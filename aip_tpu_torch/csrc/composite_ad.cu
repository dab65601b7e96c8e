// Differentiable per-tile Gaussian compositor for Hopper (sm_90a): the
// forward walk (kernel A) and its analytic backward (kernel B).
//
// Replaces the two TPU kernels of aip_tpu/ops/pallas/composite_ad.py:
//   * _pallas_fwd (:184, pallas_call :186): for every 16 x 16 tile, a
//     front-to-back walk over its K depth-sorted slots, emitting the image
//     and the final transmittance;
//   * _pallas_bwd (:211, pallas_call :214): the reverse walk with suffix
//     accumulators, emitting d mean [T, K, 2], d conic [T, K, 3], d colour
//     [T, K, 3] and d opacity [T, K, 1].
// Per pixel p = (px, py) and slot k (the TPU kernel's _alpha_terms):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  raw = op exp(min(power, 0))
//   alpha = min(0.99, raw), and 0 unless valid and alpha >= 1/255
//   colour += alpha T c while T > 1e-4;  T *= 1 - alpha;  out = colour + T bg
// Backward, from T_final and the upstream gradient g, back to front:
//   T_k = T_after / (1 - alpha_k),  w_k = alpha_k T_k (0 once T_k <= 1e-4)
//   dL/dc_k = g w_k,  dL/dalpha_k = g . (T_k c_k - (S_k + T_final bg) / (1 - alpha_k))
//   S_k = sum of w_j c_j behind k; the 0.99 clamp and the power clamp zero
//   exactly the gradients the forward clamped (raw < 0.99, power < 0).
// Every slot is walked, as both JAX backends do: T_final (and so the
// background term and its gradient) keeps multiplying past the point where
// contributions stop.
//
// What bounds it on the H100: arithmetic. Per (slot, pixel) pair the forward
// does about 20 float32 operations and one exp, against 40 bytes per slot
// per tile; the backward about 60 and a 9-term reduction over the tile's
// 256 pixels. At T = 2500 tiles and K = 128 that is 82M pairs, thousands of
// operations per byte, so the bound is the CUDA cores' float32 rate.
//
// Rounding: every per-pixel expression is written with round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, ...) in the plain version's order of
// operations, so that nvcc contracts nothing into fused multiply-adds. The
// per-pixel values are then bit for bit the plain version's on the card,
// and so are the 1/255 cutoff, the 0.99 clamp and the 1e-4 transmittance
// gate, each a hard branch that one rounding step could flip. Only the
// backward's sums over the tile's pixels run in another order.
//
// Design: one 256-thread block per tile, one pixel per thread. A block
// stages its K slots (10 floats each) in shared memory and every thread
// reads them as broadcasts. The walks are sequential in float32, as the
// CUDA rasterizer's are. In the backward each warp reduces the 9 per-slot
// terms of its 32 pixels with shuffles and writes them to its own row of a
// [8 warps, K, 9] shared array; a slot that no pixel of the warp sees
// (alpha 0 everywhere) skips the shuffles. One final pass sums the 8 warp
// rows in a fixed order (deterministic) and writes [T, K, 9] split into the
// four outputs. The scatter back to per-Gaussian arrays stays in PyTorch
// (index_add_, the gather's own backward), as the JAX package leaves it to
// XLA.
//
// Plain C interface, bound with ctypes: each entry point returns the
// cudaError_t of its launch (0 on success). Launches go on the caller's
// stream and allocate nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kSlot = 10;  // mx, my, a, b, c, r, g, b, op, valid
constexpr int kTerms = 9;  // d mean x, y, d conic a, b, c, d colour r, g, b, d op

__device__ __forceinline__ void stage_slots(float* s, const float* __restrict__ mean,
                                            const float* __restrict__ conic,
                                            const float* __restrict__ color,
                                            const float* __restrict__ op,
                                            const float* __restrict__ valid, long long tile,
                                            int k) {
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const long long j = tile * k + i;
    float* d = s + i * kSlot;
    d[0] = mean[j * 2];
    d[1] = mean[j * 2 + 1];
    d[2] = conic[j * 3];
    d[3] = conic[j * 3 + 1];
    d[4] = conic[j * 3 + 2];
    d[5] = color[j * 3];
    d[6] = color[j * 3 + 1];
    d[7] = color[j * 3 + 2];
    d[8] = op[j];
    d[9] = valid[j];
  }
}

struct Alpha {
  float alpha, raw, dx, dy, power;
  bool live;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ Alpha alpha_terms(const float* d, float px, float py) {
  Alpha a;
  a.dx = sub(px, d[0]);
  a.dy = sub(py, d[1]);
  // -0.5 (a dx dx + c dy dy) - b dx dy, left to right.
  a.power = sub(mul(-0.5f, add(mul(mul(d[2], a.dx), a.dx), mul(mul(d[4], a.dy), a.dy))),
                mul(mul(d[3], a.dx), a.dy));
  a.raw = mul(d[8], expf(fminf(a.power, 0.f)));
  const float al = fminf(0.99f, a.raw);
  a.live = d[9] > 0.f && al >= 1.0f / 255.0f;
  a.alpha = a.live ? al : 0.f;
  return a;
}

__global__ void __launch_bounds__(kThreads)
composite_ad_fwd_kernel(const float* __restrict__ mean, const float* __restrict__ conic,
                        const float* __restrict__ color, const float* __restrict__ op,
                        const float* __restrict__ valid, const float* __restrict__ bg,
                        float* __restrict__ out, float* __restrict__ t_final, int k,
                        int tile_w) {
  extern __shared__ float s_slots[];
  const long long tile = blockIdx.x;
  stage_slots(s_slots, mean, conic, color, op, valid, tile, k);
  __syncthreads();
  const int t = threadIdx.x;
  const float px = static_cast<float>((tile % tile_w) * kTile + t % kTile);
  const float py = static_cast<float>((tile / tile_w) * kTile + t / kTile);
  float trans = 1.f, r = 0.f, g = 0.f, b = 0.f;
  for (int i = 0; i < k; ++i) {
    const float* d = s_slots + i * kSlot;
    const Alpha a = alpha_terms(d, px, py);
    if (trans > 1e-4f) {
      const float w = mul(a.alpha, trans);
      r = add(r, mul(w, d[5]));
      g = add(g, mul(w, d[6]));
      b = add(b, mul(w, d[7]));
    }
    trans = mul(trans, sub(1.f, a.alpha));
  }
  float* o = out + tile * 3 * kThreads;
  o[t] = add(r, mul(trans, bg[0]));
  o[kThreads + t] = add(g, mul(trans, bg[1]));
  o[2 * kThreads + t] = add(b, mul(trans, bg[2]));
  t_final[tile * kThreads + t] = trans;
}

__global__ void __launch_bounds__(kThreads)
composite_ad_bwd_kernel(const float* __restrict__ mean, const float* __restrict__ conic,
                        const float* __restrict__ color, const float* __restrict__ op,
                        const float* __restrict__ valid, const float* __restrict__ bg,
                        const float* __restrict__ t_final, const float* __restrict__ g_out,
                        float* __restrict__ d_mean, float* __restrict__ d_conic,
                        float* __restrict__ d_color, float* __restrict__ d_op, int k,
                        int tile_w) {
  extern __shared__ float smem[];
  float* s_slots = smem;                  // [k, kSlot]
  float* s_part = smem + k * kSlot;       // [kWarps, k, kTerms]
  const long long tile = blockIdx.x;
  stage_slots(s_slots, mean, conic, color, op, valid, tile, k);
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float px = static_cast<float>((tile % tile_w) * kTile + t % kTile);
  const float py = static_cast<float>((tile / tile_w) * kTile + t / kTile);
  const float gr = g_out[tile * 3 * kThreads + t];
  const float gg = g_out[tile * 3 * kThreads + kThreads + t];
  const float gb = g_out[tile * 3 * kThreads + 2 * kThreads + t];
  const float tf = t_final[tile * kThreads + t];
  const float bg_r = mul(tf, bg[0]), bg_g = mul(tf, bg[1]), bg_b = mul(tf, bg[2]);
  float t_after = tf, s_r = 0.f, s_g = 0.f, s_b = 0.f;

  for (int i = k - 1; i >= 0; --i) {
    const float* d = s_slots + i * kSlot;
    float* part = s_part + (warp * k + i) * kTerms;
    const Alpha a = alpha_terms(d, px, py);
    if (!__any_sync(0xffffffffu, a.alpha > 0.f)) {
      // alpha 0 at every pixel of the warp: T and the suffix pass through
      // unchanged and every term is 0.
      if (lane < kTerms) part[lane] = 0.f;
      continue;
    }
    const float one_m = sub(1.f, a.alpha);
    const float t_exc = __fdiv_rn(t_after, one_m);
    const bool live = t_exc > 1e-4f;
    const float w = live ? mul(a.alpha, t_exc) : 0.f;
    float dalpha = 0.f;
    if (live) {
      // g . (T c - (S + T_final bg) / (1 - alpha)), channel by channel.
      dalpha = add(add(mul(gr, sub(mul(t_exc, d[5]), __fdiv_rn(add(s_r, bg_r), one_m))),
                       mul(gg, sub(mul(t_exc, d[6]), __fdiv_rn(add(s_g, bg_g), one_m)))),
                   mul(gb, sub(mul(t_exc, d[7]), __fdiv_rn(add(s_b, bg_b), one_m))));
    }
    const float d_raw = (a.live && a.raw < 0.99f) ? dalpha : 0.f;
    const float exp_pow = d[8] != 0.f ? __fdiv_rn(a.raw, d[8]) : 0.f;
    const float d_power = a.power < 0.f ? mul(d_raw, a.raw) : 0.f;
    float v[kTerms] = {
        mul(d_power, add(mul(d[2], a.dx), mul(d[3], a.dy))),
        mul(d_power, add(mul(d[4], a.dy), mul(d[3], a.dx))),
        mul(d_power, mul(mul(-0.5f, a.dx), a.dx)),
        mul(d_power, mul(-a.dx, a.dy)),
        mul(d_power, mul(mul(-0.5f, a.dy), a.dy)),
        mul(gr, w), mul(gg, w), mul(gb, w),
        mul(d_raw, exp_pow),
    };
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kTerms; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kTerms; ++j) part[j] = v[j];
    }
    s_r = add(s_r, mul(w, d[5]));
    s_g = add(s_g, mul(w, d[6]));
    s_b = add(s_b, mul(w, d[7]));
    t_after = t_exc;
  }
  __syncthreads();
  for (int e = t; e < k * kTerms; e += kThreads) {
    float acc = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) acc += s_part[wp * k * kTerms + e];
    const int i = e / kTerms, j = e % kTerms;
    const long long slot = tile * k + i;
    if (j < 2) d_mean[slot * 2 + j] = acc;
    else if (j < 5) d_conic[slot * 3 + j - 2] = acc;
    else if (j < 8) d_color[slot * 3 + j - 5] = acc;
    else d_op[slot] = acc;
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

}  // namespace

// Forward: mean [T, K, 2], conic [T, K, 3], color [T, K, 3], op [T, K],
// valid [T, K] (> 0 where the slot holds a Gaussian), bg [3] -> out
// [T, 3, 16, 16] and t_final [T, 16, 16]; tile t sits at column t % tile_w.
extern "C" int aip_composite_ad_fwd(const float* mean, const float* conic, const float* color,
                                    const float* op, const float* valid, const float* bg,
                                    float* out, float* t_final, int n_tiles, int k, int tile_w,
                                    void* stream) {
  if (n_tiles <= 0) return 0;
  const size_t bytes = static_cast<size_t>(k) * kSlot * sizeof(float);
  int err = set_smem(reinterpret_cast<const void*>(composite_ad_fwd_kernel), bytes);
  if (err) return err;
  composite_ad_fwd_kernel<<<n_tiles, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      mean, conic, color, op, valid, bg, out, t_final, k, tile_w);
  return static_cast<int>(cudaGetLastError());
}

// Backward: the forward's inputs, its t_final and the upstream gradient
// g_out [T, 3, 16, 16] -> d_mean [T, K, 2], d_conic [T, K, 3], d_color
// [T, K, 3], d_op [T, K].
extern "C" int aip_composite_ad_bwd(const float* mean, const float* conic, const float* color,
                                    const float* op, const float* valid, const float* bg,
                                    const float* t_final, const float* g_out, float* d_mean,
                                    float* d_conic, float* d_color, float* d_op, int n_tiles,
                                    int k, int tile_w, void* stream) {
  if (n_tiles <= 0) return 0;
  const size_t bytes = static_cast<size_t>(k) * (kSlot + kWarps * kTerms) * sizeof(float);
  int err = set_smem(reinterpret_cast<const void*>(composite_ad_bwd_kernel), bytes);
  if (err) return err;
  composite_ad_bwd_kernel<<<n_tiles, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      mean, conic, color, op, valid, bg, t_final, g_out, d_mean, d_conic, d_color, d_op, k,
      tile_w);
  return static_cast<int>(cudaGetLastError());
}
