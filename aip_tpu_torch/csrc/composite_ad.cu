// Differentiable per-tile Gaussian compositor for Hopper (sm_90a): the
// forward walk (kernel A) and its analytic backward (kernel B).
//
// Replaces the two TPU kernels of aip_tpu/ops/pallas/composite_ad.py:
//   * _pallas_fwd (:184, pallas_call :186): for every 16 x 16 tile, a
//     front-to-back walk over its K depth-sorted slots, emitting the image
//     and the final transmittance;
//   * _pallas_bwd (:211, pallas_call :214): the reverse walk with suffix
//     accumulators, emitting d mean, d conic, d colour and d opacity.
// Both read the packed per-tile rows g [T, K, 9] (mean x, y, conic a, b, c,
// colour r, g, b, opacity: the rasterizer's gather, read where it lies) and
// valid [T, K]; B writes one packed gradient [T, K, 9].
// Per pixel p = (px, py) and slot k (the TPU kernel's _alpha_terms):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  raw = op exp(min(power, 0))
//   alpha = min(0.99, raw), and 0 unless valid and alpha >= 1/255
//   colour += alpha T c while T > 1e-4;  T *= 1 - alpha;  out = colour + T bg
// Backward, from T_final and the upstream gradient g, back to front:
//   T_k = T_after / (1 - alpha_k),  w_k = alpha_k T_k (0 once T_k <= 1e-4)
//   dL/dc_k = g w_k,  dL/dalpha_k = g . T_k c_k - g . (S_k + T_final bg) / (1 - alpha_k)
//   S_k = sum of w_j c_j behind k; the 0.99 clamp and the power clamp zero
//   exactly the gradients the forward clamped (raw < 0.99, power < 0).
// There is no transmittance exit, as in both JAX backends: T_final (and so
// the background term and its gradient) keeps multiplying while live slots
// remain.
//
// The live list. Staging a tile, a block tests every valid slot and keeps
// it unless a conservative test proves alpha < 1/255 at every pixel of the
// tile (cull below); a ballot per 32 slots and a prefix count place the
// kept slots, in their order, as the tile's list in shared memory. Both
// walks run over the list only. Skipping a slot whose alpha is 0 at every
// pixel is exact: T is multiplied by 1 - 0, the colour and the suffix add
// 0 c, and B's nine terms are 0 (not live, so d raw is 0). B writes 0 for
// every slot not on the list.
//
// The cull, in float64, per (tile, slot): aip_cull's test (csrc/cull.cuh,
// whose note gives the margins), the same expressions in the same order as
// live_slots() in kernels/composite_ad.py. A slot goes when its opacity is
// <= 0, or when its conic is positive definite and
//   ln op - (q_min / 2) (1 - 16 u rho) + 1e-6 < ln(float(1/255)),
// q_min the least q = a X^2 + 2 b X Y + c Y^2 over the tile's box of pixel
// centres. Here the kernel's power has no ln op term (op multiplies the
// exp), and the 1e-6 covers expf's 2 ulp and that product, in log terms. A
// slot whose conic is not positive definite is never culled.
//
// Pixels per thread. A block is one tile: 256 / P threads, thread j at
// column j % 16 and rows (j / 16) P + i, i < P (P in {1, 2, 4, 8}, a
// template argument; P = 8 is one warp a tile). A staged row is 12 floats
// (mx, my, a, b | c, r, g, b | op, pad), three 16-byte shared loads, read
// once per thread for its P pixels; dx, a dx dx, b dx, a dx and -0.5 dx dx
// are computed once for the column and are the same bits for each pixel.
// In B a warp that sees alpha 0 at all its pixels for a slot skips the rest
// (its T and suffix pass through unchanged, its terms are 0).
//
// What bounds them on the H100. Kernel A: each walked (slot, pixel) pair
// costs about 30 float32 instructions and an expf (3 / P shared loads), so
// it is issue-bound at about 4 pairs per SM per clock; the 10 scalar shared
// loads per 32 pairs of the one-pixel-a-thread form (about 3.2 pairs per
// SM per clock on the shared-memory pipe) are gone. The grid is about one
// wave (a block a tile), so every block stages at once: the staging (the
// gather read twice, the float64 cull) is about a third of A's time on the
// served 800^2 step (PERF.md). Kernel B: about 110 instructions a pair,
// three of them IEEE divisions; each warp's nine terms are added over the
// thread's P pixels in registers first, so the 45 shuffles of the warp
// butterfly serve 32 P pairs, not 32. The wrappers take P = 2 for both
// kernels, the fastest in the sweep; B at P = 2 spills 4 bytes.
//
// Rounding: every per-pixel expression is written with round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, ...) in the plain version's order of
// operations, so that nvcc contracts nothing into fused multiply-adds; A is
// bit for bit the plain version on the card, and so are the 1/255 cutoff,
// the 0.99 clamp and the 1e-4 transmittance gate in B. B rounds otherwise
// in two places, on purpose: its sums over the tile's pixels run per thread
// (P pixels in row order), then over the warp's butterfly (xor 16 ... 1),
// then over the tile's warps in warp order (fixed, so B is deterministic:
// no atomics); and the suffix term is one division, sum over c of
// g_c (S_c + T_final bg_c), over 1 - alpha, where the plain version divides
// each channel. composite_ad_bwd_culled_reference() emulates both.
//
// Plain C interface, bound with ctypes: each entry point returns the
// cudaError_t of its launch (0 on success). Launches go on the caller's
// stream and allocate nothing.

#include <cuda_runtime.h>

#include "cull.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kSlot = 9;   // packed row: mx, my, a, b, c, r, g, b, op
constexpr int kTerms = 9;  // d mean x, y, d conic a, b, c, d colour r, g, b, d op
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
// False when alpha < 1/255 is proved at every pixel centre of the tile at
// (x0, y0) for the packed row s (the cull of the header note).
__device__ __forceinline__ bool visible(const float* s, double x0, double y0) {
  const double mx = s[0], my = s[1], a = s[2], b = s[3], c = s[4], op = s[8];
  if (op <= 0.0) return false;
  const double factor = aip_cull::margin_factor(a, b, c);
  if (isnan(factor)) return true;  // not positive definite: never culled
  const double q_min = aip_cull::box_qmin(mx, my, a, b, c, __ddiv_rn(-b, c), __ddiv_rn(-b, a),
                                          x0, y0, kTile, kTile);
  return !aip_cull::proved_invisible(log(op), q_min, factor);
}

// Builds the tile's live list: rows[3 n ..] the kept slots' staged rows in
// slot order (mx, my, a, b | c, r, g, b | op, 0, 0, 0) and,
// with kMap, idx[n] = slot and pos[slot] = n or -1.
// Returns the list's length. Ends with a barrier.
template <int kThreads, bool kMap>
__device__ int stage(const float* __restrict__ g, const float* __restrict__ valid,
                     long long tile, int k, double x0, double y0, float4* rows,
                     unsigned* ballots, short* idx, short* pos) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (k + 31) >> 5;
  const float* gt = g + tile * k * kSlot;
  for (int ch = warp; ch < chunks; ch += kWarps) {
    const int i = ch * 32 + lane;
    bool keep = false;
    if (i < k && valid[tile * k + i] > 0.f) {
      float s[kSlot];
#pragma unroll
      for (int j = 0; j < kSlot; ++j) s[j] = gt[i * kSlot + j];
      keep = visible(s, x0, y0);
    }
    const unsigned m = __ballot_sync(kFull, keep);
    if (lane == 0) ballots[ch] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int ch = i >> 5, bit = i & 31;
    const unsigned m = ballots[ch];
    int n = __popc(m & ((1u << bit) - 1u));
    for (int c = 0; c < ch; ++c) n += __popc(ballots[c]);
    const bool keep = (m >> bit) & 1u;
    if (keep) {
      const float* s = gt + i * kSlot;
      rows[3 * n] = make_float4(s[0], s[1], s[2], s[3]);
      rows[3 * n + 1] = make_float4(s[4], s[5], s[6], s[7]);
      rows[3 * n + 2] = make_float4(s[8], 0.f, 0.f, 0.f);
      if constexpr (kMap) idx[n] = static_cast<short>(i);
    }
    if constexpr (kMap) pos[i] = static_cast<short>(keep ? n : -1);
  }
  int n = 0;
  for (int c = 0; c < chunks; ++c) n += __popc(ballots[c]);
  __syncthreads();
  return n;
}

// The thread's value of v[lane] for lane < 9 (a select, not a local-memory
// index).
__device__ __forceinline__ float pick(const float (&v)[kTerms], int lane) {
  float r = v[0];
#pragma unroll
  for (int j = 1; j < kTerms; ++j) r = lane == j ? v[j] : r;
  return r;
}

template <int P>
__global__ void __launch_bounds__(kPixels / P)
composite_ad_fwd_kernel(const float* __restrict__ g, const float* __restrict__ valid,
                        const float* __restrict__ bg, float* __restrict__ out,
                        float* __restrict__ t_final, int k, int tile_w) {
  constexpr int kThreads = kPixels / P;
  extern __shared__ float4 smem[];
  float4* rows = smem;                                            // [k][3]
  unsigned* ballots = reinterpret_cast<unsigned*>(rows + 3 * k);  // [ceil(k / 32)]
  const long long tile = blockIdx.x;
  const int x0 = static_cast<int>(tile % tile_w) * kTile;
  const int y0 = static_cast<int>(tile / tile_w) * kTile;
  const int n = stage<kThreads, false>(g, valid, tile, k, x0, y0, rows, ballots, nullptr,
                                       nullptr);
  const int t = threadIdx.x, col = t % kTile, row0 = (t / kTile) * P;
  const float px = static_cast<float>(x0 + col), py0 = static_cast<float>(y0 + row0);
  float trans[P], c_r[P], c_g[P], c_b[P];
#pragma unroll
  for (int p = 0; p < P; ++p) trans[p] = 1.f, c_r[p] = c_g[p] = c_b[p] = 0.f;
  for (int i = 0; i < n; ++i) {
    const float4 s0 = rows[3 * i], s1 = rows[3 * i + 1], s2 = rows[3 * i + 2];
    const float dx = sub(px, s0.x);
    const float adxdx = mul(mul(s0.z, dx), dx), bdx = mul(s0.w, dx);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float dy = sub(py0 + static_cast<float>(p), s0.y);
      const float power = sub(mul(-0.5f, add(adxdx, mul(mul(s1.x, dy), dy))), mul(bdx, dy));
      const float al = fminf(0.99f, mul(s2.x, expf(fminf(power, 0.f))));
      const float alpha = al >= kAlphaMin ? al : 0.f;
      if (trans[p] > 1e-4f) {
        const float w = mul(alpha, trans[p]);
        c_r[p] = add(c_r[p], mul(w, s1.y));
        c_g[p] = add(c_g[p], mul(w, s1.z));
        c_b[p] = add(c_b[p], mul(w, s1.w));
      }
      trans[p] = mul(trans[p], sub(1.f, alpha));
    }
  }
  float* o = out + tile * 3 * kPixels;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int pix = (row0 + p) * kTile + col;
    o[pix] = add(c_r[p], mul(trans[p], bg[0]));
    o[kPixels + pix] = add(c_g[p], mul(trans[p], bg[1]));
    o[2 * kPixels + pix] = add(c_b[p], mul(trans[p], bg[2]));
    t_final[tile * kPixels + pix] = trans[p];
  }
}

template <int P>
__global__ void __launch_bounds__(kPixels / P)
composite_ad_bwd_kernel(const float* __restrict__ g, const float* __restrict__ valid,
                        const float* __restrict__ bg, const float* __restrict__ t_final,
                        const float* __restrict__ g_out, float* __restrict__ d_g, int k,
                        int tile_w) {
  constexpr int kThreads = kPixels / P;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ float4 smem[];
  float4* rows = smem;                                       // [k][3]
  float* part = reinterpret_cast<float*>(rows + 3 * k);      // [kWarps][k][9], kWarps > 1
  unsigned* ballots = reinterpret_cast<unsigned*>(part + (kWarps > 1 ? kWarps * k * kTerms : 0));
  short* idx = reinterpret_cast<short*>(ballots + ((k + 31) >> 5));  // [k]
  short* pos = idx + k;                                               // [k]
  const long long tile = blockIdx.x;
  const int x0 = static_cast<int>(tile % tile_w) * kTile;
  const int y0 = static_cast<int>(tile / tile_w) * kTile;
  const int n = stage<kThreads, true>(g, valid, tile, k, x0, y0, rows, ballots, idx, pos);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int col = t % kTile, row0 = (t / kTile) * P;
  const float px = static_cast<float>(x0 + col), py0 = static_cast<float>(y0 + row0);
  const float bg0 = bg[0], bg1 = bg[1], bg2 = bg[2];
  float gr[P], gg[P], gb[P], tf[P], t_after[P], s_r[P], s_g[P], s_b[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int pix = (row0 + p) * kTile + col;
    gr[p] = g_out[tile * 3 * kPixels + pix];
    gg[p] = g_out[tile * 3 * kPixels + kPixels + pix];
    gb[p] = g_out[tile * 3 * kPixels + 2 * kPixels + pix];
    tf[p] = t_after[p] = t_final[tile * kPixels + pix];
    s_r[p] = s_g[p] = s_b[p] = 0.f;
  }
  float* dg = d_g + tile * k * kTerms;
  if constexpr (kWarps == 1) {  // the warp writes its sums itself: zero the slots off the list
    for (int e = t; e < k * kTerms; e += kThreads)
      if (pos[e / kTerms] < 0) dg[e] = 0.f;
  }

  for (int i = n - 1; i >= 0; --i) {
    const float4 s0 = rows[3 * i], s1 = rows[3 * i + 1], s2 = rows[3 * i + 2];
    float* out_row = kWarps > 1 ? part + (warp * k + i) * kTerms : dg + idx[i] * kTerms;
    const float dx = sub(px, s0.x);
    const float adx = mul(s0.z, dx), bdx = mul(s0.w, dx);
    const float adxdx = mul(adx, dx), hdxdx = mul(mul(-0.5f, dx), dx);
    float alpha[P], raw[P], power[P];
    bool seen = false;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float dy = sub(py0 + static_cast<float>(p), s0.y);
      power[p] = sub(mul(-0.5f, add(adxdx, mul(mul(s1.x, dy), dy))), mul(bdx, dy));
      raw[p] = mul(s2.x, expf(fminf(power[p], 0.f)));
      const float al = fminf(0.99f, raw[p]);
      alpha[p] = al >= kAlphaMin ? al : 0.f;
      seen |= alpha[p] > 0.f;
    }
    if (!__any_sync(kFull, seen)) {
      // alpha 0 at every pixel of the warp: T and the suffix pass through
      // unchanged and every term is 0.
      if (lane < kTerms) out_row[lane] = 0.f;
      continue;
    }
    float acc[kTerms];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float dy = sub(py0 + static_cast<float>(p), s0.y);
      const float one_m = sub(1.f, alpha[p]);
      const float t_exc = __fdiv_rn(t_after[p], one_m);
      const bool live = t_exc > 1e-4f;
      const float w = live ? mul(alpha[p], t_exc) : 0.f;
      float dalpha = 0.f;
      if (live) {
        const float num = add(add(mul(gr[p], add(s_r[p], mul(tf[p], bg0))),
                                  mul(gg[p], add(s_g[p], mul(tf[p], bg1)))),
                              mul(gb[p], add(s_b[p], mul(tf[p], bg2))));
        dalpha = sub(add(add(mul(gr[p], mul(t_exc, s1.y)), mul(gg[p], mul(t_exc, s1.z))),
                         mul(gb[p], mul(t_exc, s1.w))),
                     __fdiv_rn(num, one_m));
      }
      const float d_raw = (alpha[p] > 0.f && raw[p] < 0.99f) ? dalpha : 0.f;
      const float exp_pow = s2.x != 0.f ? __fdiv_rn(raw[p], s2.x) : 0.f;
      const float d_power = power[p] < 0.f ? mul(d_raw, raw[p]) : 0.f;
      const float v[kTerms] = {
          mul(d_power, add(adx, mul(s0.w, dy))),
          mul(d_power, add(mul(s1.x, dy), bdx)),
          mul(d_power, hdxdx),
          mul(d_power, mul(-dx, dy)),
          mul(d_power, mul(mul(-0.5f, dy), dy)),
          mul(gr[p], w), mul(gg[p], w), mul(gb[p], w),
          mul(d_raw, exp_pow),
      };
#pragma unroll
      for (int j = 0; j < kTerms; ++j) acc[j] = p == 0 ? v[j] : add(acc[j], v[j]);
      s_r[p] = add(s_r[p], mul(w, s1.y));
      s_g[p] = add(s_g[p], mul(w, s1.z));
      s_b[p] = add(s_b[p], mul(w, s1.w));
      t_after[p] = t_exc;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kTerms; ++j) acc[j] = add(acc[j], __shfl_xor_sync(kFull, acc[j], off));
    }
    if (lane < kTerms) out_row[lane] = pick(acc, lane);
  }
  if constexpr (kWarps > 1) {
    __syncthreads();
    for (int e = t; e < k * kTerms; e += kThreads) {
      const int slot = e / kTerms, j = e - slot * kTerms, r = pos[slot];
      float acc = 0.f;
      if (r >= 0) {
        acc = part[r * kTerms + j];
#pragma unroll
        for (int wp = 1; wp < kWarps; ++wp) acc = add(acc, part[(wp * k + r) * kTerms + j]);
      }
      dg[e] = acc;
    }
  }
}

size_t smem_bytes(int k, int p, bool backward) {
  size_t n = 48 * static_cast<size_t>(k) + 4 * static_cast<size_t>((k + 31) / 32);
  if (backward) {
    const int warps = 8 / p;
    n += 4 * static_cast<size_t>(k) + (warps > 1 ? 36 * static_cast<size_t>(k) * warps : 0);
  }
  return n;
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

template <int P>
int launch_fwd(const float* g, const float* valid, const float* bg, float* out, float* t_final,
               int n_tiles, int k, int tile_w, cudaStream_t st) {
  const size_t bytes = smem_bytes(k, P, false);
  const int err = set_smem(reinterpret_cast<const void*>(composite_ad_fwd_kernel<P>), bytes);
  if (err) return err;
  composite_ad_fwd_kernel<P><<<n_tiles, kPixels / P, bytes, st>>>(g, valid, bg, out, t_final, k,
                                                                   tile_w);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_bwd(const float* g, const float* valid, const float* bg, const float* t_final,
               const float* g_out, float* d_g, int n_tiles, int k, int tile_w, cudaStream_t st) {
  const size_t bytes = smem_bytes(k, P, true);
  const int err = set_smem(reinterpret_cast<const void*>(composite_ad_bwd_kernel<P>), bytes);
  if (err) return err;
  composite_ad_bwd_kernel<P><<<n_tiles, kPixels / P, bytes, st>>>(g, valid, bg, t_final, g_out,
                                                                   d_g, k, tile_w);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int k, int tile_w, int p) {
  return k < 0 || k > 32767 || tile_w < 1 || (p != 1 && p != 2 && p != 4 && p != 8);
}

}  // namespace

// Dynamic shared memory of one block of kernel A (backward = 0) or B.
extern "C" int aip_composite_ad_smem(int k, int p, int backward) {
  return static_cast<int>(smem_bytes(k, p, backward != 0));
}

// Kernel A: g [T, K, 9], valid [T, K] (> 0 where the slot holds a
// Gaussian), bg [3] -> out [T, 3, 16, 16] and t_final [T, 16, 16]; tile t
// sits at column t % tile_w. p: pixels a thread, 1, 2, 4 or 8.
extern "C" int aip_composite_ad_fwd(const float* g, const float* valid, const float* bg,
                                    float* out, float* t_final, int n_tiles, int k, int tile_w,
                                    int p, void* stream) {
  if (n_tiles <= 0) return 0;
  if (bad_args(k, tile_w, p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_fwd<1>(g, valid, bg, out, t_final, n_tiles, k, tile_w, st);
    case 2: return launch_fwd<2>(g, valid, bg, out, t_final, n_tiles, k, tile_w, st);
    case 4: return launch_fwd<4>(g, valid, bg, out, t_final, n_tiles, k, tile_w, st);
    default: return launch_fwd<8>(g, valid, bg, out, t_final, n_tiles, k, tile_w, st);
  }
}

// Kernel B: the forward's inputs, its t_final and the upstream gradient
// g_out [T, 3, 16, 16] -> d_g [T, K, 9], the packed gradient (0 for every
// slot off the tile's list).
extern "C" int aip_composite_ad_bwd(const float* g, const float* valid, const float* bg,
                                    const float* t_final, const float* g_out, float* d_g,
                                    int n_tiles, int k, int tile_w, int p, void* stream) {
  if (n_tiles <= 0) return 0;
  if (bad_args(k, tile_w, p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return launch_bwd<1>(g, valid, bg, t_final, g_out, d_g, n_tiles, k, tile_w, st);
    case 2: return launch_bwd<2>(g, valid, bg, t_final, g_out, d_g, n_tiles, k, tile_w, st);
    case 4: return launch_bwd<4>(g, valid, bg, t_final, g_out, d_g, n_tiles, k, tile_w, st);
    default: return launch_bwd<8>(g, valid, bg, t_final, g_out, d_g, n_tiles, k, tile_w, st);
  }
}
