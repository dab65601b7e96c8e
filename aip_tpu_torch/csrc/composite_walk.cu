// Per-tile and coefficient Gaussian compositors for Hopper (sm_90a): the
// per-tile walk, the fused macro-to-tile walk and the macro-block
// coefficient walk.
//
// Replaces three TPU kernels of aip_tpu/ops/pallas/composite.py:
//   * composite_tiles_pallas (:154, pallas_call :168): every 16 x 16 tile
//     walks its own K gathered slots, front to back;
//   * composite_from_macro_pallas (:102, pallas_call :128): every tile walks
//     its macro block's depth-sorted Kc slots, block
//     (tile / tile_w / macro) * macro_tile_w + (tile % tile_w) / macro. The
//     two share one kernel body on the TPU (_make_kernel :54) and one
//     template here, with two entry points;
//   * composite_macro_blocks_pallas (:253, pallas_call :269, the kernel of
//     _make_block_kernel :193): every bs x bs macro block walks its Kc rows
//     of quadratic coefficients.
//
// The per-tile walk (kernels 6 and 7), per pixel (px, py) and slot k:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, op exp(min(power, 0)))
//   alpha = 0 unless valid and alpha >= 1/255
//   colour += alpha T c while T > 1e-4;  T *= 1 - alpha;  out = colour + T bg
// with no early exit: T keeps falling past 1e-4 and weights the background,
// as on the TPU. The walk stops one past the row's last valid slot, which
// the block finds first (a max over its threads): later slots have alpha 0
// and change nothing. Output [T, 3, 16, 16].
//
// The coefficient walk (kernel 5), per block-local pixel (px, py) and row:
//   power = c0 + cx px + cy py + cxx px^2 + cyy py^2 + cxy px py   (left to right)
//   alpha = min(0.99, op exp(min(power, 0))), 0 below 1/255, then as above,
// over the rows [0, counts[b]) in groups of 32; the block leaves the walk
// at the first group start where none of its bs*bs pixels (those past the
// image edge included) has T > 1e-4, as the TPU kernel skips saturated
// groups. Output [M, 3, 1, bs * bs] planes.
//
// Rounding: every per-pixel expression is written with round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) in the plain version's order
// (kernels/composite.py), so nvcc contracts nothing into fused
// multiply-adds and the 1/255 cutoff, the 0.99 clamp and the 1e-4 gate see
// the plain version's values bit for bit.
//
// What bounds them on the H100: arithmetic. The per-tile walk does about 20
// float32 operations and one exp per (slot, pixel) pair against 40 bytes
// per slot and tile, the coefficient walk about 18 and one exp per (row,
// pixel) pair against 48 bytes per row and block: hundreds to thousands of
// operations per byte at the served shapes, so the bound is the CUDA
// cores' float32 rate (67 TFLOP/s, H100 SXM data sheet).
//
// Design: one 256-thread block per tile (one pixel per thread) or per macro
// block (bs * bs / 256 pixels per thread, all in one column, so px and its
// products are computed once per row). A block stages its slots in shared
// memory, 256 slots (per-tile walks) or 32 rows (coefficient walk) at a
// time, padded to 16 bytes and read as broadcasts. Kc can be thousands
// (8192 under fit_selection's hi), more than shared memory holds, hence
// the chunks. The 16 tiles of a macro block read its list through L2. Left
// for later: a tile-wide early exit (a stated difference from the JAX
// package), one list staged once for a block's tiles, tensor cores for the
// coefficient walk's quadratic form.
//
// Plain C interface, bound with ctypes: each entry point returns the
// cudaError_t of its launch (0 on success). Launches go on the caller's
// stream and allocate nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = kThreads;  // slots staged per pass of the per-tile walks
constexpr int kGroup = 32;        // rows per exit test of the coefficient walk

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <bool kMacro>
__global__ void __launch_bounds__(kThreads)
walk_tiles_kernel(const float* __restrict__ mean, const float* __restrict__ conic,
                  const float* __restrict__ color, const float* __restrict__ op,
                  const float* __restrict__ valid, const float* __restrict__ bg,
                  float* __restrict__ out, int k, int tile_w, int macro, int macro_tile_w) {
  // Slot i: [mx, my, a, b], [c, red, green, blue], [opacity, valid, -, -].
  __shared__ float4 s_slots[kChunk][3];
  __shared__ int s_end;
  const long long tile = blockIdx.x;
  const int t = threadIdx.x;
  const long long row =
      kMacro ? (tile / tile_w / macro) * macro_tile_w + (tile % tile_w) / macro : tile;
  const float px = static_cast<float>((tile % tile_w) * kTile + t % kTile);
  const float py = static_cast<float>((tile / tile_w) * kTile + t / kTile);
  const long long base = row * k;

  // n: one past the row's last valid slot (0 if it has none).
  if (t == 0) s_end = 0;
  __syncthreads();
  int end = 0;
  for (int j = t; j < k; j += kThreads) {
    if (valid[base + j] > 0.f) end = j + 1;
  }
  end = __reduce_max_sync(0xffffffffu, end);
  if (t % 32 == 0 && end > 0) atomicMax(&s_end, end);
  __syncthreads();
  const int n = s_end;

  float trans = 1.f, r = 0.f, g = 0.f, b = 0.f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = n - c0 < kChunk ? n - c0 : kChunk;
    __syncthreads();  // the previous chunk is read by every thread
    if (t < m) {
      const long long j = base + c0 + t;
      s_slots[t][0] = make_float4(mean[2 * j], mean[2 * j + 1], conic[3 * j], conic[3 * j + 1]);
      s_slots[t][1] =
          make_float4(conic[3 * j + 2], color[3 * j], color[3 * j + 1], color[3 * j + 2]);
      s_slots[t][2] = make_float4(op[j], valid[j], 0.f, 0.f);
    }
    __syncthreads();
    for (int i = 0; i < m; ++i) {
      const float4 v0 = s_slots[i][0];
      const float4 v1 = s_slots[i][1];
      const float2 v2 = make_float2(s_slots[i][2].x, s_slots[i][2].y);
      const float dx = sub(px, v0.x);
      const float dy = sub(py, v0.y);
      // -0.5 (a dx dx + c dy dy) - b dx dy, left to right.
      const float power =
          sub(mul(-0.5f, add(mul(mul(v0.z, dx), dx), mul(mul(v1.x, dy), dy))),
              mul(mul(v0.w, dx), dy));
      const float alpha = fminf(0.99f, mul(v2.x, expf(fminf(power, 0.f))));
      if (v2.y > 0.f && alpha >= 1.0f / 255.0f) {
        if (trans > 1e-4f) {
          const float w = mul(alpha, trans);
          r = add(r, mul(w, v1.y));
          g = add(g, mul(w, v1.z));
          b = add(b, mul(w, v1.w));
        }
        trans = mul(trans, sub(1.f, alpha));
      }
    }
  }
  float* o = out + tile * 3 * kThreads;
  o[t] = add(r, mul(trans, bg[0]));
  o[kThreads + t] = add(g, mul(trans, bg[1]));
  o[2 * kThreads + t] = add(b, mul(trans, bg[2]));
}

template <int BS>
__global__ void __launch_bounds__(kThreads)
macro_blocks_kernel(const float* __restrict__ coeff, const float* __restrict__ colors,
                    const int* __restrict__ counts, const float* __restrict__ bg,
                    float* __restrict__ out, int kc) {
  constexpr int P = BS * BS;
  constexpr int PPT = P / kThreads;        // pixels per thread
  constexpr int ROW_STEP = kThreads / BS;  // pixel rows between a thread's pixels
  static_assert(P % kThreads == 0 && kThreads % BS == 0, "unsupported block size");
  // Row r: [c0, cx, cy, cxx], [cyy, cxy, opacity, 0], [red, green, blue, 0].
  __shared__ float4 s_rows[kGroup][3];

  const int blk = blockIdx.x;
  const int t = threadIdx.x;
  int count = counts[blk];
  count = count < 0 ? 0 : (count > kc ? kc : count);
  const float px = static_cast<float>(t % BS);
  const float bxx = mul(px, px);
  float py[PPT], byy[PPT], bxy[PPT];
  float trans[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    py[i] = static_cast<float>(t / BS + i * ROW_STEP);
    byy[i] = mul(py[i], py[i]);
    bxy[i] = mul(px, py[i]);
    trans[i] = 1.f;
    acc_r[i] = 0.f;
    acc_g[i] = 0.f;
    acc_b[i] = 0.f;
  }

  const long long first = static_cast<long long>(blk) * kc;
  const float4* cf = reinterpret_cast<const float4*>(coeff) + first * 2;
  const float4* cl = reinterpret_cast<const float4*>(colors) + first;
  for (int g0 = 0; g0 < count; g0 += kGroup) {
    int live = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) live |= trans[i] > 1e-4f;
    // Also the barrier that lets the previous group's rows be overwritten.
    if (!__syncthreads_or(live)) break;
    const int n = count - g0 < kGroup ? count - g0 : kGroup;
    if (t < 3 * kGroup) {
      const int r = t / 3, q = t % 3;
      if (r < n) s_rows[r][q] = q < 2 ? __ldg(cf + (g0 + r) * 2 + q) : __ldg(cl + g0 + r);
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float4 v0 = s_rows[r][0];  // c0, cx, cy, cxx
      const float4 v1 = s_rows[r][1];  // cyy, cxy, opacity
      const float4 c = s_rows[r][2];
      const float base = add(v0.x, mul(v0.y, px));
      const float cxx = mul(v0.w, bxx);
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float power =
            add(add(add(add(base, mul(v0.z, py[i])), cxx), mul(v1.x, byy[i])), mul(v1.y, bxy[i]));
        const float alpha = fminf(0.99f, mul(v1.z, expf(fminf(power, 0.f))));
        if (alpha >= 1.0f / 255.0f) {
          const float tr = trans[i];
          if (tr > 1e-4f) {
            const float w = mul(alpha, tr);
            acc_r[i] = add(acc_r[i], mul(w, c.x));
            acc_g[i] = add(acc_g[i], mul(w, c.y));
            acc_b[i] = add(acc_b[i], mul(w, c.z));
          }
          trans[i] = mul(tr, sub(1.f, alpha));
        }
      }
    }
  }

  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  float* o = out + static_cast<long long>(blk) * 3 * P;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = t + i * kThreads;
    o[p] = add(acc_r[i], mul(trans[i], bg_r));
    o[P + p] = add(acc_g[i], mul(trans[i], bg_g));
    o[2 * P + p] = add(acc_b[i], mul(trans[i], bg_b));
  }
}

}  // namespace

// Per-tile walk: mean [n_tiles, k, 2], conic and colour [n_tiles, k, 3],
// opacity and valid [n_tiles, k].
extern "C" int aip_composite_tiles(const float* mean, const float* conic, const float* color,
                                   const float* op, const float* valid, const float* bg,
                                   float* out, int n_tiles, int k, int tile_w, void* stream) {
  if (n_tiles <= 0) return 0;
  walk_tiles_kernel<false><<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mean, conic, color, op, valid, bg, out, k, tile_w, 1, 1);
  return static_cast<int>(cudaGetLastError());
}

// Fused walk: the slot arrays are per macro block ([M, kc, .]); tile i
// reads block (i / tile_w / macro) * macro_tile_w + (i % tile_w) / macro.
extern "C" int aip_composite_from_macro(const float* mean, const float* conic,
                                        const float* color, const float* op,
                                        const float* valid, const float* bg, float* out,
                                        int n_tiles, int kc, int tile_w, int macro,
                                        int macro_tile_w, void* stream) {
  if (n_tiles <= 0) return 0;
  walk_tiles_kernel<true><<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mean, conic, color, op, valid, bg, out, kc, tile_w, macro, macro_tile_w);
  return static_cast<int>(cudaGetLastError());
}

// Coefficient walk: coeff [n_blocks, kc, 8], colours [n_blocks, kc, 4] (both
// 16-byte aligned), counts [n_blocks] int32; bs = 16, 32 or 64.
extern "C" int aip_composite_macro_blocks(const float* coeff, const float* colors,
                                          const int* counts, const float* bg, float* out,
                                          int n_blocks, int kc, int bs, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 16:
      macro_blocks_kernel<16><<<n_blocks, kThreads, 0, s>>>(coeff, colors, counts, bg, out, kc);
      break;
    case 32:
      macro_blocks_kernel<32><<<n_blocks, kThreads, 0, s>>>(coeff, colors, counts, bg, out, kc);
      break;
    case 64:
      macro_blocks_kernel<64><<<n_blocks, kThreads, 0, s>>>(coeff, colors, counts, bg, out, kc);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
