// Macro-block Gaussian compositors for Hopper (sm_90a): the segment walk and
// the windowed walk.
//
// Replaces two TPU kernels of aip_tpu/ops/pallas/composite.py:
//   * composite_macro_mxu_seg_pallas (:442, the _make_mxu_seg_kernel :367):
//     block b walks rows [starts[b], starts[b] + counts[b]) of the
//     (block, depth)-sorted [S, 16] packed table;
//   * composite_macro_mxu_pallas (:509, the _make_mxu_kernel :290): block b
//     walks rows [b * Kc, b * Kc + counts[b]) of a gathered [M, Kc, 16]
//     window (valid rows are a prefix).
// Both are one block routine here with two entry points, each its own
// launch. A row is [mx, my, conic a, b, c, log(opacity), r, g, b, pad x7].
// For every pixel (px, py) of the bs x bs macro block at
// ((b % mtw) * bs, (b / mtw) * bs), rows front to back:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy + log(opacity)
//   alpha = min(0.99, exp(min(power, 0))), and 0 below 1/255
//   colour += alpha * T * rgb while T > 1e-4;  T *= 1 - alpha
// then out = colour + T * bg, written as [M, 3, 1, bs * bs] planes.
//
// What bounds it on the H100: per (row, pixel) pair about 15 float32
// operations and one exp, against one 64-byte row read per block (36 bytes
// of it used). At the served shapes that is thousands of operations per
// byte, so it is bound by the CUDA cores' float32 rate (67 TFLOP/s, H100 SXM
// data sheet), not by memory.
//
// Design: one thread block per macro block, 256 threads, each holding
// bs * bs / 256 pixels (16 at bs = 64) with their transmittance and colour
// in registers. A thread's pixels share one column, so dx and the dx terms
// are computed once per row. Rows are staged through shared memory 64 at a
// time (36 used bytes each, as three float4 loads), read as broadcasts.
// The walk is sequential front to back in float32, as the CUDA rasterizer's
// is; the TPU kernel's triangular-matmul prefix product (with its 3-pass
// bf16 split) exists for the MXU and is not carried over. At every 64-row
// group the block leaves the walk when no pixel has T > 1e-4
// (__syncthreads_or), as the TPU kernel skips saturated groups. Segments
// may start at any row: only rows inside the block's range are read.
// Blocks that hang over the image edge are computed whole; the caller
// crops. What this leaves on the table (tensor cores for the quadratic
// form, TMA staging, persistent blocks) is later work.
//
// Plain C interface, bound with ctypes: every entry point returns the
// cudaError_t of its launch (0 on success). Launches go on the caller's
// stream and allocate nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 64;  // rows staged per pass

template <int BS, bool kSegment>
__global__ void __launch_bounds__(kThreads)
composite_macro_kernel(const float* __restrict__ table, const int* __restrict__ starts,
                       const int* __restrict__ counts, const float* __restrict__ bg,
                       float* __restrict__ out, int kc, long long table_rows, int mtw) {
  // Segment: rows [starts[b], starts[b] + counts[b]); window: rows
  // [b * kc, b * kc + counts[b]). Counts clip to kc either way.
  constexpr int P = BS * BS;
  constexpr int PPT = P / kThreads;           // pixels per thread
  constexpr int ROW_STEP = kThreads / BS;     // pixel rows between a thread's pixels
  static_assert(P % kThreads == 0 && kThreads % BS == 0, "unsupported block size");
  __shared__ float4 s_rows[kGroup][3];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const long long first = kSegment ? static_cast<long long>(starts[b])
                                   : static_cast<long long>(b) * kc;
  long long count = counts[b];
  if (count > kc) count = kc;                                  // capacity, as the selection clips
  if (count > table_rows - first) count = table_rows - first;  // never read past the table
  if (count < 0) count = 0;

  const float px = static_cast<float>((b % mtw) * BS + t % BS);
  const float py0 = static_cast<float>((b / mtw) * BS + t / BS);

  float trans[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    trans[i] = 1.f;
    acc_r[i] = 0.f;
    acc_g[i] = 0.f;
    acc_b[i] = 0.f;
  }

  const float4* src = reinterpret_cast<const float4*>(table) + first * 4;
  for (long long g0 = 0; g0 < count; g0 += kGroup) {
    int live = 0;
#pragma unroll
    for (int i = 0; i < PPT; ++i) live |= trans[i] > 1e-4f;
    // Also the barrier that lets the previous group's rows be overwritten.
    if (!__syncthreads_or(live)) break;
    const int n = static_cast<int>(count - g0 < kGroup ? count - g0 : kGroup);
    if (t < 3 * kGroup) {
      const int r = t / 3, q = t % 3;
      if (r < n) s_rows[r][q] = __ldg(src + (g0 + r) * 4 + q);
    }
    __syncthreads();
    for (int r = 0; r < n; ++r) {
      const float4 v0 = s_rows[r][0];  // mx, my, a, b
      const float4 v1 = s_rows[r][1];  // c, log(opacity), red, green
      const float blue = s_rows[r][2].x;
      const float dx = px - v0.x;
      const float adx2 = v0.z * dx * dx;
      const float bdx = v0.w * dx;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dy = py0 + static_cast<float>(i * ROW_STEP) - v0.y;
        const float power = -0.5f * (adx2 + v1.x * dy * dy) - bdx * dy + v1.y;
        const float alpha = fminf(0.99f, expf(fminf(power, 0.f)));
        if (alpha >= 1.0f / 255.0f) {
          const float tr = trans[i];
          if (tr > 1e-4f) {
            const float w = alpha * tr;
            acc_r[i] += w * v1.z;
            acc_g[i] += w * v1.w;
            acc_b[i] += w * blue;
          }
          trans[i] = tr * (1.f - alpha);
        }
      }
    }
  }

  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  float* o = out + static_cast<long long>(b) * 3 * P;
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = t + i * kThreads;
    o[p] = acc_r[i] + trans[i] * bg_r;
    o[P + p] = acc_g[i] + trans[i] * bg_g;
    o[2 * P + p] = acc_b[i] + trans[i] * bg_b;
  }
}

template <bool kSegment>
int launch(const float* table, const int* starts, const int* counts, const float* bg,
           float* out, int n_blocks, int kc, long long table_rows, int bs, int mtw,
           void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 16:
      composite_macro_kernel<16, kSegment><<<n_blocks, kThreads, 0, s>>>(
          table, starts, counts, bg, out, kc, table_rows, mtw);
      break;
    case 32:
      composite_macro_kernel<32, kSegment><<<n_blocks, kThreads, 0, s>>>(
          table, starts, counts, bg, out, kc, table_rows, mtw);
      break;
    case 64:
      composite_macro_kernel<64, kSegment><<<n_blocks, kThreads, 0, s>>>(
          table, starts, counts, bg, out, kc, table_rows, mtw);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Segment walk: raw_sorted [s_rows, 16], starts/counts [n_blocks] int32,
// counts clipped to kc.
extern "C" int aip_composite_segment(const float* raw_sorted, const int* starts,
                                     const int* counts, const float* bg, float* out,
                                     int n_blocks, int kc, long long s_rows, int bs, int mtw,
                                     void* stream) {
  return launch<true>(raw_sorted, starts, counts, bg, out, n_blocks, kc, s_rows, bs, mtw,
                      stream);
}

// Windowed walk: raw [n_blocks, kc, 16], counts [n_blocks] int32 (a prefix
// of each block's kc rows).
extern "C" int aip_composite_window(const float* raw, const int* counts, const float* bg,
                                    float* out, int n_blocks, int kc, int bs, int mtw,
                                    void* stream) {
  return launch<false>(raw, nullptr, counts, bg, out, n_blocks, kc,
                       static_cast<long long>(n_blocks) * kc, bs, mtw, stream);
}
