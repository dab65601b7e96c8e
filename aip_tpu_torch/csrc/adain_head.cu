// Fused AdaIN encoder head and decoder tail for Hopper (sm_90a).
//
// Replaces the TPU kernels of aip_tpu/ops/pallas/adain_head.py:
//   * encode_head_pallas (:174)  ->  aip_encode_head
//       reflect-pad -> conv 3->64 (1x1 RGB conv folded in) -> ReLU ->
//       reflect-pad -> conv 64->64 -> ReLU -> 2x2 ceil-mode max pool
//       x [B,H,W,3] -> [B,ceil(H/2),ceil(W/2),64]
//   * decode_tail_pallas (:278)  ->  aip_decode_tail
//       nearest up2x -> reflect-pad -> conv 64->64 -> ReLU ->
//       reflect-pad -> conv 64->3
//       y [B,h,w,64] -> [B,2h,2w,3]
//
// What bounds it on the H100: operations. Each chain is ~20 GFLOP per 512^2
// image (the 64->64 conv alone is 19.3) against ~10 MB of bf16 in and out,
// far above the card's ~295 FLOP/byte ridge. Keeping the 64-channel
// intermediate in shared memory removes the full-resolution round trips
// through device memory that the layer-by-layer chain pays.
//
// Design (first, simple version: direct convolution on the CUDA cores,
// fp32 accumulation, no tensor cores, no TMA):
//   * One block of 256 threads computes a 16x16 tile of the 64->64 conv
//     for all 64 output channels. Its 18x18x64 input tile (1-pixel halo)
//     lives in shared memory as fp32, channel-planar with a 20-float row
//     stride and a 361-float channel stride, so the two rows of lanes in
//     a warp hit disjoint banks on loads and channel-strided stores are
//     conflict-free.
//   * The 147 KB fp32 weight tensor does not fit beside the tile, so it is
//     streamed through shared memory 8 input channels (18 KB) at a time.
//     Tile + chunk = 111 KB, which keeps two blocks on each SM.
//   * Each thread holds 4 vertically adjacent pixels x 16 output channels
//     (64 accumulators); per input channel and kernel column it loads 6
//     input values once and reuses them across the 3 kernel rows. A warp
//     shares its 16 output channels, so weight loads are broadcasts.
//   * Encoder: the halo of relu1_1 is relu1_1 AT THE REFLECTED COORDINATE
//     (double reflection does not commute with conv1), so conv1 is
//     evaluated directly at reflected coordinates from a staged 20x20x3
//     patch of x. The pool masks taps outside the image (odd H or W).
//   * Decoder: up2x followed by reflect-pad is an edge-clamped 2x repeat,
//     u(r) = y(clamp(r, 0, 2h-1) / 2), so the upsampled map is never
//     materialised: the block stages its 18x18 window of u straight from
//     y. The 64->64 conv then produces a 16x16 halo of z for a 14x14 output
//     tile; halo rows/columns that fall on the reflected border are copied
//     from their mirror (z(-1) = z(1), z(H) = z(H-2)) before the 64->3 conv.
//   * bf16 inputs and outputs are converted at the edges; weights arrive
//     as fp32 (already rounded to the compute dtype by the caller).
//
// Interface: plain C, loaded with ctypes. Every pointer is a device pointer,
// the stream is a cudaStream_t; each function returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kC = 64;                 // channels of the 64->64 convs
constexpr int kTile = 16;              // output tile edge of the 64->64 conv
constexpr int kIn = kTile + 2;         // 18: input tile edge with halo
constexpr int kRow = 20;               // shared-memory row stride (floats)
constexpr int kChan = kIn * kRow + 1;  // 361: per-channel stride (floats)
constexpr int kKc = 8;                 // input channels per weight chunk
constexpr int kWChunk = 9 * kKc * kC;  // 4608 floats
constexpr int kInFloats = kC * kChan;  // 23104 floats (a multiple of 4)
constexpr int kOut = kTile - 2;        // 14: decoder output tile edge
constexpr int kZChan = kTile * kRow + 1;  // 321: decoder z-halo channel stride
constexpr int kXPatch = 20;            // encoder x patch edge (rows r0-2..r0+17)
constexpr size_t kSmemBytes = (size_t)(kInFloats + kWChunk + 128) * sizeof(float);

static_assert(kC * kZChan <= kInFloats, "z halo must fit in the input tile");
static_assert(kXPatch * kXPatch * 3 + 27 * kC <= kWChunk, "x patch + w1 must fit");
static_assert(9 * kC * 4 <= kWChunk, "decoder w1 must fit");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ReflectionPad2d(1) index for g in [-1, n] (n >= 2).
__device__ __forceinline__ int reflect1(int g, int n) {
  g = g < 0 ? -g : g;
  return g >= n ? 2 * n - 2 - g : g;
}

// Thread -> (output-channel group, first of 4 pixel rows, pixel column).
__device__ __forceinline__ void thread_map(int tid, int& g, int& row0, int& col) {
  const int warp = tid >> 5, lane = tid & 31;
  g = warp >> 1;                                   // 16 channels: g*16 ..
  row0 = (warp & 1) * 8 + (lane >> 4) * 4;         // rows row0 .. row0+3
  col = lane & 15;
}

// acc[k][n] += sum_{dy,dx,ci} in[ci][row0+k+dy][col+dx] * w[dy][dx][ci][g*16+n]
// in: the 18x18x64 tile in shared memory; ws: a kWChunk-float staging area;
// w: [3][3][64][64] fp32 in device memory. Starts with a barrier, so the
// caller may still be writing `in` or reading `ws` when it is called.
__device__ __forceinline__ void conv64_tile(const float* in, float* ws,
                                            const float* __restrict__ w,
                                            float (&acc)[4][16], int row0, int col, int g) {
  for (int c0 = 0; c0 < kC; c0 += kKc) {
    __syncthreads();
    for (int i = threadIdx.x; i < kWChunk / 4; i += kThreads) {
      const int co4 = i & 15, rest = i >> 4;
      const int cl = rest % kKc, tap = rest / kKc;
      reinterpret_cast<float4*>(ws)[i] = __ldg(
          reinterpret_cast<const float4*>(w + (size_t)(tap * kC + c0 + cl) * kC) + co4);
    }
    __syncthreads();
#pragma unroll 1
    for (int cl = 0; cl < kKc; ++cl) {
      const float* ip = in + (c0 + cl) * kChan + row0 * kRow + col;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        float v[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) v[r] = ip[r * kRow + dx];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const float4* wp = reinterpret_cast<const float4*>(
              ws + ((dy * 3 + dx) * kKc + cl) * kC + g * 16);
          float wv[16];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 t = wp[q];
            wv[4 * q] = t.x; wv[4 * q + 1] = t.y; wv[4 * q + 2] = t.z; wv[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int n = 0; n < 16; ++n) acc[k][n] = fmaf(v[k + dy], wv[n], acc[k][n]);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
encode_head_kernel(const T* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ w2,
                   const float* __restrict__ b2, T* __restrict__ out, int H, int W) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* r1 = smem;                             // relu1_1 halo [64][18][20]
  float* uni = smem + kInFloats;                // x patch + w1, then w2 chunks
  float* xs = uni;                              // [20][20][3]
  float* w1s = uni + kXPatch * kXPatch * 3;     // [27][64]
  float* b1s = uni + kWChunk;                   // [64]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kTile, c0 = blockIdx.x * kTile;
  const T* xb = x + (size_t)blockIdx.z * H * W * 3;

  // Stage x rows/cols r0-2 .. r0+17 (clamped; only in-image ones are read).
  for (int i = tid; i < kXPatch * kXPatch * 3; i += kThreads) {
    const int c = i % 3, p = i / 3, s = p % kXPatch, q = p / kXPatch;
    const int gr = min(max(r0 - 2 + q, 0), H - 1);
    const int gc = min(max(c0 - 2 + s, 0), W - 1);
    xs[i] = to_f(xb[((size_t)gr * W + gc) * 3 + c]);
  }
  for (int i = tid; i < 27 * kC; i += kThreads) w1s[i] = w1[i];
  if (tid < kC) b1s[tid] = b1[tid];
  __syncthreads();

  // relu1_1 on the 18x18 halo, each position at its reflected coordinate.
  const int warp = tid >> 5, lane = tid & 31;
  for (int p = warp; p < kIn * kIn; p += kThreads / 32) {
    const int i = p / kIn, j = p % kIn;
    const int rr = reflect1(min(r0 - 1 + i, H), H);
    const int cc = reflect1(min(c0 - 1 + j, W), W);
    float a0 = b1s[lane], a1 = b1s[lane + 32];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int q = reflect1(rr + dy - 1, H) - (r0 - 2);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const int s = reflect1(cc + dx - 1, W) - (c0 - 2);
        const float* xp = xs + (q * kXPatch + s) * 3;
        const float* wp = w1s + (dy * 3 + dx) * 3 * kC;
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
          a0 = fmaf(xp[ci], wp[ci * kC + lane], a0);
          a1 = fmaf(xp[ci], wp[ci * kC + lane + 32], a1);
        }
      }
    }
    r1[lane * kChan + i * kRow + j] = fmaxf(a0, 0.f);
    r1[(lane + 32) * kChan + i * kRow + j] = fmaxf(a1, 0.f);
  }

  int g, row0, col;
  thread_map(tid, g, row0, col);
  float acc[4][16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float bv = __ldg(b2 + g * 16 + n);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k][n] = bv;
  }
  conv64_tile(r1, uni, w2, acc, row0, col, g);

  // ReLU + 2x2 ceil-mode pool over in-image taps only. Rows pair inside a
  // thread; columns pair with the neighbouring lane.
  const bool col_ok = c0 + col < W;
  float m[2][16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float v = -INFINITY;
#pragma unroll
      for (int k = 2 * t; k < 2 * t + 2; ++k)
        if (col_ok && r0 + row0 + k < H) v = fmaxf(v, fmaxf(acc[k][n], 0.f));
      m[t][n] = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    }
  }
  if ((col & 1) == 0) {
    const int hp = (H + 1) / 2, wp = (W + 1) / 2;
    const int pc = (c0 + col) >> 1;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int pr = ((r0 + row0) >> 1) + t;
      if (pr < hp && pc < wp) {
        T* o = out + (((size_t)blockIdx.z * hp + pr) * wp + pc) * kC + g * 16;
#pragma unroll
        for (int n = 0; n < 16; ++n) o[n] = from_f<T>(m[t][n]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
decode_tail_kernel(const T* __restrict__ y, const float* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ w1,
                   const float* __restrict__ b1, T* __restrict__ out, int h, int w) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* us = smem;                   // u window [64][18][20], then z halo [64][16][20]
  float* zs = smem;
  float* uni = smem + kInFloats;      // w2 chunks, then w1 [9][64][4]

  const int H = 2 * h, W = 2 * w;
  const int tid = threadIdx.x;
  const int R0 = blockIdx.y * kOut, C0 = blockIdx.x * kOut;
  const T* yb = y + (size_t)blockIdx.z * h * w * kC;

  // u rows/cols R0-2 .. R0+15 with edge clamping: up2x + reflect-pad.
  for (int i = tid; i < kIn * kIn * kC; i += kThreads) {
    const int ci = i & (kC - 1), p = i >> 6, s = p % kIn, q = p / kIn;
    const int yr = min(max(R0 - 2 + q, 0), H - 1) >> 1;
    const int yc = min(max(C0 - 2 + s, 0), W - 1) >> 1;
    us[ci * kChan + q * kRow + s] = to_f(yb[((size_t)yr * w + yc) * kC + ci]);
  }

  int g, row0, col;
  thread_map(tid, g, row0, col);
  float acc[4][16];
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float bv = __ldg(b2 + g * 16 + n);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k][n] = bv;
  }
  // z halo row i <-> z row R0-1+i (likewise columns).
  conv64_tile(us, uni, w2, acc, row0, col, g);
  __syncthreads();  // every read of the u window is done before z overwrites it
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int n = 0; n < 16; ++n)
      zs[(g * 16 + n) * kZChan + (row0 + k) * kRow + col] = fmaxf(acc[k][n], 0.f);
  for (int i = tid; i < 9 * kC * 4; i += kThreads) uni[i] = w1[i];
  __syncthreads();

  // Reflect the z halo: z(-1) = z(1), z(H) = z(H-2); rows, then columns.
  const int gi = H + 1 - R0, gj = W + 1 - C0;   // halo index of z row H / col W
  for (int i = tid; i < kC * kTile; i += kThreads) {
    float* zc = zs + (i >> 4) * kZChan;
    const int t = i & 15;
    if (R0 == 0) zc[t] = zc[2 * kRow + t];
    if (gi < kTile) zc[gi * kRow + t] = zc[(gi - 2) * kRow + t];
  }
  __syncthreads();
  for (int i = tid; i < kC * kTile; i += kThreads) {
    float* zc = zs + (i >> 4) * kZChan + (i & 15) * kRow;
    if (C0 == 0) zc[0] = zc[2];
    if (gj < kTile) zc[gj] = zc[gj - 2];
  }
  __syncthreads();

  // conv 64->3 on the 14x14 output tile, one pixel per thread.
  if (tid < kOut * kOut) {
    const int i = tid / kOut, j = tid % kOut;
    const float4* w1s = reinterpret_cast<const float4*>(uni);
    float o0 = __ldg(b1), o1 = __ldg(b1 + 1), o2 = __ldg(b1 + 2);
#pragma unroll 4
    for (int ci = 0; ci < kC; ++ci) {
      const float* zc = zs + ci * kZChan + i * kRow + j;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float zv = zc[dy * kRow + dx];
          const float4 wv = w1s[(dy * 3 + dx) * kC + ci];
          o0 = fmaf(zv, wv.x, o0);
          o1 = fmaf(zv, wv.y, o1);
          o2 = fmaf(zv, wv.z, o2);
        }
    }
    const int R = R0 + i, C = C0 + j;
    if (R < H && C < W) {
      T* o = out + (((size_t)blockIdx.z * H + R) * W + C) * 3;
      o[0] = from_f<T>(o0);
      o[1] = from_f<T>(o1);
      o[2] = from_f<T>(o2);
    }
  }
}

template <typename T>
cudaError_t launch_encode(const void* x, const void* w1, const void* b1, const void* w2,
                          const void* b2, void* out, int B, int H, int W, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(encode_head_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  encode_head_kernel<T><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<T*>(out), H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_decode(const void* y, const void* w2, const void* b2, const void* w1,
                          const void* b1, void* out, int B, int h, int w, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(decode_tail_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((2 * w + kOut - 1) / kOut, (2 * h + kOut - 1) / kOut, B);
  decode_tail_kernel<T><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const T*>(y), static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w1), static_cast<const float*>(b1), static_cast<T*>(out), h, w);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). Weights are fp32:
//   w1 [3][3][3][64] (RGB conv folded in), b1 [64], w2 [3][3][64][64], b2 [64].
extern "C" int aip_encode_head(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* out,
                               int B, int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_encode<float>(x, w1, b1, w2, b2, out, B, H, W, s);
  if (dtype == 1) return (int)launch_encode<__nv_bfloat16>(x, w1, b1, w2, b2, out, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}

// dtype as above (y and out). Weights are fp32:
//   w2 [3][3][64][64], b2 [64], w1 [3][3][64][4] (4th channel zero), b1 [4].
extern "C" int aip_decode_tail(const void* y, const void* w2, const void* b2,
                               const void* w1, const void* b1, void* out,
                               int B, int h, int w, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_decode<float>(y, w2, b2, w1, b1, out, B, h, w, s);
  if (dtype == 1) return (int)launch_decode<__nv_bfloat16>(y, w2, b2, w1, b1, out, B, h, w, s);
  return (int)cudaErrorInvalidValue;
}
