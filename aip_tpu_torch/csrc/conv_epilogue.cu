// The conv epilogue of the VGG encoder and the AdaIN decoder (sm_90a):
// what runs between two 3x3 convs, in one pass over device memory.
//
// Replaces no Pallas kernel: aip_tpu leaves this chain (bias add, ReLU,
// pool or upsample, reflection pad) to XLA, which fuses it into the convs'
// neighbours. In the port each of those ops was a PyTorch pass of its own,
// and the reflection pad wrote NCHW, so cuDNN's NHWC bf16 kernel transposed
// every conv's input in and its output back: on an H100 at 32 x 512^2 bf16
// the chain took 31 of a batch's 48 device ms, the convs 7.3. This kernel
// writes the next conv's padded input NHWC-contiguous, so with channels_last
// weights cuDNN reads and writes NHWC and nothing else touches the
// activations.
//
//   in [N, H, W, C] bf16 (a raw conv output, bias not added)
//   -> + bias (optional, fp32 [C] holding the network's bf16 bias), rounded
//      to bf16 once, where PyTorch's add rounds
//   -> ReLU (optional)
//   -> 2x2 ceil-mode max pool, or nearest 2x upsample (optional)
//   -> 1-pixel reflection border (optional)
//   out [N, Ho+2, Wo+2, C] with the border, else [N, Ho, Wo, C].
//
// ReLU, max and copies are exact, so the output equals the PyTorch op chain
// bit for bit (NaNs propagate as PyTorch's relu and max_pool2d propagate
// them).
//
// What bounds it on the H100: bytes. Each input element is read once (a
// pooled one once, an upsampled one four times from cache) and each output
// element written once, ~0 operations a byte; the floor is (in + out bytes)
// / 3.35 TB/s.
//
// Design: one block per output row (n, py), its threads over the row's
// (pixel, 16-byte channel vector) pairs, so a warp's loads and stores are
// 16 bytes a thread on consecutive addresses. Each output pixel computes its
// reflected source coordinates itself: the border costs no second pass.
// Vectors are 8 channels where C and the pointers allow 16 bytes, else one
// element a thread.
//
// bf16 only: the walks route fp32 calls to the PyTorch chain, since cuDNN's
// fp32 convs (TF32 off) are NCHW kernels that would transpose around an NHWC
// epilogue.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
enum Resample { kNone = 0, kPool = 1, kUp = 2 };

constexpr int kVec = 8;   // bf16 channels in 16 bytes

// bf16 held as its 16 bits; to fp32 is exact, back rounds to nearest even
// (cvt.rn, as PyTorch rounds), two values an instruction when packing.
__device__ __forceinline__ float get(uint16_t s) {
  return __uint_as_float(static_cast<unsigned>(s) << 16);
}

__device__ __forceinline__ uint16_t put(float f) {
  uint16_t r;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(r) : "f"(f));
  return r;
}

__device__ __forceinline__ void unpack(uint4 u, float (&f)[kVec]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[kVec]) {
  unsigned w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)   // f[2j + 1] to the upper half, f[2j] to the lower
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w[j]) : "f"(f[2 * j + 1]), "f"(f[2 * j]));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

template <int V>
__device__ __forceinline__ void load(const uint16_t* p, float (&f)[V]) {
  if constexpr (V == kVec) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), f);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = get(p[j]);
  }
}

template <int V>
__device__ __forceinline__ void store(uint16_t* p, const float (&f)[V]) {
  if constexpr (V == kVec) {
    *reinterpret_cast<uint4*>(p) = pack(f);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = put(f[j]);
  }
}

// Bias (rounded to bf16, as PyTorch's add rounds), then ReLU.
template <int V>
__device__ __forceinline__ void activate(float (&v)[V], const float (&b)[V], bool has_bias,
                                         bool relu) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float x = v[j];
    if (has_bias) x = get(put(x + b[j]));
    if (relu) x = x != x ? x : fmaxf(x, 0.f);
    v[j] = x;
  }
}

// Mode arguments are uniform over the grid, so their branches cost no
// divergence; only the vector width is a template parameter (two kernels,
// one short build).
template <int V>
__global__ void __launch_bounds__(kThreads)
conv_epilogue_kernel(const uint16_t* __restrict__ in, const float* __restrict__ bias,
                     uint16_t* __restrict__ out, int h, int w, int c, int ho, int wo,
                     int relu, int resample, int border) {
  const int hp = border ? ho + 2 : ho, wp = border ? wo + 2 : wo;
  const int row = blockIdx.x;
  const int n = row / hp, py = row - n * hp;
  const int oy = border ? reflect(py - 1, ho) : py;
  const int cv = c / V;
  const uint16_t* img = in + static_cast<size_t>(n) * h * w * c;
  uint16_t* dst = out + static_cast<size_t>(row) * wp * c;
  const bool has_bias = bias != nullptr;
  for (int i = threadIdx.x; i < wp * cv; i += kThreads) {
    const int px = i / cv, k = (i - px * cv) * V;
    const int ox = border ? reflect(px - 1, wo) : px;
    float b[V] = {};
    if (has_bias) {
      if constexpr (V % 4 == 0) {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(bias + k) + q);
          b[4 * q] = t.x, b[4 * q + 1] = t.y, b[4 * q + 2] = t.z, b[4 * q + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) b[j] = __ldg(bias + k + j);
      }
    }
    float acc[V];
    if (resample == kPool) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int y = 2 * oy + dy;
        if (y >= h) break;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int x = 2 * ox + dx;
          if (x >= w) break;
          float v[V];
          load<V>(img + (static_cast<size_t>(y) * w + x) * c + k, v);
          activate<V>(v, b, has_bias, relu);
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (v[j] > acc[j] || v[j] != v[j]) acc[j] = v[j];
        }
      }
    } else {
      const int y = resample == kUp ? oy >> 1 : oy, x = resample == kUp ? ox >> 1 : ox;
      load<V>(img + (static_cast<size_t>(y) * w + x) * c + k, acc);
      activate<V>(acc, b, has_bias, relu);
    }
    store<V>(dst + static_cast<size_t>(px) * c + k, acc);
  }
}

template <int V>
cudaError_t launch(const void* in, const float* bias, void* out, int rows, int h, int w, int c,
                   int ho, int wo, int relu, int resample, int border, cudaStream_t stream) {
  conv_epilogue_kernel<V><<<rows, kThreads, 0, stream>>>(
      static_cast<const uint16_t*>(in), bias, static_cast<uint16_t*>(out), h, w, c, ho, wo,
      relu, resample, border);
  return cudaGetLastError();
}

}  // namespace

// in [n,h,w,c] bf16, contiguous; bias fp32 [c] or null; resample 0 none,
// 1 2x2 ceil-mode max pool, 2 nearest 2x upsample; border != 0: out
// [n,ho+2,wo+2,c] with a 1-pixel reflection border (ho, wo >= 2), else out
// [n,ho,wo,c]. Returns a cudaError_t.
extern "C" int aip_conv_epilogue(const void* in, const void* bias, void* out, int n, int h,
                                 int w, int c, int relu, int resample, int border,
                                 void* stream) {
  if (n < 1 || h < 1 || w < 1 || c < 1 || resample < kNone || resample > kUp)
    return (int)cudaErrorInvalidValue;
  const int ho = resample == kPool ? (h + 1) / 2 : (resample == kUp ? 2 * h : h);
  const int wo = resample == kPool ? (w + 1) / 2 : (resample == kUp ? 2 * w : w);
  if (border && (ho < 2 || wo < 2)) return (int)cudaErrorInvalidValue;
  const long long hp = border ? ho + 2 : ho, wp = border ? wo + 2 : wo;
  if (n * hp > INT_MAX || wp * c > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = c % kVec == 0 && (reinterpret_cast<uintptr_t>(in) |
                                     reinterpret_cast<uintptr_t>(out) |
                                     reinterpret_cast<uintptr_t>(bias)) % 16 == 0;
  const float* b = static_cast<const float*>(bias);
  const int rows = static_cast<int>(n * hp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = vec ? launch<kVec> : launch<1>;
  return (int)run(in, b, out, rows, h, w, c, ho, wo, relu, resample, border, s);
}
