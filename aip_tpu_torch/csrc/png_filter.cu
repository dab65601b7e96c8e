// The PNG writer's card half (sm_90a): quantise an image and filter its
// scanlines, one block a row, in one launch.
//
// Replaces no Pallas kernel: aip_tpu writes its images through PIL on the
// host. In the port the request cells spent 120-190 ms a request in that
// write (an H100's host, 8 cores): the fp32 output's 4.2 MB pageable fetch,
// numpy's rounding, PIL's per-row filter choice (about 27 ms at 683x512 RGB)
// and zlib in one thread. This kernel leaves the host only the deflate
// (utils/png.py, in strips across threads), and the fetch a quarter of the
// bytes.
//
//   8-bit  (aip_png_filter_u8): x [H, L] fp32, L = W x bpp, bpp 1, 3 or 4
//          channels; each sample clipped to [0, 1], then floor(x * 255 +
//          0.5) in fp32, each step rounded as numpy rounds it (no FMA
//          contraction). A NaN gives 0, as numpy's cast of its NaN does.
//   16-bit (aip_png_filter_u16): d [H, W] fp32 (or float64) and its
//          [min, max] in the same type, each widened to float64 in
//          registers (exact); (d - min) / (max - min), then
//          floor(norm * 65535 + 0.5) in float64 in that order (a map with
//          max - min not above 0 gives 0), written big-endian, bpp 2.
//
// Filtered (filter != 0): out [H, 1 + L], each row its filter type and the
// row filtered by it. The type is the one of PNG's five (None, Sub, Up,
// Average, Paeth) with the smallest sum of |byte as a signed char| over the
// row, the lowest type on a tie (libpng's heuristic). The choice is integer
// arithmetic on the quantised bytes, so the plain version
// (kernels/png_filter.py::filter_rows) gives the same bytes.
// Unfiltered (filter == 0): out [H, L], the quantised bytes alone (the
// JPEG path's pixels).
//
// What bounds it on the H100: bytes, 4 (or 2) read and 1 written a byte
// of output, ~20 integer operations a byte: the floor is (in + out
// bytes) / 3.35 TB/s, 1.6 us for 512x683 RGB; launch latency sets its time.
//
// Design: one block per row, its threads over the row's bytes. A thread
// quantises each byte it needs itself (the byte, its left neighbour a pixel
// back, the two above): four reads of neighbouring addresses a warp, served
// from L1 and L2, so no shared row buffer and no limit on the width. A
// first pass sums each filter's cost, one reduction picks the type, a
// second pass writes the chosen filter's bytes.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFilters = 5;

// The quantised byte i of row r, 0 outside the image (row -1, bytes
// before 0): what PNG's filters take for the missing neighbours.
struct Src8 {
  const float* x;
  int l;
  __device__ __forceinline__ int operator()(int r, int i) const {
    if (r < 0 || i < 0) return 0;
    const float v = fminf(fmaxf(x[static_cast<long long>(r) * l + i], 0.0f), 1.0f);
    return static_cast<int>(floorf(__fadd_rn(__fmul_rn(v, 255.0f), 0.5f)));
  }
};

template <class T>
struct Src16 {
  const T* d;
  int w;
  double lo, extent;
  __device__ __forceinline__ int operator()(int r, int i) const {
    if (r < 0 || i < 0 || !(extent > 0.0)) return 0;
    const double v = static_cast<double>(d[static_cast<long long>(r) * w + (i >> 1)]);
    const double norm = __ddiv_rn(__dsub_rn(v, lo), extent);
    const unsigned q = static_cast<unsigned>(floor(__dadd_rn(__dmul_rn(norm, 65535.0), 0.5)));
    return (i & 1) ? static_cast<int>(q & 0xFFu) : static_cast<int>(q >> 8);
  }
};

__device__ __forceinline__ int paeth(int a, int b, int c) {
  const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

// The predictor of filter t for the byte x with neighbours a (left), b (up),
// c (up-left).
__device__ __forceinline__ int predict(int t, int a, int b, int c) {
  switch (t) {
    case 1: return a;
    case 2: return b;
    case 3: return (a + b) >> 1;
    case 4: return paeth(a, b, c);
    default: return 0;
  }
}

__device__ __forceinline__ unsigned cost(int v) {
  const int s = static_cast<signed char>(static_cast<unsigned char>(v & 0xFF));
  return static_cast<unsigned>(s < 0 ? -s : s);
}

template <class Src>
__device__ void filter_row(const Src& src, uint8_t* out, int l, int bpp, int filtered) {
  const int r = blockIdx.x;
  if (!filtered) {
    uint8_t* row = out + static_cast<long long>(r) * l;
    for (int i = threadIdx.x; i < l; i += kThreads) row[i] = static_cast<uint8_t>(src(r, i));
    return;
  }
  uint8_t* row = out + static_cast<long long>(r) * (l + 1);
  unsigned sums[kFilters] = {0u, 0u, 0u, 0u, 0u};
  for (int i = threadIdx.x; i < l; i += kThreads) {
    const int x = src(r, i), a = src(r, i - bpp), b = src(r - 1, i), c = src(r - 1, i - bpp);
#pragma unroll
    for (int t = 0; t < kFilters; ++t) sums[t] += cost(x - predict(t, a, b, c));
  }
  __shared__ unsigned partial[kFilters][kWarps];
  __shared__ int best;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kFilters; ++t) {
    unsigned s = sums[t];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xFFFFFFFFu, s, o);
    if (lane == 0) partial[t][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int pick = 0;
    unsigned least = 0u;
    for (int t = 0; t < kFilters; ++t) {
      unsigned s = 0u;
      for (int k = 0; k < kWarps; ++k) s += partial[t][k];
      if (t == 0 || s < least) {
        least = s;
        pick = t;
      }
    }
    best = pick;
    row[0] = static_cast<uint8_t>(pick);
  }
  __syncthreads();
  const int t = best;
  for (int i = threadIdx.x; i < l; i += kThreads) {
    const int x = src(r, i), a = src(r, i - bpp), b = src(r - 1, i), c = src(r - 1, i - bpp);
    row[1 + i] = static_cast<uint8_t>((x - predict(t, a, b, c)) & 0xFF);
  }
}

__global__ void __launch_bounds__(kThreads)
    png_filter_u8_kernel(const float* x, uint8_t* out, int l, int bpp, int filtered) {
  filter_row(Src8{x, l}, out, l, bpp, filtered);
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    png_filter_u16_kernel(const T* d, const T* minmax, uint8_t* out, int w) {
  const double lo = static_cast<double>(minmax[0]);
  filter_row(Src16<T>{d, w, lo, __dsub_rn(static_cast<double>(minmax[1]), lo)}, out, 2 * w, 2, 1);
}

// A row's cost sums stay below 2^31 (128 a byte).
constexpr int kMaxRowBytes = 1 << 24;

}  // namespace

extern "C" int aip_png_filter_u8(const void* x, void* out, int h, int l, int bpp, int filtered,
                                 void* stream) {
  if (h < 1 || l < 1 || l >= kMaxRowBytes || bpp < 1 || bpp > 4 || l % bpp)
    return (int)cudaErrorInvalidValue;
  png_filter_u8_kernel<<<h, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<uint8_t*>(out), l, bpp, filtered);
  return (int)cudaGetLastError();
}

// f64: d and minmax are float64, else fp32.
extern "C" int aip_png_filter_u16(const void* d, const void* minmax, void* out, int h, int w,
                                  int f64, void* stream) {
  if (h < 1 || w < 1 || w >= kMaxRowBytes / 2) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (f64)
    png_filter_u16_kernel<<<h, kThreads, 0, s>>>(static_cast<const double*>(d),
                                                  static_cast<const double*>(minmax),
                                                  static_cast<uint8_t*>(out), w);
  else
    png_filter_u16_kernel<<<h, kThreads, 0, s>>>(static_cast<const float*>(d),
                                                  static_cast<const float*>(minmax),
                                                  static_cast<uint8_t*>(out), w);
  return (int)cudaGetLastError();
}
