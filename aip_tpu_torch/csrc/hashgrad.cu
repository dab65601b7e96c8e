// Hash-grid table gradient for Hopper (sm_90a): dL/dtable of the colour
// field's multires hash encoding.
//
// Replaces aip_tpu/ops/pallas/hashgrad.py:74 hash_grad_pallas (the
// pallas_call at :103), which the colour field's backward
// (aip_tpu/gs/colorfield.py:259-352, hash_encode_mxu) takes for tables of
// 2^16 rows and more. For every point n, level l and trilinear corner c:
//   grad[l, idx(n, l, c), f] += w(n, l, c) * g_out[n, l * F + f]
// with idx and w exactly those of the forward's _corner_index: the corner
// grid of pos = x01 * res, dense linear indexing where the level's
// (res + 1)^3 grid (8-aligned) fits the table, else the uint32 spatial hash
// (primes 1, 2654435761, 805459861) masked to the power-of-two table size.
//
// The TPU kernel turns the scatter into one-hot matmuls on the MXU, with
// bf16 operands. That is a matrix-unit device and does not carry over: here
// it is the float32 atomic scatter that tiny-cuda-nn's backward is. The sums
// are float32 throughout (the TPU path rounds each contribution to bf16
// first), and atomics add in an order that changes from run to run.
//
// Indices and weights are recomputed from x01 in the kernel rather than read
// from the [N, L, 8] arrays the plain version materialises: at 131,072
// points that saves reading 2 x 67 MB. The arithmetic is the forward's, op
// for op (one float32 multiply, floorf, a subtraction, the weight as
// (wx * wy) * wz), so every index matches the forward's bit for bit.
//
// What bounds it on the H100: the bytes, the table written once (67 MB of
// the served 85.5 MB), and the atomics (L * 8 a point). A table zeroed
// first and then scattered into fetches every zeroed line back from HBM
// (67 MB do not stay in the 50 MB L2) and writes it again: about 2.4 times
// the bound's bytes. So this kernel writes every entry itself, one level at
// a time: a level's slice (2^19 x 2 x 4 B = 4.2 MB at the served shape) is
// zeroed, then scattered into while it sits in L2, and each line goes to
// HBM once, when L2 evicts it.
//
// The design.
// * One persistent cooperative launch (every block resident, the grid at
//   most the resident block count) with a split barrier per phase of
//   kLevelsPerPhase levels (8.4 MB of slices at the served shape): each
//   block zeroes its share of phase p + 1's slices, arrives on phase p + 1's
//   counter (a release: barrier, fence, atomic add), and only then waits
//   for phase p's counter to reach the grid (an acquire) before it
//   scatters into phase p's slices. So the next slices are zeroed while
//   these are scattered, and by the time a block waits, the others have
//   long arrived. Each barrier still costs its fence and round trips: 2
//   levels a phase beat 1, and more did no better (the sweep in PERF.md).
//   The last block to finish sets the counters back to 0 for the next
//   launch on the stream (the wrapper keeps one counter array per stream).
// * Each block owns a contiguous range of points for every level; a
//   (point, level) whose upstream gradient is zero issues no atomics: the
//   capacity's padded slots (all at one position, so all on the same 8 rows
//   of every level) and Gaussians that no pixel saw would otherwise
//   serialise on those rows.
// * Vector atomics: a row's F features are one atomicAdd of a float2 (F =
//   2) or float4 (F = 4), global-memory atomics of compute capability 9.x;
//   and the two x-neighbour corners of a point, when their rows are the two
//   halves of an aligned pair (about half the time), one float4 (F = 2) or
//   float2 (F = 1). The L2 takes atomic requests at a rate that does not
//   grow with their width, so the count of requests, not of floats, sets
//   the pace: at F = 2 about 6 a (point, level) where scalar atomics took
//   16.
// * Each thread's first point stays in registers for every level, and its
//   next level's upstream gradient is loaded a level ahead, so the per-level
//   barrier does not also wait on a cold load.
// * The levels whose rows fit kSharedBytes of shared memory (level 0 of
//   the served table at F = 1 or 2, 4,920 rows; none at F = 4; every level
//   of a 2^10 table) are summed per block in shared memory first, before
//   the block waits for the level, and flushed with one vector atomic per
//   non-zero row: every point hits those few thousand rows, and their
//   global atomics would contend on them. A block holds some 500 points, so
//   a larger level (level 1, 13,824 rows) gains little from it and pays for
//   clearing and scanning its rows (the sweep in PERF.md).
//
// Plain C interface, bound with ctypes: the entry point returns the
// cudaError_t of its launch (0 on success). The launch goes on the caller's
// stream and allocates nothing; grad needs no zeroing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;
constexpr int kSharedBytes = 48 * 1024;  // a level this small is summed in shared memory
constexpr int kLevelsPerPhase = 2;       // levels zeroed together behind one barrier

struct Levels {
  int res[kMaxLevels];
  int dense[kMaxLevels];
  int size[kMaxLevels];    // effective rows of the level
  int shared[kMaxLevels];  // 1: summed in shared memory before the flush
};

struct Args {
  const float* x01;
  const float* g_out;
  float* grad;
  unsigned* sync;  // [kMaxLevels + 1]: arrivals per phase, then blocks done
  int n, n_levels, table_cap;
};

__device__ __forceinline__ void corner_terms(const float (&x)[3], int res, int dense,
                                             int table_cap, int* idx, float* w) {
  const float fres = static_cast<float>(res);
  // __fmul_rn: the product is rounded before floorf and the subtraction,
  // as the forward rounds pos = x01 * res (no fused multiply-add).
  const float p[3] = {__fmul_rn(x[0], fres), __fmul_rn(x[1], fres), __fmul_rn(x[2], fres)};
  float fr[3];
  int p0[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float f0 = floorf(p[d]);
    fr[d] = p[d] - f0;
    p0[d] = static_cast<int>(f0);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
    int ix = p0[0] + ox, iy = p0[1] + oy, iz = p0[2] + oz;
    if (dense) {
      ix = min(ix, res);
      iy = min(iy, res);
      iz = min(iz, res);
      idx[c] = ix + (res + 1) * (iy + (res + 1) * iz);
    } else {
      const uint32_t h = static_cast<uint32_t>(ix) * 1u ^ static_cast<uint32_t>(iy) * 2654435761u ^
                         static_cast<uint32_t>(iz) * 805459861u;
      idx[c] = static_cast<int>(h & static_cast<uint32_t>(table_cap - 1));
    }
    const float wx = ox ? fr[0] : 1.0f - fr[0];
    const float wy = oy ? fr[1] : 1.0f - fr[1];
    const float wz = oz ? fr[2] : 1.0f - fr[2];
    w[c] = __fmul_rn(__fmul_rn(wx, wy), wz);
  }
}

// One row's F features added to global memory as one vector atomic.
template <int F>
__device__ __forceinline__ void add_row(float* dst, const float (&v)[F]) {
  if constexpr (F == 1) {
    atomicAdd(dst, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
    atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  }
}

// Corners c and c + 1 differ only in x. Their rows are one row (a dense
// level clamped at res), the two halves of an aligned pair of rows (a hashed
// level's even ix: h and h ^ 1; a dense level's even index), or apart. An
// aligned pair of F = 1 or 2 rows takes one float2 or float4 atomic, so a
// point issues about 6 atomics a level instead of 8: the L2's atomic units
// take a fixed number of requests a clock whatever their width.
// Rows 2k and 2k + 1 (F = 1 or 2) as one vector atomic at row 2k.
template <int F>
__device__ __forceinline__ void add_even_odd(float* row, const float (&even)[F],
                                             const float (&odd)[F]) {
  if constexpr (F == 1) {
    atomicAdd(reinterpret_cast<float2*>(row), make_float2(even[0], odd[0]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float4*>(row), make_float4(even[0], even[1], odd[0], odd[1]));
  }
}

template <int F>
__device__ __forceinline__ void add_pair(float* dst, int r0, int r1, float w0, float w1,
                                         const float (&g)[F]) {
  float v0[F], v1[F];
#pragma unroll
  for (int f = 0; f < F; ++f) v0[f] = w0 * g[f], v1[f] = w1 * g[f];
  if (r0 == r1) {
#pragma unroll
    for (int f = 0; f < F; ++f) v0[f] += v1[f];
    add_row<F>(dst + static_cast<long long>(r0) * F, v0);
  } else if (F < 4 && (r0 ^ r1) == 1) {
    if (r0 < r1) {
      add_even_odd<F>(dst + static_cast<long long>(r0) * F, v0, v1);
    } else {
      add_even_odd<F>(dst + static_cast<long long>(r1) * F, v1, v0);
    }
  } else {
    add_row<F>(dst + static_cast<long long>(r0) * F, v0);
    add_row<F>(dst + static_cast<long long>(r1) * F, v1);
  }
}

// One (point, level): its 8 corners' contributions, into shared memory
// (s_acc, one float atomic each) or global memory (dst, by x-pairs).
template <int F, bool kShared>
__device__ __forceinline__ void scatter(float* acc, const float (&x)[3], const float (&g)[F],
                                        int res, int dense, int table_cap) {
  int idx[8];
  float w[8];
  corner_terms(x, res, dense, table_cap, idx, w);
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    if constexpr (kShared) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        atomicAdd(&acc[idx[c] * F + f], w[c] * g[f]);
        atomicAdd(&acc[idx[c + 1] * F + f], w[c + 1] * g[f]);
      }
    } else {
      add_pair<F>(acc, idx[c], idx[c + 1], w[c], w[c + 1], g);
    }
  }
}

// The upstream gradient of point p at level l.
template <int F>
__device__ __forceinline__ void load_upstream(const Args& a, long long p, int l, float (&g)[F]) {
  const float* src = a.g_out + (p * a.n_levels + l) * F;
  if constexpr (F == 1) {
    g[0] = src[0];
  } else if constexpr (F == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    g[0] = v.x, g[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(src);
    g[0] = v.x, g[1] = v.y, g[2] = v.z, g[3] = v.w;
  }
}

template <int F>
__device__ __forceinline__ bool nonzero(const float (&g)[F]) {
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) any |= g[f] != 0.f;
  return any;
}

__device__ __forceinline__ void load_position(const float* x01, long long p, float (&x)[3]) {
  x[0] = x01[p * 3], x[1] = x01[p * 3 + 1], x[2] = x01[p * 3 + 2];
}

// This block's share of one level's slice of `count` floats, set to 0.
__device__ __forceinline__ void zero_share(float* slice, long long count) {
  const long long nb = gridDim.x, b = blockIdx.x;
  if ((count & 3) == 0) {
    const long long n4 = count >> 2, per = (n4 + nb - 1) / nb;
    const long long e0 = b * per, e1 = e0 + per < n4 ? e0 + per : n4;
    float4* s4 = reinterpret_cast<float4*>(slice);
    for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) s4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    const long long per = (count + nb - 1) / nb;
    const long long e0 = b * per, e1 = e0 + per < count ? e0 + per : count;
    for (long long e = e0 + threadIdx.x; e < e1; e += kThreads) slice[e] = 0.f;
  }
}

// The split barrier: every thread's writes so far, published with the
// block's arrival on `counter`; and the wait until the whole grid arrived.
__device__ __forceinline__ void arrive(unsigned* counter) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
  }
}

__device__ __forceinline__ void wait_all(const unsigned* counter) {
  if (threadIdx.x == 0) {
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(counter) : "memory");
    } while (v < gridDim.x);
  }
  __syncthreads();
}

template <int F>
__global__ void __launch_bounds__(kThreads, 2)
hash_grad_kernel(const Args a, const Levels lv) {
  extern __shared__ float s_acc[];
  const long long slice = static_cast<long long>(a.table_cap) * F;
  const long long per = (a.n + gridDim.x - 1) / gridDim.x;
  const long long p0 = blockIdx.x * per < a.n ? blockIdx.x * per : a.n;
  const long long p1 = p0 + per < a.n ? p0 + per : a.n;
  const int t = threadIdx.x;

  // The thread's first point stays in registers for every level, and its
  // next level's upstream gradient is loaded a level ahead (at the served
  // shape a thread has one point). Further points, if any, load in place.
  const long long pa = p0 + t;
  const bool has_a = pa < p1;
  float xa[3] = {0.f, 0.f, 0.f}, ga[F] = {}, gn[F] = {};
  if (has_a) {
    load_position(a.x01, pa, xa);
    load_upstream<F>(a, pa, 0, ga);
  }

  constexpr int group = kLevelsPerPhase;
  const int phases = (a.n_levels + group - 1) / group;
  zero_share(a.grad, min(group, a.n_levels) * slice);
  arrive(a.sync);
  for (int l = 0; l < a.n_levels; ++l) {
    const int ph = l / group;
    const bool first = l % group == 0;  // the phase's first level waits for its zeroing
    if (has_a && l + 1 < a.n_levels) load_upstream<F>(a, pa, l + 1, gn);
    if (first && ph + 1 < phases) {
      zero_share(a.grad + (ph + 1) * group * slice,
                 min(group, a.n_levels - (ph + 1) * group) * slice);
      arrive(a.sync + ph + 1);
    }
    const int res = lv.res[l], dense = lv.dense[l];
    if (lv.shared[l]) {
      const int entries = lv.size[l] * F;
      for (int e = t; e < entries; e += kThreads) s_acc[e] = 0.f;
      __syncthreads();
      if (has_a && nonzero<F>(ga)) scatter<F, true>(s_acc, xa, ga, res, dense, a.table_cap);
      for (long long p = pa + kThreads; p < p1; p += kThreads) {
        float x[3], g[F];
        load_upstream<F>(a, p, l, g);
        if (!nonzero<F>(g)) continue;
        load_position(a.x01, p, x);
        scatter<F, true>(s_acc, x, g, res, dense, a.table_cap);
      }
      if (first) {
        wait_all(a.sync + ph);  // also the barrier after the shared sums
      } else {
        __syncthreads();
      }
      float* dst = a.grad + l * slice;
      for (int r = t; r < lv.size[l]; r += kThreads) {
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = s_acc[r * F + f];
        if (nonzero<F>(v)) add_row<F>(dst + static_cast<long long>(r) * F, v);
      }
      __syncthreads();  // s_acc is read before the next shared level clears it
    } else {
      if (first) wait_all(a.sync + ph);
      float* dst = a.grad + l * slice;
      if (has_a && nonzero<F>(ga)) scatter<F, false>(dst, xa, ga, res, dense, a.table_cap);
      for (long long p = pa + kThreads; p < p1; p += kThreads) {
        float x[3], g[F];
        load_upstream<F>(a, p, l, g);
        if (!nonzero<F>(g)) continue;
        load_position(a.x01, p, x);
        scatter<F, false>(dst, x, g, res, dense, a.table_cap);
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) ga[f] = gn[f];
  }

  // The last block out sets the counters back to 0 for the next launch.
  __syncthreads();
  if (t == 0) {
    __threadfence();
    if (atomicAdd(a.sync + kMaxLevels, 1u) == gridDim.x - 1) {
      for (int l = 0; l < a.n_levels; ++l) a.sync[l] = 0u;
      a.sync[kMaxLevels] = 0u;
    }
  }
}

template <int F>
int launch(const Args& a, const Levels& lv, int smem_bytes, cudaStream_t s) {
  auto kernel = hash_grad_kernel<F>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  // The grid, resident blocks a SM times SMs, for the last shared-memory
  // size launched on each device (one size for one table shape).
  static int grid[kMaxDevices] = {}, grid_smem[kMaxDevices] = {};
  if (grid[dev] == 0 || grid_smem[dev] != smem_bytes) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    grid[dev] = per_sm * sms;
    grid_smem[dev] = smem_bytes;
  }
  Args args = a;
  Levels levels = lv;
  void* params[] = {&args, &levels};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid[dev]),
                                    dim3(kThreads), params, static_cast<size_t>(smem_bytes), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x01 [n, 3] float32 in [0, 1]; g_out [n, n_levels * n_feat] float32; grad
// [n_levels, table_cap, n_feat] float32, every entry written here; levels:
// host int array of (res, dense, effective rows) per level; sync: device
// uint32 [33], zero before the first launch and left zero by every launch
// (one array per stream: launches that share it must not overlap).
// n_feat must be 1, 2 or 4.
extern "C" int aip_hash_grad(const float* x01, const float* g_out, float* grad,
                             const int* levels, unsigned* sync, int n, int n_levels,
                             int table_cap, int n_feat, void* stream) {
  if (n_levels <= 0) return 0;
  if (n < 0 || n_levels > kMaxLevels || table_cap <= 0 || (table_cap & (table_cap - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv = {};
  int smem_bytes = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.res[l] = levels[3 * l];
    lv.dense[l] = levels[3 * l + 1];
    lv.size[l] = levels[3 * l + 2];
    const long long bytes = static_cast<long long>(lv.size[l]) * n_feat * 4;
    lv.shared[l] = bytes <= kSharedBytes;
    if (lv.shared[l] && bytes > smem_bytes) smem_bytes = static_cast<int>(bytes);
  }
  const Args a{x01, g_out, grad, sync, n, n_levels, table_cap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_feat) {
    case 1: return launch<1>(a, lv, smem_bytes, s);
    case 2: return launch<2>(a, lv, smem_bytes, s);
    case 4: return launch<4>(a, lv, smem_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
