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
// What bounds it on the H100: the atomics. Per point it reads 12 bytes of
// position and L * F * 4 bytes of upstream gradient, and issues L * 8 * F
// float32 adds into the table; the table is zeroed and written by the
// caller. The coarse dense levels are small (4,920 and 13,824 rows at
// levels 0 and 1) and every point hits them, so their global atomics would
// contend on a few thousand addresses. Those levels (whose rows fit in
// kSmemBytes of shared memory) are accumulated per block in shared memory,
// 2,048 points a block, and flushed with one global atomic per non-zero
// entry. The other levels go straight to global memory, one thread per
// (point, level), points fastest so that neighbouring threads read
// neighbouring positions. A point whose upstream gradient is zero at a
// level adds nothing and issues no atomics: the capacity's padded slots
// (all at one position, so all on the same 8 rows of every level) and
// Gaussians that no pixel saw would otherwise serialise on those rows.
//
// Plain C interface, bound with ctypes: the entry point returns the
// cudaError_t of its launches (0 on success). Launches go on the caller's
// stream and allocate nothing; grad must be zeroed by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kThreads = 256;
constexpr int kPointsPerSmemBlock = 2048;
constexpr int kSmemBytes = 112 * 1024;  // two such blocks fit one SM

struct LevelTable {
  int res[kMaxLevels];
  int dense[kMaxLevels];
  int size[kMaxLevels];     // effective rows of the level
  int level_of[kMaxLevels];  // blockIdx.y (smem pass) or level slot (global pass) -> level
};

__device__ __forceinline__ void corner_terms(const float* __restrict__ x01, long long n_idx,
                                             int res, int dense, int table_cap, int* idx,
                                             float* w) {
  const float fres = static_cast<float>(res);
  // __fmul_rn: the product is rounded before floorf and the subtraction,
  // as the forward rounds pos = x01 * res (no fused multiply-add).
  const float p[3] = {__fmul_rn(x01[n_idx * 3], fres), __fmul_rn(x01[n_idx * 3 + 1], fres),
                      __fmul_rn(x01[n_idx * 3 + 2], fres)};
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

// Shared-memory levels: grid (blocks per level, levels in this pass).
template <int F>
__global__ void __launch_bounds__(kThreads)
hash_grad_smem_kernel(const float* __restrict__ x01, const float* __restrict__ g_out,
                      float* __restrict__ grad, LevelTable lv, int n, int n_levels,
                      int table_cap) {
  extern __shared__ float s_acc[];
  const int l = lv.level_of[blockIdx.y];
  const int entries = lv.size[l] * F;
  for (int e = threadIdx.x; e < entries; e += kThreads) s_acc[e] = 0.f;
  __syncthreads();

  const long long p0 = static_cast<long long>(blockIdx.x) * kPointsPerSmemBlock;
  const long long p1 = p0 + kPointsPerSmemBlock < n ? p0 + kPointsPerSmemBlock : n;
  for (long long p = p0 + threadIdx.x; p < p1; p += kThreads) {
    float g[F];
    bool any = false;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      g[f] = g_out[p * n_levels * F + l * F + f];
      any |= g[f] != 0.f;
    }
    if (!any) continue;
    int idx[8];
    float w[8];
    corner_terms(x01, p, lv.res[l], lv.dense[l], table_cap, idx, w);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int f = 0; f < F; ++f) atomicAdd(&s_acc[idx[c] * F + f], w[c] * g[f]);
    }
  }
  __syncthreads();
  float* dst = grad + static_cast<long long>(l) * table_cap * F;
  for (int e = threadIdx.x; e < entries; e += kThreads) {
    const float v = s_acc[e];
    if (v != 0.f) atomicAdd(dst + e, v);
  }
}

// The other levels: one thread per (point, level slot), points fastest.
template <int F>
__global__ void __launch_bounds__(kThreads)
hash_grad_global_kernel(const float* __restrict__ x01, const float* __restrict__ g_out,
                        float* __restrict__ grad, LevelTable lv, int n, int n_levels,
                        int n_slots, int table_cap) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<long long>(n) * n_slots) return;
  const long long p = t % n;
  const int l = lv.level_of[t / n];
  float g[F];
  bool any = false;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    g[f] = g_out[p * n_levels * F + l * F + f];
    any |= g[f] != 0.f;
  }
  if (!any) return;
  int idx[8];
  float w[8];
  corner_terms(x01, p, lv.res[l], lv.dense[l], table_cap, idx, w);
  float* dst = grad + static_cast<long long>(l) * table_cap * F;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(dst + static_cast<long long>(idx[c]) * F + f,
                                          w[c] * g[f]);
  }
}

template <int F>
int launch(const float* x01, const float* g_out, float* grad, const int* levels, int n,
           int n_levels, int table_cap, cudaStream_t s) {
  LevelTable smem_lv = {}, glob_lv = {};
  int n_smem = 0, n_glob = 0, max_entries = 0;
  for (int l = 0; l < n_levels; ++l) {
    const int res = levels[3 * l], dense = levels[3 * l + 1], size = levels[3 * l + 2];
    smem_lv.res[l] = glob_lv.res[l] = res;
    smem_lv.dense[l] = glob_lv.dense[l] = dense;
    smem_lv.size[l] = glob_lv.size[l] = size;
    if (static_cast<long long>(size) * F * 4 <= kSmemBytes) {
      smem_lv.level_of[n_smem++] = l;
      if (size * F > max_entries) max_entries = size * F;
    } else {
      glob_lv.level_of[n_glob++] = l;
    }
  }
  if (n_smem > 0) {
    const int bytes = max_entries * 4;
    cudaError_t err = cudaFuncSetAttribute(hash_grad_smem_kernel<F>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + kPointsPerSmemBlock - 1) / kPointsPerSmemBlock, n_smem);
    hash_grad_smem_kernel<F><<<grid, kThreads, bytes, s>>>(x01, g_out, grad, smem_lv, n,
                                                            n_levels, table_cap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_glob > 0) {
    const long long threads = static_cast<long long>(n) * n_glob;
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
    hash_grad_global_kernel<F><<<blocks, kThreads, 0, s>>>(x01, g_out, grad, glob_lv, n,
                                                           n_levels, n_glob, table_cap);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x01 [n, 3] float32 in [0, 1]; g_out [n, n_levels * n_feat] float32; grad
// [n_levels, table_cap, n_feat] float32, zeroed; levels: host int array of
// (res, dense, effective size) per level. n_feat must be 1, 2 or 4.
extern "C" int aip_hash_grad(const float* x01, const float* g_out, float* grad,
                             const int* levels, int n, int n_levels, int table_cap, int n_feat,
                             void* stream) {
  if (n <= 0) return 0;
  if (n_levels > kMaxLevels || (table_cap & (table_cap - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_feat) {
    case 1: return launch<1>(x01, g_out, grad, levels, n, n_levels, table_cap, s);
    case 2: return launch<2>(x01, g_out, grad, levels, n, n_levels, table_cap, s);
    case 4: return launch<4>(x01, g_out, grad, levels, n, n_levels, table_cap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
