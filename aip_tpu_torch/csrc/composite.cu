// Macro-block Gaussian compositors for Hopper (sm_90a): the segment walk and
// the windowed walk, one kernel template.
//
// Replaces two TPU kernels of aip_tpu/ops/pallas/composite.py:
//   * composite_macro_mxu_seg_pallas (:442, the _make_mxu_seg_kernel :367):
//     block b walks positions [starts[b], starts[b] + counts[b]) of the
//     (block, depth)-sorted list;
//   * composite_macro_mxu_pallas (:509, the _make_mxu_kernel :290): block b
//     walks positions [b * Kc, b * Kc + counts[b]) of a [M, Kc] window
//     (valid rows are a prefix).
// Block b of a launch is macro block block0 + b of the image: the sharded
// renderer composites one strip of blocks a shard (block0 = 0 otherwise).
// Position i of a list is row i of the packed table [N, 16], or, with an
// index (the selection's gid_s or macro_idx), row index[i]: the kernel reads
// the rows through the index itself, so no [S, 16] or [M, Kc, 16] copy of
// the table is made in front of it. An index outside [0, N) is an empty row
// (the selection never puts one inside a count). A row is [mx, my, conic a,
// b, c, log(opacity), r, g, b, pad x7]. For every pixel (px, py) of the
// bs x bs macro block at ((g % mtw) * bs, (g / mtw) * bs), g = block0 + b,
// rows front to
// back:
//   power = log(opacity) - (a dx^2 + c dy^2) / 2 - b dx dy
//   alpha = min(0.99, exp(min(power, 0))), and 0 below 1/255
//   colour += alpha * T * rgb while T > 1e-4;  T *= 1 - alpha
// then out = colour + T * bg, written as [M, 3, 1, bs * bs] planes.
//
// What bounds it on the H100: per (row, pixel) pair about 15 float32
// operations and an expf, against one 64-byte row read (36 bytes used) per
// 64 x 64 pixels: thousands of operations a byte, so the CUDA cores' float32
// rate bounds it (67 TFLOP/s, H100 SXM data sheet), not memory. But most
// pairs need no work: on the served frames only 16-24 % of the walked
// (row, pixel) pairs lie in a 16 x 16 sub-tile that the row reaches with
// alpha >= 1/255 (PERF.md), and a row below 1/255 at every pixel of a
// sub-tile changes nothing there. So this kernel walks only those pairs
// (the live bound counts the pairs with alpha >= 1/255 themselves): about
// 30 issued instructions a walked pair (the power in the plain order, the
// expf, the gates, the colour), issue-bound at about 4 pairs per SM per
// clock, plus a float64 test per (row, sub-tile) and a cluster vote per
// group. It reaches well under that (PERF.md): warps whose sub-tile has
// fewer live rows wait at each group's barrier for the others.
//
// The design.
// * Sub-tiles and live rows. The macro block is cut into sub-tiles of 16 x SH
//   pixels (SH = 16 by default). While a group of 64 rows is staged in shared
//   memory, the block tests every (row, sub-tile) with aip_cull's float64
//   test (csrc/cull.cuh, whose note gives the margins): a row goes from a
//   sub-tile only when alpha < 1/255 is proved at every pixel centre there.
//   Rows carry log(opacity), so the test's ln_op is the row's own value.
//   One ballot per 32 rows gives each sub-tile a 64-bit mask of its live
//   rows; its warps walk the set bits in order (the live list, in list
//   order). Skipping a row is exact: its alpha is below 1/255 at every
//   pixel of the sub-tile, where the walk's own branch already makes it a
//   no-op.
// * Pixels a thread, warps, blocks. A warp covers 16 columns x 2 P rows of
//   one sub-tile, P pixels a thread in one column (P = 4 by default), so a
//   staged row is read once (three 16-byte shared loads) for P pixels and
//   dx, a dx^2 and b dx once a column. A thread block holds min(256 P,
//   bs^2) pixels in 256 or fewer threads; a macro block of 64 px is a
//   cluster of bs^2 / (256 P) blocks (4 at P = 4), so the 169 macro blocks
//   of an 800^2 frame fill the card with 676 blocks (one block a macro
//   block left 95 of 132 SMs with one and 37 with two), and a long list no
//   longer leaves one SM walking alone.
// * The early exit, exact. At every 64-row group start of the block's
//   list the macro block stops when no pixel of it has T > 1e-4, as the
//   TPU kernel skips saturated groups and the plain version weights the
//   background at that point. Each thread block votes (__syncthreads_or);
//   in a cluster, each block writes its vote into every block's shared
//   memory (two slots by group parity) and arrives at the cluster barrier
//   (barrier.cluster.arrive.release). A block with a live pixel knows the
//   macro block goes on, walks the group and waits for the others only
//   after it (barrier.cluster.wait.acquire), so the blocks of a cluster
//   drift up to a group apart instead of stepping together; a block with
//   none waits first and reads the votes. Every block of the macro block
//   leaves at the same group. Group starts count rows of the list, not
//   live rows.
// * Rounding. Each pixel's walk is sequential front to back in float32,
//   every operation written with a round-to-nearest intrinsic (__fmul_rn,
//   __fadd_rn, ...) in the plain version's order, so nvcc contracts nothing:
//   the power and alpha are the plain version's bits (the 1/255 cutoff
//   cannot flip between them), every layout rounds alike (the sweep's agree
//   bit for bit), and the kernel equals its emulation in plain torch
//   (composite_macro_walk_reference) bit for bit. The plain version's
//   exp(cumsum(log1p)) transmittance rounds otherwise, so kernel and plain
//   version agree within the stated tolerance (the 1e-4 cutoff can flip).
// * Staging. Each block stages the group's rows itself (the index, then the
//   row's 36 used bytes as three 16-byte loads) through registers one group
//   ahead, so the next group's loads are in flight while this one is culled
//   and walked; the fp64 terms of each row (the margin's factor, the
//   vertices' slopes) are computed once a group, the (row, sub-tile) tests
//   spread over all threads. The 256-thread layouts are held to 64
//   registers (four blocks an SM; a few bytes spill at P = 4).
// Segments may start at any row; counts clip to kc and to the list's end.
// Blocks that hang over the image edge are computed whole; the caller crops.
// Left for later: staging once per cluster (TMA multicast into distributed
// shared memory; each block stages the group itself now, 8 reads of a row
// through L2), and tensor cores for the quadratic form.
//
// Plain C interface, bound with ctypes: the entry point returns the
// cudaError_t of its launch (0 on success). Launches go on the caller's
// stream and allocate nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "cull.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 64;      // rows staged per pass, and the exit's group
constexpr int kSubW = 16;       // sub-tile width
constexpr int kMaxCluster = 8;  // portable cluster size
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kTMin = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

template <int BS, int SH, int P>
struct Layout {
  static constexpr int kPixels = BS * BS;
  static constexpr int kBlockPixels = kPixels < 256 * P ? kPixels : 256 * P;
  static constexpr int kThreads = kBlockPixels / P;
  static constexpr int kCluster = kPixels / kBlockPixels;  // blocks a macro block
  static constexpr bool kValid = SH <= BS && BS % SH == 0 && SH % (2 * P) == 0 &&
                                 kBlockPixels % (kSubW * SH) == 0 && kThreads % 32 == 0 &&
                                 kCluster <= kMaxCluster;
  static constexpr int kSubs = kValid ? kBlockPixels / (kSubW * SH) : 1;  // sub-tiles a block
  static constexpr int kWarpsPerSub = kValid ? SH / (2 * P) : 1;
  static constexpr int kSubsX = BS / kSubW;  // sub-tiles across the macro block
};

struct Args {
  const float* table;
  long long table_rows;
  const int* index;     // null: position i is row i
  long long index_len;
  const int* starts;    // null: the window, block b at b * kc
  const int* counts;
  const float* bg;
  float* out;
  int kc, mtw;
  long long block0;     // image block of launch block 0
};

// Element e < 3 * 64 of the group at list position g0 (row e / 3, float4
// e % 3) for thread t: e = t + k * threads. An index outside the table
// gives an empty row: log(opacity) -inf, culled everywhere and alpha 0 if
// walked.
template <int kThreads, int kLoads>
__device__ __forceinline__ void fetch_group(const Args& args, long long first, long long g0,
                                            long long count, float4 (&ahead)[kLoads]) {
  const float4* rows4 = reinterpret_cast<const float4*>(args.table);
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int r = e / 3, q = e - 3 * (e / 3);
    if (e < 3 * kGroup && g0 + r < count) {
      long long id = first + g0 + r;
      if (args.index) id = __ldg(args.index + id);
      if (id >= 0 && id < args.table_rows) {
        ahead[k] = __ldg(rows4 + id * 4 + q);
      } else {
        ahead[k] = q == 0 ? make_float4(0.f, 0.f, 1.f, 0.f)
                          : make_float4(q == 1 ? 1.f : 0.f, q == 1 ? -CUDART_INF_F : 0.f, 0.f,
                                        0.f);
      }
    }
  }
}

// The split cluster barrier: arrive (publishing this block's shared-memory
// writes to the cluster), and later wait for every block's arrival.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// At most 64 registers a thread for the 256-thread layouts: four blocks an SM.
template <int BS, int SH, int P>
__global__ void __launch_bounds__(Layout<BS, SH, P>::kThreads,
                                  Layout<BS, SH, P>::kThreads >= 256 ? 4 : 1)
composite_macro_kernel(const Args args) {
  using L = Layout<BS, SH, P>;
  __shared__ float4 s_rows[kGroup][3];
  __shared__ double s_factor[kGroup], s_sx[kGroup], s_sy[kGroup];
  __shared__ unsigned s_live[L::kSubs * 2];
  __shared__ int s_vote[2][kMaxCluster];

  const int rank = static_cast<int>(blockIdx.x % L::kCluster);
  const int b = static_cast<int>(blockIdx.x / L::kCluster);
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;

  const long long first = args.starts ? static_cast<long long>(args.starts[b])
                                      : static_cast<long long>(b) * args.kc;
  const long long span = args.index ? args.index_len : args.table_rows;
  long long count = args.counts[b];
  if (count > args.kc) count = args.kc;             // capacity, as the selection clips
  if (count > span - first) count = span - first;   // never read past the list
  if (first < 0 || count < 0) count = 0;

  // This thread's pixels: column lx, rows ly0 .. ly0 + P - 1 of the macro block.
  const int sub_local = warp / L::kWarpsPerSub;
  const int sub = rank * L::kSubs + sub_local;
  const int lx = (sub % L::kSubsX) * kSubW + (lane & 15);
  const int ly0 = (sub / L::kSubsX) * SH + (warp % L::kWarpsPerSub) * 2 * P + (lane >> 4) * P;
  const long long g = args.block0 + b;  // the block's place in the image
  const int bx0 = static_cast<int>(g % args.mtw) * BS, by0 = static_cast<int>(g / args.mtw) * BS;
  const float px = static_cast<float>(bx0 + lx), py0 = static_cast<float>(by0 + ly0);

  float trans[P], acc_r[P], acc_g[P], acc_b[P];
#pragma unroll
  for (int i = 0; i < P; ++i) trans[i] = 1.f, acc_r[i] = acc_g[i] = acc_b[i] = 0.f;

  if constexpr (L::kCluster > 1) cg::this_cluster().sync();  // every block has started

  // Rows are staged through registers one group ahead: the next group's
  // index and row loads are in flight while this group is culled and walked.
  constexpr int kLoads = (3 * kGroup + L::kThreads - 1) / L::kThreads;
  float4 ahead[kLoads] = {};
  fetch_group<L::kThreads, kLoads>(args, first, 0, count, ahead);
  for (long long g0 = 0; g0 < count; g0 += kGroup) {
    int live = 0;
#pragma unroll
    for (int i = 0; i < P; ++i) live |= trans[i] > kTMin;
    // Also the barrier that lets the previous group's rows be overwritten.
    live = __syncthreads_or(live);
    // In a cluster, a block with a live pixel knows that the macro block
    // goes on: it publishes its vote, arrives, and walks the group before it
    // waits for the others. A block without one waits for every vote first.
    bool waited = true;
    if constexpr (L::kCluster > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      const int parity = static_cast<int>((g0 / kGroup) & 1);
      if (t < L::kCluster) *cluster.map_shared_rank(&s_vote[parity][rank], t) = live;
      cluster_arrive();
      waited = !live;
      if (!live) {
        cluster_wait();
#pragma unroll
        for (int r = 0; r < L::kCluster; ++r) live |= s_vote[parity][r];
      }
    }
    if (!live) break;
    const int n = static_cast<int>(count - g0 < kGroup ? count - g0 : kGroup);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int e = t + k * L::kThreads;
      if (e < 3 * n) s_rows[e / 3][e % 3] = ahead[k];
    }
    fetch_group<L::kThreads, kLoads>(args, first, g0 + kGroup, count, ahead);
    __syncthreads();
    for (int r = t; r < n; r += L::kThreads) {
      const double a = s_rows[r][0].z, bb = s_rows[r][0].w, c = s_rows[r][1].x;
      s_factor[r] = aip_cull::margin_factor(a, bb, c);
      s_sx[r] = __ddiv_rn(-bb, c);
      s_sy[r] = __ddiv_rn(-bb, a);
    }
    __syncthreads();
    // Cull: bit r of sub-tile s's mask when row r may reach it.
    for (int e = t; e < L::kSubs * kGroup; e += L::kThreads) {
      const int s = e / kGroup, r = e % kGroup;
      bool keep = false;
      if (r < n) {
        const double f = s_factor[r];
        keep = true;
        if (!isnan(f)) {
          const float4 v0 = s_rows[r][0];
          const int gs = rank * L::kSubs + s;
          const double x0 = bx0 + (gs % L::kSubsX) * kSubW, y0 = by0 + (gs / L::kSubsX) * SH;
          const double q_min = aip_cull::box_qmin(v0.x, v0.y, v0.z, v0.w, s_rows[r][1].x,
                                                  s_sx[r], s_sy[r], x0, y0, kSubW, SH);
          keep = !aip_cull::proved_invisible(s_rows[r][1].y, q_min, f);
        }
      }
      const unsigned m = __ballot_sync(kFull, keep);
      if (lane == 0) s_live[e >> 5] = m;
    }
    __syncthreads();

    // Walk the sub-tile's live rows in list order.
    unsigned long long m = s_live[2 * sub_local] |
                           (static_cast<unsigned long long>(s_live[2 * sub_local + 1]) << 32);
    while (m) {
      const int r = __ffsll(static_cast<long long>(m)) - 1;
      m &= m - 1;
      const float4 v0 = s_rows[r][0];  // mx, my, a, b
      const float4 v1 = s_rows[r][1];  // c, log(opacity), red, green
      const float blue = s_rows[r][2].x;
      const float dx = __fsub_rn(px, v0.x);
      const float adx2 = __fmul_rn(__fmul_rn(v0.z, dx), dx);
      const float bdx = __fmul_rn(v0.w, dx);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float dy = __fsub_rn(py0 + static_cast<float>(i), v0.y);
        const float q2 = __fadd_rn(adx2, __fmul_rn(__fmul_rn(v1.x, dy), dy));
        const float power =
            __fadd_rn(__fsub_rn(__fmul_rn(-0.5f, q2), __fmul_rn(bdx, dy)), v1.y);
        const float alpha = fminf(0.99f, expf(fminf(power, 0.f)));
        if (alpha >= kAlphaMin) {
          const float tr = trans[i];
          if (tr > kTMin) {
            const float w = __fmul_rn(alpha, tr);
            acc_r[i] = __fadd_rn(acc_r[i], __fmul_rn(w, v1.z));
            acc_g[i] = __fadd_rn(acc_g[i], __fmul_rn(w, v1.w));
            acc_b[i] = __fadd_rn(acc_b[i], __fmul_rn(w, blue));
          }
          trans[i] = __fmul_rn(tr, __fsub_rn(1.f, alpha));
        }
      }
    }
    if constexpr (L::kCluster > 1) {
      if (!waited) cluster_wait();
    }
  }

  const float bg_r = args.bg[0], bg_g = args.bg[1], bg_b = args.bg[2];
  float* o = args.out + static_cast<long long>(b) * 3 * L::kPixels;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = (ly0 + i) * BS + lx;
    o[p] = __fadd_rn(acc_r[i], __fmul_rn(trans[i], bg_r));
    o[L::kPixels + p] = __fadd_rn(acc_g[i], __fmul_rn(trans[i], bg_g));
    o[2 * L::kPixels + p] = __fadd_rn(acc_b[i], __fmul_rn(trans[i], bg_b));
  }
}

template <int BS, int SH, int P>
int launch(const Args& args, int n_blocks, cudaStream_t stream) {
  using L = Layout<BS, SH, P>;
  if constexpr (!L::kValid) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(n_blocks) * L::kCluster);
    cfg.blockDim = dim3(L::kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = L::kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = L::kCluster > 1 ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, composite_macro_kernel<BS, SH, P>, args);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

// The layouts built: (SH, P) = (16, 4) for macro blocks of 16 and 32 px;
// the sweep's seven for 64 px (kernels/composite.py, LAYOUTS).
template <int BS>
int dispatch(const Args& args, int n_blocks, int sh, int p, cudaStream_t stream) {
  if (sh == 16 && p == 4) return launch<BS, 16, 4>(args, n_blocks, stream);
  if constexpr (BS == 64) {
    if (sh == 16 && p == 2) return launch<BS, 16, 2>(args, n_blocks, stream);
    if (sh == 16 && p == 8) return launch<BS, 16, 8>(args, n_blocks, stream);
    if (sh == 8 && p == 2) return launch<BS, 8, 2>(args, n_blocks, stream);
    if (sh == 8 && p == 4) return launch<BS, 8, 4>(args, n_blocks, stream);
    if (sh == 32 && p == 2) return launch<BS, 32, 2>(args, n_blocks, stream);
    if (sh == 32 && p == 4) return launch<BS, 32, 4>(args, n_blocks, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both walks. table [table_rows, 16] float32 (16-byte aligned); index
// [index_len] int32 or null; starts [n_blocks] int32 (the segment walk) or
// null (the window, block b at b * kc); counts [n_blocks] int32, clipped to
// kc; bg [3]; out [n_blocks, 3, 1, bs * bs]. bs 16, 32 or 64; sh x p a
// layout of the list above. block0 >= 0 offsets the blocks' image places.
extern "C" int aip_composite_macro(const float* table, long long table_rows, const int* index,
                                   long long index_len, const int* starts, const int* counts,
                                   const float* bg, float* out, int n_blocks, int kc, int bs,
                                   int mtw, int sh, int p, long long block0, void* stream) {
  if (n_blocks <= 0) return 0;
  if (kc < 0 || mtw < 1 || block0 < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args args{table, table_rows, index, index_len, starts, counts, bg, out, kc, mtw, block0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bs) {
    case 16: return dispatch<16>(args, n_blocks, sh, p, s);
    case 32: return dispatch<32>(args, n_blocks, sh, p, s);
    case 64: return dispatch<64>(args, n_blocks, sh, p, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
