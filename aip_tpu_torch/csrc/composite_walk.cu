// Per-tile and coefficient Gaussian compositors for Hopper (sm_90a): the
// per-tile walk, the fused macro-to-tile walk and the macro-block
// coefficient walk.
//
// Replaces three TPU kernels of aip_tpu/ops/pallas/composite.py:
//   * composite_tiles_pallas (:154, pallas_call :168): every 16 x 16 tile
//     walks its own K gathered slots, front to back (walk_tiles_kernel);
//   * composite_from_macro_pallas (:102, pallas_call :128): every tile walks
//     its macro block's depth-sorted Kc slots, block
//     (tile / tile_w / macro) * macro_tile_w + (tile % tile_w) / macro. The
//     two share one kernel body on the TPU (_make_kernel :54); here the
//     fused walk has a kernel of its own (from_macro_kernel, below);
//   * composite_macro_blocks_pallas (:253, pallas_call :269, the kernel of
//     _make_block_kernel :193): every bs x bs macro block walks its Kc rows
//     of quadratic coefficients (macro_blocks_kernel).
//
// The per-tile walk (kernels 6 and 7), per pixel (px, py) and slot k:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, op exp(min(power, 0)))
//   alpha = 0 unless valid and alpha >= 1/255
//   colour += alpha T c while T > 1e-4;  T *= 1 - alpha;  out = colour + T bg
// with no early exit: T keeps falling past 1e-4 and weights the background,
// as on the TPU. Output [T, 3, 16, 16].
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
// What bounds them on the H100. Each (slot or row, pixel) pair that a walk
// evaluates costs 35 (kernel 5, P = 8) or 40 (kernel 7, P = 2) issued
// instructions, an IEEE expf among them (the SASS of the inner loops, the
// row's or slot's share included), so a walk is issue-bound at 3.2-3.6
// pairs per SM per clock (128 lanes), against the 12-17 float32 operations a
// pair that the bound counts at 67 TFLOP/s (H100 SXM, CUDA cores); the bytes
// are a few per pair. So none of the three can come near its bound by walking
// every pair: each walks only the pairs a float64 test cannot prove
// invisible. A splat far from a tile or sub-tile has alpha below 1/255 at
// every pixel of it, and the walk's own branch makes it a no-op there, so
// skipping it is exact; the tests are aip_cull's (csrc/cull.cuh, whose note
// gives the margins). Each kernel has a dense twin (the template with the
// cull off), reached only through the wrappers' private argument, that
// walks every pair: the card holds the two to the same bits. On the served
// lists kernels 5 and 7 keep 29 % of the dense pairs, 1.07 and 1.16 times
// the pairs with alpha >= 1/255, and evaluate about 2.1 of them per SM per
// clock each (at 1.98 GHz): 59 % and 67 % of that issue rate (PERF.md).
//
// Kernel 7, the per-tile walk (walk_tiles_kernel<CULL>). One block a tile,
// 128 threads, P = 2 pixels a thread: thread j at column j % 16 and rows
// (j / 16) P + i, i < P, so dx, a dx^2 and b dx are computed once a column.
// The block takes its list 256 slots at a time: each warp stages 32 slots
// at once (three 16-byte shared rows a slot) and tests them with
// aip_cull::slot_visible over the tile's 16 x 16 pixel centres (kernel A's
// test: invalid, opacity <= 0, or a positive definite conic proved
// invisible); one ballot a word of 32 slots; then every thread walks the
// live slots of each word in list order, branch-free (below 1/255 alpha is
// 0: T (1 - 0) and c + 0 colour are the same bits, as in the plain
// version). Two barriers a chunk, one at K <= 256; no separate pass for the
// list's end (a chunk past it has no live slot). Tried on view 0's served
// 800^2 lists (2500 tiles x 128 slots; H100 80GB HBM3, 700 W; ms over 100
// calls in one window): the walk's branches as in the plain version's order
// 0.0435; branch-free 0.0423, 0.0433 (kept); P = 1 0.0511, P = 2, 4 and 8
// 0.04210, 0.04213 and 0.04237 (P = 2 kept); a persistent grid (as many
// blocks as fit, each walking tiles b, b + G, ..., the next tile's slot
// arrays on their way by cp.async while it culls and walks one) 0.0531; 12
// blocks an SM by a register cap (40 registers, the cull spilling) 0.0452.
//
// Kernel 5, the coefficient walk (macro_blocks_kernel<BS, CULL>). One block
// a macro block: a walker warp for each 16 x 16 sub-tile (16 at bs = 64),
// P = 8 pixels a thread in one column (px, cxx px^2 and c0 + cx px computed
// once a column), and one stager warp. Per (row, sub-tile) the float64 test
// of aip_cull::coeff_proved_invisible (the row's exact quadratic of its
// float32 coefficients over the sub-tile's box of pixel centres, a margin
// of 8 u of its terms' sizes); rows that are not finite or not concave are
// kept, rows of opacity <= 0 go. One block barrier a 32-row group:
// * the barrier at each group start is the TPU kernel's exit test
//   (__syncthreads_or of the walkers' "a pixel has T > 1e-4"): the whole
//   block leaves there or walks the group. T at a group start does not
//   depend on the cull, so the block leaves at the same group as the dense
//   twin;
// * while the walkers walk group g, the stager loads group g + 2 into a
//   ring of three shared slots (lane r row r: coefficients and colour) and
//   computes the cull's per-row float64 terms once for all sub-tiles (ln
//   op, the stationary point and its value, the vertices' slopes;
//   aip_cull::coeff_terms); the barrier publishes them and frees the slot
//   of group g - 1, so no row is staged more than two groups past the exit;
// * each walker culls the group's 32 rows for its sub-tile (lane r row r,
//   one ballot) and walks the kept rows in list order, branch-free as
//   kernel 7.
// bs = 32 and 16 are the same with 4 walkers and 1. Tried on the served
// 1088x1920 rows of 8 cameras (510 blocks x 5120 rows; H100 80GB HBM3,
// 700 W; median over the cameras of ms over 100 calls in one window): 64
// threads a sub-tile at P = 4, the sub-tile's first warp culling for both,
// the walk's branches as in the plain version 0.2946, branch-free 0.2904;
// this design 0.2632, 0.2618, 0.2641 (kept); no block barrier (walkers
// leaving through a counter and flag a ring slot, the stager behind "full"
// and "empty" mbarriers, spin waits) 0.2742, 0.2720; that at two blocks an
// SM (56 registers, spills) 0.3316; that walking the blocks in descending
// count order (an argsort a call) 0.3129.
//
// Kernel 6, the fused walk (from_macro_kernel). Most of a macro block's
// (tile, slot) pairs need no work, as above. So:
// * One block a macro block (up to 1024 threads: 64 a tile, P = 4 pixels a
//   thread; a tile's threads hold column j % 16 and rows (j / 16) P .. + P -
//   1, so dx, a dx^2 and b dx are computed once a column). The block stages
//   each chunk of 512 slots of its list once for all its tiles (three
//   16-byte rows a slot, and per slot the float64 terms of the cull: ln op,
//   the margin's factor, the vertices' slopes); with one block a tile,
//   each tile read the whole list through L2. A macro block of more than
//   16 tiles (macro 5 and up) is split over several blocks, each staging
//   the list itself.
// * The cull, per (tile, slot), in float64: aip_cull's test over the
//   tile's 16 x 16 pixel centres, as kernel A's staging
//   (csrc/composite_ad.cu) runs it: a slot goes when it
//   is invalid, its opacity is <= 0, or its conic is positive definite and
//   ln op - (q_min / 2)(1 - 16 u rho) + 1e-6 < ln(float(1/255)). One ballot
//   per 32 slots gives each tile a mask of its live slots, walked in list
//   order. Skipping a culled slot is exact: its alpha is below 1/255 at
//   every pixel of the tile.
// * The macro blocks at the right and bottom edges hold fewer tiles (tile_w
//   and the tile rows need not be multiples of macro): the threads of a
//   tile past the edge stage and wait at the barriers with the others, and
//   cull, walk and write nothing.
// Each chunk costs three block barriers, and a tile with fewer live slots
// in a chunk waits at them for the others; 512-slot chunks ran faster than
// 256-slot ones on the served lists. A cull per warp's 16 x 8 pixels was
// tried too: it kept few fewer pairs and cost more than it saved.
//
// Plain C interface, bound with ctypes: each entry point returns the
// cudaError_t of its launch (0 on success). Launches go on the caller's
// stream and allocate nothing.

#include <cuda_runtime.h>

#include "cull.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kChunk = kThreads;  // slots staged and culled per pass of the per-tile walk
constexpr int kTilesP = 2;        // the per-tile walk's pixels a thread
constexpr int kGroup = 32;        // rows per exit test of the coefficient walk
constexpr int kBlockP = 8;        // the coefficient walk's pixels a thread
constexpr int kRing = 3;          // the coefficient walk's staged groups
constexpr int kFusedChunk = 512;  // slots staged per pass of the fused walk
constexpr int kFusedP = 4;        // the fused walk's pixels a thread
constexpr int kMaxBlockThreads = 1024;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <bool CULL>
__global__ void __launch_bounds__(kThreads / kTilesP)
walk_tiles_kernel(const float* __restrict__ mean, const float* __restrict__ conic,
                  const float* __restrict__ color, const float* __restrict__ op,
                  const float* __restrict__ valid, const float* __restrict__ bg,
                  float* __restrict__ out, int k, int tile_w) {
  constexpr int P = kTilesP;
  constexpr int kWarps = kThreads / P / 32;
  // Slot i of the chunk: [mx, my, a, b], [c, red, green, blue], [opacity, valid, -, -].
  __shared__ float4 s_slots[kChunk][3];
  __shared__ unsigned s_live[kChunk / 32];  // the chunk's live slots, a word per 32
  const long long tile = blockIdx.x;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int x0 = static_cast<int>(tile % tile_w) * kTile;
  const int y0 = static_cast<int>(tile / tile_w) * kTile;
  const int col = t % kTile, row0 = (t / kTile) * P;
  const float px = static_cast<float>(x0 + col), py0 = static_cast<float>(y0 + row0);
  const long long base = tile * k;

  float trans[P], acc_r[P], acc_g[P], acc_b[P];
#pragma unroll
  for (int p = 0; p < P; ++p) trans[p] = 1.f, acc_r[p] = acc_g[p] = acc_b[p] = 0.f;

  for (int c0 = 0; c0 < k; c0 += kChunk) {
    const int m = k - c0 < kChunk ? k - c0 : kChunk;
    const int words = (m + 31) >> 5;
    if (c0 > 0) __syncthreads();  // the previous chunk is walked
    // Stage and cull: warp w takes words w, w + kWarps, ...
    for (int w = warp; w < words; w += kWarps) {
      const int i = (w << 5) + lane;
      bool keep = false;
      if (i < m) {
        const long long s = base + c0 + i;
        const float v = valid[s];
        if (!CULL || v > 0.f) {
          const float mx = mean[2 * s], my = mean[2 * s + 1];
          const float ca = conic[3 * s], cb = conic[3 * s + 1], cc = conic[3 * s + 2];
          const float o = op[s];
          s_slots[i][0] = make_float4(mx, my, ca, cb);
          s_slots[i][1] = make_float4(cc, color[3 * s], color[3 * s + 1], color[3 * s + 2]);
          s_slots[i][2] = make_float4(o, v, 0.f, 0.f);
          keep = !CULL || aip_cull::slot_visible(mx, my, ca, cb, cc, o, x0, y0, kTile, kTile);
        }
      }
      const unsigned mask = __ballot_sync(kFull, keep);
      if (lane == 0) s_live[w] = mask;
    }
    __syncthreads();
    // Walk the live slots in list order.
    for (int w = 0; w < words; ++w) {
      unsigned mask = s_live[w];
      while (mask) {
        const int i = (w << 5) + __ffs(mask) - 1;
        mask &= mask - 1;
        const float4 v0 = s_slots[i][0];  // mx, my, a, b
        const float4 v1 = s_slots[i][1];  // c, red, green, blue
        const float2 v2 = make_float2(s_slots[i][2].x, s_slots[i][2].y);  // opacity, valid
        if (!CULL && !(v2.y > 0.f)) continue;
        const float dx = sub(px, v0.x);
        const float adxdx = mul(mul(v0.z, dx), dx), bdx = mul(v0.w, dx);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float dy = sub(py0 + static_cast<float>(p), v0.y);
          // -0.5 (a dx dx + c dy dy) - b dx dy, left to right.
          const float power = sub(mul(-0.5f, add(adxdx, mul(mul(v1.x, dy), dy))), mul(bdx, dy));
          const float al = fminf(0.99f, mul(v2.x, expf(fminf(power, 0.f))));
          const float alpha = al >= kAlphaMin ? al : 0.f;
          const float wgt = trans[p] > 1e-4f ? mul(alpha, trans[p]) : 0.f;
          acc_r[p] = add(acc_r[p], mul(wgt, v1.y));
          acc_g[p] = add(acc_g[p], mul(wgt, v1.z));
          acc_b[p] = add(acc_b[p], mul(wgt, v1.w));
          trans[p] = mul(trans[p], sub(1.f, alpha));
        }
      }
    }
  }
  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  float* o = out + tile * 3 * kThreads;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int pix = (row0 + p) * kTile + col;
    o[pix] = add(acc_r[p], mul(trans[p], bg_r));
    o[kThreads + pix] = add(acc_g[p], mul(trans[p], bg_g));
    o[2 * kThreads + pix] = add(acc_b[p], mul(trans[p], bg_b));
  }
}

// The fused walk's arguments: slot arrays [M, kc, .] per macro block, a
// grid of gx x gy macro blocks (the tiles' own, the edges included) split
// into `parts` blocks of up to tiles_per_block tiles each.
struct FusedArgs {
  const float* mean;
  const float* conic;
  const float* color;
  const float* op;
  const float* valid;
  const float* bg;
  float* out;
  int n_tiles, kc, tile_w, macro, macro_tile_w, gx, parts, tiles_per_block;
};

// Tile (tx, ty) of the image, or -1 where it lies past the right or bottom
// edge.
__device__ __forceinline__ long long tile_index(const FusedArgs& a, int tx, int ty) {
  const long long i = static_cast<long long>(ty) * a.tile_w + tx;
  return tx < a.tile_w && i < a.n_tiles ? i : -1;
}

__global__ void __launch_bounds__(kMaxBlockThreads, 1)
from_macro_kernel(const FusedArgs a) {
  constexpr int P = kFusedP;
  constexpr int kTileThreads = kThreads / P;  // two warps a tile
  constexpr int kWords = kFusedChunk / 32;
  // Slot i of the chunk: [mx, my, a, b], [c, red, green, blue], [opacity, -, -, -].
  __shared__ float4 s_slots[kFusedChunk][3];
  // The cull's float64 terms of slot i: ln op, 1 - 16 u rho, -b / c, -b / a.
  __shared__ double s_ln[kFusedChunk], s_factor[kFusedChunk], s_sx[kFusedChunk],
      s_sy[kFusedChunk];
  __shared__ unsigned char s_keep[kFusedChunk];  // valid, with opacity > 0
  __shared__ unsigned s_live[kMaxBlockThreads / kTileThreads][kWords];  // per tile
  __shared__ int s_end;

  const int part = static_cast<int>(blockIdx.x % a.parts);
  const int geo = static_cast<int>(blockIdx.x / a.parts);
  const int gbx = geo % a.gx, gby = geo / a.gx;
  const int t = threadIdx.x, lane = t & 31;
  const int lt0 = part * a.tiles_per_block;
  const int macro2 = a.macro * a.macro;

  // A block whose tiles all lie past the edge has nothing to do.
  bool any = false;
  for (int k = 0; k < a.tiles_per_block && lt0 + k < macro2; ++k)
    any |= tile_index(a, gbx * a.macro + (lt0 + k) % a.macro,
                      gby * a.macro + (lt0 + k) / a.macro) >= 0;
  if (!any) return;

  // This thread's tile and pixels: column col, rows row0 .. row0 + P - 1.
  const int local = t / kTileThreads;
  const int lt = lt0 + local;
  const int j = t % kTileThreads, warp_in_tile = j >> 5;
  const int tx = gbx * a.macro + lt % a.macro, ty = gby * a.macro + lt / a.macro;
  const long long tile = lt < macro2 ? tile_index(a, tx, ty) : -1;
  const int col = j % kTile, row0 = (j / kTile) * P;
  const float px = static_cast<float>(tx * kTile + col);
  const float py0 = static_cast<float>(ty * kTile + row0);
  const double x0 = tx * kTile, y0 = ty * kTile;

  const long long base = (static_cast<long long>(gby) * a.macro_tile_w + gbx) * a.kc;
  // n: one past the list's last valid slot (0 if it has none).
  if (t == 0) s_end = 0;
  __syncthreads();
  int end = 0;
  for (int i = t; i < a.kc; i += blockDim.x) {
    if (a.valid[base + i] > 0.f) end = i + 1;
  }
  end = __reduce_max_sync(kFull, end);
  if (lane == 0 && end > 0) atomicMax(&s_end, end);
  __syncthreads();
  const int n = s_end;

  float trans[P], acc_r[P], acc_g[P], acc_b[P];
#pragma unroll
  for (int i = 0; i < P; ++i) trans[i] = 1.f, acc_r[i] = acc_g[i] = acc_b[i] = 0.f;

  for (int c0 = 0; c0 < n; c0 += kFusedChunk) {
    const int m = n - c0 < kFusedChunk ? n - c0 : kFusedChunk;
    __syncthreads();  // every tile is done with the previous chunk
    // Stage: the chunk's slots and, for those that may be walked, the
    // float64 terms of the cull (once a slot, for all the block's tiles).
    for (int i = t; i < m; i += blockDim.x) {
      const long long s = base + c0 + i;
      const float o = a.op[s];
      const float ca = a.conic[3 * s], cb = a.conic[3 * s + 1], cc = a.conic[3 * s + 2];
      s_slots[i][0] = make_float4(a.mean[2 * s], a.mean[2 * s + 1], ca, cb);
      s_slots[i][1] = make_float4(cc, a.color[3 * s], a.color[3 * s + 1], a.color[3 * s + 2]);
      s_slots[i][2] = make_float4(o, 0.f, 0.f, 0.f);
      const bool keep = a.valid[s] > 0.f && !(o <= 0.f);
      s_keep[i] = keep;
      if (keep) {
        s_ln[i] = log(static_cast<double>(o));
        s_factor[i] = aip_cull::margin_factor(ca, cb, cc);
        s_sx[i] = __ddiv_rn(-static_cast<double>(cb), cc);
        s_sy[i] = __ddiv_rn(-static_cast<double>(cb), ca);
      }
    }
    __syncthreads();
    // Cull: bit i of the tile's word i / 32 when slot i may reach the tile
    // (the tile's warps test a word each in turn).
    const int words = (m + 31) >> 5;
    if (tile >= 0) {
      for (int w = warp_in_tile; w < words; w += kTileThreads / 32) {
        const int i = (w << 5) + lane;
        bool keep = false;
        if (i < m && s_keep[i]) {
          const double f = s_factor[i];
          keep = true;
          if (!isnan(f)) {
            const float4 v0 = s_slots[i][0];
            const double q_min = aip_cull::box_qmin(v0.x, v0.y, v0.z, v0.w, s_slots[i][1].x,
                                                    s_sx[i], s_sy[i], x0, y0, kTile, kTile);
            keep = !aip_cull::proved_invisible(s_ln[i], q_min, f);
          }
        }
        const unsigned mask = __ballot_sync(kFull, keep);
        if (lane == 0) s_live[local][w] = mask;
      }
    }
    __syncthreads();
    if (tile < 0) continue;
    // Walk the tile's live slots in list order.
    for (int w = 0; w < words; ++w) {
      unsigned mask = s_live[local][w];
      while (mask) {
        const int i = (w << 5) + __ffs(mask) - 1;
        mask &= mask - 1;
        const float4 v0 = s_slots[i][0];  // mx, my, a, b
        const float4 v1 = s_slots[i][1];  // c, red, green, blue
        const float o = s_slots[i][2].x;
        const float dx = sub(px, v0.x);
        const float adxdx = mul(mul(v0.z, dx), dx), bdx = mul(v0.w, dx);
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float dy = sub(py0 + static_cast<float>(p), v0.y);
          // -0.5 (a dx dx + c dy dy) - b dx dy, left to right.
          const float power = sub(mul(-0.5f, add(adxdx, mul(mul(v1.x, dy), dy))), mul(bdx, dy));
          const float alpha = fminf(0.99f, mul(o, expf(fminf(power, 0.f))));
          if (alpha >= kAlphaMin) {
            if (trans[p] > 1e-4f) {
              const float wgt = mul(alpha, trans[p]);
              acc_r[p] = add(acc_r[p], mul(wgt, v1.y));
              acc_g[p] = add(acc_g[p], mul(wgt, v1.z));
              acc_b[p] = add(acc_b[p], mul(wgt, v1.w));
            }
            trans[p] = mul(trans[p], sub(1.f, alpha));
          }
        }
      }
    }
  }
  if (tile < 0) return;
  const float bg_r = a.bg[0], bg_g = a.bg[1], bg_b = a.bg[2];
  float* o = a.out + tile * 3 * kThreads;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int pix = (row0 + p) * kTile + col;
    o[pix] = add(acc_r[p], mul(trans[p], bg_r));
    o[kThreads + pix] = add(acc_g[p], mul(trans[p], bg_g));
    o[2 * kThreads + pix] = add(acc_b[p], mul(trans[p], bg_b));
  }
}

int launch_from_macro(FusedArgs a, cudaStream_t s) {
  constexpr int kTileThreads = kThreads / kFusedP;
  constexpr int kMaxTiles = kMaxBlockThreads / kTileThreads;
  const int macro2 = a.macro * a.macro;
  a.parts = (macro2 + kMaxTiles - 1) / kMaxTiles;
  a.tiles_per_block = (macro2 + a.parts - 1) / a.parts;
  a.gx = (a.tile_w + a.macro - 1) / a.macro;
  const long long tile_rows = (a.n_tiles + a.tile_w - 1) / a.tile_w;
  const long long gy = (tile_rows + a.macro - 1) / a.macro;
  const long long blocks = gy * a.gx * a.parts;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  from_macro_kernel<<<static_cast<unsigned>(blocks), a.tiles_per_block * kTileThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int BS, bool CULL>
__global__ void __launch_bounds__((BS / kTile) * (BS / kTile) * 32 + 32, 1)
macro_blocks_kernel(const float* __restrict__ coeff, const float* __restrict__ colors,
                    const int* __restrict__ counts, const float* __restrict__ bg,
                    float* __restrict__ out, int kc) {
  constexpr int P = kBlockP;
  constexpr int kSubsX = BS / kTile;
  constexpr int kWalkers = kSubsX * kSubsX;  // a warp a sub-tile
  // Row r of a staged group: [c0, cx, cy, cxx], [cyy, cxy, opacity, 0], [red, green, blue, 0].
  __shared__ float4 s_rows[kRing][kGroup][3];
  // The cull's terms of row r (aip_cull::coeff_terms) and its class.
  __shared__ double s_terms[kRing][6][kGroup];
  __shared__ int s_cls[kRing][kGroup];

  const int blk = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool stager = warp == kWalkers;
  int count = counts[blk];
  count = count < 0 ? 0 : (count > kc ? kc : count);
  const int groups = (count + kGroup - 1) / kGroup;
  const long long first = static_cast<long long>(blk) * kc;
  const float4* cf = reinterpret_cast<const float4*>(coeff) + first * 2;
  const float4* cl = reinterpret_cast<const float4*>(colors) + first;
  // The stager: row r of group g into ring slot g % kRing (lane r), and its
  // class and terms.
  auto stage = [&](int g) {
    const int s = g % kRing, r = g * kGroup + lane;
    if (g >= groups || r >= count) return;
    const float4 v0 = cf[2 * r], v1 = cf[2 * r + 1];
    s_rows[s][lane][0] = v0;
    s_rows[s][lane][1] = v1;
    s_rows[s][lane][2] = cl[r];
    if (CULL) {
      const float c[6] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y};
      double terms[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      s_cls[s][lane] = aip_cull::coeff_terms(c, v1.z, terms);
#pragma unroll
      for (int i = 0; i < 6; ++i) s_terms[s][i][lane] = terms[i];
    }
  };
  if (stager) {
    stage(0);
    stage(1);
  }

  // A walker: sub-tile `warp`, thread j at column j % 16 and rows (j / 16) P
  // .. + P - 1.
  const int sx = (warp % kSubsX) * kTile, sy = (warp / kSubsX) * kTile;
  const int col = lane % kTile, row0 = (lane / kTile) * P;
  const float px = static_cast<float>(sx + col), py0 = static_cast<float>(sy + row0);
  const float bxx = mul(px, px);
  float trans[P], acc_r[P], acc_g[P], acc_b[P];
#pragma unroll
  for (int p = 0; p < P; ++p) trans[p] = 1.f, acc_r[p] = acc_g[p] = acc_b[p] = 0.f;

  for (int g = 0; g < groups; ++g) {
    int live = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) live |= !stager && trans[p] > 1e-4f;
    // The exit test at the group's start: the block walks the group unless
    // no walker has a pixel with T > 1e-4. The barrier also publishes group
    // g's rows and terms and frees the slot of group g - 1.
    if (!__syncthreads_or(live)) break;
    if (stager) {
      stage(g + 2);
      continue;
    }
    const int s = g % kRing;
    const int n = count - g * kGroup < kGroup ? count - g * kGroup : kGroup;
    const float4(*rows)[3] = s_rows[s];
    // The cull: bit r when row r may reach this sub-tile (lane r row r).
    unsigned mask = n == kGroup ? kFull : (1u << n) - 1u;
    if (CULL) {
      bool keep = false;
      if (lane < n) {
        const int cls = s_cls[s][lane];
        keep = cls == aip_cull::kRowKeep;
        if (cls == aip_cull::kRowTest) {
          const float4 v0 = rows[lane][0], v1 = rows[lane][1];
          const float c[6] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y};
          double terms[6];
#pragma unroll
          for (int i = 0; i < 6; ++i) terms[i] = s_terms[s][i][lane];
          keep = !aip_cull::coeff_proved_invisible(c, terms, sx, sy, kTile, kTile);
        }
      }
      mask = __ballot_sync(kFull, keep);
    }
    while (mask) {
      const int r = __ffs(mask) - 1;
      mask &= mask - 1;
      const float4 v0 = rows[r][0];  // c0, cx, cy, cxx
      const float4 v1 = rows[r][1];  // cyy, cxy, opacity
      const float4 c = rows[r][2];
      const float base = add(v0.x, mul(v0.y, px));
      const float cxx = mul(v0.w, bxx);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float py = py0 + static_cast<float>(p);
        const float power = add(add(add(add(base, mul(v0.z, py)), cxx), mul(v1.x, mul(py, py))),
                                mul(v1.y, mul(px, py)));
        const float al = fminf(0.99f, mul(v1.z, expf(fminf(power, 0.f))));
        // Branch-free: below 1/255 alpha is 0, T * (1 - 0) and c + 0 * colour
        // are the same bits, as in the plain version.
        const float alpha = al >= kAlphaMin ? al : 0.f;
        const float w = trans[p] > 1e-4f ? mul(alpha, trans[p]) : 0.f;
        acc_r[p] = add(acc_r[p], mul(w, c.x));
        acc_g[p] = add(acc_g[p], mul(w, c.y));
        acc_b[p] = add(acc_b[p], mul(w, c.z));
        trans[p] = mul(trans[p], sub(1.f, alpha));
      }
    }
  }
  if (stager) return;

  const float bg_r = bg[0], bg_g = bg[1], bg_b = bg[2];
  float* o = out + static_cast<long long>(blk) * 3 * BS * BS;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int pix = (sy + row0 + p) * BS + sx + col;
    o[pix] = add(acc_r[p], mul(trans[p], bg_r));
    o[BS * BS + pix] = add(acc_g[p], mul(trans[p], bg_g));
    o[2 * BS * BS + pix] = add(acc_b[p], mul(trans[p], bg_b));
  }
}

template <int BS, bool CULL>
int launch_blocks(const float* coeff, const float* colors, const int* counts, const float* bg,
                  float* out, int n_blocks, int kc, cudaStream_t s) {
  macro_blocks_kernel<BS, CULL><<<n_blocks, (BS / kTile) * (BS / kTile) * 32 + 32, 0, s>>>(
      coeff, colors, counts, bg, out, kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Per-tile walk: mean [n_tiles, k, 2], conic and colour [n_tiles, k, 3],
// opacity and valid [n_tiles, k]; dense: the twin that walks every slot.
extern "C" int aip_composite_tiles(const float* mean, const float* conic, const float* color,
                                   const float* op, const float* valid, const float* bg,
                                   float* out, int n_tiles, int k, int tile_w, int dense,
                                   void* stream) {
  if (n_tiles <= 0) return 0;
  if (k < 0 || tile_w < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dense)
    walk_tiles_kernel<false><<<n_tiles, kThreads / kTilesP, 0, s>>>(mean, conic, color, op, valid,
                                                                    bg, out, k, tile_w);
  else
    walk_tiles_kernel<true><<<n_tiles, kThreads / kTilesP, 0, s>>>(mean, conic, color, op, valid,
                                                                   bg, out, k, tile_w);
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
  if (kc < 0 || tile_w < 1 || macro < 1 || macro_tile_w < 1 || macro > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedArgs a{mean, conic, color, op, valid, bg, out, n_tiles, kc, tile_w, macro,
                    macro_tile_w, 0, 0, 0};
  return launch_from_macro(a, static_cast<cudaStream_t>(stream));
}

// Coefficient walk: coeff [n_blocks, kc, 8], colours [n_blocks, kc, 4] (both
// 16-byte aligned), counts [n_blocks] int32; bs = 16, 32 or 64; dense: the
// twin that walks every row.
extern "C" int aip_composite_macro_blocks(const float* coeff, const float* colors,
                                          const int* counts, const float* bg, float* out,
                                          int n_blocks, int kc, int bs, int dense, void* stream) {
  if (n_blocks <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool d = dense != 0;
  switch (bs) {
    case 16:
      return d ? launch_blocks<16, false>(coeff, colors, counts, bg, out, n_blocks, kc, s)
               : launch_blocks<16, true>(coeff, colors, counts, bg, out, n_blocks, kc, s);
    case 32:
      return d ? launch_blocks<32, false>(coeff, colors, counts, bg, out, n_blocks, kc, s)
               : launch_blocks<32, true>(coeff, colors, counts, bg, out, n_blocks, kc, s);
    case 64:
      return d ? launch_blocks<64, false>(coeff, colors, counts, bg, out, n_blocks, kc, s)
               : launch_blocks<64, true>(coeff, colors, counts, bg, out, n_blocks, kc, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
