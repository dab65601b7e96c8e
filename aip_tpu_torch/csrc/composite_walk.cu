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
//     of quadratic coefficients.
//
// The per-tile walk (kernels 6 and 7), per pixel (px, py) and slot k:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  alpha = min(0.99, op exp(min(power, 0)))
//   alpha = 0 unless valid and alpha >= 1/255
//   colour += alpha T c while T > 1e-4;  T *= 1 - alpha;  out = colour + T bg
// with no early exit: T keeps falling past 1e-4 and weights the background,
// as on the TPU. Kernel 7 stops one past the row's last valid slot, which
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
// Kernels 5 and 7: one 256-thread block per tile (one pixel per thread) or
// per macro block (bs * bs / 256 pixels per thread, all in one column, so
// px and its products are computed once per row). A block stages its slots
// in shared memory, 256 slots (per-tile walk) or 32 rows (coefficient walk)
// at a time, padded to 16 bytes and read as broadcasts.
//
// Kernel 6, the fused walk (from_macro_kernel). Most of a macro block's
// (tile, slot) pairs need no work: a splat far from a tile has alpha below
// 1/255 at every pixel of it, and the walk's own branch makes it a no-op
// there. So:
// * One block a macro block (up to 1024 threads: 64 a tile, P = 4 pixels a
//   thread; a tile's threads hold column j % 16 and rows (j / 16) P .. + P -
//   1, so dx, a dx^2 and b dx are computed once a column). The block stages
//   each chunk of 512 slots of its list once for all its tiles (three
//   16-byte rows a slot, and per slot the float64 terms of the cull: ln op,
//   the margin's factor, the vertices' slopes); with one block a tile,
//   each tile read the whole list through L2. A macro block of more than
//   16 tiles (macro 5 and up) is split over several blocks, each staging
//   the list itself.
// * The cull, per (tile, slot), in float64: aip_cull's test (csrc/cull.cuh,
//   whose note gives the margins) over the tile's 16 x 16 pixel centres, as
//   kernel A's staging (csrc/composite_ad.cu) runs it: a slot goes when it
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
constexpr int kChunk = kThreads;  // slots staged per pass of the per-tile walks
constexpr int kGroup = 32;        // rows per exit test of the coefficient walk
constexpr int kFusedChunk = 512;  // slots staged per pass of the fused walk
constexpr int kFusedP = 4;        // the fused walk's pixels a thread
constexpr int kMaxBlockThreads = 1024;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__global__ void __launch_bounds__(kThreads)
walk_tiles_kernel(const float* __restrict__ mean, const float* __restrict__ conic,
                  const float* __restrict__ color, const float* __restrict__ op,
                  const float* __restrict__ valid, const float* __restrict__ bg,
                  float* __restrict__ out, int k, int tile_w) {
  // Slot i: [mx, my, a, b], [c, red, green, blue], [opacity, valid, -, -].
  __shared__ float4 s_slots[kChunk][3];
  __shared__ int s_end;
  const long long tile = blockIdx.x;
  const int t = threadIdx.x;
  const float px = static_cast<float>((tile % tile_w) * kTile + t % kTile);
  const float py = static_cast<float>((tile / tile_w) * kTile + t / kTile);
  const long long base = tile * k;

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
  walk_tiles_kernel<<<n_tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      mean, conic, color, op, valid, bg, out, k, tile_w);
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
