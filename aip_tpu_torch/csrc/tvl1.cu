// TV-L1 primal-dual inner loop for Hopper (sm_90a).
//
// Replaces aip_tpu/ops/pallas/tvl1.py:99 tvl1_inner_pallas (the pallas_call
// at :119), which aip_tpu/ops/flow.py _tvl1_level runs once per (pyramid
// level, warp). It runs `iters` Zach-Pock-Bischof iterations on every frame
// pair of a batch; per pixel and iteration:
//   rho  = rho_c + i1wx * u1 + i1wy * u2
//   d    = l_t * g if rho < -l_t * grad2, -l_t * g if rho > l_t * grad2,
//          else -rho * g / max(grad2, 1e-8)          (g = i1wx, i1wy)
//   u    = u + d + theta * div(p)                    (for u1 and u2)
//   p    = (p + taut * grad(u)) / (1 + taut * |grad(u)|)
// with div the backward divergence (p[0] at the first column and row,
// -p[n-2] at the last) and grad the forward difference (0 at the far edge).
//
// What bounds it on the H100. The function reads 10 fields and writes 6
// (64 B a pixel) once, and does about 55 float32 operations a pixel an
// iteration (a division and a square root counted as one each): over 300
// iterations its bound is the operations, 55 * 300 / 64 = 258 FLOP/B against
// the card's float32 ridge of 67e12 / 3.35e12 = 20 FLOP/B. One launch per
// iteration, which moves the 64 B through device memory every iteration, is
// bound by memory traffic at 300 times the function's bytes. So the state
// stays on chip for many iterations, as the TPU kernel keeps a pair's fields
// in VMEM for all of them.
//
// Design. One kernel template, tvl1_blocked_kernel<RW, RH, PPT, K>: a block
// of RW x RH/PPT threads (1024) holds an RW x RH region of one frame pair,
// each thread a column strip of PPT pixels whose six state fields stay in
// registers; the four constants (rho_c, i1wx, i1wy, grad2) of every pixel
// sit in shared memory, which leaves registers (64 a thread) for 32 warps an
// SM to hide the latency of the IEEE divisions and square roots. Per
// iteration only what a neighbour reads is exchanged through shared memory:
// p11 / p21 of every pixel (the divergence reads x - 1) and p12 / p22 of each
// strip's last row (it reads y - 1; inside a strip the thread has the row
// above), then, after the u update, u1 / u2 of every pixel (the gradient
// reads x + 1 and y + 1). Two barriers an iteration, no device-memory
// traffic between the first load and the last store. The edge rules are
// applied by the pixel's global coordinates, as selected operands rather
// than branches; a region's cut edge is not an image edge, and a warp whose
// strips lie outside the frame idles.
//   * Whole frame (K = 0): the region covers the frame (32^2 and 64^2 here),
//     so there is no halo and one launch runs all `iters` iterations, the
//     TPU kernel's own design.
//   * Temporal blocking (K > 0): the region is a tile of (RW - 2K) x
//     (RH - 2K) pixels with a K-pixel halo on every side. u_new(x) needs
//     p(x - 1, y - 1), p_new(x) needs u_new(x + 1, y + 1), so the valid part
//     shrinks by one pixel a side an iteration and after K iterations the
//     tile is exact. Each launch runs K iterations (the last one what
//     remains) and writes the tile; ceil(iters / K) launches ping-pong
//     between the output and a scratch set so that the last lands in the
//     output. Every launch reads 40 B a region pixel and writes 24 B a tile
//     pixel: (40 * 64^2 / 56^2 + 24) / 4 = 19 B a pixel-iteration at K = 4,
//     against 64 B and more for one launch an iteration. The price is the
//     halo's recompute, 64^2 / 56^2 = 1.31 at K = 4; kernels/tvl1.py picks
//     K from the frame's size (PERF.md has the sweep).
// The kernel is bound by the instructions it executes: 216 SASS instructions
// a pixel-iteration in the loop (a static count that includes the calls to
// the divisions' and square roots' slow paths), against the 55 operations
// its bound counts.
//
// Rounding. mask_lo / mask_hi are hard thresholds, so every product, sum,
// quotient and square root is written with the _rn intrinsics in the plain
// version's order (kernels/tvl1.py tvl1_inner_reference): nvcc cannot fuse
// them into multiply-adds, and the kernel takes the same branches as the
// plain PyTorch loop on the card and matches it to the bit. l_t * grad2,
// l_t * g and max(grad2, 1e-8) are recomputed each iteration from the
// constants rather than held (the registers go to the state; a form that
// held them spilled), the same rounded values (-l_t * x is -(l_t * x)).
//
// Plain C interface, bound with ctypes: the entry point returns the
// cudaError_t of its launches (0 on success) and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kFrameSide = 64;  // the largest whole-frame region
constexpr int kSmallSide = 32;  // a smaller one, for frames up to 32 x 32
constexpr int kTileSide = 64;   // the temporal-blocking region, halo included
constexpr int kPPT = 4;         // rows a thread holds in the 64-wide regions

struct Consts {
  const float* rho_c;
  const float* gx;
  const float* gy;
  const float* g2;
};

struct Fields {  // u1, u2, p11, p12, p21, p22
  const float* f[6];
};

struct OutFields {
  float* f[6];
};

// The backward divergence along one axis as one subtraction whose operands
// the edge rules select, the same bits as the plain version's branches:
// c - (+0) = c at the first pixel (the first rule wins on an axis of length
// 1), (-0) - prev = -prev at the last, c - prev inside.
__device__ __forceinline__ float bdiv(float c, float prev, bool first, bool last) {
  return __fsub_rn(last && !first ? -0.f : c, first ? 0.f : prev);
}

// The forward difference, +0 at the far edge (u - u = +0 for finite u).
__device__ __forceinline__ float fdiff(float next, float c, bool far) {
  return __fsub_rn(far ? c : next, c);
}

// d for one flow component: the thresholded step of the data term.
__device__ __forceinline__ float data_step(float rho, float g, bool lo, bool hi, float l_t,
                                           float safe) {
  const float lg = __fmul_rn(l_t, g);
  return lo ? lg : hi ? -lg : __fdiv_rn(__fmul_rn(-rho, g), safe);
}

// Shared memory: the four exchanged fields and the four constants of every
// pixel, and p12 / p22 of each strip's last row.
template <int RW, int RH>
constexpr int smem_bytes(int ppt) {
  return (8 * RH + 2 * (RH / ppt)) * RW * static_cast<int>(sizeof(float));
}

template <int RW, int RH, int PPT, int K>
__global__ void __launch_bounds__(RW * RH / PPT, 1)
tvl1_blocked_kernel(Consts cs, Fields s, OutFields o, int h, int w, int iters, float l_t,
                    float theta, float taut) {
  static_assert(RH % PPT == 0 && RW % 32 == 0, "a warp is one row of 32 strips");
  static_assert(2 * K < RW && 2 * K < RH, "the halo leaves a tile");
  constexpr int kStrips = RH / PPT;
  extern __shared__ float smem[];
  float(*sp11)[RW] = reinterpret_cast<float(*)[RW]>(smem);
  float(*sp21)[RW] = sp11 + RH;
  float(*su1)[RW] = sp21 + RH;
  float(*su2)[RW] = su1 + RH;
  float(*crc)[RW] = su2 + RH;  // the constants: each thread reads its own
  float(*cix)[RW] = crc + RH;
  float(*ciy)[RW] = cix + RH;
  float(*cg2)[RW] = ciy + RH;
  float(*sp12)[RW] = cg2 + RH;  // [kStrips]: the last row of each strip
  float(*sp22)[RW] = sp12 + kStrips;

  const int tile_w = K ? RW - 2 * K : w, tile_h = K ? RH - 2 * K : h;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gx = blockIdx.x * tile_w - K + tx;
  const int gy0 = blockIdx.y * tile_h - K + ty * PPT;
  const long long base = static_cast<long long>(blockIdx.z) * h * w;
  const bool col_in = gx >= 0 && gx < w;
  const bool first_x = gx == 0, last_x = gx == w - 1;
  // A strip wholly outside the frame computes nothing (its warp idles at the
  // barriers): nothing inside reads it, the edge rules see to that.
  const bool active = col_in && gy0 < h && gy0 + PPT > 0;
  // Neighbours in shared memory; at a region's cut edge the clamped index
  // reads the pixel itself, a value the shrinking valid part never uses.
  const int left = max(tx - 1, 0), right = min(tx + 1, RW - 1), above = max(ty - 1, 0);
  const int below = min((ty + 1) * PPT, RH - 1);

  // The state of the strip's pixels in registers, their constants in
  // shared memory (which leaves registers for twice the threads).
  float u1[PPT], u2[PPT], p11[PPT], p12[PPT], p21[PPT], p22[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int gy = gy0 + j, r = ty * PPT + j;
    const bool in = col_in && gy >= 0 && gy < h;
    const long long idx = base + static_cast<long long>(gy) * w + gx;
    crc[r][tx] = in ? cs.rho_c[idx] : 0.f;
    cix[r][tx] = in ? cs.gx[idx] : 0.f;
    ciy[r][tx] = in ? cs.gy[idx] : 0.f;
    cg2[r][tx] = in ? cs.g2[idx] : 0.f;
    u1[j] = in ? s.f[0][idx] : 0.f;
    u2[j] = in ? s.f[1][idx] : 0.f;
    p11[j] = in ? s.f[2][idx] : 0.f;
    p12[j] = in ? s.f[3][idx] : 0.f;
    p21[j] = in ? s.f[4][idx] : 0.f;
    p22[j] = in ? s.f[5][idx] : 0.f;
  }

  for (int it = 0; it < iters; ++it) {
    // 1. Publish what the divergence reads of the neighbours.
    if (active) {
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        sp11[ty * PPT + j][tx] = p11[j];
        sp21[ty * PPT + j][tx] = p21[j];
      }
      sp12[ty][tx] = p12[PPT - 1];
      sp22[ty][tx] = p22[PPT - 1];
    }
    __syncthreads();

    // 2. The data step and the new u; publish it.
    if (active) {
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int r = ty * PPT + j, gy = gy0 + j;
        const float a12 = j > 0 ? p12[j - 1] : sp12[above][tx];
        const float a22 = j > 0 ? p22[j - 1] : sp22[above][tx];
        const float ix = cix[r][tx], iy = ciy[r][tx], g2 = cg2[r][tx];
        const float rho =
            __fadd_rn(__fadd_rn(crc[r][tx], __fmul_rn(ix, u1[j])), __fmul_rn(iy, u2[j]));
        const float thr = __fmul_rn(l_t, g2), safe = fmaxf(g2, 1e-8f);
        const bool lo = rho < -thr, hi = rho > thr;
        const bool first_y = gy == 0, last_y = gy == h - 1;
        const float div1 = __fadd_rn(bdiv(p11[j], sp11[r][left], first_x, last_x),
                                     bdiv(p12[j], a12, first_y, last_y));
        const float div2 = __fadd_rn(bdiv(p21[j], sp21[r][left], first_x, last_x),
                                     bdiv(p22[j], a22, first_y, last_y));
        u1[j] = __fadd_rn(__fadd_rn(u1[j], data_step(rho, ix, lo, hi, l_t, safe)),
                          __fmul_rn(theta, div1));
        u2[j] = __fadd_rn(__fadd_rn(u2[j], data_step(rho, iy, lo, hi, l_t, safe)),
                          __fmul_rn(theta, div2));
        su1[r][tx] = u1[j];
        su2[r][tx] = u2[j];
      }
    }
    __syncthreads();

    // 3. The forward gradient of the new u and the dual update.
    if (active) {
      const bool far_x = gx + 1 >= w;
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int r = ty * PPT + j;
        const bool far_y = gy0 + j + 1 >= h;
        const float b1 = j + 1 < PPT ? u1[j + 1] : su1[below][tx];
        const float b2 = j + 1 < PPT ? u2[j + 1] : su2[below][tx];
        const float u1x = fdiff(su1[r][right], u1[j], far_x), u1y = fdiff(b1, u1[j], far_y);
        const float u2x = fdiff(su2[r][right], u2[j], far_x), u2y = fdiff(b2, u2[j], far_y);
        const float s1 = __fadd_rn(__fmul_rn(u1x, u1x), __fmul_rn(u1y, u1y));
        const float s2 = __fadd_rn(__fmul_rn(u2x, u2x), __fmul_rn(u2y, u2y));
        const float n1 = __fadd_rn(1.f, __fmul_rn(taut, __fsqrt_rn(s1)));
        const float n2 = __fadd_rn(1.f, __fmul_rn(taut, __fsqrt_rn(s2)));
        p11[j] = __fdiv_rn(__fadd_rn(p11[j], __fmul_rn(taut, u1x)), n1);
        p12[j] = __fdiv_rn(__fadd_rn(p12[j], __fmul_rn(taut, u1y)), n1);
        p21[j] = __fdiv_rn(__fadd_rn(p21[j], __fmul_rn(taut, u2x)), n2);
        p22[j] = __fdiv_rn(__fadd_rn(p22[j], __fmul_rn(taut, u2y)), n2);
      }
    }
  }

  // The tile's pixels: K + tile from the region's origin, inside the frame.
  if (!col_in || tx < K || tx >= K + tile_w) return;
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int gy = gy0 + j, r = ty * PPT + j;
    if (gy < 0 || gy >= h || r < K || r >= K + tile_h) continue;
    const long long idx = base + static_cast<long long>(gy) * w + gx;
    o.f[0][idx] = u1[j];
    o.f[1][idx] = u2[j];
    o.f[2][idx] = p11[j];
    o.f[3][idx] = p12[j];
    o.f[4][idx] = p21[j];
    o.f[5][idx] = p22[j];
  }
}

// One launch of tvl1_blocked_kernel<RW, RH, PPT, K> over (tiles, pairs).
template <int RW, int RH, int PPT, int K>
cudaError_t launch(const Consts& k, const Fields& s, const OutFields& o, int b, int h, int w,
                   int iters, float l_t, float theta, float taut, cudaStream_t st) {
  constexpr int bytes = smem_bytes<RW, RH>(PPT);
  auto kernel = tvl1_blocked_kernel<RW, RH, PPT, K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int tile_w = K ? RW - 2 * K : w, tile_h = K ? RH - 2 * K : h;
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, b);
  kernel<<<grid, dim3(RW, RH / PPT), bytes, st>>>(k, s, o, h, w, iters, l_t, theta, taut);
  return cudaGetLastError();
}

// ceil(iters / K) launches of the K-iteration tile kernel, ping-ponging so
// that the last lands in `out`.
template <int K>
cudaError_t run_tiles(const Consts& k, Fields src, const OutFields& out,
                      const OutFields& scratch, int b, int h, int w, int iters, float l_t,
                      float theta, float taut, cudaStream_t st) {
  const int n = (iters + K - 1) / K;
  for (int i = 0; i < n; ++i) {
    const OutFields& dst = (n - 1 - i) % 2 == 0 ? out : scratch;
    const int it = i + 1 < n ? K : iters - K * (n - 1);
    const cudaError_t err =
        launch<kTileSide, kTileSide, kPPT, K>(k, src, dst, b, h, w, it, l_t, theta, taut, st);
    if (err != cudaSuccess) return err;
    for (int c = 0; c < 6; ++c) src.f[c] = dst.f[c];
  }
  return cudaSuccess;
}

}  // namespace

// rho_c, i1wx, i1wy, grad2, u1, u2, p11, p12, p21, p22: [b, h, w] float32
// inputs (not written); out: six [b, h, w] fields (u1, u2, p11, p12, p21,
// p22); scratch: six more, used when the tile form takes more than one
// launch (may alias out otherwise). k = 0 runs the whole-frame form (h, w
// <= 64: one launch), k in {4, 8, 12, 16} the tile form with that many
// iterations a launch.
extern "C" int aip_tvl1_inner(const float* rho_c, const float* i1wx, const float* i1wy,
                              const float* grad2, const float* u1, const float* u2,
                              const float* p11, const float* p12, const float* p21,
                              const float* p22, float* o_u1, float* o_u2, float* o_p11,
                              float* o_p12, float* o_p21, float* o_p22, float* s_u1,
                              float* s_u2, float* s_p11, float* s_p12, float* s_p21,
                              float* s_p22, int b, int h, int w, int iters, int k, float l_t,
                              float theta, float taut, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || w < 1 || iters < 0 || b > 65535 || h > 65535 * 32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 ? (h > kFrameSide || w > kFrameSide) : (k != 4 && k != 8 && k != 12 && k != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Fields src = {{u1, u2, p11, p12, p21, p22}};
  const OutFields out = {{o_u1, o_u2, o_p11, o_p12, o_p21, o_p22}};
  const OutFields scratch = {{s_u1, s_u2, s_p11, s_p12, s_p21, s_p22}};
  if (iters == 0) {
    const size_t bytes = static_cast<size_t>(b) * h * w * sizeof(float);
    for (int c = 0; c < 6; ++c) {
      const cudaError_t err =
          cudaMemcpyAsync(out.f[c], src.f[c], bytes, cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
  const Consts c = {rho_c, i1wx, i1wy, grad2};
  cudaError_t err;
  switch (k) {
    case 0:
      err = h <= kSmallSide && w <= kSmallSide
                ? launch<kSmallSide, kSmallSide, 1, 0>(c, src, out, b, h, w, iters, l_t, theta,
                                                       taut, st)
                : launch<kFrameSide, kFrameSide, kPPT, 0>(c, src, out, b, h, w, iters, l_t,
                                                          theta, taut, st);
      break;
    case 4:
      err = run_tiles<4>(c, src, out, scratch, b, h, w, iters, l_t, theta, taut, st);
      break;
    case 8:
      err = run_tiles<8>(c, src, out, scratch, b, h, w, iters, l_t, theta, taut, st);
      break;
    case 12:
      err = run_tiles<12>(c, src, out, scratch, b, h, w, iters, l_t, theta, taut, st);
      break;
    default:
      err = run_tiles<16>(c, src, out, scratch, b, h, w, iters, l_t, theta, taut, st);
      break;
  }
  return static_cast<int>(err);
}
