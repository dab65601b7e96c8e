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
// Design. The TPU kernel keeps a frame pair's ten fields in VMEM for all
// iterations; at 256^2 that is 10 x 256 KB, more than one SM's 227 KB of
// shared memory, so this first form does not carry it over. Each iteration
// is one launch over (tiles, pairs), double-buffered in device memory, so
// that every iteration reads only the previous one's fields (Jacobi: a
// neighbour's value is never updated in place). A block stages its 32 x 8
// tile of p with a one-pixel halo in shared memory, computes the new u on
// the tile plus its right column and bottom row (p_new(x) needs u(x + 1),
// which is recomputed here rather than read), then writes u and p_new for
// the tile. One C call issues the `iters` launches on the caller's stream,
// ping-ponging between the output and a scratch set so that the last lands
// in the output.
//
// Rounding. mask_lo / mask_hi are hard thresholds, so every product, sum,
// quotient and square root is written with the _rn intrinsics in the plain
// version's order (kernels/tvl1.py tvl1_inner_reference): nvcc cannot fuse
// them into multiply-adds, and the kernel takes the same branches as the
// plain PyTorch loop on the card.
//
// What bounds it on the H100. The function reads 10 fields and writes 6
// (64 B a pixel) once, and does about 55 float32 operations a pixel an
// iteration (a division and a square root counted as one each): over 300
// iterations its bound is the operations, 55 * 300 / 64 = 258 FLOP/B against
// the card's float32 ridge of 67e12 / 3.35e12 = 20 FLOP/B. This form moves
// the 64 B (plus the halo's 16-30 %) through device memory every iteration,
// so it is bound by memory traffic, 300 times the function's bytes; the
// small pyramid levels (95 pairs x 32^2 x 64 B = 6 MB) stay in the 50 MB L2.
// Keeping a level resident across iterations, temporal blocking with a
// k-pixel halo for k iterations a launch, or a persistent kernel are what
// would move it towards its operations bound.
//
// Plain C interface, bound with ctypes: the entry point returns the
// cudaError_t of its launches (0 on success) and allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kTX = 32;         // tile width, threads.x
constexpr int kTY = 8;          // tile height, threads.y
constexpr int kThreads = kTX * kTY;
constexpr int kPW = kTX + 2;    // staged p: columns x0-1 .. x0+kTX
constexpr int kPH = kTY + 2;    // rows y0-1 .. y0+kTY
constexpr int kUW = kTX + 1;    // new u: columns x0 .. x0+kTX
constexpr int kUH = kTY + 1;    // rows y0 .. y0+kTY

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

__device__ __forceinline__ float div_x(const float (*p)[kPW], int r, int c, int gx, int w) {
  if (gx == 0) return p[r][c];
  if (gx == w - 1) return -p[r][c - 1];
  return __fsub_rn(p[r][c], p[r][c - 1]);
}

__device__ __forceinline__ float div_y(const float (*p)[kPW], int r, int c, int gy, int h) {
  if (gy == 0) return p[r][c];
  if (gy == h - 1) return -p[r - 1][c];
  return __fsub_rn(p[r][c], p[r - 1][c]);
}

// The thresholding step for one flow component: the increment d.
__device__ __forceinline__ float data_step(float rho, float g, bool lo, bool hi, float l_t,
                                           float safe) {
  if (lo) return __fmul_rn(l_t, g);
  if (hi) return __fmul_rn(-l_t, g);
  return __fdiv_rn(__fmul_rn(-rho, g), safe);
}

__global__ void __launch_bounds__(kThreads)
tvl1_iter_kernel(Consts k, Fields s, OutFields o, int h, int w, float l_t, float theta,
                 float taut) {
  __shared__ float sp[4][kPH][kPW];
  __shared__ float su[2][kUH][kUW];
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY;
  const long long base = static_cast<long long>(blockIdx.z) * h * w;
  const int tid = threadIdx.y * kTX + threadIdx.x;

  // 1. The previous iteration's p on the tile and a one-pixel halo.
  for (int e = tid; e < kPH * kPW; e += kThreads) {
    const int ly = e / kPW, lx = e % kPW;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const long long idx = base + static_cast<long long>(gy) * w + gx;
#pragma unroll
    for (int c = 0; c < 4; ++c) sp[c][ly][lx] = in ? s.f[2 + c][idx] : 0.f;
  }
  __syncthreads();

  // 2. The new u on the tile plus its right column and bottom row.
  for (int e = tid; e < kUH * kUW; e += kThreads) {
    const int ly = e / kUW, lx = e % kUW;
    const int gy = y0 + ly, gx = x0 + lx;
    if (gy >= h || gx >= w) continue;
    const long long idx = base + static_cast<long long>(gy) * w + gx;
    const float ix = k.gx[idx], iy = k.gy[idx], g2 = k.g2[idx];
    const float a1 = s.f[0][idx], a2 = s.f[1][idx];
    const float rho = __fadd_rn(__fadd_rn(k.rho_c[idx], __fmul_rn(ix, a1)), __fmul_rn(iy, a2));
    const bool lo = rho < __fmul_rn(-l_t, g2);
    const bool hi = rho > __fmul_rn(l_t, g2);
    const float safe = fmaxf(g2, 1e-8f);
    const float v1 = __fadd_rn(a1, data_step(rho, ix, lo, hi, l_t, safe));
    const float v2 = __fadd_rn(a2, data_step(rho, iy, lo, hi, l_t, safe));
    const int r = ly + 1, c = lx + 1;  // this pixel in the staged p
    const float div1 = __fadd_rn(div_x(sp[0], r, c, gx, w), div_y(sp[1], r, c, gy, h));
    const float div2 = __fadd_rn(div_x(sp[2], r, c, gx, w), div_y(sp[3], r, c, gy, h));
    su[0][ly][lx] = __fadd_rn(v1, __fmul_rn(theta, div1));
    su[1][ly][lx] = __fadd_rn(v2, __fmul_rn(theta, div2));
  }
  __syncthreads();

  // 3. The forward gradient of the new u, the dual update, the stores.
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int gy = y0 + ty, gx = x0 + tx;
  if (gy >= h || gx >= w) return;
  const long long idx = base + static_cast<long long>(gy) * w + gx;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const float uc = su[c][ty][tx];
    const float ux = gx + 1 < w ? __fsub_rn(su[c][ty][tx + 1], uc) : 0.f;
    const float uy = gy + 1 < h ? __fsub_rn(su[c][ty + 1][tx], uc) : 0.f;
    const float n = __fadd_rn(
        1.f, __fmul_rn(taut, __fsqrt_rn(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)))));
    o.f[c][idx] = uc;
    o.f[2 + 2 * c][idx] = __fdiv_rn(__fadd_rn(sp[2 * c][ty + 1][tx + 1], __fmul_rn(taut, ux)), n);
    o.f[3 + 2 * c][idx] =
        __fdiv_rn(__fadd_rn(sp[2 * c + 1][ty + 1][tx + 1], __fmul_rn(taut, uy)), n);
  }
}

}  // namespace

// rho_c, i1wx, i1wy, grad2, u1, u2, p11, p12, p21, p22: [b, h, w] float32
// inputs (not written); out: six [b, h, w] fields (u1, u2, p11, p12, p21,
// p22); scratch: six more, used when iters > 1 (may alias out otherwise).
extern "C" int aip_tvl1_inner(const float* rho_c, const float* i1wx, const float* i1wy,
                              const float* grad2, const float* u1, const float* u2,
                              const float* p11, const float* p12, const float* p21,
                              const float* p22, float* o_u1, float* o_u2, float* o_p11,
                              float* o_p12, float* o_p21, float* o_p22, float* s_u1,
                              float* s_u2, float* s_p11, float* s_p12, float* s_p21,
                              float* s_p22, int b, int h, int w, int iters, float l_t,
                              float theta, float taut, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || h < 1 || w < 1 || iters < 0 || b > 65535 || (h + kTY - 1) / kTY > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Fields src = {{u1, u2, p11, p12, p21, p22}};
  const OutFields out = {{o_u1, o_u2, o_p11, o_p12, o_p21, o_p22}};
  const OutFields scratch = {{s_u1, s_u2, s_p11, s_p12, s_p21, s_p22}};
  const size_t bytes = static_cast<size_t>(b) * h * w * sizeof(float);
  if (iters == 0) {
    for (int c = 0; c < 6; ++c) {
      const cudaError_t err =
          cudaMemcpyAsync(out.f[c], src.f[c], bytes, cudaMemcpyDeviceToDevice, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
  const Consts k = {rho_c, i1wx, i1wy, grad2};
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY, b);
  for (int i = 0; i < iters; ++i) {
    const OutFields& dst = (iters - 1 - i) % 2 == 0 ? out : scratch;
    tvl1_iter_kernel<<<grid, block, 0, st>>>(k, src, dst, h, w, l_t, theta, taut);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int c = 0; c < 6; ++c) src.f[c] = dst.f[c];
  }
  return 0;
}
