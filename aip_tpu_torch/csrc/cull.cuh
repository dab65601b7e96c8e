// The conservative visibility test of a Gaussian over a box of pixels, shared
// by the compositors that walk only the rows (or slots) live in a tile:
// composite.cu (per macro-block sub-tile) and composite_ad.cu (per 16 x 16
// tile). Its plain twin is box_visible() in kernels/composite_ad.py: the same
// float64 expressions in the same order.
//
// A Gaussian at (mx, my) with conic (a, b, c) and log opacity ln_op has, at a
// pixel centre X = px - mx, Y = py - my from its mean,
//   power = ln_op - q / 2,  q = a X^2 + 2 b X Y + c Y^2,
// and alpha = exp(min(power, 0)) (capped at 0.99), dropped below 1/255. Over
// a box of pixel centres the least q is exact for a positive definite conic:
// 0 when the mean is inside, else the least of the four edges' minima, each
// at the vertex of q along the edge (X = x: Y = -b x / c), clamped to the
// edge. A float64 rounding of that vertex only raises q by about c dY^2, some
// 1e-30 of q, far below the margins.
//
// The margins. A kernel's float32 power (dx, dy and each product and sum
// rounded once, fused or not) lies within 6 u ((a X^2 + c Y^2) / 2 + |b X Y|)
// + 2 u |ln_op| of the exact value, u = 2^-24; rho = 1 + 2 |b| / lambda_min
// bounds (a X^2 + c Y^2 + 2 |b X Y|) / q, so the float32 power is at most
// ln_op - (q / 2) (1 - 6 u rho) + 2 u |ln_op|. The test takes 16 u rho of
// q / 2 (more than twice the rounding, relative, so it stays tight near the
// contour) and 1e-6 in log terms (expf's 2 ulp, 1.2e-7, and 2 u |ln_op| for
// ln_op >= ln(1/255), 6.6e-7; a larger |ln_op| near the contour needs q / 2
// above it, where the relative margin covers it). A conic that is not
// positive definite is never culled: its factor is NaN and so is the bound.

#pragma once

#include <cuda_runtime.h>

namespace aip_cull {

constexpr double kRoundingMargin = 16.0 / 16777216.0;  // 16 u, u = 2^-24: of rho q / 2
constexpr double kExpMargin = 1e-6;
constexpr double kLnAlphaMin = -0x1.62a40f9abe3cep+2;  // ln(float(1/255)), correctly rounded

__device__ __forceinline__ double dmul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dadd(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double dsub(double a, double b) { return __dsub_rn(a, b); }

__device__ __forceinline__ double quad(double a, double b, double c, double x, double y) {
  return dadd(dadd(dmul(dmul(a, x), x), dmul(2.0, dmul(dmul(b, x), y))), dmul(dmul(c, y), y));
}

// 1 - 16 u rho for a positive definite conic, NaN otherwise.
__device__ __forceinline__ double margin_factor(double a, double b, double c) {
  const double det = dsub(dmul(a, c), dmul(b, b));
  if (!(a > 0.0 && c > 0.0 && det > 0.0)) return __longlong_as_double(0x7ff8000000000000LL);
  const double half_d = dmul(0.5, dsub(a, c));
  const double l_max =
      dadd(dmul(0.5, dadd(a, c)), __dsqrt_rn(dadd(dmul(half_d, half_d), dmul(b, b))));
  const double rho = dadd(1.0, __ddiv_rn(dmul(2.0, fabs(b)), __ddiv_rn(det, l_max)));
  return dsub(1.0, dmul(kRoundingMargin, rho));
}

// The least q over the pixel centres [x0, x0 + w - 1] x [y0, y0 + h - 1];
// sx = -b / c and sy = -b / a, the vertices' slopes.
__device__ __forceinline__ double box_qmin(double mx, double my, double a, double b, double c,
                                           double sx, double sy, double x0, double y0, int w,
                                           int h) {
  const double xa = dsub(x0, mx), xb = dsub(dadd(x0, w - 1.0), mx);
  const double ya = dsub(y0, my), yb = dsub(dadd(y0, h - 1.0), my);
  if (xa <= 0.0 && xb >= 0.0 && ya <= 0.0 && yb >= 0.0) return 0.0;
  const double q_xa = quad(a, b, c, xa, fmin(fmax(dmul(sx, xa), ya), yb));
  const double q_xb = quad(a, b, c, xb, fmin(fmax(dmul(sx, xb), ya), yb));
  const double q_ya = quad(a, b, c, fmin(fmax(dmul(sy, ya), xa), xb), ya);
  const double q_yb = quad(a, b, c, fmin(fmax(dmul(sy, yb), xa), xb), yb);
  return fmin(fmin(q_xa, q_xb), fmin(q_ya, q_yb));
}

// True when alpha < 1/255 is proved at every pixel centre of the box: the
// bound on the float32 power falls below ln(float(1/255)).
__device__ __forceinline__ bool proved_invisible(double ln_op, double q_min, double factor) {
  const double bound = dadd(dsub(ln_op, dmul(dmul(0.5, q_min), factor)), kExpMargin);
  return bound < kLnAlphaMin;
}

}  // namespace aip_cull
