// The conservative visibility test of a Gaussian over a box of pixels, shared
// by the compositors that walk only the rows (or slots) live in a tile:
// composite.cu (per macro-block sub-tile), composite_ad.cu and the per-tile
// and fused walks of composite_walk.cu (per 16 x 16 tile). Its plain twin is
// box_visible() in kernels/composite_ad.py: the same float64 expressions in
// the same order. The coefficient walk's test is at the end.
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

// False when alpha < 1/255 is proved at every pixel centre of the w x h
// box at (x0, y0) for a slot at (mx, my) with conic (a, b, c) and opacity
// op: op <= 0, or a positive definite conic proved invisible (a conic that
// is not is never culled). Kernel A's staging test, from a slot's values.
__device__ __forceinline__ bool slot_visible(double mx, double my, double a, double b, double c,
                                             double op, double x0, double y0, int w, int h) {
  if (op <= 0.0) return false;
  const double factor = margin_factor(a, b, c);
  if (isnan(factor)) return true;
  const double q_min = box_qmin(mx, my, a, b, c, __ddiv_rn(-b, c), __ddiv_rn(-b, a), x0, y0, w, h);
  return !proved_invisible(log(op), q_min, factor);
}

// The same proof for a row of the coefficient walk (composite_walk.cu,
// kernel 5), which sees only the float32 coefficients of
//   power = ((((c0 + cx x) + cy y) + cxx x^2) + cyy y^2) + cxy x y
// at block-local pixel centres (x, y) >= 0, and alpha = op exp(min(power,
// 0)). So the proof works on that exact quadratic Q of the float32 values
// (in float64, where the products of two float32 values are exact) and
// not on a mean and conic recovered from them. Its plain twin is
// blocks_sub_tile_live() in kernels/composite.py: the same float64
// expressions in the same order.
//
// A row is kept outright when a coefficient or op is not finite (op NaN
// gives alpha 0.99 through fminf), and when Q is not concave (cxx < 0,
// cyy < 0 and D = 4 cxx cyy - cxy^2 > 0 fail: both products are exact in
// float64, so D's sign is exact); it goes when op <= 0 (alpha <= 0 then,
// whatever the power). Otherwise Q_max, the maximum of Q over the box of
// pixel centres [xa, xb] x [ya, yb], is the stationary point's value
// when it lies in the box, else the largest of the four edges' maxima,
// each at the edge's vertex (x = xa: y = -(cy + cxy xa) / (2 cyy)) clamped
// to the edge. The float64 roundings of a vertex lower the value found
// there by a second-order amount (the gradient vanishes at a maximum),
// some 1e-30 of S below.
//
// The margin. The kernel's float32 power rounds each of the five sums and
// the five products (px^2, py^2, px py are exact: integers below 2^24), so
// a term passes through at most six roundings and the float32 power lies
// within gamma_6 S < 6.0000004 u S of Q, S = |c0| + |cx| x + |cy| y +
// |cxx| x^2 + |cyy| y^2 + |cxy| x y at the pixel; S is largest at the
// box's far corner (xb, yb) since x, y >= 0. The test takes E = 8 u S
// there: the 2 u S beyond gamma_6 covers the float64 evaluation of Q_max,
// of S and of the vertices (about 1e-15 S). Then alpha < 1/255 at every
// pixel of the box when
//   ln op + Q_max + E + 1e-6 < ln(float(1/255)),
// the 1e-6 (kExpMargin) covering expf's 2 ulp and the product with op in
// log terms, and min(power, 0) and the 0.99 clamp only lowering alpha.
// Rows are classified once (coeff_terms) and tested per box
// (coeff_proved_invisible).

constexpr double kCoeffMargin = 8.0 / 16777216.0;  // 8 u, u = 2^-24: of S
constexpr int kRowTest = 0, kRowKeep = 1, kRowSkip = 2;

// ((((c0 + cx x) + cy y) + cxx x x) + cyy y y) + cxy x y, left to right.
__device__ __forceinline__ double coeff_q(const double (&c)[6], double x, double y) {
  return dadd(dadd(dadd(dadd(dadd(c[0], dmul(c[1], x)), dmul(c[2], y)), dmul(dmul(c[3], x), x)),
                   dmul(dmul(c[4], y), y)),
              dmul(dmul(c[5], x), y));
}

// The row's class and, for a row to test, t = {ln op, the stationary point
// x_s, y_s, Q there, -0.5 / cxx, -0.5 / cyy}.
__device__ __forceinline__ int coeff_terms(const float (&cf)[6], float op, double (&t)[6]) {
  bool finite = isfinite(op);
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(cf[i]);
  if (!finite) return kRowKeep;
  if (op <= 0.f) return kRowSkip;
  double c[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) c[i] = cf[i];
  const double d = dsub(dmul(dmul(4.0, c[3]), c[4]), dmul(c[5], c[5]));
  if (!(c[3] < 0.0 && c[4] < 0.0 && d > 0.0)) return kRowKeep;
  t[0] = log(static_cast<double>(op));
  t[1] = __ddiv_rn(dsub(dmul(c[5], c[2]), dmul(dmul(2.0, c[4]), c[1])), d);
  t[2] = __ddiv_rn(dsub(dmul(c[5], c[1]), dmul(dmul(2.0, c[3]), c[2])), d);
  t[3] = coeff_q(c, t[1], t[2]);
  t[4] = __ddiv_rn(-0.5, c[3]);
  t[5] = __ddiv_rn(-0.5, c[4]);
  return kRowTest;
}

// True when alpha < 1/255 is proved at every pixel centre of [xa, xa + w -
// 1] x [ya, ya + h - 1] (xa, ya >= 0) for a row of class kRowTest.
__device__ __forceinline__ bool coeff_proved_invisible(const float (&cf)[6], const double (&t)[6],
                                                       double xa, double ya, int w, int h) {
  double c[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) c[i] = cf[i];
  const double xb = dadd(xa, w - 1.0), yb = dadd(ya, h - 1.0);
  double q_max = t[3];
  if (!(xa <= t[1] && t[1] <= xb && ya <= t[2] && t[2] <= yb)) {
    const double q_xa = coeff_q(c, xa, fmin(fmax(dmul(dadd(c[2], dmul(c[5], xa)), t[5]), ya), yb));
    const double q_xb = coeff_q(c, xb, fmin(fmax(dmul(dadd(c[2], dmul(c[5], xb)), t[5]), ya), yb));
    const double q_ya = coeff_q(c, fmin(fmax(dmul(dadd(c[1], dmul(c[5], ya)), t[4]), xa), xb), ya);
    const double q_yb = coeff_q(c, fmin(fmax(dmul(dadd(c[1], dmul(c[5], yb)), t[4]), xa), xb), yb);
    q_max = fmax(fmax(q_xa, q_xb), fmax(q_ya, q_yb));
  }
  const double s =
      dadd(dadd(dadd(dadd(dadd(fabs(c[0]), dmul(fabs(c[1]), xb)), dmul(fabs(c[2]), yb)),
                     dmul(dmul(fabs(c[3]), xb), xb)),
                dmul(dmul(fabs(c[4]), yb), yb)),
           dmul(dmul(fabs(c[5]), xb), yb));
  const double bound = dadd(dadd(dadd(t[0], q_max), dmul(kCoeffMargin, s)), kExpMargin);
  return bound < kLnAlphaMin;
}

}  // namespace aip_cull
