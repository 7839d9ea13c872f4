// The 4x4 symmetric Jacobi eigen-solve in double that the DLT kernel
// (triangulate_dlt.cu) and the Sim3 RANSAC kernel (sim3_ransac.cu) share:
// one rotation, and one round of the parallel order.
//
// A sweep is 3 rounds of 2 disjoint rotations, (0,1)+(2,3), (0,2)+(1,3),
// (0,3)+(1,2). Both rotations of a round are computed from the matrix
// before it and applied together, so one thread interleaves two
// independent chains; only the upper triangle of `a` is kept. c and s come
// from two double rsqrt and multiplies, with selects instead of branches:
// no division and no square root. Each kernel runs its own sweep loop and
// convergence test (the DLT's matrix is positive semi-definite, Horn's
// N-matrix is not).

#pragma once

#include <math.h>

namespace jacobi4 {

struct Rot {
  double c, s, t;  // t = s / c
};

// The rotation A <- J^T A J, J = [[c, s], [-s, c]] on rows and columns
// p, q, that zeroes a_pq: t the smaller root of t^2 + 2 theta t - 1 = 0,
// theta = (a_qq - a_pp) / (2 a_pq).
__device__ __forceinline__ Rot rotation(double app, double aqq, double apq) {
  const double d = aqq - app;
  Rot o;
  // With h = sqrt(d^2 + 4 a_pq^2): cos 2phi = |d| / h, so c^2 = u =
  // (1 + |d| / h) / 2 with no cancellation, 1 / c = rsqrt(u), c = u / c,
  // s = sin 2phi / (2c) = sgn(d) a_pq / (h c), t = s / c. d = a_pq = 0
  // gives the identity.
  const double h2 = fma(d, d, 4.0 * apq * apq);
  const bool live = h2 > 0.0;
  const double r = live ? rsqrt(h2) : 0.0;
  const double u = live ? fma(0.5 * fabs(d), r, 0.5) : 1.0;
  const double ic = rsqrt(u);
  o.c = u * ic;
  o.s = (d < 0.0 ? -apq : apq) * r * ic;
  o.t = o.s * ic;
  return o;
}

// a[i][j] of the symmetric matrix through its upper triangle.
template <int i, int j>
__device__ __forceinline__ double& up(double (&a)[4][4]) {
  return a[i < j ? i : j][i < j ? j : i];
}

// One round of the parallel order: the rotations of the disjoint pairs
// (p,q) and (r,s), both from the matrix before the round; V <- V J.
template <int p, int q, int r, int s>
__device__ __forceinline__ void round2(double (&a)[4][4], double (&v)[4][4]) {
  const double apq = a[p][q], ars = a[r][s];
  const Rot x = rotation(a[p][p], a[q][q], apq);
  const Rot y = rotation(a[r][r], a[s][s], ars);
  // The entries between the pairs: J_x^T M J_y, M = [[a_pr, a_ps], [a_qr, a_qs]].
  const double mpr = up<p, r>(a), mps = up<p, s>(a), mqr = up<q, r>(a), mqs = up<q, s>(a);
  const double lpr = x.c * mpr - x.s * mqr, lps = x.c * mps - x.s * mqs;
  const double lqr = x.s * mpr + x.c * mqr, lqs = x.s * mps + x.c * mqs;
  up<p, r>(a) = y.c * lpr - y.s * lps;
  up<p, s>(a) = y.s * lpr + y.c * lps;
  up<q, r>(a) = y.c * lqr - y.s * lqs;
  up<q, s>(a) = y.s * lqr + y.c * lqs;
  a[p][p] -= x.t * apq;
  a[q][q] += x.t * apq;
  a[p][q] = 0.0;
  a[r][r] -= y.t * ars;
  a[s][s] += y.t * ars;
  a[r][s] = 0.0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double vkp = v[k][p], vkq = v[k][q], vkr = v[k][r], vks = v[k][s];
    v[k][p] = x.c * vkp - x.s * vkq;
    v[k][q] = x.s * vkp + x.c * vkq;
    v[k][r] = y.c * vkr - y.s * vks;
    v[k][s] = y.s * vkr + y.c * vks;
  }
}

// One sweep: the three rounds.
__device__ __forceinline__ void sweep(double (&a)[4][4], double (&v)[4][4]) {
  round2<0, 1, 2, 3>(a, v);
  round2<0, 2, 1, 3>(a, v);
  round2<0, 3, 1, 2>(a, v);
}

// The largest off-diagonal magnitude of the upper triangle.
__device__ __forceinline__ double off_max(const double (&a)[4][4]) {
  return fmax(fmax(fmax(fabs(a[0][1]), fabs(a[0][2])), fmax(fabs(a[0][3]), fabs(a[1][2]))),
              fmax(fabs(a[1][3]), fabs(a[2][3])));
}

}  // namespace jacobi4
