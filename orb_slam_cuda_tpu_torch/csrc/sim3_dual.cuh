// Dual numbers for the Sim3 linearization kernels: a scalar with its
// tangent, carried through a chain with the rules torch.func.jvp applies
// to the plain chain's ops, the 3x3 products and Sim3 compose and inverse
// on it, and `seeded`, the tangent of exp(xi) o S at xi = 0 along one
// coordinate of xi. Included by csrc/pose_graph_edges.cu (the essential
// graph's edges) and csrc/sim3_opt_jacobian.cu (OptimizeSim3's
// reprojections).
//
// Everything is templated on the scalar, so that a host build (g++, no
// CUDA: `-x c++`) runs the same code in double, and `Counted` below, a
// double that counts the operations done on it, gives the operations a
// function needs for its bound.

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define S3D_FN __host__ __device__ __forceinline__
#else
#define S3D_FN inline
#endif
#include <math.h>
#include <stdint.h>

namespace s3d {

template <typename T>
struct Id {
  using type = T;
};
template <typename T>
using C = typename Id<T>::type;  // a constant operand: no tangent, not deduced

// A dual number: value and tangent.
template <typename T>
struct D {
  T v, d;
};

// Marks on tangents, for the host build's operation count (identities in
// double): `seed` a tangent that a lane's seed makes; `tangent` any other,
// which is 0 whatever the seed unless computed from a seed.
template <typename T>
S3D_FN T seed(T x) {
  return x;
}
template <typename T>
S3D_FN T tangent(T x) {
  return x;
}

template <typename T>
S3D_FN D<T> dual(T v, T d) {
  D<T> r;
  r.v = v;
  r.d = tangent(d);
  return r;
}
template <typename T>
S3D_FN D<T> constant(T v) {
  return dual(v, T(0.0));
}

template <typename T>
S3D_FN D<T> operator+(D<T> a, D<T> b) {
  return dual(a.v + b.v, a.d + b.d);
}
template <typename T>
S3D_FN D<T> operator-(D<T> a, D<T> b) {
  return dual(a.v - b.v, a.d - b.d);
}
template <typename T>
S3D_FN D<T> operator-(D<T> a) {
  return dual(-a.v, -a.d);
}
// torch's mul: other_t * self_p + self_t * other_p.
template <typename T>
S3D_FN D<T> operator*(D<T> a, D<T> b) {
  return dual(a.v * b.v, b.d * a.v + a.d * b.v);
}
// torch's div: (self_t - other_t * result) / other_p.
template <typename T>
S3D_FN D<T> operator/(D<T> a, D<T> b) {
  const T q = a.v / b.v;
  return dual(q, (a.d - b.d * q) / b.v);
}
template <typename T>
S3D_FN D<T> operator+(D<T> a, C<T> c) {
  return dual(a.v + c, a.d);
}
template <typename T>
S3D_FN D<T> operator+(C<T> c, D<T> a) {
  return dual(c + a.v, a.d);
}
template <typename T>
S3D_FN D<T> operator-(D<T> a, C<T> c) {
  return dual(a.v - c, a.d);
}
template <typename T>
S3D_FN D<T> operator-(C<T> c, D<T> a) {
  return dual(c - a.v, -a.d);
}
template <typename T>
S3D_FN D<T> operator*(D<T> a, C<T> c) {
  return dual(a.v * c, a.d * c);
}
template <typename T>
S3D_FN D<T> operator*(C<T> c, D<T> a) {
  return dual(c * a.v, c * a.d);
}
template <typename T>
S3D_FN D<T> operator/(D<T> a, C<T> c) {
  return dual(a.v / c, a.d / c);
}

// sqrt: grad / (2 result).
template <typename T>
S3D_FN D<T> dsqrt(D<T> a) {
  const T r = sqrt(a.v);
  return dual(r, a.d / (T(2.0) * r));
}
template <typename T>
S3D_FN D<T> dexp(D<T> a) {
  const T r = exp(a.v);
  return dual(r, a.d * r);
}
template <typename T>
S3D_FN D<T> dlog(D<T> a) {
  return dual(T(log(a.v)), a.d / a.v);
}
// atan2(y, x): (-y x_t + x y_t) / (y^2 + x^2).
template <typename T>
S3D_FN D<T> datan2(D<T> y, D<T> x) {
  return dual(T(atan2(y.v, x.v)), (-y.v * x.d + x.v * y.d) / (y.v * y.v + x.v * x.v));
}
// torch.clamp(a, lo, hi): NaN stays NaN; the tangent passes where lo <= a <= hi.
template <typename T>
S3D_FN D<T> dclamp(D<T> a, C<T> lo, C<T> hi) {
  const bool pass = a.v >= lo && a.v <= hi;
  return dual(a.v < lo ? lo : (a.v > hi ? hi : a.v), pass ? a.d : T(0.0));
}
template <typename T>
S3D_FN D<T> dclamp_min(D<T> a, C<T> lo) {
  return a.v < lo ? dual(lo, T(0.0)) : a;
}
template <typename T>
S3D_FN T sign(T x) {
  return x > T(0.0) ? T(1.0) : (x < T(0.0) ? T(-1.0) : T(0.0));
}

// Row-major 3x3 products. `mm` both operands dual; `cm` a constant left one.
template <typename T>
S3D_FN void mm(const D<T> a[9], const D<T> b[9], D<T> c[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}
template <typename T>
S3D_FN void mv(const D<T> a[9], const D<T> x[3], D<T> y[3]) {
  for (int i = 0; i < 3; ++i) y[i] = a[3 * i] * x[0] + a[3 * i + 1] * x[1] + a[3 * i + 2] * x[2];
}
template <typename T>
S3D_FN void cm(const T a[9], const D<T> b[9], D<T> c[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}
template <typename T>
S3D_FN void cv(const T a[9], const D<T> x[3], D<T> y[3]) {
  for (int i = 0; i < 3; ++i) y[i] = a[3 * i] * x[0] + a[3 * i + 1] * x[1] + a[3 * i + 2] * x[2];
}

// A Sim3 with tangents: x -> s R x + t.
template <typename T>
struct Sim3 {
  D<T> R[9], t[3], s;
};

// exp(xi) o S at xi = 0 (the primal S) with the tangent along coordinate k
// of xi (k < 3: rho, k < 6: phi, k == 6: sigma; any other: none). Every
// array index is a constant once the loops unroll and k only picks values,
// so a runtime k keeps S in registers.
template <typename T>
S3D_FN Sim3<T> seeded(const T R[9], const T t[3], T s, int k) {
  Sim3<T> S;
  for (int i = 0; i < 9; ++i) S.R[i] = constant(R[i]);
  for (int i = 0; i < 3; ++i) S.t[i] = constant(t[i]);
  S.s = constant(s);
  if (k >= 0 && k < 3) {
#pragma unroll
    for (int i = 0; i < 3; ++i) S.t[i].d = i == k ? seed(T(1.0)) : S.t[i].d;
  } else if (k >= 3 && k < 6) {
    // hat(e_a) v = e_a x v, for t and for each column of R: component b =
    // a + 1 gets -v_c, component c = a + 2 gets v_b (mod 3).
    const int b = (k - 2) % 3, c = (k - 1) % 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        const T next = R[3 * ((i + 1) % 3) + col], prev = R[3 * ((i + 2) % 3) + col];
        S.R[3 * i + col].d = i == b ? seed(-next) : (i == c ? seed(prev) : S.R[3 * i + col].d);
      }
      const T next = t[(i + 1) % 3], prev = t[(i + 2) % 3];
      S.t[i].d = i == b ? seed(-next) : (i == c ? seed(prev) : S.t[i].d);
    }
  } else if (k == 6) {
    for (int i = 0; i < 3; ++i) S.t[i].d = seed(t[i]);
    S.s.d = seed(s);
  }
  return S;
}

// sim3.compose(a, b): R = Ra Rb, t = sa (Ra tb) + ta, s = sa sb.
template <typename T>
S3D_FN Sim3<T> compose(const Sim3<T>& a, const Sim3<T>& b) {
  Sim3<T> c;
  D<T> Rt[3];
  mm(a.R, b.R, c.R);
  mv(a.R, b.t, Rt);
  for (int i = 0; i < 3; ++i) c.t[i] = a.s * Rt[i] + a.t[i];
  c.s = a.s * b.s;
  return c;
}

// sim3.inverse: R^T, 1 / s (reciprocal: -t r^2), -(1 / s) (R^T t).
template <typename T>
S3D_FN Sim3<T> inverse(const Sim3<T>& a) {
  Sim3<T> c;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) c.R[3 * i + j] = a.R[3 * j + i];
  const T si = T(1.0) / a.s.v;
  c.s = dual(si, -a.s.d * (si * si));
  D<T> Rt[3];
  mv(c.R, a.t, Rt);
  for (int i = 0; i < 3; ++i) c.t[i] = -c.s * Rt[i];
  return c;
}

}  // namespace s3d

#ifndef __CUDACC__

namespace s3d {

// A double that counts the operations done on it, as the function needs
// them: an operation whose operands are all primal values is the work
// item's (an edge's, a correspondence's: `primal_ops`; every lane repeats
// it, the function needs it once), one with an operand computed from a
// lane's seed is that lane's (`tangent_ops`), and one with a tangent that is
// 0 whatever the seed (from a constant, or a lane whose seed lies in another
// vertex) as an operand is counted nowhere: a product with it is 0 and a sum
// the other operand. Comparisons are not arithmetic and count nowhere
// either.
enum State : unsigned char { PRIMAL = 0, ZERO = 1, SEEDED = 2 };

struct Counted {
  double x;
  State st;
  static inline thread_local int64_t primal_ops = 0, tangent_ops = 0;
  Counted(double v = 0.0) : x(v), st(PRIMAL) {}
  Counted(double v, State s) : x(v), st(s) {}
  explicit operator float() const { return static_cast<float>(x); }
};

inline Counted op(double v, State s) {
  if (s == PRIMAL) ++Counted::primal_ops;
  if (s == SEEDED) ++Counted::tangent_ops;
  return Counted(v, s);
}
inline Counted op(double v, Counted a, Counted b) {  // a sum: a zero tangent leaves the other operand
  if (a.st == ZERO || b.st == ZERO) return Counted(v, a.st > b.st ? a.st : b.st);
  return op(v, a.st > b.st ? a.st : b.st);
}
inline Counted mul_op(double v, Counted a, Counted b) {  // a product or quotient: a zero tangent makes 0
  if (a.st == ZERO || b.st == ZERO) return Counted(v, ZERO);
  return op(v, a.st > b.st ? a.st : b.st);
}
inline Counted seed(Counted a) { return Counted(a.x, SEEDED); }
inline Counted tangent(Counted a) { return Counted(a.x, a.st == PRIMAL ? ZERO : a.st); }
inline Counted operator+(Counted a, Counted b) { return op(a.x + b.x, a, b); }
inline Counted operator-(Counted a, Counted b) { return op(a.x - b.x, a, b); }
inline Counted operator*(Counted a, Counted b) { return mul_op(a.x * b.x, a, b); }
inline Counted operator/(Counted a, Counted b) { return mul_op(a.x / b.x, a, b); }
inline Counted operator-(Counted a) { return Counted(-a.x, a.st); }  // a sign flip, folded into its use
inline bool operator<(Counted a, Counted b) { return a.x < b.x; }
inline bool operator>(Counted a, Counted b) { return a.x > b.x; }
inline bool operator<=(Counted a, Counted b) { return a.x <= b.x; }
inline bool operator>=(Counted a, Counted b) { return a.x >= b.x; }
inline bool operator==(Counted a, Counted b) { return a.x == b.x; }
inline Counted sqrt(Counted a) { return op(::sqrt(a.x), a.st); }
inline Counted exp(Counted a) { return op(::exp(a.x), a.st); }
inline Counted log(Counted a) { return op(::log(a.x), a.st); }
inline Counted sin(Counted a) { return op(::sin(a.x), a.st); }
inline Counted cos(Counted a) { return op(::cos(a.x), a.st); }
inline Counted atan2(Counted a, Counted b) { return op(::atan2(a.x, b.x), a, b); }
inline Counted fabs(Counted a) { return Counted(::fabs(a.x), a.st); }  // a sign bit cleared, folded into its use

}  // namespace s3d

#endif
