// The essential graph's edge linearization, for Hopper: every edge's Sim3
// residual and its two 7x7 forward-mode Jacobians in one launch.
//
// Answers to orb_slam_cuda_tpu/solvers/pose_graph.py:54 `_edge_residual`
// under `jax.vmap(jax.jacfwd(...))` (:88-89), which XLA fuses into a few
// kernels on the TPU. Not a Pallas kernel: the port's plain form,
// ops/pose_graph_kernel.py::linearize_plain (the residual chain in float64
// through `torch.func.jvp`, one pass a tangent coordinate), is ~10,000
// small launches a Gauss-Newton step on the card.
//
// For edge e (i = ei[e], j = ej[e]) and the left-multiplied tangents xi_i,
// xi_j (rho, phi, sigma) at 0:
//   r(xi_i, xi_j) = log(M_e o (exp(xi_i) o S_i) o (exp(xi_j) o S_j)^-1)
// In: R (K,3,3), t (K,3), s (K,) float32, the vertices' Sim3s; ei, ej
// (E,) int64; meas_R (E,3,3), meas_t (E,3), meas_s (E,) float32, M_e;
// valid (E,) bool. Out, float32: r (E,7); Ji, Jj (E,7,7), Ji[e][k][c] =
// dr_k / dxi_i[c]; flags (E,) int32, the branches the edge's chain took
// (FLAG_* below). An edge that is not valid gets zeros everywhere; a valid
// edge whose index lies outside [0, K) gets NaN and flags -1.
//
// The function is the plain chain's, branch for branch: the derivatives
// are those forward mode gives through `torch.where` (a constant branch
// has tangent 0), `clamp` (tangent 0 outside its closed range), `sqrt`
// (tangent / (2 result), infinite where the result is 0), `atan2`, `div`
// ((a_t - b_t q) / b), and the 3x3 solve (X_t = W^-1 (t_t - W_t X)), at
// every branch of geometry/sim3.py's `exp` (|sigma| < 1e-5, theta^2 <
// 1e-8) and `log`, and geometry/se3.py's `so3_log` (theta < 1e-4, the
// clamp of cos theta, theta > 3). A closed-form Jacobian would differ in
// the near-identity branches, where a converging solve spends its steps.
//
// Design: a block takes 8 edges (16 or 32 measured no faster:
// tests/torch_jacobian_split.py builds them as patches of this source) in
// three phases, two barriers:
//  1a. the primal warp, a lane an edge: loads the edge's indices once, then
//      its two vertices and measurement into shared memory (`Kept`), and runs
//      the primal chain through so3_log and log(B.s) once, keeping each
//      primal value that a tangent rule reads (each operand of a product
//      with a tangent, each divisor, the branches and clamp passes);
//  1b. the primal warp: w_matrix, W's LU factors and rho; r and the flags.
//      Beside it every direction lane runs the front half of its tangent
//      chain (to so3_log's and sigma's tangents), which reads 1a's values;
//  2.  each direction lane the back half (w_matrix's tangent, then
//      W^-1 (t_t - W_t rho)), and writes its Jacobian column.
// The direction lanes of each vertex are its rho directions (3 a edge),
// sigma's and phi's (3 a edge), each padded to whole warps, so a warp holds
// one class and the class is a compile-time argument of its chain: the
// blocks of tangents that its seed leaves 0 are `Zero` (below),
// their work dropped (a rho direction's chain is a few products and the LU
// solve). The seed is closed:
// the tangent of exp(xi) o S at xi = 0 along e_c is dt = e_c (rho), dR =
// hat(e_c) R and dt = hat(e_c) t (phi), dt = t and ds = s (sigma), the
// primal S itself (tests hold `torch.func.jvp` of sim3.exp at 0 to exactly
// these). Dropping a Zero is exact where every primal value is finite and no
// divisor is 0; phase 1 checks that for each edge, and an edge where it
// fails takes the generic dual chain (`edge_chain`: a lane the whole chain
// as a dual number, the primal and its tangent) in phase 2, so NaN and inf
// fall as the plain version's. Every value is the generic chain's: the same
// rules, in the same order, on the same values (the CPU tests hold the host
// builds of both forms bit for bit; on the card the outputs equal the
// generic chain's bit for bit on the ring). So the chain is written three
// times here, the generic dual chain, the primal (`edge_primal_log`,
// `edge_primal_w`) and the tangents (`chain_front`, `chain_back`), and a
// change to its maths is made in all three: the CPU tests hold the split
// form to the generic chain bit for bit on the branch edges and non-finite
// edges. Each half of the split pays only with the other, on an NVIDIA H100
// 80GB HBM3 at 700.00 W (tests/torch_jacobian_split.py, PERF.md §6): the
// shared primal with every tangent computed (Zero a runtime 0.0) read
// 0.0111 ms, each lane running its edge's primal itself and then its
// specialised tangents 0.0097, against 0.0089 for both and the generic
// lane chain's 0.0104-0.0109. r and J are rounded once from double to
// float32. No atomics, no host sync, one launch on the caller's
// stream: the call runs inside a captured CUDA graph, and two launches are
// bit-equal.
//
// Bound: each edge's two vertices, indices and measurement (~170 B) read
// and its r, Ji, Jj and flags (424 B) written: ~500 KB for the 256-keyframe
// ring padded to 1,024 edges, 0.15 us at 3.35 TB/s. The function's
// arithmetic, counted on the host build by `pose_graph_edges_ops` below on
// the generic chain (chip_smoke.py counts this run's edges), is an edge's
// primal chain once (290-315 double operations by branch) and each
// direction's tangent chain, without the operations on tangents that are 0
// whatever the seed (21 a rho direction, 43-350 the others): 1.70 million
// for the ring's 763 edges, 0.05 us at the H100's 34 TFLOP/s FP64 (NVIDIA's
// data sheet, SXM): bound by bytes. The kernel takes ~0.0088 ms on an NVIDIA
// H100 80GB HBM3 at 700.00 W (PERF.md §6): ~0.0021 ms the launch of an empty
// kernel of the same grid, the rest three dependent chains in a row, each
// one warp's: the loads and the primal chain to so3_log (~2 us: atan2,
// sqrt, division; a dependent double division takes ~110 cycles, atan2
// ~340), w_matrix and the LU solve beside the fronts (~2 us), the backs
// (~1.3 us). 158 registers a thread (the generic chain is compiled in), no
// spills; a block of 224 threads (7 warps) an SM at the ring's size, 128
// blocks: every SM but 4 has work.
//
// The arithmetic is templated on its scalar (the dual numbers, Sim3 compose
// and inverse and the seeds are csrc/sim3_dual.cuh's, shared with
// csrc/sim3_opt_jacobian.cu) so that a host build (g++, no CUDA: `-x c++`)
// runs the same code: `pose_graph_edges_host` runs the kernel's phases
// block by block in the kernel's order and `pose_graph_edges_host_generic`
// the generic chain's lanes, for the CPU tests, and `pose_graph_edges_ops` counts the
// double operations the function needs (each add, multiply, divide, sqrt,
// exp, log, sin, cos and atan2 one), on the generic chain.

#include "sim3_dual.cuh"

namespace pge {

using namespace s3d;

// A tangent that is 0 whatever the seed, as a type: the tangent chains
// specialised to a direction class carry it where the class's seed leaves
// a block of tangents 0, so the compiler drops the work on it. Exact where
// every primal value it meets is finite and no divisor it meets is 0: the
// plain chain's 0 * x and 0 / x are then +-0 and x + 0 is x (up to the sign
// of a zero, which no tangent rule divides by). Phase 1 checks that for
// each edge, and an edge where it does not hold runs the generic dual chain.
struct Zero {};
S3D_FN Zero operator+(Zero, Zero) { return {}; }
S3D_FN Zero operator-(Zero, Zero) { return {}; }
S3D_FN Zero operator-(Zero) { return {}; }
S3D_FN Zero operator*(Zero, Zero) { return {}; }
template <typename T>
S3D_FN T operator+(Zero, T x) {
  return x;
}
template <typename T>
S3D_FN T operator+(T x, Zero) {
  return x;
}
template <typename T>
S3D_FN T operator-(T x, Zero) {
  return x;
}
template <typename T>
S3D_FN T operator-(Zero, T x) {
  return -x;
}
template <typename T>
S3D_FN Zero operator*(Zero, T) {
  return {};
}
template <typename T>
S3D_FN Zero operator*(T, Zero) {
  return {};
}
template <typename T>
S3D_FN Zero operator/(Zero, T) {
  return {};
}
// The tangent type of a block: T where the class's seed reaches it, Zero
// where it does not; `As<U>::of(d)` reads a stored tangent as that type.
template <bool Reached, typename T>
struct TangentOf {
  using type = T;
};
template <typename T>
struct TangentOf<false, T> {
  using type = Zero;
};
template <typename U>
struct As {
  template <typename T>
  static S3D_FN T of(T d) {
    return d;
  }
};
template <>
struct As<Zero> {
  template <typename T>
  static S3D_FN Zero of(T) {
    return {};
  }
};
template <typename U>
struct IsZero {
  static constexpr bool value = false;
};
template <>
struct IsZero<Zero> {
  static constexpr bool value = true;
};
// `keep(pass, d)`: d where pass, else 0 (torch.where picking a constant,
// clamp outside its range).
S3D_FN Zero keep(bool, Zero) { return {}; }
template <typename T>
S3D_FN T keep(bool pass, T d) {
  return pass ? d : T(0.0);
}
// Every primal value an edge's specialised chain meets is finite: the
// premise above. False for an infinity and for NaN.
template <typename T>
S3D_FN bool is_finite(T x) {
  return fabs(x) <= T(1.7976931348623157e308);
}

constexpr int DIRECTIONS = 14;
constexpr double EPS = 1e-8;  // geometry/sim3.py's and se3.py's _EPS

// Branch flags of an edge's chain. They show which branch an edge took where
// r and J cannot: at a branch's threshold both sides agree to well within
// the r and J tolerances (so3_log's series at theta = 1e-4, W's |sigma| <
// 1e-5 side), so an edge on the wrong side would pass those gates.
constexpr int FLAG_LOG_SMALL = 1;     // so3_log: theta < 1e-4
constexpr int FLAG_LOG_NEAR_PI = 2;   // so3_log: theta > 3
constexpr int FLAG_COS_CLAMPED = 4;   // so3_log: (trace - 1) / 2 outside [-1, 1]
constexpr int FLAG_SIGMA_ZERO = 8;    // W: |sigma| < 1e-5
constexpr int FLAG_THETA_ZERO = 16;   // W: theta^2 < 1e-8

// M o a, M without tangent.
template <typename T>
S3D_FN Sim3<T> compose_const(const T MR[9], const T Mt[3], T Ms, const Sim3<T>& a) {
  Sim3<T> c;
  D<T> Rt[3];
  cm(MR, a.R, c.R);
  cv(MR, a.t, Rt);
  for (int i = 0; i < 3; ++i) c.t[i] = Ms * Rt[i] + Mt[i];
  c.s = Ms * a.s;
  return c;
}

// se3.so3_log, with its flags.
template <typename T>
S3D_FN void so3_log(const D<T> R[9], D<T> phi[3], int& flags) {
  const D<T> c0 = ((R[0] + R[4] + R[8]) - T(1.0)) * T(0.5);
  if (!(c0.v >= T(-1.0) && c0.v <= T(1.0))) flags |= FLAG_COS_CLAMPED;
  const D<T> cos_t = dclamp(c0, T(-1.0), T(1.0));
  const D<T> w[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const D<T> sin_t = T(0.5) * dsqrt((w[0] * w[0] + w[1] * w[1] + w[2] * w[2]) + T(1e-24));
  const D<T> theta = datan2(sin_t, cos_t);
  if (theta.v > T(3.0)) {
    // Near pi: the axis from the diagonal, its signs from the off-diagonal.
    flags |= FLAG_LOG_NEAR_PI;
    const D<T> den = dclamp_min(T(1.0) - cos_t, T(EPS));
    const T s01 = R[1].v + R[3].v;
    T sx = sign(w[0].v == T(0.0) ? s01 : w[0].v);
    if (sx == T(0.0)) sx = T(1.0);
    const T sg[3] = {sx, sign(s01 * sx + T(EPS)), sign((R[2].v + R[6].v) * sx + T(EPS))};
    for (int k = 0; k < 3; ++k) {
      const D<T> axis = dsqrt(dclamp((R[4 * k] - cos_t) / den, T(0.0), T(1.0)));
      phi[k] = (axis * sg[k]) * theta;
    }
    return;
  }
  D<T> scale;
  if (theta.v < T(1e-4)) {
    flags |= FLAG_LOG_SMALL;
    scale = T(0.5) + (theta * theta) / T(12.0);
  } else {
    scale = (T(0.5) * theta) / sin_t;
  }
  for (int k = 0; k < 3; ++k) phi[k] = scale * w[k];
}

// The 3x3 map rho -> t of sim3.exp at (phi, sigma), with its flags.
template <typename T>
S3D_FN void w_matrix(const D<T> phi[3], D<T> sigma, D<T> W[9], int& flags) {
  const D<T> theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const D<T> one = constant(T(1.0)), zero = constant(T(0.0));
  const bool nzs = fabs(sigma.v) < T(1e-5), nzt = theta2.v < T(EPS);
  if (nzs) flags |= FLAG_SIGMA_ZERO;
  if (nzt) flags |= FLAG_THETA_ZERO;
  const D<T> s = dexp(sigma);
  const D<T> sig = nzs ? one : sigma;
  const D<T> th = nzt ? one : dsqrt(theta2 + T(EPS));
  const D<T> c = nzs ? one : (s - T(1.0)) / sig;
  D<T> a = zero, b = zero;
  if (!nzt) {
    const T sth = sin(th.v), cth = cos(th.v);
    const D<T> sn = dual(sth, th.d * cth);
    const D<T> cs = dual(cth, th.d * -sth);
    if (nzs) {
      const D<T> th_sq = th * th;
      a = (T(1.0) - cs) / dclamp_min(th_sq, T(EPS));
      b = (th - sn) / dclamp_min(th_sq * th, T(EPS));
    } else {
      const D<T> a_ = s * sn, b_ = s * cs;
      const D<T> th2_sig2 = th * th + sig * sig;
      a = (a_ * sig + (T(1.0) - b_) * th) / dclamp_min(th * th2_sig2, T(EPS));
      b = (c - ((b_ - T(1.0)) * sig + a_ * th) / th2_sig2) / dclamp_min(th * th, T(EPS));
    }
  }
  // W = c I + a K + b K K, K = hat(phi).
  const D<T> K[9] = {zero, -phi[2], phi[1], phi[2], zero, -phi[0], -phi[1], phi[0], zero};
  D<T> KK[9];
  mm(K, K, KK);
  for (int i = 0; i < 9; ++i) {
    const D<T> ak_bkk = a * K[i] + b * KK[i];
    W[i] = i % 4 == 0 ? c + ak_bkk : ak_bkk;
  }
}

// x = A^-1 y by Gaussian elimination with partial pivoting (LAPACK's getrf
// order of pivots), for the value and then the tangent's right-hand side.
// Rows are swapped by selects, so no array is indexed by a runtime value
// and everything stays in registers.
template <typename T>
S3D_FN void swap_if(bool c, T& x, T& y) {
  const T a = x, b = y;
  x = c ? b : a;
  y = c ? a : b;
}
template <typename T>
S3D_FN void lu3(T a[9], int piv[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
    T best = fabs(a[4 * k]);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const T v = fabs(a[3 * i + k]);
      if (v > best) best = v, p = i;
    }
    piv[k] = p;
#pragma unroll
    for (int i = k + 1; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) swap_if(p == i, a[3 * k + j], a[3 * i + j]);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      a[3 * i + k] = a[3 * i + k] / a[4 * k];
#pragma unroll
      for (int j = k + 1; j < 3; ++j) a[3 * i + j] = a[3 * i + j] - a[3 * i + k] * a[3 * k + j];
    }
  }
}
template <typename T>
S3D_FN void lu3_solve(const T lu[9], const int piv[3], T x[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = k + 1; i < 3; ++i) swap_if(piv[k] == i, x[k], x[i]);
#pragma unroll
  for (int i = 1; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) x[i] = x[i] - lu[3 * i + j] * x[j];
#pragma unroll
  for (int i = 2; i >= 0; --i) {
#pragma unroll
    for (int j = i + 1; j < 3; ++j) x[i] = x[i] - lu[3 * i + j] * x[j];
    x[i] = x[i] / lu[4 * i];
  }
}

// sim3.log: (rho, phi, sigma), rho = W(phi, sigma)^-1 t; its tangent
// rho_t = W^-1 (t_t - W_t rho).
template <typename T>
S3D_FN void sim3_log(const Sim3<T>& S, T r[7], T dr[7], int& flags) {
  D<T> phi[3], W[9];
  so3_log(S.R, phi, flags);
  const D<T> sigma = dlog(S.s);
  w_matrix(phi, sigma, W, flags);
  T lu[9], rho[3], drho[3];
  int piv[3];
  for (int i = 0; i < 9; ++i) lu[i] = W[i].v;
  lu3(lu, piv);
  for (int i = 0; i < 3; ++i) rho[i] = S.t[i].v;
  lu3_solve(lu, piv, rho);
  for (int i = 0; i < 3; ++i) drho[i] = S.t[i].d - (W[3 * i].d * rho[0] + W[3 * i + 1].d * rho[1] + W[3 * i + 2].d * rho[2]);
  lu3_solve(lu, piv, drho);
  for (int k = 0; k < 3; ++k) {
    r[k] = rho[k];
    dr[k] = drho[k];
    r[3 + k] = phi[k].v;
    dr[3 + k] = phi[k].d;
  }
  r[6] = sigma.v;
  dr[6] = sigma.d;
}

// One lane's chain: r and its tangent along direction `dir` (0-6: xi_i's
// coordinates, 7-13: xi_j's; any other: none). Returns the flags.
template <typename T>
S3D_FN int edge_chain(const T Ri[9], const T ti[3], T si, const T Rj[9], const T tj[3], T sj, const T MR[9],
                      const T Mt[3], T Ms, int dir, T r[7], T dr[7]) {
  const Sim3<T> Si = seeded(Ri, ti, si, dir < 7 ? dir : -1);
  const Sim3<T> Sj = seeded(Rj, tj, sj, dir >= 7 ? dir - 7 : -1);
  int flags = 0;
  sim3_log(compose_const(MR, Mt, Ms, compose(Si, inverse(Sj))), r, dr, flags);
  return flags;
}

// ---- The split form, as the kernel runs it: an edge's primal chain once
// (phase 1), then each direction's tangent chain from the primal values it
// kept (phase 2), the rules and their order the generic chain's. ----

// A block's edges and threads. EDGES edges a block. Its direction lanes
// take, for each vertex (i, then j), the rho directions of its edges (3
// EDGES lanes, edge-major), their sigma directions (EDGES lanes), then the
// phi directions (3 EDGES lanes), each class padded to whole warps: a warp
// holds one class, so none runs two classes' chains one after the other. A
// last warp, the primal warp, takes an edge a lane in phase 1, so its chain
// runs beside the direction lanes' fronts and not in their warps.
constexpr int EDGES = 8;
constexpr int WARP = 32;
constexpr int warps_of(int lanes) { return (lanes + WARP - 1) / WARP * WARP; }
constexpr int RHO_LANES = warps_of(3 * EDGES), SIGMA_LANES = warps_of(EDGES), PHI_LANES = warps_of(3 * EDGES);
constexpr int VERTEX_LANES = RHO_LANES + SIGMA_LANES + PHI_LANES;
constexpr int DIRECTION_LANES = 2 * VERTEX_LANES;
constexpr int THREADS = DIRECTION_LANES + WARP;
static_assert(EDGES <= WARP, "one primal warp a block");

enum Status { ZEROS = 0, NANS = 1, SPECIALISED = 2, GENERIC = 3 };  // what phase 2 writes for an edge
enum Class { RHO, PHI, SIGMA };  // a direction class: the seed's blocks (t; R and t; t and s)

// Passes of the clamps (bit set: the tangent passes).
constexpr unsigned PASS_COS = 1, PASS_DEN = 2, PASS_AXIS = 4;  // so3_log; PASS_AXIS << k, k < 3
constexpr unsigned PASS_DEN_A = 32, PASS_DEN_B = 64;           // w_matrix, |sigma| < 1e-5
constexpr unsigned PASS_DEN_AA = 128, PASS_DEN_BB = 256;       // w_matrix, the other side

// One edge's primal values that its tangent rules read: each operand of a
// product with a tangent, each divisor, the branches and clamp passes.
// Named after the generic chain's values.
struct Kept {
  // phase 1a: the inputs, B = M o S_i o S_j^-1 up to so3_log and its log-scale
  double Ri[9], ti[3], si, Rj[9], tj[3], sj, MR[9], Mt[3], Ms;  // the inputs
  double inv_s, inv_s2, RjTt[3], inv_t[3];  // sim3.inverse(S_j): 1 / s_j, its square, R_j^T t_j, the inverse's t
  double Rt2[3], Bs, Bt[3], sigma;           // R_i t of S_j^-1; B's scale and t; sigma = log(B.s)
  double w[3], sqrt_r, sin_t, cos_t, atan_den, theta, scale, den, q[3], axis[3], sg[3], axsg[3], phi[3];  // so3_log
  // phase 1b: w_matrix, W's LU factors, rho = W^-1 t
  double s_exp, sig, th, sth, cth, c, a, b, th_sq, den_a, den_b, a_, b_, th2_sig2, omb, den_A, bm1, q2, den_B;
  double KK[9], lu[9], rho[3];
  int log_flags, log_passes, status_a;  // written in phase 1a
  int piv[3], flags, w_passes, status;  // written in phase 1b
};  // 1,008 bytes, 126 doubles; phase 2 reads one field of the block's edges at once

// Phase 1a: the primal chain of an edge whose inputs k holds up to so3_log
// and sigma, keeping what the tangent rules read; each value as the generic
// chain computes it. The phi lanes start their tangents' first half from
// these while phase 1b runs.
S3D_FN void edge_primal_log(Kept& k) {
  // sim3.inverse(S_j)
  k.inv_s = 1.0 / k.sj;
  k.inv_s2 = k.inv_s * k.inv_s;
  for (int i = 0; i < 3; ++i) k.RjTt[i] = k.Rj[i] * k.tj[0] + k.Rj[3 + i] * k.tj[1] + k.Rj[6 + i] * k.tj[2];
  for (int i = 0; i < 3; ++i) k.inv_t[i] = -k.inv_s * k.RjTt[i];
  // C = compose(S_i, S_j^-1), B = M o C
  double CR[9], Ct[3], BR[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      CR[3 * i + j] = k.Ri[3 * i] * k.Rj[3 * j] + k.Ri[3 * i + 1] * k.Rj[3 * j + 1] + k.Ri[3 * i + 2] * k.Rj[3 * j + 2];
  for (int i = 0; i < 3; ++i) {
    k.Rt2[i] = k.Ri[3 * i] * k.inv_t[0] + k.Ri[3 * i + 1] * k.inv_t[1] + k.Ri[3 * i + 2] * k.inv_t[2];
    Ct[i] = k.si * k.Rt2[i] + k.ti[i];
  }
  const double Cs = k.si * k.inv_s;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      BR[3 * i + j] = k.MR[3 * i] * CR[j] + k.MR[3 * i + 1] * CR[3 + j] + k.MR[3 * i + 2] * CR[6 + j];
  for (int i = 0; i < 3; ++i)
    k.Bt[i] = k.Ms * (k.MR[3 * i] * Ct[0] + k.MR[3 * i + 1] * Ct[1] + k.MR[3 * i + 2] * Ct[2]) + k.Mt[i];
  k.Bs = k.Ms * Cs;
  // so3_log(B.R)
  int flags = 0;
  unsigned passes = 0;
  const double c0 = ((BR[0] + BR[4] + BR[8]) - 1.0) * 0.5;
  if (c0 >= -1.0 && c0 <= 1.0) passes |= PASS_COS;
  else flags |= FLAG_COS_CLAMPED;
  k.cos_t = c0 < -1.0 ? -1.0 : (c0 > 1.0 ? 1.0 : c0);
  k.w[0] = BR[7] - BR[5];
  k.w[1] = BR[2] - BR[6];
  k.w[2] = BR[3] - BR[1];
  k.sqrt_r = sqrt((k.w[0] * k.w[0] + k.w[1] * k.w[1] + k.w[2] * k.w[2]) + 1e-24);
  k.sin_t = 0.5 * k.sqrt_r;
  k.theta = atan2(k.sin_t, k.cos_t);
  k.atan_den = k.sin_t * k.sin_t + k.cos_t * k.cos_t;
  if (k.theta > 3.0) {
    flags |= FLAG_LOG_NEAR_PI;
    const double om = 1.0 - k.cos_t;
    if (!(om < EPS)) passes |= PASS_DEN;
    k.den = om < EPS ? EPS : om;
    const double s01 = BR[1] + BR[3];
    double sx = sign(k.w[0] == 0.0 ? s01 : k.w[0]);
    if (sx == 0.0) sx = 1.0;
    k.sg[0] = sx;
    k.sg[1] = sign(s01 * sx + EPS);
    k.sg[2] = sign((BR[2] + BR[6]) * sx + EPS);
    for (int i = 0; i < 3; ++i) {
      k.q[i] = (BR[4 * i] - k.cos_t) / k.den;
      if (k.q[i] >= 0.0 && k.q[i] <= 1.0) passes |= PASS_AXIS << i;
      k.axis[i] = sqrt(k.q[i] < 0.0 ? 0.0 : (k.q[i] > 1.0 ? 1.0 : k.q[i]));
      k.axsg[i] = k.axis[i] * k.sg[i];
      k.phi[i] = k.axsg[i] * k.theta;
    }
  } else {
    if (k.theta < 1e-4) {
      flags |= FLAG_LOG_SMALL;
      k.scale = 0.5 + (k.theta * k.theta) / 12.0;
    } else {
      k.scale = (0.5 * k.theta) / k.sin_t;
    }
    for (int i = 0; i < 3; ++i) k.phi[i] = k.scale * k.w[i];
  }
  k.sigma = log(k.Bs);
  k.log_flags = flags;
  k.log_passes = static_cast<int>(passes);
  // The specialised chains' premise (csrc/sim3_dual.cuh's Zero): every
  // primal value finite and no divisor 0. Finite inputs, a finite 1 / s_j, a
  // finite log(B.s) and (phase 1b) a finite rho, so that no LU pivot is 0,
  // give the rest, every other divisor being bounded away from 0, but for an
  // axis of the near-pi branch that the clamp took to 0.
  double in = k.si + k.sj + k.Ms;
  for (int i = 0; i < 9; ++i) in += k.Ri[i] + k.Rj[i] + k.MR[i];
  for (int i = 0; i < 3; ++i) in += k.ti[i] + k.tj[i] + k.Mt[i];
  bool ok = is_finite(in) && is_finite(k.inv_s) && is_finite(k.sigma);
  if (flags & FLAG_LOG_NEAR_PI) ok = ok && k.axis[0] != 0.0 && k.axis[1] != 0.0 && k.axis[2] != 0.0;
  k.status_a = ok ? SPECIALISED : GENERIC;
}

// Phase 1b: w_matrix, W's LU factors and rho; the flags and the final
// status; returns r.
S3D_FN void edge_primal_w(Kept& k, double r[7]) {
  const double sigma = k.sigma;
  int flags = k.log_flags;
  unsigned passes = 0;
  // w_matrix(phi, sigma)
  const double theta2 = k.phi[0] * k.phi[0] + k.phi[1] * k.phi[1] + k.phi[2] * k.phi[2];
  const bool nzs = fabs(sigma) < 1e-5, nzt = theta2 < EPS;
  if (nzs) flags |= FLAG_SIGMA_ZERO;
  if (nzt) flags |= FLAG_THETA_ZERO;
  k.s_exp = exp(sigma);
  k.sig = nzs ? 1.0 : sigma;
  k.th = nzt ? 1.0 : sqrt(theta2 + EPS);
  k.c = nzs ? 1.0 : (k.s_exp - 1.0) / k.sig;
  k.a = k.b = 0.0;
  if (!nzt) {
    k.sth = sin(k.th);
    k.cth = cos(k.th);
    if (nzs) {
      k.th_sq = k.th * k.th;
      if (!(k.th_sq < EPS)) passes |= PASS_DEN_A;
      k.den_a = k.th_sq < EPS ? EPS : k.th_sq;
      k.a = (1.0 - k.cth) / k.den_a;
      const double th3 = k.th_sq * k.th;
      if (!(th3 < EPS)) passes |= PASS_DEN_B;
      k.den_b = th3 < EPS ? EPS : th3;
      k.b = (k.th - k.sth) / k.den_b;
    } else {
      k.a_ = k.s_exp * k.sth;
      k.b_ = k.s_exp * k.cth;
      k.th2_sig2 = k.th * k.th + k.sig * k.sig;
      k.omb = 1.0 - k.b_;
      const double dA = k.th * k.th2_sig2;
      if (!(dA < EPS)) passes |= PASS_DEN_AA;
      k.den_A = dA < EPS ? EPS : dA;
      k.a = (k.a_ * k.sig + k.omb * k.th) / k.den_A;
      k.bm1 = k.b_ - 1.0;
      k.q2 = (k.bm1 * k.sig + k.a_ * k.th) / k.th2_sig2;
      const double dB = k.th * k.th;
      if (!(dB < EPS)) passes |= PASS_DEN_BB;
      k.den_B = dB < EPS ? EPS : dB;
      k.b = (k.c - k.q2) / k.den_B;
    }
  }
  const double K[9] = {0.0, -k.phi[2], k.phi[1], k.phi[2], 0.0, -k.phi[0], -k.phi[1], k.phi[0], 0.0};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) k.KK[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
  double lu[9], rho[3];  // in registers, then kept
  int piv[3];
  for (int i = 0; i < 9; ++i) {
    const double ak_bkk = k.a * K[i] + k.b * k.KK[i];
    lu[i] = i % 4 == 0 ? k.c + ak_bkk : ak_bkk;
  }
  lu3(lu, piv);
  for (int i = 0; i < 3; ++i) rho[i] = k.Bt[i];
  lu3_solve(lu, piv, rho);
  for (int i = 0; i < 9; ++i) k.lu[i] = lu[i];
  for (int i = 0; i < 3; ++i) {
    k.piv[i] = piv[i];
    k.rho[i] = rho[i];
    r[i] = rho[i];
    r[3 + i] = k.phi[i];
  }
  r[6] = sigma;
  k.flags = flags;
  k.w_passes = static_cast<int>(passes);
  k.status = k.status_a == SPECIALISED && is_finite(rho[0]) && is_finite(rho[1]) && is_finite(rho[2]) ? SPECIALISED
                                                                                                       : GENERIC;
}

// A tangent's value in double (Zero is 0).
S3D_FN double value(double x) { return x; }
S3D_FN double value(Zero) { return 0.0; }

// Phase 2: the tangent of r from the seed's tangents of S_i (Ri_d, ti_d,
// si_d) and S_j, each block of them double or Zero, and the kept values:
// the generic chain's tangent rules in its order, those on a Zero left out.
// In two halves: the front (to so3_log's and sigma's tangents) reads phase
// 1a's values alone, the back (w_matrix's and rho's) phase 1b's.
template <class TP, class TS>
struct Front {
  double Bt_d[3];
  TP phi_d[3];
  TS sigma_d;
};

template <class TRi, class Tti, class Tsi, class TRj, class Ttj, class Tsj>
S3D_FN auto chain_front(const Kept& k, const TRi Ri_d[9], const Tti ti_d[3], Tsi si_d, const TRj Rj_d[9],
                        const Ttj tj_d[3], Tsj sj_d) {
  // sim3.inverse(S_j): its R's tangent is Rj_d transposed.
  const auto inv_s_d = -sj_d * k.inv_s2;
  using TRt = decltype(tj_d[0] * 0.0 + Rj_d[0] * 0.0);
  TRt Rt_d[3];
  for (int i = 0; i < 3; ++i)
    Rt_d[i] = (tj_d[0] * k.Rj[i] + Rj_d[i] * k.tj[0]) + (tj_d[1] * k.Rj[3 + i] + Rj_d[3 + i] * k.tj[1]) +
              (tj_d[2] * k.Rj[6 + i] + Rj_d[6 + i] * k.tj[2]);
  using Tinvt = decltype(TRt() * 0.0 + inv_s_d * 0.0);
  Tinvt inv_t_d[3];
  for (int i = 0; i < 3; ++i) inv_t_d[i] = Rt_d[i] * -k.inv_s + -inv_s_d * k.RjTt[i];
  // C = compose(S_i, S_j^-1)
  using TCR = decltype(Rj_d[0] * 0.0 + Ri_d[0] * 0.0);
  TCR CR_d[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      CR_d[3 * i + j] = (Rj_d[3 * j] * k.Ri[3 * i] + Ri_d[3 * i] * k.Rj[3 * j]) +
                        (Rj_d[3 * j + 1] * k.Ri[3 * i + 1] + Ri_d[3 * i + 1] * k.Rj[3 * j + 1]) +
                        (Rj_d[3 * j + 2] * k.Ri[3 * i + 2] + Ri_d[3 * i + 2] * k.Rj[3 * j + 2]);
  double Ct_d[3];
  for (int i = 0; i < 3; ++i) {
    const auto Rt2_d = (inv_t_d[0] * k.Ri[3 * i] + Ri_d[3 * i] * k.inv_t[0]) +
                       (inv_t_d[1] * k.Ri[3 * i + 1] + Ri_d[3 * i + 1] * k.inv_t[1]) +
                       (inv_t_d[2] * k.Ri[3 * i + 2] + Ri_d[3 * i + 2] * k.inv_t[2]);
    Ct_d[i] = value((Rt2_d * k.si + si_d * k.Rt2[i]) + ti_d[i]);
  }
  const auto Cs_d = inv_s_d * k.si + si_d * k.inv_s;
  // B = M o C
  TCR BR_d[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      BR_d[3 * i + j] = k.MR[3 * i] * CR_d[j] + k.MR[3 * i + 1] * CR_d[3 + j] + k.MR[3 * i + 2] * CR_d[6 + j];
  double Bt_d[3];
  for (int i = 0; i < 3; ++i)
    Bt_d[i] = k.Ms * (k.MR[3 * i] * Ct_d[0] + k.MR[3 * i + 1] * Ct_d[1] + k.MR[3 * i + 2] * Ct_d[2]);
  const auto Bs_d = k.Ms * Cs_d;
  // so3_log(B.R)
  const auto c0_d = ((BR_d[0] + BR_d[4]) + BR_d[8]) * 0.5;
  const auto cos_d = keep((k.log_passes & PASS_COS) != 0, c0_d);
  const TCR w_d[3] = {BR_d[7] - BR_d[5], BR_d[2] - BR_d[6], BR_d[3] - BR_d[1]};
  const auto ss_d = (w_d[0] * k.w[0] + w_d[0] * k.w[0]) + (w_d[1] * k.w[1] + w_d[1] * k.w[1]) +
                    (w_d[2] * k.w[2] + w_d[2] * k.w[2]);
  const auto sin_d = 0.5 * (ss_d / (2.0 * k.sqrt_r));
  const auto theta_d = (-k.sin_t * cos_d + k.cos_t * sin_d) / k.atan_den;
  TCR phi_d[3];
  if (k.log_flags & FLAG_LOG_NEAR_PI) {
    const auto den_d = keep((k.log_passes & PASS_DEN) != 0, -cos_d);
    for (int i = 0; i < 3; ++i) {
      const auto q_d = ((BR_d[4 * i] - cos_d) - den_d * k.q[i]) / k.den;
      const auto axis_d = keep((k.log_passes & (PASS_AXIS << i)) != 0, q_d) / (2.0 * k.axis[i]);
      phi_d[i] = theta_d * k.axsg[i] + (axis_d * k.sg[i]) * k.theta;
    }
  } else {
    using TSc = decltype(theta_d * 0.0);
    TSc scale_d;
    if (k.log_flags & FLAG_LOG_SMALL) scale_d = (theta_d * k.theta + theta_d * k.theta) / 12.0;
    else scale_d = (0.5 * theta_d - sin_d * k.scale) / k.sin_t;
    for (int i = 0; i < 3; ++i) phi_d[i] = w_d[i] * k.scale + scale_d * k.w[i];
  }
  Front<TCR, decltype(Bs_d / k.Bs)> f;
  for (int i = 0; i < 3; ++i) {
    f.Bt_d[i] = Bt_d[i];
    f.phi_d[i] = phi_d[i];
  }
  f.sigma_d = Bs_d / k.Bs;
  return f;
}

template <class TP, class TS>
S3D_FN void chain_back(const Kept& k, const Front<TP, TS>& f, double dr[7]) {
  const TP* phi_d = f.phi_d;
  const TS sigma_d = f.sigma_d;
  const double* Bt_d = f.Bt_d;
  // w_matrix(phi, sigma)
  const bool nzs = (k.flags & FLAG_SIGMA_ZERO) != 0, nzt = (k.flags & FLAG_THETA_ZERO) != 0;
  using TW = decltype(phi_d[0] * 0.0 + sigma_d * 0.0);
  TW W_d[9];
  if constexpr (!IsZero<TW>::value) {
    const auto theta2_d = (phi_d[0] * k.phi[0] + phi_d[0] * k.phi[0]) + (phi_d[1] * k.phi[1] + phi_d[1] * k.phi[1]) +
                          (phi_d[2] * k.phi[2] + phi_d[2] * k.phi[2]);
    const auto s_d = sigma_d * k.s_exp;
    const auto sig_d = keep(!nzs, sigma_d);
    const auto th_d = keep(!nzt, theta2_d / (2.0 * k.th));
    const auto c_d = keep(!nzs, (s_d - sig_d * k.c) / k.sig);
    // K = hat(phi); its entries 0, 4 and 8 are the constant 0 (no tangent).
    const double K[9] = {0.0, -k.phi[2], k.phi[1], k.phi[2], 0.0, -k.phi[0], -k.phi[1], k.phi[0], 0.0};
    const TP K_d[9] = {TP(), -phi_d[2], phi_d[1], phi_d[2], TP(), -phi_d[0], -phi_d[1], phi_d[0], TP()};
    for (int i = 0; i < 9; ++i) W_d[i] = TW();
    if (!nzt) {
      const auto sn_d = th_d * k.cth;
      const auto cs_d = th_d * -k.sth;
      double a_d, b_d;
      if (nzs) {
        const auto th_sq_d = th_d * k.th + th_d * k.th;
        const auto den_a_d = keep((k.w_passes & PASS_DEN_A) != 0, th_sq_d);
        a_d = value((-cs_d - den_a_d * k.a) / k.den_a);
        const auto th3_d = th_d * k.th_sq + th_sq_d * k.th;
        const auto den_b_d = keep((k.w_passes & PASS_DEN_B) != 0, th3_d);
        b_d = value(((th_d - sn_d) - den_b_d * k.b) / k.den_b);
      } else {
        const auto a__d = sn_d * k.s_exp + s_d * k.sth;
        const auto b__d = cs_d * k.s_exp + s_d * k.cth;
        const auto th2_sig2_d = (th_d * k.th + th_d * k.th) + (sig_d * k.sig + sig_d * k.sig);
        const auto num_a_d = (sig_d * k.a_ + a__d * k.sig) + (th_d * k.omb + -b__d * k.th);
        const auto den_A_d = keep((k.w_passes & PASS_DEN_AA) != 0, th2_sig2_d * k.th + th_d * k.th2_sig2);
        a_d = value((num_a_d - den_A_d * k.a) / k.den_A);
        const auto num2_d = (sig_d * k.bm1 + b__d * k.sig) + (th_d * k.a_ + a__d * k.th);
        const auto q2_d = (num2_d - th2_sig2_d * k.q2) / k.th2_sig2;
        const auto den_B_d = keep((k.w_passes & PASS_DEN_BB) != 0, th_d * k.th + th_d * k.th);
        b_d = value(((c_d - q2_d) - den_B_d * k.b) / k.den_B);
      }
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          // KK = K K: the terms with a constant-0 entry of K are 0.
          TP kk_d = TP();
          for (int m = 0; m < 3; ++m)
            if ((3 * i + m) % 4 != 0 && (3 * m + j) % 4 != 0)
              kk_d = kk_d + (K_d[3 * m + j] * K[3 * i + m] + K_d[3 * i + m] * K[3 * m + j]);
          const int n = 3 * i + j;
          const auto b_kk_d = kk_d * k.b + b_d * k.KK[n];
          W_d[n] = n % 4 == 0 ? value(b_kk_d) : value((K_d[n] * k.a + a_d * K[n]) + b_kk_d);
        }
    }
    for (int i = 0; i < 3; ++i) W_d[4 * i] = value(c_d + W_d[4 * i]);
  }
  // sim3.log's rho tangent: W^-1 (t_t - W_t rho)
  double drho[3];
  for (int i = 0; i < 3; ++i)
    drho[i] = value(Bt_d[i] - (W_d[3 * i] * k.rho[0] + W_d[3 * i + 1] * k.rho[1] + W_d[3 * i + 2] * k.rho[2]));
  lu3_solve(k.lu, k.piv, drho);
  for (int i = 0; i < 3; ++i) {
    dr[i] = drho[i];
    dr[3 + i] = value(phi_d[i]);
  }
  dr[6] = value(sigma_d);
}

// The seed's tangents of a class's direction `comp` (rho, phi: 0-2) on a
// vertex (R, t, s): `seeded`'s, the blocks the class leaves 0 as Zero.
template <int CLS>
struct Seed {
  using TR = typename TangentOf<CLS == PHI, double>::type;
  using TS = typename TangentOf<CLS == SIGMA, double>::type;
  TR R[9];
  double t[3];
  TS s;
  S3D_FN Seed(const double R0[9], const double t0[3], double s0, int comp) {
    const Sim3<double> S = seeded(R0, t0, s0, CLS == RHO ? comp : (CLS == PHI ? 3 + comp : 6));
    for (int i = 0; i < 9; ++i) R[i] = As<TR>::of(S.R[i].d);
    for (int i = 0; i < 3; ++i) t[i] = S.t[i].d;
    s = As<TS>::of(S.s.d);
  }
};

// The front half of phase 2 for direction `comp` of class CLS on vertex V
// (0: i, 1: j): the tangent chain specialised to the class.
template <int V, int CLS>
S3D_FN auto edge_front(const Kept& k, int comp) {
  const Zero z9[9] = {}, z3[3] = {};
  if constexpr (V == 0) {
    const Seed<CLS> sd(k.Ri, k.ti, k.si, comp);
    return chain_front(k, sd.R, sd.t, sd.s, z9, z3, Zero());
  } else {
    const Seed<CLS> sd(k.Rj, k.tj, k.sj, comp);
    return chain_front(k, z9, z3, Zero(), sd.R, sd.t, sd.s);
  }
}
// A lane's front in doubles (the parts its class leaves Zero are 0), as the
// lane keeps it across the barrier, and back in its class's types.
using LaneFront = Front<double, double>;
template <class TP, class TS>
S3D_FN LaneFront widen(const Front<TP, TS>& f) {
  LaneFront w;
  for (int i = 0; i < 3; ++i) {
    w.Bt_d[i] = f.Bt_d[i];
    w.phi_d[i] = value(f.phi_d[i]);
  }
  w.sigma_d = value(f.sigma_d);
  return w;
}
template <class TP, class TS>
S3D_FN Front<TP, TS> narrow(const LaneFront& w) {
  Front<TP, TS> f;
  for (int i = 0; i < 3; ++i) {
    f.Bt_d[i] = w.Bt_d[i];
    f.phi_d[i] = As<TP>::of(w.phi_d[i]);
  }
  f.sigma_d = As<TS>::of(w.sigma_d);
  return f;
}

struct Lane {
  int edge, vertex, cls, comp;  // edge in the block; comp: the direction in its class
  bool active;
};

S3D_FN Lane lane_of(int t) {
  Lane l;
  l.vertex = t / VERTEX_LANES;
  int u = t % VERTEX_LANES;
  if (u < RHO_LANES) {
    l.cls = RHO, l.edge = u / 3, l.comp = u % 3;
    l.active = u < 3 * EDGES;
  } else if ((u -= RHO_LANES) < SIGMA_LANES) {
    l.cls = SIGMA, l.edge = u, l.comp = 0;
    l.active = u < EDGES;
  } else {
    u -= SIGMA_LANES;
    l.cls = PHI, l.edge = u / 3, l.comp = u % 3;
    l.active = u < 3 * EDGES;
  }
  l.active = l.active && t < DIRECTION_LANES;
  return l;
}

// The column of xi's coordinates (rho 0-2, phi 3-5, sigma 6) a lane takes.
S3D_FN int column(const Lane& l) { return l.cls == RHO ? l.comp : (l.cls == PHI ? 3 + l.comp : 6); }

// Phase 1a for edge e: loads (its indices, then its vertices and
// measurement) and the primal chain to so3_log. An edge not valid gets
// zeros, a valid one with an index outside [0, K) NaN and flags -1: phase
// 1a writes its r and flags, and phase 1b has nothing to do.
S3D_FN void edge_phase1a(const float* R, const float* t, const float* s, int64_t K, const int64_t* ei,
                         const int64_t* ej, const float* mR, const float* mt, const float* ms, const bool* valid,
                         int64_t e, Kept& k, float* r_out, int* flags_out) {
  const int64_t a = ei[e], b = ej[e];
  const bool ok = valid[e];
  if (!ok || a < 0 || a >= K || b < 0 || b >= K) {
    k.status_a = k.status = ok ? NANS : ZEROS;
    for (int i = 0; i < 7; ++i) r_out[7 * e + i] = ok ? NAN : 0.0f;
    flags_out[e] = ok ? -1 : 0;
    return;
  }
  for (int i = 0; i < 9; ++i) {
    k.Ri[i] = R[9 * a + i];
    k.Rj[i] = R[9 * b + i];
    k.MR[i] = mR[9 * e + i];
  }
  for (int i = 0; i < 3; ++i) {
    k.ti[i] = t[3 * a + i];
    k.tj[i] = t[3 * b + i];
    k.Mt[i] = mt[3 * e + i];
  }
  k.si = s[a];
  k.sj = s[b];
  k.Ms = ms[e];
  edge_primal_log(k);
}

// Phase 1b for edge e: the rest of the primal chain, r and the flags.
S3D_FN void edge_phase1b(Kept& k, int64_t e, float* r_out, int* flags_out) {
  if (k.status_a == ZEROS || k.status_a == NANS) return;
  double r[7];
  edge_primal_w(k, r);
  for (int i = 0; i < 7; ++i) r_out[7 * e + i] = static_cast<float>(r[i]);
  flags_out[e] = k.flags;
}

// Phase 2's front for lane l, beside phase 1b, where phase 1a's premise
// holds: its class's chain to so3_log's and sigma's tangents.
S3D_FN LaneFront lane_front(const Kept& k, const Lane& l) {
  if (l.vertex == 0) {
    if (l.cls == RHO) return widen(edge_front<0, RHO>(k, l.comp));
    if (l.cls == PHI) return widen(edge_front<0, PHI>(k, l.comp));
    return widen(edge_front<0, SIGMA>(k, l.comp));
  }
  if (l.cls == RHO) return widen(edge_front<1, RHO>(k, l.comp));
  if (l.cls == PHI) return widen(edge_front<1, PHI>(k, l.comp));
  return widen(edge_front<1, SIGMA>(k, l.comp));
}

// Phase 2's back for lane l of edge e: its Jacobian column, from the front
// it computed beside phase 1b. An edge whose specialised chains' premise
// fails takes the generic chain.
S3D_FN void edge_phase2(const Kept& k, const Lane& l, int64_t e, const LaneFront& front, float* Ji, float* Jj) {
  float* J = (l.vertex == 0 ? Ji : Jj) + e * 49 + column(l);
  if (k.status == ZEROS || k.status == NANS) {
    for (int i = 0; i < 7; ++i) J[7 * i] = k.status == NANS ? NAN : 0.0f;
    return;
  }
  double dr[7];
  if (k.status == GENERIC) {
    double r[7];
    edge_chain<double>(k.Ri, k.ti, k.si, k.Rj, k.tj, k.sj, k.MR, k.Mt, k.Ms, 7 * l.vertex + column(l), r, dr);
  } else if (l.cls == RHO) {
    chain_back(k, narrow<Zero, Zero>(front), dr);
  } else if (l.cls == PHI) {
    chain_back(k, narrow<double, Zero>(front), dr);
  } else {
    chain_back(k, narrow<Zero, double>(front), dr);
  }
  for (int i = 0; i < 7; ++i) J[7 * i] = static_cast<float>(dr[i]);
}

// The generic chain's lane (e, lane): loads, the chain, its stores. The
// operation count's unit.
template <typename T>
S3D_FN void edge_lane(const float* R, const float* t, const float* s, int64_t K, const int64_t* ei, const int64_t* ej,
                      const float* mR, const float* mt, const float* ms, const bool* valid, int64_t e, int lane,
                      float* r_out, float* Ji, float* Jj, int* flags_out) {
  float* J = (lane < 7 ? Ji : Jj) + e * 49 + lane % 7;
  const int64_t a = ei[e], b = ej[e];
  const bool ok = valid[e];
  if (!ok || a < 0 || a >= K || b < 0 || b >= K) {
    const float fill = ok ? NAN : 0.0f;
    for (int k = 0; k < 7; ++k) J[7 * k] = fill;
    if (lane == 0) {
      for (int k = 0; k < 7; ++k) r_out[7 * e + k] = fill;
      flags_out[e] = ok ? -1 : 0;
    }
    return;
  }
  T Ra[9], Rb[9], MRe[9], ta[3], tb[3], Mte[3];
  for (int i = 0; i < 9; ++i) {
    Ra[i] = T(R[9 * a + i]);
    Rb[i] = T(R[9 * b + i]);
    MRe[i] = T(mR[9 * e + i]);
  }
  for (int i = 0; i < 3; ++i) {
    ta[i] = T(t[3 * a + i]);
    tb[i] = T(t[3 * b + i]);
    Mte[i] = T(mt[3 * e + i]);
  }
  T r[7], dr[7];
  const int f = edge_chain<T>(Ra, ta, T(s[a]), Rb, tb, T(s[b]), MRe, Mte, T(ms[e]), lane, r, dr);
  for (int k = 0; k < 7; ++k) J[7 * k] = static_cast<float>(dr[k]);
  if (lane == 0) {
    for (int k = 0; k < 7; ++k) r_out[7 * e + k] = static_cast<float>(r[k]);
    flags_out[e] = f;
  }
}

}  // namespace pge

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(pge::THREADS)
    pose_graph_edges_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ s,
                            int64_t K, const int64_t* __restrict__ ei, const int64_t* __restrict__ ej,
                            const float* __restrict__ mR, const float* __restrict__ mt, const float* __restrict__ ms,
                            const bool* __restrict__ valid, int64_t E, float* __restrict__ r, float* __restrict__ Ji,
                            float* __restrict__ Jj, int* __restrict__ flags) {
  __shared__ pge::Kept kept[pge::EDGES];
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * pge::EDGES;
  const int p = static_cast<int>(threadIdx.x) - pge::DIRECTION_LANES;  // the primal warp's lane
  const bool primal = p >= 0 && p < pge::EDGES && e0 + p < E;
  if (primal) pge::edge_phase1a(R, t, s, K, ei, ej, mR, mt, ms, valid, e0 + p, kept[p], r, flags);
  __syncthreads();
  const pge::Lane l = pge::lane_of(threadIdx.x);
  const bool mine = l.active && e0 + l.edge < E;
  if (primal) pge::edge_phase1b(kept[p], e0 + p, r, flags);
  pge::LaneFront front;
  if (mine && kept[l.edge].status_a == pge::SPECIALISED) front = pge::lane_front(kept[l.edge], l);
  __syncthreads();
  if (mine) pge::edge_phase2(kept[l.edge], l, e0 + l.edge, front, Ji, Jj);
}

}  // namespace

extern "C" int pose_graph_edges(const void* R, const void* t, const void* s, int64_t K, const void* ei,
                                const void* ej, const void* mR, const void* mt, const void* ms, const void* valid,
                                int64_t E, void* r, void* Ji, void* Jj, void* flags, void* stream) {
  if (K < 1 || E < 1 || !R || !t || !s || !ei || !ej || !mR || !mt || !ms || !valid || !r || !Ji || !Jj || !flags)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (E + pge::EDGES - 1) / pge::EDGES;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  pose_graph_edges_kernel<<<static_cast<unsigned>(blocks), pge::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(t), static_cast<const float*>(s), K,
      static_cast<const int64_t*>(ei), static_cast<const int64_t*>(ej), static_cast<const float*>(mR),
      static_cast<const float*>(mt), static_cast<const float*>(ms), static_cast<const bool*>(valid), E,
      static_cast<float*>(r), static_cast<float*>(Ji), static_cast<float*>(Jj), static_cast<int*>(flags));
  return static_cast<int>(cudaGetLastError());
}

#else  // a host build (g++ -x c++): the same arithmetic for the CPU tests and the operation count

// The kernel's work on the host, block by block, in the kernel's order:
// phase 1a for each of its edges; phase 1b for each, and each thread's
// front; each thread's back.
extern "C" int pose_graph_edges_host(const float* R, const float* t, const float* s, int64_t K, const int64_t* ei,
                                     const int64_t* ej, const float* mR, const float* mt, const float* ms,
                                     const bool* valid, int64_t E, float* r, float* Ji, float* Jj, int* flags) {
  if (K < 1 || E < 1) return 1;
  pge::Kept kept[pge::EDGES];
  pge::LaneFront front[pge::THREADS];
  for (int64_t e0 = 0; e0 < E; e0 += pge::EDGES) {
    const int n = static_cast<int>(E - e0 < pge::EDGES ? E - e0 : pge::EDGES);
    for (int i = 0; i < n; ++i) pge::edge_phase1a(R, t, s, K, ei, ej, mR, mt, ms, valid, e0 + i, kept[i], r, flags);
    for (int i = 0; i < n; ++i) pge::edge_phase1b(kept[i], e0 + i, r, flags);
    for (int th = 0; th < pge::THREADS; ++th) {
      const pge::Lane l = pge::lane_of(th);
      if (l.active && l.edge < n && kept[l.edge].status_a == pge::SPECIALISED)
        front[th] = pge::lane_front(kept[l.edge], l);
    }
    for (int th = 0; th < pge::THREADS; ++th) {
      const pge::Lane l = pge::lane_of(th);
      if (l.active && l.edge < n) pge::edge_phase2(kept[l.edge], l, e0 + l.edge, front[th], Ji, Jj);
    }
  }
  return 0;
}

// Every (edge, direction) through the generic dual chain, one after another:
// chain, the reference that the split form is held to bit for bit.
extern "C" int pose_graph_edges_host_generic(const float* R, const float* t, const float* s, int64_t K,
                                             const int64_t* ei, const int64_t* ej, const float* mR, const float* mt,
                                             const float* ms, const bool* valid, int64_t E, float* r, float* Ji,
                                             float* Jj, int* flags) {
  if (K < 1 || E < 1) return 1;
  for (int64_t e = 0; e < E; ++e)
    for (int lane = 0; lane < pge::DIRECTIONS; ++lane)
      pge::edge_lane<double>(R, t, s, K, ei, ej, mR, mt, ms, valid, e, lane, r, Ji, Jj, flags);
  return 0;
}

// The double operations of a valid edge that the function needs, counted
// on its lanes' chains: primal (E,), the edge's operations on primal values
// (each lane's chain repeats them: counted on every lane, 2 returned if two
// lanes disagree), and tangent (E, 14), each lane's operations on its seed's
// tangents; 0 for an edge that is not valid.
extern "C" int pose_graph_edges_ops(const float* R, const float* t, const float* s, int64_t K, const int64_t* ei,
                                    const int64_t* ej, const float* mR, const float* mt, const float* ms,
                                    const bool* valid, int64_t E, int64_t* primal, int64_t* tangent) {
  if (K < 1 || E < 1) return 1;
  float r[7], J[98];
  int flags;
  for (int64_t e = 0; e < E; ++e) {
    const int64_t a = ei[e], b = ej[e];
    const bool ok = valid[e] && a >= 0 && a < K && b >= 0 && b < K;
    primal[e] = 0;
    for (int lane = 0; lane < pge::DIRECTIONS; ++lane) {
      s3d::Counted::primal_ops = s3d::Counted::tangent_ops = 0;
      // edge_lane on a one-edge view, so its stores land in this call's scratch
      pge::edge_lane<s3d::Counted>(R, t, s, K, &ei[e], &ej[e], mR + 9 * e, mt + 3 * e, ms + e, valid + e, 0, lane,
                                   r, J, J + 49, &flags);
      tangent[e * pge::DIRECTIONS + lane] = ok ? s3d::Counted::tangent_ops : 0;
      if (ok && lane > 0 && s3d::Counted::primal_ops != primal[e]) return 2;
      primal[e] = ok ? s3d::Counted::primal_ops : 0;
    }
  }
  return 0;
}

#endif
