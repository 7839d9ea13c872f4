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
// Design: a thread a (edge, direction). 16 lanes an edge: lanes 0-6 take
// xi_i's coordinates, 7-13 xi_j's, 14-15 idle; two edges a warp. Each
// thread carries the whole chain in double as a dual number, the primal
// and its own tangent, as one `jvp` does. The seed is closed: the tangent
// of exp(xi) o S at xi = 0 along e_c is dt = e_c (rho), dR = hat(e_c) R and
// dt = hat(e_c) t (phi), dt = t and ds = s (sigma), the primal S itself
// (tests hold `torch.func.jvp` of sim3.exp at 0 to exactly these). Lane 0
// writes r and the flags, each lane its Jacobian column; r and J are
// rounded once from double to float32. No shared memory, no atomics, no
// host sync, one launch on the caller's stream: the call runs inside a
// captured CUDA graph, and two launches are bit-equal.
//
// Bound: each lane reads its edge's two vertices, indices and measurement
// (~170 B) and the edge writes r, Ji, Jj and its flags (424 B): ~500 KB for
// the 256-keyframe ring padded to 1,024 edges, 0.15 us at 3.35 TB/s. The
// function's arithmetic, counted on the host build by `pose_graph_edges_ops`
// below (chip_smoke.py counts this run's edges), is an edge's primal chain
// once (290-315 double operations by branch) and each direction's tangent
// chain, without the operations on tangents that are 0 whatever the seed
// (21 a rho direction, 43-350 the others): 1.70 million for the ring's 763
// edges, 0.05 us at the H100's 34 TFLOP/s FP64 (NVIDIA's data sheet, SXM):
// bound by bytes. Both lie far below what the kernel takes: each thread
// repeats the primal chain (804-935 operations a thread in all, comparisons
// included), one long dependent chain, so latency is what it waits on, not
// a rate. 164 registers a thread, no spills
// (`-Xptxas -v`), a block of 128 threads (8 edges) an SM at the ring's size.
//
// The arithmetic is templated on its scalar (the dual numbers, Sim3 compose
// and inverse and the seeds are csrc/sim3_dual.cuh's, shared with
// csrc/sim3_opt_jacobian.cu) so that a host build (g++, no CUDA: `-x c++`)
// runs the same code: `pose_graph_edges_host` loops over
// (edge, lane) as the kernel's threads do, for the CPU tests, and
// `pose_graph_edges_ops` counts the double operations the function needs
// (each add, multiply, divide, sqrt, exp, log, sin, cos and atan2 one).

#include "sim3_dual.cuh"

namespace pge {

using namespace s3d;

constexpr int LANES = 16;  // threads an edge: 14 directions and 2 idle
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
template <typename T>
S3D_FN void lu3(T a[9], int piv[3]) {
  for (int k = 0; k < 3; ++k) {
    int p = k;
    for (int i = k + 1; i < 3; ++i)
      if (fabs(a[3 * i + k]) > fabs(a[3 * p + k])) p = i;
    piv[k] = p;
    if (p != k)
      for (int j = 0; j < 3; ++j) {
        const T tmp = a[3 * k + j];
        a[3 * k + j] = a[3 * p + j];
        a[3 * p + j] = tmp;
      }
    for (int i = k + 1; i < 3; ++i) {
      a[3 * i + k] = a[3 * i + k] / a[4 * k];
      for (int j = k + 1; j < 3; ++j) a[3 * i + j] = a[3 * i + j] - a[3 * i + k] * a[3 * k + j];
    }
  }
}
template <typename T>
S3D_FN void lu3_solve(const T lu[9], const int piv[3], T x[3]) {
  for (int k = 0; k < 3; ++k)
    if (piv[k] != k) {
      const T tmp = x[k];
      x[k] = x[piv[k]];
      x[piv[k]] = tmp;
    }
  for (int i = 1; i < 3; ++i)
    for (int j = 0; j < i; ++j) x[i] = x[i] - lu[3 * i + j] * x[j];
  for (int i = 2; i >= 0; --i) {
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

// The work of thread (e, lane): loads, the chain, its stores.
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

constexpr int THREADS = 128;  // 8 edges a block

__global__ void __launch_bounds__(THREADS)
    pose_graph_edges_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ s,
                            int64_t K, const int64_t* __restrict__ ei, const int64_t* __restrict__ ej,
                            const float* __restrict__ mR, const float* __restrict__ mt, const float* __restrict__ ms,
                            const bool* __restrict__ valid, int64_t E, float* __restrict__ r, float* __restrict__ Ji,
                            float* __restrict__ Jj, int* __restrict__ flags) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t e = g / pge::LANES;
  const int lane = static_cast<int>(g % pge::LANES);
  if (e >= E || lane >= pge::DIRECTIONS) return;
  pge::edge_lane<double>(R, t, s, K, ei, ej, mR, mt, ms, valid, e, lane, r, Ji, Jj, flags);
}

}  // namespace

extern "C" int pose_graph_edges(const void* R, const void* t, const void* s, int64_t K, const void* ei,
                                const void* ej, const void* mR, const void* mt, const void* ms, const void* valid,
                                int64_t E, void* r, void* Ji, void* Jj, void* flags, void* stream) {
  if (K < 1 || E < 1 || !R || !t || !s || !ei || !ej || !mR || !mt || !ms || !valid || !r || !Ji || !Jj || !flags)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (E * pge::LANES + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  pose_graph_edges_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(t), static_cast<const float*>(s), K,
      static_cast<const int64_t*>(ei), static_cast<const int64_t*>(ej), static_cast<const float*>(mR),
      static_cast<const float*>(mt), static_cast<const float*>(ms), static_cast<const bool*>(valid), E,
      static_cast<float*>(r), static_cast<float*>(Ji), static_cast<float*>(Jj), static_cast<int*>(flags));
  return static_cast<int>(cudaGetLastError());
}

#else  // a host build (g++ -x c++): the same arithmetic for the CPU tests and the operation count

// The kernel's work on the host, thread by thread, in double.
extern "C" int pose_graph_edges_host(const float* R, const float* t, const float* s, int64_t K, const int64_t* ei,
                                     const int64_t* ej, const float* mR, const float* mt, const float* ms,
                                     const bool* valid, int64_t E, float* r, float* Ji, float* Jj, int* flags) {
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
