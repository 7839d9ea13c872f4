// OptimizeSim3's Jacobian, for Hopper: the forward-mode derivatives of both
// reprojection families of every correspondence in one launch.
//
// Answers to orb_slam_cuda_tpu/solvers/sim3_opt.py:95-101, `flat_res`
// (with `_pair_residuals`, :43) under `jax.jacfwd`, which XLA fuses into a
// few kernels on the TPU. Not a Pallas kernel: the port's plain form,
// ops/sim3_opt_kernel.py::jacobian_plain (the chain in float64 through
// seven `torch.func.jvp` passes, one a tangent coordinate), is ~7,900 small
// launches an LM iteration on the card, and the loop closer's refinement
// runs 15 iterations a call.
//
// For correspondence m of M and the left-multiplied tangent xi = (rho, phi,
// sigma) of the estimate S at xi = 0, direction c of xi:
//   J[m][k][c]     = d/dxi_c proj_k(exp(xi) o S x2c[m])        (into KF1)
//   J[M + m][k][c] = d/dxi_c proj_k((exp(xi) o S)^-1 x1c[m])   (into KF2)
// proj(y) = (fx y_x / z + cx, fy y_y / z + cy), z = y_z where y_z > 1e-6,
// else the constant 1e-6. In: R (3,3), t (3,), s () float32, the estimate;
// x1c, x2c (M,3) float32; fx, fy. Out: J (2M,2,7) float32, each entry
// rounded once from the double chain, as the plain version's `.float()`.
// Every pair is computed, valid or not, as the plain version computes it:
// the solver weights the pairs it does not use by 0, and a NaN or an inf
// here reaches its normal equations as it does from the plain version.
//
// The derivatives are those forward mode gives through the plain chain, op
// by op: `torch.where` choosing the constant 1e-6 gives tangent 0, `div`
// (a_t - b_t q) / b, sim3.inverse's `1.0 / s` torch's reciprocal (-s_t /
// s^2, then times 1), and the products of compose and transform. The seed
// is closed: the tangent of exp(xi) o S at 0 along e_c (csrc/sim3_dual.cuh
// `seeded`, which the essential graph's kernel starts from too).
//
// Design: threads 0-6 of a block seed the estimate along each of the
// seven directions and invert it, into shared memory (2.9 KB), while every
// thread loads its point; after a barrier a thread is one item, (pair m,
// family f, direction c), and runs the generic dual chain of its family
// (`family_generic`: the seeded pose as dual numbers, read from shared
// memory) to its two tangents. A warp holds one (f, c) over 32 consecutive
// pairs: 28,000 threads at 2,000 pairs, 221 blocks of 128, so every SM has
// work. Every value is the plain chain's, NaN and inf included. Measured
// against it on an NVIDIA H100 80GB HBM3 at 700.00 W
// (tests/torch_jacobian_split.py, PERF.md §6): each item's chain
// specialised to its direction's class (the blocks the seed leaves 0 as a
// Zero type, as csrc/pose_graph_edges.cu's, the primal values computed
// before the barrier) read 0.0043 ms against this form's 0.0038, and a
// thread a (pair, family) running the seven directions 0.0065. No atomics,
// no host sync, one launch on the caller's stream: the call runs inside the
// `sim3_refine` program's captured CUDA graph, and two launches are
// bit-equal. fx and fy are launch arguments: a loop closer's camera is
// fixed, so the values frozen in a capture stay right.
//
// Bound: S (52 B) read once, each pair's x1c and x2c (24 B) read once and
// its J (112 B) written once: 272 KB at 2,000 pairs, 0.081 us at 3.35
// TB/s. The function's arithmetic, counted on the host build by
// `sim3_opt_jacobian_ops` below (chip_smoke.py counts this run's), is the
// estimate's inverse once, each pair's primal chain once, and each (pair,
// direction)'s tangent chain without the operations on tangents that are 0
// whatever the seed (the inverse 20, a pair's primal chain 50, its seven
// tangent chains 159-187): 473,935 double operations at 2,000 pairs, 0.014
// us at the H100's 34 TFLOP/s FP64 (NVIDIA's data sheet, SXM): bound by
// bytes. The kernel takes ~0.0038 ms on an NVIDIA H100 80GB HBM3 at
// 700.00 W (PERF.md §6), of it ~0.0021 ms the launch of an empty kernel of
// the same grid; the rest is the pose's loads and seeding (~0.8 us, every
// thread waiting at the barrier) and the items' chains (~0.6 us). 76
// registers a thread, no spills, no stack (`-Xptxas -v`).
//
// The arithmetic is templated on its scalar so that a host build (g++, no
// CUDA: `-x c++`) runs the same code: `sim3_opt_jacobian_host` runs the
// kernel's items one after another, for the CPU tests, and
// `sim3_opt_jacobian_ops` counts the double operations the function needs
// (each add, multiply and divide one).

#include "sim3_dual.cuh"

namespace soj {

using namespace s3d;

constexpr int DIRECTIONS = 7;
constexpr int FAMILIES = 2;  // S x2c into keyframe 1, S^-1 x1c into keyframe 2
constexpr double Z_MIN = 1e-6;  // proj's depth clamp

// The estimate with its tangent along one direction, and its inverse.
template <typename T>
struct Pose {
  Sim3<T> S, Si;
};

template <typename T>
S3D_FN Pose<T> load_pose(const float* R, const float* t, const float* s, int c) {
  T Rd[9], td[3];
  for (int i = 0; i < 9; ++i) Rd[i] = T(R[i]);
  for (int i = 0; i < 3; ++i) td[i] = T(t[i]);
  Pose<T> p;
  p.S = seeded(Rd, td, T(s[0]), c);
  p.Si = inverse(p.S);
  return p;
}

// sim3.transform of a point without tangent: y = s (R x) + t.
template <typename T>
S3D_FN void transform(const Sim3<T>& S, const T x[3], D<T> y[3]) {
  for (int i = 0; i < 3; ++i) {
    const D<T> Rx = x[0] * S.R[3 * i] + x[1] * S.R[3 * i + 1] + x[2] * S.R[3 * i + 2];
    y[i] = S.s * Rx + S.t[i];
  }
}

// The tangents of proj(y) without its constant cx, cy.
template <typename T>
S3D_FN void proj_tangent(const D<T> y[3], T fx, T fy, T out[2]) {
  const D<T> z = y[2].v > T(Z_MIN) ? y[2] : constant(T(Z_MIN));
  out[0] = ((fx * y[0]) / z).d;
  out[1] = ((fy * y[1]) / z).d;
}

// The generic chain of one family: the seeded pose P (S or its inverse) as
// dual numbers, the point x; the two tangents of its projection.
template <typename T>
S3D_FN void family_generic(const Sim3<T>& P, const T x[3], T fx, T fy, T j[2]) {
  D<T> y[3];
  transform(P, x, y);
  proj_tangent(y, fx, fy, j);
}

template <typename T>
S3D_FN void load_point(const float* xc, int64_t m, T x[3]) {
  for (int i = 0; i < 3; ++i) x[i] = T(xc[3 * m + i]);
}

template <typename T>
S3D_FN void store(float* J, int64_t M, int f, int64_t m, int c, const T j[2]) {
  for (int k = 0; k < 2; ++k) J[(2 * (f * M + m) + k) * DIRECTIONS + c] = static_cast<float>(j[k]);
}

// A pair's work along direction c, both families in turn: the operation
// count's unit.
template <typename T>
S3D_FN void pair_lane(const Pose<T>& P, const float* x1c, const float* x2c, int64_t M, int64_t m, int c, T fx,
                      T fy, float* J) {
  T x1[3], x2[3], j[2];
  load_point(x1c, m, x1);
  load_point(x2c, m, x2);
  family_generic(P.S, x2, fx, fy, j);
  store(J, M, 0, m, c, j);
  family_generic(P.Si, x1, fx, fy, j);
  store(J, M, 1, m, c, j);
}

}  // namespace soj

#ifdef __CUDACC__

namespace {

constexpr int WARP = 32;
constexpr int COMBOS = soj::FAMILIES * soj::DIRECTIONS;  // a warp's (family, direction) over 32 pairs
constexpr int THREADS = 128;

// A thread an item (pair m, family f, direction c); a warp one (f, c) over
// 32 consecutive pairs.
__global__ void __launch_bounds__(THREADS)
    sim3_opt_jacobian_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ s,
                             const float* __restrict__ x1c, const float* __restrict__ x2c, int64_t M, double fx,
                             double fy, float* __restrict__ J) {
  __shared__ soj::Pose<double> poses[soj::DIRECTIONS];
  const int64_t w = static_cast<int64_t>(blockIdx.x) * (THREADS / WARP) + threadIdx.x / WARP;
  const int combo = static_cast<int>(w % COMBOS), f = combo / soj::DIRECTIONS, c = combo % soj::DIRECTIONS;
  const int64_t m = (w / COMBOS) * WARP + threadIdx.x % WARP;
  double x[3];
  if (m < M) soj::load_point(f == 0 ? x2c : x1c, m, x);  // while threads 0-6 seed the poses
  if (threadIdx.x < soj::DIRECTIONS) poses[threadIdx.x] = soj::load_pose<double>(R, t, s, threadIdx.x);
  __syncthreads();
  if (m >= M) return;
  double j[2];
  soj::family_generic(f == 0 ? poses[c].S : poses[c].Si, x, fx, fy, j);
  soj::store(J, M, f, m, c, j);
}

int grid(int64_t M) {
  const int64_t warps = (M + WARP - 1) / WARP * COMBOS;
  return static_cast<int>((warps + THREADS / WARP - 1) / (THREADS / WARP));
}

}  // namespace

extern "C" int sim3_opt_jacobian(const void* R, const void* t, const void* s, const void* x1c, const void* x2c,
                                 int64_t M, double fx, double fy, void* J, void* stream) {
  if (M < 1 || !R || !t || !s || !x1c || !x2c || !J) return static_cast<int>(cudaErrorInvalidValue);
  if (M > (int64_t(1) << 36)) return static_cast<int>(cudaErrorInvalidConfiguration);
  sim3_opt_jacobian_kernel<<<grid(M), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(R), static_cast<const float*>(t), static_cast<const float*>(s),
      static_cast<const float*>(x1c), static_cast<const float*>(x2c), M, fx, fy, static_cast<float*>(J));
  return static_cast<int>(cudaGetLastError());
}

#else  // a host build (g++ -x c++): the same arithmetic for the CPU tests and the operation count

// The kernel's work on the host, item by item, in double: the seven poses
// once, then every (pair, family, direction).
extern "C" int sim3_opt_jacobian_host(const float* R, const float* t, const float* s, const float* x1c,
                                      const float* x2c, int64_t M, double fx, double fy, float* J) {
  if (M < 0) return 1;
  soj::Pose<double> poses[soj::DIRECTIONS];
  for (int c = 0; c < soj::DIRECTIONS; ++c) poses[c] = soj::load_pose<double>(R, t, s, c);
  for (int f = 0; f < soj::FAMILIES; ++f)
    for (int c = 0; c < soj::DIRECTIONS; ++c)
      for (int64_t m = 0; m < M; ++m) {
        double x[3], j[2];
        soj::load_point(f == 0 ? x2c : x1c, m, x);
        soj::family_generic(f == 0 ? poses[c].S : poses[c].Si, x, fx, fy, j);
        soj::store(J, M, f, m, c, j);
      }
  return 0;
}

// The double operations the function needs, counted on the lanes' chains:
// pose (8,): [0] the estimate's operations on primal values (its inverse;
// every lane repeats them), [1 + c] direction c's operations on its seed's
// tangents there; primal (M,) each pair's operations on primal values
// (every lane of the pair repeats them) and tangent (M, 7) each (pair,
// direction)'s on its seed's tangents. 2 is returned if two lanes'
// primal counts disagree.
extern "C" int sim3_opt_jacobian_ops(const float* R, const float* t, const float* s, const float* x1c,
                                     const float* x2c, int64_t M, double fx, double fy, int64_t* pose,
                                     int64_t* primal, int64_t* tangent) {
  if (M < 0) return 1;
  using s3d::Counted;
  float J[4 * soj::DIRECTIONS];  // a one-pair view's J
  for (int c = 0; c < soj::DIRECTIONS; ++c) {
    Counted::primal_ops = Counted::tangent_ops = 0;
    const soj::Pose<Counted> P = soj::load_pose<Counted>(R, t, s, c);
    if (c > 0 && Counted::primal_ops != pose[0]) return 2;
    pose[0] = Counted::primal_ops;
    pose[1 + c] = Counted::tangent_ops;
    for (int64_t m = 0; m < M; ++m) {
      Counted::primal_ops = Counted::tangent_ops = 0;
      soj::pair_lane<Counted>(P, x1c + 3 * m, x2c + 3 * m, 1, 0, c, Counted(fx), Counted(fy), J);
      if (c > 0 && Counted::primal_ops != primal[m]) return 2;
      primal[m] = Counted::primal_ops;
      tangent[m * soj::DIRECTIONS + c] = Counted::tangent_ops;
    }
  }
  return 0;
}

#endif
