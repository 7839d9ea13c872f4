// Two-view linear (DLT) triangulation for Hopper: two entries from one
// source, sharing one null-vector solve.
//
// `triangulate_dlt` answers to orb_slam_cuda_tpu/geometry/triangulate.py::
// triangulate_dlt: per point the 4x4 system A of the rows x*P[2]-P[0],
// y*P[2]-P[1] of both views, its null vector taken as the eigenvector of
// A^T A with the smallest eigenvalue (`jnp.linalg.eigh` on an (N,4,4)
// batch, :37, the form the JAX package chose for the TPU), dehomogenized
// with |w| clamped to 1e-12. The initializer calls it.
//
// `triangulate_gated` answers to everything the mapper does to a
// triangulation neighbour after the epipolar match
// (orb_slam_cuda_tpu/engine/local_mapping.py:102-139; the port's
// engine/local_mapping.py::triangulate_with_neighbor): gather the matched
// point and octave through the match index clamped at 0, the two
// projection matrices K [R|t], the DLT point, cheirality and parallax,
// both reprojection chi2 over sigma^2 of the clamped octave, the distance
// ratio against the octave ratio, finiteness, and the AND of them all. Its
// plain version is geometry/triangulate.py::triangulate_gated_plain, about
// 95 device kernels over point-sized tensors where this is one launch.
// The gates are float32 in the plain version's order, every product and
// sum rounded on its own (__fmul_rn, __fadd_rn: no contraction into FMA)
// so that only a value within an ulp or two of a threshold can part.
//
// Neither is a Pallas kernel: they replace a batched eigen-solver call,
// which on the card reads a status back to the host and so cannot run
// inside a captured CUDA graph, and the gate ops around it.
//
// Bound at the mapper's shapes (N = 2000 features of a keyframe, the
// neighbour's 2000): the DLT's least work a point is A and A^T A (102
// float32 operations), 318 a Jacobi sweep of 6 rotations and 7 to pick the
// column and divide by w. The solve needs 3 sweeps on most points and 4 on
// the rest, so ~1,060-1,380 operations a point (2.1-2.8 Mop, 0.03-0.04 us
// at 67 TFLOP/s) against 56 KB moved (0.017 us at 3.35 TB/s); the gated
// function adds 115 operations and ~17 bytes a point. Bound by operations,
// and far below a launch: the card's time is the latency of one thread's
// dependent chain.
//
// The first design (one thread a point, blocks of 128, 8 cyclic sweeps of
// 6 rotations) took 0.0209 ms at 2000 points: each thread a chain of 48
// rotations, each three double divisions and two double square roots
// (multi-instruction sequences on the FP64 pipe) behind an early-return
// branch, then 12 dependent updates. This design shortens the chain:
//   - parallel ordering: a sweep is 3 rounds of 2 disjoint rotations,
//     (0,1)+(2,3), (0,2)+(1,3), (0,3)+(1,2). Both rotations of a round are
//     computed from the matrix before it and applied together, so one
//     thread interleaves two independent chains; only the upper triangle
//     is kept;
//   - no division and no square root: c and s come from two double rsqrt
//     and multiplies (below), with selects instead of branches;
//   - convergence exit: after each sweep the thread stops once every
//     off-diagonal entry is at most double epsilon times the trace (A^T A
//     is positive semi-definite, so the trace bounds its eigenvalues);
//     8 sweeps stay the cap (DLT_EARLY_EXIT=0 runs all 8, the tests'
//     reference). The test is per thread, not warp-uniform, so a point's
//     result depends on its own inputs alone and never on which points
//     share its warp.
// Measured one step at a time, each step a build of its own, on an NVIDIA
// H100 80GB HBM3 at 700 W, 2000 points, device time warm: 0.0209 ms;
// parallel order 0.0186; rsqrt rotation 0.0099; convergence exit (3-4
// sweeps) 0.0065, and the gated entry 0.0072. Each step paid: taken out of
// the final design, the exit cost 0.0035 ms, the rsqrt rotation 0.0039,
// the parallel order (with the first design's rotation) 0.0046. Blocks of
// 16, 32, 64 or 128 threads timed the same: at 2000 points each SM
// sub-partition holds one warp either way, so the time is one warp's
// chain. Blocks of 32 stay.
// 128 registers a thread for the gated kernel, 82 for the DLT one, no
// spills.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi4.cuh"

#ifndef DLT_EARLY_EXIT
#define DLT_EARLY_EXIT 1
#endif

namespace {

constexpr int BLOCK = 32;
constexpr int MAX_SWEEPS = 8;
constexpr double DBL_EPS = 2.220446049250313e-16;

// The DLT point of image points p1, p2 under the 3x4 row-major projections
// P1, P2: the smallest eigenvalue's eigenvector of A^T A by Jacobi in
// double, rounded to float, the |w| clamp, the division in float (as the
// plain version divides).
__device__ __forceinline__ void dlt_point(const float (&P1)[12], const float (&P2)[12], float2 p1, float2 p2,
                                          float (&X)[3]) {
  double A[4][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    A[0][c] = (double)p1.x * P1[8 + c] - P1[c];
    A[1][c] = (double)p1.y * P1[8 + c] - P1[4 + c];
    A[2][c] = (double)p2.x * P2[8 + c] - P2[c];
    A[3][c] = (double)p2.y * P2[8 + c] - P2[4 + c];
  }
  double a[4][4], v[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += A[k][r] * A[k][c];
      a[r][c] = s;
      v[r][c] = r == c ? 1.0 : 0.0;
    }
  }
#pragma unroll 1
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    jacobi4::sweep(a, v);
#if DLT_EARLY_EXIT
    if (jacobi4::off_max(a) <= DBL_EPS * (a[0][0] + a[1][1] + a[2][2] + a[3][3])) break;
#endif
  }
  // The smallest eigenvalue's column (the lowest index among ties, as the
  // ascending order of eigh puts the first of equal values first).
  int m = 0;
  double best = a[0][0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (a[k][k] < best) {
      best = a[k][k];
      m = k;
    }
  }
  float x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = (float)(m == 0 ? v[k][0] : m == 1 ? v[k][1] : m == 2 ? v[k][2] : v[k][3]);
  }
  float w = x[3];
  if (fabsf(w) < 1e-12f) w = 1e-12f;
#pragma unroll
  for (int k = 0; k < 3; ++k) X[k] = x[k] / w;
}

__global__ void __launch_bounds__(BLOCK)
triangulate_dlt_kernel(const float* __restrict__ P1g, const float* __restrict__ P2g,
                       const float2* __restrict__ xy1, const float2* __restrict__ xy2,
                       float* __restrict__ out, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float P1[12], P2[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    P1[k] = __ldg(P1g + k);
    P2[k] = __ldg(P2g + k);
  }
  float X[3];
  dlt_point(P1, P2, xy1[i], xy2[i], X);
  out[3 * i + 0] = X[0];
  out[3 * i + 1] = X[1];
  out[3 * i + 2] = X[2];
}

// The gates' float32 arithmetic, each operation rounded on its own.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}
// torch.clamp(v, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

// Row r of T X + t for a 4x4 row-major world-to-camera pose T.
__device__ __forceinline__ float cam_row(const float (&T)[16], int r, const float (&X)[3]) {
  return add(dot3(X[0], X[1], X[2], T[4 * r], T[4 * r + 1], T[4 * r + 2]), T[4 * r + 3]);
}

// The squared reprojection error of X in a pinhole camera of pose T
// (geometry/camera.py::project, |z| < 1e-9 clamped to 1e-9).
__device__ __forceinline__ float reproj_err(const float (&T)[16], const float (&X)[3], float2 xy, float fx,
                                            float fy, float cx, float cy, float* z_out) {
  const float x = cam_row(T, 0, X), y = cam_row(T, 1, X), z = cam_row(T, 2, X);
  *z_out = z;
  const float inv_z = __frcp_rn(fabsf(z) < 1e-9f ? 1e-9f : z);
  const float du = sub(add(mul(fx, mul(x, inv_z)), cx), xy.x);
  const float dv = sub(add(mul(fy, mul(y, inv_z)), cy), xy.y);
  return add(mul(du, du), mul(dv, dv));
}

// The camera centre -R^T t of a world-to-camera pose T, and X - centre.
__device__ __forceinline__ void ray(const float (&T)[16], const float (&X)[3], float (&d)[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float centre = -dot3(T[c], T[4 + c], T[8 + c], T[3], T[7], T[11]);
    d[c] = sub(X[c], centre);
  }
}

__global__ void __launch_bounds__(BLOCK)
triangulate_gated_kernel(const float* __restrict__ T1g, const float* __restrict__ T2g,
                         const float2* __restrict__ xy1, const float2* __restrict__ uv2,
                         const int64_t* __restrict__ idx, const int* __restrict__ oct1,
                         const int* __restrict__ oct2, const float* __restrict__ sig2,
                         const float* __restrict__ sf, int levels, int n, int n2, float fx, float fy,
                         float cx, float cy, float* __restrict__ xyz, bool* __restrict__ ok) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  float T1[16], T2[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    T1[k] = __ldg(T1g + k);
    T2[k] = __ldg(T2g + k);
  }
  // P = K [R|t] with K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1]].
  float P1[12], P2[12];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    P1[c] = add(mul(fx, T1[c]), mul(cx, T1[8 + c]));
    P1[4 + c] = add(mul(fy, T1[4 + c]), mul(cy, T1[8 + c]));
    P1[8 + c] = T1[8 + c];
    P2[c] = add(mul(fx, T2[c]), mul(cx, T2[8 + c]));
    P2[4 + c] = add(mul(fy, T2[4 + c]), mul(cy, T2[8 + c]));
    P2[8 + c] = T2[8 + c];
  }
  // An unmatched feature (-1) is triangulated with feature 0 and gated out;
  // an index past the neighbour's features is clamped there, never read.
  const int64_t m = idx[i];
  const int j = (int)(m < 0 ? 0 : m >= n2 ? n2 - 1 : m);
  const float2 p1 = xy1[i], p2 = uv2[j];
  float X[3];
  dlt_point(P1, P2, p1, p2, X);

  float z1, z2;
  const int o1 = min(max(oct1[i], 0), levels - 1);
  const int o2 = min(max(oct2[j], 0), levels - 1);
  const float e1 = __fdiv_rn(reproj_err(T1, X, p1, fx, fy, cx, cy, &z1), __ldg(sig2 + o1));
  const float e2 = __fdiv_rn(reproj_err(T2, X, p2, fx, fy, cx, cy, &z2), __ldg(sig2 + o2));
  float d1[3], d2[3];
  ray(T1, X, d1);
  ray(T2, X, d2);
  const float n1 = __fsqrt_rn(dot3(d1[0], d1[1], d1[2], d1[0], d1[1], d1[2]));
  const float n2n = __fsqrt_rn(dot3(d2[0], d2[1], d2[2], d2[0], d2[1], d2[2]));
  const float cosp = __fdiv_rn(dot3(d1[0], d1[1], d1[2], d2[0], d2[1], d2[2]), clamp_min(mul(n1, n2n), 1e-12f));
  const float ratio_dist = __fdiv_rn(n1, clamp_min(n2n, 1e-9f));
  const float ratio_oct = __fdiv_rn(__ldg(sf + o1), __ldg(sf + o2));
  const float ratio_factor = mul(1.5f, __ldg(sf + 1));
  const bool scale_ok = ratio_dist < mul(ratio_oct, ratio_factor) && mul(ratio_dist, ratio_factor) > ratio_oct;
  const bool finite = isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]);
  ok[i] = m >= 0 && finite && z1 > 0.0f && z2 > 0.0f && cosp < 0.9998f && e1 < 5.991f && e2 < 5.991f && scale_ok;
  xyz[3 * i + 0] = X[0];
  xyz[3 * i + 1] = X[1];
  xyz[3 * i + 2] = X[2];
}

}  // namespace

// P1, P2: (3,4) row-major float32; xy1, xy2: (n,2) float32; out: (n,3)
// float32; all on the card. Returns the launch's cudaError_t.
extern "C" int triangulate_dlt(const void* P1, const void* P2, const void* xy1, const void* xy2,
                               void* out, int n, void* stream) {
  if (n < 0 || !P1 || !P2 || !xy1 || !xy2 || !out) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  triangulate_dlt_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(P1), static_cast<const float*>(P2),
      static_cast<const float2*>(xy1), static_cast<const float2*>(xy2),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// T1, T2: (4,4) row-major float32 world-to-camera poses; xy1: (n,2)
// float32 points of the new keyframe; uv2: (n2,2) float32 points of the
// neighbour; idx: (n,) int64 match into uv2, -1 unmatched; oct1: (n,),
// oct2: (n2,) int32 octaves; sig2, sf: (levels,) float32, levels >= 2;
// fx, fy, cx, cy the pinhole intrinsics. Writes xyz (n,3) float32 and ok
// (n,) bool; all on the card. Returns the launch's cudaError_t.
extern "C" int triangulate_gated(const void* T1, const void* T2, const void* xy1, const void* uv2,
                                 const void* idx, const void* oct1, const void* oct2, const void* sig2,
                                 const void* sf, int levels, int n, int n2, float fx, float fy, float cx,
                                 float cy, void* xyz, void* ok, void* stream) {
  if (n < 0 || levels < 2 || (n > 0 && n2 < 1) || !T1 || !T2 || !xy1 || !uv2 || !idx || !oct1 || !oct2 ||
      !sig2 || !sf || !xyz || !ok)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  triangulate_gated_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(T1), static_cast<const float*>(T2), static_cast<const float2*>(xy1),
      static_cast<const float2*>(uv2), static_cast<const int64_t*>(idx), static_cast<const int*>(oct1),
      static_cast<const int*>(oct2), static_cast<const float*>(sig2), static_cast<const float*>(sf), levels, n,
      n2, fx, fy, cx, cy, static_cast<float*>(xyz), static_cast<bool*>(ok));
  return static_cast<int>(cudaGetLastError());
}
