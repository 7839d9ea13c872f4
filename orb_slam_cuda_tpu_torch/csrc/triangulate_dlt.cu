// Two-view linear (DLT) triangulation, one thread a point, for Hopper.
//
// Answers to orb_slam_cuda_tpu/geometry/triangulate.py::triangulate_dlt,
// which the JAX package runs on every triangulation neighbour of every
// keyframe (engine/local_mapping.py::triangulate_with_neighbor): per point
// the 4x4 system A of the rows x*P[2]-P[0], y*P[2]-P[1] of both views, its
// null vector taken as the eigenvector of A^T A with the smallest
// eigenvalue (`jnp.linalg.eigh` on an (N,4,4) batch, the form the JAX
// package chose for the TPU), then dehomogenized with |w| clamped to
// 1e-12. It is not a Pallas kernel; it replaces a batched eigen-solver
// call, which on the card reads a status back to the host and so cannot
// run inside a captured CUDA graph.
//
// Here each thread builds A from P1, P2 (12 floats each, read by every
// thread and cached) and its two image points, forms A^T A in double and
// finds its eigenvectors by cyclic Jacobi: JACOBI_SWEEPS sweeps over the 6
// off-diagonal pairs, every index a compile-time constant so the 4x4
// matrices stay in registers. A symmetric 4x4 matrix converges to double
// rounding within about 5 sweeps; 8 leave a margin, and a fixed count
// keeps the threads of a warp in step. The column of the smallest
// diagonal entry is the null vector; it is rounded to float before the
// clamp and the division, as the plain version divides in float.
//
// Bound, at the main path's shapes (N = 2000 features of a keyframe): the
// function must read 16 B and write 12 B a point and 96 B of matrices,
// 56 KB, 0.017 us at 3.35 TB/s; it does about 4,200 double operations a
// point (8 sweeps x 6 rotations x ~84, plus forming A and A^T A), 8.4 Mop,
// 0.25 us at the card's 34 TFLOP/s FP64 rate outside the tensor cores.
// Bound by operations on paper; at 16 blocks of 128 threads one launch is
// all latency, which is why the design is one thread a point and one
// launch a neighbour pair, with nothing staged in shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int JACOBI_SWEEPS = 8;
constexpr int BLOCK = 128;

template <int p, int q>
__device__ __forceinline__ void rotate(double (&a)[4][4], double (&v)[4][4]) {
  const double apq = a[p][q];
  if (apq == 0.0) return;
  const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
  // The smaller root of t^2 + 2 theta t - 1 = 0; a huge theta gives t = 0.
  const double t = copysign(1.0, theta) / (fabs(theta) + sqrt(theta * theta + 1.0));
  const double c = 1.0 / sqrt(t * t + 1.0);
  const double s = t * c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // A <- A J
    const double akp = a[k][p], akq = a[k][q];
    a[k][p] = c * akp - s * akq;
    a[k][q] = s * akp + c * akq;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // A <- J^T A
    const double apk = a[p][k], aqk = a[q][k];
    a[p][k] = c * apk - s * aqk;
    a[q][k] = s * apk + c * aqk;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // V <- V J
    const double vkp = v[k][p], vkq = v[k][q];
    v[k][p] = c * vkp - s * vkq;
    v[k][q] = s * vkp + c * vkq;
  }
}

__global__ void __launch_bounds__(BLOCK)
triangulate_dlt_kernel(const float* __restrict__ P1, const float* __restrict__ P2,
                       const float2* __restrict__ xy1, const float2* __restrict__ xy2,
                       float* __restrict__ out, int n) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const float2 p1 = xy1[i];
  const float2 p2 = xy2[i];
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
  for (int sweep = 0; sweep < JACOBI_SWEEPS; ++sweep) {
    rotate<0, 1>(a, v);
    rotate<0, 2>(a, v);
    rotate<0, 3>(a, v);
    rotate<1, 2>(a, v);
    rotate<1, 3>(a, v);
    rotate<2, 3>(a, v);
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
  out[3 * i + 0] = x[0] / w;
  out[3 * i + 1] = x[1] / w;
  out[3 * i + 2] = x[2] / w;
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
