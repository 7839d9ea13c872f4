// Sim3 RANSAC between matched camera-frame point sets, for Hopper.
//
// Answers to orb_slam_cuda_tpu/solvers/sim3_solver.py::solve_sim3_ransac
// (:78), the loop closer's verification of a candidate: per minimal set of
// 3 matches, Horn's closed form (centroids, the 3x3 cross-covariance, the
// 4x4 N-matrix and the eigenvector of its largest eigenvalue, there by a
// batched `jnp.linalg.eigh` over the 128 hypotheses, :60, the form the JAX
// package chose for the TPU), the symmetric scale (or s = 1) and t; the
// bidirectional reprojection test over all M matches with positive depth
// in both frames; the first hypothesis of most inliers (`jnp.argmax`); one
// weighted Horn refit on its inliers (:157), kept if it explains at least
// as many. Its plain version is the port's solvers/sim3_solver.py::
// solve_sim3_ransac_plain (`torch.linalg.eigh`, which on the card reads a
// status back to the host and so cannot run inside a captured CUDA graph).
//
// Two launches: `hypotheses_kernel`, one block a hypothesis: thread 0
// solves Horn in double (the 4x4 Jacobi of jacobi4.cuh, shared with the
// DLT kernel), then the block counts that hypothesis's inliers over M in
// float32 (`__syncthreads_count`, an integer sum: exact in any order).
// `refit_kernel`, one block: the first maximum of the counts, the refit's
// centroids and moments (each thread sums its own matches in index order
// in double, then a pairwise tree adds the threads' sums: a fixed order,
// so two runs are bit-equal), Horn, the refit's count, the choice and the
// inlier mask. No float atomics anywhere.
//
// Bound at the loop path's shapes (M = 2000 matches, 128 hypotheses):
// the count is 128 x V bidirectional projections over the V valid
// matches, 78 float32 operations each, against 48 B read for each valid
// match, and `valid` read and the mask written for every one (2 B): bound
// by operations (chip_smoke.py counts both, Horn's sweeps included).
// The Horn solves are a dependent chain of a few microseconds in one
// thread, and the single-block refit passes are latency: a simple kernel
// that is right, not yet a fast one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi4.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SWEEPS = 12;
constexpr double DBL_EPS = 2.220446049250313e-16;
constexpr int NPARAM = 13;  // R (row-major 9), t (3), s

struct Cam {
  float fx, fy, cx, cy;
};

struct Sim3f {
  float R[9], t[3], s;
};

// Horn's rotation, scale and translation from the centred cross-covariance
// M = sum y2 y1^T, sum |y1|^2, the second moment C = sum y2 y2^T (upper
// triangle: xx, xy, xz, yy, yz, zz) and the centroids, all in double:
// x1 ~ s R x2 + t. The quaternion (w,x,y,z) is the eigenvector of the
// N-matrix's largest eigenvalue (the last of equal ones, as `eigh`'s
// ascending order puts it last).
__device__ Sim3f horn(const double (&M)[3][3], double y1sq, const double (&C)[6], const double (&c1)[3],
                      const double (&c2)[3], bool fix_scale) {
  const double Sxx = M[0][0], Sxy = M[0][1], Sxz = M[0][2];
  const double Syx = M[1][0], Syy = M[1][1], Syz = M[1][2];
  const double Szx = M[2][0], Szy = M[2][1], Szz = M[2][2];
  double a[4][4], v[4][4];
  a[0][0] = Sxx + Syy + Szz;
  a[0][1] = Syz - Szy;
  a[0][2] = Szx - Sxz;
  a[0][3] = Sxy - Syx;
  a[1][1] = Sxx - Syy - Szz;
  a[1][2] = Sxy + Syx;
  a[1][3] = Szx + Sxz;
  a[2][2] = -Sxx + Syy - Szz;
  a[2][3] = Syz + Szy;
  a[3][3] = -Sxx - Syy + Szz;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[r][c] = r == c ? 1.0 : 0.0;
  }
  // N is symmetric but not semi-definite: the scale of the exit test is
  // the sum of the diagonal's magnitudes.
#pragma unroll 1
  for (int sweep = 0; sweep < MAX_SWEEPS; ++sweep) {
    jacobi4::sweep(a, v);
    const double scale = fabs(a[0][0]) + fabs(a[1][1]) + fabs(a[2][2]) + fabs(a[3][3]);
    if (jacobi4::off_max(a) <= DBL_EPS * scale) break;
  }
  int m = 0;
  double best = a[0][0];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    if (a[k][k] >= best) {
      best = a[k][k];
      m = k;
    }
  }
  double q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = m == 0 ? v[k][0] : m == 1 ? v[k][1] : m == 2 ? v[k][2] : v[k][3];
  const double qn = rsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const double w = q[0] * qn, x = q[1] * qn, y = q[2] * qn, z = q[3] * qn;
  double R[3][3];
  R[0][0] = 1 - 2 * (y * y + z * z);
  R[0][1] = 2 * (x * y - w * z);
  R[0][2] = 2 * (x * z + w * y);
  R[1][0] = 2 * (x * y + w * z);
  R[1][1] = 1 - 2 * (x * x + z * z);
  R[1][2] = 2 * (y * z - w * x);
  R[2][0] = 2 * (x * z - w * y);
  R[2][1] = 2 * (y * z + w * x);
  R[2][2] = 1 - 2 * (x * x + y * y);
  double s = 1.0;
  if (!fix_scale) {
    // sum |R y2|^2 = sum over rows r of R_r C R_r^T.
    double den = 0.0;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const double a0 = R[r][0], a1 = R[r][1], a2 = R[r][2];
      den += a0 * (a0 * C[0] + 2.0 * (a1 * C[1] + a2 * C[2])) + a1 * (a1 * C[3] + 2.0 * a2 * C[4]) +
             a2 * a2 * C[5];
    }
    s = sqrt(y1sq / fmax(den, 1e-12));
  }
  Sim3f o;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) o.R[3 * r + c] = (float)R[r][c];
    o.t[r] = (float)(c1[r] - s * (R[r][0] * c2[0] + R[r][1] * c2[1] + R[r][2] * c2[2]));
  }
  o.s = (float)s;
  return o;
}

// Match i an inlier of the hypothesis: x2 into frame 1 projected near uv1
// and x1 into frame 2 near uv2 (squared pixels under th1, th2), both in
// front of their camera (geometry/camera.py::project's |z| clamp at 1e-9).
__device__ __forceinline__ bool inlier(const Sim3f& S, float si, const float* __restrict__ x1,
                                       const float* __restrict__ x2, const float2* __restrict__ uv1,
                                       const float2* __restrict__ uv2, const float* __restrict__ th1,
                                       const float* __restrict__ th2, const bool* __restrict__ valid, Cam cam,
                                       int i) {
  if (!valid[i]) return false;
  const float a0 = x2[3 * i], a1 = x2[3 * i + 1], a2 = x2[3 * i + 2];
  const float b0 = x1[3 * i] - S.t[0], b1 = x1[3 * i + 1] - S.t[1], b2 = x1[3 * i + 2] - S.t[2];
  float p[3], q[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    p[r] = S.s * (a0 * S.R[3 * r] + a1 * S.R[3 * r + 1] + a2 * S.R[3 * r + 2]) + S.t[r];
    q[r] = si * (b0 * S.R[r] + b1 * S.R[3 + r] + b2 * S.R[6 + r]);
  }
  const float iz1 = 1.0f / (fabsf(p[2]) < 1e-9f ? 1e-9f : p[2]);
  const float iz2 = 1.0f / (fabsf(q[2]) < 1e-9f ? 1e-9f : q[2]);
  const float2 o1 = uv1[i], o2 = uv2[i];
  const float du1 = cam.fx * (p[0] * iz1) + cam.cx - o1.x, dv1 = cam.fy * (p[1] * iz1) + cam.cy - o1.y;
  const float du2 = cam.fx * (q[0] * iz2) + cam.cx - o2.x, dv2 = cam.fy * (q[1] * iz2) + cam.cy - o2.y;
  return du1 * du1 + dv1 * dv1 < th1[i] && du2 * du2 + dv2 * dv2 < th2[i] && p[2] > 0.0f && q[2] > 0.0f;
}

__device__ __forceinline__ float inv_scale(float s) { return 1.0f / (s < 1e-12f ? 1e-12f : s); }

// The block's inlier count of S over all m matches.
__device__ int count_inliers(const Sim3f& S, const float* x1, const float* x2, const float2* uv1,
                             const float2* uv2, const float* th1, const float* th2, const bool* valid, Cam cam,
                             int m) {
  const float si = inv_scale(S.s);
  int n = 0;
  for (int base = 0; base < m; base += THREADS) {
    const int i = base + threadIdx.x;
    n += __syncthreads_count(i < m && inlier(S, si, x1, x2, uv1, uv2, th1, th2, valid, cam, i));
  }
  return n;
}

__global__ void __launch_bounds__(THREADS)
hypotheses_kernel(const float* __restrict__ x1, const float* __restrict__ x2, const float2* __restrict__ uv1,
                  const float2* __restrict__ uv2, const float* __restrict__ th1, const float* __restrict__ th2,
                  const bool* __restrict__ valid, const int64_t* __restrict__ sets, int m, Cam cam,
                  int fix_scale, int* __restrict__ counts, float* __restrict__ params) {
  __shared__ Sim3f S;
  const int h = blockIdx.x;
  if (threadIdx.x == 0) {
    double p1[3][3], p2[3][3], c1[3] = {0, 0, 0}, c2[3] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int64_t j = sets[3 * h + k];
      const int i = (int)(j < 0 ? 0 : j >= m ? m - 1 : j);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        p1[k][c] = x1[3 * i + c];
        p2[k][c] = x2[3 * i + c];
        c1[c] += p1[k][c];
        c2[c] += p2[k][c];
      }
    }
    double M[3][3] = {}, C[6] = {}, y1sq = 0.0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      c1[c] /= 3.0;
      c2[c] /= 3.0;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double y1[3] = {p1[k][0] - c1[0], p1[k][1] - c1[1], p1[k][2] - c1[2]};
      const double y2[3] = {p2[k][0] - c2[0], p2[k][1] - c2[1], p2[k][2] - c2[2]};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) M[a][b] += y2[a] * y1[b];
      }
      y1sq += y1[0] * y1[0] + y1[1] * y1[1] + y1[2] * y1[2];
      C[0] += y2[0] * y2[0];
      C[1] += y2[0] * y2[1];
      C[2] += y2[0] * y2[2];
      C[3] += y2[1] * y2[1];
      C[4] += y2[1] * y2[2];
      C[5] += y2[2] * y2[2];
    }
    S = horn(M, y1sq, C, c1, c2, fix_scale != 0);
  }
  __syncthreads();
  const int n = count_inliers(S, x1, x2, uv1, uv2, th1, th2, valid, cam, m);
  if (threadIdx.x == 0) {
    counts[h] = n;
#pragma unroll
    for (int k = 0; k < 9; ++k) params[NPARAM * h + k] = S.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) params[NPARAM * h + 9 + k] = S.t[k];
    params[NPARAM * h + 12] = S.s;
  }
}

// The block's sums of `k` values from every thread's partial sums, in
// thread 0's `out`: a pairwise tree over the threads, the same pairs every
// run (a fixed order, so bit-equal runs).
template <int k>
__device__ void block_sum(double (&mine)[k], double (*part)[THREADS], double (&out)[k]) {
#pragma unroll
  for (int j = 0; j < k; ++j) part[j][threadIdx.x] = mine[j];
  __syncthreads();
#pragma unroll
  for (int stride = THREADS / 2; stride > 0; stride /= 2) {
    if (threadIdx.x < stride) {
#pragma unroll
      for (int j = 0; j < k; ++j) part[j][threadIdx.x] += part[j][threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < k; ++j) out[j] = part[j][0];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
refit_kernel(const float* __restrict__ x1, const float* __restrict__ x2, const float2* __restrict__ uv1,
             const float2* __restrict__ uv2, const float* __restrict__ th1, const float* __restrict__ th2,
             const bool* __restrict__ valid, int n_hyp, int m, Cam cam, int fix_scale, int min_inliers,
             const int* __restrict__ counts, const float* __restrict__ params, float* __restrict__ R_out,
             float* __restrict__ t_out, float* __restrict__ s_out, bool* __restrict__ inl_out,
             int64_t* __restrict__ n_out, bool* __restrict__ ok_out, int* __restrict__ info) {
  __shared__ Sim3f best, refit;
  __shared__ double part[16][THREADS];
  __shared__ double sums[16];
  __shared__ int n_best_s;
  if (threadIdx.x == 0) {
    int b = 0;
    for (int h = 1; h < n_hyp; ++h) {
      if (counts[h] > counts[b]) b = h;  // the first maximum
    }
    for (int k = 0; k < 9; ++k) best.R[k] = params[NPARAM * b + k];
    for (int k = 0; k < 3; ++k) best.t[k] = params[NPARAM * b + 9 + k];
    best.s = params[NPARAM * b + 12];
    info[0] = b;
  }
  __syncthreads();

  // Pass 1: the best hypothesis's mask and the inliers' count and sums of
  // x1, x2 (the count as a double: exact).
  const float si = inv_scale(best.s);
  double mine[16];
  for (int j = 0; j < 7; ++j) mine[j] = 0.0;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    const bool in = inlier(best, si, x1, x2, uv1, uv2, th1, th2, valid, cam, i);
    inl_out[i] = in;
    if (in) {
      for (int c = 0; c < 3; ++c) {
        mine[c] += x1[3 * i + c];
        mine[3 + c] += x2[3 * i + c];
      }
      mine[6] += 1.0;
    }
  }
  {
    double first[7], tot[7];
    for (int j = 0; j < 7; ++j) first[j] = mine[j];
    block_sum<7>(first, part, tot);
    if (threadIdx.x == 0) {
      n_best_s = (int)tot[6];
      const double n = fmax(tot[6], 3.0);
      for (int j = 0; j < 6; ++j) sums[j] = tot[j] / n;  // c1 (0-2), c2 (3-5)
    }
    __syncthreads();
  }

  // Pass 2: the centred moments over the same inliers.
  double c1[3] = {sums[0], sums[1], sums[2]}, c2[3] = {sums[3], sums[4], sums[5]};
  for (int j = 0; j < 16; ++j) mine[j] = 0.0;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    if (!inl_out[i]) continue;
    const double y1[3] = {x1[3 * i] - c1[0], x1[3 * i + 1] - c1[1], x1[3 * i + 2] - c1[2]};
    const double y2[3] = {x2[3 * i] - c2[0], x2[3 * i + 1] - c2[1], x2[3 * i + 2] - c2[2]};
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) mine[3 * a + b] += y2[a] * y1[b];
    }
    mine[9] += y1[0] * y1[0] + y1[1] * y1[1] + y1[2] * y1[2];
    mine[10] += y2[0] * y2[0];
    mine[11] += y2[0] * y2[1];
    mine[12] += y2[0] * y2[2];
    mine[13] += y2[1] * y2[1];
    mine[14] += y2[1] * y2[2];
    mine[15] += y2[2] * y2[2];
  }
  double tot[16];
  block_sum<16>(mine, part, tot);
  if (threadIdx.x == 0) {
    double M[3][3], C[6];
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) M[a][b] = tot[3 * a + b];
    }
    for (int j = 0; j < 6; ++j) C[j] = tot[10 + j];
    refit = horn(M, tot[9], C, c1, c2, fix_scale != 0);
  }
  __syncthreads();

  // Pass 3: the refit's count; kept if it explains at least as many.
  const int n_refit = count_inliers(refit, x1, x2, uv1, uv2, th1, th2, valid, cam, m);
  const bool better = n_refit >= n_best_s;
  const Sim3f& S = better ? refit : best;
  if (better) {
    const float sr = inv_scale(refit.s);
    for (int i = threadIdx.x; i < m; i += THREADS) {
      inl_out[i] = inlier(refit, sr, x1, x2, uv1, uv2, th1, th2, valid, cam, i);
    }
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 9; ++k) R_out[k] = S.R[k];
    for (int k = 0; k < 3; ++k) t_out[k] = S.t[k];
    s_out[0] = S.s;
    const int n = better ? n_refit : n_best_s;
    n_out[0] = n;
    ok_out[0] = n >= min_inliers;
    info[1] = better;
  }
}

}  // namespace

// x1, x2: (m,3) float32; uv1, uv2: (m,2) float32; th1, th2: (m,) float32;
// valid: (m,) bool; sets: (n_hyp,3) int64 indices into the matches;
// fx, fy, cx, cy the pinhole intrinsics; counts: (n_hyp,) int32 and
// params: (n_hyp,13) float32 scratch. Writes R (3,3), t (3,), s () float32,
// inliers (m,) bool, n_inliers () int64, ok () bool and info (2,) int32
// (the best hypothesis, whether the refit was kept); all on the card.
// Returns the first launch error as a cudaError_t, 0 if none.
extern "C" int sim3_ransac(const void* x1, const void* x2, const void* uv1, const void* uv2, const void* th1,
                           const void* th2, const void* valid, const void* sets, int n_hyp, int m, float fx,
                           float fy, float cx, float cy, int fix_scale, int min_inliers, void* counts,
                           void* params, void* R, void* t, void* s, void* inliers, void* n_inliers, void* ok,
                           void* info, void* stream) {
  if (n_hyp < 1 || m < 1 || !x1 || !x2 || !uv1 || !uv2 || !th1 || !th2 || !valid || !sets || !counts ||
      !params || !R || !t || !s || !inliers || !n_inliers || !ok || !info)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Cam cam{fx, fy, cx, cy};
  const float* X1 = static_cast<const float*>(x1);
  const float* X2 = static_cast<const float*>(x2);
  const float2* U1 = static_cast<const float2*>(uv1);
  const float2* U2 = static_cast<const float2*>(uv2);
  const float* T1 = static_cast<const float*>(th1);
  const float* T2 = static_cast<const float*>(th2);
  const bool* V = static_cast<const bool*>(valid);
  hypotheses_kernel<<<n_hyp, THREADS, 0, st>>>(X1, X2, U1, U2, T1, T2, V, static_cast<const int64_t*>(sets), m,
                                               cam, fix_scale, static_cast<int*>(counts),
                                               static_cast<float*>(params));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  refit_kernel<<<1, THREADS, 0, st>>>(X1, X2, U1, U2, T1, T2, V, n_hyp, m, cam, fix_scale, min_inliers,
                                      static_cast<const int*>(counts), static_cast<const float*>(params),
                                      static_cast<float*>(R), static_cast<float*>(t), static_cast<float*>(s),
                                      static_cast<bool*>(inliers), static_cast<int64_t*>(n_inliers),
                                      static_cast<bool*>(ok), static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}
