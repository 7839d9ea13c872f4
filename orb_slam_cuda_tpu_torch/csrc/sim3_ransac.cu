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
// One launch, one block of 256 threads a hypothesis:
//  1. thread 0 solves the hypothesis's Horn in double (the 4x4 Jacobi of
//     jacobi4.cuh, shared with the DLT kernel) while warps 1-7 stage the
//     valid matches of the first TILE slots into shared memory in index
//     order (a ballot and popc scan, each warp a contiguous run of slots);
//  2. the block counts the hypothesis's inliers over the staged matches
//     in float32 (later tiles staged by all warps), an integer sum;
//     thread 0 writes the count and the Sim3 and takes a ticket
//     (`__threadfence`, then `atomicInc`, which wraps the counter to 0 at
//     the last block: it is 0 again after every call, eager or replayed
//     in a CUDA graph, with no host write);
//  3. the last block to take one refits: warp 0 finds the first maximum
//     of the counts (shuffles over (count, index), the lower index on a
//     tie, as `argmax`), then from the staged matches, read from global
//     memory once where M <= TILE (past it, each pass stages the tiles
//     again): the best hypothesis's inliers and their centroids, the
//     centred moments, Horn, the refit's count and the inlier mask,
//     written once.
// The double sums go in a fixed order (each thread over its staged
// matches in index order, a shuffle tree, then the warps in order), so two
// runs are bit-equal. No float atomics; the ticket is the one integer
// atomic. A ticket is shared by calls on one stream: two calls must not
// run at once on one ticket.
//
// Bound at the loop path's shapes (M = 2000 matches, 128 hypotheses): the
// count is 128 x V bidirectional projections over the V valid matches, 78
// float32 operations each, against 48 B read for each valid match, and
// `valid` read and the mask written for every one (2 B): bound by
// operations (chip_smoke.py counts both, Horn's sweeps included). At the
// loop path's real call (V ~ 84) that bound is ~0.015 us: the kernel is
// latency, one launch and two dependent Horn chains (the hypotheses', then
// the refit's) with short passes between. Hence one launch, the staging
// hidden under the first chain, and every pass after it over the staged
// valid matches in shared memory rather than over all M slots in global
// memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "jacobi4.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 2048;  // slots staged at once: the loop path's M = 2000 in one
constexpr int RMAX = (TILE + (WARPS - 1) * 32 - 1) / ((WARPS - 1) * 32);  // rounds of a staging warp
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_SWEEPS = 12;
constexpr double DBL_EPS = 2.220446049250313e-16;
constexpr int NPARAM = 13;  // R (row-major 9), t (3), s

struct Cam {
  float fx, fy, cx, cy;
};

struct Sim3f {
  float R[9], t[3], s;
};

// The matches: x1, x2 (m,3), uv1, uv2 (m,2), th1, th2 (m,), valid (m,).
struct Matches {
  const float* x1;
  const float* x2;
  const float2* uv1;
  const float2* uv2;
  const float* th1;
  const float* th2;
  const bool* valid;
  int m;
};

// The valid matches among TILE slots, in index order, and the tile's mask.
struct Tile {
  float x1[3][TILE], x2[3][TILE];
  float2 uv1[TILE], uv2[TILE];
  float th1[TILE], th2[TILE];
  int slot[TILE];
  unsigned char flag[TILE];
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

// Horn on hypothesis h's minimal set (indices clamped into the matches).
__device__ Sim3f hypothesis(const Matches& in, const int64_t* __restrict__ sets, int h, bool fix_scale) {
  double p1[3][3], p2[3][3], c1[3] = {0, 0, 0}, c2[3] = {0, 0, 0};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int64_t j = sets[3 * h + k];
    const int i = (int)(j < 0 ? 0 : j >= in.m ? in.m - 1 : j);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p1[k][c] = in.x1[3 * i + c];
      p2[k][c] = in.x2[3 * i + c];
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
  return horn(M, y1sq, C, c1, c2, fix_scale);
}

// Staged match j an inlier of the hypothesis: x2 into frame 1 projected
// near uv1 and x1 into frame 2 near uv2 (squared pixels under th1, th2),
// both in front of their camera (geometry/camera.py::project's |z| clamp
// at 1e-9).
__device__ __forceinline__ bool inlier(const Sim3f& S, float si, const Tile& g, int j, Cam cam) {
  const float a0 = g.x2[0][j], a1 = g.x2[1][j], a2 = g.x2[2][j];
  const float b0 = g.x1[0][j] - S.t[0], b1 = g.x1[1][j] - S.t[1], b2 = g.x1[2][j] - S.t[2];
  float p[3], q[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    p[r] = S.s * (a0 * S.R[3 * r] + a1 * S.R[3 * r + 1] + a2 * S.R[3 * r + 2]) + S.t[r];
    q[r] = si * (b0 * S.R[r] + b1 * S.R[3 + r] + b2 * S.R[6 + r]);
  }
  const float iz1 = 1.0f / (fabsf(p[2]) < 1e-9f ? 1e-9f : p[2]);
  const float iz2 = 1.0f / (fabsf(q[2]) < 1e-9f ? 1e-9f : q[2]);
  const float2 o1 = g.uv1[j], o2 = g.uv2[j];
  const float du1 = cam.fx * (p[0] * iz1) + cam.cx - o1.x, dv1 = cam.fy * (p[1] * iz1) + cam.cy - o1.y;
  const float du2 = cam.fx * (q[0] * iz2) + cam.cx - o2.x, dv2 = cam.fy * (q[1] * iz2) + cam.cy - o2.y;
  return du1 * du1 + dv1 * dv1 < g.th1[j] && du2 * du2 + dv2 * dv2 < g.th2[j] && p[2] > 0.0f && q[2] > 0.0f;
}

__device__ __forceinline__ float inv_scale(float s) { return 1.0f / (s < 1e-12f ? 1e-12f : s); }

// Barrier 1 for the first `n` threads' warps that stage (barrier 0 is
// __syncthreads).
__device__ __forceinline__ void stage_sync(int n) { asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory"); }

// Stages the valid matches among slots [lo, hi) (hi - lo <= TILE) into `g`
// in index order. Warps w0..WARPS-1 take part, each a contiguous run of
// slots: one byte of `valid` a slot, a ballot and popc per 32 slots, the
// warps' totals through `wcount`, then each valid match's 48 B. Returns the
// number staged to every thread that took part. The caller synchronizes
// the block before (g and wcount free) and after (g written).
__device__ int stage(const Matches& in, int lo, int hi, int w0, Tile& g, int* wcount) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = WARPS - w0, q = warp - w0;
  const int rounds = (hi - lo + nw * 32 - 1) / (nw * 32);
  const int base = lo + q * rounds * 32;
  bool v[RMAX];
  unsigned b[RMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int i = base + r * 32 + lane;
    v[r] = r < rounds && i < hi && in.valid[i];
  }
  int tot = 0;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    b[r] = __ballot_sync(FULL, v[r]);
    tot += __popc(b[r]);
  }
  if (lane == 0) wcount[q] = tot;
  stage_sync(nw * 32);
  int off = 0, n = 0;
  for (int k = 0; k < nw; ++k) {
    const int c = wcount[k];
    n += c;
    off += k < q ? c : 0;
  }
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (v[r]) {
      const int i = base + r * 32 + lane, j = off + __popc(b[r] & below);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        g.x1[c][j] = __ldg(in.x1 + 3 * i + c);
        g.x2[c][j] = __ldg(in.x2 + 3 * i + c);
      }
      g.uv1[j] = __ldg(in.uv1 + i);
      g.uv2[j] = __ldg(in.uv2 + i);
      g.th1[j] = __ldg(in.th1 + i);
      g.th2[j] = __ldg(in.th2 + i);
      g.slot[j] = i;
    }
    off += __popc(b[r]);
  }
  return n;
}

// Tile t staged by the whole block, between two barriers.
__device__ int restage(const Matches& in, int t, Tile& g, int* wcount) {
  __syncthreads();
  const int n = stage(in, t * TILE, min(in.m, (t + 1) * TILE), 0, g, wcount);
  __syncthreads();
  return n;
}

// The inliers of S among the first n staged matches, this thread's share.
__device__ __forceinline__ int count_staged(const Sim3f& S, const Tile& g, int n, Cam cam) {
  const float si = inv_scale(S.s);
  int c = 0;
  for (int j = threadIdx.x; j < n; j += THREADS) c += inlier(S, si, g, j, cam);
  return c;
}

// The block's sum of every thread's v, to every thread: a shuffle tree in
// each warp, then the warps in order (a fixed order, so bit-equal runs).
// `scratch` holds WARPS values; the trailing barrier frees it.
__device__ int block_sum(int v, int* scratch) {
  v = __reduce_add_sync(FULL, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = scratch[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// The same for K doubles: the warps' sums added in order by lane k of
// warp 0 for value k. Threads from `reach` on summed nothing (their v is
// +0.0), so a warp wholly past it skips its tree: the same sums bit for
// bit, with fewer shuffles where few matches are staged.
template <int K>
__device__ void block_sum(double (&v)[K], double (*scratch)[16], double* total, int reach) {
  if ((int)(threadIdx.x & ~31u) < reach) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(FULL, v[k], off);
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) scratch[threadIdx.x >> 5][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    double s = scratch[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += scratch[w][threadIdx.x];
    total[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = total[k];
}

__global__ void __launch_bounds__(THREADS)
ransac_kernel(Matches in, const int64_t* __restrict__ sets, Cam cam, int fix_scale, int min_inliers,
              int* __restrict__ counts, float* __restrict__ params, unsigned* __restrict__ ticket,
              float* __restrict__ R_out, float* __restrict__ t_out, float* __restrict__ s_out,
              bool* __restrict__ inl_out, int64_t* __restrict__ n_out, bool* __restrict__ ok_out,
              int* __restrict__ info) {
  extern __shared__ __align__(16) unsigned char smem[];
  Tile& g = *reinterpret_cast<Tile*>(smem);
  __shared__ Sim3f S, refit;
  __shared__ int wcount[WARPS], isum[WARPS], n_first;
  __shared__ double dsum[WARPS][16], dtot[16];
  __shared__ bool last;
  const int h = blockIdx.x, m = in.m;
  const int tiles = (m + TILE - 1) / TILE;

  // 1. Horn on the minimal set beside the first tile's staging.
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) S = hypothesis(in, sets, h, fix_scale != 0);
  } else {
    const int n = stage(in, 0, min(m, TILE), 1, g, wcount);
    if (threadIdx.x == 32) n_first = n;
  }
  __syncthreads();

  // 2. The count, the hypothesis's outputs and the ticket.
  const Sim3f hs = S;
  int staged = n_first;
  int mine = count_staged(hs, g, staged, cam);
  for (int t = 1; t < tiles; ++t) {
    staged = restage(in, t, g, wcount);
    mine += count_staged(hs, g, staged, cam);
  }
  const int n_hyp = block_sum(mine, isum);
  if (threadIdx.x == 0) {
    counts[h] = n_hyp;
#pragma unroll
    for (int k = 0; k < 9; ++k) params[NPARAM * h + k] = hs.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) params[NPARAM * h + 9 + k] = hs.t[k];
    params[NPARAM * h + 12] = hs.s;
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // 3. The first maximum of the counts, by warp 0: each lane over its
  // hypotheses in index order, then shuffles; a tie goes to the lower index.
  if (threadIdx.x < 32) {
    __threadfence();  // the other blocks' counts and Sim3s, read from L2
    int bc = -1, bi = 0;
    for (int base = 0; base < (int)gridDim.x; base += 128) {
      int c[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = base + 32 * u + threadIdx.x;
        c[u] = k < (int)gridDim.x ? __ldcg(counts + k) : -1;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c[u] > bc) {
          bc = c[u];
          bi = base + 32 * u + threadIdx.x;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int oc = __shfl_xor_sync(FULL, bc, off), oi = __shfl_xor_sync(FULL, bi, off);
      if (oc > bc || (oc == bc && oi < bi)) {
        bc = oc;
        bi = oi;
      }
    }
    if (threadIdx.x < NPARAM) {
      const float p = __ldcg(params + NPARAM * bi + threadIdx.x);
      if (threadIdx.x < 9) S.R[threadIdx.x] = p;
      else if (threadIdx.x < 12) S.t[threadIdx.x - 9] = p;
      else S.s = p;
    }
    if (threadIdx.x == 0) info[0] = bi;
  }
  __syncthreads();
  const Sim3f best = S;
  const float sb = inv_scale(best.s);

  // Pass A: the best hypothesis's inliers, their count and sums of x1, x2
  // (the count as a double: exact). Each pass runs over the staged
  // matches; past one tile it stages the tiles again.
  double a[7] = {0, 0, 0, 0, 0, 0, 0};
  int reach = staged;  // threads from here on sum nothing
  for (int t = 0; t < tiles; ++t) {
    if (tiles > 1) {
      staged = restage(in, t, g, wcount);
      reach = t == 0 ? staged : max(reach, staged);
    }
    for (int j = threadIdx.x; j < staged; j += THREADS) {
      if (!inlier(best, sb, g, j, cam)) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[c] += g.x1[c][j];
        a[3 + c] += g.x2[c][j];
      }
      a[6] += 1.0;
    }
  }
  block_sum<7>(a, dsum, dtot, reach);
  const int n_best = (int)a[6];
  const double nn = fmax(a[6], 3.0);
  const double c1[3] = {a[0] / nn, a[1] / nn, a[2] / nn}, c2[3] = {a[3] / nn, a[4] / nn, a[5] / nn};

  // Pass B: the centred moments over the same inliers, then Horn.
  double b[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) b[k] = 0.0;
  for (int t = 0; t < tiles; ++t) {
    if (tiles > 1) staged = restage(in, t, g, wcount);
    for (int j = threadIdx.x; j < staged; j += THREADS) {
      if (!inlier(best, sb, g, j, cam)) continue;
      const double y1[3] = {g.x1[0][j] - c1[0], g.x1[1][j] - c1[1], g.x1[2][j] - c1[2]};
      const double y2[3] = {g.x2[0][j] - c2[0], g.x2[1][j] - c2[1], g.x2[2][j] - c2[2]};
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int c = 0; c < 3; ++c) b[3 * r + c] += y2[r] * y1[c];
      }
      b[9] += y1[0] * y1[0] + y1[1] * y1[1] + y1[2] * y1[2];
      b[10] += y2[0] * y2[0];
      b[11] += y2[0] * y2[1];
      b[12] += y2[0] * y2[2];
      b[13] += y2[1] * y2[1];
      b[14] += y2[1] * y2[2];
      b[15] += y2[2] * y2[2];
    }
  }
  block_sum<16>(b, dsum, dtot, reach);
  if (tiles == 1) {  // the mask's tile cleared while thread 0 solves
    for (int i = threadIdx.x; i < m; i += THREADS) g.flag[i] = 0;
  }
  if (threadIdx.x == 0) {
    const double M[3][3] = {{b[0], b[1], b[2]}, {b[3], b[4], b[5]}, {b[6], b[7], b[8]}};
    const double C[6] = {b[10], b[11], b[12], b[13], b[14], b[15]};
    refit = horn(M, b[9], C, c1, c2, fix_scale != 0);
  }
  __syncthreads();

  // Pass C: the refit's count; kept if it explains at least as many.
  const Sim3f rf = refit;
  int c = 0;
  for (int t = 0; t < tiles; ++t) {
    if (tiles > 1) staged = restage(in, t, g, wcount);
    c += count_staged(rf, g, staged, cam);
  }
  const int n_refit = block_sum(c, isum);
  const bool better = n_refit >= n_best;
  const Sim3f F = better ? rf : best;
  const float sf = inv_scale(F.s);

  // Pass D: the mask, each slot written once.
  for (int t = 0; t < tiles; ++t) {
    const int lo = t * TILE, n_slots = min(m, lo + TILE) - lo;
    if (tiles > 1) {
      staged = restage(in, t, g, wcount);
      for (int i = threadIdx.x; i < n_slots; i += THREADS) g.flag[i] = 0;
      __syncthreads();
    }
    for (int j = threadIdx.x; j < staged; j += THREADS) g.flag[g.slot[j] - lo] = inlier(F, sf, g, j, cam);
    __syncthreads();
    for (int i = threadIdx.x; i < n_slots; i += THREADS) inl_out[lo + i] = g.flag[i] != 0;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R_out[k] = F.R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t_out[k] = F.t[k];
    s_out[0] = F.s;
    const int n = better ? n_refit : n_best;
    n_out[0] = n;
    ok_out[0] = n >= min_inliers;
    info[1] = better;
  }
}

}  // namespace

// x1, x2: (m,3) float32; uv1, uv2: (m,2) float32; th1, th2: (m,) float32;
// valid: (m,) bool; sets: (n_hyp,3) int64 indices into the matches;
// fx, fy, cx, cy the pinhole intrinsics; counts: (n_hyp,) int32 and
// params: (n_hyp,13) float32 scratch (each hypothesis's count and R, t,
// s); ticket: one uint32 on the card, 0 before the first call (each call
// leaves it 0). Writes R (3,3), t (3,), s () float32, inliers (m,) bool,
// n_inliers () int64, ok () bool and info (2,) int32 (the best hypothesis,
// whether the refit was kept); all on the card. One launch. Returns the
// first error as a cudaError_t, 0 if none.
extern "C" int sim3_ransac(const void* x1, const void* x2, const void* uv1, const void* uv2, const void* th1,
                           const void* th2, const void* valid, const void* sets, int n_hyp, int m, float fx,
                           float fy, float cx, float cy, int fix_scale, int min_inliers, void* counts,
                           void* params, void* R, void* t, void* s, void* inliers, void* n_inliers, void* ok,
                           void* info, void* ticket, void* stream) {
  if (n_hyp < 1 || m < 1 || !x1 || !x2 || !uv1 || !uv2 || !th1 || !th2 || !valid || !sets || !counts ||
      !params || !R || !t || !s || !inliers || !n_inliers || !ok || !info || !ticket)
    return static_cast<int>(cudaErrorInvalidValue);
  // The tile is more shared memory than a block gets by default; the
  // attribute is set once for each device (not a stream operation, so a
  // call under graph capture may set it too).
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(ransac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Tile));
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const Matches in{static_cast<const float*>(x1),  static_cast<const float*>(x2),  static_cast<const float2*>(uv1),
                   static_cast<const float2*>(uv2), static_cast<const float*>(th1), static_cast<const float*>(th2),
                   static_cast<const bool*>(valid), m};
  ransac_kernel<<<n_hyp, THREADS, sizeof(Tile), static_cast<cudaStream_t>(stream)>>>(
      in, static_cast<const int64_t*>(sets), Cam{fx, fy, cx, cy}, fix_scale, min_inliers, static_cast<int*>(counts),
      static_cast<float*>(params), static_cast<unsigned*>(ticket), static_cast<float*>(R), static_cast<float*>(t),
      static_cast<float*>(s), static_cast<bool*>(inliers), static_cast<int64_t*>(n_inliers), static_cast<bool*>(ok),
      static_cast<int*>(info));
  return static_cast<int>(cudaGetLastError());
}
