"""Where the two Sim3 linearization kernels' time goes on the card, and one
tree's kernels held against an older tree's.

The kernels: the essential graph's edge linearization
(csrc/pose_graph_edges.cu) and OptimizeSim3's Jacobian
(csrc/sim3_opt_jacobian.cu), both on csrc/sim3_dual.cuh. The calls:
chip_smoke.py's 256-keyframe ring padded to the loop closer's bucket
(`pose_graph_args(padded_ring)`: 1,024 edges, 763 valid) and its
full-width Jacobian call (`sim3_opt_full_width_args`: 2,000 pairs).

For this tree's sources and `--parent DIR`'s (an older tree's csrc/ files
and its ops/pose_graph_kernel.py, e.g. written out with `git show`):

  * builds a copy of each source under build/jacobian_split/, as it is and
    with globaltimer and clock64 stamps written by thread 0 of each block at
    the boundaries of the kernel's phases (a copy outside the tree: the
    committed sources have no switch for them), with `-Xptxas -v` (each
    kernel's registers, stack and spills) and, where the toolkit has
    cuobjdump, each kernel's SASS instructions (a static count: the code
    a thread may run, not what it runs);
  * times each source as it is, in turns (parent, tree, tree, parent):
    warm (CUDA events around 10 launches queued behind a long product,
    chip_smoke.py's `device_median_ms`), cold (a 128 MB write before each
    launch) and as called (events around this tree's wrapper, its library
    swapped for the source's); an empty kernel of each design's grid (the
    launch alone); each phase's median over 30 stamped runs, clock64 of
    the median block, and the span from the first block's start to the
    last block's end (globaltimer);
  * holds the tree's outputs against the parent's on both calls;
  * builds and times, beside each source as it is, the variants of its
    design (`DESIGNS`), each a patch of the source's text: the edge
    linearization at 16 and 32 edges a block, with csrc/sim3_dual.cuh's
    Zero as a plain double (every tangent a seed leaves 0 computed as a
    runtime 0.0: the shared primal without the specialised chains) and with
    each lane running its edge's primal itself (the specialised chains
    without the shared primal); the Jacobian's rows form (a thread a (pair,
    family), its seven directions one after another);
  * times the edge-linearization wrapper's host work a call (perf_counter
    over 400 calls, no synchronize inside) for this tree's
    ops/pose_graph_kernel.py and the parent's, both on this tree's library:
    its parts once, and the whole call in 10 pairs of turns.

Each source is recognised by its text (the parent's lane designs or this
tree's phase designs); a source with neither fails. Prints one JSON
object.

    mkdir -p OLD
    for f in csrc/pose_graph_edges.cu csrc/sim3_opt_jacobian.cu csrc/sim3_dual.cuh ops/pose_graph_kernel.py; do
      git show <commit>:orb_slam_cuda_tpu_torch/$f > OLD/$(basename $f); done
    PYTHONPATH=$PWD python tests/torch_jacobian_split.py --parent OLD [--out SPLIT.json]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "jacobian_split")
BLOCK_SLOTS = 24  # stamps: block b at b * 24 + k
MAX_BLOCKS = 1536
N_SLOTS = MAX_BLOCKS * BLOCK_SLOTS + 1
CALIB = N_SLOTS - 1
REPS = 30
WRAPPER_PAIRS = 10
SOURCES = {"pose_graph": "pose_graph_edges.cu", "sim3_opt": "sim3_opt_jacobian.cu"}

PRELUDE = r"""
__device__ unsigned long long split_stamps[%(n)d][2];
__device__ __forceinline__ unsigned long long split_gtime() {
  unsigned long long g;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(g));
  return g;
}
// Thread `tid` of a block (0 unless given) stamps slot k once `dep` has
// arrived: the branch on it cannot resolve before, and the stamps are
// inside it.
__host__ __device__ inline void split_mark(int k, double dep, int tid = 0) {
#ifdef __CUDA_ARCH__
  if (threadIdx.x == tid && dep != 1.2345e300) {
    split_stamps[blockIdx.x * %(bs)d + k][0] = split_gtime();
    split_stamps[blockIdx.x * %(bs)d + k][1] = (unsigned long long)clock64();
  }
#endif
}
// Lane 0 of warp w < 5 stamps slot 3 + w: each warp's end.
__host__ __device__ inline void split_warp_end() {
#ifdef __CUDA_ARCH__
  if (threadIdx.x %% 32 == 0 && threadIdx.x / 32 < 5) split_mark(3 + threadIdx.x / 32, 0.0, threadIdx.x);
#endif
}
__global__ void split_calib_kernel(long long cycles) {
  const unsigned long long g0 = split_gtime();
  const long long c0 = clock64();
  long long c = c0;
  while (c - c0 < cycles) c = clock64();
  split_stamps[%(calib)d][0] = split_gtime() - g0;
  split_stamps[%(calib)d][1] = (unsigned long long)(c - c0);
}
__global__ void split_empty_kernel() {}
// Cycles of one dependent double operation of kind K, over a chain of n
// (clock64 of thread 0): the latencies that the kernels' chains wait on.
template <int K>
__global__ void split_latency_kernel(int n, double x0, double* out) {
  __shared__ double sh[64];
  if (threadIdx.x < 64) sh[threadIdx.x] = x0 + threadIdx.x * 1e-3;
  __syncthreads();
  double x = x0;
  const long long c0 = clock64();
  for (int i = 0; i < n; ++i) {
    if (K == 0) x = fma(x, 0.999999, 1e-7);
    if (K == 1) x = 1.0000001 / x;
    if (K == 2) x = sqrt(x) + 0.5;
    if (K == 3) x = exp(x * 1e-3);
    if (K == 4) x = log(x + 2.0);
    if (K == 5) x = sin(x) + 1.0;
    if (K == 6) x = atan2(x, 1.5) + 1.0;
    if (K == 7) x = sh[(int)(x * 1e-9) & 63] + x * 1e-300;
  }
  const long long c1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = (double)(c1 - c0) / n;
    out[1] = x;
  }
}
// Cycles an instruction of straight-line code that a warp runs once (8
// independent FMA chains, 4,096 FMAs unrolled: fetched as it runs) against
// the same 512 FMAs run again from a loop (fetched once).
template <bool ONCE>
__global__ void split_fetch_kernel(double x0, double* out) {
  double a[8];
  for (int k = 0; k < 8; ++k) a[k] = x0 + k;
  const long long c0 = clock64();
  if (ONCE) {
#pragma unroll
    for (int i = 0; i < 512; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = fma(a[k], 0.999999, 1e-7 * (i + 1));
  } else {
#pragma unroll 1
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int i = 0; i < 64; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) a[k] = fma(a[k], 0.999999, 1e-7 * (i + 1));
  }
  const long long c1 = clock64();
  double sum = 0.0;
  for (int k = 0; k < 8; ++k) sum += a[k];
  if (threadIdx.x == 0) {
    out[0] = (double)(c1 - c0) / 4096.0;
    out[1] = sum;
  }
}
extern "C" int split_calibrate(long long cycles) {
  split_calib_kernel<<<1, 1>>>(cycles);
  return (int)cudaDeviceSynchronize();
}
extern "C" int split_empty(int blocks, int threads, void* stream) {
  split_empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
extern "C" int split_latency(int kind, int n, void* out) {
  double* o = (double*)out;
  switch (kind) {
    case 0: split_latency_kernel<0><<<1, 32>>>(n, 1.25, o); break;
    case 1: split_latency_kernel<1><<<1, 32>>>(n, 1.25, o); break;
    case 2: split_latency_kernel<2><<<1, 32>>>(n, 1.25, o); break;
    case 3: split_latency_kernel<3><<<1, 32>>>(n, 1.25, o); break;
    case 4: split_latency_kernel<4><<<1, 32>>>(n, 1.25, o); break;
    case 5: split_latency_kernel<5><<<1, 32>>>(n, 1.25, o); break;
    case 6: split_latency_kernel<6><<<1, 32>>>(n, 1.25, o); break;
    case 7: split_latency_kernel<7><<<1, 32>>>(n, 1.25, o); break;
    case 8: split_fetch_kernel<true><<<1, 32>>>(1.25, o); break;
    case 9: split_fetch_kernel<false><<<1, 32>>>(1.25, o); break;
  }
  return (int)cudaDeviceSynchronize();
}
extern "C" int split_clear() {
  static unsigned long long zero[%(n)d][2];
  return (int)cudaMemcpyToSymbol(split_stamps, zero, sizeof(zero));
}
extern "C" int split_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, split_stamps, sizeof(split_stamps));
}
""" % dict(n=N_SLOTS, calib=CALIB, bs=BLOCK_SLOTS)

# Each design: how its text is recognised, its stamps (anchor, text put
# before it, text put after it; each anchor must occur once), its phases
# (stamp slots from, to; several "to" slots: the last of them), the slots a
# block ends at, and its variants, the first the source as it is: name ->
# dict(grid: (blocks, threads) for a call's size n, edges or pairs; patch:
# edits of the source, header: of csrc/sim3_dual.cuh, each (old, new), old
# found once, or (start, end, new), the text from start through end
# replaced; anchors: stamps added for this variant; own_anchors: its stamps
# in place of the design's; phases, block_end: in place of the design's).
WARP_ENDS = (3, 4, 5, 6, 7)

# Zero as a plain double: the specialised chains run every tangent a seed
# leaves 0 as a runtime 0.0, the same code otherwise (the edge
# linearization's `value(Zero)` overload goes with it).
NO_ZERO = ("struct Zero {};\n", "  return pass ? d : T(0.0);\n}\n", """using Zero = double;
template <bool Reached, typename T>
struct TangentOf {
  using type = T;
};
template <typename U>
struct As {
  template <typename T>
  static S3D_FN T of(T d) {
    return d;
  }
};
template <typename U>
struct IsZero {
  static constexpr bool value = false;
};
template <typename T>
S3D_FN T keep(bool pass, T d) {
  return pass ? d : T(0.0);
}
""")

# The edge linearization with each direction lane running its edge's
# primal chain itself (phase 1 into the lane's own Kept) and then its
# specialised tangent chain: the Zero tangents without the shared primal.
LANES_ZERO_KERNEL = """__global__ void __launch_bounds__(pge::THREADS)
    pose_graph_edges_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ s,
                            int64_t K, const int64_t* __restrict__ ei, const int64_t* __restrict__ ej,
                            const float* __restrict__ mR, const float* __restrict__ mt, const float* __restrict__ ms,
                            const bool* __restrict__ valid, int64_t E, float* __restrict__ r, float* __restrict__ Ji,
                            float* __restrict__ Jj, int* __restrict__ flags) {
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * pge::EDGES;
  const pge::Lane l = pge::lane_of(threadIdx.x);
  if (!(l.active && e0 + l.edge < E)) return;
  const int64_t e = e0 + l.edge;
  pge::Kept k;
  pge::edge_phase1a(R, t, s, K, ei, ej, mR, mt, ms, valid, e, k, r, flags);
  pge::edge_phase1b(k, e, r, flags);
  pge::LaneFront front;
  if (k.status_a == pge::SPECIALISED) front = pge::lane_front(k, l);
  pge::edge_phase2(k, l, e, front, Ji, Jj);
}
"""

# The Jacobian's rows form: a thread a (pair, family) row, the seven
# directions' chains one after another.
ROWS_KERNEL = """__global__ void __launch_bounds__(THREADS)
    sim3_opt_jacobian_kernel(const float* __restrict__ R, const float* __restrict__ t, const float* __restrict__ s,
                             const float* __restrict__ x1c, const float* __restrict__ x2c, int64_t M, double fx,
                             double fy, float* __restrict__ J) {
  __shared__ soj::Pose<double> poses[soj::DIRECTIONS];
  const int64_t g = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int f = g >= M;
  const int64_t m = g - f * M;
  double x[3];
  if (g < 2 * M) soj::load_point(f == 0 ? x2c : x1c, m, x);
  if (threadIdx.x < soj::DIRECTIONS) poses[threadIdx.x] = soj::load_pose<double>(R, t, s, threadIdx.x);
  __syncthreads();
  if (g >= 2 * M) return;
  for (int c = 0; c < soj::DIRECTIONS; ++c) {
    double j[2];
    soj::family_generic(f == 0 ? poses[c].S : poses[c].Si, x, fx, fy, j);
    soj::store(J, M, f, m, c, j);
  }
}

int grid(int64_t M) { return static_cast<int>((2 * M + THREADS - 1) / THREADS); }
"""


def _pg_grid(edges: int):
    lanes = 2 * ((3 * edges + 31) // 32 * 32) + (edges + 31) // 32 * 32
    return lambda n: ((n + edges - 1) // edges, 2 * lanes + 32)


def _items_grid(n: int):
    return (((n + 31) // 32 * 14 + 3) // 4, 128)


DESIGNS = {
    # The lane design: a thread an (edge, direction), 16 lanes an edge, the whole dual chain a thread.
    "pose_graph_lanes": dict(
        kernel="pose_graph", marker="constexpr int LANES = 16;",
        anchors=[
            ("  float* J = (lane < 7 ? Ji : Jj) + e * 49 + lane % 7;\n", "  split_mark(0, 0.0);\n", ""),
            ("    Mte[i] = T(mt[3 * e + i]);\n  }\n", "",
             "  split_mark(1, double(Ra[8] + Rb[8] + MRe[8] + ta[2] + tb[2] + Mte[2]));\n"),
            ("  for (int k = 0; k < 7; ++k) J[7 * k] = static_cast<float>(dr[k]);\n",
             "  split_mark(2, double(dr[0] + dr[6] + r[0] + r[6]));\n", ""),
            ("    flags_out[e] = f;\n  }\n", "", "  split_mark(3, 0.0);\n"),
        ],
        phases={"loads": (0, (1,)), "chain": (1, (2,)), "stores": (2, (3,))}, block_end=(3,),
        variants={"lanes16": dict(grid=lambda n: ((n * 16 + 127) // 128, 128))}),
    # The phase design: phase 1 a lane an edge (loads, the primal chain, kept in shared
    # memory) in two halves in a warp of its own, phase 2 a lane an (edge,
    # direction), a warp one class, each lane's front half beside phase 1b.
    # The primal warp's lane 0 (P0) stamps phase 1, thread 0 the barriers,
    # thread 64 (the first phi lane at 8 edges a block) its front and back
    # halves, each warp's lane 0 its end.
    "pose_graph_phases": dict(
        kernel="pose_graph", marker="constexpr int VERTEX_LANES",
        anchors=[
            ("static_assert(EDGES <= WARP, \"one primal warp a block\");\n", "",
             "constexpr int P0 = DIRECTION_LANES;\n"),
            ("  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * pge::EDGES;\n", "", "  split_mark(0, 0.0);\n"),
            ("  k.Ms = ms[e];\n", "", "  split_mark(1, k.Ms + k.Ri[8] + k.Rj[8] + k.MR[8] + k.ti[2] + k.tj[2], P0);\n"),
            ("  k.theta = atan2(k.sin_t, k.cos_t);\n", "", "  split_mark(8, k.theta, P0);\n"),
            ("  k.status_a = ok ? SPECIALISED : GENERIC;\n", "", "  split_mark(9, k.sigma + k.phi[2], P0);\n"),
            ("  const pge::Lane l = pge::lane_of(threadIdx.x);\n", "  split_mark(2, 0.0);\n", ""),
            ("  for (int i = 0; i < 9; ++i) {\n    const double ak_bkk", "  split_mark(10, k.a + k.b + k.KK[8], P0);\n",
             ""),
            ("  lu3_solve(lu, piv, rho);\n  for (int i = 0; i < 9; ++i) k.lu[i] = lu[i];\n", "",
             "  split_mark(11, rho[0] + rho[2], P0);\n"),
            ("  if (mine && kept[l.edge].status_a == pge::SPECIALISED) front = pge::lane_front(kept[l.edge], l);\n",
             "", "  split_mark(13, front.phi_d[0] + front.phi_d[2], 64);\n"),
            ("  if (primal) pge::edge_phase1b(kept[p], e0 + p, r, flags);\n", "", "  split_mark(12, 0.0, pge::P0);\n"),
            ("    chain_back(k, narrow<double, Zero>(front), dr);\n", "    split_mark(14, 0.0, 64);\n", ""),
            ("  lu3_solve(k.lu, k.piv, drho);\n", "  split_mark(17, drho[0] + drho[2], 0);\n",
             "  split_mark(15, drho[0] + drho[2], 64);\n  split_mark(18, drho[0] + drho[2], 0);\n"),
            ("  const bool nzs = (k.flags & FLAG_SIGMA_ZERO) != 0, nzt = (k.flags & FLAG_THETA_ZERO) != 0;\n"
             "  using TW", "  split_mark(16, f.Bt_d[0], 0);\n", ""),
            ("    chain_back(k, narrow<Zero, double>(front), dr);\n  }\n", "",
             "  split_mark(19, dr[0] + dr[6], 0);\n"),
            ("  if (mine) pge::edge_phase2(kept[l.edge], l, e0 + l.edge, front, Ji, Jj);\n", "",
             "  split_warp_end();\n"),
        ],
        phases={"loads": (0, (1,)), "p1a_to_atan2": (1, (8,)), "p1a_rest": (8, (9,)), "sync1": (9, (2,)),
                "p1b_w": (2, (10,)), "p1b_lu": (10, (11,)), "p1b_to_sync": (11, (12,)), "phi_front": (2, (13,)),
                "phi_wait": (13, (14,)), "phi_back": (14, (15,)), "sync2_and_tangents": (12, WARP_ENDS),
                "warp0_rho_i": (12, (3,)), "warp1_sigma_i": (12, (4,)), "warp2_phi_i": (12, (5,)),
                "rho0_to_back": (12, (16,)), "rho0_drho_rhs": (16, (17,)), "rho0_lu_solve": (17, (18,)),
                "rho0_to_stores": (18, (19,)), "rho0_stores": (19, (3,))},
        block_end=WARP_ENDS,
        variants={"edges8": dict(grid=_pg_grid(8)),
                  "edges8_no_zero": dict(grid=_pg_grid(8),
                                         patch=[NO_ZERO, ("S3D_FN double value(Zero) { return 0.0; }\n", "")]),
                  "lanes_zero": dict(
                      grid=_pg_grid(8), phases={"lane": (0, WARP_ENDS)},
                      patch=[("__global__ void __launch_bounds__(pge::THREADS)\n    pose_graph_edges_kernel(",
                              "  if (mine) pge::edge_phase2(kept[l.edge], l, e0 + l.edge, front, Ji, Jj);\n}\n",
                              LANES_ZERO_KERNEL)],
                      own_anchors=[
                          ("  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * pge::EDGES;\n", "",
                           "  split_mark(0, 0.0);\n"),
                          ("  pge::edge_phase2(k, l, e, front, Ji, Jj);\n", "", "  split_warp_end();\n")]),
                  "edges16": dict(grid=_pg_grid(16), patch=[("EDGES = 8;", "EDGES = 16;")]),
                  "edges32": dict(grid=_pg_grid(32), patch=[("EDGES = 8;", "EDGES = 32;")])}),
    # The lane design: a thread a (pair, direction), 8 lanes a pair, the pose and both chains a thread.
    "sim3_opt_lanes": dict(
        kernel="sim3_opt", marker="constexpr int LANES = 8;",
        anchors=[
            ("  if (m >= M || c >= soj::DIRECTIONS) return;\n", "", "  split_mark(0, 0.0);\n"),
            ("  soj::pair_lane<double>(P, x1c, x2c, M, m, c, fx, fy, J);\n}\n",
             "  split_mark(1, P.Si.t[2].v + P.Si.t[2].d);\n", ""),
            ("    x2[i] = T(x2c[3 * m + i]);\n  }\n", "", "  split_mark(2, double(x1[2] + x2[2]));\n"),
            ("  transform(P.Si, x1, y);\n", "  split_mark(3, double(j[0] + j[1]));\n", ""),
            ("  for (int k = 0; k < 2; ++k) J[(2 * (M + m) + k) * DIRECTIONS + c] = static_cast<float>(j[k]);\n", "",
             "  split_mark(4, 0.0);\n"),
        ],
        phases={"pose": (0, (1,)), "loads": (1, (2,)), "family1": (2, (3,)), "family2": (3, (4,))}, block_end=(4,),
        variants={"lanes8": dict(grid=lambda n: ((n * 8 + 255) // 256, 256))}),
    # The item design: threads 0-6 seed the block's seven poses into shared memory while every
    # thread loads its point; then a thread an item (pair, family, direction), a warp one (family,
    # direction) over 32 pairs; or, the rows variant, a thread a (pair, family) row.
    "sim3_opt_items": dict(
        kernel="sim3_opt", marker="constexpr int COMBOS",
        anchors=[
            ("  if (threadIdx.x < soj::DIRECTIONS) poses[threadIdx.x] = soj::load_pose<double>(R, t, s, "
             "threadIdx.x);\n", "", "  split_mark(1, threadIdx.x == 0 ? poses[0].Si.t[2].v : 0.0);\n"),
        ],
        phases={"loads_and_poses": (0, (1,)), "sync": (1, (2,)), "chains": (2, WARP_ENDS)},
        block_end=WARP_ENDS,
        variants={"items": dict(grid=_items_grid, anchors=[
                      ("  double x[3];\n  if (m < M) soj::load_point", "  split_mark(0, 0.0);\n", ""),
                      ("  __syncthreads();\n  if (m >= M) return;\n", "", "  split_mark(2, 0.0);\n"),
                      ("  soj::family_generic(f == 0 ? poses[c].S : poses[c].Si, x, fx, fy, j);\n"
                       "  soj::store(J, M, f, m, c, j);\n", "", "  split_warp_end();\n")]),
                  "rows": dict(grid=lambda n: ((2 * n + 127) // 128, 128), anchors=[
                      ("  double x[3];\n  if (g < 2 * M) soj::load_point", "  split_mark(0, 0.0);\n", ""),
                      ("  __syncthreads();\n  if (g >= 2 * M) return;\n", "", "  split_mark(2, 0.0);\n"),
                      ("    soj::store(J, M, f, m, c, j);\n  }\n", "", "  split_warp_end();\n")],
                      patch=[("// A thread an item (pair m, family f, direction c);",
                              "  return static_cast<int>((warps + THREADS / WARP - 1) / (THREADS / WARP));\n}\n",
                              ROWS_KERNEL)])}),
}


def _design(text: str, kernel: str) -> str:
    for name, d in DESIGNS.items():
        if d["kernel"] == kernel and d["marker"] in text:
            return name
    raise SystemExit(f"torch_jacobian_split: the {kernel} source holds no known design")


def patched(text: str, edits) -> str:
    """`text` with each edit applied: (old, new), old found once, or
    (start, end, new), the text from start through the first end after it
    replaced."""
    for edit in edits:
        if text.count(edit[0]) != 1:
            raise SystemExit(f"torch_jacobian_split: patch text {edit[0].strip()!r} found {text.count(edit[0])} times")
        a = text.index(edit[0])
        b = a + len(edit[0]) if len(edit) == 2 else text.index(edit[1], a) + len(edit[1])
        text = text[:a] + edit[-1] + text[b:]
    return text


def instrument(text: str, design: str, variant: str) -> str:
    head = '#include "sim3_dual.cuh"\n'
    if text.count(head) != 1:
        raise SystemExit("torch_jacobian_split: no sim3_dual.cuh include to put the stamps after")
    text = text.replace(head, head + PRELUDE)
    spec = DESIGNS[design]["variants"][variant]
    anchors = spec["own_anchors"] if "own_anchors" in spec else DESIGNS[design]["anchors"] + spec.get("anchors", [])
    for anchor, before, after in anchors:
        if text.count(anchor) != 1:
            raise SystemExit(f"torch_jacobian_split: anchor {anchor.strip()!r} found {text.count(anchor)} times")
        text = text.replace(anchor, before + anchor + after)
    return text


def _nvcc() -> str:
    from orb_slam_cuda_tpu_torch.ops.fast_kernel import _nvcc as nvcc

    return nvcc()


def ptxas_report(stderr: str) -> dict:
    """Registers, stack and spills of each kernel entry, from -Xptxas -v."""
    out, name = {}, None
    for line in stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "split_" not in k}


def sass_counts(lib: str) -> dict | None:
    """SASS instructions of each kernel in `lib` (cuobjdump -sass), or None
    without cuobjdump."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        return None
    proc = subprocess.run([tool, "-sass", lib], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"error": proc.stderr.strip()[-300:]}
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            counts[name] += 1
    return {k: v for k, v in counts.items() if "split_" not in k}


def build(src_dir: str, name: str, kernel: str, variant: str | None, stamped: bool) -> dict:
    """A copy of `src_dir`'s `kernel` source and its sim3_dual.cuh, as
    `variant` of its design (None: the source as it is), built by nvcc under
    build/jacobian_split/NAME/<kernel>_VARIANT[_stamped]/: its library,
    design, variant, grid, ptxas report and SASS counts."""
    from orb_slam_cuda_tpu_torch.ops.fast_kernel import NVCC_FLAGS

    with open(os.path.join(src_dir, SOURCES[kernel])) as f:
        text = f.read()
    design = _design(text, kernel)
    variants = DESIGNS[design]["variants"]
    variant = variant or next(iter(variants))
    spec = variants[variant]
    stem = f"{kernel}_{variant}{'_stamped' if stamped else ''}"
    here = os.path.join(OUT_DIR, name, stem)
    os.makedirs(here, exist_ok=True)
    with open(os.path.join(src_dir, "sim3_dual.cuh")) as f:
        header = patched(f.read(), spec.get("header", []))
    with open(os.path.join(here, "sim3_dual.cuh"), "w") as f:
        f.write(header)
    text = patched(text, spec.get("patch", []))
    if stamped:
        text = instrument(text, design, variant)
    src = os.path.join(here, stem + ".cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(here, f"lib{stem}.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", src, "-o", lib], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{proc.stderr}")
    return dict(lib=lib, design=design, variant=variant, grid=spec["grid"], build_s=time.perf_counter() - t0,
                ptxas=ptxas_report(proc.stderr), sass=sass_counts(lib))


def variants_of(src_dir: str, kernel: str) -> list:
    with open(os.path.join(src_dir, SOURCES[kernel])) as f:
        return list(DESIGNS[_design(f.read(), kernel)]["variants"])


class Kernel:
    """One build of a source, called through ctypes with the C interface
    that the wrapper's `_entry` declares (the same in both trees)."""

    def __init__(self, info: dict, kernel: str):
        from orb_slam_cuda_tpu_torch.ops import pose_graph_kernel as pk
        from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel as sk

        self.info, self.kernel, self.design = info, kernel, info["design"]
        self.lib = ctypes.CDLL(info["lib"])
        if kernel == "pose_graph":
            self.fn = pk._entry(self.lib, "pose_graph_edges", 5)
        else:
            self.fn = sk._entry(self.lib, "sim3_opt_jacobian", 2)
        if hasattr(self.lib, "split_read"):
            self.lib.split_empty.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            self.lib.split_calibrate.argtypes = [ctypes.c_longlong]

    def outputs(self, call):
        import torch

        dev = call["args"][0].device if self.kernel == "pose_graph" else call["args"][1].device
        if self.kernel == "pose_graph":
            from orb_slam_cuda_tpu_torch.ops import pose_graph_kernel as pk

            return pk._outputs(call["args"][3].shape[0], dev)
        m = call["args"][1].shape[0]
        return (torch.empty((2 * m, 2, 7), dtype=torch.float32, device=dev),)

    def __call__(self, call, out):
        import torch

        a, stream = call["args"], torch.cuda.current_stream().cuda_stream
        if self.kernel == "pose_graph":
            rc = self.fn(*(x.data_ptr() for x in a[:3]), a[0].shape[0], *(x.data_ptr() for x in a[3:]),
                         a[3].shape[0], *(o.data_ptr() for o in out), stream)
        else:
            S, x1c, x2c, cam = a
            rc = self.fn(*(x.data_ptr() for x in (*S, x1c, x2c)), x1c.shape[0], float(cam.fx), float(cam.fy),
                         out[0].data_ptr(), stream)
        if rc:
            raise RuntimeError(f"{self.kernel}: cudaError {rc}")
        return out

    def stamps(self):
        import numpy as np

        host = np.zeros((N_SLOTS, 2), np.uint64)
        rc = self.lib.split_read(host.ctypes.data)
        if rc:
            raise RuntimeError(f"split_read: cudaError {rc}")
        return host.astype(np.int64)


LATENCY_KINDS = ("dfma", "ddiv", "dsqrt", "exp", "log", "sin", "atan2", "shared_load", "fma_straight_line_once",
                 "fma_from_a_loop")


def latencies(k: Kernel) -> dict:
    """Cycles of one dependent operation of each kind (a chain of 2,000 in
    one warp, clock64; the loop's own compare and branch included), and
    cycles an FMA of 8 independent chains, 4,096 unrolled and run once
    against 512 run from a loop 8 times."""
    import torch

    out = torch.zeros(2, dtype=torch.float64, device="cuda")
    res = {}
    for i, name in enumerate(LATENCY_KINDS):
        rc = k.lib.split_latency(i, 2000, ctypes.c_void_p(out.data_ptr()))
        if rc:
            raise RuntimeError(f"split_latency: cudaError {rc}")
        res[name] = float(out[0])
    return res


def sass_text(lib: str) -> str:
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout if tool else ""


def sm_ghz(k: Kernel) -> float:
    """The SM clock in GHz: clock64 cycles over globaltimer ns of a 20 M
    cycle spin (~10 ms)."""
    k.lib.split_clear()
    rc = k.lib.split_calibrate(20_000_000)
    if rc:
        raise RuntimeError(f"split_calibrate: cudaError {rc}")
    st = k.stamps()
    return float(st[CALIB, 1]) / float(st[CALIB, 0])


def phases(k: Kernel, call, ghz: float) -> dict:
    """Each phase's median over REPS stamped runs, in µs: clock64 of the
    median block among those that stamped both ends of the phase (its end:
    the last of its end slots); the spread of the blocks' starts and the
    span from the first block's start to the last end stamp (globaltimer)."""
    import numpy as np
    import torch

    d = dict(DESIGNS[k.design], **DESIGNS[k.design]["variants"][k.info["variant"]])
    blocks = k.info["grid"](call["n"])[0]
    out = k.outputs(call)
    ends = list(d["block_end"])
    rows = []
    for _ in range(REPS):
        k.lib.split_clear()
        k(call, out)
        torch.cuda.synchronize()
        st = k.stamps()[:blocks * BLOCK_SLOTS].reshape(blocks, BLOCK_SLOTS, 2)
        r = {}
        for name, (a, to) in d["phases"].items():
            end = st[:, list(to), 1].max(axis=1)
            ok = (st[:, a, 1] != 0) & (end != 0)
            r[name] = float(np.median(end[ok] - st[ok, a, 1])) / ghz / 1e3 if ok.any() else float("nan")
        started = st[:, 0, 0] != 0
        last = st[:, ends, 0].max(axis=1)
        r["blocks_stamped"] = int(started.sum())
        r["blocks_start_spread"] = float(st[started, 0, 0].max() - st[started, 0, 0].min()) / 1e3
        r["span"] = float(last[last != 0].max() - st[started, 0, 0].min()) / 1e3
        rows.append(r)
    return {key: statistics.median(r[key] for r in rows) for key in rows[0]}


def compare(kernel: str, a, b) -> dict:
    import torch

    if kernel == "pose_graph":
        names = ("r", "Ji", "Jj", "flags")
    else:
        names = ("J",)
    out = {}
    for n, x, y in zip(names, a, b):
        same_nan = bool(torch.equal(torch.isnan(x), torch.isnan(y))) if x.is_floating_point() else True
        fin = torch.isfinite(x) & torch.isfinite(y) if x.is_floating_point() else torch.ones_like(x, dtype=torch.bool)
        out[n] = dict(torch_equal=bool(torch.equal(x, y)), nan_equal=same_nan,
                      max_abs_diff=float((x[fin].double() - y[fin].double()).abs().max()) if bool(fin.any()) else 0.0,
                      entries_parted=int((x[fin] != y[fin]).sum()))
    return out


def load_wrapper(path: str, name: str):
    """ops/pose_graph_kernel.py of another tree, loaded inside this tree's
    package (its relative imports resolve to this tree's modules)."""
    spec = importlib.util.spec_from_file_location(f"orb_slam_cuda_tpu_torch.ops.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = "orb_slam_cuda_tpu_torch.ops"
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def host_us_a_call(fn, n: int = 400) -> float:
    """fn's host time a call (µs): the median of 5 runs of `n` calls each,
    no synchronize inside a run."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def wrapper_host_us(mod, lib, args) -> dict:
    """The wrapper's host time a call on `lib`, its parts timed the same way
    (the checks, the output allocations, the ctypes call with its pointers
    and stream, the device context), and its time as called (CUDA events
    around one call, chip_smoke.py's `cuda_median_ms`)."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke

    mod._lib = lib
    dev = args[0].device
    k, e = mod._checked(args, dev)
    out = mod._outputs(e, dev)

    def call():
        lib.pose_graph_edges(*(x.data_ptr() for x in args[:3]), k, *(x.data_ptr() for x in args[3:]), e,
                             *(o.data_ptr() for o in out), torch.cuda.current_stream(dev).cuda_stream)

    def context():
        with torch.cuda.device(dev):
            pass

    parts = {"checks": host_us_a_call(lambda: mod._checked(args, dev)),
             "outputs": host_us_a_call(lambda: mod._outputs(e, dev)), "ctypes_call": host_us_a_call(call),
             "device_context": host_us_a_call(context),
             "capturing_query": host_us_a_call(torch.cuda.is_current_stream_capturing)}
    return dict(host_us=host_us_a_call(lambda: mod.launch(*args)), parts_us=parts,
                as_called_ms=chip_smoke.cuda_median_ms(lambda: mod.launch(*args)))


def wrapper_turns(mods: dict, lib, args, pairs: int = WRAPPER_PAIRS) -> dict:
    """Each wrapper's host time a call (`host_us_a_call` of `launch`) in
    `pairs` pairs of turns, the order flipped each pair (parent, tree;
    tree, parent; ...): the readings, their median, least and most, and
    whether the two sets are apart (every reading of one below every
    reading of the other)."""
    for mod in mods.values():
        mod._lib = lib
    reads = {name: [] for name in mods}
    names = list(mods)
    for i in range(pairs):
        for name in names if i % 2 == 0 else names[::-1]:
            reads[name].append(host_us_a_call(lambda: mods[name].launch(*args)))
    lo = {name: min(r) for name, r in reads.items()}
    hi = {name: max(r) for name, r in reads.items()}
    a, b = names
    return dict(reads_us=reads, median_us={name: statistics.median(r) for name, r in reads.items()}, min_us=lo,
                max_us=hi, apart=hi[a] < lo[b] or hi[b] < lo[a])


def split(parent: str, out_path: str | None) -> None:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from orb_slam_cuda_tpu_torch.ops import pose_graph_kernel as pk
    from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel as sk

    dev = torch.device("cuda")
    csrc = os.path.dirname(pk.SOURCE)
    pg_args = chip_smoke.pose_graph_args(chip_smoke.padded_ring(dev))
    so_args = chip_smoke.sim3_opt_full_width_args(dev)
    calls = {"pose_graph": dict(args=pg_args, n=pg_args[3].shape[0], label="the padded ring"),
             "sim3_opt": dict(args=so_args, n=so_args[1].shape[0], label="the full-width call")}
    trees = {"tree": csrc, "parent": parent}
    # (tree, kernel, variant): the parent's default, every variant of this tree's design
    builds = [("parent", k, variants_of(parent, k)[0]) for k in SOURCES]
    builds += [("tree", k, v) for k in SOURCES for v in variants_of(csrc, k)]
    jobs = [b + (st,) for b in builds for st in (False, True)]
    with ThreadPoolExecutor(8) as pool:  # nvcc builds, started together
        built = {job: pool.submit(build, trees[job[0]], job[0], job[1], job[2], job[3]) for job in jobs}
        kernels = {job: Kernel(f.result(), job[1]) for job, f in built.items()}
    ghz = sm_ghz(next(k for (t, _, _, st), k in kernels.items() if st))
    stamped_tree = next(k for (t, _, _, st), k in kernels.items() if st and t == "tree")
    res = {"card": chip_smoke.phase_device(), "sm_ghz": ghz, "latency_cycles": latencies(stamped_tree),
           "kernels": {}}
    if out_path:  # the SASS of this tree's default builds, beside the JSON
        with open(os.path.splitext(out_path)[0] + ".sass.txt", "w") as f:
            for k in SOURCES:
                f.write(sass_text(kernels["tree", k, variants_of(csrc, k)[0], False].info["lib"]))
    flush = torch.empty(128 * 1024 * 1024 // 4, device=dev)  # 128 MB > the 50 MB L2
    for kname, call in calls.items():
        wrapper = pk if kname == "pose_graph" else sk
        row = {"call": call["label"], "n": call["n"]}
        names = [f"{t}:{v}" for t, k, v in builds if k == kname]  # the parent first, then this tree's default
        outs = {}
        for (t, k, v) in builds:
            if k != kname:
                continue
            plain, stamped = kernels[t, k, v, False], kernels[t, k, v, True]
            o1, o2 = plain(call, plain.outputs(call)), plain(call, plain.outputs(call))
            torch.cuda.synchronize()
            outs[f"{t}:{v}"] = o1
            blocks, threads = plain.info["grid"](call["n"])
            empty = chip_smoke.device_median_ms(
                lambda: stamped.lib.split_empty(blocks, threads, torch.cuda.current_stream().cuda_stream), inner=10)
            row[f"{t}:{v}"] = dict(design=plain.design, grid=[blocks, threads], build_s=plain.info["build_s"],
                                   ptxas=plain.info["ptxas"], sass=plain.info["sass"], empty_grid_ms=empty,
                                   two_launches_equal=all(torch.equal(a, b) for a, b in zip(o1, o2)),
                                   phases_us=phases(stamped, call, ghz), warm_ms=[], cold_ms=[], as_called_ms=[])
        for name in names + names[::-1]:  # in turns
            t, v = name.split(":")
            k = kernels[t, kname, v, False]
            out = k.outputs(call)
            row[name]["warm_ms"].append(chip_smoke.device_median_ms(lambda: k(call, out), inner=10))
            row[name]["cold_ms"].append(chip_smoke.device_median_ms(lambda: k(call, out), before=flush.zero_))
            saved = wrapper._lib
            wrapper._lib = k.lib
            row[name]["as_called_ms"].append(chip_smoke.cuda_median_ms(lambda: wrapper.launch(*call["args"])))
            wrapper._lib = saved
        row["against_parent"] = {n: compare(kname, outs[n], outs[names[0]]) for n in names[1:]}
        res["kernels"][kname] = row
    parent_wrapper = load_wrapper(os.path.join(parent, "pose_graph_kernel.py"), "parent_pose_graph_kernel")
    lib = kernels["tree", "pose_graph", variants_of(csrc, "pose_graph")[0], False].lib
    pk._entry(lib, "pose_graph_edges", 5)
    launches = pk.launches
    res["pose_graph_wrapper"] = {"parent": wrapper_host_us(parent_wrapper, lib, pg_args),
                                 "tree": wrapper_host_us(pk, lib, pg_args),
                                 "turns": wrapper_turns({"parent": parent_wrapper, "tree": pk}, lib, pg_args)}
    pk.launches = launches
    text = json.dumps(res, indent=1)
    print(text)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            f.write(text + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a directory with an older tree's csrc/ sources and wrapper")
    ap.add_argument("--out")
    a = ap.parse_args()
    split(a.parent, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
