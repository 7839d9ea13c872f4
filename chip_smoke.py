#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (orb_slam_cuda_tpu_torch) once on one GPU.

Phases, each printing its own lines:
  1. device check: a CUDA device is required; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the six hand-written kernel sources from csrc/ with
     nvcc, one process each, started together (fast_corners.cu,
     triangulate_dlt.cu, sim3_ransac.cu, segsum.cu, pose_graph_edges.cu and
     sim3_opt_jacobian.cu; the second and third include jacobi4.cuh, the
     last two sim3_dual.cuh);
  3. kernel against plain: both entry points of the FAST kernel at the 8
     pyramid shapes of a rendered 1241x376 frame, at the 8 of a rendered
     640x480 frame and on uniform noise,
     torch.equal against their plain torch versions: fast_corners_pyramid
     (one launch for all levels; the main path's) and fast_score_pair (one
     level's two raw maps). For each, per frame: the device time by CUDA
     events with the launches queued behind a long kernel so that the
     host is out of the way (median of 20; pyramid warm in L2, and after
     a 128 MB write has flushed L2), the time as the caller sees it
     (events around the wrapper), the plain version's time, and the bound
     from the bytes and operations of this run's shapes;
  4. vocabulary: a DBoW2 text file of the stock ORBvoc.txt's size (k=10,
     L=6, ~982k words, ~140 MB) is generated from a seed into build/
     (reused if there) and loaded by load_orbvoc_text through the native
     scanner that the port compiles itself, then moved to the card;
     prints the seconds of each step and the bytes on the card;
  5. orbit path, bench.py's configuration: System.track_monocular over
     all 108 frames of the synthetic KITTI-resolution orbit (2000
     features, loop closing on, pipeline_lag 3: each frame is one
     fused_pipeline_step queued on the card, its result read up to 3
     frames later), the frames handed over as host arrays as a camera
     gives them, on that vocabulary; gated on tracked ratio, keyframes,
     tracking failures, one kernel launch a frame, device residency, a
     finite last pose and sim(3)-aligned ATE; prints fps, p50/p99 frame
     time over bench.py's window (frames 48-107) and stage means, and
     `build_frame`'s time on that vocabulary beside the 512-word synthetic
     one. Then one more pipelined step, after that warm-up, runs under
     torch.cuda.set_sync_debug_mode("error"): it must not synchronize;
  5a. the DLT kernel (csrc/triangulate_dlt.cu) on real inputs: the orbit
     map's last keyframe against its best covisible neighbour, all 2000
     features, through the mapper's whole triangulation once with the
     kernel's gated entry (everything after the match in one launch) and
     once with its plain version (float32 `eigh` and the gate ops), and
     the DLT entry (the initializer's) on the same pairs: gated on the max
     relative error of each entry's points that both accept (1e-2 against
     float32 `eigh`, 1e-4 against float64), on the share of matched points
     whose gate parts from the plain version's (2%), on the gated entry's
     `ok` against the plain gate stage on the kernel's own points (at most
     2 points apart) and on one device launch a gated call; prints each
     entry's device time warm and cold and as called, the plain version's
     time and device launches, and the bound;
  5b. repeatability: a local BA on the orbit's final map and an
     essential-graph solve (the loop closer's 15 Gauss-Newton steps) on a
     256-keyframe ring with a drifted loop edge, each run twice under
     programs.eager(), then as a program (the capturing call and two
     replays of its CUDA graph): all torch.equal; the times of each call,
     and the capture's own, show what a capture costs.
     Then the segment-sum kernels (csrc/segsum.cu): both solves again with
     their float sums on torch.segment_reduce over the unmasked index (the
     padded slots' zero addends clamped onto segment 0, as the solvers
     summed before the kernel): torch.equal, bit for bit, to the kernels';
     and the local BA's K = 36 (Hcc) and K = 9 (Hpp) calls, as the solve
     makes them, each through the kernel that the source's rule picks
     (named): torch.equal to its plain version and to segment_reduce on
     the unmasked index, its device time warm and cold and as called, the
     bound by bytes, the ordered floor (the longest chain of dependent
     adds at 4 cycles an add at the card's top SM clock), the plain
     version's time and the library call's (segment_reduce on the
     unmasked index, and with the padding spread over trash segments of at
     most 32 addends);
  5c. programs: on the card every path runs its per-frame stages as
     captured CUDA graphs (engine/programs.py). The orbit at lag 0 (all
     108 frames), the first 30 stereo pairs of phase 7's circuit and the
     first 30 RGB-D frames of phase 8's, each through two new Systems:
     under programs.eager() and graphed. Gated on every frame's tracking
     host vector and the trajectories byte-equal, FAST launches equal to
     the extracted images in each run, the DLT launches equal in both, no
     capture or replay in the eager run, one frame-stage program call a
     frame in the graphed one, every keyframe dispatched to the mapper as
     one call of its dispatch program, where the policy inserted two
     keyframes or more, the keyframe programs (insertion, depth points,
     the mapper's dispatch, BA round 2 and erase, loop detection,
     global-BA chunks) replayed, and where the mapper took two keyframes
     or more (the stereo and RGB-D cuts; the orbit's takes one), its
     dispatch replayed: a later keyframe's slot, slot matrix and
     probation set through the first one's graph; prints each run's
     captures, replays, capture seconds per program, graph pool and peak
     reserved memory and host ms a frame;
  6. loop path: the 340-frame KITTI-scale circuit (KITTI00-02 camera,
     2000 features, 1.3 laps of radius 22 m in a 12-wall room with 40
     billboards), rendered on the card, with 3 blank frames at frame 100;
     loop closing on. Gated on a closed loop, a relocalization, tracked
     ratio, live keyframe culling, ATE within 1% of the trajectory's
     extent, kernel launches, device residency and a finite last pose, and
     on the Sim3 stage: one Sim3 kernel launch a candidate verified, the
     `sim3_ransac` program replayed where two or more were, `sim3_refine`
     captured at a key's second call (none where it ran once, replays
     where it ran three times or more); and on the essential-graph solve:
     15 edge-linearization launches a loop closed (one a Gauss-Newton
     step), its `essential_graph` program among the System's programs
     (`loop_pose_graph` per closure and the program's captures and
     replays printed, on the stereo path too); prints fps,
     p50/p99, every mapping, loop-closing, global-BA and relocalization call
     with its frame and time, `loop_sim3` per call, the candidates through
     each Sim3 stage and the four Sim3 programs' captures and replays (as
     the stereo and RGB-D paths do);
  6a. the Sim3 RANSAC kernel (csrc/sim3_ransac.cu) on one real call of the
     loop path (the last candidate whose RANSAC passed, its inputs gathered
     again from that call's map) and on a full-width synthetic call (2,000
     matches, every pair valid, 128 minimal sets): on each, launched twice
     (torch.equal) and held against its plain version (float32 `eigh`):
     `ok` equal, n_inliers within 2, inlier masks parted on at most 2
     matches, R, t, s within 1e-4 of float64 Horn on the inliers it
     refitted on; prints its device time warm and cold and as called and
     the bound (Horn's Jacobi sweeps counted on the call's inputs) on both
     calls, and the plain version's time on the real one. Its gate of one
     device launch a call (torch.profiler, on the full-width call) runs in
     phase 3, before the vocabulary phase, with the segment sum's (one
     device launch a call at the local BA's shape, of the kernel that the
     rule picks there) and the edge linearization's (one device launch a
     call on the padded ring of 5b). Also in phase 3, the essential
     graph's edge linearization (csrc/pose_graph_edges.cu: every edge's
     Sim3 residual and both 7x7 forward-mode Jacobians, one launch a
     Gauss-Newton step) on 5b's 256-keyframe ring (763 edges padded to the
     loop closer's bucket of 1,024) and on a seeded set of edges whose
     residuals take every branch of sim3.log: launched twice (torch.equal)
     and held against its plain version (the float64 chain through
     torch.func.jvp on the card): r within one float32 ulp or 1e-12, Ji and
     Jj within 2^-22 of the edge's largest entry, the same branch flags,
     padded edges zeros; on the ring its device time warm and cold and as
     called, the plain version's time and the bound (this run's double
     operations, counted by the source's host build, at the H100's FP64
     rate, against its bytes). And OptimizeSim3's Jacobian
     (csrc/sim3_opt_jacobian.cu: both reprojection families' 2x7
     forward-mode Jacobians of every pair, one launch an LM iteration) at
     full width (2,000 pairs) and on 64 pairs at 2 rad, each with depths
     clamped to 1e-6 and behind either camera: launched twice (bit-equal)
     and held against its plain version (the float64 chain through
     torch.func.jvp on the card) within 2^-22 of the row's largest entry;
     one device launch a call; at full width its device time warm and cold
     and as called, the plain version's time and the bound; after the loop
     path the same on the Jacobian inputs of its last eager `sim3_refine`,
     whose numbers lead its row; every path with a loop closer gates 15
     launches a refinement;
  6b. parallel: the distributed back end on the loop path's final map.
     (a) its global-BA problem (as the loop closer gathers it) solved by
     bundle_adjust and by distributed_bundle_adjust on a 1-rank NCCL
     group: poses within 1e-4, points within 1e-3, inlier masks equal;
     (b) the same problem saved and solved by 2 spawned ranks sharing the
     card over gloo: the ranks torch.equal, each within (a)'s tolerance;
     (c) one cluster_block_ba round on the map on the 1-rank group, run
     twice: torch.equal, and the global problem's error no higher after
     it than before. Prints each solve's time. (d) the segment-sum kernel
     on the global-BA problem as in 5b: a 2-iteration solve through the
     kernel torch.equal to one on the unmasked index and segment_reduce,
     and the K = 36 and K = 9 calls timed;
  7. stereo path, in a process of its own started after 5b and run beside
     6, 6b, 8 and 9 (its log is printed when it ends): the first 300 frames (1.15 laps; the first loop closes
     by frame 283) of the same scene and circuit as a rectified pair
     (baseline 0.537 m, bf 386.1448) through System.track_stereo, loop
     closing on, no blank frames. Gated on a pose at frame 0, tracked ratio, ATE WITHOUT
     scale alignment within 1% of the extent, the estimated trajectory's
     span within 5% of the true one (metric scale), a closed loop, the
     share of left features with a depth, two kernel launches a frame,
     device residency and a finite last pose;
  8. RGB-D path: the first 90 of the 400 frames of a 640x480 TUM-like
     circuit (8-wall room, radius 1.8 m, 1000 features, 30 fps, depth
     stored as z*5000 truncated to 16 bits) through System.track_rgbd,
     loop closing on (0.28 lap: no loop can close here; the stereo path
     is the one that closes loops at fixed scale). Gated on tracked ratio,
     unscaled ATE within 1% of the extent, one launch a frame, residency
     and a finite last pose; then a localization-only probe: the map is
     saved, loaded into a new System, and the first 30 frames tracked
     again: it must relocalize within 3 frames, track 85% of them, insert
     no keyframe and hold the saved map's keyframes and points; every
     candidate that a relocalization refused before the first pose is
     printed with the rung that refused it;
  9. CLI path: the port's command-line runner, `run.main(argv)` in this
     process, on the first 90 of the 460 frames of config_mono_tum
     (640x480, the TUM1.yaml lens k1 0.262, k2 -0.953, k3 1.163, 1000
     features, 30 fps), generated with the port's tools/accuracy_eval.py
     and PNG writer into a temporary directory and read back through the
     port's dataset reader and PNG decoder: --save-tum --diag --timing-dir
     --save-map; gated on the first pose by frame 60, tracked >= 0.85 of
     the frames from it on, sim(3) ATE within 1% of the whole config's
     5.09 m extent, one launch a frame and a finite last pose; then a
     second `run.main` with --load-map --localization-only on frames 60-79:
     a pose within 3 frames, 85% tracked, no keyframe, 20 launches. Prints
     fps, p50/p99 and stage means from the timing CSVs and the PNG decode
     time a frame.
Every path builds `System(cfg)` with no device argument: the card is the
default. The float segment sums of the solvers and the map statistics
add in a fixed order (ops/segsum.py), so a run on one card repeats bit
for bit (tools/rgbd_repeat.py in the package checks it on the RGB-D
frames); a run on another card or host can still part from it, and every
gate is on this one run. The line before the last is the kernel table as
JSON: the FAST kernel with its launches summed over all paths (one per
extracted image), the DLT kernel's two entries with their launches
summed over all paths: `triangulate_dlt` (the initializer's) and
`triangulate_gated` (one a triangulation neighbour of every keyframe the
mapper took; every path whose mapper dispatched a keyframe must have
launched it), `sim3_ransac` (one a loop candidate verified, on the
loop and stereo paths), `segsum` (every float segment sum of the
bundle adjustments, the essential graph, the BoW rows and the map's
statistics; every path whose mapper dispatched a keyframe must have
launched it), `pose_graph_edges` (15 a loop closed) and
`sim3_opt_jacobian` (15 a Sim3 refinement). The line
before that holds the same numbers for fast_score_pair, the entry point
the paths do not call. The last line is the device JSON. Any failure
raises and exits non-zero without them. Every path prints its programs'
captures, replays and capture seconds (each frame runs one frame-stage
program: the monocular, stereo or RGB-D frame, or the pipelined step;
gated; keyframes run the keyframe programs), the graph pool, the peak
memory reserved and the timesMapping.csv means (`local_mapping`,
`local_ba2`, `loop_pose_graph`, `gba_chunk` among them).

Usage: python3 chip_smoke.py   (from the repository root; needs one GPU)
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

WIDTH, HEIGHT = 1241, 376
# The script must end inside 20 minutes, the frame time is bound by the
# host, and the same code takes 1.4 times as long on one H100 machine as on
# another: run one after the other, the paths took 884.9 s on one and
# 1,243.8 s on another (PERF.md has the runs). So the stereo path runs in a
# process of its own beside the loop, parallel, RGB-D and CLI paths (the
# card is idle most of the time, and the host has 8 cores), and two paths
# are cut: the stereo path to the first STEREO_FRAMES of the circuit (its
# first loop closed between frames 262 and 283 in six runs of six), the
# RGB-D path to the first RGBD_RUN of its config's 400 frames (at 400 the
# script outgrew its limit on the slower hosts). The loop
# path stays whole: cut to 300 frames its ATE missed the gate in the one
# run tried. The orbit is bench.py's whole run (bench.py:49-118).
ORBIT_FRAMES = 108
MEASURE_FROM = 48  # bench.py's warm-up; frames 48-107 are its measured window
PIPELINE_LAG = 3  # bench.py's default (BENCH_LAG)
BUILD_FRAME_FRAMES = 20  # frames over which build_frame is timed on each vocabulary
RING_KEYFRAMES = 256  # the essential graph of the repeatability phase
TH_HI, TH_LO = 20.0, 7.0
CELL, BORDER = 32, 19
# Published peaks of one H100 SXM: device memory and float32 outside the
# tensor cores. The bounds below are taken against them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# Float operations, by the way the kernel computes the function. Every
# pixel takes the quick test on the 4 compass pixels (4 differences, 14
# min/max, a negation, a max and the compare: 21) and the entry point's
# tail: a compare-select per threshold for the raw pair; 8 neighbour maxes,
# 4 threshold selects, 2 suppression compares, the cell select and the
# border select for the fused map. A pixel that passes the quick test also
# takes the full score: 16 differences, 2 x 64 sliding min/max (windows 2,
# 4, 8, 9), 2 x 15 over the 16 starts, a negation and a max (176). How many
# pass depends on the image, and is counted on this run's levels.
OPS_QUICK_TEST = 21
OPS_FULL_SCORE = 176
OPS_TAIL = {"fast_score_pair": 2, "fast_corners_pyramid": 16}
# Bytes a pixel: the image read once, each output written once.
BYTES_PER_PIXEL = {"fast_score_pair": 12, "fast_corners_pyramid": 8}
KERNEL_SOURCE = "orb_slam_cuda_tpu_torch/csrc/fast_corners.cu"
DLT_SOURCE = "orb_slam_cuda_tpu_torch/csrc/triangulate_dlt.cu"
SIM3_SOURCE = "orb_slam_cuda_tpu_torch/csrc/sim3_ransac.cu"
SEGSUM_SOURCE = "orb_slam_cuda_tpu_torch/csrc/segsum.cu"
POSE_GRAPH_SOURCE = "orb_slam_cuda_tpu_torch/csrc/pose_graph_edges.cu"
# One H100 SXM's FP64 rate outside the tensor cores (NVIDIA's data sheet):
# the edge-linearization kernel's chain is double.
PEAK_FP64_OPS_PER_S = 34e12
# The loop closer's Gauss-Newton steps a solve: one edge-linearization
# launch each.
POSE_GRAPH_GN_STEPS = 15
# The edge-linearization kernel against its plain version (both round one
# double chain once to float32): r within one float32 ulp of the plain
# version's or POSE_GRAPH_R_ABS (double cancellation where r ~ 0), Ji and
# Jj within POSE_GRAPH_J_REL of the edge's largest entry (at least 1), the
# branch flags equal.
POSE_GRAPH_R_ABS = 1e-12
POSE_GRAPH_J_REL = 2.0**-22
POSE_GRAPH_SEED = 7  # branch_edges' seed
SIM3_OPT_SOURCE = "orb_slam_cuda_tpu_torch/csrc/sim3_opt_jacobian.cu"
# OptimizeSim3's LM iterations a refinement (5, then 10): one Jacobian
# launch each.
SIM3_OPT_LM_ITERS = 15
# The Jacobian kernel against its plain version (both round one double
# chain once to float32): within SIM3_OPT_J_REL of the row's largest entry
# (a row: J[i], one projection's 2x7 derivative), NaN where it has NaN.
SIM3_OPT_J_REL = 2.0**-22
# The full-width call: a KITTI keyframe's 2,000 features as pairs
# (`sim3_opt_kernel.synthetic_pairs`, its special rows at the head).
SIM3_OPT_FULL_WIDTH, SIM3_OPT_SEED = 2000, 17
# The least bytes of the Jacobian: S (52 B) read once, each pair's x1c and
# x2c (24 B) read once and its J (112 B) written once.
BYTES_SIM3_OPT_POSE, BYTES_SIM3_OPT_PAIR = 52, 24 + 112
# The least bytes of the linearization: the vertices' R, t, s (52 B each)
# read once, each edge's indices, measurement and flag (69 B) read once
# and its r, Ji, Jj and flags (424 B) written once.
BYTES_PG_VERTEX, BYTES_PG_EDGE = 52, 69 + 424
# The least bytes of a segment sum: each valid addend's K floats and its
# int64 place in the sort order read once, the (n+1) int64 offsets read
# and the (n, K) sums written once; its operations are one float add an
# addend.
SEGSUM_TRASH = 32  # the library call's padding spread over segments of at most this many addends
# The ordered floor of a segment sum: its longest segment's chain of
# dependent float adds, FADD_CYCLES each (Hopper's dependent FP32 add), at
# the card's top SM clock (nvidia-smi clocks.max.sm).
FADD_CYCLES = 4
# The least work of the function a point, whatever the kernel does (its
# double arithmetic is its own choice): A (16 products, 16 differences),
# the 10 entries of the symmetric A^T A (4 products and 3 sums each), the
# smallest of 4 and the division by w (7); and a Jacobi sweep of 6
# rotations on the upper triangle (the angle 13; the pivot pair 4; the
# other two rows' pairs 2 x 2 x 3; the eigenvector columns 4 x 2 x 3: 53)
# for each sweep the point needs, counted on this run's inputs by
# `jacobi_sweeps`; at float32's rate, since the function is a float32 DLT
# held to its float32 plain version. Bytes: both image points read (16 B),
# the point written (12 B); the two 3x4 matrices (96 B) once.
OPS_DLT_POINT = 32 + 70 + 7
OPS_DLT_SWEEP = 6 * 53
BYTES_DLT_POINT, BYTES_DLT_FIXED = 28, 96
# The gated entry: the DLT's work and, given its point, the least work of the gate
# stage a point: two camera transforms R X + t (2 x 18; z1 and z2 are their
# third rows), two projections (the |z| test and select, a reciprocal, 2
# products by 1/z, 2 by f and 2 sums with c: 2 x 9), two squared errors
# over sigma^2 (2 x 6), two rays X - C and their norms (2 x 9), the
# parallax cosine (3 products, 2 sums, the norms' product, the clamp, the
# division: 8), the distance ratio with its clamp (2), the octave ratio
# (1), the two scale tests (4), finiteness (3), the five threshold
# compares and the AND of nine conditions (13). Bytes: the new keyframe's
# point, match index and octave read and its point and `ok` written (33 B),
# the neighbour's points and octaves read once (12 B a feature); the two
# poses and two level tables once.
OPS_GATES_POINT = 36 + 18 + 12 + 18 + 8 + 2 + 1 + 4 + 3 + 13
BYTES_GATED_POINT, BYTES_GATED_NEIGHBOUR, BYTES_GATED_FIXED = 33, 12, 128
# Against its plain version (float32 `eigh`, whose rounding the kernel's
# double Jacobi does not share) on the points both accept: the relative
# error of a point; against the plain version in float64 (the same
# function computed exactly but for the float32 inputs and output).
DLT_RTOL_F32, DLT_RTOL_F64 = 1e-2, 1e-4
# The share of matched points whose triangulation gate may part between
# the kernel and float32 `eigh` (a point on a threshold).
DLT_GATE_SHARE = 0.02
# Points whose gated `ok` may part from the plain gate stage run by torch
# on the kernel's own points: torch's float32 ops on the card may contract
# into FMA or sum in another order, so a value within an ulp or two of a
# threshold can fall the other way.
GATE_STAGE_PARTED = 2
# The Sim3 RANSAC kernel against its plain version (float32 `eigh`; the
# kernel solves Horn in double) on one real call of the loop path: `ok`
# equal, n_inliers within SIM3_N_DIFF, masks parted on at most
# SIM3_PARTED matches (a match within rounding of its threshold), R, t, s
# within SIM3_TOL64 of float64 Horn on the inliers the kernel refitted on.
SIM3_N_DIFF, SIM3_PARTED, SIM3_TOL64 = 2, 2, 1e-4
# The least work of the Sim3 RANSAC function, counted from its code, at
# float32's rate: for each hypothesis and valid match the bidirectional
# test (two Sim3 transforms 2 x 21, two projections 2 x 11, two squared
# errors 2 x 3, two threshold and two depth compares, their AND and the
# count 8: 78); for each hypothesis its 3-point sums (centroids 18,
# centring 18, the cross-covariance 45, the second moments 30: 111) and a
# Horn solve (the N-matrix, the quaternion's rotation, scale and t: 100,
# and a Jacobi sweep of the DLT's 318 operations for each sweep its
# N-matrix needs, counted on this call's inputs by `horn_sweeps`); the
# first maximum of the counts; then the refit's sums over the best
# hypothesis's inliers (48 a match), its Horn solve and its bidirectional
# test over the valid matches. Bytes: valid read and the mask written for
# every match (2 B); x1, x2, uv1, uv2, th1 and th2 read for the valid ones
# (48 B); the minimal sets (24 B a hypothesis) and the outputs once.
OPS_SIM3_MATCH, OPS_SIM3_SET, OPS_SIM3_INLIER, OPS_HORN = 78, 111, 48, 100
BYTES_SIM3_MATCH, BYTES_SIM3_VALID, BYTES_SIM3_SET, BYTES_SIM3_FIXED = 2, 48, 24, 64
ATE_GATE = 0.24  # 2% of the 12 m near plane
# The JAX reference System inserts 3 keyframes on this fixture and
# configuration (2 at initialization, 1 by the keyframe policy).
MIN_KEYFRAMES = 3
LOOP_FRAMES = 340  # the circuit, and the loop path
STEREO_FRAMES = 300
BLANK_AT = 100  # 3 blank frames; the map holds 39 keyframes by then
# The JAX reference System on the same 340 frames on the CPU: tracked
# 0.95, 114 keyframes (112 live), 2 loops, 9 relocalizations (4 lost
# frames), ATE 0.4865 m of a 62.22 m extent (0.78%).
PAR_LM_ITERS, PAR_CG_ITERS = 10, 20  # the loop closer's global BA: 10 LM iterations, 20 CG
PAR_POSE_TOL, PAR_POINT_TOL = 1e-4, 1e-3
LOOP_REFERENCE = dict(tracked=0.95, loops=2, n_reloc=9, ate=0.4865)
STEREO_BASELINE, STEREO_BF = 0.537, 386.1448
TH_DEPTH_FACTOR = 40.0  # ThDepth of the accuracy configs' settings files
TUM_WIDTH, TUM_HEIGHT = 640, 480
RGBD_FRAMES = 400  # the config's; RGBD_RUN of them are tracked
RGBD_RUN = 120
RGBD_DT = 1.0 / 30.0
DEPTH_FACTOR = 5000.0  # TUM's: a stored depth of 5000 is 1 m
PROBE_FRAMES = 30
VOCAB_K, VOCAB_DEPTH = 10, 6
# The CLI path: the first CLI_FRAMES of config_mono_tum's 460 frames, then
# a localization-only probe on frames CLI_PROBE_FROM.. of them, inside the
# stretch the map covers (the JAX reference's CLI run of the config first
# tracks at about frame 31: eval/mono_tum.json, gaps [[0.0, 1.03]]).
# Cut from 120 when the orbit became bench.py's 108 pipelined frames, to
# keep the script inside its limit on the slower hosts.
CLI_FRAMES = 90
CLI_FIRST_POSE_BY = 60
CLI_PROBE_FROM, CLI_PROBE_FRAMES = 60, 20
MONO_TUM_EXTENT = 5.09  # the whole config's ground-truth extent, m (eval/mono_tum.json)
CLI_ATE_GATE = 0.01 * MONO_TUM_EXTENT
PROGRAM_FRAMES = 30  # stereo pairs and RGB-D frames of the programs phase
# Runtime API calls by which the host puts work on the card.
LAUNCH_APIS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync"}
# Each frame runs exactly one of these programs (the pipelined step holds
# the frame's extraction).
FRAME_PROGRAMS = ("frame", "pipe", "stereo_frame", "rgbd_frame")
# The keyframe path's programs (engine/system.py, local_mapping.py,
# loop_closing.py).
KEYFRAME_PROGRAMS = ("kf_insert", "depth_points", "map_dispatch", "map_ba2", "map_erase", "loop_detect",
                     "gba_chunk")


def log(*a):
    print(*a, flush=True)


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_median_ms(fn, reps: int = 20, inner: int = 1, before=None):
    """Median device time of one call of `fn` by CUDA events with the host
    out of the way: everything is queued behind three large matrix
    products, so the events see the kernels back to back. Each pair of
    events holds `inner` calls (an empty pair reads about 3 us, which
    `inner` > 1 spreads thin). `before`, if given, runs ahead of each pair,
    outside its events."""
    import torch

    fn()
    blocker = torch.ones((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    pairs = []
    for _ in range(3):
        blocker @ blocker
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) / inner for a, b in pairs)
    return times[len(times) // 2]


def kernel_bound(name: str, pixels: int, candidates: int):
    """(bound_ms, bound_by) of one frame's work: the larger of bytes over
    the memory rate and operations over the float32 rate, for `pixels`
    pixels of which `candidates` pass the quick test."""
    ops = pixels * (OPS_QUICK_TEST + OPS_TAIL[name]) + candidates * OPS_FULL_SCORE
    by_bytes = pixels * BYTES_PER_PIXEL[name] / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def stage_means(rows, first_frame: int) -> str:
    """Mean ms per stage name over StageTimer rows from `first_frame` on."""
    acc = {}
    for frame, name, _, ns in rows:
        if frame >= first_frame:
            acc.setdefault(name, []).append(ns / 1e6)
    if not acc:
        return "none"
    return ", ".join(f"{k} {sum(v) / len(v):.2f} ms (n={len(v)})" for k, v in acc.items())


def stage_mean_ms(rows, stage: str) -> float:
    ns = [r[3] for r in rows if r[1] == stage]
    return sum(ns) / len(ns) / 1e6


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def sm_clock_mhz() -> float:
    """The card's top SM clock in MHz, as nvidia-smi reports it."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(smi.stdout.strip().splitlines()[0])


def phase_build():
    """The six kernels' nvcc builds, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from orb_slam_cuda_tpu_torch.ops import (dlt_kernel, fast_kernel, pose_graph_kernel, segsum, sim3_kernel,
                                             sim3_opt_kernel)

    t0 = time.perf_counter()
    kernels = (fast_kernel, dlt_kernel, sim3_kernel, segsum, pose_graph_kernel, sim3_opt_kernel)
    with ThreadPoolExecutor(len(kernels)) as pool:
        builds = [pool.submit(k.build) for k in kernels]
        results = [b.result() for b in builds]
    sources = (KERNEL_SOURCE, DLT_SOURCE, SIM3_SOURCE, SEGSUM_SOURCE, POSE_GRAPH_SOURCE, SIM3_OPT_SOURCE)
    for source, (path, seconds) in zip(sources, results):
        log(f"build: {source} -> {path} in {seconds:.2f} s")
    log(f"build: all six in {time.perf_counter() - t0:.2f} s")


def reset_launches():
    """Every kernel's launch count to 0, just before a path is driven."""
    from orb_slam_cuda_tpu_torch.ops import (dlt_kernel, fast_kernel, pose_graph_kernel, segsum, sim3_kernel,
                                             sim3_opt_kernel)

    fast_kernel.launches = 0
    dlt_kernel.launches = 0
    dlt_kernel.gated.launches = 0
    sim3_kernel.launches = 0
    segsum.launches = 0
    pose_graph_kernel.launches = 0
    sim3_opt_kernel.launches = 0


# The DLT, Sim3, segment-sum, edge-linearization and OptimizeSim3-Jacobian
# kernels' launches of each path's run, read just after it is driven:
# {"dlt": the initializer's entry, "gated": the mapper's, "sim3": the loop
# closer's RANSAC, "segsum": the float segment sums, "pose_graph": the
# essential graph's Gauss-Newton steps, "sim3_opt": the Sim3 refinement's
# LM iterations}.
PATH_LAUNCHES = {}
PATH_KERNELS = ("dlt", "gated", "sim3", "segsum", "pose_graph", "sim3_opt")


def note_launches(name: str) -> dict:
    """Record the DLT entries', the Sim3 kernel's, the segment-sum kernel's,
    the edge-linearization kernel's and the OptimizeSim3-Jacobian kernel's
    launches of path `name` since reset_launches()."""
    from orb_slam_cuda_tpu_torch.ops import dlt_kernel, pose_graph_kernel, segsum, sim3_kernel, sim3_opt_kernel

    PATH_LAUNCHES[name] = n = {"dlt": dlt_kernel.launches, "gated": dlt_kernel.gated.launches,
                               "sim3": sim3_kernel.launches, "segsum": segsum.launches,
                               "pose_graph": pose_graph_kernel.launches, "sim3_opt": sim3_opt_kernel.launches}
    return n


def mapping_dispatches(slam) -> int:
    return sum(1 for r in slam.timer.rows["timesMapping.csv"] if r[1] == "local_mapping")


def kernel_gates(name: str, slam) -> dict:
    """Record the path's DLT, Sim3 and segment-sum launches, print its Sim3
    stage and gate them: on the card a path whose mapper dispatched a
    keyframe launched the gated DLT entry and the segment-sum kernel (its
    local BA's sums), and the Sim3 kernel launched once a
    candidate the loop closer verified, inside the replays of `sim3_ransac`
    wherever it verified two or more; `sim3_refine` not captured where it
    ran once and replayed where it ran three times or more."""
    n, dispatches = note_launches(name), mapping_dispatches(slam)
    log(f"{name}: dlt, sim3, segsum, pose_graph and sim3_opt launches {n} ({dispatches} keyframes dispatched to the "
        "mapper)")
    gates = {}
    if slam.device.type == "cuda" and dispatches:
        gates[f"gated dlt launches > 0 ({dispatches} keyframes dispatched)"] = n["gated"] > 0
        gates[f"segsum launches > 0 ({dispatches} keyframes dispatched)"] = n["segsum"] > 0
    lc = slam.loop_closer
    if lc is None:
        return gates
    ms = [ns / 1e6 for _, stage, _, ns in slam.timer.rows["timesMapping.csv"] if stage == "loop_sim3"]
    stats = {p.name: p.stats() for p in (lc._match_fn, lc._ransac_fn, lc._refine_fn, lc._gate_fn)}
    pg = [ns / 1e6 for _, stage, _, ns in slam.timer.rows["timesMapping.csv"] if stage == "loop_pose_graph"]
    eg, keys = lc._pose_graph_fn.stats(), len(lc._pose_graph_fn._calls) + len(lc._pose_graph_fn._graphs)
    log(f"{name}: loop_pose_graph per closure " + ", ".join(f"{v:.2f}" for v in pg) + f" ms ({lc.n_loops_closed} "
        f"closures); the essential_graph program (capture_at {lc._pose_graph_fn.capture_at}): {keys} keys, "
        f"{eg['captures']} captures in {eg['capture_s']:.3f} s, {eg['replays']} replays; pose_graph_edges "
        f"launches {n['pose_graph']}")
    if slam.device.type == "cuda":
        want = POSE_GRAPH_GN_STEPS * lc.n_loops_closed
        gates[f"pose_graph_edges launches == {POSE_GRAPH_GN_STEPS} x the {lc.n_loops_closed} closures"] = \
            n["pose_graph"] == want
        gates["the essential_graph program in program_stats()"] = "essential_graph" in slam.program_stats()
    log(f"{name}: loop_sim3 {sum(ms) / max(len(ms), 1):.2f} ms a call (n={len(ms)}, max "
        f"{max(ms, default=0.0):.2f} ms, total {sum(ms):.1f} ms); Sim3 candidates by stage {lc.sim3_counts}; "
        "Sim3 programs (captures in s + replays): "
        + ", ".join(f"{k} {v['captures']} in {v['capture_s']:.3f} + {v['replays']}" for k, v in stats.items())
        + f"; sim3_opt_jacobian launches {n['sim3_opt']}")
    attempts, refined = lc.sim3_counts["ransac"], lc.sim3_counts["refine"]
    if slam.device.type == "cuda":
        gates[f"sim3 launches == the {attempts} candidates verified"] = n["sim3"] == attempts
        gates[f"sim3_opt_jacobian launches == {SIM3_OPT_LM_ITERS} x the {refined} refinements"] = \
            n["sim3_opt"] == SIM3_OPT_LM_ITERS * refined
        if attempts >= 2:
            gates["sim3_ransac replayed"] = stats["sim3_ransac"]["replays"] > 0
        # sim3_refine captures a key at its second call.
        if refined == 1:
            gates["sim3_refine's one call not captured"] = stats["sim3_refine"]["captures"] == 0
        if refined >= 3:
            gates["sim3_refine replayed"] = stats["sim3_refine"]["replays"] > 0
    return gates


class Sim3Recorder:
    """Stands in for a loop closer's `sim3_ransac` program and its host read
    (as `lc._ransac_fn` and `lc._read`) and keeps the arguments of the last
    call whose RANSAC passed, as its own read saw it (no read of its own)."""

    def __init__(self, lc):
        self.program, self.read_fn, self.lc = lc._ransac_fn, lc._read, lc
        self.pending = self.packed = self.last_ok = None
        lc._ransac_fn, lc._read = self, self.read

    def __call__(self, *args):
        out = self.program(*args)
        self.pending, self.packed = args, out[0]
        return out

    def read(self, t):
        v = self.read_fn(t)
        if t is self.packed and v[1]:
            self.last_ok = self.pending
        return v

    def detach(self):
        self.lc._ransac_fn = self.program
        del self.lc._read  # the class's own again


def _rel_err(a, b, mask) -> float:
    """The largest relative error of a point of `a` against `b` on `mask`."""
    import torch

    d = torch.linalg.norm(a.double() - b.double(), dim=-1) / torch.clamp(torch.linalg.norm(b.double(), dim=-1),
                                                                         min=1e-12)
    return float(d[mask].max()) if bool(mask.any()) else 0.0


def jacobi_sweeps(P1, P2, xy1, xy2, cap=8):
    """The Jacobi sweeps each point's DLT solve needs, (N,) int64: the
    kernel's solve (csrc/triangulate_dlt.cu) replayed in float64 on the
    host, every point at once: A^T A of the four DLT rows, stopping after
    the first sweep whose off-diagonal entries are at most double epsilon
    times the trace, `cap` at most."""
    import torch

    P1, P2, xy1, xy2 = (t.detach().double().cpu() for t in (P1, P2, xy1, xy2))
    A = torch.stack([xy1[:, :1] * P1[2] - P1[0], xy1[:, 1:] * P1[2] - P1[1],
                     xy2[:, :1] * P2[2] - P2[0], xy2[:, 1:] * P2[2] - P2[1]], 1)
    return _jacobi4_sweeps(A.transpose(1, 2) @ A, lambda a: a.diagonal(dim1=1, dim2=2).sum(1), cap)


def horn_sweeps(x1, x2, sets, inliers, cap=12):
    """The Jacobi sweeps of the Sim3 kernel's Horn solves on one call,
    (NH + 1,) int64: the N-matrix of each minimal set's centred
    cross-covariance and that of the refit over `inliers` (the best
    hypothesis's inliers, unweighted), in float64 as csrc/sim3_ransac.cu
    forms them, solved by its Jacobi (the DLT kernel's rotations; the exit
    scaled by the diagonal's magnitudes, `cap` sweeps at most)."""
    import torch

    from orb_slam_cuda_tpu_torch.solvers.sim3_solver import n_matrix

    x1, x2 = x1.detach().double().cpu(), x2.detach().double().cpu()
    sets, w = sets.detach().cpu(), inliers.detach().cpu().double()[:, None]
    p1, p2 = x1[sets], x2[sets]
    y1, y2 = p1 - p1.mean(1, keepdim=True), p2 - p2.mean(1, keepdim=True)
    n = torch.clamp(w.sum(), min=3.0)
    c1, c2 = (x1 * w).sum(0) / n, (x2 * w).sum(0) / n
    M = torch.cat([y2.transpose(1, 2) @ y1, (((x2 - c2) * w).T @ ((x1 - c1) * w))[None]])
    return _jacobi4_sweeps(n_matrix(M), lambda a: a.diagonal(dim1=1, dim2=2).abs().sum(1), cap)


def _jacobi4_sweeps(a, scale, cap):
    """The sweeps csrc/jacobi4.cuh's solve takes on each symmetric 4x4
    matrix of `a` (B,4,4) float64 (changed in place): sweeps of 3 rounds of
    2 disjoint rotations, c and s from rsqrt as the kernels take them,
    stopping after the first sweep whose off-diagonal entries are at most
    double epsilon times `scale(a)`, `cap` at most."""
    import torch

    n = a.shape[0]
    sweeps = torch.full((n,), cap, dtype=torch.int64)
    done = torch.zeros(n, dtype=torch.bool)
    eps = torch.finfo(torch.float64).eps
    upper = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]

    def rotation(p, q):
        d, apq = a[:, q, q] - a[:, p, p], a[:, p, q]
        h2 = d * d + 4 * apq * apq
        r = torch.where(h2 > 0, torch.rsqrt(h2), torch.zeros_like(h2))
        u = torch.where(h2 > 0, 0.5 * d.abs() * r + 0.5, torch.ones_like(h2))
        ic = torch.rsqrt(u)
        s = torch.where(d < 0, -apq, apq) * r * ic
        return u * ic, s, s * ic

    for sweep in range(cap):
        for p, q, r_, s_ in ((0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2)):
            (cx, sx, tx), (cy, sy, ty) = rotation(p, q), rotation(r_, s_)
            apq, ars = a[:, p, q].clone(), a[:, r_, s_].clone()
            m = a[:, [p, q]][:, :, [r_, s_]]
            lp = cx[:, None] * m[:, 0] - sx[:, None] * m[:, 1]
            lq = sx[:, None] * m[:, 0] + cx[:, None] * m[:, 1]
            for i, row in ((p, lp), (q, lq)):
                a[:, i, r_] = a[:, r_, i] = cy * row[:, 0] - sy * row[:, 1]
                a[:, i, s_] = a[:, s_, i] = sy * row[:, 0] + cy * row[:, 1]
            a[:, p, p] -= tx * apq
            a[:, q, q] += tx * apq
            a[:, r_, r_] -= ty * ars
            a[:, s_, s_] += ty * ars
            a[:, p, q] = a[:, q, p] = a[:, r_, s_] = a[:, s_, r_] = 0.0
        off = torch.stack([a[:, i, j].abs() for i, j in upper], 1).amax(1)
        now = ~done & (off <= eps * scale(a))
        sweeps[now] = sweep + 1
        done |= now
    return sweeps


def phase_dlt_kernel(slam):
    """Both entries of the DLT kernel on real triangulation inputs: the
    orbit's last keyframe against its best covisible neighbour, as the
    mapper's triangulation gives them to the kernel (all of the keyframe's
    features; unmatched ones paired with feature 0 and gated out). The
    whole triangulation runs twice, with the gated entry and with its
    plain version (float32 `eigh` and the gate ops); the DLT entry runs on
    the same pairs. Errors against float32 and float64 `eigh` on the
    points both accept, the count whose gate parts, the gated `ok` against
    the plain gate stage on the kernel's own points, device launches,
    times and bounds. Returns the kernel-table rows of triangulate_dlt and
    triangulate_gated (without `launches`)."""
    import torch

    from orb_slam_cuda_tpu_torch.engine import local_mapping
    from orb_slam_cuda_tpu_torch.geometry import triangulate
    from orb_slam_cuda_tpu_torch.ops import dlt_kernel
    from orb_slam_cuda_tpu_torch.slam_map import ops as map_ops

    kf = slam.kf_order[-1]
    nb = int(map_ops.top_covisible(slam.state.covis[kf], 1)[0])
    m = slam.mapper
    seen, kernel = [], dlt_kernel.triangulate_gated

    def recorder(*args):
        seen.append(args)
        return kernel(*args)

    def run(fn):
        dlt_kernel.triangulate_gated = fn
        try:
            return local_mapping.triangulate_with_neighbor(slam.state, kf, nb, slam.cam, m.scale_factors,
                                                           m.level_sigma2)
        finally:
            dlt_kernel.triangulate_gated = kernel

    launches0 = (dlt_kernel.launches, dlt_kernel.gated.launches)
    got = run(recorder)
    want = run(triangulate.triangulate_gated_plain)
    args = seen[0]
    cam, T1, T2, xy1, uv2, idx, oct1, oct2, sig2, sf = args
    j = torch.clamp(idx, min=0)
    xy2 = uv2[j].contiguous()
    K = cam.K_on(xy1.device)
    P1, P2 = triangulate.projection_matrix(K, T1), triangulate.projection_matrix(K, T2)
    X_dlt = dlt_kernel.triangulate_dlt(P1, P2, xy1, xy2)
    X32 = triangulate.triangulate_dlt_plain(P1, P2, xy1, xy2)
    X64 = triangulate.triangulate_dlt_plain(P1.double(), P2.double(), xy1.double(), xy2.double())
    matched_mask = idx >= 0
    stage = triangulate.triangulation_gates(cam, got.xyz, T1, T2, xy1, xy2, matched_mask, oct1, oct2[j], sig2, sf)
    torch.cuda.synchronize()
    both = got.ok & want.ok
    matched = int(matched_mask.sum())
    err = {"gated": (_rel_err(got.xyz, want.xyz, both), _rel_err(got.xyz, X64, both)),
           "dlt": (_rel_err(X_dlt, X32, both), _rel_err(X_dlt, X64, both))}
    parted = int((got.ok != want.ok).sum())
    stage_parted = int((stage != got.ok).sum())

    def gated_kern():
        return dlt_kernel.triangulate_gated(*args)

    def gated_plain():
        return triangulate.triangulate_gated_plain(*args)

    def dlt_kern():
        return dlt_kernel.triangulate_dlt(P1, P2, xy1, xy2)

    def dlt_plain():
        return triangulate.triangulate_dlt_plain(P1, P2, xy1, xy2)

    # Device work of the whole triangulation with the kernel, with its plain
    # version and with a stand-in that launches nothing: what each puts on
    # the card after the match.
    def nothing(*a):
        return (torch.empty((a[3].shape[0], 3), device=xy1.device),
                torch.empty((a[3].shape[0],), dtype=torch.bool, device=xy1.device))

    calls0 = dlt_kernel.gated.launches
    events = {k: device_event_names(lambda: run(fn))
              for k, fn in (("kernel", kernel), ("plain", triangulate.triangulate_gated_plain), ("none", nothing))}
    after = {k: len(events[k]) - len(events["none"]) for k in ("kernel", "plain")}
    seen_by_name = sum("triangulate_gated" in e for e in events["kernel"])
    sweeps = jacobi_sweeps(P1, P2, xy1, xy2)
    sweep_counts = {int(k): int(v) for k, v in zip(*torch.unique(sweeps, return_counts=True))}
    wrapper_calls = dlt_kernel.gated.launches - calls0  # 2: the profile's warm-up call and the profiled one
    n, n2 = xy1.shape[0], uv2.shape[0]
    log(f"triangulate_gated on keyframe {kf} against neighbour {nb}: {n} points, {matched} matched, "
        f"{int(got.ok.sum())} accepted ({int(want.ok.sum())} by the plain version, {int(both.sum())} by both); "
        f"max relative error on those {err['gated'][0]:.3e} against float32 eigh (tolerance {DLT_RTOL_F32}), "
        f"{err['gated'][1]:.3e} against float64 eigh (tolerance {DLT_RTOL_F64}); {parted} gates part from the "
        f"plain version's (tolerance {DLT_GATE_SHARE} of {matched}), {stage_parted} from the plain gate stage on "
        f"the kernel's own points (tolerance {GATE_STAGE_PARTED}); device launches after the match "
        f"(torch.profiler, the whole triangulation less the match's {len(events['none'])}): kernel "
        f"{after['kernel']} ({seen_by_name} named triangulate_gated), plain version {after['plain']}")
    log(f"triangulate_dlt on the same {n} pairs: max relative error on the points both accept "
        f"{err['dlt'][0]:.3e} against float32 eigh, {err['dlt'][1]:.3e} against float64 eigh")
    check_gates("triangulate_dlt kernel", {
        "some points accepted": bool(both.any()),
        **{f"{e}: max relative error <= {DLT_RTOL_F32} against float32 eigh": err[e][0] <= DLT_RTOL_F32
           for e in err},
        **{f"{e}: max relative error <= {DLT_RTOL_F64} against float64 eigh": err[e][1] <= DLT_RTOL_F64
           for e in err},
        f"gates part on <= {DLT_GATE_SHARE} of matched points": parted <= DLT_GATE_SHARE * max(matched, 1),
        f"gated ok equal to the plain gate stage on its points but for <= {GATE_STAGE_PARTED}":
            stage_parted <= GATE_STAGE_PARTED,
        f"one device launch after the match ({after['kernel']} profiled, {wrapper_calls} wrapper launches in 2 "
        f"calls, {seen_by_name} named triangulate_gated)":
            after["kernel"] == 1 and seen_by_name == 1 and wrapper_calls == 2,
    })

    flush = torch.empty(128 * 1024 * 1024 // 4, device=xy1.device)  # 128 MB > the 50 MB L2
    rows = []
    levels = sig2.shape[0]
    dlt_ops = n * OPS_DLT_POINT + int(sweeps.sum()) * OPS_DLT_SWEEP
    log(f"DLT solve on these {n} pairs: Jacobi sweeps needed {sweep_counts} (points by sweeps; {dlt_ops / n:.1f} "
        f"float32 operations a point)")
    bounds = {
        "triangulate_dlt": ((n * BYTES_DLT_POINT + BYTES_DLT_FIXED), dlt_ops),
        "triangulate_gated": (n * BYTES_GATED_POINT + n2 * BYTES_GATED_NEIGHBOUR + BYTES_GATED_FIXED + 8 * levels,
                              dlt_ops + n * OPS_GATES_POINT),
    }
    for name, kern, plain, e in (("triangulate_dlt", dlt_kern, dlt_plain, "dlt"),
                                 ("triangulate_gated", gated_kern, gated_plain, "gated")):
        warm = device_median_ms(kern, inner=10)
        cold = device_median_ms(kern, before=flush.zero_)
        called = cuda_median_ms(kern)
        plain_ms = cuda_median_ms(plain)
        nbytes, ops = bounds[name]
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
        bound_ms, bound_by = max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")
        log(f"{name} per call ({n} points): device {warm:.4f} ms warm (10 calls a pair of events), {cold:.4f} ms "
            f"cold L2 (1 call a pair); as called {called:.4f} ms; plain {plain_ms:.4f} ms; bound {bound_ms:.6f} ms "
            f"by {bound_by} ({by_bytes:.6f} by {nbytes} bytes, {by_ops:.6f} by {ops / n:.1f} FP32 operations a "
            f"point); share of bound reached {bound_ms / warm:.4f} warm; library call: none (no one PyTorch call "
            f"triangulates, and eigh reads back)")
        ref = want.xyz if e == "gated" else X32
        pts = got.xyz if e == "gated" else X_dlt
        rows.append({"name": name, "route": "cuda", "source": DLT_SOURCE,
                     "replaces": ("orb_slam_cuda_tpu/geometry/triangulate.py:37" if e == "dlt" else
                                  "orb_slam_cuda_tpu/engine/local_mapping.py:102"),
                     "max_abs_err": float((pts - ref)[both].abs().max()) if bool(both.any()) else 0.0,
                     "max_rel_err": err[e][0], "max_rel_err_f64": err[e][1], "points": n,
                     "jacobi_sweeps": sweep_counts,
                     "ms": warm, "cold_l2_ms": cold,
                     "as_called_ms": called, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": None})
    rows[1].update(gates_parted=parted, stage_parted=stage_parted, device_launches_after_match=after["kernel"],
                   plain_device_launches_after_match=after["plain"])
    dlt_kernel.launches, dlt_kernel.gated.launches = launches0  # the comparison's launches are not the path's
    return rows


def kitti_camera():
    from orb_slam_cuda_tpu_torch.geometry.camera import Camera

    return Camera.create(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                         width=WIDTH, height=HEIGHT)


def make_fixture(device="cpu"):
    import numpy as np

    from orb_slam_cuda_tpu_torch.utils import synthetic

    rng = np.random.default_rng(42)
    cam = kitti_camera()
    scene = synthetic.PlanarScene.default(rng, depth=12.0, second_depth=25.0,
                                          extent=40.0, tex_size=2048)
    poses = synthetic.orbit_trajectory(ORBIT_FRAMES, radius=1.5, depth_amp=0.3)
    t0 = time.perf_counter()
    frames = [scene.render(cam.K, T, WIDTH, HEIGHT, device=device) for T in poses]
    log(f"fixture: {ORBIT_FRAMES} frames {WIDTH}x{HEIGHT} rendered in {time.perf_counter() - t0:.1f} s")
    return cam, poses, frames


def phase_kernels(frame0, tum_frame0):
    """Both entry points of the kernel against their plain versions at
    every shape the paths give the kernel (the 8 levels of a 1241x376 frame
    and of a 640x480 frame), and their times per 1241x376 frame. Returns
    one kernel-table row (without `launches`) per entry point."""
    import torch

    from orb_slam_cuda_tpu_torch.frontend import fast, image_ops
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    dev = torch.device("cuda")
    levels = [lv.contiguous() for lv in
              image_ops.build_pyramid(torch.as_tensor(frame0, device=dev), 8, 1.2)]
    shapes = [tuple(lv.shape) for lv in levels]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    noise = torch.rand((HEIGHT, WIDTH), generator=g, device=dev) * 255.0

    def pair_kernel():
        return [fast_kernel.fast_score_pair(lv, TH_HI, TH_LO) for lv in levels]

    def pair_plain():
        return [(fast.fast_score(lv, TH_HI), fast.fast_score(lv, TH_LO)) for lv in levels]

    out = fast_kernel.pyramid_buffers(shapes, dev)  # as the extractor owns them

    def pyramid_kernel():
        return fast_kernel.fast_corners_pyramid(levels, TH_HI, TH_LO, CELL, BORDER, out=out)

    def pyramid_plain():
        return [fast.fast_corners_plain(lv, TH_HI, TH_LO, CELL, BORDER) for lv in levels]

    tum_levels = [lv.contiguous() for lv in
                  image_ops.build_pyramid(torch.as_tensor(tum_frame0, device=dev), 8, 1.2)]
    max_err = {"fast_score_pair": 0.0, "fast_corners_pyramid": 0.0}
    for name, img in ([(f"level{i}", lv) for i, lv in enumerate(levels)] + [("noise", noise)]
                      + [(f"640x480 level{i}", lv) for i, lv in enumerate(tum_levels)]):
        hi, lo = fast_kernel.fast_score_pair(img, TH_HI, TH_LO)
        (fused,) = fast_kernel.fast_corners_pyramid([img], TH_HI, TH_LO, CELL, BORDER)
        ref_hi, ref_lo = fast.fast_score(img, TH_HI), fast.fast_score(img, TH_LO)
        ref_fused = fast.fast_corners_plain(img, TH_HI, TH_LO, CELL, BORDER)
        torch.cuda.synchronize()
        if not (torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)):
            raise AssertionError(f"fast_score_pair differs from plain at {name} {tuple(img.shape)}")
        if not torch.equal(fused, ref_fused):
            raise AssertionError(f"fast_corners_pyramid differs from plain at {name} {tuple(img.shape)}")
        max_err["fast_score_pair"] = max(max_err["fast_score_pair"], float((hi - ref_hi).abs().max()),
                                         float((lo - ref_lo).abs().max()))
        max_err["fast_corners_pyramid"] = max(max_err["fast_corners_pyramid"],
                                              float((fused - ref_fused).abs().max()))
        log(f"{name} {tuple(img.shape)}: fast_score_pair and fast_corners_pyramid equal their plain "
            f"versions (tolerance 0, torch.equal); {int((ref_fused > 0).sum())} corners")
    # All 8 levels in one launch, into caller-owned buffers, as the extractor calls it.
    for lv, got, want in zip(levels, pyramid_kernel(), pyramid_plain()):
        if not torch.equal(got, want):
            raise AssertionError(f"fast_corners_pyramid (8 levels, one launch) differs at {tuple(lv.shape)}")
    log("fast_corners_pyramid, 8 levels in one launch: equal (tolerance 0, torch.equal)")
    tum_got = fast_kernel.fast_corners_pyramid(tum_levels, TH_HI, TH_LO, CELL, BORDER)
    for lv, got in zip(tum_levels, tum_got):
        if not torch.equal(got, fast.fast_corners_plain(lv, TH_HI, TH_LO, CELL, BORDER)):
            raise AssertionError(f"fast_corners_pyramid (8 levels of 640x480, one launch) differs at {tuple(lv.shape)}")
    log("fast_corners_pyramid, the 8 levels of a 640x480 frame in one launch: equal (tolerance 0, torch.equal)")

    flush = torch.empty(128 * 1024 * 1024 // 4, device=dev)  # 128 MB > the 50 MB L2
    pixels = sum(h * w for h, w in shapes)
    candidates = sum(int(fast.quick_test_candidates(lv, min(TH_HI, TH_LO)).sum()) for lv in levels)
    log(f"one frame: {pixels} pixels in 8 levels, {candidates} pass the quick test "
        f"({candidates / pixels:.4f}); an empty pair of events reads "
        f"{device_median_ms(lambda: None):.4f} ms")
    rows = []
    # Calls in one pair of events for the warm time: 10 launches, or 4 frames
    # of 8 launches, so that all pairs fit in the launch queue.
    for name, kern, plain, inner in (("fast_corners_pyramid", pyramid_kernel, pyramid_plain, 10),
                                     ("fast_score_pair", pair_kernel, pair_plain, 4)):
        bound_ms, bound_by = kernel_bound(name, pixels, candidates)
        warm = device_median_ms(kern, inner=inner)
        cold = device_median_ms(kern, before=flush.zero_)
        called = cuda_median_ms(kern)
        plain_ms = cuda_median_ms(plain)
        log(f"{name} per frame: device {warm:.4f} ms warm L2 ({inner} calls a pair of events), "
            f"{cold:.4f} ms cold L2 (1 call a pair); as called {called:.4f} ms; plain {plain_ms:.4f} ms; "
            f"bound {bound_ms:.5f} ms by {bound_by}; share of bound reached {bound_ms / warm:.3f} warm, "
            f"{bound_ms / cold:.3f} cold; library call: none (no PyTorch call computes FAST-9)")
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": "orb_slam_cuda_tpu/ops/pallas_fast.py:116",
            "max_abs_err": max_err[name], "ms": warm, "cold_l2_ms": cold, "as_called_ms": called,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    return rows


def check_against_cpu(frame0):
    """The CUDA extractor agrees with the port's CPU path on one frame."""
    import torch

    from orb_slam_cuda_tpu_torch.frontend.extractor import ExtractorConfig, ORBExtractor

    cfg = ExtractorConfig(n_features=2000)
    gpu = ORBExtractor(cfg, HEIGHT, WIDTH)(frame0)  # no device: the card is the default
    cpu = ORBExtractor(cfg, HEIGHT, WIDTH, device="cpu")(frame0)
    lvl0 = (cpu.octave == 0) & cpu.valid
    same_kp = torch.equal(gpu.uv.cpu()[lvl0], cpu.uv[lvl0]) and torch.equal(gpu.valid.cpu(), cpu.valid)
    rows = (gpu.desc.cpu() == cpu.desc).all(1)[cpu.valid].float().mean().item()
    if not same_kp or rows < 0.95:
        raise AssertionError(f"CUDA extractor vs CPU: level-0 keypoints equal={same_kp}, identical rows {rows:.4f}")
    log(f"extractor cuda vs cpu: level-0 keypoints equal, identical descriptor rows {rows:.4f}")


def device_event_names(fn) -> list:
    """The names of the kernels, copies and memsets that one call of `fn`
    puts on the card (torch.profiler over host and device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not names:
        raise AssertionError("torch.profiler recorded no device event")
    return names


def bracketed_device_event_names(fn) -> list:
    """The names of the device events that one call of `fn` puts on the
    card between two one-element fills, in a profile over host and device.
    A profile of a lone short call can record no device event at all; the
    fills around it show whether the window was recorded, and a profile
    that lost them is taken again, three times at most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda")
            fn()
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        if len(names) >= 2 and "FillFunctor" in names[0] and "FillFunctor" in names[-1]:
            return names[1:-1]
        log(f"torch.profiler lost the window's device events ({names}); profiling again")
    raise AssertionError("torch.profiler recorded no bracketed device events")


def count_device_launches(fn) -> int:
    """Kernels, copies and memsets that one call of `fn` puts on the card."""
    return len(device_event_names(fn))


def phase_extract_launches(frame0):
    """Device launches of one extraction, and of the ops that the one
    kernel launch replaced: per level the raw-pair launch, two NMS, the
    cell choice and the border mask."""
    import torch

    from orb_slam_cuda_tpu_torch.frontend import fast, image_ops
    from orb_slam_cuda_tpu_torch.frontend.extractor import ExtractorConfig, ORBExtractor
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    extractor = ORBExtractor(ExtractorConfig(n_features=2000), HEIGHT, WIDTH)
    img = torch.as_tensor(frame0, device="cuda")
    levels = [lv.contiguous() for lv in image_ops.build_pyramid(img, 8, 1.2)]

    def unfused():
        for lv in levels:
            hi, lo = fast_kernel.fast_score_pair(lv, TH_HI, TH_LO)
            fast.border_mask(fast.two_threshold_cell_select(fast.nms3x3(hi), fast.nms3x3(lo), CELL), BORDER)

    total = count_device_launches(lambda: extractor(img))
    fused = count_device_launches(lambda: fast_kernel.fast_corners_pyramid(levels, TH_HI, TH_LO, CELL, BORDER))
    replaced = count_device_launches(unfused)
    log(f"device launches per extraction: {total}, of them {fused} for the corner maps of all 8 levels; "
        f"the raw pair per level with plain NMS, cell choice and border mask takes {replaced}")
    log(f"corner maps of a frame as the caller sees them (CUDA events around the calls, median of 20): "
        f"{cuda_median_ms(lambda: fast_kernel.fast_corners_pyramid(levels, TH_HI, TH_LO, CELL, BORDER)):.4f} ms "
        f"in one launch, {cuda_median_ms(unfused):.4f} ms as the raw pair per level with the plain ops; "
        f"one extraction {cuda_median_ms(lambda: extractor(img)):.4f} ms")


def phase_vocabulary(device="cuda", depth_l=VOCAB_DEPTH):
    """A vocabulary of the stock ORBvoc.txt's size, through the port's
    loader: generate the text once, build the native scanner, load the
    file with `load_orbvoc_text` (which reports its parse and assemble
    seconds), move the result to the card. (A CPU device and a smaller
    depth are the tests' rehearsal.)"""
    import torch

    from orb_slam_cuda_tpu_torch.vocab import load_orbvoc_text, native_loader, stock_scale

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    path = os.path.join(build_dir, f"orbvoc_k{VOCAB_K}_L{depth_l}.txt")
    if os.path.exists(path):
        log(f"vocabulary: reusing {path}")
    else:
        tmp = path + ".tmp"
        seconds = stock_scale.generate(tmp, depth=depth_l, k=VOCAB_K)
        os.replace(tmp, path)
        log(f"vocabulary: generated {path} in {seconds:.1f} s")
    t0 = time.perf_counter()
    lib = native_loader.build()  # the loader would build it at first use: apart here for its time
    t1 = time.perf_counter()
    steps = {}
    voc = load_orbvoc_text(path, timings=steps)
    t2 = time.perf_counter()
    voc = voc.to(device)
    _synchronize(device)
    t3 = time.perf_counter()
    tensors = (*voc.children_packed, *voc.children_valid, *voc.child_base, *voc.node_word, voc.word_weight)
    n_bytes = sum(t.numel() * t.element_size() for t in tensors)
    if not all(t.device.type == torch.device(device).type for t in tensors):
        raise AssertionError(f"vocabulary tensors are not on {device}")
    want_words = 0.98 * VOCAB_K ** depth_l  # 2% of the bottom subtrees are early leaves
    if not (voc.k == VOCAB_K and voc.depth == depth_l and abs(voc.n_words - want_words) < 0.01 * want_words):
        raise AssertionError(f"vocabulary: k {voc.k}, depth {voc.depth}, {voc.n_words} words")
    log(f"vocabulary: {os.path.getsize(path) / 1e6:.1f} MB of text, {steps['nodes']} nodes, {voc.n_words} words, "
        f"k {voc.k}, depth {voc.depth}, levelsup depth {voc.levelsup_depth}; native scanner built in {t1 - t0:.2f} s "
        f"({os.path.basename(lib)}), load_orbvoc_text {t2 - t1:.2f} s (parse {steps['parse']:.2f} s, assemble "
        f"{steps['assemble']:.2f} s), to the card {t3 - t2:.2f} s; {n_bytes / 1e6:.1f} MB on the card")
    return voc


def orbit_config(cam, lag=PIPELINE_LAG):
    """bench.py's SystemConfig (bench.py:99-110) without its TPU switch."""
    from orb_slam_cuda_tpu_torch.engine import Sensor, SystemConfig

    return SystemConfig(
        camera=cam, sensor=Sensor.MONOCULAR, n_features=2000, max_keyframes=128,
        max_points=16384, enable_loop_closing=True, max_frames_between_kf=10,
        min_frames_between_kf=4, pipeline_lag=lag,
    )


def program_summary(name, slam) -> int:
    """Print the System's programs, per-frame and keyframe (captures,
    replays, capture seconds each), the shared graph pool and the peak
    memory reserved since the last reset. Returns the calls of the
    frame-stage programs."""
    import torch

    st = slam.program_stats()
    progs = {k: v for k, v in st.items() if k != "pool_bytes"}
    used = [f"{k} {v['captures']} + {v['replays']} ({v['capture_s']:.2f} s)" for k, v in progs.items()
            if v["captures"] or v["replays"]]
    peak = torch.cuda.max_memory_reserved() if slam.device.type == "cuda" else 0
    log(f"{name} programs (captures + replays): {', '.join(used) or 'none'}; "
        f"{sum(v['captures'] for v in progs.values())} captures in "
        f"{sum(v['capture_s'] for v in progs.values()):.2f} s, {sum(v['replays'] for v in progs.values())} "
        f"replays; tracked frames {slam.stats.n_tracked}; graph pool {st['pool_bytes'] / 1e6:.1f} MB, "
        f"peak reserved {peak / 1e6:.1f} MB")
    return sum(v["captures"] + v["replays"] for k, v in progs.items() if k in FRAME_PROGRAMS)


def reset_peak(device):
    """Start a path's peak-memory count from what it holds itself: the
    blocks earlier paths left cached are released first."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def build_frame_ms(extractor, cam, vocab, frames) -> float:
    """Mean host time of `build_frame` (synchronized) over `frames`."""
    import torch

    from orb_slam_cuda_tpu_torch.engine.frame import build_frame

    feats = [extractor(img) for img in frames]
    build_frame(feats[0], cam, vocab)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in feats:
        build_frame(f, cam, vocab)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(feats)


def check_step_syncs_nothing(slam, image):
    """Queue one more pipelined step (its image a host array, as on the
    main path) under torch.cuda.set_sync_debug_mode("error"), which raises
    at any op that waits for the card. The System's state is not changed."""
    import torch

    if slam._carry is None:
        slam._carry = slam._make_carry()
    min_obs = 3 if len(slam.kf_order) > 2 else 2
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, res, _, host, copied = slam._dispatch_pipelined(image, min_obs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    copied.synchronize()
    if not bool(torch.isfinite(host).all()):
        raise AssertionError(f"pipelined step under sync debug mode gave {host.tolist()}")
    log(f"one pipelined step ran under set_sync_debug_mode('error') without a sync; "
        f"its host vector: ok {int(host[0])}, inliers {int(host[1])}")


def phase_main_path(cam, poses, frames, device=None, vocab=None):
    """Track the fixture at bench.py's configuration and check every gate.
    With no `device` the System is built without one and must land on the
    card. On a CPU device (the tests' rehearsal) the FAST wrapper takes its
    plain version, so the kernel count must stay 0. `vocab` is the
    vocabulary to track on; with none the System trains its 512-word
    synthetic one. Returns (launches, the System)."""
    import numpy as np
    import torch

    from orb_slam_cuda_tpu_torch.engine import System
    from orb_slam_cuda_tpu_torch.ops import fast_kernel
    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    cfg = orbit_config(cam)
    slam = System(cfg, vocab=vocab) if device is None else System(cfg, vocab=vocab, device=device)
    on_gpu = slam.device.type == "cuda"
    if device is None and not on_gpu:
        raise AssertionError(f"System(cfg) landed on {slam.device}, not on the card")
    # As a camera hands them over: host arrays, uploaded by the System.
    host_frames = [f.cpu().numpy() if torch.is_tensor(f) else np.asarray(f) for f in frames]
    if vocab is not None and on_gpu:
        from orb_slam_cuda_tpu_torch.engine.system import synthetic_vocabulary

        small = synthetic_vocabulary(cfg.vocab_words).to(slam.device)
        some = host_frames[:BUILD_FRAME_FRAMES]
        log(f"build_frame over {len(some)} frames: {build_frame_ms(slam.extractor, cam, vocab, some):.2f} ms "
            f"on the {vocab.n_words}-word vocabulary, {build_frame_ms(slam.extractor, cam, small, some):.2f} ms "
            f"on the {small.n_words}-word synthetic one")
    frame_ms = []
    reset_peak(slam.device)
    reset_launches()  # count this path's launches only
    t_all = time.perf_counter()
    for i, img in enumerate(host_frames):
        t0 = time.perf_counter()
        slam.track_monocular(img, i * 0.1)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    status = slam.get_status()  # retires the frames still in flight
    _synchronize(slam.device)
    flush_ms = (time.perf_counter() - t0) * 1e3
    total_s = time.perf_counter() - t_all
    launches = fast_kernel.launches
    dlt = note_launches("orbit")
    dispatches = mapping_dispatches(slam)

    ts, est = camera_centers(slam.get_trajectory())
    gt_by_t = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    gt = np.asarray([gt_by_t[round(t, 6)] for t in ts])
    ate = ate_rmse(est, gt) if len(est) >= 3 else float("inf")
    window = np.asarray(frame_ms[MEASURE_FROM:])
    fps = len(window) / ((window.sum() + flush_ms) / 1e3)
    p50, p99 = np.percentile(window, [50, 99])
    st = slam.state
    off_device = [f for f in st._fields if getattr(st, f).device.type != slam.device.type]
    n = len(frame_ms)
    log(f"main path (pipeline_lag {cfg.pipeline_lag}, loop closing on): {n} frames in {total_s:.1f} s; "
        f"{status}; tracked_ratio {slam.tracked_ratio():.4f}, keyframes {slam.stats.n_keyframes} "
        f"(live {len(slam.kf_order)}), points {int(st.mp_valid.sum())}, lost {slam.stats.n_lost}, "
        f"relocalized {slam.stats.n_reloc}, ATE {ate:.4f} m, fast launches {launches}, dlt launches {dlt} "
        f"({dispatches} keyframes dispatched to the mapper)")
    log(f"frames {MEASURE_FROM}-{n - 1}: {fps:.2f} fps (the final flush of {flush_ms:.2f} ms included), "
        f"p50 {p50:.2f} ms, p99 {p99:.2f} ms, max {window.max():.2f} ms")
    for csv in ("times.csv", "timesTracking.csv"):
        log(f"stage means {csv}, frames {MEASURE_FROM}-{n - 1}: "
            + stage_means(slam.timer.rows[csv], MEASURE_FROM))
    # Keyframe work is rare and may fall before the window: time it over
    # the whole run, and list each call with its frame.
    mapping = slam.timer.rows["timesMapping.csv"]
    log(f"stage means timesMapping.csv, frames 0-{n - 1}: " + stage_means(mapping, 0))
    for frame, name, _, ns in mapping:
        log(f"mapping stage {name} at frame {frame}: {ns / 1e6:.2f} ms "
            f"(that frame took {frame_ms[frame] if frame < n else float('nan'):.2f} ms)")
    program_calls = program_summary("main path", slam)
    pose = slam.last_pose
    want_launches = n if on_gpu else 0  # one launch a frame
    check_gates("main path", {
        f"frame-stage program calls == {want_launches}": program_calls == want_launches,
        "tracked_ratio >= 0.85": slam.tracked_ratio() >= 0.85,
        f"keyframes >= {MIN_KEYFRAMES}": slam.stats.n_keyframes >= MIN_KEYFRAMES,
        "tracking never failed (lost 0, relocalized 0)": slam.stats.n_lost == 0 and slam.stats.n_reloc == 0,
        f"fast launches == {want_launches}": launches == want_launches,
        "dlt launched (the initializer triangulates)": dlt["dlt"] > 0 or not on_gpu,
        f"gated dlt launched ({dispatches} keyframes dispatched)": dlt["gated"] > 0 or not on_gpu or dispatches == 0,
        f"segsum launched ({dispatches} keyframes dispatched)": dlt["segsum"] > 0 or not on_gpu or dispatches == 0,
        f"map tensors on {slam.device} (off: {off_device})": not off_device,
        f"ATE <= {ATE_GATE}": ate <= ATE_GATE,
        "last pose finite": pose is not None and bool(np.isfinite(pose).all()),
    })
    if on_gpu:  # after the launches are read: this step is not the path's
        check_step_syncs_nothing(slam, host_frames[-1])
    return launches, slam


def _host_vector_log(slam) -> list:
    """Wrap the System's lag-0 tracking program so that every frame's host
    vector is kept, as bytes."""
    vecs, program = [], slam._track_fn

    def track(*args):
        res = program(*args)
        vecs.append(res.host_vec.cpu().numpy().tobytes())
        return res

    slam._track_fn = track
    return vecs


def graphed_against_eager(name, make, track, frames, dt, want_launches, profiled=0):
    """The same frames through two new Systems (`make()`), first under
    programs.eager(), then with the per-frame programs replayed as CUDA
    graphs; print each run and check the gates of phase 5c. With
    `profiled` > 0 the last that many frames run under torch.profiler
    (host API launches and device kernels a frame) and the host time a
    frame is over the others. Returns each run's numbers."""
    import contextlib

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orb_slam_cuda_tpu_torch.engine import programs
    from orb_slam_cuda_tpu_torch.ops import dlt_kernel, fast_kernel, segsum

    runs = {}
    timed = len(frames) - profiled
    for mode in ("eager", "graphed"):
        slam = make()
        vecs = _host_vector_log(slam)
        reset_peak(slam.device)
        reset_launches()
        frame_ms = []
        with programs.eager() if mode == "eager" else contextlib.nullcontext():
            for i, frame in enumerate(frames[:timed]):
                t0 = time.perf_counter()
                track(slam, frame, i * dt)
                frame_ms.append((time.perf_counter() - t0) * 1e3)
            profiled_line = ""
            if profiled:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for i in range(timed, len(frames)):
                        track(slam, frames[i], i * dt)
                    torch.cuda.synchronize()
                events = prof.events()
                host_launches = sum(e.device_type == DeviceType.CPU and e.name in LAUNCH_APIS for e in events)
                kernels = sum(e.device_type == DeviceType.CUDA for e in events)
                profiled_line = (f"; frames {timed}-{len(frames) - 1} (torch.profiler): {host_launches / profiled:.1f} "
                                 f"host API launches and {kernels / profiled:.1f} device kernels a frame")
            traj = [(ts, None if T is None else np.asarray(T).tobytes(), ok) for ts, T, ok in slam.get_trajectory()]
        torch.cuda.synchronize()
        ms = np.asarray(frame_ms)
        p50, p99 = np.percentile(ms, [50, 99])
        log(f"programs, {name}, {mode}: {len(frames)} frames, tracked {slam.tracked_ratio():.4f}, keyframes "
            f"{slam.stats.n_keyframes}; frames 0-{timed - 1}: host {ms.mean():.2f} ms a frame "
            f"({1e3 / ms.mean():.2f} fps), p50 {p50:.2f}, p99 {p99:.2f} ms{profiled_line}; "
            f"fast launches {fast_kernel.launches}, dlt launches {dlt_kernel.launches}, gated dlt launches "
            f"{dlt_kernel.gated.launches}, segsum launches {segsum.launches}")
        calls = program_summary(f"programs, {name}, {mode},", slam)
        stats = slam.program_stats()
        keyframe_programs = {k: v for k, v in stats.items() if k in KEYFRAME_PROGRAMS}
        runs[mode] = dict(vecs=vecs, traj=traj, launches=fast_kernel.launches, calls=calls,
                          dlt=(dlt_kernel.launches, dlt_kernel.gated.launches), segsum=segsum.launches,
                          dispatches=mapping_dispatches(slam),
                          policy_keyframes=slam.stats.n_keyframes - (1 if slam.cfg.sensor.value else 2),
                          kf_calls=sum(v["captures"] + v["replays"] for v in keyframe_programs.values()),
                          kf_replays=sum(v["replays"] for v in keyframe_programs.values()),
                          captured=sum(v["captures"] + v["replays"] for k, v in stats.items() if k != "pool_bytes"),
                          track_replays=stats["track"]["replays"], host_ms=float(ms.mean()), p50_ms=float(p50),
                          p99_ms=float(p99), programs=stats, line=profiled_line)
    e, g = runs["eager"], runs["graphed"]
    gates = {
        f"host vectors byte-equal ({len(g['vecs'])} frames)": e["vecs"] == g["vecs"] and len(g["vecs"]) > 0,
        "trajectories byte-equal": e["traj"] == g["traj"],
        f"fast launches == {want_launches} in each run": e["launches"] == g["launches"] == want_launches,
        f"dlt launches equal in both runs ({e['dlt']}, {g['dlt']})": e["dlt"] == g["dlt"],
        "no capture or replay under programs.eager()": e["captured"] == 0,
        f"graphed: frame-stage program calls == {len(frames)}": g["calls"] == len(frames),
        "graphed: the tracking program replayed": g["track_replays"] > 0,
        f"graphed: {g['dispatches']} keyframes dispatched to the mapper, each as a program call":
            g["programs"]["map_dispatch"]["captures"] + g["programs"]["map_dispatch"]["replays"] == g["dispatches"],
    }
    if g["policy_keyframes"] > 0:  # the mapper triangulated
        gates["gated dlt launched"] = g["dlt"][1] > 0
    if g["dispatches"] > 0:  # the mapper's local BA summed
        gates["segsum launched in each run"] = e["segsum"] > 0 and g["segsum"] > 0
    if g["policy_keyframes"] > 1:  # the keyframe programs were called again with a captured key
        gates[f"graphed: keyframe programs replayed ({g['policy_keyframes']} keyframes inserted by the "
              f"policy)"] = g["kf_replays"] > 0
    if g["dispatches"] > 1:  # a later keyframe replays the dispatch on its own slot, points and probation
        dispatch = g["programs"]["map_dispatch"]
        gates[f"graphed: the mapper's dispatch replayed ({dispatch['captures']} + {dispatch['replays']} for "
              f"{g['dispatches']} keyframes), byte-equal to eager above"] = dispatch["replays"] > 0
    check_gates(f"programs, {name}", gates)
    return {mode: {k: v for k, v in r.items() if k not in ("vecs", "traj")} for mode, r in runs.items()}


def depth_programs_against_eager(rgbd, profiled=0) -> dict:
    """The first PROGRAM_FRAMES stereo pairs and RGB-D frames (`rgbd`, the
    RGB-D fixture), each graphed against eager; `profiled` as in
    `graphed_against_eager`."""
    from orb_slam_cuda_tpu_torch.engine import Sensor

    s_cam, _, pairs = make_stereo_fixture("cuda", PROGRAM_FRAMES)
    r_cam, _, r_frames = rgbd
    return {
        "stereo": graphed_against_eager(
            "stereo", lambda: build_system(circuit_config(s_cam, Sensor.STEREO), None),
            lambda s, pair, t: s.track_stereo(pair[0], pair[1], t), pairs, 0.1, 2 * PROGRAM_FRAMES, profiled),
        "rgbd": graphed_against_eager(
            "rgbd", lambda: build_system(rgbd_config(r_cam), None), _track_rgbd, r_frames[:PROGRAM_FRAMES],
            RGBD_DT, PROGRAM_FRAMES, profiled),
    }


def phase_programs(cam, frames, vocab, rgbd):
    """Phase 5c: bench.py's orbit at lag 0, the first PROGRAM_FRAMES stereo
    pairs and RGB-D frames, each graphed against eager."""
    import numpy as np
    import torch

    from orb_slam_cuda_tpu_torch.engine import System

    host_frames = [f.cpu().numpy() if torch.is_tensor(f) else np.asarray(f) for f in frames]
    graphed_against_eager("orbit at lag 0", lambda: System(orbit_config(cam, lag=0), vocab=vocab),
                          lambda s, img, t: s.track_monocular(img, t), host_frames, 0.1, len(host_frames))
    depth_programs_against_eager(rgbd)


def ring_pose_graph(n: int, device):
    """An essential graph of `n` keyframes on a circle: the chain, edges
    to the second and third neighbours, and a loop edge from the last to
    the first whose measurement carries a 5% scale and 0.05 rad drift."""
    import math

    import torch

    from orb_slam_cuda_tpu_torch.geometry import se3
    from orb_slam_cuda_tpu_torch.solvers import pose_graph

    g = torch.Generator().manual_seed(11)
    ang = torch.arange(n, dtype=torch.float64) * (2 * math.pi / n)
    xi = torch.zeros((n, 6), dtype=torch.float64)
    xi[:, 0], xi[:, 2], xi[:, 4] = 20 * torch.cos(ang), 20 * torch.sin(ang), ang
    T = se3.exp(xi.float())
    R, t, s = T[:, :3, :3], T[:, :3, 3], torch.ones(n)
    ei = torch.cat([torch.arange(n - k) for k in (1, 2, 3)] + [torch.tensor([0])])
    ej = torch.cat([torch.arange(k, n) for k in (1, 2, 3)] + [torch.tensor([n - 1])])
    mR, mt, ms = pose_graph.relative_sim3((R[ei], t[ei], s[ei]), (R[ej], t[ej], s[ej]))
    drift = se3.exp(torch.tensor([[0.3, 0.0, 0.2, 0.0, 0.05, 0.0]]))[0]
    mR[-1], mt[-1], ms[-1] = drift[:3, :3] @ mR[-1], mt[-1] + drift[:3, 3], ms[-1] * 1.05
    noise = torch.randn((n, 3), generator=g) * 0.05
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[0] = True
    problem = pose_graph.PoseGraphProblem(
        vert_R=R, vert_t=t + noise, vert_s=s, vert_fixed=fixed, edge_i=ei, edge_j=ej,
        meas_R=mR, meas_t=mt, meas_s=ms, edge_valid=torch.ones(ei.shape, dtype=torch.bool))
    return pose_graph.PoseGraphProblem(*(x.to(device) for x in problem))


def padded_ring(device):
    """`ring_pose_graph`'s ring with its edge list padded as the loop closer
    pads one (`loop_closing.pad_edges`: 763 edges to 1,024; the padding
    (0, 0) edges with the identity as their measurement, not valid)."""
    import torch

    from orb_slam_cuda_tpu_torch.engine import loop_closing
    from orb_slam_cuda_tpu_torch.geometry import sim3

    p = ring_pose_graph(RING_KEYFRAMES, device)
    ei, ej, valid = loop_closing.pad_edges(p.edge_i, p.edge_j, RING_KEYFRAMES)
    eye_R, eye_t, eye_s = sim3.identity((ei.shape[0] - p.edge_i.shape[0],), device=device)
    return p._replace(edge_i=ei, edge_j=ej, meas_R=torch.cat([p.meas_R, eye_R]), meas_t=torch.cat([p.meas_t, eye_t]),
                      meas_s=torch.cat([p.meas_s, eye_s]), edge_valid=valid)


def pose_graph_args(p):
    """The edge-linearization kernel's arguments for a PoseGraphProblem at
    its vertices' poses, as optimize_pose_graph's first step makes them."""
    return (p.vert_R.contiguous(), p.vert_t.contiguous(), p.vert_s.contiguous(), p.edge_i.long().contiguous(),
            p.edge_j.long().contiguous(), p.meas_R.contiguous(), p.meas_t.contiguous(), p.meas_s.contiguous(),
            p.edge_valid.bool().contiguous())


def pose_graph_against_plain(out, want, flags_plain, valid) -> dict:
    """The kernel's (r, Ji, Jj, flags) against its plain version's (r, Ji,
    Jj) and `branch_flags_plain`: the errors, and the gates (POSE_GRAPH_*
    tolerances; padded edges zeros; everything finite)."""
    import torch

    r, Ji, Jj, flags = out
    pr, pJi, pJj = want
    ulp = torch.abs(torch.nextafter(pr, torch.full_like(pr, float("inf"))) - pr)
    r_err = torch.abs(r - pr)
    j_rel = max(float((torch.abs(a - b) / torch.clamp(b.abs().amax(dim=(1, 2), keepdim=True), min=1.0)).max())
                for a, b in ((Ji, pJi), (Jj, pJj)))
    pad = ~valid
    return {
        "max_abs_err": max(_max_abs(a, b) for a, b in zip((r, Ji, Jj), want)),
        "r_max_ulps": float((r_err / ulp).max()), "j_max_rel": j_rel,
        "flags_parted": int((flags != flags_plain).sum()),
        "gates": {
            f"r within one float32 ulp or {POSE_GRAPH_R_ABS}":
                bool((r_err <= torch.clamp(ulp, min=POSE_GRAPH_R_ABS)).all()),
            f"Ji, Jj within {POSE_GRAPH_J_REL:.3g} of the edge's largest entry": j_rel <= POSE_GRAPH_J_REL,
            "branch flags equal": torch.equal(flags, flags_plain),
            "padded edges zeros": not (r[pad].any() or Ji[pad].any() or Jj[pad].any() or flags[pad].any()),
            "finite": all(bool(torch.isfinite(x).all()) for x in (r, Ji, Jj)),
        },
    }


def phase_pose_graph_launches() -> int:
    """The edge linearization's device launches a call (torch.profiler over
    host and device) on the padded ring, gated on one, the kernel. Before
    the vocabulary phase, as phase_sim3_launches."""
    from orb_slam_cuda_tpu_torch.ops import pose_graph_kernel

    launches0 = pose_graph_kernel.launches
    args = pose_graph_args(padded_ring("cuda"))
    names = device_event_names(lambda: pose_graph_kernel.launch(*args))
    pose_graph_kernel.launches = launches0  # the profile's launches are not a path's
    log(f"pose_graph_edges device launches a call (torch.profiler): {len(names)} {names}")
    check_gates("pose_graph_edges kernel", {"one device launch a linearization":
                                            len(names) == 1 and "pose_graph_edges_kernel" in names[0]})
    return len(names)


def phase_pose_graph_kernel(device_launches: int) -> dict:
    """The essential graph's edge linearization (csrc/pose_graph_edges.cu)
    on phase 5b's ring at full width (256 keyframes, 763 edges padded to
    the loop closer's bucket of 1,024) and on `branch_edges(POSE_GRAPH_SEED)`
    (residuals through every branch of sim3.log): on each, launched twice
    (torch.equal) and held against its plain version (the float64 chain
    through torch.func.jvp on the card) and `branch_flags_plain`, gated
    (`pose_graph_against_plain`); on the ring its device time warm and cold
    and as called, the plain version's time and the bound: the larger of
    the double operations the function needs on this run's edges (each
    edge's primal chain once and each direction's tangent chain, counted by
    the source's host build, `pose_graph_kernel.edge_ops`) at
    PEAK_FP64_OPS_PER_S and its bytes at PEAK_BYTES_PER_S. Library call: none (no one PyTorch call
    linearizes a Sim3 residual). Returns the kernel table's row (without
    `launches`)."""
    import torch

    from orb_slam_cuda_tpu_torch.ops import pose_graph_kernel as pk

    launches0 = pk.launches
    calls = {}
    for label, args in (("the padded ring", pose_graph_args(padded_ring("cuda"))),
                        ("the branch edges", pk.branch_edges(POSE_GRAPH_SEED, "cuda"))):
        out, again = pk.launch(*args), pk.launch(*args)
        rep = pose_graph_against_plain(out, pk.linearize_plain(*args), pk.branch_flags_plain(*args), args[-1])
        torch.cuda.synchronize()
        rep["gates"]["two launches torch.equal"] = all(torch.equal(a, b) for a, b in zip(out, again))
        k, e, n_valid = args[0].shape[0], args[3].shape[0], int(args[-1].sum())
        flags = out[3][args[-1]]
        branches = {name: int(((flags & bit) != 0).sum()) for name, bit in (
            ("log_small", pk.FLAG_LOG_SMALL), ("log_near_pi", pk.FLAG_LOG_NEAR_PI),
            ("cos_clamped", pk.FLAG_COS_CLAMPED), ("sigma_zero", pk.FLAG_SIGMA_ZERO),
            ("theta_zero", pk.FLAG_THETA_ZERO))}
        log(f"pose_graph_edges on {label}: K = {k}, {e} edges, {n_valid} valid; edges by branch {branches}; against "
            f"the plain version: r {rep['r_max_ulps']:.2f} float32 ulps at most, Ji and Jj {rep['j_max_rel']:.3e} of "
            f"the edge's largest entry, max abs {rep['max_abs_err']:.3e}, flags parted on {rep['flags_parted']}")
        check_gates(f"pose_graph_edges kernel, {label}", rep["gates"])
        calls[label] = dict(args=args, rep=rep, edges=e, valid=n_valid, vertices=k, branches=branches)
    ring = calls["the padded ring"]
    args = ring["args"]
    flush = torch.empty(128 * 1024 * 1024 // 4, device="cuda")  # 128 MB > the 50 MB L2
    warm = device_median_ms(lambda: pk.launch(*args), inner=10)
    cold = device_median_ms(lambda: pk.launch(*args), before=flush.zero_)
    called = cuda_median_ms(lambda: pk.linearize(*args))
    plain_ms = cuda_median_ms(lambda: pk.linearize_plain(*args), reps=5, warmup=1)
    pk.launches = launches0  # these launches are not a path's
    t0 = time.perf_counter()
    primal, tangent = pk.edge_ops(*args)
    ops_s = time.perf_counter() - t0
    ops = int(primal.sum() + tangent.sum())
    nbytes = ring["vertices"] * BYTES_PG_VERTEX + ring["edges"] * BYTES_PG_EDGE
    by_ops, by_bytes = ops / PEAK_FP64_OPS_PER_S * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")
    valid = args[-1].cpu()
    log(f"pose_graph_edges per call on the padded ring: device {warm:.4f} ms warm (10 calls a pair of events), "
        f"{cold:.4f} ms cold L2, as called {called:.4f} ms; plain version {plain_ms:.2f} ms as called; bound "
        f"{bound_ms:.6f} ms by {bound_by} ({ops} double operations: the primal chains {int(primal.sum())}, "
        f"{int(primal[valid].min())}-{int(primal[valid].max())} an edge, the tangent chains {int(tangent.sum())}, "
        f"{int(tangent[valid].min())}-{int(tangent[valid].max())} a direction, counted by the host build in "
        f"{ops_s:.1f} s: {by_ops:.6f} ms at {PEAK_FP64_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s; {nbytes} bytes: {by_bytes:.6f} ms); share {bound_ms / warm:.4f} warm; library call: none (no one "
        "PyTorch call linearizes a Sim3 residual)")
    return {"name": "pose_graph_edges", "route": "cuda", "source": POSE_GRAPH_SOURCE,
            "replaces": "orb_slam_cuda_tpu/solvers/pose_graph.py:88",
            "max_abs_err": max(c["rep"]["max_abs_err"] for c in calls.values()), "ms": warm, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, "cold_l2_ms": cold,
            "as_called_ms": called, "device_launches_a_call": device_launches, "edges": ring["edges"],
            "valid_edges": ring["valid"], "double_ops": ops, "primal_ops": int(primal.sum()), "bytes": nbytes,
            "checks": {label: dict(c["rep"], edges=c["edges"], valid=c["valid"], branches=c["branches"])
                       for label, c in calls.items()}}


def sim3_opt_against_plain(J, want) -> dict:
    """The Jacobian kernel's J against its plain version's: the largest
    error of a row (J[i]) over its largest entry, and the gates
    (SIM3_OPT_J_REL; NaN exactly where the plain version has NaN)."""
    import torch

    nan = torch.isnan(want)
    rows = ~nan.flatten(1).any(dim=1)
    scale = want[rows].abs().amax(dim=(1, 2), keepdim=True)
    err = torch.abs(J[rows] - want[rows])
    rel = float((err / torch.clamp(scale, min=1e-30)).max()) if bool(rows.any()) else 0.0
    return {
        "max_abs_err": _max_abs(J[rows], want[rows]), "j_max_rel": rel,
        "bits_parted": int((J[rows] != want[rows]).sum()),
        "gates": {
            f"J within {SIM3_OPT_J_REL:.3g} of the row's largest entry": bool((err <= SIM3_OPT_J_REL * scale).all()),
            "NaN where the plain version's is": torch.equal(torch.isnan(J), nan),
        },
    }


def sim3_opt_full_width_args(device):
    """The Jacobian kernel's arguments at full width: 2,000 pairs of
    `sim3_opt_kernel.synthetic_pairs`, a scaled estimate rotating 0.3 rad."""
    from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel

    return sim3_opt_kernel.synthetic_pairs(SIM3_OPT_SEED, SIM3_OPT_FULL_WIDTH, 0.3, 1.2, device)


def _sim3_opt_launches_worker(queue):
    """`bracketed_device_event_names` of one full-width Jacobian call, in a
    process of its own."""
    import traceback

    from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel

    try:
        args = sim3_opt_full_width_args("cuda")
        queue.put(bracketed_device_event_names(lambda: sim3_opt_kernel.launch(*args)))
    except BaseException:
        queue.put(traceback.format_exc())


def phase_sim3_opt_launches() -> int:
    """The Jacobian kernel's device launches a call (torch.profiler over host
    and device, the call between two fills) at full width, gated on one,
    the kernel. Before the vocabulary phase, as phase_sim3_launches, and in
    a process of its own: in this one, after the launch profiles above, such
    a profile recorded no device event."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_sim3_opt_launches_worker, args=(queue,))
    proc.start()
    try:
        names = queue.get(timeout=180)
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()
    if isinstance(names, str):
        raise AssertionError("sim3_opt_jacobian launch profile failed in its process:\n" + names)
    log(f"sim3_opt_jacobian device launches a call (torch.profiler, own process): {len(names)} {names}")
    check_gates("sim3_opt_jacobian kernel", {"one device launch a Jacobian":
                                             len(names) == 1 and "sim3_opt_jacobian_kernel" in names[0]})
    return len(names)


def sim3_opt_check(args, label: str) -> dict:
    """The Jacobian kernel launched twice on `args` (bit-equal) and held
    against its plain version (the float64 chain through torch.func.jvp on
    the card); gated and printed under `label`."""
    import torch

    from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel as sk

    launches0 = sk.launches
    J, again = sk.launch(*args), sk.launch(*args)
    rep = sim3_opt_against_plain(J, sk.jacobian_plain(*args))
    torch.cuda.synchronize()
    sk.launches = launches0  # the comparison's launches are not a path's
    rep["gates"]["two launches bit-equal"] = torch.equal(J.view(torch.int32), again.view(torch.int32))
    log(f"sim3_opt_jacobian on {label}: {args[1].shape[0]} pairs; against the plain version: J {rep['j_max_rel']:.3e} "
        f"of the row's largest entry at most, max abs {rep['max_abs_err']:.3e}, {rep['bits_parted']} entries not "
        "bit-equal")
    check_gates(f"sim3_opt_jacobian kernel, {label}", rep["gates"])
    return rep


def sim3_opt_times(args, label: str) -> dict:
    """The Jacobian kernel's device time on `args` warm and cold and as
    called, the plain version's, and the bound: the larger of this call's
    bytes at PEAK_BYTES_PER_S and the double operations the function needs
    on its inputs (the estimate's inverse once, each pair's primal chain
    once and each (pair, direction)'s tangent chain, counted by the
    source's host build, `sim3_opt_kernel.pair_ops`) at PEAK_FP64_OPS_PER_S.
    Library call: none (no one PyTorch call linearizes a Sim3
    reprojection)."""
    import torch

    from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel as sk

    launches0 = sk.launches
    flush = torch.empty(128 * 1024 * 1024 // 4, device="cuda")  # 128 MB > the 50 MB L2
    warm = device_median_ms(lambda: sk.launch(*args), inner=10)
    cold = device_median_ms(lambda: sk.launch(*args), before=flush.zero_)
    called = cuda_median_ms(lambda: sk.jacobian(*args))
    plain_ms = cuda_median_ms(lambda: sk.jacobian_plain(*args), reps=5, warmup=1)
    sk.launches = launches0  # these launches are not a path's
    pose, primal, tangent = sk.pair_ops(*args)
    m = args[1].shape[0]
    ops = int(pose.sum() + primal.sum() + tangent.sum())
    nbytes = BYTES_SIM3_OPT_POSE + m * BYTES_SIM3_OPT_PAIR
    by_ops, by_bytes = ops / PEAK_FP64_OPS_PER_S * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms, bound_by = max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes else "bytes")
    log(f"sim3_opt_jacobian per call on {label} ({m} pairs): device {warm:.4f} ms warm (10 calls a pair of events), "
        f"{cold:.4f} ms cold L2, as called {called:.4f} ms; plain version {plain_ms:.2f} ms as called; bound "
        f"{bound_ms:.6f} ms by {bound_by} ({ops} double operations: the estimate's {int(pose[0])} + "
        f"{int(pose[1:].sum())}, the pairs' primal chains {int(primal.sum())}, their tangent chains "
        f"{int(tangent.sum())}, counted by the host build: {by_ops:.6f} ms at {PEAK_FP64_OPS_PER_S / 1e12:.0f} "
        f"TFLOP/s; {nbytes} bytes: {by_bytes:.6f} ms); share {bound_ms / warm:.4f} warm; library call: none (no one "
        "PyTorch call linearizes a Sim3 reprojection)")
    return {"pairs": m, "ms": warm, "cold_l2_ms": cold, "as_called_ms": called, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "double_ops": ops, "bytes": nbytes}


def phase_sim3_opt_kernel(device_launches: int) -> dict:
    """OptimizeSim3's Jacobian (csrc/sim3_opt_jacobian.cu) at full width
    (2,000 pairs) and on 64 pairs of a scaled estimate rotating 2 rad, each
    with points clamped to depth 1e-6 or behind either camera and zero
    rows at their head (`sim3_opt_kernel.synthetic_pairs`): on each,
    launched twice (bit-equal) and held against its plain version; at
    full width its times and bound (`sim3_opt_times`). Returns the kernel
    table's row (without `launches`; phase_sim3_opt_real_call adds the loop
    path's real call)."""
    from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel as sk

    full = sim3_opt_full_width_args("cuda")
    checks = {"the full-width call": sim3_opt_check(full, "the full-width call"),
              "the special rows": sim3_opt_check(sk.synthetic_pairs(SIM3_OPT_SEED, 64, 2.0, 1.7, "cuda"),
                                                 "64 pairs at 2 rad, scale 1.7")}
    times = sim3_opt_times(full, "the full-width call")
    return {"name": "sim3_opt_jacobian", "route": "cuda", "source": SIM3_OPT_SOURCE,
            "replaces": "orb_slam_cuda_tpu/solvers/sim3_opt.py:101",
            "max_abs_err": max(c["max_abs_err"] for c in checks.values()), "library_ms": None,
            "device_launches_a_call": device_launches, "full_width": times,
            "checks": checks}


def phase_sim3_opt_real_call(row: dict, call) -> dict:
    """The Jacobian kernel on one real call of the loop path (`call`: the
    inputs of the last Jacobian of its last eager `sim3_refine`), checked
    and timed as at full width; the row's times and bound become this
    call's, the full-width call's stay under `full_width`."""
    if call is None:
        raise AssertionError("sim3_opt_jacobian: the loop path made no eager Sim3 refinement")
    check = sim3_opt_check(call, "the loop path's last eager refinement")
    real = sim3_opt_times(call, "the loop path's last eager refinement")
    row = dict(row, **real)
    row["checks"]["the loop path's real call"] = check
    row["max_abs_err"] = max(row["max_abs_err"], check["max_abs_err"])
    return row


class JacobianRecorder:
    """Keeps a copy of the inputs of the last OptimizeSim3 Jacobian computed
    outside a CUDA-graph capture (an eager `sim3_refine` call's), standing
    in for `sim3_opt_kernel.jacobian` while a path runs."""

    def __init__(self):
        from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel

        self.mod, self.fn, self.last = sim3_opt_kernel, sim3_opt_kernel.jacobian, None
        sim3_opt_kernel.jacobian = self

    def __call__(self, S, x1c, x2c, cam):
        import torch

        if not torch.cuda.is_current_stream_capturing():
            self.last = (tuple(a.clone() for a in S), x1c.clone(), x2c.clone(), cam)
        return self.fn(S, x1c, x2c, cam)

    def detach(self):
        self.mod.jacobian = self.fn


# The segment-sum kernel's calls timed in phases 5b and 6b (d), by name.
SEGSUM_CALLS = {}


@contextlib.contextmanager
def unmasked_plain_sums():
    """The solvers' float segment sums as they ran before the kernel: the
    unmasked index (a padded slot's ±0 addends in its camera's segment and
    clamped onto point or vertex 0) and torch.segment_reduce."""
    from orb_slam_cuda_tpu_torch.ops import segsum
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba
    from orb_slam_cuda_tpu_torch.solvers import pose_graph

    def index(n, idx, valid=None):
        return segsum.segment_index(n, idx)

    def plain(seg, vals):
        return segsum.segsum_plain(seg, vals) if vals.is_floating_point() else segsum.segsum(seg, vals)

    saved = [(m, a, getattr(m, a)) for m in (ba, pose_graph) for a in ("segment_index", "segsum")]
    for m in (ba, pose_graph):
        m.segment_index, m.segsum = index, plain
    try:
        yield
    finally:
        for m, a, v in saved:
            setattr(m, a, v)


def _bits_equal(a, b) -> bool:
    """torch.equal, with -0.0 apart from +0.0 for floats."""
    import torch

    if a.is_floating_point():
        return a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def ba_sum_calls(problem, cam):
    """The segment-sum calls of a BA's first normal equations, as the
    solve makes them: (Hcc's (seg, vals), K = 36; Hpp's, K = 9)."""
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba

    calls, real = [], ba.segsum

    def spy(seg, vals):
        if vals.is_floating_point():
            calls.append((seg, vals))
        return real(seg, vals)

    ba.segsum = spy
    try:
        ba.bundle_adjust(problem, cam, lm_iters=1, cg_iters=1)
    finally:
        ba.segsum = real
    hcc = next(c for c in calls if c[1].dim() == 3 and c[1].shape[1] == 6)
    hpp = next(c for c in calls if c[1].dim() == 3 and c[1].shape[1] == 3)
    return hcc, hpp


def segsum_call(label, seg, parent_idx, vals):
    """The segment-sum kernel on one real call (`seg`, `vals`): launched
    twice, held against its plain version, against segment_reduce on the
    unmasked index `parent_idx` (the sums before the kernel) and with the
    padding spread over trash segments of SEGSUM_TRASH addends, all bit for
    bit; the kernel that the source's rule picks for it, its device time
    warm and cold and as called, the bound, the ordered floor, the plain
    version's and the two library calls' times (each the one
    segment_reduce call, its input gathered beforehand). Gated; recorded
    in SEGSUM_CALLS[label]."""
    import math

    import torch

    from orb_slam_cuda_tpu_torch.ops import segsum

    launches0 = segsum.launches
    n, e, k = seg.n, vals.shape[0], math.prod(vals.shape[1:])
    parent = segsum.segment_index(n, parent_idx)
    invalid = seg.idx >= n
    n_trash = -(-int(invalid.sum()) // SEGSUM_TRASH)
    trash_key = torch.where(invalid, n + (torch.cumsum(invalid.long(), 0) - 1) // SEGSUM_TRASH, seg.idx)
    trash = segsum.segment_index(n + n_trash, trash_key)
    lib_in, trash_in = vals[parent.order], vals[trash.order]

    def kern():
        return segsum.launch(seg, vals)

    def library():
        return torch.segment_reduce(lib_in, "sum", lengths=parent.lengths, axis=0, unsafe=True)

    def library_trash():
        return torch.segment_reduce(trash_in, "sum", lengths=trash.lengths, axis=0, unsafe=True)

    out, again = kern(), kern()
    others = {"two launches": again, "plain version": segsum.segsum_plain(seg, vals),
              "segment_reduce, unmasked index": library(), "segment_reduce, trash segments": library_trash()[:n]}
    torch.cuda.synchronize()
    parted = [name for name, o in others.items() if not _bits_equal(out, o)]
    err = max(_max_abs(out, o) for o in others.values())
    flush = torch.empty(128 * 1024 * 1024 // 4, device=vals.device)  # 128 MB > the 50 MB L2
    warm = device_median_ms(kern, inner=10)
    cold = device_median_ms(kern, before=flush.zero_)
    called = cuda_median_ms(lambda: segsum.segsum(seg, vals))
    plain_ms = cuda_median_ms(lambda: segsum.segsum_plain(seg, vals))
    library_ms = device_median_ms(library, inner=3)
    trash_ms = device_median_ms(library_trash, inner=3)
    segsum.launches = launches0  # these launches are not a path's
    n_valid = int(seg.offsets[-1])
    nbytes = n_valid * (4 * k + 8) + (n + 1) * 8 + n * k * 4
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e3, n_valid * k / PEAK_FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")
    chain, parent_chain = int(seg.lengths.max()), int(parent.lengths.max())
    kernel, mhz = segsum.kernel_name(n, k), sm_clock_mhz()
    floor_ms = chain * FADD_CYCLES / (mhz * 1e6) * 1e3
    log(f"segsum on {label}: {e} slots, {n_valid} valid, {n} segments of K = {k} (longest valid segment "
        f"{chain} addends; {parent_chain} on the unmasked index); served by {kernel}; bit-equal to "
        + ", ".join(f"{name} {'yes' if name not in parted else 'NO'}" for name in others)
        + f"; device {warm:.4f} ms warm (10 calls a pair of events), {cold:.4f} ms cold L2, as called "
        f"{called:.4f} ms; bound {bound_ms:.6f} ms by {bound_by} ({nbytes} bytes; {n_valid * k} adds "
        f"{by_ops:.6f} ms); ordered floor {floor_ms:.6f} ms ({chain} adds x {FADD_CYCLES} cycles at {mhz:.0f} "
        f"MHz); share {bound_ms / warm:.4f} warm; plain version {plain_ms:.4f} ms as called; library "
        f"call (segment_reduce, device, warm) {library_ms:.4f} ms on the unmasked index, {trash_ms:.4f} ms with "
        f"the padding over {n_trash} trash segments of <= {SEGSUM_TRASH}")
    check_gates(f"segsum kernel, {label}", {f"bit-equal to {name}": name not in parted for name in others})
    SEGSUM_CALLS[label] = {"kernel": kernel, "slots": e, "valid": n_valid, "segments": n, "k": k,
                           "longest_segment": chain, "ordered_floor_ms": floor_ms,
                           "longest_segment_unmasked": parent_chain, "max_abs_err": err, "ms": warm,
                           "cold_l2_ms": cold, "as_called_ms": called, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "library_ms": library_ms, "library_trash_ms": trash_ms}


def phase_segsum_launches() -> int:
    """The segment sum's device launches a call (torch.profiler over host
    and device) at the local BA's shape (24 cameras x 2,000 slots, 2,139
    valid, K = 36), gated on one, of the kernel that the source's rule
    picks there. Before the vocabulary phase, as phase_sim3_launches."""
    import torch

    from orb_slam_cuda_tpu_torch.ops import segsum

    g = torch.Generator().manual_seed(36)
    e = 24 * 2000
    valid = torch.zeros(e, dtype=torch.bool)
    valid[torch.randperm(e, generator=g)[:2139]] = True
    idx = torch.arange(24).repeat_interleave(2000)
    vals = torch.where(valid[:, None, None], torch.randn((e, 6, 6), generator=g), torch.zeros(()))
    seg = segsum.segment_index(24, idx.cuda(), valid.cuda())
    vals = vals.cuda()
    launches0 = segsum.launches
    names = device_event_names(lambda: segsum.launch(seg, vals))
    segsum.launches = launches0  # the profile's launches are not a path's
    kernel = segsum.kernel_name(24, 36)
    log(f"segsum device launches a call (torch.profiler): {len(names)} {names}; the rule picks {kernel}")
    check_gates("segsum kernel", {f"one device launch a segment sum, {kernel}": len(names) == 1 and kernel in names[0]})
    return len(names)


def segsum_row(calls: dict, launches: int, device_launches: int) -> dict:
    """The kernel table's row: the local BA's Hcc call's numbers, every
    timed call inside; `device_launches` a call from phase 3."""
    head = calls["local BA Hcc (K=36)"]
    return {"name": "segsum", "route": "cuda", "source": SEGSUM_SOURCE,
            "replaces": "orb_slam_cuda_tpu/solvers/bundle_adjust.py:189", "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in calls.values()), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "cold_l2_ms": head["cold_l2_ms"], "as_called_ms": head["as_called_ms"],
            "device_launches_a_call": device_launches, "calls": calls}


def phase_repeatability(slam):
    """One local BA (the last keyframe's window of the orbit's final map,
    round 2's iterations) and one essential-graph solve (a drifted ring of
    RING_KEYFRAMES, the loop closer's 15 Gauss-Newton steps), each run
    twice eagerly (programs.eager()) and then as a program: its first call
    (eager, then the capture) and two replays of the graph. All four
    results must be torch.equal. Then each solved eagerly once more with
    its float sums on segment_reduce over the unmasked index: bit-equal to
    the kernel's; and the local BA's K = 36 and K = 9 calls timed
    (`segsum_call`)."""
    import torch

    from orb_slam_cuda_tpu_torch.engine import programs
    from orb_slam_cuda_tpu_torch.engine.local_mapping import gather_local_ba_problem
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba
    from orb_slam_cuda_tpu_torch.solvers import pose_graph

    m = slam.mapper
    problem, _, _ = gather_local_ba_problem(slam.state, slam.kf_order[-1], slam.cam, m.level_inv_sigma2,
                                            n_local=m.lba_local, n_fixed=m.lba_fixed, n_points=m.lba_points)
    graph = ring_pose_graph(RING_KEYFRAMES, slam.device)
    runs, unmasked = {}, {}
    for name, fn, arg in (("local BA", lambda p: ba.bundle_adjust(p, slam.cam, lm_iters=10, cg_iters=15), problem),
                          ("essential graph",
                           lambda g: pose_graph.optimize_pose_graph(g, gn_iters=POSE_GRAPH_GN_STEPS, cg_iters=30),
                           graph)):
        program = programs.Program(fn, f"repeatability {name}")
        ms, outs = [], []
        for mode in ("eager", "eager", "capture", "replay", "replay"):
            t0 = time.perf_counter()
            with programs.eager() if mode == "eager" else contextlib.nullcontext():
                outs.append(program(arg))
            _synchronize(slam.device)
            ms.append(f"{mode} {(time.perf_counter() - t0) * 1e3:.2f} ms")
        same = all(torch.equal(x, y) for out in outs[1:] for x, y in zip(outs[0], out))
        replayed = program.stats()["replays"] == 2
        runs[name] = same and replayed
        log(f"repeatability, {name}: two eager solves, the program's capture and two replays on the same inputs "
            f"{'torch.equal' if same else 'DIFFER'} (replays {program.stats()['replays']}); " + ", ".join(ms)
            + f" (the capture alone {program.stats()['capture_s'] * 1e3:.2f} ms)")
        t0 = time.perf_counter()
        with programs.eager(), unmasked_plain_sums():
            old = fn(arg)
        _synchronize(slam.device)
        unmasked[name] = all(_bits_equal(x, y) for x, y in zip(outs[0], old))
        log(f"segsum, {name}: the eager solve with its float sums on segment_reduce over the unmasked index "
            f"{(time.perf_counter() - t0) * 1e3:.2f} ms (through the kernel: {ms[0]}), bit-equal to the kernel's "
            f"{unmasked[name]}")
    log(f"repeatability: local BA of {int(problem.obs_valid.sum())} observations, "
        f"{int(problem.pt_valid.sum())} points, {problem.cam_pose.shape[0]} cameras; essential graph of "
        f"{RING_KEYFRAMES} keyframes and {graph.edge_i.shape[0]} edges")
    check_gates("repeatability", {f"{k} repeats bit for bit, eager and graphed": v for k, v in runs.items()})
    check_gates("segsum kernel", {f"{k} through the kernel bit-equal to segment_reduce on the unmasked index": v
                                  for k, v in unmasked.items()})
    if slam.device.type == "cuda":
        hcc, hpp = ba_sum_calls(problem, slam.cam)
        segsum_call("local BA Hcc (K=36)", hcc[0], torch.clamp(problem.obs_cam, min=0).long(), hcc[1])
        segsum_call("local BA Hpp (K=9)", hpp[0], torch.clamp(problem.obs_pt, min=0).long(), hpp[1])


def circuit_scene():
    """The scene and circuit of the KITTI accuracy configs (mono and
    stereo alike): a 12-wall room, apothem 36 m, with 40 billboards, and
    1.3 laps of radius 22 m in 340 frames."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.utils import synthetic

    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    scene = synthetic.room_scene(rng, half_size=36.0, tex_size=3072, n_walls=12)
    scene.planes.extend(synthetic.ring_obstacles(rng, 24, 28.0))
    scene.planes.extend(synthetic.ring_obstacles(rng, 16, 15.0, height=3.0, width=4.0))
    poses = synthetic.circuit_trajectory(LOOP_FRAMES, radius=22.0, laps=1.3)
    log(f"circuit scene: {len(scene.planes)} planes textured in {time.perf_counter() - t0:.1f} s")
    return scene, poses


def _synchronize(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_loop_fixture(device, views=()):
    """config_mono_kitti's scene and circuit on `device`, with
    BLANK_AT..BLANK_AT+2 blank. `views` are the circuit's first frames
    where the stereo fixture has rendered them already as its left images
    (the same scene, poses and camera matrix); the rest are rendered here."""
    import torch

    scene, poses = circuit_scene()
    t1 = time.perf_counter()
    cam = kitti_camera()
    frames = list(views)
    frames += [scene.render(cam.K, T, WIDTH, HEIGHT, device=device) for T in poses[len(frames):]]
    for i in range(BLANK_AT, BLANK_AT + 3):
        frames[i] = torch.zeros_like(frames[i])
    _synchronize(device)
    log(f"loop fixture: {LOOP_FRAMES} frames {WIDTH}x{HEIGHT}, {len(views)} of them taken from the stereo "
        f"fixture and {LOOP_FRAMES - len(views)} rendered, on {device} in "
        f"{time.perf_counter() - t1:.1f} s; frames {BLANK_AT}-{BLANK_AT + 2} blank")
    return cam, poses, frames


def make_stereo_fixture(device, n_frames=STEREO_FRAMES):
    """config_stereo_kitti: the first `n_frames` of the same scene and
    circuit as a rectified pair, the right camera 0.537 m along the left
    camera's x axis."""
    from orb_slam_cuda_tpu_torch.geometry.camera import Camera

    scene, poses = circuit_scene()
    poses = poses[:n_frames]
    t1 = time.perf_counter()
    cam = Camera.create(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=STEREO_BF,
                        width=WIDTH, height=HEIGHT)
    frames = [scene.render_stereo(cam.K, T, STEREO_BASELINE, WIDTH, HEIGHT, device=device) for T in poses]
    _synchronize(device)
    log(f"stereo fixture: {len(frames)} pairs {WIDTH}x{HEIGHT} rendered on {device} in "
        f"{time.perf_counter() - t1:.1f} s; baseline {STEREO_BASELINE} m, bf {STEREO_BF}")
    return cam, poses, frames


def make_rgbd_fixture(device, n_frames=RGBD_RUN):
    """config_rgbd_tum: an 8-wall room (apothem 4.5 m), 1.25 laps of radius
    1.8 m in 400 frames at 30 fps, 640x480, with the depth channel as the
    config's generator stores it: z * 5000 clipped to 16 bits and
    truncated, 0 where there is no surface (held as int32 here)."""
    import numpy as np
    import torch

    from orb_slam_cuda_tpu_torch.geometry.camera import Camera
    from orb_slam_cuda_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    scene = synthetic.room_scene(np.random.default_rng(5), half_size=4.5, tex_size=1024, n_walls=8)
    poses = synthetic.circuit_trajectory(RGBD_FRAMES, radius=1.8, laps=1.25)[:n_frames]
    cam = Camera.create(fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764, bf=40.0,
                        width=TUM_WIDTH, height=TUM_HEIGHT)
    frames = []
    for T in poses:
        img, z = scene.render_with_depth(cam.K, T, TUM_WIDTH, TUM_HEIGHT, device=device)
        frames.append((img, torch.clamp(z * DEPTH_FACTOR, 0, 65535).to(torch.int32)))
    _synchronize(device)
    log(f"rgbd fixture: {len(frames)} frames {TUM_WIDTH}x{TUM_HEIGHT} with depth rendered on {device} in "
        f"{time.perf_counter() - t0:.1f} s (of the config's {RGBD_FRAMES} frames)")
    return cam, poses, frames


def build_system(cfg, device):
    """`System(cfg)` with no device must land on the card; a CPU device is
    the tests' rehearsal."""
    from orb_slam_cuda_tpu_torch.engine import System

    slam = System(cfg) if device is None else System(cfg, device=device)
    if device is None and slam.device.type != "cuda":
        raise AssertionError(f"System(cfg) landed on {slam.device}, not on the card")
    slam.reloc_trace = []  # every relocalization candidate's outcome, for `summarize`
    return slam


def drive(slam, track, frames, dt):
    """Track every frame (`track(slam, frame, timestamp)`), with the kernel's
    launch count set to 0 just before and read just after. Returns the
    poses, the frame times in ms, the relocalization calls as (frame,
    accepting stage, tracked), the share of valid features with a depth per
    tracked frame, the seconds and the FAST launches (the DLT launches are
    left in dlt_kernel's counts)."""
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    poses, frame_ms, reloc_calls, depth_share = [], [], [], []
    reset_peak(slam.device)
    reset_launches()  # count this path's launches only
    t_all = time.perf_counter()
    for i, frame in enumerate(frames):
        before = dict(slam.reloc_stage_stats)
        t0 = time.perf_counter()
        pose = track(slam, frame, i * dt)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        poses.append(pose)
        stage = [k for k, v in slam.reloc_stage_stats.items() if v != before.get(k, 0)]
        if stage:
            reloc_calls.append((i, stage[0], pose is not None))
        lf = slam.last_frame
        if pose is not None and lf is not None:  # read outside the timed call
            depth_share.append(float(((lf.depth > 0) & lf.valid).sum()) / max(float(lf.valid.sum()), 1.0))
    total_s = time.perf_counter() - t_all
    return poses, frame_ms, reloc_calls, depth_share, total_s, fast_kernel.launches


def summarize(name, slam, gt_poses, dt, frame_ms, reloc_calls, total_s, launches, with_scale):
    """Print a path's outcome, timing, stage means, programs and every
    mapping, loop, global-BA and relocalization call with its frame.
    Returns (ATE, extent, estimated / true trajectory span, tensors not on
    the System's device, frame-stage program calls)."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    n = len(frame_ms)
    status = slam.get_status()
    ts, est = camera_centers(slam.get_trajectory())
    gt_by_t = {round(i * dt, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(gt_poses)}
    gt = np.asarray([gt_by_t[round(t, 6)] for t in ts])
    ate = ate_rmse(est, gt, with_scale=with_scale) if len(est) >= 3 else float("inf")
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0))) if len(gt) else 0.0
    span = float(np.linalg.norm(est.max(0) - est.min(0))) / max(extent, 1e-9) if len(est) else 0.0
    ms = np.asarray(frame_ms)
    p50, p99 = np.percentile(ms, [50, 99])
    st = slam.state
    off_device = [f for f in st._fields if getattr(st, f).device.type != slam.device.type]
    off_device += [f"db.{f}" for f in slam.db._fields if getattr(slam.db, f).device.type != slam.device.type]
    edges = slam.loop_closer.loop_edges if slam.loop_closer else []
    log(f"{name}: {n} frames in {total_s:.1f} s; {status}; keyframes live {len(slam.kf_order)}, "
        f"points {int(st.mp_valid.sum())}, lost {slam.stats.n_lost}, loop edges {edges}, "
        f"relocalization stages {slam.reloc_stage_stats}, ATE {'sim(3)' if with_scale else 'without scale'} "
        f"{ate:.4f} m of extent {extent:.2f} m ({100 * ate / max(extent, 1e-9):.3f}%), estimated / true span "
        f"{span:.4f}, fast launches {launches}")
    log(f"{name} frames 0-{n - 1}: {n / (ms.sum() / 1e3):.2f} fps, p50 {p50:.2f} ms, "
        f"p99 {p99:.2f} ms, max {ms.max():.2f} ms")
    for csv in ("times.csv", "timesTracking.csv", "timesMapping.csv"):
        log(f"stage means {csv}, frames 0-{n - 1}: " + stage_means(slam.timer.rows[csv], 0))
    program_calls = program_summary(name, slam)
    reloc_ms = {frame: ns / 1e6 for frame, stage, _, ns in slam.timer.rows["timesTracking.csv"]
                if stage == "relocalize"}
    refused = {}
    for row in slam.reloc_trace:
        rung = row.get("refused_at", "accepted")
        refused[rung] = refused.get(rung, 0) + 1
    log(f"{name}: {len(reloc_calls)} relocalization calls tried {len(slam.reloc_trace)} candidates; "
        f"accepted, or refused at the BoW match count, EPnP or the pose ladder: {refused}")
    for frame, stage, _ in reloc_calls:
        log(f"relocalize at frame {frame}: {reloc_ms.get(frame, float('nan')):.2f} ms, "
            f"{'accepted by stage ' + stage if stage != 'fail' else 'no candidate accepted'}")
    by_frame = {}
    for frame, stage, _, ns in slam.timer.rows["timesMapping.csv"]:
        by_frame.setdefault(frame, []).append(f"{stage} {ns / 1e6:.2f} ms")
    for frame in sorted(by_frame):
        log(f"mapping/loop/gba at frame {frame} ({frame_ms[frame]:.2f} ms): " + ", ".join(by_frame[frame]))
    return ate, extent, span, off_device, program_calls


def check_gates(name, checks):
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{name} gates failed: " + "; ".join(failed))
    log(f"{name}: all gates passed")


def circuit_config(cam, sensor, **kw):
    """The settings the KITTI accuracy configs run with (KITTI00-02.yaml,
    10 fps, the reference keyframe policy)."""
    from orb_slam_cuda_tpu_torch.engine import SystemConfig

    cfg = dict(camera=cam, sensor=sensor, n_features=2000, max_keyframes=256, max_points=32768,
               enable_loop_closing=True, max_frames_between_kf=10, min_frames_between_kf=0,
               async_mapping=True, pipeline_lag=0, th_depth_factor=TH_DEPTH_FACTOR)
    cfg.update(kw)
    return SystemConfig(**cfg)


def phase_loop_path(cam, poses, frames, device=None):
    """Track the circuit with loop closing on and check every gate. With no
    `device` the System is built without one and must land on the card."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.engine import Sensor

    slam = build_system(circuit_config(cam, Sensor.MONOCULAR), device)
    recorder = Sim3Recorder(slam.loop_closer)  # keeps one real Sim3 call's inputs for phase_sim3_kernel
    jacobians = JacobianRecorder()  # and one real Jacobian's for phase_sim3_opt_real_call
    try:
        _, frame_ms, reloc_calls, _, total_s, launches = drive(
            slam, lambda s, img, t: s.track_monocular(img, t), frames, 0.1)
    finally:
        recorder.detach()
        jacobians.detach()
    dlt = kernel_gates("loop path", slam)
    ate, extent, _, off_device, program_calls = summarize("loop path", slam, poses, 0.1, frame_ms, reloc_calls,
                                                          total_s, launches, with_scale=True)
    status = slam.get_status()
    ref = LOOP_REFERENCE
    log(f"loop path vs JAX reference (CPU, same frames): tracked {slam.tracked_ratio():.4f} vs "
        f"{ref['tracked']}, loops {status['loops_closed']} vs {ref['loops']}, relocalizations "
        f"{slam.stats.n_reloc} vs {ref['n_reloc']}, ATE {ate:.4f} vs {ref['ate']} m")
    pose = slam.last_pose
    want_launches = len(frames) if slam.device.type == "cuda" else 0  # one launch a frame
    gates = {
        f"frame-stage program calls == {want_launches}": program_calls == want_launches,
        "loops_closed >= 1": status["loops_closed"] >= 1,
        "n_reloc >= 1": slam.stats.n_reloc >= 1,
        "tracked_ratio >= 0.85": slam.tracked_ratio() >= 0.85,
        "keyframe culling live": len(slam.kf_order) < slam.stats.n_keyframes,
        "ATE <= 1% of extent": ate <= 0.01 * extent,
        f"fast launches == {want_launches}": launches == want_launches,
        f"map tensors on {slam.device} (off: {off_device})": not off_device,
        "last pose finite": pose is not None and bool(np.isfinite(pose).all()),
        **dlt,
    }
    check_gates("loop path", gates)
    return launches, slam, recorder.last_ok, jacobians.last


def sim3_against_plain(args, label: str):
    """The Sim3 kernel launched twice on `args` (torch.equal) and held
    against its plain version (float32 `eigh`) and against float64 Horn
    on the inliers it refitted on; gated, and printed under `label`.
    Returns (the kernel's outputs, the plain version's result, error
    against float64, error against the plain version, masks parted)."""
    import torch

    from orb_slam_cuda_tpu_torch.ops import sim3_kernel
    from orb_slam_cuda_tpu_torch.solvers import sim3_solver

    x1, x2, uv1, uv2, valid, sets, th1, th2, cam, fix, min_in = args
    out = sim3_kernel.launch(*args)
    again = sim3_kernel.launch(*args)
    want = sim3_solver.solve_sim3_ransac_plain(x1, x2, uv1, uv2, valid, cam, th1, th2, fix_scale=fix,
                                               min_inliers=min_in, sample_sets=sets)
    R, t, s, inl, n_in, ok, info, counts, params = out
    ref = sim3_kernel.reference64(x1, x2, uv1, uv2, valid, sets, th1, th2, cam, fix, info, params)
    torch.cuda.synchronize()
    err64 = max(float((a.double() - b).abs().max()) for a, b in zip((R, t, s), ref))
    err_plain = max(float((a - b).abs().max()) for a, b in zip((R, t, s), want[:3]))
    parted = int((inl != want.inliers).sum())
    best = int(info[0])
    log(f"sim3_ransac on {label}: {x1.shape[0]} matches, {int(valid.sum())} valid pairs; best hypothesis {best} of "
        f"{sets.shape[0]} ({int(counts[best])} inliers), refit kept {bool(info[1])}; kernel ok {bool(ok)}, "
        f"{int(n_in)} inliers; plain version ok {bool(want.ok)}, {int(want.n_inliers)} inliers; masks part on "
        f"{parted} (tolerance {SIM3_PARTED}); R, t, s {err64:.3e} from float64 Horn on the inliers refitted on "
        f"(tolerance {SIM3_TOL64}), {err_plain:.3e} from the plain version's")
    check_gates(f"sim3_ransac kernel, {label}", {
        "ok equal to the plain version's": bool(ok) == bool(want.ok),
        f"n_inliers within {SIM3_N_DIFF} of the plain version's":
            abs(int(n_in) - int(want.n_inliers)) <= SIM3_N_DIFF,
        f"inlier masks part on <= {SIM3_PARTED} matches": parted <= SIM3_PARTED,
        f"R, t, s within {SIM3_TOL64} of float64 Horn": err64 <= SIM3_TOL64,
        "two launches torch.equal": all(torch.equal(a, b) for a, b in zip(out, again)),
        "the call's RANSAC passes": bool(ok),
    })
    return out, want, err64, err_plain, parted


def sim3_times(args, out, label: str) -> dict:
    """The Sim3 kernel's device time on `args` warm and cold and as called,
    and its bound (the function's least work on these inputs, Horn's
    Jacobi sweeps counted on them), printed under `label`."""
    import torch

    from orb_slam_cuda_tpu_torch.ops import sim3_kernel
    from orb_slam_cuda_tpu_torch.solvers import sim3_solver

    x1, x2, uv1, uv2, valid, sets, th1, th2, cam, fix, min_in = args
    flush = torch.empty(128 * 1024 * 1024 // 4, device=x1.device)  # 128 MB > the 50 MB L2

    def kern():
        return sim3_kernel.launch(*args)

    warm = device_median_ms(kern, inner=10)
    cold = device_median_ms(kern, before=flush.zero_)
    called = cuda_median_ms(lambda: sim3_kernel.solve(*args))
    counts, params, info = out[7], out[8], out[6]
    m, nh, n_valid, best = x1.shape[0], sets.shape[0], int(valid.sum()), int(info[0])
    n_best, p = int(counts[best]), params[best]
    best_inl = sim3_solver.count_inliers(p[:9].reshape(3, 3), p[9:12], p[12], x1, x2, uv1, uv2, valid, cam, th1, th2)
    sweeps = horn_sweeps(x1, x2, sets, best_inl)
    ops = (nh * (n_valid * OPS_SIM3_MATCH + OPS_SIM3_SET) + (nh + 1) * OPS_HORN + int(sweeps.sum()) * OPS_DLT_SWEEP
           + nh + n_best * OPS_SIM3_INLIER + n_valid * OPS_SIM3_MATCH)
    nbytes = m * BYTES_SIM3_MATCH + n_valid * BYTES_SIM3_VALID + nh * BYTES_SIM3_SET + BYTES_SIM3_FIXED
    sweep_counts = {int(k): int(v) for k, v in zip(*torch.unique(sweeps, return_counts=True))}
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    bound_ms, bound_by = max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")
    log(f"sim3_ransac per call on {label} ({m} matches, {n_valid} valid, {nh} hypotheses): device {warm:.4f} ms warm "
        f"(10 calls a pair of events), {cold:.4f} ms cold L2 (1 call a pair); as called {called:.4f} ms; bound "
        f"{bound_ms:.6f} ms by {bound_by} ({by_bytes:.6f} by {nbytes} bytes, {by_ops:.6f} by {ops} FP32 "
        f"operations, Horn's Jacobi sweeps {sweep_counts} of its {nh + 1} N-matrices); share of bound reached "
        f"{bound_ms / warm:.4f} warm")
    return {"matches": m, "valid": n_valid, "ms": warm, "cold_l2_ms": cold, "as_called_ms": called,
            "bound_ms": bound_ms, "bound_by": bound_by, "jacobi_sweeps": sweep_counts}


def sim3_full_width_args(device):
    """The Sim3 kernel's arguments for a full-width call: 2,000 matches,
    every pair valid, 128 minimal sets (`sim3_kernel.synthetic_problem`)."""
    from orb_slam_cuda_tpu_torch.engine import loop_closing
    from orb_slam_cuda_tpu_torch.ops import sim3_kernel

    cam, p = sim3_kernel.synthetic_problem(device, 2000, seed=2000)
    return (p["x1"], p["x2"], p["uv1"], p["uv2"], p["valid"], sim3_kernel.synthetic_sets(p, 131 * 15), p["th1"],
            p["th2"], cam, False, loop_closing.MIN_SIM3_INLIERS)


def phase_sim3_launches() -> int:
    """The Sim3 kernel's device launches a call (torch.profiler over host
    and device) on the full-width call, gated on one, the kernel. It runs
    before the vocabulary phase: in this script's process, profiles taken
    after it recorded none or only some of a call's device events."""
    import torch

    from orb_slam_cuda_tpu_torch.ops import sim3_kernel

    launches0 = sim3_kernel.launches
    args = sim3_full_width_args(torch.device("cuda"))
    names = device_event_names(lambda: sim3_kernel.launch(*args))
    sim3_kernel.launches = launches0  # the profile's launches are not a path's
    log(f"sim3_ransac device launches a call (torch.profiler): {len(names)} {names}")
    check_gates("sim3_ransac kernel",
                {"one device launch a Sim3 call": len(names) == 1 and "ransac_kernel" in names[0]})
    return len(names)


def phase_sim3_kernel(slam, call, device_launches: int):
    """The Sim3 RANSAC kernel on one real call of the loop path (`call`, the
    arguments of the last `sim3_ransac` program call whose RANSAC passed:
    the BoW match's pairs of the two keyframes, all their features, pairs
    without two live points invalid, and the draw's minimal sets) and on a
    full-width synthetic one (2,000 matches, every pair valid, 128 minimal
    sets, `sim3_kernel.synthetic_problem`): on each, the kernel launched
    twice (torch.equal) and held against its plain version (float32
    `eigh`) and against float64 Horn on the inliers it refitted on, its
    device time warm and cold and as called, and the bound; one device
    launch a call (`device_launches`, from phase_sim3_launches); the plain
    version's time on the real call. Returns the kernel-table row (without
    `launches`)."""
    from orb_slam_cuda_tpu_torch.engine import loop_closing
    from orb_slam_cuda_tpu_torch.ops import sim3_kernel
    from orb_slam_cuda_tpu_torch.solvers import sim3_solver

    if call is None:
        raise AssertionError("sim3 kernel: the loop path made no Sim3 call whose RANSAC passed")
    lc = slam.loop_closer
    (_, valid, x1, x2, uv1, uv2, th1, th2), sets = call
    cam, fix, min_in = lc.cam, lc.fix_scale, loop_closing.MIN_SIM3_INLIERS
    args = (x1, x2, uv1, uv2, valid, sets, th1, th2, cam, fix, min_in)
    launches0 = sim3_kernel.launches
    out, want, err64, err_plain, parted = sim3_against_plain(args, "the loop path's last passing call")
    real = sim3_times(args, out, "the loop path's last passing call")
    plain_ms = cuda_median_ms(lambda: sim3_solver.solve_sim3_ransac_plain(
        x1, x2, uv1, uv2, valid, cam, th1, th2, fix_scale=fix, min_inliers=min_in, sample_sets=sets))
    log(f"sim3_ransac plain version {plain_ms:.4f} ms a call; library call: none (no one PyTorch call computes Sim3 "
        "RANSAC, and eigh reads back)")
    wargs = sim3_full_width_args(x1.device)
    check_gates("sim3_ransac full-width call", {"every pair valid": bool(wargs[4].all())})
    wout, _, werr64, _, _ = sim3_against_plain(wargs, "the full-width synthetic call")
    full = sim3_times(wargs, wout, "the full-width synthetic call")
    sim3_kernel.launches = launches0  # the comparison's launches are not the path's
    return {"name": "sim3_ransac", "route": "cuda", "source": SIM3_SOURCE,
            "replaces": "orb_slam_cuda_tpu/solvers/sim3_solver.py:78", "max_abs_err": err_plain,
            "max_abs_err_f64": err64, "inliers": int(out[4]), "inliers_plain": int(want.n_inliers),
            "masks_parted": parted, **real, "plain_ms": plain_ms, "library_ms": None,
            "device_launches_a_call": device_launches, "full_width": dict(full, max_abs_err_f64=werr64)}


def _max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def phase_parallel(slam):
    """The distributed back end on the loop path's final System: (a) one
    rank on a 1-rank group against the single-device solve, (b) two
    spawned ranks sharing the card over gloo, (c) a cluster refinement
    round twice. `device="cpu"` rehearses it on gloo ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from orb_slam_cuda_tpu_torch.parallel import distributed_bundle_adjust, make_mesh
    from orb_slam_cuda_tpu_torch.parallel.cluster_ba import cluster_block_ba
    from orb_slam_cuda_tpu_torch.parallel.multihost import join_group, run_ranks
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba
    from orb_slam_cuda_tpu_torch.tools import dryrun_multichip

    on_gpu = slam.device.type == "cuda"
    cam, iters = slam.cam, dict(lm_iters=PAR_LM_ITERS, cg_iters=PAR_CG_ITERS)
    problem, _ = slam.loop_closer.global_ba_problem(slam.state, slam.kf_order)
    n_obs, n_pts = int(problem.obs_valid.sum()), int(problem.pt_valid.sum())
    log(f"parallel: global BA of the loop map: {problem.cam_pose.shape[0]} camera rows "
        f"({len(slam.kf_order)} keyframes), {n_pts} points, {n_obs} observations; {iters}")

    def close(a, b):
        return (_max_abs(a.cam_pose, b.cam_pose) <= PAR_POSE_TOL and _max_abs(a.xyz, b.xyz) <= PAR_POINT_TOL)

    def timed_solve(fn):
        _synchronize(slam.device)
        t0 = time.perf_counter()
        out = fn()
        _synchronize(slam.device)
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        join_group(f"file://{os.path.join(tmp, 'store')}", 1, 0, backend="nccl" if on_gpu else "gloo",
                   device=str(slam.device))
        try:
            mesh = make_mesh(device=str(slam.device))
            # (a) one rank against the single-device solve
            single, single_s = timed_solve(lambda: ba.bundle_adjust(problem, cam, **iters))
            one, one_s = timed_solve(lambda: distributed_bundle_adjust(problem, cam, mesh, **iters))
            bit_equal = all(torch.equal(x, y) for x, y in zip(single, one))
            log(f"parallel (a): bundle_adjust {single_s * 1e3:.2f} ms, distributed_bundle_adjust on 1 rank "
                f"({dist.get_backend()}) {one_s * 1e3:.2f} ms; bit-equal {bit_equal}; pose diff "
                f"{_max_abs(single.cam_pose, one.cam_pose):.3g}, point diff {_max_abs(single.xyz, one.xyz):.3g}, "
                f"inlier masks equal {torch.equal(single.obs_inlier, one.obs_inlier)}; final error "
                f"{float(single.final_error):.6g} vs {float(one.final_error):.6g} (input "
                f"{float(ba.bundle_adjust(problem, cam, lm_iters=0).final_error):.6g})")
            # (c) one cluster refinement round, twice
            inv_sig = 1.0 / torch.as_tensor(slam.map_cfg.level_sigma2, dtype=torch.float32)
            before = float(ba.bundle_adjust(problem, cam, lm_iters=0).final_error)
            rounds = [timed_solve(lambda: cluster_block_ba(slam.state, cam, inv_sig, mesh=mesh, rounds=1,
                                                           lm_iters=4, cg_iters=12)) for _ in range(2)]
            (r1, r1_s), (r2, r2_s) = rounds
            repeat = torch.equal(r1.kf_pose, r2.kf_pose) and torch.equal(r1.mp_xyz, r2.mp_xyz)
            after_problem, _ = slam.loop_closer.global_ba_problem(r1, slam.kf_order)
            after = float(ba.bundle_adjust(after_problem, cam, lm_iters=0).final_error)
            log(f"parallel (c): cluster_block_ba round ({mesh.size} cluster(s), lm 4, cg 12) {r1_s * 1e3:.2f} ms "
                f"and {r2_s * 1e3:.2f} ms, the two runs {'torch.equal' if repeat else 'DIFFER'}; global error "
                f"{before:.6g} before, {after:.6g} after")
        finally:
            dist.destroy_process_group()
        # (b) two ranks sharing the card over gloo
        path = os.path.join(tmp, "problem.pt")
        dryrun_multichip.save_problem(path, problem, cam, **iters)
        t0 = time.perf_counter()
        outs = run_ranks(dryrun_multichip.rank_solve, 2, (path, "cuda:0" if on_gpu else "cpu"),
                         root=os.path.join(tmp, "ranks"), backend="gloo", device=str(slam.device), timeout=300)
        spawn_s = time.perf_counter() - t0
    res = [ba.BAResult(**o["result"]) for o in outs]
    ranks_equal = all(torch.equal(x, y) for x, y in zip(res[0], res[1]))
    single_cpu = ba.BAResult(*(x.cpu() for x in single))
    log(f"parallel (b): 2 ranks on {outs[0]['device']} and {outs[1]['device']} over {outs[0]['backend']}: "
        f"solve {outs[0]['seconds'] * 1e3:.2f} ms and {outs[1]['seconds'] * 1e3:.2f} ms, spawn to results "
        f"{spawn_s:.1f} s; ranks {'torch.equal' if ranks_equal else 'DIFFER'}; against (a): pose diff "
        f"{_max_abs(single_cpu.cam_pose, res[0].cam_pose):.3g}, point diff {_max_abs(single_cpu.xyz, res[0].xyz):.3g}, "
        f"inlier mismatches {int((single_cpu.obs_inlier != res[0].obs_inlier).sum())}, final error "
        f"{float(res[0].final_error):.6g}")
    # (d) the segment-sum kernel on the global-BA problem
    cmp_iters = dict(lm_iters=2, cg_iters=PAR_CG_ITERS)
    new, new_s = timed_solve(lambda: ba.bundle_adjust(problem, cam, **cmp_iters))
    with unmasked_plain_sums():
        old, old_s = timed_solve(lambda: ba.bundle_adjust(problem, cam, **cmp_iters))
    unmasked_equal = all(_bits_equal(x, y) for x, y in zip(new, old))
    log(f"parallel (d): global BA {cmp_iters} through the segsum kernel {new_s * 1e3:.2f} ms, on segment_reduce "
        f"over the unmasked index {old_s * 1e3:.2f} ms; bit-equal {unmasked_equal}")
    if on_gpu:
        hcc, hpp = ba_sum_calls(problem, cam)
        segsum_call("global BA Hcc (K=36)", hcc[0], torch.clamp(problem.obs_cam, min=0).long(), hcc[1])
        segsum_call("global BA Hpp (K=9)", hpp[0], torch.clamp(problem.obs_pt, min=0).long(), hpp[1])
    check_gates("parallel", {
        "(d) global BA through the segsum kernel bit-equal to segment_reduce on the unmasked index": unmasked_equal,
        f"(a) 1 rank within {PAR_POSE_TOL} / {PAR_POINT_TOL} of bundle_adjust": close(single, one),
        "(a) inlier masks equal": torch.equal(single.obs_inlier, one.obs_inlier),
        "(b) the 2 ranks torch.equal": ranks_equal,
        f"(b) each rank within {PAR_POSE_TOL} / {PAR_POINT_TOL} of (a)": all(close(single_cpu, r) for r in res),
        "(c) a cluster round repeats bit for bit": repeat,
        "(c) global error not higher after the round": after <= before,
        "finite results": bool(np.isfinite(float(one.final_error)) and np.isfinite(after)),
    })


def phase_stereo_path(cam, poses, frames, device=None):
    """Track the stereo circuit with loop closing on and check every gate."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.engine import Sensor

    slam = build_system(circuit_config(cam, Sensor.STEREO), device)
    est, frame_ms, reloc_calls, depth_share, total_s, launches = drive(
        slam, lambda s, pair, t: s.track_stereo(pair[0], pair[1], t), frames, 0.1)
    dlt = kernel_gates("stereo path", slam)
    ate, extent, span, off_device, program_calls = summarize("stereo path", slam, poses, 0.1, frame_ms,
                                                             reloc_calls, total_s, launches, with_scale=False)
    status = slam.get_status()
    share = float(np.mean(depth_share)) if depth_share else 0.0
    log(f"stereo path: pose at frame 0 {est[0] is not None}; valid left features with a depth "
        f"{share:.4f} (mean over {len(depth_share)} tracked frames, least {min(depth_share, default=0.0):.4f}); "
        f"th_depth {slam.th_depth:.2f} m; visual-odometry frames {slam.stats.n_vo_frames}")
    pose = slam.last_pose
    want_launches = 2 * len(frames) if slam.device.type == "cuda" else 0  # left and right
    want_calls = want_launches // 2
    check_gates("stereo path", {
        f"frame-stage program calls == {want_calls}": program_calls == want_calls,
        "a pose at frame 0": est[0] is not None,
        "tracked_ratio >= 0.85": slam.tracked_ratio() >= 0.85,
        "unscaled ATE <= 1% of extent": ate <= 0.01 * extent,
        "estimated / true span within 0.95-1.05": 0.95 <= span <= 1.05,
        "loops_closed >= 1": status["loops_closed"] >= 1,
        "share of valid left features with a depth >= 0.5": share >= 0.5,
        f"fast launches == {want_launches}": launches == want_launches,
        f"map tensors on {slam.device} (off: {off_device})": not off_device,
        "last pose finite": pose is not None and bool(np.isfinite(pose).all()),
        **dlt,
    })
    return launches


def rgbd_config(cam):
    """config_rgbd_tum's settings on the circuit's policy."""
    from orb_slam_cuda_tpu_torch.engine import Sensor

    return circuit_config(cam, Sensor.RGBD, n_features=1000, max_frames_between_kf=30,
                          depth_map_factor=1.0 / DEPTH_FACTOR)


def _track_rgbd(slam, frame, t):
    return slam.track_rgbd(frame[0], frame[1], t)


def phase_rgbd_path(cam, poses, frames, device=None):
    """Track the RGB-D circuit with loop closing on, check every gate, then
    save the map, load it into a new System and localize in it."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.engine import Sensor

    cfg = rgbd_config(cam)
    track = _track_rgbd

    slam = build_system(cfg, device)
    est, frame_ms, reloc_calls, depth_share, total_s, launches = drive(slam, track, frames, RGBD_DT)
    dlt = kernel_gates("rgbd path", slam)
    ate, extent, span, off_device, program_calls = summarize("rgbd path", slam, poses, RGBD_DT, frame_ms,
                                                             reloc_calls, total_s, launches, with_scale=False)
    log(f"rgbd path: pose at frame 0 {est[0] is not None}; valid features with a depth "
        f"{float(np.mean(depth_share)) if depth_share else 0.0:.4f}; th_depth {slam.th_depth:.2f} m; "
        f"loops closed {slam.get_status()['loops_closed']} (not gated)")
    pose = slam.last_pose
    on_gpu = slam.device.type == "cuda"
    want_launches = len(frames) if on_gpu else 0
    check_gates("rgbd path", {
        f"frame-stage program calls == {want_launches}": program_calls == want_launches,
        "tracked_ratio >= 0.85": slam.tracked_ratio() >= 0.85,
        "unscaled ATE <= 1% of extent": ate <= 0.01 * extent,
        f"fast launches == {want_launches}": launches == want_launches,
        f"map tensors on {slam.device} (off: {off_device})": not off_device,
        "last pose finite": pose is not None and bool(np.isfinite(pose).all()),
        **dlt,
    })

    # Localization-only probe: the saved map in a new System.
    saved_kfs, saved_pts = int(slam.state.kf_valid.sum()), int(slam.state.mp_valid.sum())
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        t0 = time.perf_counter()
        slam.save_map(path)
        t1 = time.perf_counter()
        size = os.path.getsize(path)
        probe = build_system(cfg, device)
        probe.load_map(path)
        t2 = time.perf_counter()
    loaded_kfs, loaded_pts = int(probe.state.kf_valid.sum()), int(probe.state.mp_valid.sum())
    p_est, p_ms, p_reloc, _, p_s, p_launches = drive(probe, track, frames[:PROBE_FRAMES], RGBD_DT)
    p_calls = program_summary("localization probe", probe)
    first = next((i for i, p in enumerate(p_est) if p is not None), None)
    tracked = sum(p is not None for p in p_est)
    mapped = [T for _, T, _ in slam.get_trajectory()]  # the mapping run's poses, in the map's frame
    err = [float(np.linalg.norm(np.linalg.inv(p)[:3, 3] - np.linalg.inv(T)[:3, 3]))
           for p, T in zip(p_est, mapped) if p is not None and T is not None]
    log(f"localization probe: map saved in {t1 - t0:.2f} s ({size / 1e6:.2f} MB), loaded in {t2 - t1:.2f} s; "
        f"{loaded_kfs} keyframes and {loaded_pts} points loaded of {saved_kfs} and {saved_pts} saved; "
        f"{probe.get_status()}; first pose at frame {first}, tracked {tracked} of {len(p_est)} in {p_s:.1f} s "
        f"(p50 {float(np.percentile(p_ms, 50)):.2f} ms), relocalizations {p_reloc}, visual-odometry frames "
        f"{probe.stats.n_vo_frames}, mean distance to the mapping run's camera centre {float(np.mean(err)) if err else -1:.4f} m, "
        f"fast launches {p_launches}")
    # Candidates in the order tried, up to the one that gave the first pose.
    for row in probe.reloc_trace:
        log(f"localization probe, relocalization candidate: {row}")
        if "refused_at" not in row:
            break
    p_want = len(p_est) if on_gpu else 0
    check_gates("localization probe", {
        f"frame-stage program calls == {p_want}": p_calls == p_want,
        "relocalizes within the first 3 frames": first is not None and first < 3,
        "tracked >= 0.85 of the frames": tracked >= 0.85 * len(p_est),
        "no keyframe inserted": probe.stats.n_keyframes == len(slam.kf_order) == len(probe.kf_order),
        "loaded map holds the saved keyframes and points": (loaded_kfs, loaded_pts) == (saved_kfs, saved_pts),
        "localization-only mode": probe.get_status()["localization_only"],
        f"fast launches == {p_want}": p_launches == p_want,
    })
    return launches + p_launches


def _cli(argv):
    """`orb_slam_cuda_tpu_torch.run.main(argv)` in this process, its FAST
    launches and program captures and replays counted from 0; its stderr
    is captured and printed. Returns (launches, stderr lines, seconds). A
    non-zero return raises."""
    import contextlib
    import io

    import torch

    from orb_slam_cuda_tpu_torch import run
    from orb_slam_cuda_tpu_torch.engine import programs
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    err = io.StringIO()
    reset_launches()  # count this run's launches only
    programs.captures, programs.replays, programs.capture_s = 0, 0, 0.0
    on_card = torch.cuda.is_available()
    reset_peak("cuda" if on_card else "cpu")
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = run.main(argv)
    seconds = time.perf_counter() - t0
    launches = fast_kernel.launches
    log(f"  cli: programs: {programs.captures} captures in {programs.capture_s:.2f} s, "
        f"{programs.replays} replays; peak reserved "
        f"{torch.cuda.max_memory_reserved() / 1e6 if on_card else 0.0:.1f} MB")
    lines = err.getvalue().splitlines()
    for line in lines:
        log(f"  cli: {line}")
    if rc != 0:
        raise AssertionError(f"orb_slam_cuda_tpu_torch.run.main returned {rc}")
    return launches, lines, seconds


def _read_csv(path):
    import csv

    with open(path) as f:
        return list(csv.DictReader(f))


def frame_stage_ms(timing_dir):
    """Per frame, the sum of its rows over the StageTimer CSVs (extraction,
    frame build, tracking and the mapping units drained before it): the
    time `track_monocular` spent in its stages, in ms."""
    acc = {}
    for name in ("times.csv", "timesTracking.csv", "timesMapping.csv"):
        path = os.path.join(timing_dir, name)
        if os.path.exists(path):
            for row in _read_csv(path):
                acc[int(row["frame"])] = acc.get(int(row["frame"]), 0.0) + int(row["time"]) / 1e6
    return [acc.get(i, 0.0) for i in range(max(acc) + 1)] if acc else []


def phase_cli_path(device=None):
    """The port's CLI on the distorted TUM monocular configuration: the
    first CLI_FRAMES frames of config_mono_tum (640x480, TUM1.yaml lens,
    1000 features, 30 fps) generated with the port's tool into a temporary
    directory, mapped through `run.main` with --save-tum --diag
    --timing-dir --save-map, then a localization-only probe through a
    second `run.main` with --load-map on frames CLI_PROBE_FROM.. listed in
    a second sequence directory. With no `device` the CLI takes its
    default, the card; a CPU device is the tests' rehearsal."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.io import png
    from orb_slam_cuda_tpu_torch.tools import accuracy_eval

    dev_args = [] if device is None else ["--device", str(device)]
    on_gpu = device is None or str(device).startswith("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        seq = os.path.join(tmp, "mono_tum")
        t0 = time.perf_counter()
        args = accuracy_eval.make_mono_tum(seq, device="cuda" if device is None else device,
                                           n_frames=CLI_FRAMES)
        gen_s = time.perf_counter() - t0
        log(f"cli fixture: the first {CLI_FRAMES} of config_mono_tum's 460 frames generated in {gen_s:.1f} s")
        traj, diag = os.path.join(tmp, "traj.txt"), os.path.join(tmp, "diag.csv")
        timing, map_path = os.path.join(tmp, "timing"), os.path.join(tmp, "map.npz")
        os.makedirs(timing)
        launches, lines, run_s = _cli(args + ["--save-tum", traj, "--diag", diag, "--timing-dir", timing,
                                              "--save-map", map_path] + dev_args)
        dlt = note_launches("cli path")
        rows = _read_csv(diag)
        ok = [r["state"] == "OK" for r in rows]
        first = ok.index(True) if any(ok) else None
        tracked_after = sum(ok[first:]) / len(ok[first:]) if first is not None else 0.0
        ate, extent, n_scored, extras = accuracy_eval.score(seq, traj)
        last = np.loadtxt(traj, ndmin=2)[-1]
        ms = np.asarray(frame_stage_ms(timing))
        p50, p99 = np.percentile(ms, [50, 99])
        rgb = sorted(os.listdir(os.path.join(seq, "rgb")))
        t1 = time.perf_counter()
        for name in rgb:
            png.read_gray(os.path.join(seq, "rgb", name))
        decode_ms = (time.perf_counter() - t1) / len(rgb) * 1e3
        log(f"cli path: {len(rows)} frames in {run_s:.1f} s; first pose at frame {first}, tracked "
            f"{sum(ok)} ({tracked_after:.4f} of the frames from the first pose on), keyframes "
            f"{rows[-1]['keyframes']}, relocalizations {rows[-1]['relocs']}; ATE sim(3) {ate:.4f} m over "
            f"{n_scored} frames: {100 * ate / extent:.3f}% of this cut's {extent:.2f} m extent, "
            f"{100 * ate / MONO_TUM_EXTENT:.3f}% of the whole config's {MONO_TUM_EXTENT} m; {extras}; "
            f"fast launches {launches}, dlt launches {dlt}")
        log(f"cli path frames 0-{len(ms) - 1} (stage time a frame, timing CSVs): {len(ms) / (ms.sum() / 1e3):.2f} fps, "
            f"p50 {p50:.2f} ms, p99 {p99:.2f} ms, max {ms.max():.2f} ms; PNG decode {decode_ms:.2f} ms a frame "
            f"(native, {len(rgb)} frames 640x480)")
        for name in ("times.csv", "timesTracking.csv", "timesMapping.csv"):
            path = os.path.join(timing, name)
            rows_t = [(int(r["frame"]), r["name"], 0, int(r["time"])) for r in _read_csv(path)] \
                if os.path.exists(path) else []
            log(f"cli path stage means {name}, frames 0-{len(ms) - 1}: " + stage_means(rows_t, 0))
        want = len(rows) if on_gpu else 0
        check_gates("cli path", {
            f"first pose by frame {CLI_FIRST_POSE_BY}": first is not None and first < CLI_FIRST_POSE_BY,
            "tracked >= 0.85 of the frames from the first pose on": tracked_after >= 0.85,
            f"ATE sim(3) <= {CLI_ATE_GATE:.4f} m": ate <= CLI_ATE_GATE,
            f"fast launches == {want} (frames read)": launches == want and len(rows) == CLI_FRAMES,
            "gated dlt launched (keyframes inserted)": dlt["gated"] > 0 or not on_gpu or int(rows[-1]["keyframes"]) < 3,
            "segsum launched (keyframes inserted)": dlt["segsum"] > 0 or not on_gpu or int(rows[-1]["keyframes"]) < 3,
            "last pose finite": bool(np.isfinite(last).all()),
            "shutdown line printed": any(line.startswith("tracked ") for line in lines),
        })

        # Localization-only probe: frames CLI_PROBE_FROM.. through the saved map.
        probe_seq = os.path.join(tmp, "probe")
        os.makedirs(probe_seq)
        with open(os.path.join(seq, "rgb.txt")) as f:
            entries = f.read().split("\n")[CLI_PROBE_FROM:CLI_PROBE_FROM + CLI_PROBE_FRAMES]
        with open(os.path.join(probe_seq, "rgb.txt"), "w") as f:
            f.write("".join(f"{ts} ../mono_tum/{rel}\n" for ts, rel in (e.split() for e in entries)))
        p_diag = os.path.join(tmp, "probe_diag.csv")
        p_args = [a if a != seq else probe_seq for a in args]
        p_launches, _, p_s = _cli(p_args + ["--load-map", map_path, "--localization-only", "--max-frames",
                                            str(CLI_PROBE_FRAMES), "--diag", p_diag] + dev_args)
        p_rows = _read_csv(p_diag)
        p_ok = [r["state"] == "OK" for r in p_rows]
        p_first = p_ok.index(True) if any(p_ok) else None
        kfs = {int(r["keyframes"]) for r in p_rows}
        log(f"cli localization probe (frames {CLI_PROBE_FROM}-{CLI_PROBE_FROM + CLI_PROBE_FRAMES - 1}, map "
            f"{os.path.getsize(map_path) / 1e6:.2f} MB): first pose at frame {p_first}, tracked {sum(p_ok)} of "
            f"{len(p_rows)} in {p_s:.1f} s, keyframe column {sorted(kfs)}, fast launches {p_launches}")
        p_want = len(p_rows) if on_gpu else 0
        check_gates("cli localization probe", {
            "first pose within 3 frames": p_first is not None and p_first < 3,
            "tracked >= 0.85 of the frames": sum(p_ok) >= 0.85 * len(p_rows),
            "keyframe column never grows": len(kfs) == 1,
            f"fast launches == {p_want}": p_launches == p_want and len(p_rows) == CLI_PROBE_FRAMES,
        })
    return launches + p_launches


def _stereo_worker(queue, device, n_frames):
    """The stereo path in a process of its own: its fixture rendered on the
    card, every gate, its log captured and sent back with its launches."""
    import io
    import traceback

    out = io.StringIO()
    sys.stdout = out
    try:
        t0 = time.perf_counter()
        launches = phase_stereo_path(*make_stereo_fixture(device, n_frames),
                                     device=None if device == "cuda" else device)
        queue.put(dict(launches=launches, dlt=PATH_LAUNCHES.get("stereo path", dict.fromkeys(PATH_KERNELS, 0)),
                       seconds=time.perf_counter() - t0, log=out.getvalue()))
    except BaseException:
        queue.put(dict(error=traceback.format_exc(), log=out.getvalue()))


def start_stereo_path(device="cuda", n_frames=STEREO_FRAMES):
    """Start the stereo path beside the rest; `finish_stereo_path` waits.
    (`device="cpu"` and a few frames rehearse it.)"""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_stereo_worker, args=(queue, device, n_frames))
    proc.start()
    return proc, queue


def finish_stereo_path(handle, timeout_s: float = 1000.0):
    """Print the stereo path's log; its launches, or raise if it failed."""
    import queue as queue_mod

    proc, queue = handle
    deadline = time.perf_counter() + timeout_s
    try:
        while True:
            try:
                res = queue.get(timeout=5)
                break
            except queue_mod.Empty:
                if not proc.is_alive():  # one more look: its result may be on the way
                    try:
                        res = queue.get(timeout=5)
                        break
                    except queue_mod.Empty:
                        raise AssertionError(f"stereo path: its process ended (code {proc.exitcode}) "
                                             "with no result")
                if time.perf_counter() > deadline:
                    raise AssertionError(f"stereo path: no result in {timeout_s} s")
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.kill()
            proc.join()
    print(res["log"], end="", flush=True)
    if "error" in res:
        raise AssertionError("stereo path failed in its process:\n" + res["error"])
    log(f"stereo path (own process): {res['seconds']:.1f} s")
    PATH_LAUNCHES["stereo path"] = res["dlt"]
    return res["launches"]


def main() -> int:
    t_start = time.perf_counter()
    card = phase_device()
    try:
        import orb_slam_cuda_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the port package is not importable here: {e}")
    import torch

    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        log(f"phase {name}: {seconds[name]:.1f} s ({time.perf_counter() - t_start:.1f} s since the start)")
        return out

    timed("build", phase_build)
    cam, poses, frames = timed("orbit fixture", make_fixture, device="cuda")
    rgbd = timed("rgbd fixture", make_rgbd_fixture, "cuda")
    pyramid_row, pair_row = timed("kernels", phase_kernels, frames[0], rgbd[2][0][0])
    timed("kernels", check_against_cpu, frames[0])
    timed("kernels", phase_extract_launches, frames[0])
    sim3_device_launches = timed("kernels", phase_sim3_launches)
    segsum_device_launches = timed("kernels", phase_segsum_launches)
    pose_graph_row = timed("kernels", phase_pose_graph_kernel, timed("kernels", phase_pose_graph_launches))
    sim3_opt_row = timed("kernels", phase_sim3_opt_kernel, timed("kernels", phase_sim3_opt_launches))
    vocab = timed("vocabulary", phase_vocabulary)
    launches, orbit_slam = timed("orbit path", phase_main_path, cam, poses, frames, vocab=vocab)
    dlt_row, gated_row = timed("kernels", phase_dlt_kernel, orbit_slam)
    timed("repeatability", phase_repeatability, orbit_slam)
    timed("programs", phase_programs, cam, frames, vocab, rgbd)
    del frames, vocab, orbit_slam
    stereo = start_stereo_path()  # beside the paths below; its log is printed when it ends
    try:
        loop_launches, loop_slam, sim3_call, jacobian_call = timed("loop path", phase_loop_path,
                                                                   *timed("loop fixture", make_loop_fixture, "cuda"))
        launches += loop_launches
        sim3_row = timed("kernels", phase_sim3_kernel, loop_slam, sim3_call, sim3_device_launches)
        sim3_opt_row = timed("kernels", phase_sim3_opt_real_call, sim3_opt_row, jacobian_call)
        del sim3_call, jacobian_call
        timed("parallel", phase_parallel, loop_slam)
        del loop_slam
        launches += timed("rgbd path", phase_rgbd_path, *rgbd)
        del rgbd
        launches += timed("cli path", phase_cli_path)
    except BaseException:
        stereo[0].kill()
        raise
    launches += timed("stereo path, waited for", finish_stereo_path, stereo)
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; total {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    # fast_score_pair is built, launched and held against its plain version
    # above, but no path calls it: its row stands apart from the main
    # path's kernel table.
    print(json.dumps({"entry_points_off_the_main_path": [dict(pair_row, launches=0)]}), flush=True)
    log(f"dlt, sim3, segsum, pose_graph and sim3_opt launches by path: {PATH_LAUNCHES}")
    total = {k: sum(n.get(k, 0) for n in PATH_LAUNCHES.values()) for k in PATH_KERNELS}
    print(json.dumps({"kernels": [dict(pyramid_row, launches=launches), dict(dlt_row, launches=total["dlt"]),
                                  dict(gated_row, launches=total["gated"]), dict(sim3_row, launches=total["sim3"]),
                                  segsum_row(SEGSUM_CALLS, total["segsum"], segsum_device_launches),
                                  dict(pose_graph_row, launches=total["pose_graph"]),
                                  dict(sim3_opt_row, launches=total["sim3_opt"])]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
