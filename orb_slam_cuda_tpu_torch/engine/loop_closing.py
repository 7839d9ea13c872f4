"""Loop closing: detection, Sim3 verification, loop fusion, essential-graph
optimization and the chunked global BA (torch port of
orb_slam_cuda_tpu/engine/loop_closing.py).

Host decisions (consistency chaining, the candidate ladder, which
keyframes a global BA re-poses) read small tensors back; the heavy steps
are batched tensor ops on the map's device. Scatters that the reference
drops with mode='drop' or pads onto index 0 write into a trash row here,
and every gather of a -1-padded index is clamped first. The essential
graph's edge set is built with tensor ops (encode, unique, sorted).
With a mesh (parallel/mesh.py, a process group) each global-BA chunk is
solved by parallel/dist_ba.py over the group and comes back on the map's
device, the same on every rank; without one it runs on the map's device.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..geometry import se3, sim3
from ..geometry.camera import Camera
from ..matching import search
from ..ops import hamming
from ..slam_map import MapConfig, MapState, keyframe_db
from ..slam_map import ops as map_ops
from ..slam_map.state import slot_index, slot_mask
from ..solvers import bundle_adjust as ba
from ..solvers import pose_graph, sim3_opt, sim3_solver
from ..solvers.initializer import default_sampler
from ..utils.timing import StageTimer
from . import local_mapping, programs, tracking
from .programs import pow2_bucket

CONSISTENCY_TH = 3
MIN_SIM3_INLIERS = 20
MIN_OPT_INLIERS = 20
MIN_TOTAL_MATCHES = 40
COVIS_EDGE_MIN_WEIGHT = 100
# The essential graph's edge count is padded to a power of two from this
# up: the key of its solve's program.
EDGE_BUCKET_MIN = 64
# The solve's program captures a key at its third call. On the 256-keyframe
# ring (763 edges, 15 steps; NVIDIA H100 80GB HBM3, tests/torch_pose_graph_
# profile.py) an eager solve takes 0.60-0.66 s, a capture 1.33-1.48 s more
# and a replay 0.04 s: a capture pays back after ~2.5 replays, so a key is
# captured once two eager calls have cost about what its capture costs (a
# path closes one or two loops, often on different keys).
ESSENTIAL_GRAPH_CAPTURE_AT = 3


class GBAPending:
    """An in-flight global BA: the current chunk's result, the problem to
    warm-start the next chunk from, and the snapshots finish_global_ba
    needs to apply it after frames and keyframes have interleaved."""

    __slots__ = ("idx", "result", "kfs", "kf_gen_snap", "pt_snap",
                 "problem", "iters_done", "cam_slots")

    def __init__(self, idx, result, kfs, kf_gen_snap, pt_snap,
                 problem=None, iters_done=0, cam_slots=None):
        self.idx = idx
        self.result = result
        self.kfs = kfs
        self.problem = problem
        self.iters_done = iters_done
        self.cam_slots = cam_slots
        self.kf_gen_snap = kf_gen_snap
        self.pt_snap = pt_snap


def _apply_gba(state: MapState, gba_pose, gba_xyz, kf_apply, pt_apply, chain) -> MapState:
    """Write a finished global BA into the current map. kf_apply (K,) and
    pt_apply (P,) take their GBA pose/position directly; `chain` lists
    (child, parent) slots of keyframes created during the solve, corrected
    child after parent in insertion order; the remaining points re-anchor
    through their reference keyframe's (old, corrected) pose pair."""
    corrected = torch.where(kf_apply[:, None, None], gba_pose, state.kf_pose)
    changed = kf_apply.clone()
    for c, p in chain:
        corrected[c] = state.kf_pose[c] @ se3.inverse(state.kf_pose[p]) @ corrected[p]
        changed[c] = True

    xyz = torch.where(pt_apply[:, None], gba_xyz, state.mp_xyz)
    ref = torch.clamp(state.mp_ref_kf, min=0).long()
    old = state.kf_pose[ref]
    new = corrected[ref]
    p_cam = torch.einsum("pij,pj->pi", old[:, :3, :3], xyz) + old[:, :3, 3]
    p_re = torch.einsum("pji,pj->pi", new[:, :3, :3], p_cam - new[:, :3, 3])
    fix = state.mp_valid & ~pt_apply & changed[ref]
    xyz = torch.where(fix[:, None], p_re, xyz)
    kf_pose = torch.where(changed[:, None, None], corrected, state.kf_pose)
    return state._replace(kf_pose=kf_pose, mp_xyz=xyz)


def _bow_scores_vs_neighbors(db, state: MapState, kf_slot, n_words: int):
    """The keyframe's BoW query, its scores, a FRESH covisibility matrix
    (the incremental rows' drift flipped marginal loop funnels in the
    reference), its >= 15-weight neighbours and their minimum score (the
    loop-candidate floor; 1.0 without neighbours). `kf_slot` an int or a
    slot tensor."""
    slot = slot_index(kf_slot, state.device)
    q = keyframe_db.dense_bow(db.word[slot][0], db.weight[slot][0], n_words)
    s = keyframe_db.scores(db, q)
    covis = map_ops.covisibility_matrix(state)
    neigh = (covis[slot][0] >= 15) & db.valid
    min_score = torch.min(torch.where(neigh, s, torch.full_like(s, float("inf"))))
    min_score = torch.where(torch.isfinite(min_score), min_score, torch.ones_like(min_score))
    return q, s, covis, neigh, min_score


def _project_points_into_kf(pts_xyz, pts_valid, pts_min_d, pts_max_d, S_cam, cam: Camera,
                            scale_factors):
    """Project points through a Sim3 into a keyframe image: (proj (M,2),
    predicted octave (M,), gate (M,)) under the depth, image and scale-band
    gates."""
    y = sim3.transform(S_cam, pts_xyz)
    z_ok = y[:, 2] > 1e-6
    z = torch.where(z_ok, y[:, 2], torch.ones_like(y[:, 2]))
    u = cam.fx * y[:, 0] / z + cam.cx
    v = cam.fy * y[:, 1] / z + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    dist = torch.linalg.norm(y, dim=-1)
    band = (dist >= 0.8 * pts_min_d) & (dist <= 1.2 * pts_max_d)
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=y.device)
    pred = search.predict_octave(dist, pts_max_d, torch.log(sf[1]), sf.shape[0])
    return torch.stack([u, v], dim=-1), pred, pts_valid & z_ok & in_img & band


def _row(arr, slot):
    """Row `slot` (an int or a slot tensor) of `arr`, gathered through a
    (1,) index: a 0-d tensor index would read back on the card."""
    return arr[slot_index(slot, arr.device)][0]


def sim3_pairs(state: MapState, kf1, cand, sig2):
    """The BoW match of keyframe kf1's features to the candidate's, and the
    matched point pairs gathered on the map's device: (idx (N,) the
    candidate feature per kf1 feature or -1, pair_ok (N,): both features
    hold a live point, x1, x2 (N,3) those points in each keyframe's camera
    frame, uv1, uv2 (N,2), th1, th2 (N,) the chi2 thresholds 9.210 sigma^2
    of each octave). Indices are clamped, so a pair that is not ok gathers
    row 0. kf1, cand: slots (ints or slot tensors); sig2 (L,) float32."""
    mp1, mp2 = _row(state.kf_mp, kf1).long(), _row(state.kf_mp, cand).long()
    has1 = (mp1 >= 0) & state.mp_valid[torch.clamp(mp1, min=0)]
    has2 = (mp2 >= 0) & state.mp_valid[torch.clamp(mp2, min=0)]
    m = search.by_bow(
        _row(state.kf_node, kf1), hamming.bipolar(_row(state.kf_desc, kf1)), _row(state.kf_feat_valid, kf1),
        _row(state.kf_ang, kf1), _row(state.kf_node, cand), hamming.bipolar(_row(state.kf_desc, cand)),
        _row(state.kf_feat_valid, cand), _row(state.kf_ang, cand), ratio=0.75, check_rotation=True,
        f1_has_point=has1,
    )
    idx = m.idx.long()
    j = torch.clamp(idx, min=0)
    pair_ok = (idx >= 0) & (mp1 >= 0) & has2[j]
    x1 = se3.transform(_row(state.kf_pose, kf1), state.mp_xyz[torch.clamp(mp1, min=0)])
    x2 = se3.transform(_row(state.kf_pose, cand), state.mp_xyz[torch.clamp(mp2[j], min=0)])
    top = sig2.shape[0] - 1
    th1 = 9.210 * sig2[torch.clamp(_row(state.kf_oct, kf1).long(), 0, top)]
    th2 = 9.210 * sig2[torch.clamp(_row(state.kf_oct, cand).long()[j], 0, top)]
    return idx, pair_ok, x1, x2, _row(state.kf_uv, kf1), _row(state.kf_uv, cand)[j], th1, th2


def sim3_candidate_ransac(pairs, sets, cam: Camera, fix_scale: bool = False):
    """Sim3 RANSAC (the kernel on the card) on `sim3_pairs`' output `pairs`
    over the (NH,3) minimal sets `sets`. Returns (packed (2,) int64:
    RANSAC inliers, ok; R, t, s; prior_feat (N,) the candidate feature of
    each RANSAC inlier or -1)."""
    idx, pair_ok, x1, x2, uv1, uv2, th1, th2 = pairs
    res = sim3_solver.solve_sim3_ransac(x1, x2, uv1, uv2, pair_ok, cam, th1, th2, fix_scale=fix_scale,
                                        min_inliers=MIN_SIM3_INLIERS, sample_sets=sets)
    prior_feat = torch.where(pair_ok & res.inliers, idx, torch.full_like(idx, -1))
    packed = torch.stack([res.n_inliers.long(), res.ok.long()])
    return packed, res.R, res.t, res.s, prior_feat


def sim3_search_and_refine(state: MapState, kf1: int, kf2: int, R0, t0, s0, prior_feat,
                           cam: Camera, scale_factors, fix_scale: bool = False):
    """SearchBySim3 (each keyframe's points projected through the estimate
    into the other, window-matched, mutual pairs kept; RANSAC inliers
    `prior_feat` (N,) are kept and skipped) then OptimizeSim3 over the
    combined correspondences. kf1, kf2: slots (ints or slot tensors).
    Returns (R, t, s, n_inliers, feat12), feat12 (N,) the surviving kf2
    feature per kf1 feature or -1."""
    S12 = (R0, t0, s0)
    S21 = sim3.inverse(S12)
    dev = state.device
    T1, T2 = _row(state.kf_pose, kf1), _row(state.kf_pose, kf2)
    mp1, mp2 = _row(state.kf_mp, kf1), _row(state.kf_mp, kf2)
    p1 = torch.clamp(mp1, min=0).long()
    p2 = torch.clamp(mp2, min=0).long()
    has1 = (mp1 >= 0) & state.mp_valid[p1]
    has2 = (mp2 >= 0) & state.mp_valid[p2]
    prior_feat = prior_feat.long()
    already1 = prior_feat >= 0
    N = mp1.shape[0]
    already2 = map_ops.mark(N, torch.clamp(prior_feat, min=0), already1)
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=dev)
    zeros_ang = torch.zeros((N,), dtype=torch.float32, device=dev)

    def directed(xc, pts, has, already, S, kf_t):
        proj, pred, gate = _project_points_into_kf(
            xc, has & ~already, state.mp_min_dist[pts], state.mp_max_dist[pts], S, cam, sf)
        return search.by_projection(
            proj, hamming.bipolar(state.mp_desc[pts]), gate, pred,
            _row(state.kf_uv, kf_t), _row(state.kf_oct, kf_t), zeros_ang, hamming.bipolar(_row(state.kf_desc, kf_t)),
            _row(state.kf_feat_valid, kf_t), sf, radius=7.5, max_dist=100.0, ratio=1.0,
            octave_lo_off=-1, octave_hi_off=0, check_rotation=False,
        )

    x1c = se3.transform(T1, state.mp_xyz[p1])
    m1 = directed(x1c, p1, has1, already1, S21, kf2)  # kf1 points -> kf2 image
    m2 = directed(se3.transform(T2, state.mp_xyz[p2]), p2, has2, already2, S12, kf1)
    j2 = torch.clamp(m1.idx, min=0)
    mutual = (m1.idx >= 0) & (m2.idx[j2] == torch.arange(N, device=dev))
    minus1 = torch.full_like(prior_feat, -1)
    feat12 = torch.where(already1, prior_feat, torch.where(mutual, m1.idx, minus1))

    # A pair needs its own point in kf1 and the matched point in kf2.
    jm = torch.clamp(feat12, min=0)
    q2 = torch.clamp(mp2[jm], min=0).long()
    pair_ok = (feat12 >= 0) & has1 & has2[jm]
    max_oct = sf.shape[0] - 1
    inv_sig = 1.0 / (sf ** 2)
    oct1 = torch.clamp(_row(state.kf_oct, kf1).long(), 0, max_oct)
    oct2 = torch.clamp(_row(state.kf_oct, kf2)[jm].long(), 0, max_oct)
    res = sim3_opt.optimize_sim3(
        S12, x1c, se3.transform(T2, state.mp_xyz[q2]), _row(state.kf_uv, kf1), _row(state.kf_uv, kf2)[jm],
        inv_sig[oct1], inv_sig[oct2], pair_ok, cam, fix_scale=fix_scale, th2=10.0,
    )
    return res.R, res.t, res.s, res.n_inliers, torch.where(pair_ok & res.inliers, feat12, minus1)


def loop_group_point_count(state: MapState, cand: int):
    """(count, loop_kfs mask) of the loop keyframe's covisibility-group
    points (fresh covisibility), so the host can size the projection gate
    to the true occupancy. `cand` an int or a slot tensor."""
    covis = map_ops.covisibility_matrix(state)
    K = covis.shape[0]
    loop_kfs = ((_row(covis, cand) >= 15) | slot_mask(cand, K, state.device)) & state.kf_valid
    pts_mask = map_ops.points_of_keyframes(state, loop_kfs) & state.mp_valid
    return torch.sum(pts_mask), loop_kfs


def loop_points_projection_gate(state: MapState, kf_cur: int, cand: int, R, t, s, feat_matched,
                                cam: Camera, scale_factors, loop_kfs, n_pts_bucket: int = 4096):
    """The final acceptance gate: project the loop group's points through
    Scw = S_cm o T_mw into the current keyframe (th=10, TH_LOW, view cos
    0.5) and count matched features. kf_cur, cand: slots (ints or slot
    tensors). Returns (n_total, point_match (N,) point id per
    current-keyframe feature or -1)."""
    P = state.mp_xyz.shape[0]
    dev = state.device
    pts = local_mapping.nonzero_fixed(map_ops.points_of_keyframes(state, loop_kfs) & state.mp_valid,
                                      min(n_pts_bucket, P))
    pv = pts >= 0
    pc = torch.clamp(pts, min=0)
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=dev)
    S_cw = sim3.compose((R, t, s), sim3.from_se3(_row(state.kf_pose, cand)))
    Rc, tc, sc = S_cw
    Ow = -(Rc.transpose(-1, -2) @ (tc / sc)[..., None])[..., 0]
    X = state.mp_xyz[pc]
    vec = X - Ow[None, :]
    dist_w = torch.linalg.norm(vec, dim=-1)
    view_cos = torch.sum(vec * state.mp_normal[pc], dim=-1) / torch.clamp(dist_w, min=1e-9)
    y = sim3.transform(S_cw, X)
    z_ok = y[:, 2] > 1e-6
    z = torch.where(z_ok, y[:, 2], torch.ones_like(y[:, 2]))
    u = cam.fx * y[:, 0] / z + cam.cx
    v = cam.fy * y[:, 1] / z + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    band = (dist_w >= 0.8 * state.mp_min_dist[pc]) & (dist_w <= 1.2 * state.mp_max_dist[pc])
    pred = search.predict_octave(dist_w, state.mp_max_dist[pc], torch.log(sf[1]), sf.shape[0])

    # Points already matched by the Sim3 stage are skipped, their features taken.
    mp2 = _row(state.kf_mp, cand)
    feat_matched = feat_matched.long()
    fm_ok = feat_matched >= 0
    matched_pts = torch.where(fm_ok, mp2[torch.clamp(feat_matched, min=0)].long(),
                              torch.full_like(feat_matched, -1))
    already_pt = map_ops.mark(P, torch.clamp(matched_pts, min=0), matched_pts >= 0)
    q_valid = pv & z_ok & in_img & band & (view_cos > 0.5) & ~already_pt[pc]
    N = mp2.shape[0]
    feat_taken = map_ops.mark(N, torch.clamp(feat_matched, min=0), fm_ok)
    m = search.by_projection(
        torch.stack([u, v], dim=-1), hamming.bipolar(state.mp_desc[pc]), q_valid, pred,
        _row(state.kf_uv, kf_cur), _row(state.kf_oct, kf_cur), torch.zeros((N,), dtype=torch.float32, device=dev),
        hamming.bipolar(_row(state.kf_desc, kf_cur)), _row(state.kf_feat_valid, kf_cur),
        sf, radius=10.0, max_dist=50.0, ratio=1.0, octave_lo_off=-1, octave_hi_off=1,
        check_rotation=False, t_has_point=feat_taken,
    )
    point_match = tracking._bind(N, m.idx, pts, m.idx >= 0).long()
    point_match = torch.where(fm_ok, torch.where(matched_pts >= 0, matched_pts, point_match), point_match)
    return torch.sum(point_match >= 0), point_match


def essential_graph_solve(state: MapState, pose_before, ei, ej, loop_pos, S_loop, cand, edge_valid=None):
    """The essential graph's Sim3 pose graph: vertices start at the current
    poses, measurements come from the pre-correction poses `pose_before`,
    the edge at `loop_pos` (a 0-d tensor) takes the loop's `S_loop`, `cand`
    (a slot tensor) is held fixed with the invalid keyframes. `edge_valid`
    (default all) marks the real edges of a padded list: the padded ones
    get the identity as their measurement and leave the solve's bits as
    they are. Points follow their reference keyframe. Reads nothing back
    (the loop closer runs it as the program `essential_graph`). Returns
    (kf_pose, mp_xyz)."""
    K = state.kf_valid.shape[0]
    dev = state.device
    if edge_valid is None:
        edge_valid = torch.ones(ei.shape, dtype=torch.bool, device=dev)
    ones_k = torch.ones((K,), dtype=torch.float32, device=dev)
    Rm, tm = pose_before[:, :3, :3], pose_before[:, :3, 3]
    mR, mt, ms = pose_graph.relative_sim3((Rm[ei], tm[ei], ones_k[ei]), (Rm[ej], tm[ej], ones_k[ej]))
    at = torch.arange(ei.shape[0], device=dev) == loop_pos
    mR = torch.where(at[:, None, None], S_loop[0], mR)
    mt = torch.where(at[:, None], S_loop[1], mt)
    ms = torch.where(at, S_loop[2], ms)
    eye_R, eye_t, eye_s = sim3.identity(dtype=torch.float32, device=dev)
    mR = torch.where(edge_valid[:, None, None], mR, eye_R)
    mt = torch.where(edge_valid[:, None], mt, eye_t)
    ms = torch.where(edge_valid, ms, eye_s)
    problem = pose_graph.PoseGraphProblem(
        vert_R=state.kf_pose[:, :3, :3], vert_t=state.kf_pose[:, :3, 3], vert_s=ones_k,
        vert_fixed=slot_mask(cand, K, dev) | ~state.kf_valid, edge_i=ei, edge_j=ej,
        meas_R=mR, meas_t=mt, meas_s=ms, edge_valid=edge_valid,
    )
    R_opt, t_opt, s_opt = pose_graph.optimize_pose_graph(problem, gn_iters=15, cg_iters=30)

    ref = torch.clamp(state.mp_ref_kf, min=0).long()
    old = state.kf_pose[ref]
    p_cam = sim3.transform((old[:, :3, :3], old[:, :3, 3], torch.ones_like(state.mp_xyz[:, 0])),
                           state.mp_xyz)
    p_new = sim3.transform(sim3.inverse((R_opt[ref], t_opt[ref], s_opt[ref])), p_cam)
    new_xyz = torch.where(state.mp_valid[:, None], p_new, state.mp_xyz)
    new_pose = sim3.to_se3((R_opt, t_opt, s_opt))
    return torch.where(state.kf_valid[:, None, None], new_pose, state.kf_pose), new_xyz


def essential_graph_edges(kf_valid, covis_pre, kf_order, loop_edges, loop_pair):
    """The essential graph's sorted, deduplicated (i < j) edge list as two
    (E,) int64 tensors: covisibility pairs of weight >= 100, the kf_order
    chain, past loop edges and this loop's edge, all between valid
    keyframes (this loop's edge always)."""
    K = kf_valid.shape[0]
    dev = kf_valid.device

    def codes(a, b, ok):
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        return (lo * K + hi)[ok]

    strong = torch.triu(covis_pre >= COVIS_EDGE_MIN_WEIGHT, diagonal=1)
    strong &= kf_valid[:, None] & kf_valid[None, :]
    sa, sb = torch.nonzero(strong, as_tuple=True)
    ko = torch.as_tensor(kf_order, dtype=torch.int64, device=dev)
    la = torch.as_tensor([a for a, _ in loop_edges], dtype=torch.int64, device=dev)
    lb = torch.as_tensor([b for _, b in loop_edges], dtype=torch.int64, device=dev)
    this = torch.as_tensor(loop_pair, dtype=torch.int64, device=dev)
    all_codes = torch.cat([
        codes(ko[:-1], ko[1:], kf_valid[ko[:-1]] & kf_valid[ko[1:]]),
        codes(sa, sb, torch.ones_like(sa, dtype=torch.bool)),
        codes(la, lb, kf_valid[la] & kf_valid[lb]),
        codes(this[:1], this[1:], torch.ones((1,), dtype=torch.bool, device=dev)),
    ])
    edges = torch.unique(all_codes, sorted=True)
    return edges // K, edges % K


def pad_edges(ei, ej, K: int):
    """The edge list padded with (0, 0) edges to its program's bucket, the
    smallest power of two >= E from EDGE_BUCKET_MIN up: (ei, ej, valid),
    valid False on the padding."""
    E = ei.shape[0]
    most = 1 << max(0, K * (K - 1) // 2 - 1).bit_length()  # a power of two >= K(K-1)/2, the most edges
    bucket = pow2_bucket(E, EDGE_BUCKET_MIN, max(EDGE_BUCKET_MIN, most))
    pad = torch.zeros((bucket - E,), dtype=ei.dtype, device=ei.device)
    valid = torch.arange(bucket, device=ei.device) < E
    return torch.cat([ei, pad]), torch.cat([ej, pad]), valid


class LoopCloser:
    """DetectLoop -> ComputeSim3 -> CorrectLoop -> global BA at keyframe
    rate. `sampler(site, seed, valid)` gives the Sim3 RANSAC minimal sets,
    seeded with kf_slot * 131 + candidate (default:
    `initializer.default_sampler`). `timer`, if enabled, times the steps
    of a loop closure in timesMapping.csv: `loop_sim3` (the candidates'
    verification) and `loop_correct`, which holds `loop_fuse` and
    `loop_pose_graph`. `mesh` (parallel/mesh.Mesh) distributes the
    global BA over its process group."""

    GBA_TOTAL_ITERS = 10
    GBA_CHUNK_ITERS = 3

    def __init__(self, cfg: MapConfig, cam: Camera, vocab, fix_scale: bool = False,
                 run_global_ba: bool = True, sampler=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.cam = cam
        self.vocab = vocab
        self.fix_scale = fix_scale
        self.run_global_ba = run_global_ba
        self.sampler = sampler or default_sampler
        self.consistent_groups: List[Tuple[set, int]] = []
        # Keyframe-insertion clock for the recent-loop cooldown (culling
        # shrinks kf_order, so its length is not a clock).
        self.kf_seen: int = 0
        self.last_loop_kf_seen: int = -(10**9)
        self.n_loops_closed = 0
        # Every past loop's (a, b) pair joins every later essential graph.
        self.loop_edges: List[Tuple[int, int]] = []
        # GBA generation: each accepted loop bumps it; a pending global BA
        # whose captured index no longer matches was superseded.
        self.gba_idx = 0
        self.gba_requested = False
        self.timer = StageTimer(enabled=False)
        # Device programs (engine/programs.py): the per-keyframe detection
        # and a global-BA chunk without a mesh.
        self._detect_fn = programs.Program(self._detect_program, "loop_detect")
        self._chunk_fn = programs.Program(self._chunk_program, "gba_chunk")
        # The Sim3 stage of a candidate, one program a host decision: the BoW
        # match (eager in the JAX package), then as the JAX package jits them
        # RANSAC, the refinement and the projection gate. The refinement's
        # capture takes seconds, more than an eager call, so a key is
        # captured at its second call: a path that refines once (stereo)
        # never pays it.
        self._match_fn = programs.Program(self._match_program, "sim3_match")
        self._ransac_fn = programs.Program(self._ransac_program, "sim3_ransac")
        self._refine_fn = programs.Program(self._refine_program, "sim3_refine", capture_at=2)
        self._gate_fn = programs.Program(self._gate_program, "loop_gate")
        # The essential-graph solve and the point update after it, as the JAX
        # package jits optimize_pose_graph, keyed on the map's capacity and
        # the edge count's bucket (`pad_edges`).
        self._pose_graph_fn = programs.Program(essential_graph_solve, "essential_graph",
                                               capture_at=ESSENTIAL_GRAPH_CAPTURE_AT)
        self.programs = (self._detect_fn, self._chunk_fn, self._match_fn, self._ransac_fn, self._refine_fn,
                         self._gate_fn, self._pose_graph_fn)
        # Candidates through each stage of _compute_sim3: `match` (every
        # candidate), `ransac` (enough pairs), `refine` (RANSAC ok), `gate`
        # (refined inliers enough), `accepted`.
        self.sim3_counts = dict(match=0, ransac=0, refine=0, gate=0, accepted=0)
        self._tables = {}

    def _stage(self, name: str, state: MapState):
        return self.timer.stage("timesMapping.csv", name, sync=state.device)

    @property
    def scale_factors(self):
        return tuple(self.cfg.scale_factors)

    # ------------------------------------------------------------------
    def process(self, state: MapState, db, kf_slot: int, kf_order: List[int]):
        """Detection, verification, correction and global BA for one new
        keyframe, back to back (the synchronous form)."""
        pending = self.dispatch_detect(state, db, kf_slot, kf_order)
        if pending is None:
            return state, db
        state, db = self.finish_detect(state, db, pending, kf_order)
        if self.gba_requested:
            self.gba_requested = False
            gba = self.dispatch_global_ba(state, kf_order)
            while not self.continue_global_ba(gba):
                pass
            state = self.finish_global_ba(state, gba, kf_order)
        return state, db

    def _detect_program(self, state: MapState, db, slot):
        q, _, covis, neigh, min_score = _bow_scores_vs_neighbors(db, state, slot, self.vocab.n_words)
        exclude = neigh | slot_mask(slot, neigh.shape[0], neigh.device)
        cand_mask, _ = keyframe_db.detect_candidates(db, q, exclude, covis, min_score=min_score)
        return cand_mask, covis

    def _candidates(self, state: MapState, db, kf_slot: int):
        """(candidate mask, fresh covisibility) of one keyframe, queued as
        the detection program; the consistency chain reads them."""
        return self._detect_fn(state, db, torch.full((), int(kf_slot), dtype=torch.int64, device=state.device))

    def dispatch_detect(self, state: MapState, db, kf_slot: int, kf_order: List[int]):
        """BoW candidate retrieval for a new keyframe; None when detection
        is skipped (map under 10 keyframes, or within 10 keyframes of the
        last loop)."""
        self.kf_seen += 1
        if len(kf_order) < 10 or self.kf_seen - self.last_loop_kf_seen < 10:
            # Consistency needs consecutive detections: a skipped round
            # breaks every chain.
            self.consistent_groups = []
            return None
        cand_mask, covis = self._candidates(state, db, kf_slot)
        return kf_slot, cand_mask, covis

    def finish_detect(self, state: MapState, db, pending, kf_order: List[int]):
        """Consistency chaining and, on a consistent hit, verification and
        loop correction."""
        kf_slot, cand_mask, covis = pending
        cands = self._consistency_chain(cand_mask, covis)
        if not cands:
            return state, db
        with self._stage("loop_sim3", state):
            hit = self._compute_sim3(state, kf_slot, cands)
        if hit is None:
            return state, db
        cand_kf, S_cm, _ = hit
        with self._stage("loop_correct", state):
            state = self._correct_loop(state, kf_slot, cand_kf, S_cm, kf_order)
        self.loop_edges.append((min(kf_slot, cand_kf), max(kf_slot, cand_kf)))
        self.last_loop_kf_seen = self.kf_seen
        self.n_loops_closed += 1
        self.consistent_groups = []
        # Supersede any in-flight global BA and ask for a fresh one.
        self.gba_idx += 1
        self.gba_requested = self.run_global_ba
        return state, db

    def _detect(self, state: MapState, db, kf_slot: int) -> List[int]:
        """Detection and consistency chaining back to back."""
        return self._consistency_chain(*self._candidates(state, db, kf_slot))

    def _consistency_chain(self, cand_mask, covis) -> List[int]:
        """A candidate's covisibility group must recur in CONSISTENCY_TH
        consecutive detections."""
        cand_ids = np.flatnonzero(cand_mask.cpu().numpy())
        if len(cand_ids) == 0:
            self.consistent_groups = []
            return []
        covis_rows = covis[torch.as_tensor(cand_ids, device=covis.device)].cpu().numpy()
        enough: List[int] = []
        new_groups: List[Tuple[set, int]] = []
        for row, c in enumerate(cand_ids):
            group = set(np.flatnonzero(covis_rows[row] > 0).tolist()) | {int(c)}
            best_count = 0
            matched_any = False
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    matched_any = True
                    best_count = max(best_count, count + 1)
            new_groups.append((group, best_count))
            if best_count >= CONSISTENCY_TH:
                enough.append(int(c))
            if not matched_any:
                new_groups[-1] = (group, 0)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    def _level_tables(self, device):
        """(sigma^2, scale factor) per level as float32 tensors on `device`,
        made once: program inputs, never host data copied inside one."""
        key = str(device)
        if key not in self._tables:
            self._tables[key] = tuple(torch.as_tensor(np.asarray(v, np.float32), device=device)
                                      for v in (self.cfg.level_sigma2, self.cfg.scale_factors))
        return self._tables[key]

    @staticmethod
    def _match_program(state: MapState, kf1, cand, sig2):
        pairs = sim3_pairs(state, kf1, cand, sig2)
        return torch.sum(pairs[1]), pairs

    def _ransac_program(self, pairs, sets):
        return sim3_candidate_ransac(pairs, sets, self.cam, self.fix_scale)

    def _refine_program(self, state: MapState, kf1, cand, R, t, s, prior_feat, sf):
        R_r, t_r, s_r, n_in, feat12 = sim3_search_and_refine(state, kf1, cand, R, t, s, prior_feat, self.cam, sf,
                                                             fix_scale=self.fix_scale)
        # The loop group's point count joins the refinement's read: the host
        # sizes the projection gate with it.
        n_grp, loop_kfs = loop_group_point_count(state, cand)
        return torch.stack([n_in.long(), n_grp.long()]), R_r, t_r, s_r, feat12, loop_kfs

    def _gate_program(self, state: MapState, kf1, cand, R, t, s, feat12, loop_kfs, sf, bucket: int):
        return loop_points_projection_gate(state, kf1, cand, R, t, s, feat12, self.cam, sf, loop_kfs,
                                           n_pts_bucket=bucket)

    @staticmethod
    def _read(t):
        """One packed host decision: the copy queued, then waited for."""
        host, event = programs.read_async(t)
        if event is not None:
            event.synchronize()
        return host.tolist()

    def _compute_sim3(self, state: MapState, kf_slot: int, cands: List[int]):
        """Per candidate: BoW matching of the two keyframes' points
        (`sim3_match`, >= 20 pairs), Sim3 RANSAC (`sim3_ransac`, >= 20
        inliers), SearchBySim3 + OptimizeSim3 (`sim3_refine`, >= 20
        inliers), then the loop-group projection gate (`loop_gate`, >= 40
        matches), each a program with one packed read after it. Returns
        (cand, S_cm, point_match) for the first candidate through, else
        None."""
        dev = state.device
        sig2, sf = self._level_tables(dev)
        kf_t = slot_index(kf_slot, dev)
        for cand in cands:
            slots = (kf_t, slot_index(cand, dev))
            self.sim3_counts["match"] += 1
            n_pairs, pairs = self._match_fn(state, *slots, sig2)
            if self._read(n_pairs) < MIN_SIM3_INLIERS:
                continue
            self.sim3_counts["ransac"] += 1
            # The minimal sets on the pairs' device (the default sampler masks
            # host-drawn keys there: nothing is read back).
            sets = torch.as_tensor(self.sampler("sim3", int(kf_slot) * 131 + int(cand), pairs[1]),
                                   device=dev).long()
            packed, R, t, s, prior_feat = self._ransac_fn(pairs, sets)
            if not self._read(packed)[1]:
                continue
            self.sim3_counts["refine"] += 1
            packed, R_r, t_r, s_r, feat12, loop_kfs = self._refine_fn(state, *slots, R, t, s, prior_feat, sf)
            n_in, n_grp = self._read(packed)
            if n_in < MIN_OPT_INLIERS:
                continue
            self.sim3_counts["gate"] += 1
            bucket = pow2_bucket(n_grp, 4096, self.cfg.max_points)
            n_total, point_match = self._gate_fn(state, *slots, R_r, t_r, s_r, feat12, loop_kfs, sf, bucket)
            if self._read(n_total) < MIN_TOTAL_MATCHES:
                continue
            self.sim3_counts["accepted"] += 1
            return cand, (R_r, t_r, s_r), point_match  # S_cm: cand frame -> current frame
        return None

    # ------------------------------------------------------------------
    def _correct_loop(self, state: MapState, kf_slot: int, cand: int, S_cm,
                      kf_order: List[int]) -> MapState:
        """CorrectLoop: propagate the corrected Sim3 to the current
        covisibility group, rewrite its points, fuse the loop side's points
        into it, then optimize the essential graph. Global BA is requested
        by finish_detect, not run here."""
        dev = state.device
        covis = map_ops.covisibility_matrix(state)  # fresh
        rows = covis[torch.as_tensor([kf_slot, cand], device=dev)].cpu().numpy()
        # Edge measurements come from the pre-correction poses.
        pose_before = state.kf_pose
        S_corr_cw = sim3.compose(S_cm, sim3.from_se3(state.kf_pose[cand]))

        kf_valid = state.kf_valid.cpu().numpy()
        group = set(np.flatnonzero(rows[0] > 0).tolist()) | {kf_slot}
        group = [g for g in group if kf_valid[g]]
        G = torch.as_tensor(group, dtype=torch.int64, device=dev)
        T_g = state.kf_pose[G]
        corrected = sim3.compose(sim3.from_se3(T_g @ se3.inverse(state.kf_pose[kf_slot])), S_corr_cw)

        # Rewrite the group's points p' = S_new^-1(S_old(p)); a point seen
        # by several group keyframes follows the first in group order.
        P = self.cfg.max_points
        N = state.kf_mp.shape[1]
        row_mp = state.kf_mp[G].long()
        pos = torch.arange(len(group), device=dev)[:, None].expand(-1, N)
        bound = row_mp >= 0
        owner = torch.full((P + 1,), len(group), dtype=torch.int64, device=dev).scatter_reduce(
            0, torch.where(bound, row_mp, torch.full_like(row_mp, P)).reshape(-1),
            torch.where(bound, pos, torch.full_like(pos, len(group))).reshape(-1),
            reduce="amin", include_self=True)[:P]
        owned = owner < len(group)
        o = torch.clamp(owner, max=len(group) - 1)
        p_cam = torch.einsum("pij,pj->pi", T_g[o][:, :3, :3], state.mp_xyz) + T_g[o][:, :3, 3]
        Rn, tn, sn = sim3.inverse(tuple(c[o] for c in corrected))
        p_new = sn[:, None] * torch.einsum("pij,pj->pi", Rn, p_cam) + tn
        state = state._replace(mp_xyz=torch.where(owned[:, None], p_new, state.mp_xyz))
        kf_pose = state.kf_pose.clone()
        kf_pose[G] = sim3.to_se3(corrected)
        state = state._replace(kf_pose=kf_pose)

        # SearchAndFuse: the loop side's points into the corrected group.
        loop_group = set(np.flatnonzero(rows[1] > 0).tolist()) | {cand}
        loop_mask = map_ops.mark(state.kf_valid.shape[0],
                                 torch.as_tensor(sorted(loop_group), device=dev),
                                 torch.ones((len(loop_group),), dtype=torch.bool, device=dev))
        loop_pts_mask = map_ops.points_of_keyframes(state, loop_mask)
        bucket = pow2_bucket(int(torch.sum(loop_pts_mask)), 4096, P)
        loop_pts = local_mapping.nonzero_fixed(loop_pts_mask, bucket)
        with self._stage("loop_fuse", state):
            for g in group:
                m = local_mapping.fuse_into_keyframe(state, loop_pts, g, self.cam, self.scale_factors)
                state = local_mapping.apply_fusion(state, g, loop_pts, m.idx)
            state = map_ops.update_point_stats(state, self.cfg)
            state = map_ops.refresh_covis_rows(state, torch.as_tensor(sorted(group), device=dev))
        with self._stage("loop_pose_graph", state):
            return self._optimize_essential_graph(state, kf_slot, cand, S_cm, kf_order, covis, pose_before)

    def _optimize_essential_graph(self, state: MapState, kf_slot: int, cand: int, S_cm,
                                  kf_order, covis_pre, pose_before) -> MapState:
        """Sim3 pose graph over the essential graph; vertices start at the
        current poses, measurements come from the pre-correction poses
        (the loop edge from the solver); points follow their reference
        keyframe."""
        K = state.kf_valid.shape[0]
        dev = state.device
        loop_pair = (min(kf_slot, cand), max(kf_slot, cand))
        ei, ej = essential_graph_edges(state.kf_valid, covis_pre, kf_order, self.loop_edges, loop_pair)
        loop_pos = torch.searchsorted(ei * K + ej, loop_pair[0] * K + loop_pair[1])
        ei, ej, valid = pad_edges(ei, ej, K)
        # S_cm maps cand -> current: the measurement S_ji when i = cand.
        S_loop = S_cm if loop_pair[0] == cand else sim3.inverse(S_cm)
        kf_pose, mp_xyz = self._pose_graph_fn(
            state, pose_before, ei, ej, loop_pos, tuple(S_loop),
            torch.full((), int(cand), dtype=torch.int64, device=dev), valid)
        return state._replace(kf_pose=kf_pose, mp_xyz=mp_xyz)

    # ------------------------------------------------------------------
    # Global BA: GBA_TOTAL_ITERS LM iterations in chunks of GBA_CHUNK_ITERS,
    # so a superseding loop aborts between chunks and frames interleave.
    def _chunk_program(self, problem, lm_iters: int):
        return ba.bundle_adjust(problem, self.cam, lm_iters=lm_iters, cg_iters=20)

    def _solve_chunk(self, problem, lm_iters):
        if self.mesh is not None:
            from ..parallel import distributed_bundle_adjust

            res = distributed_bundle_adjust(problem, self.cam, self.mesh, lm_iters=lm_iters, cg_iters=20)
            return ba.BAResult(*(x.to(problem.xyz.device) for x in res))
        return self._chunk_fn(problem, lm_iters)

    def global_ba_problem(self, state: MapState, kf_order):
        """The whole-map BA over the live keyframes (padded to a power-of-two
        count, the first keyframe fixed). Returns (problem, camera slots)."""
        C = max(8, 1 << max(0, len(kf_order) - 1).bit_length())
        cam_arr = np.full(C, -1, np.int64)
        cam_arr[: len(kf_order)] = kf_order
        inv_sig = (1.0 / torch.as_tensor(self.cfg.level_sigma2, dtype=torch.float32)).tolist()
        problem, _, _ = gather_global_ba_problem(
            state, torch.as_tensor(cam_arr, device=state.device), kf_order[0], inv_sig)
        return problem, cam_arr

    def dispatch_global_ba(self, state: MapState, kf_order, kf_gen=None, mp_valid_host=None):
        """Gather the whole-map BA over the live keyframes (padded to a
        power-of-two count, the first keyframe fixed) and run its first
        chunk. kf_gen / mp_valid_host snapshots let finish_global_ba
        recognize slots recycled meanwhile."""
        problem, cam_arr = self.global_ba_problem(state, kf_order)
        chunk = min(self.GBA_CHUNK_ITERS, self.GBA_TOTAL_ITERS)
        return GBAPending(
            idx=self.gba_idx, result=self._solve_chunk(problem, chunk), kfs=list(kf_order),
            problem=problem, iters_done=chunk, cam_slots=cam_arr,
            kf_gen_snap=None if kf_gen is None else np.asarray(kf_gen).copy(),
            pt_snap=None if mp_valid_host is None else np.asarray(mp_valid_host).copy(),
        )

    def continue_global_ba(self, pending: GBAPending) -> bool:
        """Run one more chunk, warm-started from the last; True when the
        solve is complete, or superseded (then nothing more is solved)."""
        if pending.idx != self.gba_idx:
            return True
        remaining = self.GBA_TOTAL_ITERS - pending.iters_done
        if remaining <= 0:
            return True
        chunk = min(self.GBA_CHUNK_ITERS, remaining)
        r = pending.result
        pending.problem = pending.problem._replace(cam_pose=r.cam_pose, xyz=r.xyz)
        pending.result = self._solve_chunk(pending.problem, chunk)
        pending.iters_done += chunk
        return pending.iters_done >= self.GBA_TOTAL_ITERS

    def finish_global_ba(self, state: MapState, pending: GBAPending, kf_order,
                         kf_gen=None, mp_valid_host=None) -> MapState:
        """Apply a finished global BA unless superseded. Keyframes of the
        solve whose slot generation is unchanged take their GBA pose;
        keyframes created since chain off their predecessor in insertion
        order; points of the solve take their optimized positions, newer
        ones re-anchor through their reference keyframe."""
        if pending.idx != self.gba_idx:
            return state
        K = state.kf_valid.shape[0]
        P = state.mp_valid.shape[0]
        dev = state.device
        in_solve = set(pending.kfs)
        check_gen = kf_gen is not None and pending.kf_gen_snap is not None
        kf_apply = np.zeros(K, bool)
        chain = []
        prev = None
        for s in kf_order:
            if s in in_solve and (not check_gen or int(kf_gen[s]) == int(pending.kf_gen_snap[s])):
                kf_apply[s] = True
            elif prev is not None:
                chain.append((s, prev))
            prev = s
        if pending.pt_snap is not None and mp_valid_host is not None:
            pt_apply = pending.pt_snap & np.asarray(mp_valid_host)
        else:
            pt_apply = np.ones(P, bool)
        gba_pose = _expand_gba_poses(state.kf_pose, pending.result.cam_pose,
                                     torch.as_tensor(pending.cam_slots, device=dev))
        return _apply_gba(state, gba_pose, pending.result.xyz, torch.as_tensor(kf_apply, device=dev),
                          torch.as_tensor(pt_apply, device=dev), chain)


def _expand_gba_poses(kf_pose_full, cam_pose_c, cam_slots):
    """Scatter compacted GBA camera poses onto the (K,4,4) slot table;
    padding goes to a trash row."""
    K = kf_pose_full.shape[0]
    out = torch.cat([kf_pose_full, kf_pose_full.new_zeros((1, 4, 4))])
    out[torch.where(cam_slots >= 0, cam_slots, torch.full_like(cam_slots, K))] = cam_pose_c
    return out[:K]


def gather_global_ba_problem(state: MapState, cam_slots, fixed_slot, level_inv_sigma2):
    """Whole-map BA over the live keyframes `cam_slots` ((C,) -1 padded),
    `fixed_slot` pinned for gauge, every valid point, the (C,N)
    observation rows as edges. Returns (problem, cam_slots, pt_slots)."""
    C = cam_slots.shape[0]
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    dev = state.device
    safe_cam = torch.clamp(cam_slots, min=0).long()
    cam_ok = (cam_slots >= 0) & state.kf_valid[safe_cam]
    rows_mp = state.kf_mp[safe_cam]
    rows_valid = (rows_mp >= 0) & cam_ok[:, None] & state.kf_feat_valid[safe_cam]
    inv_sig = torch.as_tensor(level_inv_sigma2, dtype=torch.float32, device=dev)
    obs_isig = inv_sig[torch.clamp(state.kf_oct[safe_cam].long(), 0, inv_sig.shape[0] - 1)]
    problem = ba.BAProblem(
        cam_pose=state.kf_pose[safe_cam],
        cam_fixed=~cam_ok | (cam_slots == fixed_slot),
        xyz=state.mp_xyz,
        pt_valid=state.mp_valid,
        obs_cam=torch.arange(C, dtype=torch.int64, device=dev)[:, None].expand(C, N).reshape(-1),
        obs_pt=torch.where(rows_valid, rows_mp, torch.full_like(rows_mp, -1)).reshape(-1),
        obs_uv=state.kf_uv[safe_cam].reshape(-1, 2),
        obs_ur=torch.where(rows_valid, state.kf_right[safe_cam],
                           torch.full_like(state.kf_right[safe_cam], -1.0)).reshape(-1),
        obs_inv_sigma2=obs_isig.reshape(-1),
        obs_valid=rows_valid.reshape(-1),
    )
    return problem, cam_slots, torch.arange(P, dtype=torch.int64, device=dev)
