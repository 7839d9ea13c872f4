"""Local mapping: triangulation, fusion, local BA, culling (torch port of
the monocular parts of orb_slam_cuda_tpu/engine/local_mapping.py).

The reference's `lax.scan`s over neighbours are Python loops over a fixed
number of entries of the -1-padded neighbour tensor, an absent neighbour
masked out as the scan masks it; nothing reads a value back between the
mapper's programs (see LocalMapper). Keyframe slots may be Python ints or
slot tensors. Scatters that the reference pads onto index 0 (or a
sentinel with mode='drop') write into a trash row instead.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import camera as cam_mod
from ..geometry import se3, triangulate
from ..geometry.camera import Camera
from ..matching import search
from ..ops import hamming
from ..ops.segsum import last_writes
from ..slam_map import MapConfig, MapState, keyframe_db
from ..slam_map import ops as map_ops
from ..slam_map import state as mstate
from ..solvers import bundle_adjust as ba
from ..utils.device import resolve as resolve_device
from . import programs


class PendingMapping:
    """In-flight mapping work for one keyframe: the dispatch program's
    outputs, the packed vector that finish_keyframe reads back once (its
    copy into pinned host memory is queued at dispatch), and the host
    context to interpret it."""

    __slots__ = (
        "kf_slot", "packed_host", "packed_copied", "n_cull", "has_reds",
        "slot_matrix", "probation_ids", "born", "cur",
        "problem", "result1", "cam_slots", "pt_slots",
        "aborted", "ba2_done",
    )

    def __init__(self, **kw):
        self.aborted = False
        self.ba2_done = False
        for k, v in kw.items():
            setattr(self, k, v)


class TriangulationResult(NamedTuple):
    xyz: torch.Tensor  # (N,3) candidate points (world)
    ok: torch.Tensor  # (N,) bool
    feat_new: torch.Tensor  # (N,) feature idx in the new KF
    feat_nb: torch.Tensor  # (N,) matched feature idx in the neighbour


def _tab(values, device):
    """A float32 table on `device`; a tensor (the mapper makes its tables
    once) is not copied."""
    if torch.is_tensor(values):
        return values.to(device=device, dtype=torch.float32)
    return torch.as_tensor(values, dtype=torch.float32, device=device)


_slot = mstate.slot_index


def _row(x, slot):
    """x[slot] for a (1,) slot index."""
    return x[slot][0]


def nonzero_fixed(mask, size: int):
    """First `size` indices where the 1-D mask is True, in increasing
    order, -1 padded (the reference's `nonzero(size=..., fill_value=-1)`,
    torch.nonzero's first `size`). The count is never read back: a cumsum
    ranks the True entries and a scatter writes the first `size` of them
    (the rest into a trash slot)."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    pos = torch.where(mask & (rank < size), rank, torch.full_like(rank, size))
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=mask.device)
    return out.scatter_(0, pos, torch.arange(n, dtype=torch.int64, device=mask.device))[:size]


def _masked(ok, new: MapState, old: MapState) -> MapState:
    """`new` where the 0-d `ok`, else `old`, bit for bit: fields that `new`
    shares with `old` stay shared."""
    return old._replace(**{f: torch.where(ok, a, b) for f, a, b in zip(MapState._fields, new, old) if a is not b})


def triangulate_with_neighbor(state: MapState, kf_new, kf_nb, cam: Camera,
                              scale_factors, level_sigma2) -> TriangulationResult:
    """Epipolar-matched two-view triangulation between the new keyframe
    and one covisibility neighbour (CreateNewMapPoints inner loop). The
    slots are ints or slot tensors."""
    dev = state.device
    s1, s2 = _slot(kf_new, dev), _slot(kf_nb, dev)
    K = cam.K_on(dev)
    T1 = _row(state.kf_pose, s1)
    T2 = _row(state.kf_pose, s2)
    F12 = triangulate.fundamental_from_poses(K, T1, K, T2)
    mp1 = _row(state.kf_mp, s1)
    mp2 = _row(state.kf_mp, s2)
    has1 = (mp1 >= 0) & state.mp_valid[torch.clamp(mp1, min=0).long()]
    has2 = (mp2 >= 0) & state.mp_valid[torch.clamp(mp2, min=0).long()]

    C1w = -T1[:3, :3].T @ T1[:3, 3]
    C1_in_2 = T2[:3, :3] @ C1w + T2[:3, 3]
    epipole2 = cam_mod.project(cam, C1_in_2[None, :])[0]

    sf = _tab(scale_factors, dev)
    sig2 = _tab(level_sigma2, dev)
    uv1, uv2 = _row(state.kf_uv, s1), _row(state.kf_uv, s2)
    oct1_raw, oct2_raw = _row(state.kf_oct, s1), _row(state.kf_oct, s2)
    m = search.for_triangulation(
        _row(state.kf_node, s1), hamming.bipolar(_row(state.kf_desc, s1)), _row(state.kf_feat_valid, s1),
        _row(state.kf_ang, s1), uv1, oct1_raw,
        _row(state.kf_node, s2), hamming.bipolar(_row(state.kf_desc, s2)), _row(state.kf_feat_valid, s2),
        _row(state.kf_ang, s2), uv2, oct2_raw,
        F12, sig2, epipole_uv=epipole2, scale_factors=sf,
        f1_has_point=has1, f2_has_point=has2,
    )
    ok = m.idx >= 0
    j = torch.clamp(m.idx, min=0)
    xy1 = uv1
    xy2 = uv2[j]
    X = triangulate.triangulate_dlt(
        triangulate.projection_matrix(K, T1), triangulate.projection_matrix(K, T2), xy1, xy2
    )
    z1, z2, cosp = triangulate.cheirality_and_parallax(X, T1, T2)

    def reproj_err(T, xy):
        uv = cam_mod.project(cam, se3.transform(T, X))
        return torch.sum((uv - xy) ** 2, dim=-1)

    L = sig2.shape[0]
    oct1 = torch.clamp(oct1_raw.long(), 0, L - 1)
    oct2 = torch.clamp(oct2_raw[j].long(), 0, L - 1)
    e1 = reproj_err(T1, xy1) / sig2[oct1]
    e2 = reproj_err(T2, xy2) / sig2[oct2]

    C2w = -T2[:3, :3].T @ T2[:3, 3]
    d1 = torch.linalg.norm(X - C1w[None, :], dim=-1)
    d2 = torch.linalg.norm(X - C2w[None, :], dim=-1)
    ratio_dist = d1 / torch.clamp(d2, min=1e-9)
    ratio_oct = sf[oct1] / sf[oct2]
    ratio_factor = 1.5 * sf[1]
    scale_ok = (ratio_dist < ratio_oct * ratio_factor) & (ratio_dist * ratio_factor > ratio_oct)

    finite = torch.all(torch.isfinite(X), dim=-1)
    good = (
        ok & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.9998)
        & (e1 < 5.991) & (e2 < 5.991) & scale_ok
    )
    feat_new = torch.arange(X.shape[0], dtype=torch.int64, device=dev)
    return TriangulationResult(xyz=X, ok=good, feat_new=feat_new, feat_nb=m.idx)


def insert_triangulated(state: MapState, tri: TriangulationResult, slots, kf_new,
                        kf_nb, max_new: int = 256):
    """Write up to `max_new` triangulated points into preallocated slots."""
    dev = state.device
    s_new = _slot(kf_new, dev)
    sel = nonzero_fixed(tri.ok, max_new)
    valid = sel >= 0
    sel_c = torch.clamp(sel, min=0)
    slots = torch.as_tensor(slots, device=dev).long()
    kf_new_t = s_new.to(torch.int32).expand(max_new)
    state = mstate.add_points(
        state, slots, tri.xyz[sel_c], valid, _row(state.kf_desc, s_new)[sel_c],
        torch.zeros((max_new, 3), dtype=torch.float32, device=dev),
        torch.zeros((max_new,), dtype=torch.float32, device=dev),
        torch.full((max_new,), 1e9, dtype=torch.float32, device=dev),
        kf_new_t, kf_new_t,
    )
    state = mstate.bind_observations(state, s_new, sel_c, slots, valid)
    nb_feat = tri.feat_nb[sel_c]
    state = mstate.bind_observations(state, _slot(kf_nb, dev), torch.clamp(nb_feat, min=0), slots,
                                     valid & (nb_feat >= 0))
    return state, torch.sum(valid)


def create_depth_points(state: MapState, kf_slot, cam: Camera, th_depth, slots,
                        max_new: int = 512):
    """Spawn map points for the unbound features with a depth of a
    stereo/RGB-D keyframe (CreateNewKeyFrame's depth branch): closest
    first (a stable sort, so equal depths keep feature order), all those
    closer than `th_depth` (a float or a 0-d tensor) or among the 100
    closest, at most `max_new`, into the preallocated `slots`. Returns
    (state, number used)."""
    dev = state.device
    s = _slot(kf_slot, dev)
    depth = _row(state.kf_depth, s)
    cand = (depth > 0) & (_row(state.kf_mp, s) < 0) & _row(state.kf_feat_valid, s)
    key = torch.where(cand, depth, torch.full_like(depth, float("inf")))
    sel = torch.argsort(key, stable=True)[:max_new]
    rank = torch.arange(max_new, device=dev)
    valid = cand[sel] & ((depth[sel] < th_depth) | (rank < 100))

    Twc = se3.inverse(_row(state.kf_pose, s))
    xyz = se3.transform(Twc, cam_mod.backproject(cam, _row(state.kf_uv, s)[sel], depth[sel]))
    slots = torch.as_tensor(slots, device=dev).long()
    kf_t = s.to(torch.int32).expand(max_new)
    state = mstate.add_points(
        state, slots, xyz, valid, _row(state.kf_desc, s)[sel],
        torch.zeros((max_new, 3), dtype=torch.float32, device=dev),
        torch.zeros((max_new,), dtype=torch.float32, device=dev),
        torch.full((max_new,), 1e9, dtype=torch.float32, device=dev),
        kf_t, kf_t,
    )
    state = mstate.bind_observations(state, s, sel, slots, valid)
    return state, torch.sum(valid)


def triangulate_and_insert_all(state: MapState, kf_slot, neighbors, slot_matrix,
                               cam: Camera, scale_factors, level_sigma2, max_new: int = 256,
                               n_iter: int = None):
    """CreateNewMapPoints over the covisibility neighbours (-1 = absent),
    each triangulated against the new keyframe and inserted into its row
    of `slot_matrix`, as the reference's scan: an absent neighbour (taken
    as slot 0) inserts nothing, so it leaves the state bit for bit
    unchanged. Only the first `n_iter` entries (default all) are visited;
    the caller bounds it by the live keyframes, beyond which every entry is
    absent. Returns (state, (NB,) used counts, 0 past `n_iter`)."""
    dev = state.device
    neighbors = torch.as_tensor(neighbors, device=dev).long()
    slot_matrix = torch.as_tensor(slot_matrix, device=dev)
    NB = neighbors.shape[0]
    n_iter = NB if n_iter is None else min(n_iter, NB)
    counts = torch.zeros((NB,), dtype=torch.int64, device=dev)
    for i in range(n_iter):
        nb = neighbors[i]
        nb_ok = nb >= 0
        nb_c = torch.clamp(nb, min=0)
        tri = triangulate_with_neighbor(state, kf_slot, nb_c, cam, scale_factors, level_sigma2)
        tri = tri._replace(ok=tri.ok & nb_ok)
        state, n_used = insert_triangulated(state, tri, slot_matrix[i], kf_slot, nb_c, max_new=max_new)
        counts = torch.where(torch.arange(NB, device=dev) == i, n_used, counts)
    return state, counts


def fuse_into_keyframe(state: MapState, pt_candidates, kf_target, cam: Camera, scale_factors):
    """Project candidate points into a keyframe and find fusable feature
    matches (ORBmatcher::Fuse). Returns a MatchResult over the candidates."""
    s = _slot(kf_target, state.device)
    T = _row(state.kf_pose, s)
    pc = torch.clamp(pt_candidates, min=0).long()
    pv = (pt_candidates >= 0) & state.mp_valid[pc]
    X = state.mp_xyz[pc]
    Xc = se3.transform(T, X)
    proj = cam_mod.project(cam, Xc)
    in_front = Xc[:, 2] > 0
    in_img = (
        (proj[:, 0] >= 0) & (proj[:, 0] < cam.width)
        & (proj[:, 1] >= 0) & (proj[:, 1] < cam.height)
    )
    Cw = -T[:3, :3].T @ T[:3, 3]
    vec = X - Cw[None, :]
    dist = torch.linalg.norm(vec, dim=-1)
    mind = state.mp_min_dist[pc]
    maxd = state.mp_max_dist[pc]
    view_cos = torch.sum(vec * state.mp_normal[pc], dim=-1) / torch.clamp(dist, min=1e-9)
    pv = pv & in_front & in_img & (dist >= 0.8 * mind) & (dist <= 1.2 * maxd) & (view_cos > 0.5)
    sf = _tab(scale_factors, state.device)
    pred_oct = search.predict_octave(dist, maxd, torch.log(sf[1]), sf.shape[0])
    return search.fuse(
        proj, hamming.bipolar(state.mp_desc[pc]), pv, pred_oct,
        _row(state.kf_uv, s), _row(state.kf_oct, s),
        hamming.bipolar(_row(state.kf_desc, s)), _row(state.kf_feat_valid, s),
        sf, radius=3.0,
    )


def apply_fusion(state: MapState, kf_target, pt_candidates, match_idx) -> MapState:
    """Apply fusion decisions: an unbound feature binds to its point; a
    feature bound to another point merges the two (more observations
    wins, every binding of the loser rewritten)."""
    P = state.mp_xyz.shape[0]
    N = state.kf_mp.shape[1]
    dev = state.device
    ok = (match_idx >= 0) & (pt_candidates >= 0)
    j = torch.clamp(match_idx, min=0).long()
    p = torch.clamp(pt_candidates, min=0).long()
    s = _slot(kf_target, dev)
    row = _row(state.kf_mp, s)
    q = row[j].long()

    bind = ok & (q < 0)
    row_ext = torch.cat([row, row.new_full((1,), -1)])
    # Where two writes meet one slot, the later one stays, as a serial
    # scatter leaves it (CUDA writes them in no fixed order).
    jt = torch.where(bind, j, torch.full_like(j, N))
    row_ext[torch.where(last_writes(jt, N + 1), jt, torch.full_like(jt, N))] = p.to(row.dtype)
    kf_mp = state.kf_mp.clone()
    kf_mp[s] = row_ext[:N]
    state = state._replace(kf_mp=kf_mp)

    obs = map_ops.observation_counts(state)
    merge = ok & (q >= 0) & (q != p)
    qc = torch.clamp(q, min=0)
    p_wins = obs[p] >= obs[qc]
    winner = torch.where(p_wins, p, qc)
    loser = torch.where(p_wins, qc, p)
    # One point can lose twice (as one candidate's point and another's
    # bound point): the later merge writes it.
    tgt = torch.where(merge, loser, torch.full_like(loser, P))
    table = torch.arange(P + 1, dtype=torch.int64, device=dev)
    table[torch.where(last_writes(tgt, P + 1), tgt, torch.full_like(tgt, P))] = winner
    table = table[:P]
    table = table[table]  # chase one level of chaining
    kf_mp = state.kf_mp
    kf_mp = torch.where(kf_mp >= 0, table[torch.clamp(kf_mp, min=0).long()].to(kf_mp.dtype),
                        torch.full_like(kf_mp, -1))
    mp_valid = state.mp_valid & (table == torch.arange(P, device=dev))
    return _dedup_observations(state._replace(kf_mp=kf_mp, mp_valid=mp_valid))


def _dedup_observations(state: MapState) -> MapState:
    """At most one feature per (keyframe, point): keep the lowest feature
    index. Small maps use a (K,P) scatter-min table, large ones a row sort."""
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    dev = state.device
    feat_idx = torch.arange(N, dtype=torch.int64, device=dev)[None, :].expand(K, N)
    bound = state.kf_mp >= 0
    if K * P <= 16 * 1024 * 1024:
        flat = (torch.arange(K, device=dev)[:, None] * P + torch.clamp(state.kf_mp, min=0).long()).reshape(-1)
        first = torch.full((K * P,), N, dtype=torch.int64, device=dev).scatter_reduce(
            0, flat, torch.where(bound, feat_idx, torch.full_like(feat_idx, N)).reshape(-1),
            reduce="amin", include_self=True,
        )
        keep = bound & (feat_idx == first[flat].reshape(K, N))
    else:
        pt = torch.where(bound, state.kf_mp.long(), torch.full_like(feat_idx, P))
        order = torch.argsort(pt, dim=1, stable=True)
        pt_sorted = torch.gather(pt, 1, order)
        first_in_group = torch.ones((K, N), dtype=torch.bool, device=dev)
        first_in_group[:, 1:] = pt_sorted[:, 1:] != pt_sorted[:, :-1]
        keep = torch.zeros((K, N), dtype=torch.bool, device=dev).scatter(1, order, first_in_group) & bound
    return state._replace(kf_mp=torch.where(keep, state.kf_mp, torch.full_like(state.kf_mp, -1)))


def fuse_pair(state: MapState, kf_src, kf_dst, cam: Camera, scale_factors):
    """Fuse kf_src's points into kf_dst (one direction)."""
    pts = _row(state.kf_mp, _slot(kf_src, state.device))
    m = fuse_into_keyframe(state, pts, kf_dst, cam, scale_factors)
    return apply_fusion(state, kf_dst, pts, m.idx)


def fuse_all(state: MapState, kf_slot, neighbors, cam: Camera, scale_factors, n_iter: int = None):
    """SearchInNeighbors fusion, both directions for every neighbour of the
    first `n_iter` (default all): an absent neighbour (-1) leaves the state
    bit for bit unchanged, as the reference's `lax.cond` skips it."""
    neighbors = torch.as_tensor(neighbors, device=state.device).long()
    n_iter = neighbors.shape[0] if n_iter is None else min(n_iter, neighbors.shape[0])
    for i in range(n_iter):
        nb = neighbors[i]
        nb_c = torch.clamp(nb, min=0)
        fused = fuse_pair(state, kf_slot, nb_c, cam, scale_factors)
        fused = fuse_pair(fused, nb_c, kf_slot, cam, scale_factors)
        state = _masked(nb >= 0, fused, state)
    return state


def redundancy_all(state: MapState, neighbors, n_iter: int = None):
    """KeyFrameCulling redundancy fractions for every neighbour (0 for
    pads, and past the first `n_iter`)."""
    neighbors = torch.as_tensor(neighbors, device=state.device).long()
    NB = neighbors.shape[0]
    n_iter = NB if n_iter is None else min(n_iter, NB)
    zero = torch.zeros((), dtype=torch.float32, device=state.device)
    reds = [torch.where(neighbors[i] >= 0, map_ops.keyframe_redundancy(state, torch.clamp(neighbors[i], min=0)),
                        zero) for i in range(n_iter)]
    return torch.stack(reds + [zero] * (NB - n_iter))


def top_covis_neighbors(state: MapState, kf_slot, nb: int):
    """Top-nb covisibility neighbours of a keyframe, -1 padded."""
    return map_ops.top_covisible(_row(state.covis, _slot(kf_slot, state.device)), nb)


def gather_mask(mask, ids):
    """mask[ids] with -1 padding -> False."""
    return (ids >= 0) & mask[torch.clamp(ids, min=0).long()]


def gather_local_ba_problem(state: MapState, kf_new, cam: Camera, level_inv_sigma2,
                            n_local: int = 16, n_fixed: int = 8, n_points: int = 4096):
    """Local-BA window: the new KF and its covisible KFs are free; KFs
    outside the window that observe local points join as fixed cameras.
    Returns (problem, cam_slots (C,), pt_slots (n_points,))."""
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    dev = state.device
    s_new = _slot(kf_new, dev)
    top = map_ops.top_covisible(_row(state.covis, s_new), n_local - 1)
    local = torch.cat([s_new, top])
    local_mask = map_ops.mark(K, torch.clamp(local, min=0), local >= 0) & state.kf_valid

    pt_mask = map_ops.points_of_keyframes(state, local_mask)
    pt_slots = nonzero_fixed(pt_mask, n_points)
    pt_sel = map_ops.mark(P, torch.clamp(pt_slots, min=0), pt_slots >= 0)

    sees = (state.kf_mp >= 0) & pt_sel[torch.clamp(state.kf_mp, min=0).long()]
    overlap = torch.sum(sees, dim=1).to(torch.int32)
    overlap = torch.where(local_mask | ~state.kf_valid, torch.zeros_like(overlap), overlap)
    fixed = map_ops.top_covisible(overlap, n_fixed)

    cam_slots = torch.cat([local, fixed])
    C = cam_slots.shape[0]
    L = local.shape[0]
    cam_ok = cam_slots >= 0
    safe_cam = torch.clamp(cam_slots, min=0)
    cam_fixed = torch.arange(C, device=dev) >= L
    # Gauge: fix the oldest local camera when no fixed camera exists.
    any_fixed = torch.any(cam_fixed & cam_ok)
    oldest = torch.argmin(torch.where(
        local_mask[safe_cam[:L]] & cam_ok[:L], state.kf_frame_id[safe_cam[:L]],
        torch.full_like(state.kf_frame_id[safe_cam[:L]], 2**30),
    ))
    cam_fixed = cam_fixed | ((torch.arange(C, device=dev) == oldest) & ~any_fixed)

    inv = torch.full((P + 1,), -1, dtype=torch.int64, device=dev)
    inv[torch.where(pt_slots >= 0, pt_slots, torch.full_like(pt_slots, P))] = torch.arange(
        n_points, dtype=torch.int64, device=dev)
    inv = inv[:P]
    rows_mp = state.kf_mp[safe_cam]
    rows_valid = (rows_mp >= 0) & cam_ok[:, None] & state.kf_feat_valid[safe_cam]
    obs_pt_local = torch.where(rows_valid, inv[torch.clamp(rows_mp, min=0).long()],
                               torch.full_like(rows_mp, -1, dtype=torch.int64))
    rows_valid = rows_valid & (obs_pt_local >= 0)
    obs_cam = torch.arange(C, dtype=torch.int64, device=dev)[:, None].expand(C, N)
    inv_sig = _tab(level_inv_sigma2, dev)
    obs_isig = inv_sig[torch.clamp(state.kf_oct[safe_cam].long(), 0, inv_sig.shape[0] - 1)]

    problem = ba.BAProblem(
        cam_pose=state.kf_pose[safe_cam],
        cam_fixed=cam_fixed | ~cam_ok,
        xyz=state.mp_xyz[torch.clamp(pt_slots, min=0)],
        pt_valid=pt_slots >= 0,
        obs_cam=obs_cam.reshape(-1),
        obs_pt=obs_pt_local.reshape(-1),
        obs_uv=state.kf_uv[safe_cam].reshape(-1, 2),
        obs_ur=torch.where(rows_valid, state.kf_right[safe_cam],
                           torch.full_like(state.kf_right[safe_cam], -1.0)).reshape(-1),
        obs_inv_sigma2=obs_isig.reshape(-1),
        obs_valid=rows_valid.reshape(-1),
    )
    return problem, cam_slots, pt_slots


def scatter_ba_result(state: MapState, result: ba.BAResult, problem: ba.BAProblem,
                      cam_slots, pt_slots) -> MapState:
    """Write optimized free poses and points back and unbind chi2-outlier
    observations. Rows that change nothing go to a trash row."""
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    C = cam_slots.shape[0]
    dev = state.device
    cam_ok = (cam_slots >= 0) & ~problem.cam_fixed
    kf_pose = torch.cat([state.kf_pose, state.kf_pose.new_zeros((1, 4, 4))])
    kf_pose[torch.where(cam_ok, cam_slots, torch.full_like(cam_slots, K))] = result.cam_pose
    pt_ok = pt_slots >= 0
    mp_xyz = torch.cat([state.mp_xyz, state.mp_xyz.new_zeros((1, 3))])
    mp_xyz[torch.where(pt_ok, pt_slots, torch.full_like(pt_slots, P))] = result.xyz

    prune = (problem.obs_valid & ~result.obs_inlier).reshape(C, N)
    rows = state.kf_mp[torch.clamp(cam_slots, min=0)]
    rows = torch.where(prune, torch.full_like(rows, -1), rows)
    kf_mp = torch.cat([state.kf_mp, state.kf_mp.new_full((1, N), -1)])
    kf_mp[torch.where(cam_slots >= 0, cam_slots, torch.full_like(cam_slots, K))] = rows
    return state._replace(kf_pose=kf_pose[:K], mp_xyz=mp_xyz[:P], kf_mp=kf_mp[:K])


def erase_keyframes(state: MapState, db, mask):
    """Erase every keyframe of the (K,) mask from the map and the BoW
    database (the culled keyframes of one finish, in one program)."""
    return mstate.erase_keyframe(state, mask), keyframe_db.erase(db, mask)


class LocalMapper:
    """Host-side orchestration of the mapping steps for one keyframe
    (LocalMapping::Run loop body), with a host mirror of point occupancy
    for slot allocation.

    Its device work runs as three programs (engine/programs.py; CUDA
    graphs on the card, plain calls on the CPU): `dispatch` (triangulation,
    fusion, point statistics, local BA round 1, probation culling, the
    keyframe-cull redundancies), `ba2` (local BA round 2) and `erase` (the
    keyframes a finish culls). Their inputs are tensors: the keyframe slot,
    the slot matrix, the probation mask, ages and padded ids. Their Python
    leaves are sizes that the JAX package also keeps static, and the
    neighbour loops' lengths, powers of two from 4 up, bounded by the live
    keyframes (beyond them every neighbour entry is absent). The dispatch
    queues the copy of one packed vector to pinned host memory, which
    finish_keyframe reads: the keyframe's one read-back."""

    MAX_NEW = 256  # triangulated points a neighbour may add

    def __init__(self, cfg: MapConfig, cam: Camera, n_triangulate_neighbors=20,
                 n_fuse_neighbors=40, lba_local=16, lba_fixed=8, lba_points=4096,
                 kf_cull_redundancy=0.9, device="cuda"):
        self.cfg = cfg
        self.cam = cam
        self.device = resolve_device(device)
        self.n_tri_nb = n_triangulate_neighbors
        self.n_fuse_nb = max(n_fuse_neighbors, n_triangulate_neighbors)
        self.kf_cull_redundancy = kf_cull_redundancy
        self.lba_local = lba_local
        self.lba_fixed = lba_fixed
        self.lba_points = lba_points
        self._next_pt_slot = 0  # rotating allocator (delays slot reuse)
        # Conservative host mirror of state.mp_valid: slots are marked used
        # when handed out and free when culls are learned.
        self.mp_valid_host = np.zeros(cfg.max_points, bool)
        # Tables on the device once (a host table would be copied to it at
        # every use).
        self.scale_factors = torch.as_tensor(cfg.scale_factors, dtype=torch.float32, device=self.device)
        self.level_sigma2 = torch.as_tensor(cfg.level_sigma2, dtype=torch.float32, device=self.device)
        self.level_inv_sigma2 = 1.0 / self.level_sigma2
        self._dispatch_fn = programs.Program(self._dispatch, "map_dispatch")
        self._ba2_fn = programs.Program(self._ba2, "map_ba2")
        self._erase_fn = programs.Program(erase_keyframes, "map_erase")
        self.programs = (self._dispatch_fn, self._ba2_fn, self._erase_fn)

    def note_points_added(self, slots):
        slots = np.asarray(slots, np.int64)
        if slots.size:
            self.mp_valid_host[slots] = True

    def note_points_erased(self, slots):
        slots = np.asarray(slots, np.int64)
        if slots.size:
            self.mp_valid_host[slots] = False

    def resync_point_mirror(self, state: MapState):
        self.mp_valid_host = state.mp_valid.cpu().numpy().copy()

    def peek_point_slots(self, state: MapState, n: int) -> np.ndarray:
        """Rotating free-slot candidates without advancing the cursor."""
        free = np.flatnonzero(~self.mp_valid_host)
        if len(free) < n:
            self.resync_point_mirror(state)
            free = np.flatnonzero(~self.mp_valid_host)
        if len(free) < n:
            raise RuntimeError(
                f"map point capacity exhausted ({self.cfg.max_points}); raise MapConfig.max_points"
            )
        pos = np.searchsorted(free, self._next_pt_slot)
        free = np.concatenate([free[pos:], free[:pos]])
        return free[:n]

    def advance_point_slots(self, slots: np.ndarray, n_used: int):
        if n_used > 0:
            self._next_pt_slot = (int(slots[n_used - 1]) + 1) % self.cfg.max_points

    def free_point_slots(self, state: MapState, n: int) -> np.ndarray:
        sel = self.peek_point_slots(state, n)
        self.advance_point_slots(sel, n)
        return sel

    def _dispatch(self, state: MapState, slot, slot_matrix, cull, n_tri: int, n_fuse: int):
        """The dispatch program. `slot` 0-d int64; `slot_matrix` (NB, 256);
        `cull` (probation (P,) bool, age (P,) int32, padded ids);
        `n_tri`/`n_fuse` the neighbour loops' lengths. Returns (state,
        packed [neighbours, used counts, redundancies, probation culls] as
        float32, problem, result1, cam_slots, pt_slots)."""
        cam, NB = self.cam, self.n_tri_nb
        state = map_ops.refresh_covis_rows(state, slot.reshape(1))
        nb_fuse = top_covis_neighbors(state, slot, self.n_fuse_nb)
        nb_arr = nb_fuse[:NB]
        state, n_used = triangulate_and_insert_all(
            state, slot, nb_arr, slot_matrix, cam, self.scale_factors, self.level_sigma2,
            max_new=self.MAX_NEW, n_iter=n_tri,
        )
        # New points need their statistics before fusion (reference order).
        state = map_ops.update_point_stats(state, self.cfg)
        state = fuse_all(state, slot, nb_fuse, cam, self.scale_factors, n_iter=n_fuse)
        state = map_ops.update_point_stats(state, self.cfg)
        state = map_ops.refresh_covis_rows(state, torch.cat([slot.reshape(1), nb_fuse]))

        problem, cam_slots, pt_slots = gather_local_ba_problem(
            state, slot, cam, self.level_inv_sigma2,
            n_local=self.lba_local, n_fixed=self.lba_fixed, n_points=self.lba_points,
        )
        result1 = ba.bundle_adjust(problem, cam, lm_iters=5, cg_iters=15)
        state = scatter_ba_result(state, result1, problem, cam_slots, pt_slots)

        # MapPointCulling on the probation list (ages in keyframe counts).
        probation, age, ids = cull
        dead = map_ops.cull_points(state, probation, age, th_obs=2)
        state = mstate.erase_points(state, dead)
        reds = redundancy_all(state, nb_arr, n_iter=n_tri)
        packed = torch.cat([nb_arr.float(), n_used.float(), reds, gather_mask(dead, ids).float()])
        return state, packed, problem, result1, cam_slots, pt_slots

    def dispatch_keyframe(self, state: MapState, kf_slot: int, recent_pts: list, kf_order: list):
        """Triangulation, fusion, point statistics, local BA round 1,
        probation culling and keyframe-cull redundancies, queued as one
        program without a host sync. Returns (state, PendingMapping);
        finish_keyframe does the host bookkeeping and run_ba_round2 the
        10-iteration second BA round."""
        dev = state.device
        NB, MAX_NEW = self.n_tri_nb, self.MAX_NEW
        born = len(kf_order)
        slot_matrix = self.peek_point_slots(state, NB * MAX_NEW).reshape(NB, MAX_NEW)
        self.note_points_added(slot_matrix.ravel())
        self._next_pt_slot = (int(slot_matrix[-1, -1]) + 1) % self.cfg.max_points

        cur = len(kf_order)
        probation_ids = np.fromiter((p for p, _ in recent_pts), np.int32, count=len(recent_pts))
        P = self.cfg.max_points
        probation = np.zeros(P, bool)
        age = np.zeros(P, np.int32)
        for p, b in recent_pts:
            probation[p] = True
            age[p] = cur - b
        # The reference's padding of the probation ids (to a power of two),
        # from 4096 up: the probation list holds the last keyframes'
        # points, so successive keyframes share the size.
        ids_pad = np.full(programs.pow2_bucket(len(probation_ids), 4096, P), -1, np.int32)
        ids_pad[: len(probation_ids)] = probation_ids
        cull = tuple(programs.to_device(a, dev) for a in (probation, age, ids_pad))
        # The neighbours are live keyframes other than this one: past the
        # first len(kf_order) - 1 entries every one is absent. At least 4,
        # so that a young map's keyframes share one program.
        n_nb = len(kf_order) - 1
        n_tri, n_fuse = programs.pow2_bucket(n_nb, 4, NB), programs.pow2_bucket(n_nb, 4, self.n_fuse_nb)
        state, packed, problem, result1, cam_slots, pt_slots = self._dispatch_fn(
            state, torch.full((), int(kf_slot), dtype=torch.int64, device=dev),
            programs.to_device(slot_matrix.astype(np.int32), dev), cull, n_tri, n_fuse,
        )
        packed_host, copied = programs.read_async(packed)
        pending = PendingMapping(
            kf_slot=kf_slot, packed_host=packed_host, packed_copied=copied,
            n_cull=len(probation_ids), has_reds=len(kf_order) > 3, slot_matrix=slot_matrix,
            probation_ids=probation_ids, born=born, cur=cur, problem=problem, result1=result1,
            cam_slots=cam_slots, pt_slots=pt_slots,
        )
        return state, pending

    def _ba2(self, state: MapState, problem, r1, cam_slots, pt_slots):
        problem2 = problem._replace(cam_pose=r1.cam_pose, xyz=r1.xyz, obs_valid=problem.obs_valid & r1.obs_inlier)
        result2 = ba.bundle_adjust(problem2, self.cam, lm_iters=10, cg_iters=15)
        return scatter_ba_result(state, result2, problem2, cam_slots, pt_slots)

    def run_ba_round2(self, state: MapState, pending: PendingMapping):
        """Local BA round 2 without the round-1 outliers; skipped when the
        pending keyframe was superseded (mbAbortBA)."""
        if pending.aborted or pending.ba2_done:
            return state
        pending.ba2_done = True
        return self._ba2_fn(state, pending.problem, pending.result1, pending.cam_slots, pending.pt_slots)

    def finish_keyframe(self, state: MapState, db, pending: PendingMapping,
                        recent_pts: list, kf_order: list, protected: set = frozenset(),
                        cull_log: list = None):
        """Host bookkeeping from the one packed read-back: probation
        updates, freeing unused point slots, KeyFrameCulling decisions."""
        if pending.packed_copied is not None:
            pending.packed_copied.synchronize()
        vals = pending.packed_host.numpy()
        NB = self.n_tri_nb
        nb_host = vals[:NB].astype(np.int64)
        n_used_host = vals[NB:2 * NB].astype(np.int64)
        reds_host = vals[2 * NB:3 * NB] if pending.has_reds else None
        cull_host = vals[3 * NB:3 * NB + pending.n_cull] > 0.5 if pending.n_cull else None
        slot_matrix = pending.slot_matrix
        born = pending.born
        cur = pending.cur

        for row in range(NB):
            n_u = int(n_used_host[row])
            recent_pts.extend((int(p), born) for p in slot_matrix[row, :n_u])
            self.note_points_erased(slot_matrix[row, n_u:])
        if cull_host is not None:
            culled = set(int(p) for p, dead in zip(pending.probation_ids, cull_host) if dead)
            self.note_points_erased(np.fromiter(culled, np.int64, len(culled)))
            recent_pts[:] = [(p, b) for p, b in recent_pts if p not in culled and cur - b < 3]

        origin = kf_order[0] if kf_order else -1
        culled_now = []
        if reds_host is not None:
            for row, nb in enumerate(nb_host):
                nb = int(nb)
                if nb < 0 or nb == origin or nb in protected:
                    continue
                if reds_host[row] > self.kf_cull_redundancy:
                    if nb in kf_order:
                        kf_order.remove(nb)
                    culled_now.append(nb)
        if culled_now:
            mask = np.zeros(state.kf_valid.shape[0], bool)
            mask[culled_now] = True
            state, db = self._erase_fn(state, db, programs.to_device(mask, state.device))

        # Trajectory repair chain: culled keyframes' poses relative to the
        # keyframe being processed.
        if culled_now and cull_log is not None:
            parent = int(pending.kf_slot)
            poses = state.kf_pose[torch.as_tensor(culled_now + [parent])].cpu().numpy().astype(np.float64)
            T_parent_inv = np.linalg.inv(poses[-1])
            for i, nb in enumerate(culled_now):
                cull_log.append((nb, parent, poses[i] @ T_parent_inv))
        return state, db

    def process_keyframe(self, state: MapState, db, kf_slot: int, recent_pts: list,
                         kf_order: list, protected: set = frozenset(), cull_log: list = None):
        """Synchronous dispatch + BA round 2 + finish for one keyframe."""
        state, pending = self.dispatch_keyframe(state, kf_slot, recent_pts, kf_order)
        state = self.run_ba_round2(state, pending)
        return self.finish_keyframe(state, db, pending, recent_pts, kf_order, protected, cull_log)
