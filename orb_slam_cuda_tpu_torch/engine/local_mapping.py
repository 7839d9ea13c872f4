"""Local mapping: triangulation, fusion, local BA, culling (torch port of
the monocular parts of orb_slam_cuda_tpu/engine/local_mapping.py).

The reference's `lax.scan`s over neighbours are Python loops here, and
neighbour lists are read to the host once per keyframe. Scatters that the
reference pads onto index 0 (or a sentinel with mode='drop') write into a
trash row instead. `create_depth_points` (stereo/RGB-D) is not ported yet.
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
from ..slam_map import MapConfig, MapState, keyframe_db
from ..slam_map import ops as map_ops
from ..slam_map import state as mstate
from ..solvers import bundle_adjust as ba
from ..utils.device import resolve as resolve_device


class PendingMapping:
    """In-flight mapping work for one keyframe plus the host context."""

    __slots__ = (
        "kf_slot", "nb_arr", "n_used_arr", "cull_sel", "reds_dev",
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
    return torch.as_tensor(values, dtype=torch.float32, device=device)


def nonzero_fixed(mask, size: int):
    """First `size` indices where mask is True, -1 padded (the reference's
    `nonzero(size=..., fill_value=-1)`)."""
    idx = torch.nonzero(mask).flatten()[:size]
    out = torch.full((size,), -1, dtype=torch.int64, device=mask.device)
    out[: idx.shape[0]] = idx
    return out


def triangulate_with_neighbor(state: MapState, kf_new, kf_nb, cam: Camera,
                              scale_factors, level_sigma2) -> TriangulationResult:
    """Epipolar-matched two-view triangulation between the new keyframe
    and one covisibility neighbour (CreateNewMapPoints inner loop)."""
    dev = state.device
    K = cam.K_on(dev)
    T1 = state.kf_pose[kf_new]
    T2 = state.kf_pose[kf_nb]
    F12 = triangulate.fundamental_from_poses(K, T1, K, T2)
    mp1 = state.kf_mp[kf_new]
    mp2 = state.kf_mp[kf_nb]
    has1 = (mp1 >= 0) & state.mp_valid[torch.clamp(mp1, min=0).long()]
    has2 = (mp2 >= 0) & state.mp_valid[torch.clamp(mp2, min=0).long()]

    C1w = -T1[:3, :3].T @ T1[:3, 3]
    C1_in_2 = T2[:3, :3] @ C1w + T2[:3, 3]
    epipole2 = cam_mod.project(cam, C1_in_2[None, :])[0]

    m = search.for_triangulation(
        state.kf_node[kf_new], hamming.bipolar(state.kf_desc[kf_new]), state.kf_feat_valid[kf_new],
        state.kf_ang[kf_new], state.kf_uv[kf_new], state.kf_oct[kf_new],
        state.kf_node[kf_nb], hamming.bipolar(state.kf_desc[kf_nb]), state.kf_feat_valid[kf_nb],
        state.kf_ang[kf_nb], state.kf_uv[kf_nb], state.kf_oct[kf_nb],
        F12, level_sigma2, epipole_uv=epipole2, scale_factors=scale_factors,
        f1_has_point=has1, f2_has_point=has2,
    )
    ok = m.idx >= 0
    j = torch.clamp(m.idx, min=0)
    xy1 = state.kf_uv[kf_new]
    xy2 = state.kf_uv[kf_nb][j]
    X = triangulate.triangulate_dlt(
        triangulate.projection_matrix(K, T1), triangulate.projection_matrix(K, T2), xy1, xy2
    )
    z1, z2, cosp = triangulate.cheirality_and_parallax(X, T1, T2)

    def reproj_err(T, xy):
        uv = cam_mod.project(cam, se3.transform(T, X))
        return torch.sum((uv - xy) ** 2, dim=-1)

    sig2 = _tab(level_sigma2, dev)
    L = sig2.shape[0]
    oct1 = torch.clamp(state.kf_oct[kf_new].long(), 0, L - 1)
    oct2 = torch.clamp(state.kf_oct[kf_nb][j].long(), 0, L - 1)
    e1 = reproj_err(T1, xy1) / sig2[oct1]
    e2 = reproj_err(T2, xy2) / sig2[oct2]

    C2w = -T2[:3, :3].T @ T2[:3, 3]
    d1 = torch.linalg.norm(X - C1w[None, :], dim=-1)
    d2 = torch.linalg.norm(X - C2w[None, :], dim=-1)
    ratio_dist = d1 / torch.clamp(d2, min=1e-9)
    sf = _tab(scale_factors, dev)
    ratio_oct = sf[oct1] / sf[oct2]
    ratio_factor = 1.5 * float(np.float32(scale_factors[1]))
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
    sel = nonzero_fixed(tri.ok, max_new)
    valid = sel >= 0
    sel_c = torch.clamp(sel, min=0)
    slots = torch.as_tensor(slots, device=dev).long()
    kf_new_t = torch.full((max_new,), int(kf_new), dtype=torch.int32, device=dev)
    state = mstate.add_points(
        state, slots, tri.xyz[sel_c], valid, state.kf_desc[kf_new][sel_c],
        torch.zeros((max_new, 3), dtype=torch.float32, device=dev),
        torch.zeros((max_new,), dtype=torch.float32, device=dev),
        torch.full((max_new,), 1e9, dtype=torch.float32, device=dev),
        kf_new_t, kf_new_t,
    )
    state = mstate.bind_observations(state, kf_new, sel_c, slots, valid)
    nb_feat = tri.feat_nb[sel_c]
    state = mstate.bind_observations(state, kf_nb, torch.clamp(nb_feat, min=0), slots, valid & (nb_feat >= 0))
    return state, torch.sum(valid)


def triangulate_and_insert_all(state: MapState, kf_slot, neighbors, slot_matrix,
                               cam: Camera, scale_factors, level_sigma2, max_new: int = 256):
    """CreateNewMapPoints over every covisibility neighbour (-1 = absent).
    Returns (state, (NB,) used counts)."""
    counts = []
    for nb, slots in zip(torch.as_tensor(neighbors).tolist(), slot_matrix):
        if nb < 0:
            counts.append(torch.zeros((), dtype=torch.int64, device=state.device))
            continue
        tri = triangulate_with_neighbor(state, kf_slot, nb, cam, scale_factors, level_sigma2)
        state, n_used = insert_triangulated(state, tri, slots, kf_slot, nb, max_new=max_new)
        counts.append(n_used)
    return state, torch.stack(counts)


def fuse_into_keyframe(state: MapState, pt_candidates, kf_target, cam: Camera, scale_factors):
    """Project candidate points into a keyframe and find fusable feature
    matches (ORBmatcher::Fuse). Returns a MatchResult over the candidates."""
    T = state.kf_pose[kf_target]
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
    log_sf = torch.log(_tab(scale_factors, state.device)[1])
    pred_oct = search.predict_octave(dist, maxd, log_sf, len(scale_factors))
    return search.fuse(
        proj, hamming.bipolar(state.mp_desc[pc]), pv, pred_oct,
        state.kf_uv[kf_target], state.kf_oct[kf_target],
        hamming.bipolar(state.kf_desc[kf_target]), state.kf_feat_valid[kf_target],
        scale_factors, radius=3.0,
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
    row = state.kf_mp[kf_target]
    q = row[j].long()

    bind = ok & (q < 0)
    row_ext = torch.cat([row, row.new_full((1,), -1)])
    row_ext[torch.where(bind, j, torch.full_like(j, N))] = p.to(row.dtype)
    kf_mp = state.kf_mp.clone()
    kf_mp[kf_target] = row_ext[:N]
    state = state._replace(kf_mp=kf_mp)

    obs = map_ops.observation_counts(state)
    merge = ok & (q >= 0) & (q != p)
    qc = torch.clamp(q, min=0)
    p_wins = obs[p] >= obs[qc]
    winner = torch.where(p_wins, p, qc)
    loser = torch.where(p_wins, qc, p)
    table = torch.arange(P + 1, dtype=torch.int64, device=dev)
    table[torch.where(merge, loser, torch.full_like(loser, P))] = winner
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
    pts = state.kf_mp[kf_src]
    m = fuse_into_keyframe(state, pts, kf_dst, cam, scale_factors)
    return apply_fusion(state, kf_dst, pts, m.idx)


def fuse_all(state: MapState, kf_slot, neighbors, cam: Camera, scale_factors):
    """SearchInNeighbors fusion, both directions for every neighbour."""
    for nb in torch.as_tensor(neighbors).tolist():
        if nb >= 0:
            state = fuse_pair(state, kf_slot, nb, cam, scale_factors)
            state = fuse_pair(state, nb, kf_slot, cam, scale_factors)
    return state


def redundancy_all(state: MapState, neighbors):
    """KeyFrameCulling redundancy fractions for every neighbour (0 for pads)."""
    return torch.stack([
        map_ops.keyframe_redundancy(state, nb) if nb >= 0
        else torch.zeros((), dtype=torch.float32, device=state.device)
        for nb in torch.as_tensor(neighbors).tolist()
    ])


def top_covis_neighbors(state: MapState, kf_slot, nb: int):
    """Top-nb covisibility neighbours of a keyframe, -1 padded."""
    return map_ops.top_covisible(state.covis[kf_slot], nb)


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
    top = map_ops.top_covisible(state.covis[kf_new], n_local - 1)
    local = torch.cat([torch.tensor([int(kf_new)], dtype=torch.int64, device=dev), top])
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
    cam_fixed = torch.cat([torch.zeros((L,), dtype=torch.bool, device=dev),
                           torch.ones((n_fixed,), dtype=torch.bool, device=dev)])
    # Gauge: fix the oldest local camera when no fixed camera exists.
    any_fixed = torch.any(cam_fixed & cam_ok)
    oldest = torch.argmin(torch.where(
        local_mask[safe_cam[:L]] & cam_ok[:L], state.kf_frame_id[safe_cam[:L]],
        torch.full_like(state.kf_frame_id[safe_cam[:L]], 2**30),
    ))
    cam_fixed[oldest] = cam_fixed[oldest] | ~any_fixed

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


class LocalMapper:
    """Host-side orchestration of the mapping steps for one keyframe
    (LocalMapping::Run loop body), with a host mirror of point occupancy
    for slot allocation."""

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
        self.scale_factors = tuple(cfg.scale_factors)
        self.level_sigma2 = tuple(cfg.level_sigma2)
        self.level_inv_sigma2 = (1.0 / _tab(self.level_sigma2, "cpu")).tolist()

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

    def dispatch_keyframe(self, state: MapState, kf_slot: int, recent_pts: list, kf_order: list):
        """Triangulation, fusion, point statistics, local BA round 1,
        probation culling and keyframe-cull redundancies. Returns (state,
        PendingMapping); finish_keyframe does the host bookkeeping and
        run_ba_round2 the 10-iteration second BA round."""
        cam = self.cam
        dev = state.device
        NB = self.n_tri_nb
        state = map_ops.refresh_covis_rows(state, torch.tensor([kf_slot], device=dev))
        nb_fuse = top_covis_neighbors(state, kf_slot, self.n_fuse_nb)
        nb_arr = nb_fuse[:NB]

        MAX_NEW = 256
        born = len(kf_order)
        slot_matrix = self.peek_point_slots(state, NB * MAX_NEW).reshape(NB, MAX_NEW)
        self.note_points_added(slot_matrix.ravel())
        self._next_pt_slot = (int(slot_matrix[-1, -1]) + 1) % self.cfg.max_points
        state, n_used_arr = triangulate_and_insert_all(
            state, kf_slot, nb_arr, torch.as_tensor(slot_matrix, device=dev), cam,
            self.scale_factors, self.level_sigma2, max_new=MAX_NEW,
        )
        # New points need their statistics before fusion (reference order).
        state = map_ops.update_point_stats(state, self.cfg)
        state = fuse_all(state, kf_slot, nb_fuse, cam, self.scale_factors)
        state = map_ops.update_point_stats(state, self.cfg)
        state = map_ops.refresh_covis_rows(
            state, torch.cat([torch.tensor([kf_slot], device=dev), nb_fuse])
        )

        problem, cam_slots, pt_slots = gather_local_ba_problem(
            state, kf_slot, cam, self.level_inv_sigma2,
            n_local=self.lba_local, n_fixed=self.lba_fixed, n_points=self.lba_points,
        )
        result1 = ba.bundle_adjust(problem, cam, lm_iters=5, cg_iters=15)
        state = scatter_ba_result(state, result1, problem, cam_slots, pt_slots)

        # MapPointCulling on the probation list (ages in keyframe counts).
        cur = len(kf_order)
        probation_ids = np.fromiter((p for p, _ in recent_pts), np.int32, count=len(recent_pts))
        cull_sel = None
        if recent_pts:
            P = self.cfg.max_points
            probation = np.zeros(P, bool)
            age = np.zeros(P, np.int32)
            for p, b in recent_pts:
                probation[p] = True
                age[p] = cur - b
            cull = map_ops.cull_points(
                state, torch.as_tensor(probation, device=dev), torch.as_tensor(age, device=dev), th_obs=2
            )
            state = mstate.erase_points(state, cull)
            cull_sel = gather_mask(cull, torch.as_tensor(probation_ids, device=dev))

        reds_dev = redundancy_all(state, nb_arr) if len(kf_order) > 3 else None
        pending = PendingMapping(
            kf_slot=kf_slot, nb_arr=nb_arr, n_used_arr=n_used_arr, cull_sel=cull_sel,
            reds_dev=reds_dev, slot_matrix=slot_matrix, probation_ids=probation_ids,
            born=born, cur=cur, problem=problem, result1=result1, cam_slots=cam_slots,
            pt_slots=pt_slots,
        )
        return state, pending

    def run_ba_round2(self, state: MapState, pending: PendingMapping):
        """Local BA round 2 without the round-1 outliers; skipped when the
        pending keyframe was superseded (mbAbortBA)."""
        if pending.aborted or pending.ba2_done:
            return state
        pending.ba2_done = True
        r1 = pending.result1
        problem2 = pending.problem._replace(
            cam_pose=r1.cam_pose, xyz=r1.xyz,
            obs_valid=pending.problem.obs_valid & r1.obs_inlier,
        )
        result2 = ba.bundle_adjust(problem2, self.cam, lm_iters=10, cg_iters=15)
        return scatter_ba_result(state, result2, problem2, pending.cam_slots, pending.pt_slots)

    def finish_keyframe(self, state: MapState, db, pending: PendingMapping,
                        recent_pts: list, kf_order: list, protected: set = frozenset(),
                        cull_log: list = None):
        """Host bookkeeping: probation updates, freeing unused point slots,
        KeyFrameCulling decisions."""
        nb_host = pending.nb_arr.cpu().numpy()
        n_used_host = pending.n_used_arr.cpu().numpy()
        cull_host = None if pending.cull_sel is None else pending.cull_sel.cpu().numpy()
        reds_host = None if pending.reds_dev is None else pending.reds_dev.cpu().numpy()
        slot_matrix = pending.slot_matrix
        born = pending.born
        cur = pending.cur

        for row in range(self.n_tri_nb):
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
                    state = mstate.erase_keyframe(state, nb)
                    db = keyframe_db.erase(db, nb)
                    if nb in kf_order:
                        kf_order.remove(nb)
                    culled_now.append(nb)

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
