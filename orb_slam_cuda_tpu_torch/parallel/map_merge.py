"""Cross-map alignment and merging for multi-sequence work sharding (torch
port of orb_slam_cuda_tpu/parallel/map_merge.py).

N ranks track N sequences through the same place into rank-local maps;
the maps are aligned by place recognition and a Sim3 (the loop funnel's
SearchByBoW and Sim3 RANSAC applied across maps), merged into one, their
seam fused, and a global BA over the merged map, distributed over the
process group (parallel/dist_ba.py), polishes the joint estimate. The
merge itself is host-side numpy, as in the reference: it runs once.
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
from ..slam_map import state as mstate
from ..solvers import bundle_adjust as ba
from ..solvers import sim3_solver
from ..solvers.initializer import default_sampler


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def find_cross_map_link(state_a: MapState, db_a, state_b: MapState, kf_b: int, cam: Camera,
                        scale_factors, level_sigma2, n_words: int, fix_scale: bool = True,
                        min_inliers: int = 20, top_candidates: int = 3, seed: int = 0,
                        word_weight=None, sampler=None):
    """Locate keyframe `kf_b` of map B inside map A and estimate the
    B-world -> A-world similarity. Returns (kf_a, S_ab) with p_a =
    S_ab(p_b), or (None, None) if no candidate passes the Sim3 gate.
    `fix_scale=True` for stereo/RGB-D maps (both metric). The RANSAC
    minimal sets of candidate kf_a come from `sampler("sim3", seed * 997 +
    kf_a, valid)` (default: `initializer.default_sampler`, a CPU
    generator seeded so)."""
    sampler = sampler or default_sampler
    dev = state_a.device
    wq = state_b.kf_word[kf_b]
    if word_weight is not None:
        idf = torch.as_tensor(word_weight, device=dev)[torch.clamp(wq, min=0).long()]
    else:
        idf = torch.ones_like(state_b.kf_ang[kf_b])
    q_dense = keyframe_db.dense_bow(*keyframe_db.compute_bow_row(wq, idf, state_b.kf_feat_valid[kf_b]), n_words)
    s_scores = keyframe_db.scores(db_a, q_dense)
    s_np = _np(torch.where(state_a.kf_valid, s_scores, torch.full_like(s_scores, -1.0)))
    order = np.argsort(-s_np)[:top_candidates]

    sig2 = np.asarray(level_sigma2, np.float32)
    b_bip = hamming.bipolar(state_b.kf_desc[kf_b])
    mp_b = _np(state_b.kf_mp[kf_b])
    mpb_ok = (mp_b >= 0) & _np(state_b.kf_feat_valid[kf_b])
    mpb_ok &= _np(state_b.mp_valid)[np.clip(mp_b, 0, None)]

    for kf_a in order:
        kf_a = int(kf_a)
        if s_np[kf_a] <= 0:
            continue
        mp_a = _np(state_a.kf_mp[kf_a])
        a_has = (mp_a >= 0) & _np(state_a.kf_feat_valid[kf_a])
        a_has &= _np(state_a.mp_valid)[np.clip(mp_a, 0, None)]
        m = search.by_bow(
            state_a.kf_node[kf_a], hamming.bipolar(state_a.kf_desc[kf_a]),
            state_a.kf_feat_valid[kf_a], state_a.kf_ang[kf_a],
            state_b.kf_node[kf_b], b_bip, state_b.kf_feat_valid[kf_b], state_b.kf_ang[kf_b],
            ratio=0.75, check_rotation=True, f1_has_point=torch.as_tensor(a_has, device=dev),
        )
        idx = _np(m.idx)  # A-feature i -> B-feature idx[i]
        j = np.clip(idx, 0, None)
        pair_ok = (idx >= 0) & a_has & mpb_ok[j]
        if int(pair_ok.sum()) < min_inliers:
            continue
        # Camera-frame point sets for the Sim3 solve and its
        # bidirectional reprojection gates.
        p_a = torch.as_tensor(np.clip(mp_a, 0, None), device=dev).long()
        p_b = torch.as_tensor(np.clip(mp_b[j], 0, None), device=dev).long()
        j_t = torch.as_tensor(j, device=dev).long()
        T_a = state_a.kf_pose[kf_a]
        T_b = state_b.kf_pose[kf_b]
        x1 = se3.transform(T_a, state_a.mp_xyz[p_a])
        x2 = se3.transform(T_b, state_b.mp_xyz[p_b])
        oct_a = _np(state_a.kf_oct[kf_a])
        oct_b = _np(state_b.kf_oct[kf_b])[j]
        th1 = 9.210 * sig2[np.clip(oct_a, 0, len(sig2) - 1)]
        th2 = 9.210 * sig2[np.clip(oct_b, 0, len(sig2) - 1)]
        valid = torch.as_tensor(pair_ok, device=dev)
        res = sim3_solver.solve_sim3_ransac(
            x1, x2, state_a.kf_uv[kf_a], state_b.kf_uv[kf_b][j_t], valid, cam,
            torch.as_tensor(th1, device=dev), torch.as_tensor(th2, device=dev),
            fix_scale=fix_scale, min_inliers=min_inliers,
            sample_sets=sampler("sim3", seed * 997 + kf_a, valid),
        )
        if not bool(res.ok):
            continue
        # S_12: cam_b -> cam_a; p_a = T_a^-1(S_12(T_b(p_b))), so
        # S_ab = S_a^-1 o S_12 o S_b.
        S_ab = sim3.compose(sim3.inverse(sim3.from_se3(T_a)),
                            sim3.compose((res.R, res.t, res.s), sim3.from_se3(T_b)))
        return kf_a, S_ab
    return None, None


def merge_maps(state_a: MapState, kf_order_a: List[int], db_a, state_b: MapState,
               kf_order_b: List[int], db_b, S_ab, cfg: MapConfig
               ) -> Tuple[MapState, object, List[int], dict, dict]:
    """Merge map B into map A's frame under S_ab (p_a = S_ab(p_b)).

    A's keyframe and point slots are kept; B's live keyframes and valid
    points are packed into free slots. B's poses fold the similarity's
    scale into the translation as CorrectLoop does; for the fixed-scale
    (stereo/RGB-D) case s = 1 and the depth columns stay metric.

    Returns (merged_state, merged_db, kf_order, kf_slot_map, pt_slot_map)
    on map A's device, the maps taking B slots to merged slots."""
    K, N, P = cfg.max_keyframes, cfg.max_features, cfg.max_points
    KA, NA = state_a.kf_mp.shape
    if NA != N:
        raise ValueError("feature capacity mismatch")
    dev = state_a.device

    a = state_a._asdict()
    out = {k: _np(v).copy() for k, v in mstate.empty(cfg)._asdict().items()}
    # A verbatim into the head of each axis.
    for k, v in a.items():
        v = _np(v)
        if k == "covis":
            out[k][:KA, :KA] = v
        elif k.startswith("kf_"):
            out[k][:KA] = v
        else:
            out[k][: v.shape[0]] = v

    kf_used = np.zeros(K, bool)
    kf_used[_np(state_a.kf_valid)[:KA].nonzero()[0]] = True
    pt_used = _np(state_a.mp_valid).copy()
    if pt_used.shape[0] < P:
        pt_used = np.concatenate([pt_used, np.zeros(P - pt_used.shape[0], bool)])

    free_kf = [i for i in range(K) if not kf_used[i]]
    free_pt = np.flatnonzero(~pt_used)

    b_valid = _np(state_b.kf_valid)
    b_kfs = [s for s in kf_order_b if b_valid[s]]
    if len(b_kfs) > len(free_kf):
        raise ValueError("merged keyframe capacity too small")
    kf_slot_map = {b: free_kf[i] for i, b in enumerate(b_kfs)}

    bp_valid = _np(state_b.mp_valid)
    b_pts = np.flatnonzero(bp_valid)
    if len(b_pts) > len(free_pt):
        raise ValueError("merged point capacity too small")
    pt_slot_map_arr = np.full(bp_valid.shape[0], -1, np.int64)
    pt_slot_map_arr[b_pts] = free_pt[: len(b_pts)]

    # B's geometry in A's world.
    R, t, s = (_np(torch.as_tensor(x)).astype(np.float64) for x in S_ab)
    s = float(s)
    xyz_b = _np(state_b.mp_xyz).astype(np.float64)
    xyz_new = (s * (xyz_b @ R.T)) + t
    normal_b = _np(state_b.mp_normal).astype(np.float64) @ R.T
    S_inv = sim3.inverse(tuple(torch.as_tensor(x, dtype=torch.float32).cpu() for x in S_ab))
    pose_b = _np(state_b.kf_pose)

    b = {k: _np(v) for k, v in state_b._asdict().items()}
    for bslot, mslot in kf_slot_map.items():
        for k in b:
            if not k.startswith("kf_") or k == "kf_valid":
                continue
            if k == "kf_pose":
                S_new = sim3.compose(sim3.from_se3(torch.as_tensor(pose_b[bslot])), S_inv)
                out[k][mslot] = _np(sim3.to_se3(S_new))
            elif k == "kf_mp":
                row = b[k][bslot]
                out[k][mslot] = np.where(row >= 0, pt_slot_map_arr[np.clip(row, 0, None)], -1)
            elif k == "kf_depth":
                out[k][mslot] = np.where(b[k][bslot] >= 0, b[k][bslot] * s, -1.0)
            else:
                out[k][mslot] = b[k][bslot]
        out["kf_valid"][mslot] = True

    dst = pt_slot_map_arr[b_pts]
    out["mp_xyz"][dst] = xyz_new[b_pts].astype(np.float32)
    out["mp_valid"][dst] = True
    out["mp_desc"][dst] = b["mp_desc"][b_pts]
    out["mp_normal"][dst] = normal_b[b_pts].astype(np.float32)
    out["mp_min_dist"][dst] = b["mp_min_dist"][b_pts] * s
    out["mp_max_dist"][dst] = b["mp_max_dist"][b_pts] * s
    out["mp_visible"][dst] = b["mp_visible"][b_pts]
    out["mp_found"][dst] = b["mp_found"][b_pts]
    ref_b = b["mp_ref_kf"][b_pts]
    kf_map_arr = np.full(pose_b.shape[0], -1, np.int64)
    for bslot, mslot in kf_slot_map.items():
        kf_map_arr[bslot] = mslot
    out["mp_ref_kf"][dst] = np.where(ref_b >= 0, kf_map_arr[np.clip(ref_b, 0, None)], -1).astype(np.int32)
    out["mp_first_kf"][dst] = out["mp_ref_kf"][dst]

    merged = MapState(**{k: torch.as_tensor(v, device=dev) for k, v in out.items()})
    merged = merged._replace(covis=map_ops.covisibility_matrix(merged))

    # The merged BoW database.
    word = np.full((K, db_a.word.shape[1]), -1, np.int32)
    weight = np.zeros((K, db_a.word.shape[1]), np.float32)
    valid = np.zeros(K, bool)
    word[:KA] = _np(db_a.word)
    weight[:KA] = _np(db_a.weight)
    valid[:KA] = _np(db_a.valid)
    db_b_np = [_np(x) for x in (db_b.word, db_b.weight, db_b.valid)]
    for bslot, mslot in kf_slot_map.items():
        word[mslot] = db_b_np[0][bslot]
        weight[mslot] = db_b_np[1][bslot]
        valid[mslot] = bool(db_b_np[2][bslot])
    dbm = keyframe_db.BowDB(word=torch.as_tensor(word, device=dev), weight=torch.as_tensor(weight, device=dev),
                            valid=torch.as_tensor(valid, device=dev))

    kf_order = [s_ for s_ in kf_order_a if kf_used[s_]] + [kf_slot_map[bslot] for bslot in b_kfs]
    pt_slot_map = {int(p): int(pt_slot_map_arr[p]) for p in b_pts}
    return merged, dbm, kf_order, kf_slot_map, pt_slot_map


def fuse_seam(state: MapState, cfg: MapConfig, kfs_into, pts_from_mask, cam: Camera, scale_factors):
    """Fuse the masked points into each keyframe of `kfs_into`
    (CorrectLoop's SearchAndFuse at a merge seam). Without it the merged
    map has no cross-map observation and its global BA sees two separate
    components."""
    from ..engine import local_mapping
    from ..engine.loop_closing import pow2_bucket

    n = int(torch.sum(pts_from_mask))
    if n == 0 or not kfs_into:
        return state
    pts = local_mapping.nonzero_fixed(pts_from_mask, pow2_bucket(n, 1024, cfg.max_points))
    sf = tuple(scale_factors)
    for g in kfs_into:
        m = local_mapping.fuse_into_keyframe(state, pts, int(g), cam, sf)
        state = local_mapping.apply_fusion(state, int(g), pts, m.idx)
    state = map_ops.update_point_stats(state, cfg)
    return map_ops.refresh_covis_rows(state, torch.as_tensor(sorted(kfs_into), device=state.device))


def merged_global_ba(state: MapState, kf_order: List[int], cfg: MapConfig, cam: Camera,
                     mesh=None, lm_iters: int = 10, cg_iters: int = 20) -> MapState:
    """Global BA over the merged map, distributed over `mesh`'s group when
    given (parallel/dist_ba.py), else on the map's device. Returns the
    refined state. As in the reference, the observation weights are
    looked up in `cfg.level_sigma2` itself, not in its inverse (ROADMAP
    queue 3 E)."""
    from ..engine.loop_closing import gather_global_ba_problem, pow2_bucket

    dev = state.device
    C = pow2_bucket(len(kf_order), 32, cfg.max_keyframes)
    cam_slots = np.full(C, -1, np.int64)
    cam_slots[: len(kf_order)] = kf_order
    cam_slots_t = torch.as_tensor(cam_slots, device=dev)
    problem, _, _ = gather_global_ba_problem(state, cam_slots_t, int(kf_order[0]), list(cfg.level_sigma2))
    if mesh is not None:
        from . import dist_ba

        res = dist_ba.distributed_bundle_adjust(problem, cam, mesh, lm_iters=lm_iters, cg_iters=cg_iters)
    else:
        res = ba.bundle_adjust(problem, cam, lm_iters=lm_iters, cg_iters=cg_iters)
    K = state.kf_pose.shape[0]
    kf_pose = torch.cat([state.kf_pose, state.kf_pose.new_zeros((1, 4, 4))])
    kf_pose[torch.where(cam_slots_t >= 0, cam_slots_t, torch.full_like(cam_slots_t, K))] = res.cam_pose.to(dev)
    mp_xyz = torch.where(state.mp_valid[:, None], res.xyz.to(dev), state.mp_xyz)
    return state._replace(kf_pose=kf_pose[:K], mp_xyz=mp_xyz)
