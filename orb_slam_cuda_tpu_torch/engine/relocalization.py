"""Relocalization: BoW candidate retrieval, guided matching and the staged
pose ladder (torch port of orb_slam_cuda_tpu/engine/relocalization.py).

Per candidate, best BoW score first: SearchByBoW (>= 15 matches), EPnP
RANSAC, pose-only LM on its inliers; under 50 inliers a wide th=10 /
Hamming 100 projection search and re-optimization; at 30-49 after that a
narrow th=3 / Hamming 64 retry; accepted at >= 50. The reference's
`lax.cond` ladder is host `if`s on the inlier counts here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..geometry.camera import Camera
from ..matching import search
from ..ops import hamming
from ..slam_map import MapState, keyframe_db
from ..slam_map import ops as map_ops
from ..solvers import pnp
from ..solvers.initializer import default_sampler
from . import tracking
from .frame import FrameData

MIN_BOW_MATCHES = 15
MIN_INLIERS_ACCEPT = 50
NARROW_RETRY_MIN = 30
WIDE_TH, WIDE_HAM = 10.0, 100.0
NARROW_TH, NARROW_HAM = 3.0, 64.0


def _staged_refine(state: MapState, frame: FrameData, kf: int, pose0, mp0, cam: Camera,
                   scale_factors):
    """Stages 3-5 of the ladder. Returns (pose, bindings, n_good, n after
    the first optimization, n after the wide stage)."""
    kf_mp = state.kf_mp[kf]
    safe_mp = torch.clamp(kf_mp, min=0).long()
    kf_has = (kf_mp >= 0) & state.mp_valid[safe_mp]
    kf_bip = hamming.bipolar(state.kf_desc[kf])
    kf_feat_ok = state.kf_feat_valid[kf] & kf_has
    P = state.mp_xyz.shape[0]

    def optimize(pose, mp):
        return tracking._optimize_and_prune(state, frame, pose, mp, cam, scale_factors)

    def widen_search(pose, mp, radius, ham):
        """SearchByProjection of the candidate's points not found yet."""
        already = map_ops.mark(P, torch.clamp(mp, min=0), mp >= 0)
        Xc = se3.transform(pose, state.mp_xyz[safe_mp])
        q_ok = kf_feat_ok & ~already[safe_mp] & (Xc[:, 2] > 0)
        m = search.by_projection(
            cam_mod.project(cam, Xc), kf_bip, q_ok, state.kf_oct[kf],
            frame.uv, frame.oct, frame.ang, frame.bip, frame.valid,
            scale_factors, radius=radius, q_ang=state.kf_ang[kf],
            max_dist=ham, ratio=1.0, check_rotation=True, t_has_point=mp >= 0,
        )
        return tracking._bind(mp.shape[0], m.idx, kf_mp, m.idx >= 0, base=mp)

    pose1, mp1, n1 = optimize(pose0, mp0)
    if int(n1) >= MIN_INLIERS_ACCEPT:
        return pose1, mp1, n1, n1, n1
    pose2, mp2, n2 = optimize(pose1, widen_search(pose1, mp1, WIDE_TH, WIDE_HAM))
    if not NARROW_RETRY_MIN <= int(n2) < MIN_INLIERS_ACCEPT:
        return pose2, mp2, n2, n1, n2
    pose3, mp3, n3 = optimize(pose2, widen_search(pose2, mp2, NARROW_TH, NARROW_HAM))
    return pose3, mp3, n3, n1, n2


def relocalize(state: MapState, db, frame: FrameData, cam: Camera, n_words: int,
               scale_factors, max_candidates: int = 5, stats: dict = None, sampler=None,
               trace: list = None):
    """Try candidates best-score-first; return (pose, bindings, ok).

    `stats`, if given, counts the rung that produced the accepted pose
    ('bow', 'wide', 'narrow') and 'fail' per exhausted query. `sampler(site,
    seed, valid)` gives the EPnP minimal sets, seeded with the candidate's
    slot (default: `initializer.default_sampler`). `trace`, if given,
    receives one dict per candidate tried: its slot, BoW score and match
    count, then as far as it got the EPnP verdict and the inliers after
    each rung, and the rung that refused it under "refused_at"."""
    sampler = sampler or default_sampler
    wu, wt = keyframe_db.compute_bow_row(frame.word, frame.idf, frame.valid)
    q_dense = keyframe_db.dense_bow(wu, wt, n_words)
    cand_mask, scores = keyframe_db.detect_candidates(db, q_dense, torch.zeros_like(db.valid), state.covis)
    cand_mask = cand_mask.cpu().numpy()
    scores = scores.cpu().numpy()
    order = np.argsort(-scores)
    cands = [int(k) for k in order if cand_mask[k]][:max_candidates]

    sig2 = torch.as_tensor(scale_factors, dtype=torch.float32, device=state.device) ** 2
    max_oct = sig2.shape[0] - 1
    for kf in cands:
        kf_mp = state.kf_mp[kf]
        safe_mp = torch.clamp(kf_mp, min=0).long()
        kf_has = (kf_mp >= 0) & state.mp_valid[safe_mp]
        m = search.by_bow(
            state.kf_node[kf], hamming.bipolar(state.kf_desc[kf]), state.kf_feat_valid[kf],
            state.kf_ang[kf], frame.node, frame.bip, frame.valid, frame.ang,
            ratio=0.75, check_rotation=True, f1_has_point=kf_has,
        )
        ok_pair = m.idx >= 0
        n_pairs = int(torch.sum(ok_pair))
        row = dict(kf=kf, score=float(scores[kf]), bow_matches=n_pairs)
        if trace is not None:
            trace.append(row)
        if n_pairs < MIN_BOW_MATCHES:
            row["refused_at"] = "bow_matches"
            continue
        j = torch.clamp(m.idx, min=0)
        err_th2 = 5.991 * sig2[torch.clamp(frame.oct[j].long(), 0, max_oct)]
        valid = ok_pair & kf_has
        res = pnp.solve_pnp_ransac(state.mp_xyz[safe_mp], frame.uv[j], valid, err_th2, cam,
                                   sample_sets=sampler("pnp", kf, valid))
        if trace is not None:
            row["pnp_inliers"] = int(torch.sum(res.inliers & ok_pair))
        if not bool(res.ok):
            row["refused_at"] = "pnp"
            continue
        mp = tracking._bind(frame.capacity, m.idx, kf_mp, res.inliers & ok_pair)
        pose2, mp2, n_good, n_bow, n_wide = _staged_refine(
            state, frame, kf, res.pose, mp, cam, scale_factors)
        if trace is not None:
            row.update(n_bow=int(n_bow), n_wide=int(n_wide), n_good=int(n_good))
        if int(n_good) < MIN_INLIERS_ACCEPT:
            row["refused_at"] = "ladder"
        else:
            if stats is not None:
                stage = ("bow" if int(n_bow) >= MIN_INLIERS_ACCEPT
                         else "wide" if int(n_wide) >= MIN_INLIERS_ACCEPT else "narrow")
                stats[stage] = stats.get(stage, 0) + 1
            return pose2, mp2, True
    if stats is not None:
        stats["fail"] = stats.get("fail", 0) + 1
    return None, None, False
