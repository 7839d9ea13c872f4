"""The ORBmatcher search strategies as masked dense matches (torch port of
orb_slam_cuda_tpu/matching/search.py). Outputs are per-query target
indices (-1 = unmatched)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import hamming
from . import core


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (Q,) int64 matched target index or -1
    dist: torch.Tensor  # (Q,) float32 Hamming distance (INF if unmatched)

    @property
    def valid(self):
        return self.idx >= 0

    def count(self):
        return torch.sum(self.idx >= 0)


def _sf(scale_factors, device):
    return torch.as_tensor(scale_factors, dtype=torch.float32, device=device)


def _finalize(best_idx, best, gate_ok, n_targets, resolve=True):
    valid = gate_ok & (best < core.INF)
    if resolve:
        valid = core.resolve_duplicate_targets(best_idx, best, valid, n_targets)
    idx = torch.where(valid, best_idx, torch.full_like(best_idx, -1))
    dist = torch.where(valid, best, torch.full_like(best, core.INF))
    return MatchResult(idx=idx, dist=dist)


def by_projection(
    q_uv, q_bip, q_valid, q_pred_octave,
    t_uv, t_oct, t_ang, t_bip, t_valid,
    scale_factors,
    radius: float,
    q_ang=None,
    max_dist: float = core.TH_HIGH,
    ratio: float = 0.9,
    octave_lo_off: int = -1,
    octave_hi_off: int = 1,
    ratio_same_level_only: bool = True,
    check_rotation: bool = False,
    t_has_point=None,
    q_radius_scale=None,
):
    """Projection-window search (SearchByProjection map->frame and
    frame->frame), gated by window, octave band, validity and has-point."""
    sf = _sf(scale_factors, q_uv.device)
    r = radius * sf[torch.clamp(q_pred_octave.long(), 0, sf.shape[0] - 1)]
    if q_radius_scale is not None:
        r = r * q_radius_scale
    du = torch.abs(q_uv[:, 0:1] - t_uv[None, :, 0])
    dv = torch.abs(q_uv[:, 1:2] - t_uv[None, :, 1])
    window = (du <= r[:, None]) & (dv <= r[:, None])
    oct_lo = q_pred_octave[:, None] + octave_lo_off
    oct_hi = q_pred_octave[:, None] + octave_hi_off
    octave_ok = (t_oct[None, :] >= oct_lo) & (t_oct[None, :] <= oct_hi)
    gate = window & octave_ok & q_valid[:, None] & t_valid[None, :]
    if t_has_point is not None:
        gate = gate & ~t_has_point[None, :]

    dist = hamming.hamming_matrix(q_bip, t_bip).to(torch.float32)
    best_idx, best, second, second_idx = core.best_two(dist, gate)

    ok = best <= max_dist
    best_lvl = t_oct[best_idx]
    second_lvl = t_oct[second_idx]
    if ratio_same_level_only:
        ratio_applies = (best_lvl == second_lvl) & (second < core.INF)
    else:
        ratio_applies = second < core.INF
    ok = ok & ~(ratio_applies & (best > ratio * second))

    if check_rotation:
        rot = q_ang - t_ang[best_idx]
        ok = ok & core.rotation_consistency(rot, ok)

    return _finalize(best_idx, best, ok, t_uv.shape[0])


def for_initialization(
    f1_uv, f1_bip, f1_valid, f1_ang,
    f2_uv, f2_bip, f2_valid, f2_ang, f2_oct,
    f1_oct,
    window: float = 100.0,
    ratio: float = 0.9,
    max_dist: float = core.TH_LOW,
):
    """SearchForInitialization: level-0 only, square window, TH_LOW,
    ratio, rotation histogram, duplicate suppression."""
    du = torch.abs(f1_uv[:, 0:1] - f2_uv[None, :, 0])
    dv = torch.abs(f1_uv[:, 1:2] - f2_uv[None, :, 1])
    gate = (
        (du <= window) & (dv <= window)
        & f1_valid[:, None] & f2_valid[None, :]
        & (f1_oct[:, None] == 0) & (f2_oct[None, :] == 0)
    )
    dist = hamming.hamming_matrix(f1_bip, f2_bip).to(torch.float32)
    best_idx, best, second, _ = core.best_two(dist, gate)
    ok = (best <= max_dist) & (best <= ratio * second)
    rot = f1_ang - f2_ang[best_idx]
    ok = ok & core.rotation_consistency(rot, ok)
    return _finalize(best_idx, best, ok, f2_uv.shape[0])


def by_bow(
    f1_nodes, f1_bip, f1_valid, f1_ang,
    f2_nodes, f2_bip, f2_valid, f2_ang,
    ratio: float = 0.7,
    max_dist: float = core.TH_LOW,
    check_rotation: bool = True,
    f1_has_point=None,
    f2_has_point=None,
):
    """SearchByBoW: candidates share the levelsup vocabulary node."""
    gate = (f1_nodes[:, None] == f2_nodes[None, :]) & f1_valid[:, None] & f2_valid[None, :]
    if f1_has_point is not None:
        gate = gate & f1_has_point[:, None]
    if f2_has_point is not None:
        gate = gate & ~f2_has_point[None, :]
    dist = hamming.hamming_matrix(f1_bip, f2_bip).to(torch.float32)
    best_idx, best, second, _ = core.best_two(dist, gate)
    ok = (best <= max_dist) & (best <= ratio * second)
    if check_rotation:
        rot = f1_ang - f2_ang[best_idx]
        ok = ok & core.rotation_consistency(rot, ok)
    return _finalize(best_idx, best, ok, f2_nodes.shape[0])


def for_triangulation(
    f1_nodes, f1_bip, f1_valid, f1_ang, f1_uv, f1_oct,
    f2_nodes, f2_bip, f2_valid, f2_ang, f2_uv, f2_oct,
    F12,
    level_sigma2,
    epipole_uv=None,
    scale_factors=None,
    ratio: float = 1.0,
    max_dist: float = core.TH_LOW,
    check_rotation: bool = True,
    f1_has_point=None,
    f2_has_point=None,
):
    """SearchForTriangulation: BoW node gate + epipolar distance
    < 3.84*sigma2[octave2] + epipole rejection; unbound features only."""
    dev = f1_uv.device
    gate = (f1_nodes[:, None] == f2_nodes[None, :]) & f1_valid[:, None] & f2_valid[None, :]
    if f1_has_point is not None:
        gate = gate & ~f1_has_point[:, None]
    if f2_has_point is not None:
        gate = gate & ~f2_has_point[None, :]

    # Epipolar line of each f1 feature, then the distance of every f2
    # feature to it (epipolar_distance_sq, expanded over the pairs).
    x1h = torch.cat([f1_uv, torch.ones_like(f1_uv[:, :1])], dim=-1)
    line = x1h @ F12
    a, b, c = line[:, 0:1], line[:, 1:2], line[:, 2:3]
    num = a * f2_uv[None, :, 0] + b * f2_uv[None, :, 1] + c
    d2 = num * num / torch.clamp(a * a + b * b, min=1e-12)
    sig2_t = _sf(level_sigma2, dev)
    sig2 = sig2_t[torch.clamp(f2_oct.long(), 0, sig2_t.shape[0] - 1)]
    gate = gate & (d2 < 3.84 * sig2[None, :])

    if epipole_uv is not None and scale_factors is not None:
        sf_t = _sf(scale_factors, dev)
        sf = sf_t[torch.clamp(f2_oct.long(), 0, sf_t.shape[0] - 1)]
        de2 = torch.sum((f2_uv - epipole_uv[None, :]) ** 2, dim=-1)
        gate = gate & (de2 >= 100.0 * sf)[None, :]

    dist = hamming.hamming_matrix(f1_bip, f2_bip).to(torch.float32)
    best_idx, best, second, _ = core.best_two(dist, gate)
    ok = best <= max_dist
    if ratio < 1.0:
        ok = ok & (best <= ratio * second)
    if check_rotation:
        rot = f1_ang - f2_ang[best_idx]
        ok = ok & core.rotation_consistency(rot, ok)
    return _finalize(best_idx, best, ok, f2_nodes.shape[0])


def fuse(
    p_uv, p_bip, p_valid, p_pred_octave,
    t_uv, t_oct, t_bip, t_valid,
    scale_factors,
    radius: float = 3.0,
    max_dist: float = core.TH_LOW,
):
    """ORBmatcher::Fuse matching: window r*scale[pred], levels
    [pred-1, pred+1], TH_LOW, no ratio, no rotation check."""
    return by_projection(
        p_uv, p_bip, p_valid, p_pred_octave,
        t_uv, t_oct, torch.zeros_like(t_uv[:, 0]), t_bip, t_valid,
        scale_factors,
        radius=radius,
        max_dist=max_dist,
        ratio=1.0,
        octave_lo_off=-1,
        octave_hi_off=1,
        ratio_same_level_only=True,
        check_rotation=False,
    )


def predict_octave(dist_to_point, max_distance, log_scale_factor, n_levels):
    """MapPoint::PredictScale: ceil(log(maxDist/dist)/log(scale)) clipped."""
    ratio = max_distance / torch.clamp(dist_to_point, min=1e-9)
    lvl = torch.ceil(torch.log(ratio) / log_scale_factor)
    lvl = torch.nan_to_num(lvl, nan=0.0).clamp(-1, n_levels)
    return torch.clamp(lvl.to(torch.int32), 0, n_levels - 1)
