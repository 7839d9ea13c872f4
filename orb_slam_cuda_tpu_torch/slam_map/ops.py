"""Batched map operations: covisibility, point statistics, culling (torch
port of orb_slam_cuda_tpu/slam_map/ops.py). Segment sums over the (K,N)
observation table are `index_add_` where the addends are 0/1 (exact in
any order) and go through `ops/segsum.py` where they are other floats, so
that they repeat bit for bit on CUDA; membership masks write True through
a trash slot so padding never touches a real index."""

from __future__ import annotations

import torch

from ..ops import hamming
from ..ops.segsum import segment_sum
from .state import MapConfig, MapState, slot_index


def _obs_valid(state: MapState):
    """(K,N) bool: genuine observations (valid KF row, bound point)."""
    return (state.kf_mp >= 0) & state.kf_valid[:, None]


def _seg(state: MapState):
    return torch.clamp(state.kf_mp, min=0).long()


def mark(n: int, idx, cond):
    """(n,) bool, True at idx[i] wherever cond[i] (an `.at[].max` of a
    bool mask); entries with ~cond land in a trash slot. (`index_fill_`:
    `out[i] = True` copies the host scalar to the device.)"""
    out = torch.zeros((n + 1,), dtype=torch.bool, device=idx.device)
    slots = torch.where(cond, idx.long(), torch.full_like(idx, n, dtype=torch.int64))
    return out.index_fill_(0, slots.reshape(-1), True)[:n]


def observation_counts(state: MapState):
    """(P,) int32 observations per map point."""
    P = state.mp_xyz.shape[0]
    counts = torch.zeros((P,), dtype=torch.int32, device=state.device)
    return counts.index_add_(0, _seg(state).reshape(-1), _obs_valid(state).reshape(-1).to(torch.int32))


def observation_matrix(state: MapState, dtype=torch.float32):
    """(K,P) incidence matrix (1 = keyframe observes point); test-size maps
    only, it materializes K*P."""
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    flat = torch.arange(K, device=state.device)[:, None] * P + _seg(state)
    obs = torch.zeros((K * P,), dtype=dtype, device=state.device)
    obs.index_add_(0, flat.reshape(-1), _obs_valid(state).reshape(-1).to(dtype))
    return obs.reshape(K, P)


_COVIS_TILE = 16384


def covisibility_matrix(state: MapState):
    """(K,K) int32 shared-point counts, diagonal zeroed, computed in tiles
    of the point axis (peak memory K*TILE)."""
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    dev = state.device
    tile = min(P, _COVIS_TILE)
    ov = _obs_valid(state)
    seg = _seg(state)
    rows = torch.arange(K, device=dev)[:, None].expand(K, N)
    w = torch.zeros((K, K), dtype=torch.float32, device=dev)
    for base in range(0, P, tile):
        local = seg - base
        in_tile = ov & (local >= 0) & (local < tile)
        A = torch.zeros((K * tile,), dtype=torch.float32, device=dev)
        A.index_add_(0, (rows * tile + torch.clamp(local, 0, tile - 1)).reshape(-1),
                     in_tile.reshape(-1).to(torch.float32))
        A = A.reshape(K, tile)
        w = w + A @ A.T
    w = w.to(torch.int32) * (1 - torch.eye(K, dtype=torch.int32, device=dev))
    valid2 = state.kf_valid[:, None] & state.kf_valid[None, :]
    return torch.where(valid2, w, torch.zeros_like(w))


def refresh_covis_rows(state: MapState, kf_ids) -> MapState:
    """Recompute covisibility rows/columns for kf_ids ((M,), -1 padded)."""
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    kf_ids = torch.as_tensor(kf_ids, device=state.device).long()
    ov = _obs_valid(state)
    seg = _seg(state)
    safe = torch.clamp(kf_ids, min=0)
    row_mp = state.kf_mp[safe].long()  # (M,N)
    cond = (row_mp >= 0) & state.kf_feat_valid[safe]
    M = kf_ids.shape[0]
    rows = torch.arange(M, device=state.device)
    col = torch.where(cond, row_mp, torch.full_like(row_mp, P))
    sel = torch.zeros((M * (P + 1),), dtype=torch.bool, device=state.device)
    sel = sel.index_fill_(0, (rows[:, None] * (P + 1) + col).reshape(-1), True).reshape(M, P + 1)[:, :P]
    hit = ov[None] & sel[:, seg]  # (M,K,N)
    w = torch.sum(hit, dim=2).to(torch.int32)
    w = torch.where(state.kf_valid[None, :] & state.kf_valid[safe][:, None], w, torch.zeros_like(w))
    w = w.reshape(-1).index_fill_(0, rows * K + safe, 0).reshape(M, K)
    idx = torch.where(kf_ids >= 0, kf_ids, torch.full_like(kf_ids, K))
    covis = torch.zeros((K + 1, K + 1), dtype=torch.int32, device=state.device)
    covis[:K, :K] = state.covis
    covis[idx, :K] = w
    covis[:K, idx] = w.T
    return state._replace(covis=covis[:K, :K].contiguous())


def covisibility_counts_for_bindings(state: MapState, point_ids):
    """(K,) int32 — how many of point_ids ((M,), -1 padded) each keyframe
    observes."""
    P = state.mp_xyz.shape[0]
    sel = mark(P, torch.clamp(point_ids, min=0), point_ids >= 0)
    hit = _obs_valid(state) & sel[_seg(state)]
    return torch.sum(hit, dim=1).to(torch.int32)


def points_of_keyframes(state: MapState, kf_mask):
    """(P,) bool — union of points observed by masked keyframes."""
    P = state.mp_xyz.shape[0]
    ov = _obs_valid(state) & kf_mask[:, None]
    return mark(P, _seg(state).reshape(-1), ov.reshape(-1)) & state.mp_valid


def _scatter(n, idx, src, reduce, fill, dtype=torch.float32):
    out = torch.full((n,), fill, dtype=dtype, device=src.device)
    return out.scatter_reduce(0, idx, src.to(dtype), reduce=reduce, include_self=True)


def update_point_stats(state: MapState, cfg: MapConfig) -> MapState:
    """Distinctive descriptors, normals, reference-KF repair and
    scale-distance bounds for all points, from the observation table."""
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    dev = state.device
    ov = _obs_valid(state).reshape(-1)
    flat_pt = _seg(state).reshape(-1)
    w = ov.to(torch.float32)
    inf = float("inf")

    # Distinctive descriptor: bit-mean, then the closest observation.
    desc_e = state.kf_desc.reshape(K * N, 8)
    bits = hamming.unpack_bits(desc_e).to(torch.float32)
    sum_bits = torch.zeros((P, hamming.N_BITS), dtype=torch.float32, device=dev)
    sum_bits.index_add_(0, flat_pt, bits * w[:, None])
    cnt = torch.zeros((P,), dtype=torch.float32, device=dev).index_add_(0, flat_pt, w)
    mean_bip = (sum_bits / torch.clamp(cnt, min=1.0)[:, None]) * 2.0 - 1.0
    obs_bip = bits * 2.0 - 1.0
    score = torch.sum(obs_bip * mean_bip[flat_pt], dim=-1)
    score = torch.where(ov, score, torch.full_like(score, -inf))
    best_score = _scatter(P, flat_pt, score, "amax", -inf)
    is_best = score >= best_score[flat_pt]
    e_idx = torch.arange(K * N, dtype=torch.float32, device=dev)
    cand = torch.where(is_best & ov, e_idx, torch.full_like(e_idx, inf))
    best_e = _scatter(P, flat_pt, cand, "amin", inf)
    has_obs = cnt > 0
    best_e_i = torch.clamp(best_e, 0, K * N - 1).long()
    new_desc = torch.where(has_obs[:, None], desc_e[best_e_i], state.mp_desc)

    # Normal: mean unit vector from the observing camera centres.
    R = state.kf_pose[:, :3, :3]
    t = state.kf_pose[:, :3, 3]
    centers = -torch.einsum("kij,ki->kj", R.transpose(1, 2), t)
    centers_e = centers.repeat_interleave(N, dim=0)
    vec = state.mp_xyz[flat_pt] - centers_e
    vec = vec / torch.clamp(torch.linalg.norm(vec, dim=-1, keepdim=True), min=1e-9)
    sum_n = segment_sum(P, flat_pt, vec * w[:, None])
    normal = sum_n / torch.clamp(torch.linalg.norm(sum_n, dim=-1, keepdim=True), min=1e-9)
    new_normal = torch.where(has_obs[:, None], normal, state.mp_normal)

    # Reference-keyframe repair: a culled ref moves to the lowest observer.
    kf_of_e_f = torch.arange(K, dtype=torch.float32, device=dev).repeat_interleave(N)
    min_obs_kf = _scatter(P, flat_pt, torch.where(ov, kf_of_e_f, torch.full_like(kf_of_e_f, inf)), "amin", inf)
    ref_old = state.mp_ref_kf
    ref_invalid = ~state.kf_valid[torch.clamp(ref_old, min=0).long()] | (ref_old < 0)
    new_ref = torch.where(ref_invalid & has_obs,
                          torch.clamp(min_obs_kf, 0, K - 1).to(torch.int32), ref_old)

    # Scale-distance bounds from the reference keyframe observation.
    ref = torch.clamp(new_ref, min=0).long()
    dist = torch.linalg.norm(state.mp_xyz - centers[ref], dim=-1)
    kf_of_e = torch.arange(K, device=dev).repeat_interleave(N)
    is_ref_obs = ov & (kf_of_e == ref[flat_pt])
    oct_e = state.kf_oct.reshape(-1).to(torch.float32)
    ref_oct = _scatter(P, flat_pt, torch.where(is_ref_obs, oct_e, torch.full_like(oct_e, -inf)), "amax", 0.0)
    ref_oct = torch.clamp(ref_oct, 0, cfg.n_levels - 1)
    max_dist = dist * cfg.scale_factor**ref_oct
    min_dist = max_dist / (cfg.scale_factor ** (cfg.n_levels - 1))
    return state._replace(
        mp_ref_kf=new_ref,
        mp_desc=new_desc,
        mp_normal=new_normal,
        mp_max_dist=torch.where(has_obs, max_dist, state.mp_max_dist),
        mp_min_dist=torch.where(has_obs, min_dist, state.mp_min_dist),
    )


def cull_points(state: MapState, probation_mask, age, min_found_ratio: float = 0.25,
                th_obs: int = 2):
    """(P,) bool points to erase (MapPointCulling on the probation list)."""
    obs = observation_counts(state)
    ratio_bad = state.mp_found / torch.clamp(state.mp_visible, min=1.0) < min_found_ratio
    few_obs_bad = (age >= 2) & (obs <= th_obs)
    return probation_mask & state.mp_valid & (ratio_bad | few_obs_bad)


def keyframe_redundancy(state: MapState, kf_slot, th_scale_slack: int = 1):
    """Fraction of this keyframe's points seen by >= 3 other keyframes at
    equal-or-finer scale (KeyFrameCulling's 90% rule)."""
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    s = slot_index(kf_slot, state.device)
    row_mp = state.kf_mp[s][0].long()
    row_valid = row_mp >= 0
    row_oct = state.kf_oct[s][0]
    safe = torch.clamp(row_mp, min=0)
    oct_ceiling = _scatter(P, safe, torch.where(row_valid, row_oct + th_scale_slack, torch.zeros_like(row_oct)),
                           "amax", 0, dtype=torch.int32)
    in_row = mark(P, safe, row_valid)
    seg = _seg(state)
    counted = (
        _obs_valid(state)
        & in_row[seg]
        & (state.kf_oct <= oct_ceiling[seg])
        & (torch.arange(K, device=state.device)[:, None] != s)
    )
    per_point = torch.zeros((P,), dtype=torch.int32, device=state.device)
    per_point.index_add_(0, seg.reshape(-1), counted.reshape(-1).to(torch.int32))
    redundant = in_row & (per_point >= 3)
    n_pts = torch.sum(in_row)
    return torch.sum(redundant) / torch.clamp(n_pts, min=1)


def sanitize_bindings(state: MapState, mp):
    """Drop bindings to invalid point slots."""
    ok = (mp >= 0) & state.mp_valid[torch.clamp(mp, min=0).long()]
    return torch.where(ok, mp, torch.full_like(mp, -1))


def _increase(arr, point_ids, amount):
    sel = point_ids >= 0
    idx = torch.clamp(point_ids, min=0).long()
    if amount is None:  # 0/1 addends: exact in any order
        return arr.clone().index_add_(0, idx, sel.to(torch.float32))
    # `arr` enters as each segment's first addend, so the sum is index_add_'s.
    n = arr.shape[0]
    seg = torch.cat([torch.arange(n, device=arr.device), idx])
    return segment_sum(n, seg, torch.cat([arr, torch.where(sel, amount, torch.zeros_like(amount))]))


def increase_visible(state: MapState, point_ids, amount=None) -> MapState:
    return state._replace(mp_visible=_increase(state.mp_visible, point_ids, amount))


def increase_found(state: MapState, point_ids, amount=None) -> MapState:
    return state._replace(mp_found=_increase(state.mp_found, point_ids, amount))


def top_covisible(covis_row, n: int):
    """Indices of the n largest-weight entries (weight > 0, -1 padded, lower
    index first among ties), always (n,)-shaped."""
    k = min(n, covis_row.shape[-1])
    w, idx = torch.sort(covis_row, dim=-1, descending=True, stable=True)
    w, idx = w[..., :k], idx[..., :k]
    out = torch.where(w > 0, idx, torch.full_like(idx, -1))
    if k < n:
        pad = torch.full(out.shape[:-1] + (n - k,), -1, dtype=out.dtype, device=out.device)
        out = torch.cat([out, pad], dim=-1)
    return out
