"""Batched matching primitives: best/second-best scan, rotation histogram,
duplicate-target suppression (torch port of
orb_slam_cuda_tpu/matching/core.py)."""

from __future__ import annotations

import torch

INF = 3.0e4
TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30


def best_two(dist, gate):
    """Per-row best and second-best over gated columns. Returns
    (best_idx (Q,) int64, best (Q,), second (Q,), second_idx (Q,));
    argmin takes the first index among ties, as the reference."""
    d = torch.where(gate, dist.to(torch.float32), torch.full_like(dist, INF, dtype=torch.float32))
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)
    d_wo_best = torch.where(cols[None, :] == best_idx[:, None], torch.full_like(d, INF), d)
    second_idx = torch.argmin(d_wo_best, dim=1)
    second = torch.gather(d_wo_best, 1, second_idx[:, None])[:, 0]
    return best_idx, best, second, second_idx


def rotation_consistency(rot_deg, valid, histo_length: int = HISTO_LENGTH,
                         keep_top: int = 3):
    """Keep matches whose orientation difference falls in the `keep_top`
    most populated bins (ComputeThreeMaxima with its 0.1*max1 rule)."""
    factor = histo_length / 360.0
    b = torch.round(rot_deg * factor).to(torch.int64)
    b = torch.where(b == histo_length, torch.zeros_like(b), b)
    b = torch.remainder(b, histo_length)
    bins = torch.arange(histo_length, device=b.device)
    hist = torch.sum(valid[:, None] & (b[:, None] == bins[None, :]), dim=0)
    order = torch.argsort(-hist, stable=True)
    max1 = hist[order[:1]].to(torch.float32)  # (1,): `hist[order[0]]` would read order[0] back
    keep_bins = order[:keep_top]
    keep_counts = hist[keep_bins].to(torch.float32)
    bin_ok = keep_counts >= 0.1 * max1
    bin_ok[0].fill_(True)  # `= True` would copy a host scalar to the device
    match_bin_ok = torch.any((b[:, None] == keep_bins[None, :]) & bin_ok[None, :], dim=1)
    return valid & match_bin_ok


def resolve_duplicate_targets(target_idx, dist, valid, n_targets: int):
    """Each target claimed by at most one query: keep the lowest
    (distance, query index) key. Invalid queries park in an overflow bin."""
    q = torch.arange(target_idx.shape[0], dtype=torch.float32, device=dist.device)
    key = dist * 1e6 + q
    key = torch.where(valid, key, torch.full_like(key, float("inf")))
    tgt = torch.where(valid, target_idx.to(torch.int64), torch.full_like(target_idx, n_targets, dtype=torch.int64))
    best_key = torch.full((n_targets + 1,), float("inf"), dtype=torch.float32, device=dist.device)
    best_key = best_key.scatter_reduce(0, tgt, key, reduce="amin", include_self=True)
    return valid & (key <= best_key[tgt])
