"""Dense FAST-9 scores, 3x3 NMS and the two-threshold cell fallback
(torch port of orb_slam_cuda_tpu/frontend/fast.py).

`fast_score` here is the plain version of the hand-written CUDA kernel in
`ops/fast_kernel.py`; both compute the same float32 subtractions, mins
and maxes, so they agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 — the 16 FAST offsets (row, col), clockwise.
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

_ARC = 9  # FAST-9: contiguous arc length


def _shifted_stack(img):
    """(16,H,W) of the image sampled at the circle offsets, edge-padded."""
    h, w = img.shape
    p = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    views = [p[3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] for dy, dx in CIRCLE]
    return torch.stack(views, dim=0)


def _arc_score(margin):
    """max over the 16 start positions of the min over 9 contiguous."""
    mins = margin
    rolled = margin
    for _ in range(_ARC - 1):
        rolled = torch.roll(rolled, -1, dims=0)
        mins = torch.minimum(mins, rolled)
    return torch.amax(mins, dim=0)


def corner_score(img):
    """(H,W) FAST-9 score before thresholding and border masking."""
    diff = _shifted_stack(img) - img[None]
    return torch.maximum(_arc_score(diff), _arc_score(-diff))


def _interior(h, w, device):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)


def fast_score(img, threshold: float):
    """Dense FAST-9 score map: 0 where not a corner, else the OpenCV-style
    score (strictly > threshold); the 3-px border ring is zeroed."""
    score = corner_score(img)
    keep = (score > threshold) & _interior(*img.shape, img.device)
    return torch.where(keep, score, torch.zeros_like(score))


def nms3x3(score):
    """3x3 non-maximum suppression. Scores are >= 0, so comparing against
    a 3x3 max pool (centre included, -inf padding) keeps exactly the
    pixels that are >= every zero-padded neighbour, as the reference."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= pooled, score, torch.zeros_like(score))


def two_threshold_cell_select(score_hi, score_lo, cell: int = 32):
    """Per cell: high-threshold corners if the cell has any, else the
    low-threshold ones (the reference's per-cell FAST fallback)."""
    h, w = score_hi.shape
    ph = (-h) % cell
    pw = (-w) % cell
    hi = F.pad(score_hi, (0, pw, 0, ph))
    hb = hi.reshape((h + ph) // cell, cell, (w + pw) // cell, cell)
    cell_has_hi = torch.amax(hb, dim=(1, 3)) > 0.0
    cell_mask = cell_has_hi.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    return torch.where(cell_mask, score_hi, score_lo)
