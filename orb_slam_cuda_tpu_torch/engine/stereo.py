"""Stereo / RGB-D depth association (torch port of
orb_slam_cuda_tpu/engine/stereo.py): one dense masked (N_L, N_R) Hamming
match with a row-band gate (Frame::ComputeStereoMatches), SAD subpixel
refinement as a batched gather of correlation strips on each keypoint's
own pyramid level, and the RGB-D depth lookup (ComputeStereoFromRGBD).
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend import image_ops
from ..geometry.camera import Camera
from ..matching import core
from ..ops import hamming

_SAD_W = 5  # half window (11x11)
_SAD_L = 5  # search range +-5 px on the keypoint's level


def match_stereo(l_uv, l_oct, l_bip, l_valid, r_uv, r_oct, r_bip, r_valid,
                 cam: Camera, scale_factors, left_img=None, right_img=None,
                 left_pyramid=None, right_pyramid=None):
    """Left->right matching on a rectified pair. `scale_factors` is a
    sequence or, for a call without host syncs, a float32 tensor on the
    features' device. Returns (u_right (N,),
    depth (N,)), -1 where unmatched (mvuRight/mvDepth):
      * row gate |v_r - v_l| <= 2 * scale[octave_l]; octaves within +-1;
      * disparity in (0.01, bf / b], b the baseline in meters;
      * Hamming <= (TH_HIGH + TH_LOW) / 2, first index among ties;
      * with both images (or both pyramids, as `image_ops.build_pyramid`
        gives them for those images), SAD subpixel refinement; a match
        whose SAD minimum lies on the rim of the search range is dropped.
    """
    dev = l_uv.device
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=dev)
    r_row = 2.0 * sf[torch.clamp(l_oct.long(), 0, sf.shape[0] - 1)]
    dv = torch.abs(l_uv[:, 1:2] - r_uv[None, :, 1])
    row_ok = dv <= r_row[:, None]
    oct_ok = torch.abs(l_oct[:, None] - r_oct[None, :]) <= 1
    disparity = l_uv[:, 0:1] - r_uv[None, :, 0]  # uL - uR
    bf, fx = np.float32(cam.bf), np.float32(cam.fx)
    max_d = float(bf / (bf / fx))  # minZ = the baseline
    disp_ok = (disparity > 0.01) & (disparity <= max_d)
    gate = row_ok & oct_ok & disp_ok & l_valid[:, None] & r_valid[None, :]

    dist = hamming.hamming_matrix(l_bip, r_bip).to(torch.float32)
    best_idx, best, _, _ = core.best_two(dist, gate)
    ok = best <= (core.TH_HIGH + core.TH_LOW) / 2.0

    ur = r_uv[best_idx, 0]
    if left_pyramid is None and left_img is not None and right_img is not None:
        n_levels = len(scale_factors)
        factor = float(scale_factors[1]) if n_levels > 1 else 1.0
        left_pyramid = image_ops.build_pyramid(torch.as_tensor(left_img, device=dev), n_levels, factor)
        right_pyramid = image_ops.build_pyramid(torch.as_tensor(right_img, device=dev), n_levels, factor)
    if left_pyramid is not None and right_pyramid is not None:
        ur_ref, sad_ok = _sad_subpixel(left_pyramid, right_pyramid, l_uv, l_oct, ur, scale_factors)
        ur = torch.where(sad_ok, ur_ref, ur)
        ok = ok & sad_ok

    disp = l_uv[:, 0] - ur
    ok = ok & (disp > 0.01)
    # A tensor numerator: torch turns scalar / tensor into a reciprocal and
    # a product, which rounds twice.
    depth = torch.full_like(disp, cam.bf) / torch.clamp(disp, min=1e-6)
    neg = torch.full_like(ur, -1.0)
    return torch.where(ok, ur, neg), torch.where(ok, depth, neg)


def _int_table(values, device):
    """(n,) int64 tensor of host ints, written by fills on the device: no
    host-to-device copy, which a CUDA-graph capture would refuse."""
    out = torch.empty((len(values),), dtype=torch.int64, device=device)
    for i, v in enumerate(values):
        out[i].fill_(int(v))
    return out


def _sad_subpixel(left_pyramid, right_pyramid, l_uv, l_oct, ur0, scale_factors):
    """Batched SAD correlation along the rectified row, each keypoint on
    its own level: both pyramids are flattened into one buffer and the
    11x11 windows gathered through a per-keypoint base offset. Window
    indices outside the level are clamped before the gather. Returns
    (ur refined, at level-0 scale; interior), `interior` False where the
    minimum lies on the rim of the +-5 px range."""
    dev = l_uv.device
    n_levels = len(scale_factors)
    shapes = [tuple(p.shape) for p in left_pyramid]
    flat_l = torch.cat([p.reshape(-1) for p in left_pyramid])
    flat_r = torch.cat([p.reshape(-1) for p in right_pyramid])
    offs = np.concatenate([[0], np.cumsum([h * w for h, w in shapes])])[:-1]
    hs = _int_table([h for h, _ in shapes], dev)
    ws = _int_table([w for _, w in shapes], dev)
    offs = _int_table(offs, dev)
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=dev)

    N = l_uv.shape[0]
    d = torch.arange(-_SAD_W, _SAD_W + 1, device=dev)
    oct_c = torch.clamp(l_oct.long(), 0, n_levels - 1)
    inv_s = 1.0 / sf[oct_c]
    yl = torch.round(l_uv[:, 1] * inv_s).to(torch.int64)
    xl = torch.round(l_uv[:, 0] * inv_s).to(torch.int64)
    xr0 = torch.round(ur0 * inv_s).to(torch.int64)
    base = offs[oct_c][:, None, None]
    h_k = hs[oct_c][:, None, None]
    w_k = ws[oct_c][:, None, None]

    def patch(flat, ys, xs):
        yy = torch.minimum(torch.clamp(ys[:, None, None] + d[None, :, None], min=0), h_k - 1)
        xx = torch.minimum(torch.clamp(xs[:, None, None] + d[None, None, :], min=0), w_k - 1)
        p = flat[base + yy * w_k + xx]
        return p - p[:, _SAD_W:_SAD_W + 1, _SAD_W:_SAD_W + 1]

    pl = patch(flat_l, yl, xl)
    sad = torch.stack([
        torch.sum(torch.abs(pl - patch(flat_r, yl, xr0 + off)), dim=(1, 2))
        for off in range(-_SAD_L, _SAD_L + 1)
    ], dim=1)  # (N, 2L+1)
    best = torch.argmin(sad, dim=1)
    interior = (best > 0) & (best < 2 * _SAD_L)
    bi = torch.clamp(best, 1, 2 * _SAD_L - 1)
    rows = torch.arange(N, device=dev)
    c = sad[rows, bi]
    l_ = sad[rows, bi - 1]
    r_ = sad[rows, bi + 1]
    denom = l_ + r_ - 2.0 * c
    delta = torch.where(torch.abs(denom) > 1e-6, (l_ - r_) / (2.0 * denom), torch.zeros_like(denom))
    delta = torch.clamp(delta, -1.0, 1.0)
    ur_ref = sf[oct_c] * (xr0.to(torch.float32) + (bi - _SAD_L).to(torch.float32) + delta)
    return ur_ref, interior


def depth_from_rgbd(uv_raw, valid, depth_map, cam: Camera, depth_factor: float = 1.0):
    """Per-keypoint depth, sampled at the RAW keypoint position (rounded,
    clamped into the map) and scaled by `depth_factor`; -1 where the
    feature is invalid or the map holds no depth."""
    h, w = depth_map.shape
    x = torch.clamp(torch.round(uv_raw[:, 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(uv_raw[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_map[y, x].to(torch.float32) * depth_factor
    return torch.where(valid & (d > 0), d, torch.full_like(d, -1.0))


def virtual_right(uv_und, depth, cam: Camera):
    """ur = u - bf/z at the undistorted keypoint, -1 without a depth."""
    ur = uv_und[:, 0] - torch.full_like(depth, cam.bf) / torch.clamp(depth, min=1e-6)
    return torch.where(depth > 0, ur, torch.full_like(ur, -1.0))
