"""The ORB extraction graph: pyramid -> FAST -> spatial top-K -> IC-angle
-> blur -> binned rBRIEF (torch port of
orb_slam_cuda_tpu/frontend/extractor.py).

On a CUDA tensor the corner maps of all pyramid levels (FAST at both
thresholds, NMS, the per-cell choice, the keypoint border) come from one
launch of the hand-written kernel (ops/fast_kernel.py); on a CPU tensor
from its plain version.
The binned rBRIEF gathers the 512 rotated pattern samples straight from
the blurred patch (the TPU's one-hot matmul exists only for the MXU) and
rounds each sample to bf16 before comparing, as the reference does.
The continuous-rotation descriptor (`rotation_bins=0`) is not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import fast_kernel, hamming
from ..utils.device import resolve as resolve_device
from . import fast, image_ops

_PATTERN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "brief_pattern_31.npy")
HALF_PATCH = 15  # IC-angle circular patch radius
EDGE_THRESHOLD = 19  # keypoint exclusion border
DESC_PATCH = 39  # covers rotated BRIEF offsets (max pattern radius 18.4)
DESC_C = 19  # patch centre


class ExtractorConfig(NamedTuple):
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    rotation_bins: int = 30

    def features_per_level(self):
        """Geometric per-level quota (ORBextractor ctor)."""
        factor = 1.0 / self.scale_factor
        n_first = self.n_features * (1 - factor) / (1 - factor**self.n_levels)
        quotas = []
        acc = 0
        for lvl in range(self.n_levels - 1):
            q = int(round(n_first * factor**lvl))
            quotas.append(q)
            acc += q
        quotas.append(max(self.n_features - acc, 0))
        return quotas

    def scale_factors(self):
        return [self.scale_factor**lvl for lvl in range(self.n_levels)]


class Features(NamedTuple):
    """Fixed-capacity keypoint batch: uv (N,2) level-0 coords, response
    (N,), octave (N,) int32, angle (N,) degrees, desc (N,8) int32 packed,
    valid (N,) bool."""

    uv: torch.Tensor
    response: torch.Tensor
    octave: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self):
        return self.uv.shape[-2]


def load_brief_pattern() -> np.ndarray:
    """(256,4) int8 canonical ORB pattern, from this package's own copy of
    the data file."""
    return np.load(_PATTERN_PATH)


def _ic_angle_offsets():
    """(M,2) int32 (dy,dx) of the circular IC patch (reference umax)."""
    umax = np.zeros(HALF_PATCH + 1, np.int32)
    vmax = int(math.floor(HALF_PATCH * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(HALF_PATCH * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(math.sqrt(HALF_PATCH * HALF_PATCH - v * v)))
    v0 = 0
    for v in range(HALF_PATCH, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    offs = []
    for dy in range(-HALF_PATCH, HALF_PATCH + 1):
        u = int(umax[abs(dy)])
        for dx in range(-u, u + 1):
            offs.append((dy, dx))
    return np.array(offs, np.int32)


def _angle_moment_weights():
    """m10/m01 weights over the flattened 39x39 patch."""
    w10 = np.zeros(DESC_PATCH * DESC_PATCH, np.float32)
    w01 = np.zeros(DESC_PATCH * DESC_PATCH, np.float32)
    for dy, dx in _ic_angle_offsets():
        i = (dy + DESC_C) * DESC_PATCH + (dx + DESC_C)
        w10[i] = dx
        w01[i] = dy
    return w10, w01


def build_rotation_index(pattern_np: np.ndarray, nbins: int) -> np.ndarray:
    """(B,512) int64 flat patch index of each rotated pattern point, with
    the reference's rounding (row = round(px*sin + py*cos), col =
    round(px*cos - py*sin)). Rows 0..255 are the first points of the pairs,
    256..511 the second."""
    px = np.concatenate([pattern_np[:, 0], pattern_np[:, 2]]).astype(np.float64)
    py = np.concatenate([pattern_np[:, 1], pattern_np[:, 3]]).astype(np.float64)
    out = np.zeros((nbins, 512), np.int64)
    for b in range(nbins):
        th = np.radians(b * 360.0 / nbins)
        a, s = np.cos(th), np.sin(th)
        r = np.rint(px * s + py * a).astype(np.int64)
        c = np.rint(px * a - py * s).astype(np.int64)
        out[b] = (r + DESC_C) * DESC_PATCH + (c + DESC_C)
    return out


def topk_stable(x, k: int):
    """Largest k along the last axis, lower index first among ties (the
    order lax.top_k gives; torch.topk promises none)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _select_spatial_topk(score, quota: int, border: int = 0):
    """Grid-bucketed spatial top-K: order candidates by (per-bin rank,
    -score) and keep `quota`. Returns (ys, xs, scores, valid), each (quota,).
    `border` > 0 zeroes that border of `score` first; the extractor passes
    maps whose border is already zeroed."""
    h, w = score.shape
    dev = score.device
    if border > 0:
        score = fast.border_mask(score, border)

    bin_size = int(np.clip(round(math.sqrt(h * w / max(quota, 1))), 16, 64))
    rank_depth = 4
    ph = (-h) % bin_size
    pw = (-w) % bin_size
    sp = F.pad(score, (0, pw, 0, ph))
    hb, wb = (h + ph) // bin_size, (w + pw) // bin_size
    binned = sp.reshape(hb, bin_size, wb, bin_size).permute(0, 2, 1, 3)
    binned = binned.reshape(hb * wb, bin_size * bin_size)
    top_v, top_i = topk_stable(binned, rank_depth)

    bin_ids = torch.arange(hb * wb, device=dev)
    by = (bin_ids // wb)[:, None] * bin_size
    bx = (bin_ids % wb)[:, None] * bin_size
    cy = by + top_i // bin_size
    cx = bx + top_i % bin_size

    ranks = torch.arange(rank_depth, device=dev)[None, :].expand(top_v.shape)
    valid = top_v > 0.0
    key = torch.where(valid, ranks.to(torch.float32) * 2048.0 - top_v,
                      torch.full_like(top_v, float("inf")))
    _, sel = topk_stable(-key.reshape(-1), quota)
    ys = cy.reshape(-1)[sel]
    xs = cx.reshape(-1)[sel]
    vs = top_v.reshape(-1)[sel]
    ok = valid.reshape(-1)[sel]
    return ys, xs, vs, ok


def _extract_patches(img, ys, xs):
    """(N,39,39) patches centred on keypoints. Start offsets are clamped
    into the image, as the reference's dynamic slices clamp them."""
    h, w = img.shape
    y0 = torch.clamp(ys - DESC_C, 0, h - DESC_PATCH)
    x0 = torch.clamp(xs - DESC_C, 0, w - DESC_PATCH)
    ar = torch.arange(DESC_PATCH, device=img.device)
    idx = (y0[:, None, None] + ar[None, :, None]) * w + (x0[:, None, None] + ar[None, None, :])
    return img.reshape(-1)[idx]


def _ic_angle_from_patches(patches_flat, w10, w01):
    """IC-angle in degrees [0,360) from flattened raw patches (N,1521)."""
    m10 = patches_flat @ w10
    m01 = patches_flat @ w01
    ang = torch.rad2deg(torch.atan2(m01, m10))
    return torch.where(ang < 0, ang + 360.0, ang)


def _rbrief_binned(patches_flat, angle_deg, rot_index, nbins: int):
    """Rotated BRIEF with the angle quantized to `nbins`: gather the 512
    rotated samples, round them to bf16, compare pairs; packed (N,8) int32."""
    step = 360.0 / nbins
    bins = torch.remainder(torch.round(angle_deg / step).to(torch.int64), nbins)
    samples = torch.gather(patches_flat, 1, rot_index[bins])
    samples = samples.to(torch.bfloat16).to(torch.float32)
    bits = samples[:, :256] < samples[:, 256:]
    return hamming.pack_bits(bits)


class ORBExtractor:
    """Extraction for a fixed image size on one device."""

    def __init__(self, config: ExtractorConfig, height: int, width: int, device="cuda"):
        if config.rotation_bins <= 0:
            raise NotImplementedError("continuous-rotation rBRIEF (rotation_bins=0) is not ported")
        self.config = config
        self.height = height
        self.width = width
        self.device = resolve_device(device)
        # One buffer for the corner maps of all levels, reused every frame:
        # the maps are consumed within the `_extract_impl` call that fills them.
        self._corner_maps = fast_kernel.pyramid_buffers(
            image_ops.pyramid_shapes(height, width, config.n_levels, config.scale_factor),
            self.device,
        )
        self.rot_index = torch.as_tensor(
            build_rotation_index(load_brief_pattern(), config.rotation_bins),
            device=self.device,
        )
        w10, w01 = _angle_moment_weights()
        self.w10 = torch.as_tensor(w10, device=self.device)
        self.w01 = torch.as_tensor(w01, device=self.device)

    def __call__(self, image) -> Features:
        """image: (H,W) uint8/float32 grayscale, numpy or tensor."""
        img = torch.as_tensor(image).to(self.device)
        return self._extract_impl(img)

    def _extract_impl(self, image) -> Features:
        cfg = self.config
        levels = image_ops.build_pyramid(image, cfg.n_levels, cfg.scale_factor)
        quotas = cfg.features_per_level()
        scales = cfg.scale_factors()
        uts, ress, octs, vals, praws, pblurs = [], [], [], [], [], []
        scores = fast_kernel.fast_corners_pyramid(
            [lv.contiguous() for lv in levels], cfg.ini_th_fast, cfg.min_th_fast,
            border=EDGE_THRESHOLD, out=self._corner_maps,
        )
        for lvl, (img_l, score, quota, scale) in enumerate(zip(levels, scores, quotas, scales)):
            ys, xs, resp, ok = _select_spatial_topk(score, quota)
            blurred = image_ops.separable_gaussian(img_l, 7, 2.0)
            praws.append(_extract_patches(img_l, ys, xs).reshape(quota, -1))
            pblurs.append(_extract_patches(blurred, ys, xs).reshape(quota, -1))
            uv = torch.stack([xs.to(torch.float32), ys.to(torch.float32)], dim=-1) * scale
            uts.append(uv)
            ress.append(resp)
            octs.append(torch.full((quota,), lvl, dtype=torch.int32, device=image.device))
            vals.append(ok)

        angle = _ic_angle_from_patches(torch.cat(praws, 0), self.w10, self.w01)
        desc = _rbrief_binned(torch.cat(pblurs, 0), angle, self.rot_index, cfg.rotation_bins)
        return Features(
            uv=torch.cat(uts, 0),
            response=torch.cat(ress, 0),
            octave=torch.cat(octs, 0),
            angle=angle,
            desc=desc,
            valid=torch.cat(vals, 0),
        )
