"""Sim(3) estimation: Horn's closed form and a batched RANSAC (torch port
of orb_slam_cuda_tpu/solvers/sim3_solver.py).

All hypotheses are one batch: a (NH,3) index tensor of minimal sets, one
batched 4x4 `eigh` for Horn's quaternions and one batched bidirectional
reprojection count. The sets come in as `sample_sets` or are drawn from
`generator`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..geometry.camera import Camera
from .initializer import draw_sets


class Sim3Result(NamedTuple):
    R: torch.Tensor  # (3,3) maps frame-2 coords to frame-1 coords
    t: torch.Tensor  # (3,)
    s: torch.Tensor  # ()
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor  # ()
    ok: torch.Tensor  # () bool


def _horn_centered(y1, y2, c1, c2, fix_scale: bool):
    """Horn's quaternion solution from centred (...,K,3) sets and their
    centroids (...,3): x1 ~ s R x2 + t."""
    M = y2.transpose(-1, -2) @ y1
    S = lambda i, j: M[..., i, j]  # noqa: E731
    N = torch.stack([
        torch.stack([S(0, 0) + S(1, 1) + S(2, 2), S(1, 2) - S(2, 1), S(2, 0) - S(0, 2), S(0, 1) - S(1, 0)], -1),
        torch.stack([S(1, 2) - S(2, 1), S(0, 0) - S(1, 1) - S(2, 2), S(0, 1) + S(1, 0), S(2, 0) + S(0, 2)], -1),
        torch.stack([S(2, 0) - S(0, 2), S(0, 1) + S(1, 0), -S(0, 0) + S(1, 1) - S(2, 2), S(1, 2) + S(2, 1)], -1),
        torch.stack([S(0, 1) - S(1, 0), S(2, 0) + S(0, 2), S(1, 2) + S(2, 1), -S(0, 0) - S(1, 1) + S(2, 2)], -1),
    ], -2)
    _, V = torch.linalg.eigh(N)
    R = se3.quat_to_rot(V[..., :, -1])  # max-eigenvalue quaternion (w,x,y,z)
    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    else:
        # Symmetric scale (Horn eq. 39), as the reference.
        num = torch.sum(y1 * y1, dim=(-1, -2))
        den = torch.sum(torch.square(y2 @ R.transpose(-1, -2)), dim=(-1, -2))
        s = torch.sqrt(num / torch.clamp(den, min=1e-12))
    t = c1 - s[..., None] * (R @ c2[..., None])[..., 0]
    return R, t, s


def horn_sim3(x1, x2, fix_scale: bool = False):
    """Closed-form Sim3 from (...,K,3) correspondences, batched over any
    leading dims: x1 ~ s R x2 + t."""
    c1 = x1.mean(dim=-2)
    c2 = x2.mean(dim=-2)
    return _horn_centered(x1 - c1[..., None, :], x2 - c2[..., None, :], c1, c2, fix_scale)


def solve_sim3_ransac(x1, x2, uv1, uv2, valid, cam: Camera, err_th1, err_th2,
                      n_hypotheses: int = 128, fix_scale: bool = False,
                      min_inliers: int = 20, sample_sets=None, generator=None) -> Sim3Result:
    """RANSAC Sim3 between matched camera-frame point sets (M,3), with
    bidirectional reprojection inliers under per-match squared-pixel
    thresholds err_th1/err_th2 (M,), then one weighted Horn refit."""
    if sample_sets is None:
        sample_sets = draw_sets(valid, n_hypotheses, generator, set_size=3)
    sets = torch.as_tensor(sample_sets, device=x1.device).long()

    def count_inliers(R, t, s):
        # x2 -> frame 1, projected into image 1; x1 -> frame 2, into image 2.
        x2_in_1 = s[..., None, None] * (x2 @ R.transpose(-1, -2)) + t[..., None, :]
        si = 1.0 / torch.clamp(s, min=1e-12)
        x1_in_2 = si[..., None, None] * ((x1 - t[..., None, :]) @ R)
        e1 = torch.sum((cam_mod.project(cam, x2_in_1) - uv1) ** 2, dim=-1)
        e2 = torch.sum((cam_mod.project(cam, x1_in_2) - uv2) ** 2, dim=-1)
        inl = valid & (e1 < err_th1) & (e2 < err_th2)
        return inl & (x2_in_1[..., 2] > 0) & (x1_in_2[..., 2] > 0)

    Rs, ts, ss = horn_sim3(x1[sets], x2[sets], fix_scale)
    best = torch.argmax(torch.sum(count_inliers(Rs, ts, ss), dim=-1))  # first maximum
    R, t, s = Rs[best], ts[best], ss[best]

    # Refit on the inliers (weighted Horn), kept if it explains as many.
    inl = count_inliers(R, t, s)
    w = inl.to(torch.float32)[:, None]
    n = torch.clamp(torch.sum(w), min=3.0)
    c1 = torch.sum(x1 * w, dim=0) / n
    c2 = torch.sum(x2 * w, dim=0) / n
    Rr, tr, sr = _horn_centered((x1 - c1) * w, (x2 - c2) * w, c1, c2, fix_scale)
    inl_r = count_inliers(Rr, tr, sr)
    better = torch.sum(inl_r) >= torch.sum(inl)
    R = torch.where(better, Rr, R)
    t = torch.where(better, tr, t)
    s = torch.where(better, sr, s)
    inl = torch.where(better, inl_r, inl)
    n_in = torch.sum(inl)
    return Sim3Result(R=R, t=t, s=s, inliers=inl, n_inliers=n_in, ok=n_in >= min_inliers)
