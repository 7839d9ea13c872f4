"""Sim(3) estimation: Horn's closed form and a batched RANSAC (torch port
of orb_slam_cuda_tpu/solvers/sim3_solver.py).

`solve_sim3_ransac` draws or takes the (NH,3) minimal sets and dispatches
by device through ops/sim3_kernel.py: on the card the hand-written kernel
(csrc/sim3_ransac.cu), on the CPU `solve_sim3_ransac_plain`, the plain
version: all hypotheses one batch, one batched 4x4 `eigh` for Horn's
quaternions (which on the card reads back) and one batched bidirectional
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


def n_matrix(M):
    """Horn's symmetric 4x4 N-matrix (...,4,4) of the cross-covariance
    M = y2^T y1 (...,3,3): its largest eigenvalue's eigenvector is the
    rotation's quaternion (w,x,y,z)."""
    S = lambda i, j: M[..., i, j]  # noqa: E731
    return torch.stack([
        torch.stack([S(0, 0) + S(1, 1) + S(2, 2), S(1, 2) - S(2, 1), S(2, 0) - S(0, 2), S(0, 1) - S(1, 0)], -1),
        torch.stack([S(1, 2) - S(2, 1), S(0, 0) - S(1, 1) - S(2, 2), S(0, 1) + S(1, 0), S(2, 0) + S(0, 2)], -1),
        torch.stack([S(2, 0) - S(0, 2), S(0, 1) + S(1, 0), -S(0, 0) + S(1, 1) - S(2, 2), S(1, 2) + S(2, 1)], -1),
        torch.stack([S(0, 1) - S(1, 0), S(2, 0) + S(0, 2), S(1, 2) + S(2, 1), -S(0, 0) - S(1, 1) + S(2, 2)], -1),
    ], -2)


def _horn_centered(y1, y2, c1, c2, fix_scale: bool):
    """Horn's quaternion solution from centred (...,K,3) sets and their
    centroids (...,3): x1 ~ s R x2 + t."""
    _, V = torch.linalg.eigh(n_matrix(y2.transpose(-1, -2) @ y1))
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


def count_inliers(R, t, s, x1, x2, uv1, uv2, valid, cam: Camera, err_th1, err_th2):
    """(...,M) bool: the matches that Sim3 (R, t, s) (batched over leading
    dims) explains both ways: x2 into frame 1 projected within err_th1 of
    uv1, x1 into frame 2 within err_th2 of uv2, in front of both cameras."""
    x2_in_1 = s[..., None, None] * (x2 @ R.transpose(-1, -2)) + t[..., None, :]
    si = 1.0 / torch.clamp(s, min=1e-12)
    x1_in_2 = si[..., None, None] * ((x1 - t[..., None, :]) @ R)
    e1 = torch.sum((cam_mod.project(cam, x2_in_1) - uv1) ** 2, dim=-1)
    e2 = torch.sum((cam_mod.project(cam, x1_in_2) - uv2) ** 2, dim=-1)
    inl = valid & (e1 < err_th1) & (e2 < err_th2)
    return inl & (x2_in_1[..., 2] > 0) & (x1_in_2[..., 2] > 0)


def solve_sim3_ransac(x1, x2, uv1, uv2, valid, cam: Camera, err_th1, err_th2,
                      n_hypotheses: int = 128, fix_scale: bool = False,
                      min_inliers: int = 20, sample_sets=None, generator=None) -> Sim3Result:
    """RANSAC Sim3 between matched camera-frame point sets (M,3), with
    bidirectional reprojection inliers under per-match squared-pixel
    thresholds err_th1/err_th2 (M,), then one weighted Horn refit: the
    kernel on the card, the plain version on the CPU."""
    from ..ops import sim3_kernel

    if sample_sets is None:
        sample_sets = draw_sets(valid, n_hypotheses, generator, set_size=3)
    sets = torch.as_tensor(sample_sets, device=x1.device).long()
    return sim3_kernel.solve(x1, x2, uv1, uv2, valid, sets, err_th1, err_th2, cam, fix_scale=fix_scale,
                             min_inliers=min_inliers)


def solve_sim3_ransac_plain(x1, x2, uv1, uv2, valid, cam: Camera, err_th1, err_th2,
                            n_hypotheses: int = 128, fix_scale: bool = False,
                            min_inliers: int = 20, sample_sets=None, generator=None) -> Sim3Result:
    """The plain version of `solve_sim3_ransac`, in torch ops (`eigh`)."""
    if sample_sets is None:
        sample_sets = draw_sets(valid, n_hypotheses, generator, set_size=3)
    sets = torch.as_tensor(sample_sets, device=x1.device).long()

    def count(R, t, s):
        return count_inliers(R, t, s, x1, x2, uv1, uv2, valid, cam, err_th1, err_th2)

    Rs, ts, ss = horn_sim3(x1[sets], x2[sets], fix_scale)
    best = torch.argmax(torch.sum(count(Rs, ts, ss), dim=-1))  # first maximum
    R, t, s = Rs[best], ts[best], ss[best]

    # Refit on the inliers (weighted Horn), kept if it explains as many.
    inl = count(R, t, s)
    w = inl.to(torch.float32)[:, None]
    n = torch.clamp(torch.sum(w), min=3.0)
    c1 = torch.sum(x1 * w, dim=0) / n
    c2 = torch.sum(x2 * w, dim=0) / n
    Rr, tr, sr = _horn_centered((x1 - c1) * w, (x2 - c2) * w, c1, c2, fix_scale)
    inl_r = count(Rr, tr, sr)
    better = torch.sum(inl_r) >= torch.sum(inl)
    R = torch.where(better, Rr, R)
    t = torch.where(better, tr, t)
    s = torch.where(better, sr, s)
    inl = torch.where(better, inl_r, inl)
    n_in = torch.sum(inl)
    return Sim3Result(R=R, t=t, s=s, inliers=inl, n_inliers=n_in, ok=n_in >= min_inliers)
