"""EPnP + RANSAC pose solver for relocalization (torch port of
orb_slam_cuda_tpu/solvers/pnp.py).

The 512 six-point hypotheses run as one batched EPnP (batched `eigh` for
the control points and the 12x12 kernel, batched `svd` for the rigid
alignment) on the sampled rows only; the consensus refit is one weighted
EPnP over all rows, then a 2-round robust pose-only LM. The sets come in
as `sample_sets` or are drawn from `generator`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..geometry.camera import Camera
from . import pose_opt
from .initializer import draw_sets


class PnPResult(NamedTuple):
    pose: torch.Tensor  # (4,4) Tcw
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _control_points(Xw, w):
    """Centroid + principal-axes control points (...,4,3) of (...,M,3)
    points under weights (...,M)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    c0 = torch.sum(Xw * w[..., None], dim=-2) / wsum[..., None]
    Y = (Xw - c0[..., None, :]) * torch.sqrt(w)[..., None]
    cov = Y.transpose(-1, -2) @ Y / wsum[..., None, None]
    eval_, evec = torch.linalg.eigh(cov)
    axes = evec * torch.sqrt(torch.clamp(eval_, min=1e-12))[..., None, :]
    return torch.stack([c0, c0 + axes[..., 2], c0 + axes[..., 1], c0 + axes[..., 0]], dim=-2)


def _barycentric(Xw, ctrl):
    """(...,M,4) barycentric coordinates with respect to the control points."""
    B = (ctrl[..., 1:, :] - ctrl[..., :1, :]).transpose(-1, -2)
    eye = torch.eye(3, dtype=Xw.dtype, device=Xw.device)
    Binv = torch.linalg.inv(B + 1e-12 * eye)
    a123 = (Xw - ctrl[..., :1, :]) @ Binv.transpose(-1, -2)
    a0 = 1.0 - torch.sum(a123, dim=-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)


def _build_MtM(alphas, uv, w, cam: Camera):
    """(...,12,12) normal matrix of the EPnP M system: per point and
    control j the rows [a_j fx, 0, a_j (cx - u)] and [0, a_j fy, a_j (cy - v)]."""
    zero = torch.zeros_like(alphas)
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    M1 = torch.stack([alphas * cam.fx, zero, alphas * (cam.cx - u)], dim=-1).flatten(-2)
    M2 = torch.stack([zero, alphas * cam.fy, alphas * (cam.cy - v)], dim=-1).flatten(-2)
    return ((M1 * w[..., None]).transpose(-1, -2) @ M1
            + (M2 * w[..., None]).transpose(-1, -2) @ M2)


def _rigid_align(A, B):
    """Least-squares rigid transform mapping A (...,K,3) onto B."""
    ca = A.mean(dim=-2)
    cb = B.mean(dim=-2)
    H = (A - ca[..., None, :]).transpose(-1, -2) @ (B - cb[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = V @ D @ U.transpose(-1, -2)
    t = cb - (R @ ca[..., None])[..., 0]
    return R, t


_IU = ([0, 0, 0, 1, 1, 2], [1, 2, 3, 2, 3, 3])  # triu_indices(4, 1)


def _epnp_from_weights(Xw, uv, w, cam: Camera):
    """One EPnP solve per batch entry (beta case N=1) -> (...,4,4) Tcw."""
    ctrl_w = _control_points(Xw, w)
    alphas = _barycentric(Xw, ctrl_w)
    _, V = torch.linalg.eigh(_build_MtM(alphas, uv, w, cam))
    v1 = V[..., :, 0].reshape(V.shape[:-2] + (4, 3))

    def pdists(C):
        diff = C[..., :, None, :] - C[..., None, :, :]
        return torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)[..., _IU[0], _IU[1]]

    dw = pdists(ctrl_w)
    dc = pdists(v1)
    beta = torch.sum(dc * dw, dim=-1) / torch.clamp(torch.sum(dc * dc, dim=-1), min=1e-12)
    ctrl_c = beta[..., None, None] * v1
    # Cheirality: the weighted points must lie in front of the camera.
    pc_z = (alphas @ ctrl_c)[..., 2]
    sign = torch.sign(torch.sum(torch.where(w > 0, pc_z, torch.zeros_like(pc_z)), dim=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    R, t = _rigid_align(ctrl_w, ctrl_c * sign[..., None, None])
    return se3.make_T(R, t)


def solve_pnp_ransac(Xw, uv, valid, err_th2, cam: Camera, n_hypotheses: int = 512,
                     min_inliers: int = 10, sample_sets=None, generator=None) -> PnPResult:
    """RANSAC EPnP on (M,3) world points and (M,2) observed pixels with
    per-match squared-pixel thresholds err_th2 (M,)."""
    if sample_sets is None:
        sample_sets = draw_sets(valid, n_hypotheses, generator, set_size=6)
    sets = torch.as_tensor(sample_sets, device=Xw.device).long()
    M = Xw.shape[0]

    def reproj_inliers(T):  # T (4,4) or (NH,4,4)
        Xc = Xw @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]
        e2 = torch.sum((cam_mod.project(cam, Xc) - uv) ** 2, dim=-1)
        return valid & (e2 < err_th2) & (Xc[..., 2] > 0)

    # 6-point minimal sets: the 12 equations make the EPnP kernel
    # one-dimensional, so the N=1 beta case is exact.
    Xs = Xw[sets]
    Ts = _epnp_from_weights(Xs, uv[sets], torch.ones(Xs.shape[:-1], dtype=Xw.dtype, device=Xw.device), cam)
    T0 = Ts[torch.argmax(torch.sum(reproj_inliers(Ts), dim=-1))]  # first maximum

    # Refit on the full consensus; keep whichever pose explains more.
    inl = reproj_inliers(T0)
    T1 = _epnp_from_weights(Xw, uv, inl.to(torch.float32), cam)
    better = torch.sum(reproj_inliers(T1)) >= torch.sum(inl)
    T_init = torch.where(better, T1, T0)
    res = pose_opt.optimize_pose(
        T_init, Xw, uv, torch.full((M,), -1.0, device=Xw.device),
        torch.ones((M,), dtype=torch.float32, device=Xw.device), reproj_inliers(T_init), cam,
        rounds=2, iters_per_round=10,
    )
    final_inl = reproj_inliers(res.pose) & res.inliers
    n = torch.sum(final_inl)
    return PnPResult(pose=res.pose, inliers=final_inl, n_inliers=n, ok=n >= min_inliers)
