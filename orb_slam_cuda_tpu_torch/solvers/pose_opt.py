"""Pose-only bundle adjustment: batched Levenberg-Marquardt on SE(3)
(torch port of orb_slam_cuda_tpu/solvers/pose_opt.py): 4 rounds x 10
LM iterations, Huber in all but the last round, chi2 reclassification
between rounds. Accept/reject is a tensor `where`, and the 6x6 solve
skips its error check (which reads the solver's status back on CUDA), so
the 40 iterations run without a host sync."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import Camera

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    pose: torch.Tensor  # (4,4) optimized Tcw
    inliers: torch.Tensor  # (M,) bool
    n_inliers: torch.Tensor  # () int64


def _projection_jacobian(Xc, cam: Camera):
    """d(u, v, u_right)/dXc rows (M,3,3) for the pinhole + stereo model."""
    x, y, z = Xc[:, 0], Xc[:, 1], Xc[:, 2]
    iz = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    iz2 = iz * iz
    zero = torch.zeros_like(iz)
    du = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    dv = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    dur = du + torch.stack([zero, zero, cam.bf * iz2], dim=-1)
    return torch.stack([du, dv, dur], dim=-2), iz


def _residual_jacobian(T, Xw, uv, ur, cam: Camera):
    """Residuals (M,3), Jacobians (M,3,6) wrt the left update, depth_ok."""
    Xc = se3.transform(T, Xw)
    dpi, iz = _projection_jacobian(Xc, cam)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    u_r = u - cam.bf * iz
    r = torch.stack([u - uv[:, 0], v - uv[:, 1], u_r - ur], dim=-1)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    dX = torch.cat([eye, -se3.hat(Xc)], dim=-1)
    J = dpi @ dX
    return r, J, Xc[:, 2] > 1e-6


def _edge_chi2(r, inv_sigma2, is_stereo):
    sq = r[:, 0] ** 2 + r[:, 1] ** 2 + torch.where(is_stereo, r[:, 2] ** 2, torch.zeros_like(r[:, 2]))
    return sq * inv_sigma2


def optimize_pose(Tcw0, Xw, uv, ur, inv_sigma2, valid, cam: Camera,
                  rounds: int = 4, iters_per_round: int = 10) -> PoseOptResult:
    """Xw (M,3) world points, uv (M,2) observations, ur (M,) right-u (<0
    mono), inv_sigma2 (M,) information, valid (M,) bool."""
    is_stereo = ur >= 0
    ur_eff = torch.where(is_stereo, ur, torch.zeros_like(ur))
    delta = torch.where(is_stereo, torch.full_like(ur, math.sqrt(CHI2_STEREO)),
                        torch.full_like(ur, math.sqrt(CHI2_MONO)))
    chi2_th = torch.where(is_stereo, torch.full_like(ur, CHI2_STEREO),
                          torch.full_like(ur, CHI2_MONO))

    def normal_eqs(T_eval, active, robust):
        r, J, depth_ok = _residual_jacobian(T_eval, Xw, uv, ur_eff, cam)
        use = active & depth_ok
        comp_mask = torch.stack([use, use, use & is_stereo], dim=-1).to(r.dtype)
        chi2 = _edge_chi2(r, inv_sigma2, is_stereo)
        e = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w_rob = torch.where((e > delta) & robust, delta / e, torch.ones_like(e))
        w = inv_sigma2 * w_rob
        rw = r * comp_mask
        Jw = J * comp_mask[..., None]
        H = torch.einsum("mki,mkj,m->ij", Jw, Jw, w)
        g = torch.einsum("mki,mk,m->i", Jw, rw, w)
        err = torch.sum(chi2 * torch.where(use, w_rob, torch.zeros_like(w_rob)))
        return H, g, err

    T = Tcw0
    active = valid
    for rnd in range(rounds):
        robust = rnd < rounds - 1
        H, g, err = normal_eqs(T, active, robust)
        lam = torch.full((), 1e-3, dtype=torch.float32, device=T.device)
        for _ in range(iters_per_round):
            D = torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
            step = -torch.linalg.solve_ex(H + lam * D, g, check_errors=False)[0]
            T_new = se3.retract(T, step)
            H_new, g_new, err_new = normal_eqs(T_new, active, robust)
            improved = err_new < err
            T = torch.where(improved, T_new, T)
            H = torch.where(improved, H_new, H)
            g = torch.where(improved, g_new, g)
            err = torch.where(improved, err_new, err)
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        r, _, depth_ok = _residual_jacobian(T, Xw, uv, ur_eff, cam)
        chi2 = _edge_chi2(r, inv_sigma2, is_stereo)
        active = valid & depth_ok & (chi2 <= chi2_th)

    return PoseOptResult(pose=T, inliers=active, n_inliers=torch.sum(active))
