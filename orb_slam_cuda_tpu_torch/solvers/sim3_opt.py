"""Joint Sim3 refinement over bidirectional reprojection edges (torch port
of orb_slam_cuda_tpu/solvers/sim3_opt.py).

One Sim3 vertex S12, fixed camera-frame points of both keyframes, and a
pair of Huber-robust edges per correspondence (uv1 against S12 X2c, uv2
against S12^-1 X1c). Schedule: 5 LM iterations, chi2 > th2 pairs removed,
10 more; fewer than 10 survivors of the first cut fail. Jacobians are
forward-mode derivatives of the retraction at 0 in float64, rounded to
float32: one launch of a hand-written kernel an iteration on the card
(ops/sim3_opt_kernel.py::jacobian, csrc/sim3_opt_jacobian.cu), its plain
version on the CPU; accept/reject is a tensor `where` and the 6x6/7x7
solve checks no status, so the 15 iterations never sync and run inside a
captured CUDA graph (the loop closer's `sim3_refine` program).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import sim3
from ..geometry.camera import Camera
from ..ops import sim3_opt_kernel


class Sim3OptResult(NamedTuple):
    R: torch.Tensor  # (3,3)
    t: torch.Tensor  # (3,)
    s: torch.Tensor  # ()
    inliers: torch.Tensor  # (M,) bool, both edges of the pair under th2
    n_inliers: torch.Tensor  # () int32 (0 when the <10-survivors gate fails)


def optimize_sim3(S12, x1c, x2c, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                  cam: Camera, fix_scale: bool = False, th2: float = 10.0) -> Sim3OptResult:
    """S12 (R,t,s) initial estimate; x1c/x2c (M,3) correspondence points
    in the KF1/KF2 camera frames; uv1/uv2 (M,2) observations; inv_sigma2_*
    (M,) information by octave; valid (M,) bool."""
    dev = x1c.device
    delta = math.sqrt(float(np.float32(th2)))
    isig = torch.cat([inv_sigma2_1, inv_sigma2_2])

    def stacked(S):
        p1, p2, _, _ = sim3_opt_kernel.pair_residuals(S, x1c, x2c, cam)
        return torch.cat([p1 - uv1, p2 - uv2], dim=0)  # (2M,2)

    def robust_err(r, act2):
        chi2 = torch.sum(r * r, dim=-1) * isig
        e = torch.sqrt(torch.clamp(chi2, min=1e-12))
        w_rob = torch.where(e > delta, delta / e, torch.ones_like(e))
        return chi2, w_rob, torch.sum(torch.where(act2, chi2 * w_rob, torch.zeros_like(chi2)))

    def lm_iters(S, active, n_iters):
        act2 = torch.cat([active, active])
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        for _ in range(n_iters):
            r = stacked(S)
            J = sim3_opt_kernel.jacobian(S, x1c, x2c, cam)
            chi2, w_rob, err_old = robust_err(r, act2)
            w = torch.where(act2, isig * w_rob, torch.zeros_like(isig))
            H = torch.einsum("mki,mkj,m->ij", J, J, w)
            g = torch.einsum("mki,mk,m->i", J, r, w)
            if fix_scale:
                # Pin the scale coordinate (g2o VertexSim3Expmap._fix_scale).
                pin = torch.arange(7, device=dev) == 6
                H = torch.where(pin[:, None] | pin[None, :], (pin[:, None] & pin[None, :]).to(H.dtype), H)
                g = torch.cat([g[:6], g.new_zeros(1)])
            D = torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
            xi = -torch.linalg.solve_ex(H + lam * D, g, check_errors=False)[0]
            if fix_scale:
                xi = torch.cat([xi[:6], xi.new_zeros(1)])
            S_new = sim3.retract(S, xi)
            err_new = robust_err(stacked(S_new), act2)[2]
            improved = err_new < err_old
            S = tuple(torch.where(improved, n, o) for n, o in zip(S_new, S))
            lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        return S

    def classify(S, base):
        p1, p2, ok1, ok2 = sim3_opt_kernel.pair_residuals(S, x1c, x2c, cam)
        c1 = torch.sum((p1 - uv1) ** 2, dim=-1) * inv_sigma2_1
        c2 = torch.sum((p2 - uv2) ** 2, dim=-1) * inv_sigma2_2
        return base & ok1 & ok2 & (c1 <= th2) & (c2 <= th2)

    S = lm_iters(tuple(S12), valid, 5)
    inl = classify(S, valid)
    n_good = torch.sum(inl)
    S = lm_iters(S, inl, 10)
    inl2 = classify(S, inl)
    n_in = torch.where(n_good >= 10, torch.sum(inl2), torch.zeros_like(n_good)).to(torch.int32)
    R, t, s = S
    return Sim3OptResult(R=R, t=t, s=s, inliers=inl2, n_inliers=n_in)
