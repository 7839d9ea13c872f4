"""Bundle adjustment: Levenberg-Marquardt with preconditioned conjugate
gradients over batched residual/Jacobian blocks (torch port of
orb_slam_cuda_tpu/solvers/bundle_adjust.py).

Segment sums go through `ops/segsum.py`: the observation index is sorted
once per call, the invalid (padded) slots left out, and every sum adds
each segment's valid observations in observation order, so a solve gives
the same bits from run to run on CUDA and the bits of `index_add_` on the
CPU. A left-out slot's addends are exactly ±0 (its weight and masked
residual are 0, its Jacobians finite), so leaving them out keeps the
bits of an index that holds them. Accept/reject steps are tensor `where`s (no
sync).

With `group` (a `torch.distributed` process group) the function is one
rank's part of a distributed solve, the counterpart of the reference's
`axis_name`: the rank holds a block of the points and every observation
of those points (parallel/dist_ba.py lays the problem out so), the camera
state is the same on every rank, and the camera-sized sums (`nobs_cam`,
`bc`, `Hcc`, the matvec's `yc`), the point terms of the CG dot products
and the error are summed over the group by `all_reduce`."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..geometry import se3
from ..geometry.camera import Camera
from ..ops.segsum import segment_index, segsum
from .pose_opt import _projection_jacobian

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class BAProblem(NamedTuple):
    """C cameras, P points, E observations (-1-padded rows invalid)."""

    cam_pose: torch.Tensor  # (C,4,4)
    cam_fixed: torch.Tensor  # (C,) bool
    xyz: torch.Tensor  # (P,3)
    pt_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor  # (E,)
    obs_pt: torch.Tensor  # (E,)
    obs_uv: torch.Tensor  # (E,2)
    obs_ur: torch.Tensor  # (E,) right-u (<0 mono)
    obs_inv_sigma2: torch.Tensor  # (E,)
    obs_valid: torch.Tensor  # (E,) bool


class BAResult(NamedTuple):
    cam_pose: torch.Tensor
    xyz: torch.Tensor
    obs_inlier: torch.Tensor  # (E,) bool post-optimization chi2 gate
    final_error: torch.Tensor


def _residuals_jacobians(problem: BAProblem, cam_pose, xyz, cam: Camera, ci, pi):
    """Residual (E,3), Jacobians wrt camera tangent (E,3,6) and point
    (E,3,3), depth_ok, is_stereo."""
    T = cam_pose[ci]
    X = xyz[pi]
    Xc = torch.einsum("eij,ej->ei", T[:, :3, :3], X) + T[:, :3, 3]
    dpi, iz = _projection_jacobian(Xc, cam)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    u_r = u - cam.bf * iz
    is_stereo = problem.obs_ur >= 0
    ur_obs = torch.where(is_stereo, problem.obs_ur, torch.zeros_like(problem.obs_ur))
    r = torch.stack([u - problem.obs_uv[:, 0], v - problem.obs_uv[:, 1], u_r - ur_obs], dim=-1)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(Xc.shape[:-1] + (3, 3))
    Jc = dpi @ torch.cat([eye, -se3.hat(Xc)], dim=-1)
    Jp = dpi @ T[:, :3, :3]
    return r, Jc, Jp, Xc[:, 2] > 1e-6, is_stereo


def _chi2(r, inv_sigma2, is_stereo):
    sq = r[:, 0] ** 2 + r[:, 1] ** 2 + torch.where(is_stereo, r[:, 2] ** 2, torch.zeros_like(r[:, 2]))
    return sq * inv_sigma2


def _robust_weight(chi2, is_stereo, robust: bool):
    d = torch.where(is_stereo, torch.full_like(chi2, math.sqrt(CHI2_STEREO)),
                    torch.full_like(chi2, math.sqrt(CHI2_MONO)))
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    if not robust:
        return torch.ones_like(e)
    return torch.where(e > d, d / e, torch.ones_like(e))


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over the ranks of `group`, as a new tensor. Every rank
    gets the same bits: gloo and NCCL reduce in a fixed order and hand all
    ranks the one result."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def bundle_adjust(problem: BAProblem, cam: Camera, lm_iters: int = 10,
                  cg_iters: int = 20, robust: bool = True,
                  chi2_outlier_mono: float = CHI2_MONO,
                  chi2_outlier_stereo: float = CHI2_STEREO, group=None) -> BAResult:
    """LM with a PCG inner solve of (H + lam D) dx = -b, block-Jacobi
    preconditioned; under-constrained cameras and points are frozen.
    `group`: see the module's docstring."""
    psum = (lambda x: x) if group is None else (lambda x: group_sum(x, group))  # noqa: E731
    C = problem.cam_pose.shape[0]
    P = problem.xyz.shape[0]
    dev = problem.xyz.device
    ci = torch.clamp(problem.obs_cam, min=0).long()
    pi = torch.clamp(problem.obs_pt, min=0).long()
    ov = problem.obs_valid.to(torch.int32)
    nres = ov * torch.where(problem.obs_ur >= 0, 3, 2).to(torch.int32)
    seg_c = segment_index(C, ci, valid=problem.obs_valid)
    seg_p = segment_index(P, pi, valid=problem.obs_valid)
    nobs_cam = psum(segsum(seg_c, ov))
    nres_pt = segsum(seg_p, nres)
    cam_free = ~problem.cam_fixed & (nobs_cam > 0)
    pt_free = problem.pt_valid & (nres_pt >= 3)
    ABS_DAMP = 1e-3
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)

    def build_system(cam_pose, xyz):
        r, Jc, Jp, depth_ok, is_stereo = _residuals_jacobians(problem, cam_pose, xyz, cam, ci, pi)
        use = problem.obs_valid & depth_ok
        comp = torch.stack([use, use, use & is_stereo], dim=-1).to(r.dtype)
        chi2 = _chi2(r, problem.obs_inv_sigma2, is_stereo)
        w_rob = _robust_weight(chi2, is_stereo, robust)
        w = problem.obs_inv_sigma2 * w_rob * use
        err = psum(torch.sum(torch.where(use, chi2 * w_rob, torch.zeros_like(chi2))))
        return r * comp, Jc * comp[..., None], Jp * comp[..., None], w, err

    cam_pose, xyz = problem.cam_pose, problem.xyz
    lam = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    for _ in range(lm_iters):
        rw, Jcw, Jpw, w, err = build_system(cam_pose, xyz)
        bc = psum(segsum(seg_c, torch.einsum("eki,ek,e->ei", Jcw, rw, w)))
        bp = segsum(seg_p, torch.einsum("eki,ek,e->ei", Jpw, rw, w))
        Hcc = psum(segsum(seg_c, torch.einsum("eki,ekj,e->eij", Jcw, Jcw, w)))
        Hpp = segsum(seg_p, torch.einsum("eki,ekj,e->eij", Jpw, Jpw, w))
        lam_dc = lam * torch.clamp(torch.diagonal(Hcc, dim1=-2, dim2=-1), min=1e-6) + ABS_DAMP
        lam_dp = lam * torch.clamp(torch.diagonal(Hpp, dim1=-2, dim2=-1), min=1e-6) + ABS_DAMP
        # `inv_ex` without its error check (which reads a status back on
        # the card): the same bits.
        Minv_c = torch.linalg.inv_ex(Hcc + lam_dc[:, :, None] * eye6 + 1e-8 * eye6, check_errors=False).inverse
        Minv_p = torch.linalg.inv_ex(Hpp + lam_dp[:, :, None] * eye3 + 1e-8 * eye3, check_errors=False).inverse
        Minv_c = torch.where(cam_free[:, None, None], Minv_c, torch.zeros_like(Minv_c))
        Minv_p = torch.where(pt_free[:, None, None], Minv_p, torch.zeros_like(Minv_p))
        cf = cam_free[:, None]
        pf = pt_free[:, None]

        def matvec(xc, xp):
            xc = torch.where(cf, xc, torch.zeros_like(xc))
            xp = torch.where(pf, xp, torch.zeros_like(xp))
            ye = torch.einsum("eki,ei->ek", Jcw, xc[ci]) + torch.einsum("eki,ei->ek", Jpw, xp[pi])
            yc = psum(segsum(seg_c, torch.einsum("eki,ek,e->ei", Jcw, ye, w))) + lam_dc * xc
            yp = segsum(seg_p, torch.einsum("eki,ek,e->ei", Jpw, ye, w)) + lam_dp * xp
            return (torch.where(cf, yc, torch.zeros_like(yc)),
                    torch.where(pf, yp, torch.zeros_like(yp)))

        def precond(rc, rp):
            return (torch.einsum("cij,cj->ci", Minv_c, rc),
                    torch.einsum("pij,pj->pi", Minv_p, rp))

        def safe(x):
            return torch.where(torch.abs(x) < 1e-12, torch.full_like(x, 1e-12), x)

        rc = torch.where(cf, -bc, torch.zeros_like(bc))
        rp = torch.where(pf, -bp, torch.zeros_like(bp))
        xc = torch.zeros_like(rc)
        xp = torch.zeros_like(rp)
        zc, zp = precond(rc, rp)
        pc, pp = zc, zp
        # Camera vectors are the same on every rank; only the point terms
        # of the dot products are summed over the group.
        rz = torch.sum(rc * zc) + psum(torch.sum(rp * zp))
        for _ in range(cg_iters):
            Apc, App = matvec(pc, pp)
            alpha = rz / safe(torch.sum(pc * Apc) + psum(torch.sum(pp * App)))
            xc = xc + alpha * pc
            xp = xp + alpha * pp
            rc = rc - alpha * Apc
            rp = rp - alpha * App
            zc, zp = precond(rc, rp)
            rz_new = torch.sum(rc * zc) + psum(torch.sum(rp * zp))
            beta = rz_new / safe(rz)
            pc = zc + beta * pc
            pp = zp + beta * pp
            rz = rz_new

        xc = torch.where(cf, xc, torch.zeros_like(xc))
        xp = torch.where(pf, xp, torch.zeros_like(xp))
        new_pose = se3.retract(cam_pose, xc)
        new_xyz = xyz + xp
        err_new = build_system(new_pose, new_xyz)[4]
        improved = (err_new < err) & torch.isfinite(err_new)
        cam_pose = torch.where(improved, new_pose, cam_pose)
        xyz = torch.where(improved, new_xyz, xyz)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-9, 1e6)

    r, _, _, depth_ok, is_stereo = _residuals_jacobians(problem, cam_pose, xyz, cam, ci, pi)
    chi2 = _chi2(r, problem.obs_inv_sigma2, is_stereo)
    th = torch.where(is_stereo, torch.full_like(chi2, chi2_outlier_stereo),
                     torch.full_like(chi2, chi2_outlier_mono))
    inlier = problem.obs_valid & depth_ok & (chi2 <= th)
    # A point explaining none of its observations reverts to its input.
    pt_has_inl = torch.zeros((P + 1,), dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(inlier, pi, torch.full_like(pi, P)), True)
    keep = (pt_has_inl[:P] | ~pt_free)[:, None]
    xyz = torch.where(keep, xyz, problem.xyz)
    xyz = torch.where(torch.all(torch.isfinite(xyz), -1, keepdim=True), xyz, problem.xyz)
    pose_ok = torch.all(torch.isfinite(cam_pose).reshape(C, 16), dim=-1)[:, None, None]
    cam_pose = torch.where(pose_ok, cam_pose, problem.cam_pose)
    err = build_system(cam_pose, xyz)[4]
    return BAResult(cam_pose=cam_pose, xyz=xyz, obs_inlier=inlier, final_error=err)
