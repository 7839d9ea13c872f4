"""Distributed bundle adjustment over a process group (torch port of
orb_slam_cuda_tpu/parallel/dist_ba.py).

The global-BA problem is split so that each rank OWNS a contiguous block
of the point axis and holds ALL observations of its points, while the
small camera state is the same on every rank. `solvers.bundle_adjust`
with `group` set then does every point-sized and observation-sized
computation on its own rank; per LM/CG iteration the only traffic is the
camera blocks `b_c (C,6)`, `H_cc (C,6,6)`, the matvec's `y_c (C,6)` and a
few scalars, each an `all_reduce(SUM)`: O(C) bytes, independent of the
points and observations.

The layout is the reference's, rank r taking device r's rows: points in
equal blocks by index, each observation routed to its point's block,
invalid observations dealt round-robin, every rank's rows padded to the
largest block load rounded up to 8. Results come back in input order on
every rank through `all_reduce` alone: each rank writes its block into a
zero-filled full-size tensor (the inlier mask as int32 0/1) and the sum
over the group, whose terms are disjoint, is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import Camera
from ..solvers import bundle_adjust as ba
from .mesh import Mesh


class PartitionedBA(NamedTuple):
    """This rank's part of a BAProblem laid out for the group.

    `local` holds the whole camera state, the rank's `pblk` points and its
    `emax` observation rows, whose `obs_pt` are BLOCK-LOCAL indices;
    `obs_src` maps each row to its original observation index (-1 for
    padding); `n_obs`/`n_pts` are the original sizes."""

    local: ba.BAProblem
    obs_src: torch.Tensor  # (emax,) int64
    n_obs: int
    n_pts: int
    pblk: int


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def partition_problem(problem: ba.BAProblem, mesh: Mesh) -> PartitionedBA:
    """Route observations to their point's block, pad, and keep this
    rank's rows on the rank's device (host-side numpy, once per problem)."""
    n, r = mesh.size, mesh.rank
    obs_pt = _np(problem.obs_pt)
    obs_valid = _np(problem.obs_valid)
    E = obs_pt.shape[0]
    Pn = int(problem.xyz.shape[0])
    pblk = -(-Pn // n)
    Pp = pblk * n

    live = obs_valid & (obs_pt >= 0)
    owner = np.where(live, np.clip(obs_pt, 0, Pn - 1) // pblk, 0).astype(np.int64)
    owner[~live] = np.arange(np.count_nonzero(~live)) % n
    counts = np.bincount(owner, minlength=n)
    emax = int(counts.max()) if E else 1
    emax = max(8, -(-emax // 8) * 8)

    # obs_src[d*emax + k] = original index of rank d's k-th row.
    obs_src = np.full((n * emax,), -1, np.int64)
    order = np.argsort(owner, kind="stable")
    slot = np.concatenate([np.arange(c) for c in counts]) if E else np.zeros(0, np.int64)
    obs_src[owner[order] * emax + slot] = order
    obs_src = obs_src[r * emax:(r + 1) * emax]
    pad_row = obs_src < 0
    src = np.maximum(obs_src, 0)
    dev = mesh.device

    def take(x, fill):
        x = _np(x)
        if x.shape[0] == 0:
            out = np.full((len(src),) + x.shape[1:], fill, x.dtype)
        else:
            out = x[src].copy()
            out[pad_row] = fill
        return torch.as_tensor(out, device=dev)

    if E:
        p = obs_pt[src]
        pt_local = p - (np.clip(p, 0, Pn - 1) // pblk) * pblk
        pt_local = np.where(pad_row | (p < 0), -1, pt_local).astype(np.int64)
    else:
        pt_local = np.full(len(src), -1, np.int64)

    xyz = np.zeros((Pp, 3), np.float32)
    xyz[:Pn] = _np(problem.xyz)
    pt_valid = np.zeros((Pp,), bool)
    pt_valid[:Pn] = _np(problem.pt_valid)
    block = slice(r * pblk, (r + 1) * pblk)
    local = ba.BAProblem(
        cam_pose=problem.cam_pose.to(dev),
        cam_fixed=problem.cam_fixed.to(dev),
        xyz=torch.as_tensor(xyz[block], device=dev),
        pt_valid=torch.as_tensor(pt_valid[block], device=dev),
        obs_cam=take(problem.obs_cam, -1).long(),
        obs_pt=torch.as_tensor(pt_local, device=dev),
        obs_uv=take(problem.obs_uv, 0.0),
        obs_ur=take(problem.obs_ur, -1.0),
        obs_inv_sigma2=take(problem.obs_inv_sigma2, 1.0),
        obs_valid=take(problem.obs_valid, False),
    )
    return PartitionedBA(local=local, obs_src=torch.as_tensor(obs_src, device=dev),
                         n_obs=E, n_pts=Pn, pblk=pblk)


def solve_partitioned(part: PartitionedBA, cam: Camera, mesh: Mesh, lm_iters: int = 10,
                      cg_iters: int = 20, robust: bool = True) -> ba.BAResult:
    """Solve an already partitioned problem (call this in loops). Every
    rank returns the whole result, in input order, with the same bits."""
    res = ba.bundle_adjust(part.local, cam, lm_iters=lm_iters, cg_iters=cg_iters,
                           robust=robust, group=mesh.group)
    dev = res.xyz.device
    xyz = torch.zeros((mesh.size * part.pblk, 3), dtype=res.xyz.dtype, device=dev)
    xyz[mesh.rank * part.pblk:(mesh.rank + 1) * part.pblk] = res.xyz
    xyz = ba.group_sum(xyz, mesh.group)[: part.n_pts]
    rows = part.obs_src >= 0
    inl = torch.zeros((part.n_obs,), dtype=torch.int32, device=dev)
    inl[part.obs_src[rows]] = res.obs_inlier[rows].to(torch.int32)
    inl = ba.group_sum(inl, mesh.group) > 0
    return ba.BAResult(cam_pose=res.cam_pose, xyz=xyz, obs_inlier=inl, final_error=res.final_error)


def distributed_bundle_adjust(problem: ba.BAProblem, cam: Camera, mesh: Mesh, lm_iters: int = 10,
                              cg_iters: int = 20, robust: bool = True) -> ba.BAResult:
    """Partition, place, solve; results come back in input order."""
    return solve_partitioned(partition_problem(problem, mesh), cam, mesh, lm_iters=lm_iters,
                             cg_iters=cg_iters, robust=robust)
