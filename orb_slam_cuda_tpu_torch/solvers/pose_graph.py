"""Sim(3) pose-graph (essential graph) optimization (torch port of
orb_slam_cuda_tpu/solvers/pose_graph.py).

Per-edge residual r = log(S_ji o S_i o S_j^-1) with Jacobians from
forward-mode derivatives over the two 7-dim tangents, all edges at once
(`ops/pose_graph_kernel.py::linearize`: one launch of the hand-written
kernel on the card, the float64 chain through `torch.func.jvp` on the CPU,
each rounded once to float32), then Gauss-Newton steps solved by
block-Jacobi preconditioned CG over segment sums of the edge list. The sums
go through `ops/segsum.py` (each edge end sorted once per solve, padded
edges left out, each segment added in edge order), so a solve gives the
same bits from run to run on CUDA. Nothing depends on the edge count but
the edges' own rows: padded edges (`edge_valid` False) leave a solve's
bits as they are.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import sim3
from ..ops import pose_graph_kernel
from ..ops.segsum import segment_index, segsum


class PoseGraphProblem(NamedTuple):
    """K vertices (Sim3 world->kf), E edges; meas_* is the measured S_ji
    (maps i -> j); vert_fixed (K,) pins vertices."""

    vert_R: torch.Tensor
    vert_t: torch.Tensor
    vert_s: torch.Tensor
    vert_fixed: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    meas_R: torch.Tensor
    meas_t: torch.Tensor
    meas_s: torch.Tensor
    edge_valid: torch.Tensor


def relative_sim3(Si, Sj):
    """S_ji = S_j o S_i^-1."""
    return sim3.compose(Sj, sim3.inverse(Si))


def optimize_pose_graph(problem: PoseGraphProblem, gn_iters: int = 20, cg_iters: int = 30):
    """Returns the optimized (R (K,3,3), t (K,3), s (K,))."""
    K = problem.vert_R.shape[0]
    dev = problem.vert_R.device
    ei = torch.clamp(problem.edge_i, min=0).long()
    ej = torch.clamp(problem.edge_j, min=0).long()
    seg_i = segment_index(K, ei, valid=problem.edge_valid)
    seg_j = segment_index(K, ej, valid=problem.edge_valid)
    free = ~problem.vert_fixed
    w_e = problem.edge_valid.to(torch.float32)
    meas = tuple(m.contiguous() for m in (problem.meas_R, problem.meas_t, problem.meas_s))
    valid = problem.edge_valid.bool().contiguous()
    eye7 = torch.eye(7, dtype=torch.float32, device=dev)

    def safe(x):
        return torch.where(torch.abs(x) < 1e-12, torch.full_like(x, 1e-12), x)

    R, t, s = (v.contiguous() for v in (problem.vert_R, problem.vert_t, problem.vert_s))
    for _ in range(gn_iters):
        r, Ji, Jj = pose_graph_kernel.linearize(R, t, s, ei, ej, *meas, valid)
        b = (segsum(seg_i, torch.einsum("eki,ek,e->ei", Ji, r, w_e))
             + segsum(seg_j, torch.einsum("eki,ek,e->ei", Jj, r, w_e)))
        Hd = (segsum(seg_i, torch.einsum("eki,ekj,e->eij", Ji, Ji, w_e))
              + segsum(seg_j, torch.einsum("eki,ekj,e->eij", Jj, Jj, w_e)))
        Minv = torch.linalg.inv_ex(Hd + 1e-6 * eye7, check_errors=False).inverse  # no status read-back
        Minv = torch.where(free[:, None, None], Minv, torch.zeros_like(Minv))
        fr = free[:, None]

        def matvec(x):
            x = torch.where(fr, x, torch.zeros_like(x))
            ye = torch.einsum("eki,ei->ek", Ji, x[ei]) + torch.einsum("eki,ei->ek", Jj, x[ej])
            y = (segsum(seg_i, torch.einsum("eki,ek,e->ei", Ji, ye, w_e))
                 + segsum(seg_j, torch.einsum("eki,ek,e->ei", Jj, ye, w_e)))
            y = y + 1e-8 * x
            return torch.where(fr, y, torch.zeros_like(y))

        rc = torch.where(fr, -b, torch.zeros_like(b))
        x = torch.zeros_like(rc)
        zc = torch.einsum("kij,kj->ki", Minv, rc)
        pc = zc
        rz = torch.sum(rc * zc)
        for _ in range(cg_iters):
            Ap = matvec(pc)
            alpha = rz / safe(torch.sum(pc * Ap))
            x = x + alpha * pc
            rc = rc - alpha * Ap
            zc = torch.einsum("kij,kj->ki", Minv, rc)
            rz_new = torch.sum(rc * zc)
            pc = zc + (rz_new / safe(rz)) * pc
            rz = rz_new
        x = torch.where(fr, x, torch.zeros_like(x))
        R, t, s = sim3.compose(sim3.exp(x), (R, t, s))
    return R, t, s
