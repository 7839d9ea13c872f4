"""Cluster-parallel map refinement: covisibility-block BA over a process
group (torch port of orb_slam_cuda_tpu/parallel/cluster_ba.py).

The keyframes are split into covisibility clusters
(multihost.covisibility_clusters); each cluster becomes a local-BA
problem whose frontier keyframes are held fixed, and one round solves
every cluster once: a block-coordinate descent step on the global
problem. The reference vmaps one `bundle_adjust` over the clusters; here
each cluster has its own `bundle_adjust` call, so LM's damping and its
accept test stay per cluster, as there. With a group, rank r solves the
clusters c with c % size == r, and an `all_reduce` over the disjoint
writes gives every rank the same map.

The write-back mirrors the reference's serial scatter of every
cluster's camera rows and point rows in cluster order, where a fixed row
writes the map's old value back and the last write to a slot wins
(`ops.segsum.last_writes` finds it): a free camera that a later cluster
holds as a fixed frontier camera keeps its old pose, in both packages
(ROADMAP queue 3 D). Padding rows clip onto slot 0 and write its old value,
as there, so keyframe 0, which fixes the map's frame, and point 0 keep
their values through every round (queue 3 G).
"""

from __future__ import annotations

import torch

from ..engine.local_mapping import nonzero_fixed
from ..geometry.camera import Camera
from ..ops.segsum import last_writes
from ..slam_map import MapState
from ..slam_map import ops as map_ops
from ..solvers import bundle_adjust as ba
from .mesh import Mesh
from .multihost import covisibility_clusters


def _gather_cluster_problem(state: MapState, assign, inv_sig, c: int, cams_per: int, pts_per: int):
    """Cluster `c`'s BA problem: its keyframes are free cameras (up to half
    the camera budget), keyframes of other clusters observing its points
    join as fixed frontier cameras (the rest), and its points are those
    whose reference keyframe lies in the cluster. Returns (problem,
    cam_slots, pt_slots), -1 padded."""
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    dev = state.device
    own_free = cams_per // 2
    n_fixed = cams_per - own_free

    mine = (assign == c) & state.kf_valid
    cam_own = nonzero_fixed(mine, own_free)
    ref = torch.clamp(state.mp_ref_kf, min=0).long()
    owned = state.mp_valid & (state.mp_ref_kf >= 0) & mine[ref]
    pt_slots = nonzero_fixed(owned, pts_per)
    trash = lambda idx: torch.where(idx >= 0, idx, torch.full_like(idx, P))  # noqa: E731
    pt_sel = torch.zeros((P + 1,), dtype=torch.bool, device=dev)
    pt_sel[trash(pt_slots)] = True
    pt_sel = pt_sel[:P]

    # Frontier: foreign keyframes observing owned points.
    sees = (state.kf_mp >= 0) & pt_sel[torch.clamp(state.kf_mp, min=0).long()]
    overlap = torch.sum(sees, dim=1).to(torch.int32)
    overlap = torch.where(mine | ~state.kf_valid, torch.zeros_like(overlap), overlap)
    fixed = map_ops.top_covisible(overlap, n_fixed).long()

    cam_slots = torch.cat([cam_own, fixed])
    cam_ok = cam_slots >= 0
    safe_cam = torch.clamp(cam_slots, min=0)
    cam_fixed = torch.cat([torch.zeros((own_free,), dtype=torch.bool, device=dev),
                           torch.ones((n_fixed,), dtype=torch.bool, device=dev)])
    # Gauge: no frontier -> pin the oldest own camera.
    any_fixed = torch.any(cam_fixed & cam_ok)
    oldest = torch.argmin(torch.where(cam_ok[:own_free], state.kf_frame_id[safe_cam[:own_free]],
                                      torch.full((own_free,), 2**30, dtype=torch.int32, device=dev)))
    cam_fixed[oldest] = cam_fixed[oldest] | ~any_fixed

    inv = torch.full((P + 1,), -1, dtype=torch.int64, device=dev)
    inv[trash(pt_slots)] = torch.arange(pts_per, device=dev)
    inv = inv[:P]
    rows_mp = state.kf_mp[safe_cam]
    rows_valid = (rows_mp >= 0) & cam_ok[:, None] & state.kf_feat_valid[safe_cam]
    obs_pt = torch.where(rows_valid, inv[torch.clamp(rows_mp, min=0).long()], torch.full_like(inv[:1], -1))
    rows_valid = rows_valid & (obs_pt >= 0)
    obs_isig = inv_sig[torch.clamp(state.kf_oct[safe_cam].long(), 0, inv_sig.shape[0] - 1)]
    problem = ba.BAProblem(
        cam_pose=state.kf_pose[safe_cam],
        cam_fixed=cam_fixed | ~cam_ok,
        xyz=state.mp_xyz[torch.clamp(pt_slots, min=0)],
        pt_valid=pt_slots >= 0,
        obs_cam=torch.arange(cams_per, device=dev)[:, None].expand(cams_per, N).reshape(-1),
        obs_pt=obs_pt.reshape(-1),
        obs_uv=state.kf_uv[safe_cam].reshape(-1, 2),
        obs_ur=torch.where(rows_valid, state.kf_right[safe_cam],
                           torch.full_like(state.kf_right[safe_cam], -1.0)).reshape(-1),
        obs_inv_sigma2=obs_isig.reshape(-1),
        obs_valid=rows_valid.reshape(-1),
    )
    return problem, cam_slots, pt_slots


def _gather_cluster_problems(state: MapState, assign, level_inv_sigma2, n_clusters: int,
                             cams_per: int, pts_per: int):
    """Every cluster's (problem, cam_slots, pt_slots), in cluster order."""
    inv_sig = torch.as_tensor(level_inv_sigma2, dtype=torch.float32, device=state.device)
    assign = torch.as_tensor(assign, device=state.device)
    return [_gather_cluster_problem(state, assign, inv_sig, c, cams_per, pts_per)
            for c in range(n_clusters)]


def _scatter_owned(base, slots, written, values, mine, group):
    """`base` after the reference's serial scatter at `slots` (padding, -1,
    clipped onto slot 0) of rows that write a new value where `written` and
    `base`'s own value elsewhere: the last write to a slot wins. Rows of
    clusters this rank solved (`mine`) carry `values`; the disjoint final
    writes are summed over the group."""
    n = base.shape[0]
    psum = (lambda x: x) if group is None else (lambda x: ba.group_sum(x, group))  # noqa: E731
    idx = torch.clamp(slots, min=0)
    sel = last_writes(idx, n) & written & mine
    acc = torch.zeros_like(base)
    acc[idx[sel]] = values[sel]
    hit = torch.zeros((n,), dtype=torch.int32, device=base.device)
    hit[idx[sel]] = 1
    acc, hit = psum(acc), psum(hit)
    return torch.where((hit > 0).reshape((n,) + (1,) * (base.dim() - 1)), acc, base)


def _solve_and_scatter(state: MapState, clusters, cam: Camera, lm_iters: int, cg_iters: int,
                       mesh: Mesh | None):
    rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    group = None if mesh is None else mesh.group
    dev = state.device
    C, Pc = clusters[0][1].shape[0], clusters[0][2].shape[0]
    poses, xyzs, mine = [], [], []
    for c, (problem, _, _) in enumerate(clusters):
        if c % size == rank:
            res = ba.bundle_adjust(problem, cam, lm_iters=lm_iters, cg_iters=cg_iters)
            poses.append(res.cam_pose)
            xyzs.append(res.xyz)
        else:
            poses.append(torch.zeros((C, 4, 4), dtype=torch.float32, device=dev))
            xyzs.append(torch.zeros((Pc, 3), dtype=torch.float32, device=dev))
        mine.append(c % size == rank)
    mine = torch.as_tensor(mine, device=dev)
    cam_slots = torch.stack([cl[1] for cl in clusters])
    cam_fixed = torch.stack([cl[0].cam_fixed for cl in clusters])
    pt_slots = torch.stack([cl[2] for cl in clusters])
    # Free cameras and owned points write their solution.
    kf_pose = _scatter_owned(state.kf_pose, cam_slots.reshape(-1), ((cam_slots >= 0) & ~cam_fixed).reshape(-1),
                             torch.cat(poses), mine.repeat_interleave(C), group)
    mp_xyz = _scatter_owned(state.mp_xyz, pt_slots.reshape(-1), (pt_slots >= 0).reshape(-1),
                            torch.cat(xyzs), mine.repeat_interleave(Pc), group)
    return state._replace(kf_pose=kf_pose, mp_xyz=mp_xyz)


def cluster_block_ba(state: MapState, cam: Camera, level_inv_sigma2, mesh: Mesh | None = None,
                     n_clusters: int | None = None, rounds: int = 2, lm_iters: int = 5,
                     cg_iters: int = 15, cams_per: int = 32, pts_per: int = 4096) -> MapState:
    """Refine the whole map by `rounds` of cluster-parallel block BA. With
    a mesh each rank solves its own clusters and every rank ends with the
    same map; `n_clusters` defaults to the group's size, or 4 without a
    group."""
    if n_clusters is None:
        n_clusters = mesh.size if mesh is not None else 4
    for _ in range(rounds):
        assign = covisibility_clusters(state.covis.cpu().numpy(), state.kf_valid.cpu().numpy(), n_clusters)
        clusters = _gather_cluster_problems(state, assign, level_inv_sigma2, n_clusters, cams_per, pts_per)
        state = _solve_and_scatter(state, clusters, cam, lm_iters, cg_iters, mesh)
    return state
