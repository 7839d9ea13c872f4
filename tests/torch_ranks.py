"""The rank side of tests/test_torch_parallel.py: the function that
`orb_slam_cuda_tpu_torch.parallel.multihost.start_ranks` runs in each of n
spawned ranks (gloo, a `file://` store under the test's temporary
directory, so that tests on several workers share no port). Imports no
JAX: each rank is a fresh interpreter that loads only the port."""

from __future__ import annotations

import torch
import torch.distributed as dist


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _ba_problem(arrays):
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba

    return ba.BAProblem(**{k: torch.as_tensor(v) for k, v in arrays.items()})


def _result(res):
    return {k: _np(v) for k, v in res._asdict().items()}


def parity_cases(rank: int, world: int, inputs: dict) -> dict:
    """All cases in one spawn of `world` (4) ranks: sub-groups of the first
    1 and 2 ranks stand for the smaller meshes."""
    torch.set_num_threads(1)
    from orb_slam_cuda_tpu_torch.geometry.camera import Camera
    from orb_slam_cuda_tpu_torch.parallel import cluster_ba, dist_ba, map_merge
    from orb_slam_cuda_tpu_torch.parallel.mesh import make_mesh
    from orb_slam_cuda_tpu_torch.slam_map import MapConfig, MapState

    groups = {1: dist.new_group([0]), 2: dist.new_group([0, 1]), 4: None}
    meshes = {n: make_mesh(g, device="cpu") for n, g in groups.items() if rank < n}
    out = {"partition": {}, "dist_ba": {}}

    part_problem = _ba_problem(inputs["partition_problem"])
    for n in (2, 4):
        if n in meshes:
            p = dist_ba.partition_problem(part_problem, meshes[n])
            out["partition"][n] = dict(local=_result(p.local), obs_src=_np(p.obs_src), pblk=p.pblk,
                                       n_obs=p.n_obs, n_pts=p.n_pts)

    cam = Camera.create(**inputs["ba_cam"])
    problem = _ba_problem(inputs["ba_problem"])
    for n, mesh in meshes.items():
        res = dist_ba.distributed_bundle_adjust(problem, cam, mesh, **inputs["ba_iters"])
        out["dist_ba"][n] = _result(res)

    if 2 in meshes:
        ring = MapState(**{k: torch.as_tensor(v) for k, v in inputs["ring"].items()})
        ring_cam = Camera.create(**inputs["ring_cam"])
        st = cluster_ba.cluster_block_ba(ring, ring_cam, torch.as_tensor(inputs["ring_inv_sig2"]),
                                         mesh=meshes[2], **inputs["cluster_kw"])
        out["cluster"] = dict(kf_pose=_np(st.kf_pose), mp_xyz=_np(st.mp_xyz))

        merged = MapState(**{k: torch.as_tensor(v) for k, v in inputs["merged"].items()})
        st = map_merge.merged_global_ba(merged, inputs["merged_order"], MapConfig(**inputs["merged_cfg"]),
                                        ring_cam, mesh=meshes[2], lm_iters=6, cg_iters=15)
        out["merged_gba"] = dict(kf_pose=_np(st.kf_pose), mp_xyz=_np(st.mp_xyz))

    if rank == 0 and "system" in inputs:
        out["system"] = _system_case(inputs["system"], meshes[1])
    return out


def _system_case(spec: dict, mesh) -> dict:
    """A System with a mesh and cluster refinement over the given frames."""
    from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
    from orb_slam_cuda_tpu_torch.geometry.camera import Camera

    cfg = SystemConfig(camera=Camera.create(**spec["cam"]), sensor=Sensor.MONOCULAR, mesh=mesh,
                       **spec["cfg"])
    slam = System(cfg, device="cpu")
    for i, img in enumerate(spec["frames"]):
        slam.track_monocular(torch.as_tensor(img), i * 0.1)
    rows = slam.timer.rows["timesMapping.csv"]
    return dict(traj=slam.get_trajectory(), status=slam.get_status(),
                n_keyframes=slam.stats.n_keyframes, n_cluster_refines=slam.stats.n_cluster_refines,
                tracked_ratio=slam.tracked_ratio(),
                stages=sorted({r[1] for r in rows}))


def fail_on_rank_one(rank: int, world: int):
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    dist.barrier()
