"""The whole SLAM engine on a 2-rank process group (port of
tools/multihost_system.py).

Every rank runs the same host program on the same frames (tracking,
mapping and loop closing stay on the rank), and the group-wide solves run
over `torch.distributed`: the global BA at loop closure
(parallel/dist_ba.py, `SystemConfig.mesh`) and the periodic
covisibility-cluster BA (parallel/cluster_ba.py,
`cluster_refine_interval`). The ranks meet at a barrier after each frame,
as a shared camera feed would pace them.

Two configurations:
  --device cpu   the JAX tool's: 320x240, 800 features, an 8-wall room
                 (seed 7), 300 frames of 1.3 laps of radius 5 m, loop
                 closing on, cluster_refine_interval 24, gloo ranks.
  --device cuda  chip_smoke.py's loop path at full width: 1241x376 (the
                 KITTI00-02 camera), 2000 features, the 340-frame circuit
                 of radius 22 m in the 12-wall room with 40 billboards,
                 frames 100-102 blank, loop closing on, cluster refinement
                 every 24 keyframes; both ranks share one card over gloo
                 (NCCL when each rank has a card of its own).

Gates: both ranks write byte-equal TUM trajectory files (sha256), >= 1
loop closed, >= 1 cluster refinement, tracked >= 0.9 (cpu, the JAX
tool's) or >= 0.85 (cuda, the loop path's: the blank frames are lost),
and on cuda a sim(3) ATE within 1% of the trajectory's extent. Prints one
JSON line; a failed gate or rank exits non-zero.

Usage (from the repository root):
    python3 -m orb_slam_cuda_tpu_torch.tools.multihost_system [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

RANKS = 2
CPU = dict(width=320, height=240, n_features=800, frames=300, tracked_gate=0.9)
CUDA = dict(width=1241, height=376, n_features=2000, frames=340, tracked_gate=0.85, blank_at=100)


def cpu_fixture(device):
    """The JAX tool's scene, camera and circuit."""
    from ..geometry.camera import Camera
    from ..utils import synthetic

    W, H = CPU["width"], CPU["height"]
    scene = synthetic.room_scene(np.random.default_rng(7), half_size=9.0, tex_size=768, n_walls=8)
    poses = synthetic.circuit_trajectory(CPU["frames"], radius=5.0, laps=1.3)
    cam = Camera.create(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
    return cam, poses, [scene.render(cam.K, T, W, H, device=device) for T in poses]


def cuda_fixture(device):
    """chip_smoke.py's loop path: the KITTI accuracy configs' scene and
    circuit, frames blank_at..blank_at+2 blank."""
    from ..geometry.camera import Camera
    from ..utils import synthetic

    W, H = CUDA["width"], CUDA["height"]
    rng = np.random.default_rng(5)
    scene = synthetic.room_scene(rng, half_size=36.0, tex_size=3072, n_walls=12)
    scene.planes.extend(synthetic.ring_obstacles(rng, 24, 28.0))
    scene.planes.extend(synthetic.ring_obstacles(rng, 16, 15.0, height=3.0, width=4.0))
    poses = synthetic.circuit_trajectory(CUDA["frames"], radius=22.0, laps=1.3)
    cam = Camera.create(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=W, height=H)
    frames = [scene.render(cam.K, T, W, H, device=device) for T in poses]
    for i in range(CUDA["blank_at"], CUDA["blank_at"] + 3):
        frames[i] = torch.zeros_like(frames[i])
    return cam, poses, frames


def system_config(kind: str, cam, mesh):
    from ..engine import Sensor, SystemConfig

    if kind == "cpu":
        return SystemConfig(camera=cam, sensor=Sensor.MONOCULAR, n_features=CPU["n_features"], max_keyframes=128,
                            max_points=16384, enable_loop_closing=True, max_frames_between_kf=30,
                            min_frames_between_kf=0, mesh=mesh, cluster_refine_interval=24)
    # chip_smoke.py::circuit_config, monocular.
    return SystemConfig(camera=cam, sensor=Sensor.MONOCULAR, n_features=CUDA["n_features"], max_keyframes=256,
                        max_points=32768, enable_loop_closing=True, max_frames_between_kf=10,
                        min_frames_between_kf=0, async_mapping=True, pipeline_lag=0, th_depth_factor=40.0,
                        mesh=mesh, cluster_refine_interval=24)


def rank_main(rank: int, world: int, kind: str, out_dir: str) -> dict:
    """One rank: track every frame, barrier after each, write the TUM
    trajectory, return the outcome."""
    import torch.distributed as dist

    from ..engine import System
    from ..parallel.mesh import make_mesh
    from ..utils.evaluation import ate_rmse, camera_centers

    device = "cpu" if kind == "cpu" else "cuda"
    mesh = make_mesh(device=device)
    cam, poses, frames = (cpu_fixture if kind == "cpu" else cuda_fixture)(mesh.device)
    # Seed of the synthetic vocabulary: the JAX tool's 1, chip_smoke.py's 0.
    slam = System(system_config(kind, cam, mesh), seed=1 if kind == "cpu" else 0, device=mesh.device)
    dist.barrier()
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        slam.track_monocular(img, i * 0.1)
        dist.barrier()
    slam._flush_pipeline()
    dist.barrier()
    wall = time.perf_counter() - t0
    path = os.path.join(out_dir, f"traj.rank{rank}.txt")
    slam.save_trajectory_tum(path)
    with open(path, "rb") as f:
        blob = f.read()
    status = slam.get_status()
    ts, est = camera_centers(slam.get_trajectory())
    gt_by_t = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    gt = np.asarray([gt_by_t[round(t, 6)] for t in ts])
    ate = float(ate_rmse(est, gt, with_scale=True)) if len(est) >= 3 else float("inf")
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0))) if len(gt) else 0.0
    stages = {}
    for _, stage, _, ns in slam.timer.rows["timesMapping.csv"]:
        if stage == "cluster_refine" or stage.startswith("gba_"):
            stages.setdefault(stage, []).append(ns / 1e6)
    return dict(
        rank=rank, device=str(mesh.device), backend=dist.get_backend(), tracked_ratio=slam.tracked_ratio(),
        keyframes=status["keyframes"], keyframes_live=len(slam.kf_order), loops_closed=status["loops_closed"],
        relocalizations=status["relocalizations"], cluster_refines=slam.stats.n_cluster_refines,
        traj_sha256=hashlib.sha256(blob).hexdigest(), traj_rows=blob.count(b"\n"), wall_s=wall,
        fps=len(frames) / wall, ate_m=ate, extent_m=extent,
        stage_ms={k: dict(mean=float(np.mean(v)), n=len(v)) for k, v in sorted(stages.items())},
    )


def run(kind: str) -> dict:
    from ..parallel.multihost import run_ranks
    from .accuracy_eval import card_name

    from ..utils.device import resolve

    resolve(kind)
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks(rank_main, RANKS, (kind, tmp), root=os.path.join(tmp, "ranks"),
                         device="cpu" if kind == "cpu" else "cuda")
    a, b = outs
    agree = a["traj_sha256"] == b["traj_sha256"]
    gate = CPU["tracked_gate"] if kind == "cpu" else CUDA["tracked_gate"]
    checks = {
        "ranks_agree": agree,
        "loops_closed >= 1": a["loops_closed"] >= 1,
        "cluster_refines >= 1": a["cluster_refines"] >= 1,
        f"tracked_ratio >= {gate}": a["tracked_ratio"] >= gate,
    }
    if kind == "cuda":
        checks["ATE <= 1% of extent"] = a["ate_m"] <= 0.01 * a["extent_m"]
    return dict(
        metric="multihost_system", ok=all(checks.values()), failed=[k for k, v in checks.items() if not v],
        device=kind, card=card_name() if kind == "cuda" else None, processes=RANKS,
        backend=a["backend"], rank_devices=[o["device"] for o in outs], ranks_agree=agree,
        **{k: a[k] for k in ("tracked_ratio", "keyframes", "keyframes_live", "loops_closed", "relocalizations",
                             "cluster_refines", "traj_rows", "ate_m", "extent_m", "stage_ms")},
        ate_share_of_extent=a["ate_m"] / max(a["extent_m"], 1e-9),
        wall_s_per_rank=[o["wall_s"] for o in outs], fps_per_rank=[o["fps"] for o in outs],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    result = run(args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
