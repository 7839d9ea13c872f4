"""Two-rank distributed-BA demo (port of tools/multihost_demo.py).

Two processes join one `torch.distributed` process group (a file store;
gloo on the CPU, or ranks sharing one card; NCCL when each has a card of
its own), and each runs the point-block distributed solve
(parallel/dist_ba.py) of the same stereo problem: 6 cameras 0.15 m apart
and 96 points, observations with 0.5 px noise, initial poses and points
perturbed (the reference's tests/test_bundle_adjust.py::build_problem,
drawn in the same order). Checks that both ranks end with the same bits,
and prints how far they are from the single-process bundle_adjust.

Usage (from the repository root):
    python3 -m orb_slam_cuda_tpu_torch.tools.multihost_demo [--device cuda|cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

RANKS = 2
LM_ITERS, CG_ITERS = 8, 15


def stereo_problem(rng, n_cams=6, n_pts=120, noise_px=0.5, pose_noise=0.02, pt_noise=0.05, bf=0.0):
    """(BAProblem arrays as numpy, camera arguments, true poses): points
    3-10 m ahead, cameras along x, every point seen by every camera."""
    from ..geometry import camera as cam_mod
    from ..geometry import se3

    cam_args = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=bf, width=640, height=480)
    cam = cam_mod.Camera.create(**cam_args)
    X = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts), rng.uniform(5, 10, n_pts)],
                 axis=-1).astype(np.float32)
    xi = np.zeros((n_cams, 6), np.float32)
    xi[:, 0] = 0.15 * np.arange(n_cams)
    xi[:, 4] = 0.01 * np.arange(n_cams)
    poses_true = se3.exp(torch.as_tensor(xi)).numpy()
    obs_cam, obs_pt, obs_uv, obs_ur = [], [], [], []
    for c in range(n_cams):
        Xc = X @ poses_true[c, :3, :3].T + poses_true[c, :3, 3]
        uvr = cam_mod.project_stereo(cam, torch.as_tensor(Xc)).numpy()
        for p in range(n_pts):
            obs_cam.append(c)
            obs_pt.append(p)
            obs_uv.append(uvr[p, :2] + rng.normal(0, noise_px, 2))
            obs_ur.append(uvr[p, 2] + rng.normal(0, noise_px) if bf > 0 else -1.0)
    E = len(obs_cam)
    poses0 = []
    for c in range(n_cams):
        noise = np.zeros(6, np.float32)
        if c > 0:
            noise = rng.normal(0, pose_noise, 6).astype(np.float32)
        poses0.append(se3.exp(torch.as_tensor(noise)).numpy() @ poses_true[c])
    X0 = X + rng.normal(0, pt_noise, X.shape).astype(np.float32)
    arrays = dict(
        cam_pose=np.stack(poses0).astype(np.float32), cam_fixed=np.arange(n_cams) == 0,
        xyz=X0.astype(np.float32), pt_valid=np.ones(n_pts, bool),
        obs_cam=np.asarray(obs_cam, np.int64), obs_pt=np.asarray(obs_pt, np.int64),
        obs_uv=np.asarray(obs_uv, np.float32), obs_ur=np.asarray(obs_ur, np.float32),
        obs_inv_sigma2=np.ones(E, np.float32), obs_valid=np.ones(E, bool),
    )
    return arrays, cam_args, poses_true


def run(device="cuda") -> dict:
    from ..geometry.camera import Camera
    from ..parallel.multihost import run_ranks
    from ..solvers import bundle_adjust as ba
    from ..utils.device import resolve
    from . import dryrun_multichip

    device = str(resolve(device))
    arrays, cam_args, _ = stereo_problem(np.random.default_rng(5), n_cams=6, n_pts=96, bf=50.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "problem.pt")
        dryrun_multichip.save_problem(path, arrays, cam_args, LM_ITERS, CG_ITERS)
        t0 = time.perf_counter()
        outs = run_ranks(dryrun_multichip.rank_solve, RANKS, (path, device), root=os.path.join(tmp, "ranks"),
                         device=device)
        wall = time.perf_counter() - t0
    problem = ba.BAProblem(**{k: torch.as_tensor(v, device=device) for k, v in arrays.items()})
    single = ba.bundle_adjust(problem, Camera.create(**cam_args), lm_iters=LM_ITERS, cg_iters=CG_ITERS)
    res = [o["result"] for o in outs]
    agree = all(torch.equal(res[0][k], res[1][k]) for k in res[0])
    return dict(
        metric="multihost_demo", ok=bool(agree and np.isfinite(float(res[0]["final_error"]))), processes=RANKS,
        backend=outs[0]["backend"], rank_devices=[o["device"] for o in outs], ranks_agree=agree,
        final_error=float(res[0]["final_error"]), single_final_error=float(single.final_error),
        pose_diff_vs_single=float((res[0]["cam_pose"] - single.cam_pose.cpu()).abs().max()),
        solve_s_per_rank=[o["seconds"] for o in outs], wall_s=wall,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = run(args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
