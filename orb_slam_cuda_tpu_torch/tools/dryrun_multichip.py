"""Dry run of the distributed global BA over n ranks (the port's
counterpart of the reference's `__graft_entry__.dryrun_multichip`).

Spawns n ranks that join one process group and each run one
`distributed_bundle_adjust` (lm_iters=2, cg_iters=5) on the same tiny
stereo problem, 4 cameras and 64 points; every rank's final error must be
finite and the ranks must agree bit for bit. `rank_solve`, the rank side,
also serves chip_smoke.py and the card tests: it solves any problem saved
with `save_problem`.

Usage (from the repository root):
    python3 -m orb_slam_cuda_tpu_torch.tools.dryrun_multichip [--ranks 2] [--device cuda|cpu]

On the CPU the ranks run on gloo; on the card, NCCL when each rank has a
card of its own, else gloo with the ranks sharing the card.
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


def tiny_problem():
    """(BAProblem arrays as numpy, camera arguments): 4 cameras 0.1 m
    apart on x, 64 points 3-6 m ahead, every point seen by every camera
    with its right-image coordinate, the points perturbed by 5 cm."""
    from ..geometry import camera as cam_mod
    from ..geometry import se3

    rng = np.random.default_rng(0)
    n_cams, n_pts = 4, 64
    cam_args = dict(fx=200.0, fy=200.0, cx=80.0, cy=60.0, bf=20.0, width=160, height=120)
    cam = cam_mod.Camera.create(**cam_args)
    X = np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts), rng.uniform(3, 6, n_pts)],
                 axis=-1).astype(np.float32)
    xi = np.zeros((n_cams, 6), np.float32)
    xi[:, 0] = 0.1 * np.arange(n_cams)
    poses = se3.exp(torch.as_tensor(xi)).numpy()
    obs_cam, obs_pt, obs_uv, obs_ur = [], [], [], []
    for c in range(n_cams):
        Xc = X @ poses[c][:3, :3].T + poses[c][:3, 3]
        uvr = cam_mod.project_stereo(cam, torch.as_tensor(Xc)).numpy()
        obs_cam += [c] * n_pts
        obs_pt += list(range(n_pts))
        obs_uv.append(uvr[:, :2])
        obs_ur.append(uvr[:, 2])
    E = len(obs_cam)
    arrays = dict(
        cam_pose=poses, cam_fixed=np.arange(n_cams) == 0,
        xyz=X + rng.normal(0, 0.05, X.shape).astype(np.float32), pt_valid=np.ones(n_pts, bool),
        obs_cam=np.asarray(obs_cam, np.int64), obs_pt=np.asarray(obs_pt, np.int64),
        obs_uv=np.concatenate(obs_uv).astype(np.float32), obs_ur=np.concatenate(obs_ur).astype(np.float32),
        obs_inv_sigma2=np.ones(E, np.float32), obs_valid=np.ones(E, bool),
    )
    return arrays, cam_args


def save_problem(path: str, problem, cam, lm_iters: int, cg_iters: int):
    """Write a problem (a BAProblem on any device, or a dict of its arrays)
    with its camera (a Camera, or `Camera.create`'s arguments) and
    iteration counts, for `rank_solve`."""
    arrays = problem._asdict() if hasattr(problem, "_asdict") else problem
    cam_args = cam._asdict() if hasattr(cam, "_asdict") else dict(cam)
    torch.save(dict(problem={k: torch.as_tensor(v).cpu() for k, v in arrays.items()}, cam=cam_args,
                    iters=dict(lm_iters=lm_iters, cg_iters=cg_iters)), path)


def rank_solve(rank: int, world: int, path: str, device: str) -> dict:
    """One rank: load the problem at `path`, solve it with
    distributed_bundle_adjust over the whole group on this rank's device,
    return the result on the CPU and the solve's seconds."""
    from ..geometry.camera import Camera
    from ..parallel import dist_ba
    from ..parallel.mesh import make_mesh
    from ..solvers import bundle_adjust as ba

    import torch.distributed as dist

    mesh = make_mesh(device=device)
    saved = torch.load(path)
    problem = ba.BAProblem(**{k: v.to(mesh.device) for k, v in saved["problem"].items()})
    cam = Camera.create(**saved["cam"])
    dist.barrier()
    t0 = time.perf_counter()
    res = dist_ba.distributed_bundle_adjust(problem, cam, mesh, **saved["iters"])
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    seconds = time.perf_counter() - t0
    return dict(result={k: v.cpu() for k, v in res._asdict().items()}, seconds=seconds,
                device=str(mesh.device), backend=dist.get_backend())


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """Spawn n ranks, solve the tiny problem on each; raises unless every
    final error is finite and the ranks agree bit for bit."""
    from ..parallel.multihost import run_ranks
    from ..utils.device import resolve

    device = str(resolve(device))
    arrays, cam_args = tiny_problem()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "problem.pt")
        save_problem(path, arrays, cam_args, lm_iters=2, cg_iters=5)
        outs = run_ranks(rank_solve, n_ranks, (path, device), root=tmp, device=device)
    errs = [float(o["result"]["final_error"]) for o in outs]
    if not all(np.isfinite(errs)):
        raise AssertionError(f"final error not finite: {errs}")
    agree = all(torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0]["result"].values(),
                                                                      o["result"].values()))
    if not agree:
        raise AssertionError("ranks disagree")
    return dict(ranks=n_ranks, backend=outs[0]["backend"], devices=[o["device"] for o in outs],
                final_error=errs[0], ranks_agree=agree, seconds=[o["seconds"] for o in outs])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(json.dumps(dict(metric="dryrun_multichip", **dryrun_multichip(args.ranks, args.device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
