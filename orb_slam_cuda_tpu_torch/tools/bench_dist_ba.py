"""Distributed-BA scaling: LM iterations/s against the number of ranks
(port of tools/bench_dist_ba.py).

The reference's KITTI-scale problem (256 cameras 0.3 m apart, 20,000
points, 120,000 monocular observations with 0.5 px noise, poses and
points perturbed; the same sizes and seed, drawn with numpy in the same
order) is partitioned once per group size (parallel/dist_ba.py,
`partition_problem`; its time printed apart) and solved with
`solve_partitioned`, LM_ITERS=10 and CG_ITERS=20: one warm-up solve, then
the median of REPS timed solves, each ended by a barrier and a device
synchronize.

  --device cpu   1, 2, 4 and 8 gloo ranks on this host's CPU, its cores
                 split among them: a CPU curve (it measures the gloo
                 collectives and the split of one host's cores, not more
                 hardware);
  --device cuda  1 rank on NCCL, then 2 ranks sharing the one card over
                 gloo (two processes on one card: it measures the
                 collectives' overhead, not a second card).

Usage (from the repository root):
    python3 -m orb_slam_cuda_tpu_torch.tools.bench_dist_ba [--device cuda|cpu]
Prints one JSON line with the device each point ran on.
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

N_CAMS, N_PTS, N_OBS = 256, 20000, 120000
LM_ITERS = 10
CG_ITERS = 20
REPS = 3


def build_problem(rng):
    """(BAProblem arrays as numpy, camera arguments): the reference tool's
    problem, drawn in its order."""
    from ..geometry import se3

    cam_args = dict(fx=718.0, fy=718.0, cx=600.0, cy=180.0, width=1241, height=376)
    xi = np.zeros((N_CAMS, 6), np.float32)
    xi[:, 0] = 0.3 * np.arange(N_CAMS)
    xi[:, 4] = 0.01 * np.sin(np.arange(N_CAMS) * 0.1)
    poses = se3.exp(torch.as_tensor(xi)).numpy()
    X = np.stack([rng.uniform(-50, 50 + 0.3 * N_CAMS, N_PTS), rng.uniform(-5, 5, N_PTS),
                  rng.uniform(5, 60, N_PTS)], -1).astype(np.float32)
    oc = rng.integers(0, N_CAMS, N_OBS).astype(np.int64)
    op = rng.integers(0, N_PTS, N_OBS).astype(np.int64)
    Xc = np.einsum("eij,ej->ei", poses[oc, :3, :3], X[op]) + poses[oc, :3, 3]
    z = np.maximum(Xc[:, 2], 0.5)
    uv = np.stack([718.0 * Xc[:, 0] / z + 600.0, 718.0 * Xc[:, 1] / z + 180.0], -1).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    noise = np.stack([se3.exp(torch.as_tensor(rng.normal(0, 0.01, 6).astype(np.float32))).numpy()
                      for _ in range(N_CAMS)])
    arrays = dict(
        cam_pose=np.einsum("kij,kjl->kil", noise, poses).astype(np.float32), cam_fixed=np.arange(N_CAMS) == 0,
        xyz=X + rng.normal(0, 0.05, X.shape).astype(np.float32), pt_valid=np.ones(N_PTS, bool),
        obs_cam=oc, obs_pt=op, obs_uv=uv, obs_ur=np.full(N_OBS, -1.0, np.float32),
        obs_inv_sigma2=np.ones(N_OBS, np.float32), obs_valid=np.ones(N_OBS, bool),
    )
    return arrays, cam_args


def rank_bench(rank: int, world: int, path: str, device: str) -> dict:
    """One rank: partition the saved problem for the group, one warm-up
    solve, REPS timed solves."""
    import torch.distributed as dist

    from ..geometry.camera import Camera
    from ..parallel import dist_ba
    from ..parallel.mesh import make_mesh
    from ..solvers import bundle_adjust as ba

    mesh = make_mesh(device=device)
    saved = torch.load(path)
    problem = ba.BAProblem(**{k: v.to(mesh.device) for k, v in saved["problem"].items()})
    cam = Camera.create(**saved["cam"])

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier()

    sync()
    t0 = time.perf_counter()
    part = dist_ba.partition_problem(problem, mesh)
    sync()
    t_part = time.perf_counter() - t0
    res = dist_ba.solve_partitioned(part, cam, mesh, **saved["iters"])
    sync()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        res = dist_ba.solve_partitioned(part, cam, mesh, **saved["iters"])
        sync()
        times.append(time.perf_counter() - t0)
    return dict(solve_s=sorted(times)[len(times) // 2], partition_s=t_part, final_error=float(res.final_error),
                backend=dist.get_backend(), device=str(mesh.device), threads=torch.get_num_threads())


def run(device: str, rank_counts) -> dict:
    from ..parallel.multihost import run_ranks
    from . import dryrun_multichip

    arrays, cam_args = build_problem(np.random.default_rng(11))
    points = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "problem.pt")
        dryrun_multichip.save_problem(path, arrays, cam_args, LM_ITERS, CG_ITERS)
        for n in rank_counts:
            backend = None if device == "cpu" else ("nccl" if n == 1 else "gloo")
            dev = device if device == "cpu" else "cuda:0"
            outs = run_ranks(rank_bench, n, (path, dev), root=os.path.join(tmp, f"ranks{n}"), backend=backend,
                             device=device)
            o = outs[0]
            iters_s = LM_ITERS / max(x["solve_s"] for x in outs)
            points[str(n)] = dict(lm_iters_per_s=iters_s, solve_ms=1e3 * max(x["solve_s"] for x in outs),
                                  partition_ms=1e3 * o["partition_s"], final_error=o["final_error"],
                                  backend=o["backend"], devices=sorted({x["device"] for x in outs}),
                                  threads_per_rank=o["threads"])
            print(f"ranks={n} ({o['backend']}, {points[str(n)]['devices']}): "
                  f"{points[str(n)]['solve_ms']:.1f} ms/solve, {iters_s:.3f} LM iters/s, partition "
                  f"{points[str(n)]['partition_ms']:.0f} ms, final_err={o['final_error']:.1f}", file=sys.stderr)
    label = ("CPU curve: gloo ranks splitting one host's CPU cores" if device == "cpu" else
             "card points: 1 rank on NCCL, 2 ranks sharing the one card over gloo")
    card = None
    if device == "cuda":
        from .accuracy_eval import card_name

        card = card_name()
    return dict(metric="dist_ba_lm_iters_per_second", device=device, label=label, card=card,
                cpu_cores=os.cpu_count(), per_ranks=points, lm_iters=LM_ITERS, cg_iters=CG_ITERS,
                problem=dict(cams=N_CAMS, pts=N_PTS, obs=N_OBS))


def main(argv=None) -> int:
    from ..utils.device import resolve

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    resolve(args.device)
    print(json.dumps(run(args.device, (1, 2, 4, 8) if args.device == "cpu" else (1, 2))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
