"""The essential-graph solve of a tree of the port on the card: its host
launches and device kernels a Gauss-Newton step (torch.profiler), and its
times eager, captured and replayed, on chip_smoke.py's 256-keyframe ring
(763 edges) with the loop closer's 15 steps and 30 CG iterations.

Run from the root of the repository; `--tree DIR` measures another tree of
the port (e.g. an older commit unpacked with `git archive` into a
gitignored directory that the card's copy holds, such as `chipcmd/`): its
package and its chip_smoke.py are imported from DIR. Prints one JSON line.

    PYTHONPATH=$PWD python tests/torch_pose_graph_profile.py [--tree DIR] [--times] [--turns N]

Launches: one profile of a 1-step and one of a 2-step solve (each after an
unprofiled call of the same solve); a step is their difference, the rest
the solve's set-up. Host launches are the runtime API calls by which the
host puts work on the card (chip_smoke.LAUNCH_APIS). `--times`: the
15-step solve eager (median of `--turns` calls, each ending in a
synchronize), then as a `programs.Program` (capture_at 1): its first call
(eager, then the capture; the capture's own seconds from the program's
count) and the median of `--turns` replays. Where the tree pads the loop
closer's edge list (chip_smoke.padded_ring), the eager solve of the ring
padded to 1,024 edges is timed in turns with the unpadded one, and the two
solves' outputs compared (`padded_equal`).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.getcwd())
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--turns", type=int, default=3)
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path.insert(0, tree)
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from orb_slam_cuda_tpu_torch.engine import programs
    from orb_slam_cuda_tpu_torch.solvers import pose_graph

    if not torch.cuda.is_available():
        raise SystemExit("torch_pose_graph_profile: needs a CUDA device")
    assert os.path.dirname(os.path.abspath(pose_graph.__file__)).startswith(tree), pose_graph.__file__
    ring = cs.ring_pose_graph(cs.RING_KEYFRAMES, "cuda")

    def solve(steps):
        return pose_graph.optimize_pose_graph(ring, gn_iters=steps, cg_iters=30)

    counts = {}
    for steps in (1, 2):
        solve(steps)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            solve(steps)
            torch.cuda.synchronize()
        events = prof.events()
        counts[steps] = (sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in cs.LAUNCH_APIS),
                         sum(1 for e in events if e.device_type == DeviceType.CUDA))
    out = {"tree": tree, "card": _card(), "ring_edges": int(ring.edge_i.shape[0]),
           "host_launches_a_step": counts[2][0] - counts[1][0], "device_kernels_a_step": counts[2][1] - counts[1][1],
           "host_launches_set_up": 2 * counts[1][0] - counts[2][0],
           "device_kernels_set_up": 2 * counts[1][1] - counts[2][1]}
    if a.times:
        steps = cs.POSE_GRAPH_GN_STEPS if hasattr(cs, "POSE_GRAPH_GN_STEPS") else 15
        padded = cs.padded_ring("cuda") if hasattr(cs, "padded_ring") else None
        eager, eager_padded = [], []
        for _ in range(a.turns):
            t0 = time.perf_counter()
            want = solve(steps)
            torch.cuda.synchronize()
            eager.append((time.perf_counter() - t0) * 1e3)
            if padded is not None:
                t0 = time.perf_counter()
                got = pose_graph.optimize_pose_graph(padded, gn_iters=steps, cg_iters=30)
                torch.cuda.synchronize()
                eager_padded.append((time.perf_counter() - t0) * 1e3)
                out["padded_equal"] = all(torch.equal(x, y) for x, y in zip(want, got))
        if eager_padded:
            out.update(padded_edges=int(padded.edge_i.shape[0]), eager_padded_ms=eager_padded,
                       eager_padded_median_ms=statistics.median(eager_padded))
        program = programs.Program(lambda p: pose_graph.optimize_pose_graph(p, gn_iters=steps, cg_iters=30), "ring")
        t0 = time.perf_counter()
        program(ring)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        replays = []
        for _ in range(a.turns):
            t0 = time.perf_counter()
            program(ring)
            torch.cuda.synchronize()
            replays.append((time.perf_counter() - t0) * 1e3)
        out.update(gn_steps=steps, eager_ms=eager, eager_median_ms=statistics.median(eager),
                   first_program_call_ms=first, capture_ms=program.stats()["capture_s"] * 1e3,
                   replay_ms=replays, replay_median_ms=statistics.median(replays))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
