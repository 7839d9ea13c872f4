"""The loop closer's Sim3 refinement of a tree of the port on the card: the
host launches and device kernels of one eager `sim3_refine` call and the
share of them under OptimizeSim3's Jacobian (torch.profiler), and its
times eager, captured and replayed.

The call: the loop closer's `sim3_refine` program function
(SearchBySim3, OptimizeSim3's 15 LM iterations, the loop group's point
count) on the drifted-ring map of tests/torch_ring.py built on the card,
keyframe 15 against candidate 0, its arguments those that the loop
closer's own `_compute_sim3` hands the program (256 features a keyframe).
Beside it `optimize_sim3` alone at full width: 2,000 correspondences (a
KITTI keyframe's features), 400 of them outliers.

Run from the root of the repository; `--tree DIR` measures another tree of
the port (e.g. an older commit unpacked with `git archive` into a
gitignored directory that the card's copy holds, such as `chipcmd/`): its
package and its tests/torch_ring.py are imported from DIR. Prints one JSON
line.

    PYTHONPATH=$PWD python tests/torch_sim3_opt_profile.py [--tree DIR] [--times] [--turns N]

First, with the kernels built and loaded, the candidate's first pass
through the loop closer's four Sim3 programs in this process, each
program's call timed (`first_call_ms_by_program`): as a path's first loop
closure meets them, `sim3_match`, `sim3_ransac` and `loop_gate` run eagerly
and capture, `sim3_refine` runs eagerly (capture_at 2).

Host launches are the runtime API calls by which the host puts work on the
card (chip_smoke.LAUNCH_APIS); `jacobian_*` counts those inside the
Jacobian's calls (a `record_function` span around the tree's
`sim3_opt_kernel.jacobian`, or `sim3.tangent_jacobian` on a tree without
it) and their share of the call's wall time. Each profiled call follows an
unprofiled one of the same call. `--times`: the refinement eager (median
of `--turns` calls, each ending in a synchronize), then as a
`programs.Program` (capture_at 1): its first call (eager, then the
capture; the capture's own seconds from the program's count) and the
median of `--turns` replays, each replay `torch.equal` to the eager call;
and the full-width `optimize_sim3` eager.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SPAN = "sim3_opt_jacobian"
FULL_WIDTH, OUTLIERS = 2000, 400


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def full_width_problem(device, m=FULL_WIDTH, n_out=OUTLIERS, seed=2000):
    """optimize_sim3's arguments at `m` correspondences: points 3-30 m in
    front of keyframe 2's camera (a KITTI camera), keyframe 1 a Sim3 away,
    `n_out` observations in keyframe 1 moved 20-60 px, the initial estimate
    a small Sim3 off the truth."""
    import numpy as np
    import torch

    from orb_slam_cuda_tpu_torch.geometry import sim3
    from orb_slam_cuda_tpu_torch.geometry.camera import Camera

    cam = Camera.create(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241, height=376)
    rng = np.random.default_rng(seed)
    z = rng.uniform(3.0, 30.0, m)
    x2c = np.stack([rng.uniform(-0.9, 0.9, m) * z, rng.uniform(-0.25, 0.25, m) * z, z], -1)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    S_true = sim3.exp(f32([0.4, -0.05, 0.8, 0.01, -0.06, 0.005, 0.08]))
    x1c = sim3.transform(S_true, f32(x2c))

    def proj(X):
        return torch.stack([cam.fx * X[:, 0] / X[:, 2] + cam.cx, cam.fy * X[:, 1] / X[:, 2] + cam.cy], -1)

    uv1, uv2 = proj(x1c), proj(f32(x2c))
    out = rng.choice(m, n_out, replace=False)
    uv1[out] += f32(rng.uniform(20, 60, (n_out, 2)))
    isig = f32(rng.choice([1.0, 1 / 1.44, 1 / 1.44**2], m))
    S0 = sim3.compose(sim3.exp(f32([0.03, -0.02, 0.05, 0.01, -0.008, 0.006, 0.02])), S_true)
    args = (tuple(a.contiguous() for a in S0), x1c, f32(x2c), uv1, uv2, isig, isig, torch.ones(m, dtype=torch.bool))
    move = lambda a: tuple(move(x) for x in a) if isinstance(a, tuple) else a.to(device)  # noqa: E731
    return tuple(move(a) for a in args), cam


def _jacobian_span():
    """Wrap the tree's Jacobian in a `record_function` span: the kernel's
    wrapper where the tree has one, else sim3.tangent_jacobian (which the
    refinement then calls). Returns the wrapped function's name."""
    import torch

    try:
        from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel as mod
        name = "jacobian"
    except ImportError:
        from orb_slam_cuda_tpu_torch.geometry import sim3 as mod
        name = "tangent_jacobian"
    fn = getattr(mod, name)

    def spanned(*args, **kw):
        with torch.profiler.record_function(SPAN):
            return fn(*args, **kw)

    setattr(mod, name, spanned)
    return f"{mod.__name__}.{name}"


def profile_call(fn, device, launch_apis) -> dict:
    """One profiled call of `fn` after an unprofiled one: host launches,
    device kernels, wall ms, and the launches and wall share inside the
    Jacobian's spans."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    spans = [e.time_range for e in events if e.name == SPAN and e.device_type == DeviceType.CPU]
    launches = [e for e in events if e.device_type == DeviceType.CPU and e.name in launch_apis]
    inside = sum(1 for e in launches if any(s.start <= e.time_range.start <= s.end for s in spans))
    span_us = sum(s.end - s.start for s in spans)
    return {"host_launches": len(launches), "device_kernels": sum(1 for e in events if e.device_type == DeviceType.CUDA),
            "wall_ms": wall, "jacobian_calls": len(spans), "jacobian_host_launches": inside,
            "jacobian_launch_share": inside / max(len(launches), 1), "jacobian_wall_ms": span_us / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.getcwd())
    ap.add_argument("--times", action="store_true")
    ap.add_argument("--turns", type=int, default=3)
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    sys.path[:0] = [tree, os.path.join(tree, "tests")]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_sim3_opt_profile: needs a CUDA device")
    import chip_smoke as cs
    from orb_slam_cuda_tpu_torch.engine import loop_closing, programs
    from orb_slam_cuda_tpu_torch.ops import segsum, sim3_kernel
    from orb_slam_cuda_tpu_torch.solvers import sim3_opt
    from torch_ring import CAM, CFG, build_drifted_ring

    assert os.path.dirname(os.path.abspath(sim3_opt.__file__)).startswith(tree), sim3_opt.__file__
    dev = torch.device("cuda")
    wrapped = _jacobian_span()
    kernels = [sim3_kernel, segsum]
    try:
        from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel

        kernels.append(sim3_opt_kernel)
    except ImportError:
        sim3_opt_kernel = None
    for k in kernels:  # built and loaded before any timing, as chip_smoke.py builds them first
        k.build()
        k._load()
    state = build_drifted_ring(np.random.default_rng(0), device=dev)[0]
    lc = loop_closing.LoopCloser(CFG, CAM, None)
    first, seen, originals = {}, [], {}  # the first pass, timed by program

    def timed(attr):
        program = originals[attr] = getattr(lc, attr)

        def run(*args):
            if attr == "_refine_fn":
                seen.append(args)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = program(*args)
            torch.cuda.synchronize()
            first[program.name] = first.get(program.name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out

        return run

    for attr in ("_match_fn", "_ransac_fn", "_refine_fn", "_gate_fn"):
        setattr(lc, attr, timed(attr))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hit = lc._compute_sim3(state, 15, [0])
    torch.cuda.synchronize()
    first_total = (time.perf_counter() - t0) * 1e3
    for attr, program in originals.items():
        setattr(lc, attr, program)
    if hit is None or not seen:
        raise SystemExit("torch_sim3_opt_profile: the ring's candidate did not reach the refinement")
    args = seen[-1]
    counter = sim3_opt_kernel

    def refine():
        return lc._refine_program(*args)

    fw_args, fw_cam = full_width_problem(dev)

    def full_width():
        return sim3_opt.optimize_sim3(*fw_args, fw_cam)

    out = {"tree": tree, "card": _card(), "jacobian_fn": wrapped, "refine_features": int(args[6].shape[0]),
           "first_compute_sim3_ms": first_total, "first_call_ms_by_program": first,
           "refine": profile_call(refine, dev, cs.LAUNCH_APIS),
           "full_width": dict(profile_call(full_width, dev, cs.LAUNCH_APIS), matches=FULL_WIDTH)}
    if counter is not None:
        n0 = counter.launches
        refine()
        out["kernel_launches_a_refine"] = counter.launches - n0
    if a.times:
        eager = []
        for _ in range(a.turns):
            t0 = time.perf_counter()
            want = refine()
            torch.cuda.synchronize()
            eager.append((time.perf_counter() - t0) * 1e3)
        graphed = programs.Program(lc._refine_program, "sim3_refine_profile")
        t0 = time.perf_counter()
        graphed(*args)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        replays, equal = [], True
        for _ in range(a.turns):
            n0 = counter.launches if counter is not None else 0
            t0 = time.perf_counter()
            got = graphed(*args)
            torch.cuda.synchronize()
            replays.append((time.perf_counter() - t0) * 1e3)
            equal &= all(torch.equal(x, y) for x, y in zip(got, want))
            if counter is not None:
                out["kernel_launches_a_replay"] = counter.launches - n0
        fw = []
        for _ in range(a.turns):
            t0 = time.perf_counter()
            full_width()
            torch.cuda.synchronize()
            fw.append((time.perf_counter() - t0) * 1e3)
        out.update(eager_ms=eager, eager_median_ms=statistics.median(eager), first_program_call_ms=first,
                   capture_ms=graphed.stats()["capture_s"] * 1e3, replay_ms=replays,
                   replay_median_ms=statistics.median(replays), replays_equal_eager=bool(equal),
                   full_width_eager_ms=fw, full_width_eager_median_ms=statistics.median(fw))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
