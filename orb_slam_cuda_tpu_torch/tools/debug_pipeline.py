"""Synchronous (lag 0) against pipelined (lag 3) tracking on bench.py's
orbit, on one GPU.

bench.py's configuration (bench.py:49-118): the 108-frame synthetic
KITTI-resolution orbit (1241x376, 2000 features, loop closing on,
`max_frames_between_kf=10`, `min_frames_between_kf=4`) on the stock-scale
vocabulary (k=10, L=6, generated once into build/ by chip_smoke.py's
phase), the frames handed over as host arrays. For each lag it prints:

- tracked ratio, keyframes, loops and sim(3) ATE;
- fps, p50 and p99 of the per-call host time over frames 48-107 (bench.py's
  window; fps counts the final flush of the frames still in flight);
- from torch.profiler over 10 frames of that window (a second run of the
  same frames, so that the profiler does not touch the timed one): device
  launches a frame, device busy time a frame, and the idle share of the
  card over those frames' wall time.

Then, on the lag-3 System's final state, it captures one pipelined step
(`tracking.fused_pipeline_step`) as a CUDA graph and replays it: the
replay's outputs must be torch.equal to the eager step's on the same
inputs, and the replay time is printed beside the eager time (CUDA events
around the call, median of 20). If the capture fails it prints the op it
failed at and the error.

Everything is also written as JSON to `--out`.

Usage (from the repository root; needs one GPU unless --device cpu, which
rehearses the drive at a few frames without the profile and the graph):
    python3 -m orb_slam_cuda_tpu_torch.tools.debug_pipeline [--lags 0 3] [--frames 108]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

WINDOW_FROM = 48
PROFILE_FROM, PROFILE_FRAMES = 60, 10


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_system(cs, cam, vocab, lag, device):
    from orb_slam_cuda_tpu_torch.engine import System

    return System(dataclasses.replace(cs.orbit_config(cam), pipeline_lag=lag), vocab=vocab, device=device)


def drive(cs, cam, poses, frames, vocab, lag, device):
    """One timed run over every frame. Returns (System, record)."""
    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    slam = make_system(cs, cam, vocab, lag, device)
    frame_ms = []
    for i, img in enumerate(frames):
        t0 = time.perf_counter()
        slam.track_monocular(img, i * 0.1)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    status = slam.get_status()  # retires the frames still in flight
    _sync(device)
    flush_ms = (time.perf_counter() - t0) * 1e3
    ts, est = camera_centers(slam.get_trajectory())
    gt_by_t = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    gt = np.asarray([gt_by_t[round(t, 6)] for t in ts])
    ate = float(ate_rmse(est, gt)) if len(est) >= 3 else float("inf")
    window = np.asarray(frame_ms[WINDOW_FROM:] or frame_ms)
    p50, p99 = np.percentile(window, [50, 99])
    rec = dict(lag=lag, status=status, tracked_ratio=slam.tracked_ratio(), keyframes=slam.stats.n_keyframes,
               lost=slam.stats.n_lost, ate_m=ate, window=[min(WINDOW_FROM, len(frame_ms) - len(window)),
                                                        len(frame_ms) - 1],
               fps=len(window) / ((window.sum() + flush_ms) / 1e3), p50_ms=float(p50), p99_ms=float(p99),
               max_ms=float(window.max()), flush_ms=flush_ms, frame_ms=frame_ms,
               stage_means={csv: slam.timer.summary(csv) for csv in ("times.csv", "timesTracking.csv",
                                                                     "timesMapping.csv")})
    return slam, rec


def _busy_us(events) -> float:
    """Device time covered by the union of the events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy


def profile(cs, cam, frames, vocab, lag, device):
    """Track frames 0..PROFILE_FROM-1, then profile the next PROFILE_FRAMES."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    slam = make_system(cs, cam, vocab, lag, device)
    for i, img in enumerate(frames[:PROFILE_FROM]):
        slam.track_monocular(img, i * 0.1)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_FROM, PROFILE_FROM + PROFILE_FRAMES):
            slam.track_monocular(frames[i], i * 0.1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("torch.profiler recorded no device event")
    busy = _busy_us(dev)
    kernels = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return dict(frames=[PROFILE_FROM, PROFILE_FROM + PROFILE_FRAMES - 1],
                launches_per_frame=len(dev) / PROFILE_FRAMES, device_ms_per_frame=busy / 1e3 / PROFILE_FRAMES,
                wall_ms_per_frame=wall_us / 1e3 / PROFILE_FRAMES, idle_share=1.0 - busy / wall_us,
                top_device_ms_per_frame={k: v / 1e3 / PROFILE_FRAMES for k, v in top})


class _LastOp(TorchDispatchMode):
    """Remembers the last aten op dispatched and the port's line that
    called it."""

    def __init__(self):
        super().__init__()
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        frames = [f for f in traceback.extract_stack() if "orb_slam_cuda_tpu_torch" in f.filename
                  and "tools" not in f.filename]
        where = f"{frames[-1].filename.split('orb_slam_cuda_tpu_torch/')[-1]}:{frames[-1].lineno}" if frames else "?"
        self.last = f"{func} at {where}"
        return func(*args, **(kwargs or {}))


def _events_median_ms(fn, reps=20):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_replay(slam, image):
    """Capture one pipelined step as a CUDA graph, replay it, hold it
    against the eager step on the same inputs and time both."""
    from orb_slam_cuda_tpu_torch.engine import tracking
    from orb_slam_cuda_tpu_torch.engine.frame import build_frame
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    if slam._carry is None:
        slam._carry = slam._make_carry()
    carry = tracking.TrackCarry(*(t.clone() for t in slam._carry))
    img = slam.extractor.upload(image).clone()
    min_obs = 3 if len(slam.kf_order) > 2 else 2

    def step():
        return tracking.fused_pipeline_step(
            slam.state, img, carry, min_obs, slam.extractor._extract_impl,
            lambda f: build_frame(f, slam.cam, slam.vocab), slam.cam, slam._scale_factors_dev,
            slam._radius_mm, slam.th_depth, slam._vo_th_depth)

    def flat(out):
        frame, res, nxt = out
        return [*frame, *res, *nxt]

    launches0 = fast_kernel.launches
    ref = flat(step())
    torch.cuda.synchronize()
    eager_ms = _events_median_ms(step)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    spy = _LastOp()
    try:
        with spy, torch.cuda.graph(graph):
            out = step()
    except Exception as e:  # report what broke the capture; nothing falls back
        torch.cuda.synchronize()
        return dict(captured=False, failed_at=spy.last, error=f"{type(e).__name__}: {e}"[:2000],
                    eager_ms=eager_ms)
    graph.replay()
    torch.cuda.synchronize()
    got = flat(out)
    equal = [torch.equal(a, b) for a, b in zip(ref, got)]
    replay_ms = _events_median_ms(graph.replay)
    fast_kernel.launches = launches0  # the tool's own launches
    return dict(captured=True, outputs=len(ref), outputs_equal=sum(equal), all_equal=all(equal),
                eager_ms=eager_ms, replay_ms=replay_ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lags", type=int, nargs="+", default=[0, 3])
    ap.add_argument("--frames", type=int, default=108)
    ap.add_argument("--out", default=os.path.join("build", "debug_pipeline.json"))
    ap.add_argument("--device", default="cuda", help="cpu rehearses the drive at a few frames")
    args = ap.parse_args()
    on_gpu = args.device == "cuda"
    if on_gpu and not torch.cuda.is_available():
        raise SystemExit("debug_pipeline: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    card = "cpu" if not on_gpu else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cam, poses, frames = cs.make_fixture("cuda" if on_gpu else "cpu")
    frames = [f.cpu().numpy() for f in frames[:args.frames]]
    poses = poses[:args.frames]
    vocab = cs.phase_vocabulary() if on_gpu else None
    out = dict(card=card, runs={})
    slam = None
    for lag in args.lags:
        slam, rec = drive(cs, cam, poses, frames, vocab, lag, args.device)
        a, b = rec["window"]
        print(f"lag {lag}: tracked {rec['tracked_ratio']:.4f}, keyframes {rec['keyframes']}, lost {rec['lost']}, "
              f"loops {rec['status']['loops_closed']}, ATE {rec['ate_m']:.4f} m; frames {a}-{b}: "
              f"{rec['fps']:.2f} fps, p50 {rec['p50_ms']:.2f} ms, p99 {rec['p99_ms']:.2f} ms, "
              f"max {rec['max_ms']:.2f} ms, final flush {rec['flush_ms']:.2f} ms", flush=True)
        print(f"lag {lag}: stage means {json.dumps(rec['stage_means'])}", flush=True)
        if on_gpu and args.frames >= PROFILE_FROM + PROFILE_FRAMES:
            rec["profile"] = p = profile(cs, cam, frames, vocab, lag, args.device)
            print(f"lag {lag}: torch.profiler over frames {p['frames'][0]}-{p['frames'][1]}: "
                  f"{p['launches_per_frame']:.1f} device launches a frame, {p['device_ms_per_frame']:.2f} ms "
                  f"device time a frame of {p['wall_ms_per_frame']:.2f} ms wall, idle share "
                  f"{p['idle_share']:.4f}; top device ms a frame {json.dumps(p['top_device_ms_per_frame'])}",
                  flush=True)
        out["runs"][str(lag)] = {k: v for k, v in rec.items() if k != "frame_ms"}
    if on_gpu and slam is not None and slam.cfg.pipeline_lag > 0:
        g = out["graph"] = graph_replay(slam, frames[-1])
        if g["captured"]:
            print(f"CUDA graph of one pipelined step: {g['outputs_equal']} of {g['outputs']} outputs torch.equal "
                  f"to the eager step's; replay {g['replay_ms']:.3f} ms, eager {g['eager_ms']:.3f} ms "
                  f"(CUDA events, median of 20)", flush=True)
        else:
            print(f"CUDA graph capture of one pipelined step failed at {g['failed_at']}: {g['error']}; "
                  f"eager {g['eager_ms']:.3f} ms", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"written {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
