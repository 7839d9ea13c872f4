"""Synchronous (lag 0) against pipelined (lag 3) tracking on bench.py's
orbit, each eager against graphed, on one GPU.

bench.py's configuration (bench.py:49-118): the 108-frame synthetic
KITTI-resolution orbit (1241x376, 2000 features, loop closing on,
`max_frames_between_kf=10`, `min_frames_between_kf=4`) on the stock-scale
vocabulary (k=10, L=6, generated once into build/ by chip_smoke.py's
phase), the frames handed over as host arrays. Each lag runs twice: under
`programs.eager()` (every per-frame stage launched op by op) and graphed
(the System's per-frame programs replayed as CUDA graphs, as the card runs
them by default). For each run it prints:

- tracked ratio, keyframes, loops and sim(3) ATE;
- fps, p50 and p99 of the per-call host time over frames 48-107 (bench.py's
  window; fps counts the final flush of the frames still in flight);
- the programs' captures, replays and capture seconds, the graph pool and
  the peak memory reserved;
- from torch.profiler over 10 frames of that window (a second run of the
  same frames, so that the profiler does not touch the timed one): host
  API launches a frame (kernel, graph, copy and memset launches the host
  issued), device kernels a frame (the card's kernels, copies and
  memsets), device busy time a frame, and the idle share of the card over
  those frames' wall time.

Then, on the graphed lag-3 System's final state, it calls the System's own
pipelined program (`System._pipe_fn`) on the same inputs under
`programs.eager()` and as a replay of the graph the run captured: the
outputs must be torch.equal, and the replay time is printed beside the
eager time (CUDA events around the call, median of 20). A failed capture
raises, naming the op it failed at.

Then the stereo and RGB-D frame programs: chip_smoke.py's phase 5c cuts
(the first 30 stereo pairs of its circuit, the first 30 RGB-D frames),
each eager and graphed with the same gates, the last 3 frames of each run
under torch.profiler (host API launches and device kernels a frame).

Last, the keyframe frames: a frame that ran keyframe work (keyframe
insertion, the mapper's units, loop detection: a timesMapping.csv row at
that frame). A first graphed run of each cut, without the profiler,
finds the keyframe frames at which no program captured: there every
keyframe program replays a graph that an earlier keyframe captured.
Then the cut runs again, eager and graphed (new Systems, whose keyframes
fall on the same frames and whose graphs are captured at the same
frames), with those frames and the last KF_OTHER frames without
keyframe work each under a torch.profiler of its own. For both kinds
apart it prints the host API launches, device kernels, device ms and
wall ms a frame, the card's idle share and the top kernels' and the
segment-sum kernels' device ms a frame, beside the `local_mapping`
and `local_ba2` means; the graphed run must capture at none of the
profiled frames.

Everything is also written as JSON to `--out`.

Usage (from the repository root; needs one GPU unless --device cpu, which
rehearses the drive at a few frames without the profile and the graph):
    python3 -m orb_slam_cuda_tpu_torch.tools.debug_pipeline [--lags 0 3] [--frames 108]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

WINDOW_FROM = 48
PROFILE_FROM, PROFILE_FRAMES = 60, 10
DEPTH_PROFILED = 3  # the stereo and RGB-D runs' frames under torch.profiler
KF_OTHER = 3  # frames without keyframe work profiled beside the keyframe frames
MODES = ("eager", "graphed")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_system(cs, cam, vocab, lag, device):
    from orb_slam_cuda_tpu_torch.engine import System

    return System(cs.orbit_config(cam, lag=lag), vocab=vocab, device=device)


def mode_context(mode):
    from orb_slam_cuda_tpu_torch.engine import programs

    return programs.eager() if mode == "eager" else contextlib.nullcontext()


def drive(cs, cam, poses, frames, vocab, lag, device):
    """One timed run over every frame. Returns (System, record)."""
    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    slam = make_system(cs, cam, vocab, lag, device)
    cs.reset_peak(device)
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
               programs=slam.program_stats(),
               peak_reserved_mb=torch.cuda.max_memory_reserved() / 1e6 if torch.device(device).type == "cuda" else 0.0,
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
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("torch.profiler recorded no device event")
    host_launches = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in cs.LAUNCH_APIS)
    busy = _busy_us(dev)
    kernels = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return dict(frames=[PROFILE_FROM, PROFILE_FROM + PROFILE_FRAMES - 1],
                host_launches_per_frame=host_launches / PROFILE_FRAMES,
                device_kernels_per_frame=len(dev) / PROFILE_FRAMES, device_ms_per_frame=busy / 1e3 / PROFILE_FRAMES,
                wall_ms_per_frame=wall_us / 1e3 / PROFILE_FRAMES, idle_share=1.0 - busy / wall_us,
                top_device_ms_per_frame={k: v / 1e3 / PROFILE_FRAMES for k, v in top})


def _frame_profile(track, slam, frame, t, launch_apis, by_kernel):
    """One frame under a torch.profiler of its own: (host API launches,
    device events, device busy us, wall us); each device event's us are
    added to `by_kernel` under its name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        track(slam, frame, t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    host = sum(1 for e in events if e.device_type == DeviceType.CPU and e.name in launch_apis)
    for e in dev:
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return host, len(dev), _busy_us(dev), wall_us


def keyframe_frames(cs, rgbd):
    """The phase-5c stereo and RGB-D cuts: keyframe frames whose programs
    all replay, and KF_OTHER frames without keyframe work, each profiled
    alone, eager and graphed (see the module docstring)."""
    from orb_slam_cuda_tpu_torch.engine import Sensor, programs

    s_cam, _, pairs = cs.make_stereo_fixture("cuda", cs.PROGRAM_FRAMES)
    r_cam, _, r_frames = rgbd
    cuts = (("stereo", lambda: cs.build_system(cs.circuit_config(s_cam, Sensor.STEREO), None),
             lambda s, pair, t: s.track_stereo(pair[0], pair[1], t), pairs, 0.1),
            ("rgbd", lambda: cs.build_system(cs.rgbd_config(r_cam), None), cs._track_rgbd,
             r_frames[:cs.PROGRAM_FRAMES], cs.RGBD_DT))
    out = {}
    for name, make, track, frames, dt in cuts:
        slam, captured_at = make(), set()
        for i, frame in enumerate(frames):
            before = programs.captures
            track(slam, frame, i * dt)
            if programs.captures != before:
                captured_at.add(i)
        mapped = {r[0] for r in slam.timer.rows["timesMapping.csv"]}
        kinds = (("keyframe frames, replayed", sorted(mapped - captured_at)),
                 ("other frames", sorted(set(range(len(frames))) - mapped - captured_at)[-KF_OTHER:]))
        print(f"keyframe frames, {name}: keyframe work at frames {sorted(mapped)}, captures at "
              f"{sorted(captured_at)}; profiled {dict(kinds)}", flush=True)
        profiled = {i for _, sel in kinds for i in sel}
        for mode in MODES:
            slam, rows, by_frame, captures = make(), {}, {}, 0
            with mode_context(mode):
                for i, frame in enumerate(frames):
                    if i not in profiled:
                        track(slam, frame, i * dt)
                        continue
                    before = programs.captures
                    by_frame[i] = {}
                    rows[i] = _frame_profile(track, slam, frame, i * dt, cs.LAUNCH_APIS, by_frame[i])
                    captures += programs.captures - before
            if captures:
                raise AssertionError(f"{name}, {mode}: {captures} captures at the profiled frames")
            rec = {}
            for kind, sel in kinds:
                if not sel:
                    print(f"keyframe frames, {name}, {mode}, {kind}: none", flush=True)
                    continue
                a = np.asarray([rows[i] for i in sel], np.float64)
                host, kernels, busy, wall = a.mean(0)
                top = {}
                for i in sel:
                    for k, us in by_frame[i].items():
                        top[k] = top.get(k, 0.0) + us / 1e3 / len(sel)
                segsums = {k: v for k, v in top.items() if "segsum" in k}
                top = dict(sorted(top.items(), key=lambda kv: -kv[1])[:10])
                rec[kind] = dict(frames=sel, host_launches_per_frame=host, device_kernels_per_frame=kernels,
                                 device_ms_per_frame=busy / 1e3, wall_ms_per_frame=wall / 1e3,
                                 idle_share=1.0 - a[:, 2].sum() / a[:, 3].sum(), top_device_ms_per_frame=top,
                                 segsum_device_ms_per_frame=segsums)
                print(f"keyframe frames, {name}, {mode}, {kind} (frames {sel}, each profiled alone): {host:.1f} "
                      f"host API launches, {kernels:.1f} device kernels, {busy / 1e3:.2f} device ms, "
                      f"{wall / 1e3:.2f} wall ms a frame; idle share {rec[kind]['idle_share']:.4f}; segment-sum "
                      f"kernels' device ms a frame {json.dumps(segsums)}; top device ms a frame {json.dumps(top)}",
                      flush=True)
            means = {k: v for k, v in slam.timer.summary("timesMapping.csv").items()
                     if k in ("local_mapping", "local_ba2", "loop_detect", "local_mapping_finish")}
            print(f"keyframe frames, {name}, {mode}: timesMapping means {json.dumps(means)}", flush=True)
            rec["mapping_means"] = means
            out[f"{name}, {mode}"] = rec
    return out


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
    """The System's own pipelined program on its final state: under
    programs.eager() and as a replay, the outputs held torch.equal, both
    timed. Leaves the System's state and the kernel's launch count as they
    were."""
    from orb_slam_cuda_tpu_torch.engine import programs
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    if slam._carry is None:
        slam._carry = slam._make_carry()
    img = slam.extractor.upload(image)
    values = slam._step_values(3 if len(slam.kf_order) > 2 else 2)

    def step():
        return slam._pipe_fn(slam.state, img, slam._carry, *values)

    def flat(out):
        frame, res, nxt = out
        return [*frame, *res, *nxt]

    launches0, stats0 = fast_kernel.launches, slam._pipe_fn.stats()
    with programs.eager():
        ref = flat(step())
        torch.cuda.synchronize()
        eager_ms = _events_median_ms(step)
    got = flat(step())  # a replay if the run captured this key, else a capture
    torch.cuda.synchronize()
    equal = [torch.equal(a, b) for a, b in zip(ref, got)]
    replay_ms = _events_median_ms(step)
    fast_kernel.launches = launches0  # the tool's own launches
    stats = slam._pipe_fn.stats()
    return dict(outputs=len(ref), outputs_equal=sum(equal), all_equal=all(equal), eager_ms=eager_ms,
                replay_ms=replay_ms, captured_here=stats["captures"] - stats0["captures"])


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
        for mode in MODES:
            name = f"lag {lag}, {mode}"
            with mode_context(mode):
                slam, rec = drive(cs, cam, poses, frames, vocab, lag, args.device)
            a, b = rec["window"]
            progs = {k: v for k, v in rec["programs"].items() if k != "pool_bytes"}
            print(f"{name}: tracked {rec['tracked_ratio']:.4f}, keyframes {rec['keyframes']}, lost {rec['lost']}, "
                  f"loops {rec['status']['loops_closed']}, ATE {rec['ate_m']:.4f} m; frames {a}-{b}: "
                  f"{rec['fps']:.2f} fps, p50 {rec['p50_ms']:.2f} ms, p99 {rec['p99_ms']:.2f} ms, "
                  f"max {rec['max_ms']:.2f} ms, final flush {rec['flush_ms']:.2f} ms", flush=True)
            print(f"{name}: programs (captures + replays) "
                  + ", ".join(f"{k} {v['captures']} + {v['replays']}" for k, v in progs.items())
                  + f"; capture {sum(v['capture_s'] for v in progs.values()):.2f} s; graph pool "
                  f"{rec['programs']['pool_bytes'] / 1e6:.1f} MB, peak reserved {rec['peak_reserved_mb']:.1f} MB",
                  flush=True)
            print(f"{name}: stage means {json.dumps(rec['stage_means'])}", flush=True)
            if on_gpu and args.frames >= PROFILE_FROM + PROFILE_FRAMES:
                with mode_context(mode):
                    rec["profile"] = p = profile(cs, cam, frames, vocab, lag, args.device)
                print(f"{name}: torch.profiler over frames {p['frames'][0]}-{p['frames'][1]}: "
                      f"{p['host_launches_per_frame']:.1f} host API launches a frame, "
                      f"{p['device_kernels_per_frame']:.1f} device kernels a frame, {p['device_ms_per_frame']:.2f} ms "
                      f"device time a frame of {p['wall_ms_per_frame']:.2f} ms wall, idle share "
                      f"{p['idle_share']:.4f}; top device ms a frame {json.dumps(p['top_device_ms_per_frame'])}",
                      flush=True)
            out["runs"][name] = {k: v for k, v in rec.items() if k != "frame_ms"}
    if on_gpu and slam is not None and slam.cfg.pipeline_lag > 0:
        g = out["graph"] = graph_replay(slam, frames[-1])
        print(f"the System's pipelined program: {g['outputs_equal']} of {g['outputs']} outputs of a replay "
              f"torch.equal to the eager step's; replay {g['replay_ms']:.3f} ms, eager {g['eager_ms']:.3f} ms "
              f"(CUDA events, median of 20); captured here {g['captured_here']}", flush=True)
    if on_gpu:
        rgbd = cs.make_rgbd_fixture("cuda", n_frames=cs.PROGRAM_FRAMES)
        out["depth_programs"] = cs.depth_programs_against_eager(rgbd, profiled=DEPTH_PROFILED)
        out["keyframe_frames"] = keyframe_frames(cs, rgbd)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"written {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
