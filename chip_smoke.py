#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (orb_slam_cuda_tpu_torch) once on one GPU.

Phases, each printing its own lines:
  1. device check: a CUDA device is required; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the hand-written kernels from csrc/ with nvcc;
  3. kernel against plain: the FAST kernel at the 8 pyramid shapes of a
     rendered 1241x376 frame and on uniform noise, torch.equal against
     its plain torch version, with CUDA-event times (median of 20);
  4. main path: System.track_monocular over the 108-frame synthetic
     KITTI-resolution orbit (2000 features, no loop closing), gated on
     tracked ratio, keyframes, tracking failures, kernel launches, device
     residency and sim(3)-aligned ATE; prints fps, p50/p99 frame time and
     stage means;
  5. loop path: the 340-frame KITTI-scale circuit (KITTI00-02 camera,
     2000 features, 1.3 laps of radius 22 m in a 12-wall room with 40
     billboards), rendered on the card, with 3 blank frames at frame 100;
     loop closing on. Gated on a closed loop, a relocalization, tracked
     ratio, live keyframe culling, ATE within 1% of the trajectory's
     extent, kernel launches, device residency and a finite last pose;
     prints fps, p50/p99, every mapping, loop-closing, global-BA and
     relocalization call with its frame and time.
The line before the last is the kernel table as JSON (its launch count
covers both paths); the last line is the device JSON. Any failure raises
and exits non-zero without them.

Usage: python3 chip_smoke.py   (from the repository root; needs one GPU)
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

WIDTH, HEIGHT = 1241, 376
N_FRAMES = 108
MEASURE_FROM = 48
TH_HI, TH_LO = 20.0, 7.0
ATE_GATE = 0.24  # 2% of the 12 m near plane
# The JAX reference System inserts 3 keyframes on this fixture and
# configuration (2 at initialization, 1 by the keyframe policy).
MIN_KEYFRAMES = 3
LOOP_FRAMES = 340
BLANK_AT = 100  # 3 blank frames; the map holds 39 keyframes by then
# The JAX reference System on the same 340 frames on the CPU: tracked
# 0.95, 114 keyframes (112 live), 2 loops, 9 relocalizations (4 lost
# frames), ATE 0.4865 m of a 62.22 m extent (0.78%).
LOOP_REFERENCE = dict(tracked=0.95, loops=2, n_reloc=9, ate=0.4865)


def log(*a):
    print(*a, flush=True)


def cuda_median_ms(fn, reps: int = 20, warmup: int = 3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def stage_means(rows, first_frame: int) -> str:
    """Mean ms per stage name over StageTimer rows from `first_frame` on."""
    acc = {}
    for frame, name, _, ns in rows:
        if frame >= first_frame:
            acc.setdefault(name, []).append(ns / 1e6)
    if not acc:
        return "none"
    return ", ".join(f"{k} {sum(v) / len(v):.2f} ms (n={len(v)})" for k, v in acc.items())


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


def phase_build():
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    path, seconds = fast_kernel.build()
    log(f"build: fast_score.cu -> {path} in {seconds:.2f} s")


def kitti_camera():
    from orb_slam_cuda_tpu_torch.geometry.camera import Camera

    return Camera.create(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
                         width=WIDTH, height=HEIGHT)


def make_fixture(device="cpu"):
    import numpy as np

    from orb_slam_cuda_tpu_torch.utils import synthetic

    rng = np.random.default_rng(42)
    cam = kitti_camera()
    scene = synthetic.PlanarScene.default(rng, depth=12.0, second_depth=25.0,
                                          extent=40.0, tex_size=2048)
    poses = synthetic.orbit_trajectory(N_FRAMES, radius=1.5, depth_amp=0.3)
    t0 = time.perf_counter()
    frames = [scene.render(cam.K, T, WIDTH, HEIGHT, device=device) for T in poses]
    log(f"fixture: {N_FRAMES} frames {WIDTH}x{HEIGHT} rendered in {time.perf_counter() - t0:.1f} s")
    return cam, poses, frames


def phase_kernels(frame0):
    """Kernel vs plain at every shape the main path gives it."""
    import torch

    from orb_slam_cuda_tpu_torch.frontend import fast, image_ops
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    dev = torch.device("cuda")
    levels = image_ops.build_pyramid(torch.as_tensor(frame0, device=dev), 8, 1.2)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    noise = torch.rand((HEIGHT, WIDTH), generator=g, device=dev) * 255.0
    max_err = 0.0
    kern_ms = plain_ms = 0.0
    for name, img in [(f"level{i}", lv.contiguous()) for i, lv in enumerate(levels)] + [("noise", noise)]:
        hi, lo = fast_kernel.fast_score_pair(img, TH_HI, TH_LO)
        ref_hi, ref_lo = fast.fast_score(img, TH_HI), fast.fast_score(img, TH_LO)
        torch.cuda.synchronize()
        if not (torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)):
            raise AssertionError(f"FAST kernel differs from plain at {name} {tuple(img.shape)}")
        max_err = max(max_err, float((hi - ref_hi).abs().max()), float((lo - ref_lo).abs().max()))
        k = cuda_median_ms(lambda: fast_kernel.fast_score_pair(img, TH_HI, TH_LO))
        p = cuda_median_ms(lambda: (fast.fast_score(img, TH_HI), fast.fast_score(img, TH_LO)))
        if name != "noise":
            kern_ms += k
            plain_ms += p
        log(f"fast_score_pair {name} {tuple(img.shape)}: equal (tolerance 0, torch.equal), "
            f"kernel {k:.4f} ms, plain {p:.4f} ms")
    log(f"fast_score_pair per frame (8 levels): kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms")
    return max_err, kern_ms, plain_ms


def check_against_cpu(frame0):
    """The CUDA extractor agrees with the port's CPU path on one frame."""
    import torch

    from orb_slam_cuda_tpu_torch.frontend.extractor import ExtractorConfig, ORBExtractor

    cfg = ExtractorConfig(n_features=2000)
    gpu = ORBExtractor(cfg, HEIGHT, WIDTH, device="cuda")(frame0)
    cpu = ORBExtractor(cfg, HEIGHT, WIDTH, device="cpu")(frame0)
    lvl0 = (cpu.octave == 0) & cpu.valid
    same_kp = torch.equal(gpu.uv.cpu()[lvl0], cpu.uv[lvl0]) and torch.equal(gpu.valid.cpu(), cpu.valid)
    rows = (gpu.desc.cpu() == cpu.desc).all(1)[cpu.valid].float().mean().item()
    if not same_kp or rows < 0.95:
        raise AssertionError(f"CUDA extractor vs CPU: level-0 keypoints equal={same_kp}, identical rows {rows:.4f}")
    log(f"extractor cuda vs cpu: level-0 keypoints equal, identical descriptor rows {rows:.4f}")


def phase_main_path(cam, poses, frames, device="cuda"):
    """Track the fixture on `device` and check every gate. On a CPU device
    (the tests' rehearsal) the FAST wrapper takes its plain version, so
    the kernel count must stay 0."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
    from orb_slam_cuda_tpu_torch.ops import fast_kernel
    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    cfg = SystemConfig(
        camera=cam, sensor=Sensor.MONOCULAR, n_features=2000, max_keyframes=128,
        max_points=16384, enable_loop_closing=False, max_frames_between_kf=10,
        min_frames_between_kf=4,
    )
    slam = System(cfg, device=device)
    on_gpu = slam.device.type == "cuda"
    frame_ms = []
    fast_kernel.launches = 0  # count this path's launches only
    t_all = time.perf_counter()
    for i, img in enumerate(frames):
        t0 = time.perf_counter()
        slam.track_monocular(img, i * 0.1)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    total_s = time.perf_counter() - t_all
    launches = fast_kernel.launches

    ts, est = camera_centers(slam.get_trajectory())
    gt_by_t = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    gt = np.asarray([gt_by_t[round(t, 6)] for t in ts])
    ate = ate_rmse(est, gt) if len(est) >= 3 else float("inf")
    window = np.asarray(frame_ms[MEASURE_FROM:])
    fps = len(window) / (window.sum() / 1e3)
    p50, p99 = np.percentile(window, [50, 99])
    st = slam.state
    off_device = [f for f in st._fields if getattr(st, f).device.type != slam.device.type]
    log(f"main path: {N_FRAMES} frames in {total_s:.1f} s; tracked_ratio {slam.tracked_ratio():.4f}, "
        f"keyframes {slam.stats.n_keyframes} (live {len(slam.kf_order)}), "
        f"points {int(st.mp_valid.sum())}, lost {slam.stats.n_lost}, relocalized {slam.stats.n_reloc}, "
        f"ATE {ate:.4f} m, fast launches {launches}")
    log(f"frames {MEASURE_FROM}-{N_FRAMES - 1}: {fps:.2f} fps, p50 {p50:.2f} ms, p99 {p99:.2f} ms, "
        f"max {window.max():.2f} ms")
    for csv in ("times.csv", "timesTracking.csv"):
        log(f"stage means {csv}, frames {MEASURE_FROM}-{N_FRAMES - 1}: "
            + stage_means(slam.timer.rows[csv], MEASURE_FROM))
    # Keyframe work is rare and may fall before the window: time it over
    # the whole run, and list each call with its frame.
    mapping = slam.timer.rows["timesMapping.csv"]
    log(f"stage means timesMapping.csv, frames 0-{N_FRAMES - 1}: " + stage_means(mapping, 0))
    for frame, name, _, ns in mapping:
        log(f"mapping stage {name} at frame {frame}: {ns / 1e6:.2f} ms "
            f"(that frame took {frame_ms[frame]:.2f} ms)")
    pose = slam.last_pose
    want_launches = 8 * N_FRAMES if on_gpu else 0
    checks = {
        "tracked_ratio >= 0.85": slam.tracked_ratio() >= 0.85,
        f"keyframes >= {MIN_KEYFRAMES}": slam.stats.n_keyframes >= MIN_KEYFRAMES,
        "tracking never failed (lost 0, relocalized 0)": slam.stats.n_lost == 0 and slam.stats.n_reloc == 0,
        f"fast launches == {want_launches}": launches == want_launches,
        f"map tensors on {slam.device} (off: {off_device})": not off_device,
        f"ATE <= {ATE_GATE}": ate <= ATE_GATE,
        "last pose finite": pose is not None and bool(np.isfinite(pose).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("main path gates failed: " + "; ".join(failed))
    log("main path: all gates passed")
    return launches


def make_loop_fixture(device):
    """config_mono_kitti's scene and circuit, rendered on `device`, with
    BLANK_AT..BLANK_AT+2 blank."""
    import numpy as np
    import torch

    from orb_slam_cuda_tpu_torch.utils import synthetic

    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    scene = synthetic.room_scene(rng, half_size=36.0, tex_size=3072, n_walls=12)
    scene.planes.extend(synthetic.ring_obstacles(rng, 24, 28.0))
    scene.planes.extend(synthetic.ring_obstacles(rng, 16, 15.0, height=3.0, width=4.0))
    poses = synthetic.circuit_trajectory(LOOP_FRAMES, radius=22.0, laps=1.3)
    t1 = time.perf_counter()
    cam = kitti_camera()
    frames = [scene.render(cam.K, T, WIDTH, HEIGHT, device=device) for T in poses]
    for i in range(BLANK_AT, BLANK_AT + 3):
        frames[i] = torch.zeros_like(frames[i])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    log(f"loop fixture: {len(scene.planes)} planes textured in {t1 - t0:.1f} s; {LOOP_FRAMES} frames "
        f"{WIDTH}x{HEIGHT} rendered on {device} in {time.perf_counter() - t1:.1f} s; "
        f"frames {BLANK_AT}-{BLANK_AT + 2} blank")
    return cam, poses, frames


def phase_loop_path(cam, poses, frames, device="cuda"):
    """Track the circuit with loop closing on and check every gate."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
    from orb_slam_cuda_tpu_torch.ops import fast_kernel
    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    cfg = SystemConfig(
        camera=cam, sensor=Sensor.MONOCULAR, n_features=2000, max_keyframes=256,
        max_points=32768, enable_loop_closing=True, max_frames_between_kf=10,
        min_frames_between_kf=0, async_mapping=True, pipeline_lag=0,
    )
    slam = System(cfg, device=device)
    on_gpu = slam.device.type == "cuda"
    frame_ms = []
    reloc_calls = []
    fast_kernel.launches = 0  # count this path's launches only
    t_all = time.perf_counter()
    for i, img in enumerate(frames):
        before = dict(slam.reloc_stage_stats)
        t0 = time.perf_counter()
        pose = slam.track_monocular(img, i * 0.1)
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        stage = [k for k, v in slam.reloc_stage_stats.items() if v != before.get(k, 0)]
        if stage:
            reloc_calls.append((i, stage[0], pose is not None))
    total_s = time.perf_counter() - t_all
    launches = fast_kernel.launches
    status = slam.get_status()

    ts, est = camera_centers(slam.get_trajectory())
    gt_by_t = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    gt = np.asarray([gt_by_t[round(t, 6)] for t in ts])
    ate = ate_rmse(est, gt) if len(est) >= 3 else float("inf")
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0))) if len(gt) else 0.0
    ms = np.asarray(frame_ms)
    p50, p99 = np.percentile(ms, [50, 99])
    st = slam.state
    off_device = [f for f in st._fields if getattr(st, f).device.type != slam.device.type]
    off_device += [f"db.{f}" for f in slam.db._fields if getattr(slam.db, f).device.type != slam.device.type]
    log(f"loop path: {LOOP_FRAMES} frames in {total_s:.1f} s; {status}; keyframes live "
        f"{len(slam.kf_order)}, lost {slam.stats.n_lost}, loop edges {slam.loop_closer.loop_edges}, "
        f"relocalization stages {slam.reloc_stage_stats}, ATE {ate:.4f} m of extent {extent:.2f} m "
        f"({100 * ate / max(extent, 1e-9):.3f}%), fast launches {launches}")
    log(f"loop path frames 0-{LOOP_FRAMES - 1}: {len(ms) / (ms.sum() / 1e3):.2f} fps, p50 {p50:.2f} ms, "
        f"p99 {p99:.2f} ms, max {ms.max():.2f} ms")
    ref = LOOP_REFERENCE
    log(f"loop path vs JAX reference (CPU, same frames): tracked {slam.tracked_ratio():.4f} vs "
        f"{ref['tracked']}, loops {status['loops_closed']} vs {ref['loops']}, relocalizations "
        f"{slam.stats.n_reloc} vs {ref['n_reloc']}, ATE {ate:.4f} vs {ref['ate']} m")
    for csv in ("times.csv", "timesTracking.csv", "timesMapping.csv"):
        log(f"stage means {csv}, frames 0-{LOOP_FRAMES - 1}: " + stage_means(slam.timer.rows[csv], 0))
    reloc_ms = {}
    for frame, name, _, ns in slam.timer.rows["timesTracking.csv"]:
        if name == "relocalize":
            reloc_ms[frame] = ns / 1e6
    for frame, stage, ok in reloc_calls:
        log(f"relocalize at frame {frame}: {reloc_ms.get(frame, float('nan')):.2f} ms, "
            f"{'accepted by stage ' + stage if stage != 'fail' else 'no candidate accepted'}")
    by_frame = {}
    for frame, name, _, ns in slam.timer.rows["timesMapping.csv"]:
        by_frame.setdefault(frame, []).append(f"{name} {ns / 1e6:.2f} ms")
    for frame in sorted(by_frame):
        log(f"mapping/loop/gba at frame {frame} ({frame_ms[frame]:.2f} ms): " + ", ".join(by_frame[frame]))
    pose = slam.last_pose
    want_launches = 8 * LOOP_FRAMES if on_gpu else 0
    checks = {
        "loops_closed >= 1": status["loops_closed"] >= 1,
        "n_reloc >= 1": slam.stats.n_reloc >= 1,
        "tracked_ratio >= 0.85": slam.tracked_ratio() >= 0.85,
        "keyframe culling live": len(slam.kf_order) < slam.stats.n_keyframes,
        "ATE <= 1% of extent": ate <= 0.01 * extent,
        f"fast launches == {want_launches}": launches == want_launches,
        f"map tensors on {slam.device} (off: {off_device})": not off_device,
        "last pose finite": pose is not None and bool(np.isfinite(pose).all()),
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError("loop path gates failed: " + "; ".join(failed))
    log("loop path: all gates passed")
    return launches


def main() -> int:
    card = phase_device()
    try:
        import orb_slam_cuda_tpu_torch  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the port package is not importable here: {e}")
    import torch

    phase_build()
    cam, poses, frames = make_fixture(device="cuda")
    max_err, kern_ms, plain_ms = phase_kernels(frames[0])
    check_against_cpu(frames[0])
    launches = phase_main_path(cam, poses, frames)
    del frames
    launches += phase_loop_path(*make_loop_fixture("cuda"))
    log(f"card: {card}")
    print(json.dumps({"kernels": [{
        "name": "fast_score_pair",
        "route": "cuda",
        "source": "orb_slam_cuda_tpu_torch/csrc/fast_score.cu",
        "replaces": "orb_slam_cuda_tpu/ops/pallas_fast.py:116",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
