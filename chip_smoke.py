#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (orb_slam_cuda_tpu_torch) once on one GPU.

Phases, each printing its own lines:
  1. device check: a CUDA device is required; prints the card's name and
     power limit as nvidia-smi reports them;
  2. build: compiles the hand-written kernel from csrc/ with nvcc;
  3. kernel against plain: both entry points of the FAST kernel at the 8
     pyramid shapes of a rendered 1241x376 frame and on uniform noise,
     torch.equal against their plain torch versions: fast_corners_pyramid
     (one launch for all levels; the main path's) and fast_score_pair (one
     level's two raw maps). For each, per frame: the device time by CUDA
     events with the launches queued behind a long kernel so that the
     host is out of the way (median of 20; pyramid warm in L2, and after
     a 128 MB write has flushed L2), the time as the caller sees it
     (events around the wrapper), the plain version's time, and the bound
     from the bytes and operations of this run's shapes;
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
Both paths build `System(cfg)` with no device argument: the card is the
default. The line before the last is the kernel table as JSON: the kernel
of the main path with its launches over both paths (one per frame). The
line before that holds the same numbers for fast_score_pair, the entry
point the paths do not call. The last line is the device JSON. Any failure
raises and exits non-zero without them.

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
CELL, BORDER = 32, 19
# Published peaks of one H100 SXM: device memory and float32 outside the
# tensor cores. The bounds below are taken against them.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# Float operations, by the way the kernel computes the function. Every
# pixel takes the quick test on the 4 compass pixels (4 differences, 14
# min/max, a negation, a max and the compare: 21) and the entry point's
# tail: a compare-select per threshold for the raw pair; 8 neighbour maxes,
# 4 threshold selects, 2 suppression compares, the cell select and the
# border select for the fused map. A pixel that passes the quick test also
# takes the full score: 16 differences, 2 x 64 sliding min/max (windows 2,
# 4, 8, 9), 2 x 15 over the 16 starts, a negation and a max (176). How many
# pass depends on the image, and is counted on this run's levels.
OPS_QUICK_TEST = 21
OPS_FULL_SCORE = 176
OPS_TAIL = {"fast_score_pair": 2, "fast_corners_pyramid": 16}
# Bytes a pixel: the image read once, each output written once.
BYTES_PER_PIXEL = {"fast_score_pair": 12, "fast_corners_pyramid": 8}
KERNEL_SOURCE = "orb_slam_cuda_tpu_torch/csrc/fast_corners.cu"
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


def device_median_ms(fn, reps: int = 20, inner: int = 1, before=None):
    """Median device time of one call of `fn` by CUDA events with the host
    out of the way: everything is queued behind three large matrix
    products, so the events see the kernels back to back. Each pair of
    events holds `inner` calls (an empty pair reads about 3 us, which
    `inner` > 1 spreads thin). `before`, if given, runs ahead of each pair,
    outside its events."""
    import torch

    fn()
    blocker = torch.ones((8192, 8192), device="cuda")
    torch.cuda.synchronize()
    pairs = []
    for _ in range(3):
        blocker @ blocker
    for _ in range(reps):
        if before is not None:
            before()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) / inner for a, b in pairs)
    return times[len(times) // 2]


def kernel_bound(name: str, pixels: int, candidates: int):
    """(bound_ms, bound_by) of one frame's work: the larger of bytes over
    the memory rate and operations over the float32 rate, for `pixels`
    pixels of which `candidates` pass the quick test."""
    ops = pixels * (OPS_QUICK_TEST + OPS_TAIL[name]) + candidates * OPS_FULL_SCORE
    by_bytes = pixels * BYTES_PER_PIXEL[name] / PEAK_BYTES_PER_S * 1e3
    by_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


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
    log(f"build: {KERNEL_SOURCE} -> {path} in {seconds:.2f} s")


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
    """Both entry points of the kernel against their plain versions at
    every shape the main path gives the kernel, and their times per frame.
    Returns one kernel-table row (without `launches`) per entry point."""
    import torch

    from orb_slam_cuda_tpu_torch.frontend import fast, image_ops
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    dev = torch.device("cuda")
    levels = [lv.contiguous() for lv in
              image_ops.build_pyramid(torch.as_tensor(frame0, device=dev), 8, 1.2)]
    shapes = [tuple(lv.shape) for lv in levels]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    noise = torch.rand((HEIGHT, WIDTH), generator=g, device=dev) * 255.0

    def pair_kernel():
        return [fast_kernel.fast_score_pair(lv, TH_HI, TH_LO) for lv in levels]

    def pair_plain():
        return [(fast.fast_score(lv, TH_HI), fast.fast_score(lv, TH_LO)) for lv in levels]

    out = fast_kernel.pyramid_buffers(shapes, dev)  # as the extractor owns them

    def pyramid_kernel():
        return fast_kernel.fast_corners_pyramid(levels, TH_HI, TH_LO, CELL, BORDER, out=out)

    def pyramid_plain():
        return [fast.fast_corners_plain(lv, TH_HI, TH_LO, CELL, BORDER) for lv in levels]

    max_err = {"fast_score_pair": 0.0, "fast_corners_pyramid": 0.0}
    for name, img in [(f"level{i}", lv) for i, lv in enumerate(levels)] + [("noise", noise)]:
        hi, lo = fast_kernel.fast_score_pair(img, TH_HI, TH_LO)
        (fused,) = fast_kernel.fast_corners_pyramid([img], TH_HI, TH_LO, CELL, BORDER)
        ref_hi, ref_lo = fast.fast_score(img, TH_HI), fast.fast_score(img, TH_LO)
        ref_fused = fast.fast_corners_plain(img, TH_HI, TH_LO, CELL, BORDER)
        torch.cuda.synchronize()
        if not (torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)):
            raise AssertionError(f"fast_score_pair differs from plain at {name} {tuple(img.shape)}")
        if not torch.equal(fused, ref_fused):
            raise AssertionError(f"fast_corners_pyramid differs from plain at {name} {tuple(img.shape)}")
        max_err["fast_score_pair"] = max(max_err["fast_score_pair"], float((hi - ref_hi).abs().max()),
                                         float((lo - ref_lo).abs().max()))
        max_err["fast_corners_pyramid"] = max(max_err["fast_corners_pyramid"],
                                              float((fused - ref_fused).abs().max()))
        log(f"{name} {tuple(img.shape)}: fast_score_pair and fast_corners_pyramid equal their plain "
            f"versions (tolerance 0, torch.equal); {int((ref_fused > 0).sum())} corners")
    # All 8 levels in one launch, into caller-owned buffers, as the extractor calls it.
    for lv, got, want in zip(levels, pyramid_kernel(), pyramid_plain()):
        if not torch.equal(got, want):
            raise AssertionError(f"fast_corners_pyramid (8 levels, one launch) differs at {tuple(lv.shape)}")
    log("fast_corners_pyramid, 8 levels in one launch: equal (tolerance 0, torch.equal)")

    flush = torch.empty(128 * 1024 * 1024 // 4, device=dev)  # 128 MB > the 50 MB L2
    pixels = sum(h * w for h, w in shapes)
    candidates = sum(int(fast.quick_test_candidates(lv, min(TH_HI, TH_LO)).sum()) for lv in levels)
    log(f"one frame: {pixels} pixels in 8 levels, {candidates} pass the quick test "
        f"({candidates / pixels:.4f}); an empty pair of events reads "
        f"{device_median_ms(lambda: None):.4f} ms")
    rows = []
    # Calls in one pair of events for the warm time: 10 launches, or 4 frames
    # of 8 launches, so that all pairs fit in the launch queue.
    for name, kern, plain, inner in (("fast_corners_pyramid", pyramid_kernel, pyramid_plain, 10),
                                     ("fast_score_pair", pair_kernel, pair_plain, 4)):
        bound_ms, bound_by = kernel_bound(name, pixels, candidates)
        warm = device_median_ms(kern, inner=inner)
        cold = device_median_ms(kern, before=flush.zero_)
        called = cuda_median_ms(kern)
        plain_ms = cuda_median_ms(plain)
        log(f"{name} per frame: device {warm:.4f} ms warm L2 ({inner} calls a pair of events), "
            f"{cold:.4f} ms cold L2 (1 call a pair); as called {called:.4f} ms; plain {plain_ms:.4f} ms; "
            f"bound {bound_ms:.5f} ms by {bound_by}; share of bound reached {bound_ms / warm:.3f} warm, "
            f"{bound_ms / cold:.3f} cold; library call: none (no PyTorch call computes FAST-9)")
        rows.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": "orb_slam_cuda_tpu/ops/pallas_fast.py:116",
            "max_abs_err": max_err[name], "ms": warm, "cold_l2_ms": cold, "as_called_ms": called,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    return rows


def check_against_cpu(frame0):
    """The CUDA extractor agrees with the port's CPU path on one frame."""
    import torch

    from orb_slam_cuda_tpu_torch.frontend.extractor import ExtractorConfig, ORBExtractor

    cfg = ExtractorConfig(n_features=2000)
    gpu = ORBExtractor(cfg, HEIGHT, WIDTH)(frame0)  # no device: the card is the default
    cpu = ORBExtractor(cfg, HEIGHT, WIDTH, device="cpu")(frame0)
    lvl0 = (cpu.octave == 0) & cpu.valid
    same_kp = torch.equal(gpu.uv.cpu()[lvl0], cpu.uv[lvl0]) and torch.equal(gpu.valid.cpu(), cpu.valid)
    rows = (gpu.desc.cpu() == cpu.desc).all(1)[cpu.valid].float().mean().item()
    if not same_kp or rows < 0.95:
        raise AssertionError(f"CUDA extractor vs CPU: level-0 keypoints equal={same_kp}, identical rows {rows:.4f}")
    log(f"extractor cuda vs cpu: level-0 keypoints equal, identical descriptor rows {rows:.4f}")


def count_device_launches(fn) -> int:
    """Kernels, copies and memsets that one call of `fn` puts on the card
    (torch.profiler's device events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    if n == 0:
        raise AssertionError("torch.profiler recorded no device event")
    return n


def phase_extract_launches(frame0):
    """Device launches of one extraction, and of the ops that the one
    kernel launch replaced: per level the raw-pair launch, two NMS, the
    cell choice and the border mask."""
    import torch

    from orb_slam_cuda_tpu_torch.frontend import fast, image_ops
    from orb_slam_cuda_tpu_torch.frontend.extractor import ExtractorConfig, ORBExtractor
    from orb_slam_cuda_tpu_torch.ops import fast_kernel

    extractor = ORBExtractor(ExtractorConfig(n_features=2000), HEIGHT, WIDTH)
    img = torch.as_tensor(frame0, device="cuda")
    levels = [lv.contiguous() for lv in image_ops.build_pyramid(img, 8, 1.2)]

    def unfused():
        for lv in levels:
            hi, lo = fast_kernel.fast_score_pair(lv, TH_HI, TH_LO)
            fast.border_mask(fast.two_threshold_cell_select(fast.nms3x3(hi), fast.nms3x3(lo), CELL), BORDER)

    total = count_device_launches(lambda: extractor(img))
    fused = count_device_launches(lambda: fast_kernel.fast_corners_pyramid(levels, TH_HI, TH_LO, CELL, BORDER))
    replaced = count_device_launches(unfused)
    log(f"device launches per extraction: {total}, of them {fused} for the corner maps of all 8 levels; "
        f"the raw pair per level with plain NMS, cell choice and border mask takes {replaced}")
    log(f"corner maps of a frame as the caller sees them (CUDA events around the calls, median of 20): "
        f"{cuda_median_ms(lambda: fast_kernel.fast_corners_pyramid(levels, TH_HI, TH_LO, CELL, BORDER)):.4f} ms "
        f"in one launch, {cuda_median_ms(unfused):.4f} ms as the raw pair per level with the plain ops; "
        f"one extraction {cuda_median_ms(lambda: extractor(img)):.4f} ms")


def phase_main_path(cam, poses, frames, device=None):
    """Track the fixture and check every gate. With no `device` the System
    is built without one and must land on the card. On a CPU device (the
    tests' rehearsal) the FAST wrapper takes its plain version, so the
    kernel count must stay 0."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
    from orb_slam_cuda_tpu_torch.ops import fast_kernel
    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    cfg = SystemConfig(
        camera=cam, sensor=Sensor.MONOCULAR, n_features=2000, max_keyframes=128,
        max_points=16384, enable_loop_closing=False, max_frames_between_kf=10,
        min_frames_between_kf=4,
    )
    slam = System(cfg) if device is None else System(cfg, device=device)
    on_gpu = slam.device.type == "cuda"
    if device is None and not on_gpu:
        raise AssertionError(f"System(cfg) landed on {slam.device}, not on the card")
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
    want_launches = N_FRAMES if on_gpu else 0  # one launch a frame
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


def phase_loop_path(cam, poses, frames, device=None):
    """Track the circuit with loop closing on and check every gate. With no
    `device` the System is built without one and must land on the card."""
    import numpy as np

    from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
    from orb_slam_cuda_tpu_torch.ops import fast_kernel
    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    cfg = SystemConfig(
        camera=cam, sensor=Sensor.MONOCULAR, n_features=2000, max_keyframes=256,
        max_points=32768, enable_loop_closing=True, max_frames_between_kf=10,
        min_frames_between_kf=0, async_mapping=True, pipeline_lag=0,
    )
    slam = System(cfg) if device is None else System(cfg, device=device)
    on_gpu = slam.device.type == "cuda"
    if device is None and not on_gpu:
        raise AssertionError(f"System(cfg) landed on {slam.device}, not on the card")
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
    want_launches = LOOP_FRAMES if on_gpu else 0  # one launch a frame
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
    pyramid_row, pair_row = phase_kernels(frames[0])
    check_against_cpu(frames[0])
    phase_extract_launches(frames[0])
    launches = phase_main_path(cam, poses, frames)
    del frames
    launches += phase_loop_path(*make_loop_fixture("cuda"))
    log(f"card: {card}")
    # fast_score_pair is built, launched and held against its plain version
    # above, but neither path calls it: its row stands apart from the main
    # path's kernel table.
    print(json.dumps({"entry_points_off_the_main_path": [dict(pair_row, launches=0)]}), flush=True)
    print(json.dumps({"kernels": [dict(pyramid_row, launches=launches)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
