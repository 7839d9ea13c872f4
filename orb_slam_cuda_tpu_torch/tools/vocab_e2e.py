"""Loop closing on a vocabulary of the stock ORBvoc.txt's size, end to end
(port of tools/vocab_e2e.py).

The loop fixture of tools/vocab_e2e.py runs through the whole System
twice: once with a 982k-word DBoW2 text vocabulary (vocab/stock_scale.py,
k=10, L=6, seed 3; ~1.1M nodes, 2% early leaves), once with the engine's
synthetic 512-word tree as the control. With the big tree the BoW gating
of the tracking fallback, of the keyframe database's loop detection and
of the Sim3 stage's SearchByBoW runs at the stock vocabulary's
selectivity.

Fixture (the JAX tool's): 320x240, fx=fy=260, an 8-wall room of apothem
9 m (seed 7, 1024-px textures), `--frames` (default 360) frames of a
circuit of radius 5 m over 1.3 laps, 800 features, loop closing on, at
most 128 keyframes and 16384 points, a keyframe at least every 30
frames, System seed 1. The frames come from the port's renderer, on
`--device`.

The vocabulary file is build/orbvoc_k10_L<depth>.txt (the name
chip_smoke.py's vocabulary phase uses), generated once and then reused;
the port's native scanner loads it. `--vocab-depth 4` takes the ~11k-node
file instead (a rehearsal).

Per vocabulary it prints one JSON line: the JAX tool's fields (metric,
n_words, frames, tracked_ratio, keyframes, loops_closed, ate_rmse,
wall_s), then relocalizations, the FAST kernel's launches in the run,
fps, the p50 and p99 of the per-frame host time, the mean ms of the
orb_extract, build_frame, loop_detect and loop_closing stages (on the
card orb_extract is the frame program, extraction and frame build in one
CUDA graph, and build_frame is not timed apart), and the card's name and
power limit. On the card a run whose FAST launches differ from its frames
did not run on the kernel, and the tool exits non-zero.

Usage (from the repository root; needs one GPU unless --device cpu):
    python -m orb_slam_cuda_tpu_torch.tools.vocab_e2e [--frames 360] [--device cuda|cpu] [--vocab-depth 6]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from .accuracy_eval import card_name

W, H = 320, 240
FX = 260.0
N_FRAMES = 360
LAPS = 1.3
VOCAB_K, VOCAB_DEPTH = 10, 6
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def vocab_path(depth: int = VOCAB_DEPTH) -> str:
    """build/orbvoc_k10_L<depth>.txt, generated by vocab/stock_scale.py if
    it is not there yet."""
    from ..vocab import stock_scale

    path = os.path.join(REPO, "build", f"orbvoc_k{VOCAB_K}_L{depth}.txt")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        print(f"generating {path}...", file=sys.stderr, flush=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        stock_scale.generate(tmp, depth=depth, k=VOCAB_K)
        os.replace(tmp, path)
    return path


def fixture(n_frames: int = N_FRAMES, laps: float = LAPS):
    """(camera, room scene, world->camera poses) of the loop fixture."""
    from ..geometry.camera import Camera
    from ..utils import synthetic

    cam = Camera.create(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H)
    scene = synthetic.room_scene(np.random.default_rng(7), half_size=9.0, tex_size=1024, n_walls=8)
    return cam, scene, synthetic.circuit_trajectory(n_frames, radius=5.0, laps=laps)


def system_config(cam):
    from ..engine import Sensor, SystemConfig

    return SystemConfig(camera=cam, sensor=Sensor.MONOCULAR, n_features=800, max_keyframes=128,
                        max_points=16384, enable_loop_closing=True, max_frames_between_kf=30,
                        min_frames_between_kf=0)


def _stage_mean(timer, csv, name):
    ms = timer.summary(csv).get(name)
    return None if ms is None else round(ms, 3)


def run(vocab, tag: str, n_frames: int = N_FRAMES, device="cuda") -> dict:
    """Track the fixture with `vocab` (None: the synthetic 512-word tree)
    and return its JSON record."""
    from ..engine import System
    from ..ops import fast_kernel
    from ..utils.device import resolve
    from ..utils.evaluation import ate_rmse, camera_centers

    dev = resolve(device)
    on_card = dev.type == "cuda"
    cam, scene, poses = fixture(n_frames)
    slam = System(system_config(cam), seed=1, vocab=vocab, device=dev)
    K = np.asarray(cam.K)
    launches0 = fast_kernel.launches
    frame_s, render_s = [], 0.0
    t0 = time.perf_counter()
    for i, T in enumerate(poses):
        r0 = time.perf_counter()
        img = scene.render(K, T, W, H, device=dev)
        r1 = time.perf_counter()
        slam.track_monocular(img, i * 0.1)
        frame_s.append(time.perf_counter() - r1)
        render_s += r1 - r0
    st = slam.get_status()  # flushes the pipeline
    wall = time.perf_counter() - t0
    launches = fast_kernel.launches - launches0
    ts, est = camera_centers(slam.get_trajectory())
    gt_by_t = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    gt = np.asarray([gt_by_t[round(t, 6)] for t in ts])
    ate = float(ate_rmse(est, gt)) if len(est) >= 3 else None
    gt_all = np.asarray([np.linalg.inv(T)[:3, 3] for T in poses])
    extent = float(np.linalg.norm(gt_all.max(0) - gt_all.min(0)))
    frame_ms = np.asarray(frame_s) * 1e3
    return {
        "metric": f"vocab_e2e_{tag}",
        "n_words": slam.vocab.n_words,
        "frames": n_frames,
        "tracked_ratio": st["tracked_ratio"],
        "keyframes": st["keyframes"],
        "loops_closed": st["loops_closed"],
        "ate_rmse": None if ate is None else round(ate, 4),
        "wall_s": round(wall, 1),
        "relocalizations": st["relocalizations"],
        "extent_m": round(extent, 3),
        "ate_pct_extent": None if ate is None else round(100 * ate / extent, 3),
        "fast_launches": launches,
        "fast_launches_equal_frames": launches == n_frames if on_card else None,
        "fps": round(n_frames / wall, 3),
        "frame_ms_p50": round(float(np.percentile(frame_ms, 50)), 2),
        "frame_ms_p99": round(float(np.percentile(frame_ms, 99)), 2),
        "render_s": round(render_s, 2),
        "render_device": f"{dev.type} ({'the card' if on_card else 'the host'})",
        "stage_ms": {
            "orb_extract": _stage_mean(slam.timer, "times.csv", "orb_extract"),
            "build_frame": _stage_mean(slam.timer, "times.csv", "build_frame"),
            "loop_detect": _stage_mean(slam.timer, "timesMapping.csv", "loop_detect"),
            "loop_closing": _stage_mean(slam.timer, "timesMapping.csv", "loop_closing"),
        },
        "device": str(dev),
        "card": card_name() if on_card else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=N_FRAMES, help=f"frames of the circuit (default {N_FRAMES})")
    ap.add_argument("--device", default="cuda", help="device of the renders and the System (default cuda)")
    ap.add_argument("--vocab-depth", type=int, default=VOCAB_DEPTH,
                    help=f"depth L of the k=10 stock-scale tree (default {VOCAB_DEPTH}: 982k words)")
    args = ap.parse_args(argv)
    from ..utils.device import resolve
    from ..vocab import load_orbvoc_text

    resolve(args.device)
    path = vocab_path(args.vocab_depth)
    steps = {}
    t0 = time.perf_counter()
    voc = load_orbvoc_text(path, timings=steps)
    print(f"vocabulary loaded in {time.perf_counter() - t0:.1f}s ({voc.n_words} words; parse "
          f"{steps['parse']:.2f} s, assemble {steps['assemble']:.2f} s)", file=sys.stderr, flush=True)
    tag = "stock_982k" if args.vocab_depth == VOCAB_DEPTH else f"stock_k{VOCAB_K}_L{args.vocab_depth}"
    ok = True
    for vocab, name in ((voc, tag), (None, "synthetic_512")):
        rec = run(vocab, name, args.frames, args.device)
        if vocab is not None:
            rec["vocab_load_s"] = {k: round(v, 3) for k, v in steps.items() if k != "nodes"}
        print(json.dumps(rec), flush=True)
        ok &= rec["fast_launches_equal_frames"] is not False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
