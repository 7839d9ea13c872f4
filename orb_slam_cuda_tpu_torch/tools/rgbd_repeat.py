"""Track chip_smoke.py's RGB-D frames several times on one GPU and say
where the runs part.

The same frames go through a new `System` each time: `--runs` times as the
port runs by default, then `--runs` times under
`torch.use_deterministic_algorithms(True, warn_only=True)`. Per run it
prints the outcome (tracked, keyframes, loops, ATE without scale alignment
as a share of the extent), the frames at which a keyframe was inserted,
the mapping stages' mean times and the camera centre's error every 20th
frame. Per pair of runs of one mode it
prints the first frame whose pose differs in any bit and the first frame at
which the keyframe counts differ. Under the deterministic mode it lists the
ops that PyTorch warns have no deterministic version. Then the first run's
map is saved, loaded into a new System in localization-only mode, and the
first frames are tracked again with every relocalization candidate's
outcome printed: its keyframe slot, the frame that keyframe came from, its
BoW score and match count, the EPnP inliers, the inliers after each rung of
the pose ladder and the rung that refused it.

With `--trace`, the default-mode runs record a digest of the outputs of
every call of the map, mapping, loop-closing and solver functions listed
in TRACED, in call order, and the tool prints the first call whose outputs
differ between two runs: its function and frame. (The digests copy the
outputs to the host, which adds to the stage times, and which a CUDA-graph
capture refuses: the traced runs go under `programs.eager()`, every
per-frame stage op by op.)

Everything is also written as JSON to `--out`.

Usage (from the repository root; needs one GPU unless --device cpu):
    python3 -m orb_slam_cuda_tpu_torch.tools.rgbd_repeat [--frames 240] [--runs 2] [--trace]
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # what deterministic cuBLAS asks for

import numpy as np  # noqa: E402
import torch  # noqa: E402


# module -> functions whose outputs `--trace` digests.
TRACED = {
    "orb_slam_cuda_tpu_torch.engine.local_mapping": [
        "triangulate_and_insert_all", "fuse_all", "apply_fusion", "gather_local_ba_problem",
        "scatter_ba_result", "create_depth_points", "redundancy_all"],
    "orb_slam_cuda_tpu_torch.slam_map.ops": [
        "update_point_stats", "refresh_covis_rows", "cull_points", "covisibility_matrix"],
    "orb_slam_cuda_tpu_torch.slam_map.state": [
        "insert_keyframe", "add_points", "bind_observations", "erase_points"],
    "orb_slam_cuda_tpu_torch.slam_map.keyframe_db": ["compute_bow_row", "insert", "erase"],
    "orb_slam_cuda_tpu_torch.solvers.bundle_adjust": ["bundle_adjust"],
    "orb_slam_cuda_tpu_torch.solvers.pose_graph": ["optimize_pose_graph"],
    "orb_slam_cuda_tpu_torch.engine.tracking": ["full_track_step", "full_track_step_sync_free"],
    "orb_slam_cuda_tpu_torch.engine.relocalization": ["relocalize"],
    "orb_slam_cuda_tpu_torch.engine.frame": ["build_frame"],
}


class Tracer:
    """Wraps the TRACED functions in their modules; `log` gets (function,
    frame, digest of the tensors in the outputs) per call."""

    def __init__(self):
        self.log, self.frame, self._saved = [], -1, []

    @staticmethod
    def _digest(out) -> str:
        h = hashlib.sha1()

        def walk(x):
            if torch.is_tensor(x):
                h.update(x.detach().cpu().contiguous().numpy().tobytes())
            elif isinstance(x, (tuple, list)):
                for y in x:
                    walk(y)

        walk(out)
        return h.hexdigest()

    def __enter__(self):
        for mod_name, names in TRACED.items():
            mod = importlib.import_module(mod_name)
            for name in names:
                fn = getattr(mod, name)
                self._saved.append((mod, name, fn))

                def traced(*a, _fn=fn, _name=f"{mod_name.rsplit('.', 1)[-1]}.{name}", **kw):
                    out = _fn(*a, **kw)
                    self.log.append((_name, self.frame, self._digest(out)))
                    return out

                setattr(mod, name, traced)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()


def first_traced_difference(a, b):
    """The first call whose outputs differ: (call index, function, frame)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x[0], x[1], y[0]
    return None


def run_once(cs, cfg, frames, gt_poses, device, tracer=None):
    """One new System over `frames`. Returns (slam, record)."""
    from orb_slam_cuda_tpu_torch.engine import System
    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    slam = System(cfg, device=device)
    poses, kfs, lost = [], [], []
    for i, (img, depth) in enumerate(frames):
        if tracer is not None:
            tracer.frame = i
        pose = slam.track_rgbd(img, depth, i * cs.RGBD_DT)
        poses.append(None if pose is None else np.asarray(pose, np.float64))
        kfs.append(slam.stats.n_keyframes)
        if pose is None:
            lost.append(i)
    # Ground truth in the first camera's frame, where the estimate lives.
    T0_inv = np.linalg.inv(gt_poses[0])
    err = [None if p is None else
           float(np.linalg.norm(np.linalg.inv(p)[:3, 3] - np.linalg.inv(T @ T0_inv)[:3, 3]))
           for p, T in zip(poses, gt_poses)]
    ts, est = camera_centers(slam.get_trajectory())
    gt_by_t = {round(i * cs.RGBD_DT, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(gt_poses)}
    gt = np.asarray([gt_by_t[round(t, 6)] for t in ts])
    extent = float(np.linalg.norm(gt.max(0) - gt.min(0)))
    ate = float(ate_rmse(est, gt, with_scale=False))
    kf_frames = [i for i in range(len(kfs)) if kfs[i] != (kfs[i - 1] if i else 0)]
    rec = dict(status=slam.get_status(), live_keyframes=len(slam.kf_order), ate_m=ate, extent_m=extent,
               ate_share=ate / extent, lost_frames=lost, keyframe_frames=kf_frames, center_error_m=err,
               reloc_stages=dict(slam.reloc_stage_stats),
               mapping_ms=slam.timer.summary("timesMapping.csv"),
               poses=[None if p is None else p.tolist() for p in poses])
    return slam, rec


def first_difference(a, b):
    """First frame whose poses differ in any bit, and first frame at which
    the keyframe insertions differ."""
    pose_at = next((i for i, (p, q) in enumerate(zip(a["poses"], b["poses"])) if p != q), None)
    ka, kb = set(a["keyframe_frames"]), set(b["keyframe_frames"])
    kf_at = min(ka ^ kb, default=None)
    return pose_at, kf_at


def probe(cs, cfg, slam, frames, n_frames, device):
    """Save `slam`'s map, load it into a new System, track the first
    `n_frames` again and return every relocalization candidate's row."""
    from orb_slam_cuda_tpu_torch.engine import System

    kf_frame = {slot: int(round(t / cs.RGBD_DT)) for slot, t in slam.kf_timestamps.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        slam.save_map(path)
        loc = System(cfg, device=device)
        loc.load_map(path)
    loc.reloc_trace = []
    rows = []
    for i, (img, depth) in enumerate(frames[:n_frames]):
        before = len(loc.reloc_trace)
        pose = loc.track_rgbd(img, depth, i * cs.RGBD_DT)
        for row in loc.reloc_trace[before:]:
            rows.append(dict(row, frame=i, keyframe_from_frame=kf_frame.get(row["kf"]), tracked=pose is not None))
    return rows, loc.get_status()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--probe-frames", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("build", "rgbd_repeat.json"))
    ap.add_argument("--device", default="cuda", help="cpu rehearses the script at a few frames")
    ap.add_argument("--trace", action="store_true",
                    help="digest the traced functions' outputs in the default runs; print the first that differs")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("rgbd_repeat: no CUDA device")
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    from orb_slam_cuda_tpu_torch.engine import Sensor, programs

    card = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cam, gt_poses, frames = cs.make_rgbd_fixture(args.device, n_frames=args.frames)
    cfg = cs.circuit_config(cam, Sensor.RGBD, n_features=1000, max_frames_between_kf=30,
                            depth_map_factor=1.0 / cs.DEPTH_FACTOR)
    out = dict(card=card, frames=args.frames, runs={}, pairs={})
    first_slam = None
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            recs, traces = [], []
            for r in range(args.runs):
                if args.trace and mode == "default":
                    # The digests read outputs back, which a CUDA-graph
                    # capture refuses: the traced runs go op by op.
                    with Tracer() as tracer, programs.eager():
                        slam, rec = run_once(cs, cfg, frames, gt_poses, args.device, tracer)
                    traces.append(tracer.log)
                else:
                    slam, rec = run_once(cs, cfg, frames, gt_poses, args.device)
                if first_slam is None:
                    first_slam = slam
                recs.append(rec)
                err = rec["center_error_m"]
                worst = max((e, i) for i, e in enumerate(err) if e is not None)
                print(f"{mode} run {r}: {rec['status']}, live {rec['live_keyframes']}, ATE without scale "
                      f"{rec['ate_m']:.4f} m = {100 * rec['ate_share']:.3f}% of {rec['extent_m']:.2f} m, lost "
                      f"{rec['lost_frames']}, relocalization stages {rec['reloc_stages']}, worst centre error "
                      f"{worst[0]:.4f} m at frame {worst[1]}", flush=True)
                print(f"{mode} run {r}: keyframes at frames {rec['keyframe_frames']}", flush=True)
                print(f"{mode} run {r}: mapping stage means (ms) "
                      + ", ".join(f"{k} {v:.2f}" for k, v in rec["mapping_ms"].items()), flush=True)
                print(f"{mode} run {r}: centre error (m) every 20th frame: "
                      + ", ".join(f"{i}: {'lost' if err[i] is None else format(err[i], '.4f')}"
                                  for i in range(0, len(err), 20)), flush=True)
        nondet = sorted({str(w.message).split(". You can")[0] for w in caught
                         if "deterministic" in str(w.message)})
        for a in range(len(recs)):
            for b in range(a + 1, len(recs)):
                pose_at, kf_at = first_difference(recs[a], recs[b])
                out["pairs"][f"{mode} {a} vs {b}"] = dict(first_pose_difference=pose_at,
                                                          first_keyframe_difference=kf_at)
                print(f"{mode} runs {a} and {b}: poses first differ at frame {pose_at}, keyframe insertions "
                      f"first differ at frame {kf_at}", flush=True)
                if traces:
                    d = first_traced_difference(traces[a], traces[b])
                    out["pairs"][f"{mode} {a} vs {b}"]["first_traced_difference"] = d
                    print(f"{mode} runs {a} and {b}: of {len(traces[a])} traced calls the first whose outputs "
                          f"differ: {d}", flush=True)
        if mode == "deterministic":
            out["ops_without_a_deterministic_version"] = nondet
            for msg in nondet:
                print(f"deterministic mode warned: {msg}", flush=True)
        for r, rec in enumerate(recs):
            out["runs"][f"{mode} {r}"] = {k: v for k, v in rec.items() if k != "poses"}
    torch.use_deterministic_algorithms(False)
    rows, status = probe(cs, cfg, first_slam, frames, args.probe_frames, args.device)
    out["probe"] = dict(status=status, candidates=rows)
    print(f"probe on the first default run's map: {status}", flush=True)
    for row in rows:
        print(f"probe candidate: {row}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"written {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
