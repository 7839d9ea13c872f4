"""Where the port and the JAX package part on the CPU, frame by frame.

The fixture is the first FRAMES of config_mono_tum, generated by the
port's tools/accuracy_eval.py and read back through the port's PNG reader;
the same arrays go to three Systems built from the same settings file by
each package's settings parser: the JAX System, the port's, and the
port's with the JAX extractor's output put in place of its own extraction
(converted with utils/convert.py). For each it logs, per frame: the
keyframe count, whether the frame tracked, and the inputs of every
keyframe-policy call (inliers, the reference keyframe's tracked points,
frames since the last keyframe, mapper idle) with its answer. Then it
reports the first frame at which the keyframe insertions differ and the
frame before it, the policy's inputs there on each side, the first frame
whose inlier count differs, and the extraction of frame 0 compared
between the packages (keypoints, angles, descriptor rows). Last, the
stages on the same inputs: the JAX System runs again to the first
keyframe difference, and its own inputs are handed to the port: the
extraction of that frame's image, the tracking step there (motion model,
local map, the keyframe policy's inputs), and the last local BA solved
before the first frame whose inlier count differs.

Run as a script (JAX_PLATFORMS=cpu, from the repository root):
    python tests/torch_divergence.py [--frames 120] [--root DIR]
or through tests/test_torch_divergence.py (slow tier)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np

FRAMES = 120


def fixture(root: str, n_frames: int = FRAMES):
    """(settings path, [(timestamp, image)]) of the cut config."""
    from orb_slam_cuda_tpu_torch.io.datasets import TumRgbdDataset
    from orb_slam_cuda_tpu_torch.tools import accuracy_eval

    args = accuracy_eval.make_mono_tum(root, n_frames=n_frames)
    settings = args[args.index("--settings") + 1]
    frames = [(t, d["image"]) for t, d in TumRgbdDataset(root, monocular=True)][:n_frames]
    return settings, frames


def _instrument(slam, log):
    need = slam._need_new_keyframe

    def logged(frame):
        out = need(frame)
        log.append(dict(frame=int(slam.frame_id), inliers=int(slam.n_inliers_local),
                        ref_tracked=int(getattr(slam, "ref_tracked", -1)),
                        since_kf=int(slam.frames_since_kf), keyframes=len(slam.kf_order),
                        idle=not any(u[0] == "map_finish" for u in slam._bg), insert=bool(out)))
        return out

    slam._need_new_keyframe = logged
    return slam


def drive(slam, frames):
    """Per frame (keyframes inserted so far, tracked, pose) and the policy log."""
    log = []
    _instrument(slam, log)
    rows = []
    for t, img in frames:
        pose = slam.track_monocular(img, t)
        rows.append(dict(keyframes=int(slam.stats.n_keyframes), tracked=pose is not None,
                         pose=None if pose is None else np.asarray(pose, np.float64).tolist()))
    return rows, log


class _JaxFeatures:
    """An extractor for the port's System that returns the JAX extractor's
    output for the same image."""

    def __init__(self, jax_extractor):
        self.jax_extractor = jax_extractor

    def __call__(self, image):
        from orb_slam_cuda_tpu_torch.utils import convert

        return convert.features(self.jax_extractor(np.asarray(image)))


def systems(settings):
    from orb_slam_cuda_tpu.engine.system import System as JSystem
    from orb_slam_cuda_tpu.io.config import load_settings as jload
    from orb_slam_cuda_tpu_torch.engine.system import System
    from orb_slam_cuda_tpu_torch.io.config import load_settings as tload

    jslam = JSystem(jload(settings))
    port = System(tload(settings), device="cpu")
    injected = System(tload(settings), device="cpu")
    injected.extractor = _JaxFeatures(jslam.extractor)
    return {"jax": jslam, "port": port, "port with JAX features": injected}


def first_keyframe_difference(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x["keyframes"] != y["keyframes"]), None)


def compare_extraction(jslam, port, image):
    j, t = jslam.extractor(image), port.extractor(image)
    to = lambda x: np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)  # noqa: E731
    valid = to(j.valid)
    dj, dt = to(j.desc).view(np.int32), to(t.desc)
    d = np.abs(to(j.angle) - to(t.angle))[valid]
    return dict(keypoints_equal=bool(np.array_equal(to(j.uv), to(t.uv))),
                valid_equal=bool(np.array_equal(valid, to(t.valid))),
                angle_max_diff_deg=float(np.minimum(d, 360 - d).max()),
                identical_descriptor_rows=float((dj == dt).all(1)[valid].mean()),
                differing_bits=int(np.unpackbits((dj ^ dt)[valid].view(np.uint8)).sum()))


def _max_diff(a, b) -> float:
    a = np.asarray(a.detach().cpu() if hasattr(a, "detach") else a, np.float64)
    b = np.asarray(b.detach().cpu() if hasattr(b, "detach") else b, np.float64)
    return float(np.abs(a - b).max()) if a.size else 0.0


def same_inputs(settings, frames, step_frame: int, ba_before: int) -> dict:
    """Run the JAX System to `step_frame`, keeping its tracking step's
    arguments and result there and the last local BA it solved before
    `ba_before`; run the port's functions on those same inputs."""
    import torch

    from orb_slam_cuda_tpu.engine import tracking as jtr
    from orb_slam_cuda_tpu.engine.system import System as JSystem
    from orb_slam_cuda_tpu.io.config import load_settings as jload
    from orb_slam_cuda_tpu.solvers import bundle_adjust as jba
    from orb_slam_cuda_tpu_torch.engine import tracking as ttr
    from orb_slam_cuda_tpu_torch.engine.system import System
    from orb_slam_cuda_tpu_torch.io.config import load_settings as tload
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as tba
    from orb_slam_cuda_tpu_torch.utils import convert

    jslam = JSystem(jload(settings))
    kept = {}
    step, solve = jtr.full_track_step, jba.bundle_adjust

    def kept_step(*a):
        out = step(*a)
        if jslam.frame_id == step_frame:
            kept["step"] = (a, out)
        return out

    def kept_ba(problem, cam, *a, **kw):
        out = solve(problem, cam, *a, **kw)
        if jslam.frame_id < ba_before:
            kept["ba"] = (problem, cam, a, kw, out, jslam.frame_id)
        return out

    jtr.full_track_step, jba.bundle_adjust = kept_step, kept_ba
    try:
        for t, img in frames[:step_frame + 1]:
            jslam.track_monocular(img, t)
    finally:
        jtr.full_track_step, jba.bundle_adjust = step, solve
    out = dict(extraction=compare_extraction(jslam, System(tload(settings), device="cpu"), frames[step_frame][1]))
    if "step" in kept:
        a, jres = kept["step"]
        state, frame, pose_pred, pose_last, uv, oct_, ang, bip, mp, depth, ref_kf, min_obs, cam, sf = a[:14]
        c = lambda x: convert.tensor(x)  # noqa: E731
        tres = ttr.full_track_step(
            convert.map_state(state), convert.frame_data(frame), c(pose_pred), c(pose_last), c(uv), c(oct_),
            c(ang), c(bip), c(mp), c(depth), int(ref_kf), int(min_obs), convert.camera(cam),
            tuple(float(v) for v in np.asarray(sf)), *(float(np.asarray(v)) for v in a[14:]))
        jv, tv = np.asarray(jres.host_vec), tres.host_vec.numpy()
        jm, tm = np.asarray(jres.mp), tres.mp.numpy()
        out["tracking_step"] = dict(frame=step_frame, scalars_jax=jv[:9].astype(int).tolist(),
                                    scalars_port=tv[:9].astype(int).tolist(),
                                    scalars_equal=bool(np.array_equal(jv[:9], tv[:9])),
                                    pose_max_diff=_max_diff(jv[9:25], tv[9:25]),
                                    bindings_differ_at=np.flatnonzero(jm != tm).tolist())
    if "ba" in kept:
        problem, cam, a, kw, jres, at = kept["ba"]
        tres = tba.bundle_adjust(convert.ba_problem(problem), convert.camera(cam), *a, **kw)
        out["local_ba"] = dict(frame=at, observations=int(np.asarray(problem.obs_valid).sum()),
                               cam_pose_max_diff=_max_diff(jres.cam_pose, tres.cam_pose),
                               xyz_max_diff=_max_diff(jres.xyz, tres.xyz),
                               inlier_flags_differ=int((np.asarray(jres.obs_inlier) != tres.obs_inlier.numpy()).sum()),
                               bit_equal=bool(torch.equal(convert.tensor(jres.xyz), tres.xyz)))
    return out


def search(root: str, n_frames: int = FRAMES) -> dict:
    settings, frames = fixture(root, n_frames)
    runs = systems(settings)
    out = dict(frames=n_frames, extraction_frame0=compare_extraction(runs["jax"], runs["port"], frames[0][1]))
    recs = {}
    for name, slam in runs.items():
        rows, log = drive(slam, frames)
        recs[name] = (rows, log)
        kf_frames = [i for i, r in enumerate(rows) if r["keyframes"] != (rows[i - 1]["keyframes"] if i else 0)]
        out[name] = dict(keyframes=rows[-1]["keyframes"], tracked=sum(r["tracked"] for r in rows),
                         keyframe_frames=kf_frames)
    jrows, jlog = recs["jax"]
    for name in ("port", "port with JAX features"):
        rows, log = recs[name]
        f = first_keyframe_difference(jrows, rows)
        by_frame = lambda lg: {e["frame"]: e for e in lg}  # noqa: E731
        jl, tl = by_frame(jlog), by_frame(log)
        inl = next((k for k in sorted(set(jl) & set(tl)) if jl[k]["inliers"] != tl[k]["inliers"]), None)
        pose_diff = [None if not (a["tracked"] and b["tracked"]) else
                     float(np.abs(np.asarray(a["pose"]) - np.asarray(b["pose"])).max())
                     for a, b in zip(jrows, rows)]
        out[f"jax vs {name}"] = dict(
            first_keyframe_difference=f,
            policy_at={str(k): dict(jax=jl.get(k), other=tl.get(k)) for k in ((f - 1, f) if f else ())},
            first_inlier_difference=inl,
            inliers_there=None if inl is None else (jl[inl]["inliers"], tl[inl]["inliers"]),
            first_pose_difference_above_1e_4=next((i for i, d in enumerate(pose_diff) if d and d > 1e-4), None),
            max_pose_difference=max((d for d in pose_diff if d is not None), default=None))
    d = out["jax vs port"]
    if d["first_keyframe_difference"] is not None:
        out["same_inputs"] = same_inputs(settings, frames, d["first_keyframe_difference"],
                                         d["first_inlier_difference"] or n_frames)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--root", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if args.root:
        print(json.dumps(search(args.root, args.frames), indent=1))
        return 0
    with tempfile.TemporaryDirectory() as root:
        print(json.dumps(search(root, args.frames), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
