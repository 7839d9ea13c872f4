"""Each package's System on each package's renders of the JAX multihost
tool's CPU configuration, one process, no mesh (ROADMAP queue 3, F).

The configuration is tools/multihost_system.py's: 320x240, 800 features,
an 8-wall room (seed 7), 300 frames of 1.3 laps of radius 5 m, loop
closing on, cluster refinement every 24 keyframes. The frames come from
either renderer: the JAX package's (`cv2.warpPerspective`) or the port's
(its own torch warp, within a few gray levels of it). On the same image
the two extractors nearly always agree bit for bit, so this separates
what the images do from what the engines do. Per frame it prints the tracking state, the
keyframes inserted, the live map points, the local-map inliers and the
cluster refinements run; then one RESULT line (first pose, tracked ratio,
loops, keyframes, first and last lost frame and their count). With
`images` it compares the two renderers instead: the largest gray-level
difference of every 10th frame, and on how many of those frames of each
renderer the two extractors agree bit for bit (and how the others differ).

Run as a script (JAX_PLATFORMS=cpu, from the repository root), a few
minutes each:
    python tests/torch_multihost_divergence.py {jax,port} {cv2,torch}
    python tests/torch_multihost_divergence.py images
"""

from __future__ import annotations

import os
import sys

import numpy as np

W, H, FRAMES = 320, 240, 300
CONFIG = dict(n_features=800, max_keyframes=128, max_points=16384, enable_loop_closing=True,
              max_frames_between_kf=30, min_frames_between_kf=0, cluster_refine_interval=24)


def frames(renderer: str):
    """The tool's 300 frames as uint8 numpy arrays from one renderer."""
    if renderer == "cv2":
        from orb_slam_cuda_tpu.utils import synthetic
    else:
        from orb_slam_cuda_tpu_torch.utils import synthetic
    K = np.array([[260.0, 0, W / 2], [0, 260.0, H / 2], [0, 0, 1]])
    scene = synthetic.room_scene(np.random.default_rng(7), half_size=9.0, tex_size=768, n_walls=8)
    poses = synthetic.circuit_trajectory(FRAMES, radius=5.0, laps=1.3)
    if renderer == "cv2":
        return [np.asarray(scene.render(K, T, W, H)) for T in poses]
    return [scene.render(K, T, W, H, device="cpu").numpy() for T in poses]


def system(engine: str):
    """(System, feed): the System and what turns a numpy frame into its input."""
    if engine == "jax":
        from orb_slam_cuda_tpu.engine import Sensor, System, SystemConfig
        from orb_slam_cuda_tpu.geometry.camera import Camera

        cam = Camera.create(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
        return System(SystemConfig(camera=cam, sensor=Sensor.MONOCULAR, **CONFIG), seed=1), lambda f: f
    import torch

    from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
    from orb_slam_cuda_tpu_torch.geometry.camera import Camera

    cam = Camera.create(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
    slam = System(SystemConfig(camera=cam, sensor=Sensor.MONOCULAR, **CONFIG), seed=1, device="cpu")
    return slam, torch.as_tensor


def run(engine: str, renderer: str) -> dict:
    slam, feed = system(engine)
    first, lost = None, []
    for i, f in enumerate(frames(renderer)):
        pose = slam.track_monocular(feed(f), i * 0.1)
        first = i if first is None and pose is not None else first
        if first is not None and pose is None:
            lost.append(i)
        print(i, slam.tracking_state.name, slam.stats.n_keyframes, int(np.asarray(slam.state.mp_valid).sum()),
              slam.n_inliers_local, slam.stats.n_cluster_refines, flush=True)
    slam._flush_pipeline()
    st = slam.get_status()
    return dict(engine=engine, renderer=renderer, first_pose=first, tracked=st["tracked_ratio"],
                loops=st["loops_closed"], keyframes=st["keyframes"],
                lost=[lost[0], lost[-1], len(lost)] if lost else None)


def images() -> dict:
    from torch_divergence import compare_extraction

    a, b = frames("cv2")[::10], frames("torch")[::10]
    diff = [int(np.abs(x.astype(np.int16) - y.astype(np.int16)).max()) for x, y in zip(a, b)]
    jslam, tslam = system("jax")[0], system("port")[0]
    names = [f"{r} {10 * i}" for r in ("cv2", "torch") for i in range(len(a))]
    cmp = dict(zip(names, (compare_extraction(jslam, tslam, f) for f in a + b)))
    apart = {k: v for k, v in cmp.items() if not (v["keypoints_equal"] and v["identical_descriptor_rows"] == 1.0)}
    return dict(max_gray_diff_every_10th_frame=diff, extractors_agree_on=f"{len(cmp) - len(apart)} of {len(cmp)}",
                apart=apart)


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if sys.argv[1] == "images":
        print("RESULT", images(), flush=True)
        return 0
    engine, renderer = sys.argv[1:3]
    print("RESULT", run(engine, renderer), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
