"""The port's per-frame programs (engine/programs.py) on the CPU, where a
Program calls its function directly and nothing is captured.

The capture key: equal for calls with equal shapes, whatever the values
of `min_obs`, `th_depth` and `vo_th_depth` (0-d tensor inputs, as JAX
traces them); new after `mstate.grow_points` or `grow_keyframes`. A CPU
Program calls through and counts no capture or replay; `eager()` nests and
restores. On a map that the port's System built from the 320x240 orbit,
its tracking program (the sync-free step with tensor scalars, what the
card replays) equals the host-branch `full_track_step` that the CPU path
runs, bit for bit, and it honours a changed `min_obs` (the reference
keyframe's tracked points with two observations, then with three). Imports no JAX."""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu_torch.engine import System, SystemConfig, programs, tracking
from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.slam_map import state as mstate
from orb_slam_cuda_tpu_torch.utils import synthetic

torch.set_num_threads(2)
W, H = 320, 240
CAM = dict(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
CFG = dict(n_features=600, max_keyframes=64, max_points=8192, enable_loop_closing=False,
           max_frames_between_kf=10)


@pytest.fixture(scope="module")
def tracked():
    """A CPU System tracking the orbit with at least two keyframes, and
    the next frame built by its frame program."""
    scene = synthetic.PlanarScene.default(np.random.default_rng(42), depth=5.0, second_depth=8.0,
                                          extent=12.0, tex_size=768)
    poses = synthetic.orbit_trajectory(20, radius=0.6)
    K = Camera.create(**CAM).K
    slam = System(SystemConfig(camera=Camera.create(**CAM), **CFG), device="cpu")
    i = 0
    while i < len(poses) and not (slam.tracking_state.name == "OK" and len(slam.kf_order) >= 2):
        slam.track_monocular(scene.render(K, poses[i], W, H), i * 0.1)
        i += 1
    assert slam.tracking_state.name == "OK" and len(slam.kf_order) >= 2
    frame = slam._frame_fn(slam.extractor.upload(scene.render(K, poses[i], W, H)))
    return slam, frame


def _track_args(slam, frame, min_obs=2, th_depth=0.0, vo_th_depth=0.0, state=None):
    lf = slam.last_frame
    pose = torch.as_tensor(slam.last_pose, dtype=torch.float32)
    return (slam.state if state is None else state, frame, pose, pose.clone(),
            (lf.uv, lf.oct, lf.ang, lf.bip, lf.mp, lf.depth), torch.tensor(slam.ref_kf),
            torch.tensor(min_obs), torch.tensor(th_depth, dtype=torch.float32),
            torch.tensor(vo_th_depth, dtype=torch.float32))


def test_key_ignores_values_and_follows_capacities(tracked):
    slam, frame = tracked
    key = programs.program_key(*_track_args(slam, frame))
    assert programs.program_key(*_track_args(slam, frame, min_obs=3, th_depth=14.0, vo_th_depth=14.0)) == key
    assert programs.program_key(*_track_args(slam, frame._replace(uv=frame.uv + 1.0))) == key
    P, K = slam.state.mp_valid.shape[0], slam.state.kf_valid.shape[0]
    grown_p = programs.program_key(*_track_args(slam, frame, state=mstate.grow_points(slam.state, 2 * P)))
    grown_k = programs.program_key(*_track_args(slam, frame, state=mstate.grow_keyframes(slam.state, 2 * K)))
    assert len({key, grown_p, grown_k}) == 3
    # A Python number among the arguments is part of the key.
    assert programs.program_key(torch.zeros(3), 2) != programs.program_key(torch.zeros(3), 3)


def test_cpu_program_calls_through():
    calls = []

    def fn(x, pair, k):
        calls.append(k)
        return x * k, (pair[0] + 1, pair[1])

    prog = programs.Program(fn, "add")
    x = torch.arange(4.0)
    out = prog(x, (x, None), 2)
    assert torch.equal(out[0], x * 2) and torch.equal(out[1][0], x + 1) and out[1][1] is None
    assert calls == [2]
    assert prog.stats() == dict(captures=0, replays=0, capture_s=0.0, graphs=0)
    prog.clear()  # nothing to drop on the CPU


def test_eager_nests_and_restores():
    assert not programs.is_eager()
    with programs.eager():
        assert programs.is_eager()
        with programs.eager():
            assert programs.is_eager()
        assert programs.is_eager()
    assert not programs.is_eager()
    with pytest.raises(KeyError):
        with programs.eager():
            raise KeyError("inside")
    assert not programs.is_eager()


def test_track_program_equals_host_branch_step(tracked):
    slam, frame = tracked
    lf = slam.last_frame
    ref_tracked = {}
    for min_obs in (2, 3):
        got = slam._track_fn(*_track_args(slam, frame, min_obs=min_obs))
        want = tracking.full_track_step(
            slam.state, frame, slam.last_pose, slam.last_pose, lf.uv, lf.oct, lf.ang, lf.bip, lf.mp,
            lf.depth, slam.ref_kf, min_obs, slam.cam, slam.scale_factors, slam._radius_mm)
        for f in tracking.FullStepResult._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), (min_obs, f)
        assert int(got.scalars[0]) == 1
        ref_tracked[min_obs] = int(got.scalars[3])
    # Two keyframes: every point has two observations, none three.
    assert ref_tracked[2] > 0 and ref_tracked[3] == 0
    assert slam.program_stats()["pool_bytes"] == 0
