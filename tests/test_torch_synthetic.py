"""The port's OpenCV-free renderer, trajectory, evaluation and stage timer
against the JAX package's. Tolerances: textures within 1 gray level,
renders >= 95% of pixels within 2 gray levels (measured: all pixels,
max 2), orbit poses within 1e-6, ATE/Umeyama within 1e-9, timer rows
exact."""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.utils import evaluation as jev
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu_torch.utils import evaluation as tev
from orb_slam_cuda_tpu_torch.utils import synthetic as tsyn
from orb_slam_cuda_tpu_torch.utils.timing import StageTimer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    kw = dict(depth=5.0, second_depth=8.0, extent=12.0, tex_size=512)
    return (jsyn.PlanarScene.default(np.random.default_rng(42), **kw),
            tsyn.PlanarScene.default(np.random.default_rng(42), **kw))


def test_texture_within_one_gray_level(scenes):
    js, ts = scenes
    for pj, pt in zip(js.planes, ts.planes):
        d = np.abs(pj.tex.astype(int) - pt.tex.astype(int))
        assert d.max() <= 1
        np.testing.assert_array_equal(pj.origin, pt.origin)
        assert pj.scale == pt.scale


@pytest.mark.parametrize("frame", [0, 7, 23])
def test_render_matches_opencv_renderer(scenes, frame):
    js, ts = scenes
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
    T = jsyn.orbit_trajectory(40, radius=0.6)[frame]
    a = js.render(K, T, 320, 240).astype(int)
    b = ts.render(K, T, 320, 240).astype(int)
    within = (np.abs(a - b) <= 2).mean()
    print(f"frame {frame}: {within:.5f} of pixels within 2 gray levels, max diff {np.abs(a - b).max()}")
    assert within >= 0.95


def test_orbit_trajectory():
    for a, b in zip(jsyn.orbit_trajectory(30, radius=1.5, depth_amp=0.3),
                    tsyn.orbit_trajectory(30, radius=1.5, depth_amp=0.3)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_evaluation_copy():
    rng = np.random.default_rng(0)
    gt = rng.normal(0, 1, (50, 3))
    est = 0.5 * gt @ np.linalg.qr(rng.normal(0, 1, (3, 3)))[0].T + 0.01 * rng.normal(0, 1, (50, 3))
    for a, b in zip(jev.umeyama_alignment(est, gt), tev.umeyama_alignment(est, gt)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    assert abs(jev.ate_rmse(est, gt) - tev.ate_rmse(est, gt)) < 1e-9
    poses = [np.eye(4) for _ in range(5)]
    traj = [(i * 0.1, p, i != 2) for i, p in enumerate(poses)]
    for a, b in zip(jev.camera_centers(traj), tev.camera_centers(traj)):
        np.testing.assert_array_equal(a, b)
    assert jev.rpe_translation(poses, poses) == tev.rpe_translation(poses, poses)


def test_stage_timer(tmp_path):
    t = StageTimer()
    t.set_frame(3)
    with t.stage("times.csv", "orb_extract", sync=torch.device("cpu")):
        pass
    with t.stage("times.csv", "orb_extract", level=2):
        pass
    assert [r[:3] for r in t.rows["times.csv"]] == [(3, "orb_extract", -1), (3, "orb_extract", 2)]
    assert set(t.summary("times.csv")) == {"orb_extract"}
    (path,) = t.flush(str(tmp_path))
    assert open(path).readline().strip() == "frame,name,level,time"
    off = StageTimer(enabled=False)
    with off.stage("times.csv", "x"):
        pass
    assert not off.rows
