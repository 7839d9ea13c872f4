"""The port's OpenCV-free renderer, trajectories, evaluation and stage
timer against the JAX package's. Tolerances: textures within 1 gray level,
renders >= 95% of pixels within 2 gray levels (measured: all pixels,
max 2), orbit, circuit and loop poses within 1e-6, ATE/Umeyama within 1e-9,
timer rows exact. The torch render equals, pixel for pixel, the numpy
render it replaced (kept below as `_numpy_render`) on the circuit scene."""

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
    b = ts.render(K, T, 320, 240).numpy().astype(int)
    within = (np.abs(a - b) <= 2).mean()
    print(f"frame {frame}: {within:.5f} of pixels within 2 gray levels, max diff {np.abs(a - b).max()}")
    assert within >= 0.95


def _numpy_render(scene, K, Tcw, width, height):
    """The port's earlier numpy renderer: inverse-homography bilinear warp
    at 1/32 px, nearest-neighbour coverage, ray-plane depth order."""
    K = np.asarray(K, np.float64)
    R, t = np.asarray(Tcw, np.float64)[:3, :3], np.asarray(Tcw, np.float64)[:3, 3]
    out = np.zeros((height, width), np.uint8)
    depth = np.full((height, width), np.inf)
    us, vs = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    rays = np.stack([us, vs, np.ones_like(us)], axis=-1) @ np.linalg.inv(K).T
    for plane in scene.planes:
        eu_c, ev_c, p0_c = R @ plane.eu, R @ plane.ev, R @ plane.origin + t
        n = np.cross(eu_c, ev_c)
        if np.linalg.norm(n) < 1e-12:
            continue
        n = n / np.linalg.norm(n)
        denom = rays @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            lam = np.where(np.abs(denom) < 1e-9, np.inf, (n @ p0_c) / denom)
        H = K @ np.stack([eu_c * plane.scale, ev_c * plane.scale, p0_c], axis=1)
        if abs(np.linalg.det(H)) < 1e-12:
            continue
        Hi = np.linalg.inv(H)
        w = Hi[2, 0] * us + Hi[2, 1] * vs + Hi[2, 2]
        with np.errstate(divide="ignore"):
            w = np.where(w != 0, 1.0 / w, 0.0)
        lim = float(2**28)
        sx = np.clip((Hi[0, 0] * us + Hi[0, 1] * vs + Hi[0, 2]) * w, -lim, lim)
        sy = np.clip((Hi[1, 0] * us + Hi[1, 1] * vs + Hi[1, 2]) * w, -lim, lim)
        th, tw = plane.tex.shape
        qx, qy = np.rint(sx * 32).astype(np.int64), np.rint(sy * 32).astype(np.int64)
        x0, y0 = qx >> 5, qy >> 5
        ax, ay = (qx & 31).astype(np.float32) / 32.0, (qy & 31).astype(np.float32) / 32.0
        src = plane.tex.astype(np.float32)

        def tap(yy, xx):
            inside = (yy >= 0) & (yy < th) & (xx >= 0) & (xx < tw)
            return np.where(inside, src[np.clip(yy, 0, th - 1), np.clip(xx, 0, tw - 1)], 0.0)

        val = ((1 - ay) * ((1 - ax) * tap(y0, x0) + ax * tap(y0, x0 + 1))
               + ay * ((1 - ax) * tap(y0 + 1, x0) + ax * tap(y0 + 1, x0 + 1)))
        warped = np.clip(np.rint(val), 0, 255).astype(np.uint8)
        x, y = np.rint(sx), np.rint(sy)
        visible = (x >= 0) & (x < tw) & (y >= 0) & (y < th) & (lam > 0.05) & (lam < depth)
        out = np.where(visible, warped, out)
        depth = np.where(visible, lam, depth)
    return out


def _circuit_scene(mod):
    rng = np.random.default_rng(5)
    scene = mod.room_scene(rng, half_size=9.0, tex_size=384, n_walls=8)
    scene.planes.extend(mod.ring_obstacles(rng, 10, 7.0, tex_size=128))
    return scene


@pytest.fixture(scope="module")
def circuit():
    return _circuit_scene(jsyn), _circuit_scene(tsyn), tsyn.circuit_trajectory(40, radius=5.0, laps=1.3)


def test_circuit_scene_and_trajectory(circuit):
    js, ts, poses = circuit
    assert len(js.planes) == len(ts.planes) == 18
    for pj, pt in zip(js.planes, ts.planes):
        assert np.abs(pj.tex.astype(int) - pt.tex.astype(int)).max() <= 1
        for f in ("origin", "eu", "ev"):
            np.testing.assert_allclose(getattr(pj, f), getattr(pt, f), atol=1e-12)
        assert pj.scale == pt.scale
    for a, b in zip(jsyn.circuit_trajectory(40, radius=5.0, laps=1.3), poses):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 37])
def test_loop_trajectory(n):
    """The in-place yaw loop: the same 4x4 poses within 1e-6 (so3_exp in
    float32 in both)."""
    jp, tp = jsyn.loop_trajectory(n), tsyn.loop_trajectory(n)
    assert len(jp) == len(tp) == n
    for a, b in zip(jp, tp):
        assert b.shape == (4, 4) and b.dtype == np.float64
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("frame", [0, 13, 31])
def test_torch_render_equals_numpy_render(circuit, frame):
    _, ts, poses = circuit
    K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
    img = ts.render(K, poses[frame], 320, 240)
    assert img.dtype == torch.uint8 and img.device.type == "cpu"
    ref = _numpy_render(ts, K, poses[frame], 320, 240)
    assert (ref > 0).mean() > 0.9
    np.testing.assert_array_equal(img.numpy(), ref)


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
