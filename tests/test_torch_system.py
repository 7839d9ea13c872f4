"""The whole monocular slice, held against the JAX System by outcome on
the end-to-end orbit fixture (identical rendered frames to both): each
tracks > 85% of frames with ATE < 0.10 m, keyframe counts agree within
max(2, 25%), relocalization counts agree; the same with loop closing on.
Also: relocalization after a blackout, the refused configurations, the
synchronous-mapping path, trajectory export, and (slow tier) loop closure
on a circuit against the same run with loop closing off, and
chip_smoke.py's full-size paths on the CPU."""

import os
import sys

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine import Sensor as JSensor
from orb_slam_cuda_tpu.engine import System as JSystem
from orb_slam_cuda_tpu.engine import SystemConfig as JConfig
from orb_slam_cuda_tpu.geometry.camera import Camera as JCamera
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.utils import synthetic as tsyn
from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

torch.set_num_threads(2)
W, H = 320, 240
CAM = dict(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
CFG = dict(n_features=600, max_keyframes=64, max_points=8192, enable_loop_closing=False,
           max_frames_between_kf=10)


@pytest.fixture(scope="module")
def orbit():
    rng = np.random.default_rng(42)
    scene = jsyn.PlanarScene.default(rng, depth=5.0, second_depth=8.0, extent=12.0, tex_size=768)
    poses = jsyn.orbit_trajectory(40, radius=0.6)
    K = np.asarray(JCamera.create(**CAM).K)
    return poses, [scene.render(K, T, W, H) for T in poses]


def _run(slam, poses, images):
    for i, img in enumerate(images):
        slam.track_monocular(img, i * 0.1)
    ts, est = camera_centers(slam.get_trajectory())
    gt = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    return ate_rmse(est, np.asarray([gt[round(t, 6)] for t in ts]))


@pytest.fixture(scope="module")
def runs(orbit):
    poses, images = orbit
    jslam = JSystem(JConfig(camera=JCamera.create(**CAM), sensor=JSensor.MONOCULAR, **CFG))
    tslam = System(SystemConfig(camera=Camera.create(**CAM), sensor=Sensor.MONOCULAR, **CFG), device="cpu")
    return (jslam, _run(jslam, poses, images)), (tslam, _run(tslam, poses, images))


def test_slice_matches_reference_by_outcome(runs):
    (jslam, jate), (tslam, tate) = runs
    print(f"reference: tracked {jslam.tracked_ratio():.3f} ATE {jate:.4f} kfs {jslam.stats.n_keyframes}; "
          f"port: tracked {tslam.tracked_ratio():.3f} ATE {tate:.4f} kfs {tslam.stats.n_keyframes} "
          f"n_reloc {tslam.stats.n_reloc}")
    for slam, ate in ((jslam, jate), (tslam, tate)):
        assert slam.tracked_ratio() > 0.85
        assert ate < 0.10
    kj, kt = jslam.stats.n_keyframes, tslam.stats.n_keyframes
    assert abs(kj - kt) <= max(2, 0.25 * kj)
    assert tslam.stats.n_reloc == jslam.stats.n_reloc


def test_port_map_is_consistent(runs):
    _, (tslam, _) = runs
    st = tslam.state
    bound = st.kf_mp[st.kf_mp >= 0].long()
    assert bool(st.mp_valid[bound].all())
    assert int(st.mp_valid.sum()) > 100
    assert sorted(tslam.kf_order) == torch.nonzero(st.kf_valid).flatten().tolist()
    assert all(getattr(st, f).device.type == "cpu" for f in st._fields)


def test_trajectory_export(runs, tmp_path):
    _, (tslam, _) = runs
    path = tmp_path / "traj.txt"
    tslam.save_trajectory_tum(str(path))
    rows = [line.split() for line in path.read_text().splitlines()]
    assert len(rows) == sum(ok for _, _, ok in tslam.get_trajectory())
    assert all(len(r) == 8 for r in rows)
    tslam.reset()
    assert tslam.tracking_state.name == "NO_IMAGES_YET" and not tslam.kf_order


def test_synchronous_mapping(orbit):
    poses, images = orbit
    slam = System(SystemConfig(camera=Camera.create(**CAM), async_mapping=False, **CFG), device="cpu")
    ate = _run(slam, poses[:25], images[:25])
    assert slam.tracked_ratio() > 0.85 and ate < 0.10
    assert not slam._bg


def test_loop_closing_on_matches_reference(orbit):
    """enable_loop_closing=True on the 40-frame orbit: the same outcome
    as the JAX System with the same setting."""
    poses, images = orbit
    cfg = dict(CFG, enable_loop_closing=True)
    jslam = JSystem(JConfig(camera=JCamera.create(**CAM), sensor=JSensor.MONOCULAR, **cfg))
    tslam = System(SystemConfig(camera=Camera.create(**CAM), sensor=Sensor.MONOCULAR, **cfg), device="cpu")
    jate, tate = _run(jslam, poses, images), _run(tslam, poses, images)
    js, ts = jslam.get_status(), tslam.get_status()
    print(f"reference {js} ATE {jate:.4f}; port {ts} ATE {tate:.4f}")
    assert ts["loops_closed"] == js["loops_closed"] and ts["relocalizations"] == js["relocalizations"]
    assert tslam.loop_closer.kf_seen == jslam.loop_closer.kf_seen
    assert abs(ts["tracked_ratio"] - js["tracked_ratio"]) <= 0.03
    assert abs(ts["keyframes"] - js["keyframes"]) <= max(2, 0.25 * js["keyframes"])
    assert tate < 0.10 and jate < 0.10


def test_relocalizes_after_blackout():
    """Three blank frames once the map holds more than 5 keyframes: the
    frames are lost, then relocalized against the map."""
    scene = tsyn.PlanarScene.default(np.random.default_rng(42), depth=5.0, second_depth=8.0,
                                     extent=12.0, tex_size=768)
    poses = tsyn.orbit_trajectory(44, radius=0.6)
    slam = System(SystemConfig(camera=Camera.create(**CAM), **dict(
        CFG, max_frames_between_kf=4, kf_cull_redundancy=1.1, kf_ref_ratio=1.1)), device="cpu")
    K = np.asarray(slam.cam.K)
    tracked_after = 0
    track = slam._track

    def track_after_drain(frame, ts):
        # The reference finishes the deferred units before a frame tracks.
        assert not slam._bg
        return track(frame, ts)

    slam._track = track_after_drain
    for i, T in enumerate(poses):
        img = torch.zeros((H, W), dtype=torch.uint8) if 30 <= i < 33 else scene.render(K, T, W, H)
        pose = slam.track_monocular(img, i * 0.1)
        tracked_after += int(i >= 33 and pose is not None)
    print(f"lost {slam.stats.n_lost}, reloc {slam.stats.n_reloc} {slam.reloc_stage_stats}, "
          f"tracked after {tracked_after}")
    assert slam.stats.n_lost >= 2
    assert tracked_after >= 7, "failed to relocalize after blackout"
    assert slam.stats.n_reloc >= 1
    assert slam.get_status()["state"] == "OK"


@pytest.mark.parametrize("kw", [
    dict(sensor=Sensor.STEREO), dict(enable_loop_closing=True, mesh=object()), dict(pipeline_lag=2),
    dict(mesh=object()), dict(cluster_refine_interval=4),
], ids=["stereo", "loop_closing", "pipeline_lag", "mesh", "cluster_refine"])
def test_unported_configurations_refused(kw):
    cfg = dict(CFG, enable_loop_closing=False)
    cfg.update(kw)
    with pytest.raises(NotImplementedError):
        System(SystemConfig(camera=Camera.create(**CAM), **cfg), device="cpu")


def _circuit_run(enable_loop: bool):
    """tests/test_loop_e2e.py's circuit (8-wall room, 360 frames, 1.3
    laps, the reference keyframe policy) through the port."""
    rng = np.random.default_rng(7)
    scene = tsyn.room_scene(rng, half_size=9.0, tex_size=1024, n_walls=8)
    poses = tsyn.circuit_trajectory(360, radius=5.0, laps=1.3)
    slam = System(SystemConfig(camera=Camera.create(**CAM), sensor=Sensor.MONOCULAR, n_features=800,
                               max_keyframes=128, max_points=16384, enable_loop_closing=enable_loop,
                               max_frames_between_kf=30, min_frames_between_kf=0), seed=1, device="cpu")
    return slam, _run_rendered(slam, scene, poses)


def _run_rendered(slam, scene, poses):
    K = np.asarray(slam.cam.K)
    for i, T in enumerate(poses):
        slam.track_monocular(scene.render(K, T, W, H), i * 0.1)
    ts, est = camera_centers(slam.get_trajectory())
    gt = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    return ate_rmse(est, np.asarray([gt[round(t, 6)] for t in ts]))


@pytest.mark.slow
def test_loop_closure_reduces_ate_on_circuit():
    slam_off, ate_off = _circuit_run(False)
    slam_on, ate_on = _circuit_run(True)
    st_on, st_off = slam_on.get_status(), slam_off.get_status()
    print(f"on {st_on} ATE {ate_on:.4f}; off {st_off} ATE {ate_off:.4f}")
    assert st_on["loops_closed"] >= 1, st_on
    assert st_on["tracked_ratio"] > 0.85 and st_off["tracked_ratio"] > 0.85
    assert len(slam_on.kf_order) < slam_on.stats.n_keyframes  # culling is live
    assert ate_on < 0.92 * ate_off, f"loop-on ATE {ate_on:.4f} vs loop-off {ate_off:.4f}"


@pytest.mark.slow
def test_chip_smoke_main_path_on_cpu():
    """chip_smoke.py's full-size fixture (1241x376, 2000 features, 108
    frames) tracks through the port's plain versions on the CPU."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    cam, poses, frames = chip_smoke.make_fixture()
    chip_smoke.phase_main_path(cam, poses, frames, device="cpu")
