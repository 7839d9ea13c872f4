"""The whole monocular slice, held against the JAX System by outcome on
the end-to-end orbit fixture (identical rendered frames to both): each
tracks > 85% of frames with ATE < 0.10 m, keyframe counts agree within
max(2, 25%), and the port skips no relocalization. Also: the refused
configurations, the synchronous-mapping path, trajectory export, and (slow
tier) chip_smoke.py's full-size main path on the CPU."""

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
    tslam = System(SystemConfig(camera=Camera.create(**CAM), sensor=Sensor.MONOCULAR, **CFG))
    return (jslam, _run(jslam, poses, images)), (tslam, _run(tslam, poses, images))


def test_slice_matches_reference_by_outcome(runs):
    (jslam, jate), (tslam, tate) = runs
    print(f"reference: tracked {jslam.tracked_ratio():.3f} ATE {jate:.4f} kfs {jslam.stats.n_keyframes}; "
          f"port: tracked {tslam.tracked_ratio():.3f} ATE {tate:.4f} kfs {tslam.stats.n_keyframes} "
          f"n_reloc_skipped {tslam.stats.n_reloc_skipped}")
    for slam, ate in ((jslam, jate), (tslam, tate)):
        assert slam.tracked_ratio() > 0.85
        assert ate < 0.10
    kj, kt = jslam.stats.n_keyframes, tslam.stats.n_keyframes
    assert abs(kj - kt) <= max(2, 0.25 * kj)
    assert tslam.stats.n_reloc_skipped == 0


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
    slam = System(SystemConfig(camera=Camera.create(**CAM), async_mapping=False, **CFG))
    ate = _run(slam, poses[:25], images[:25])
    assert slam.tracked_ratio() > 0.85 and ate < 0.10
    assert not slam._bg


@pytest.mark.parametrize("kw", [
    dict(sensor=Sensor.STEREO), dict(enable_loop_closing=True), dict(pipeline_lag=2),
    dict(mesh=object()), dict(cluster_refine_interval=4),
], ids=["stereo", "loop_closing", "pipeline_lag", "mesh", "cluster_refine"])
def test_unported_configurations_refused(kw):
    cfg = dict(CFG, enable_loop_closing=False)
    cfg.update(kw)
    with pytest.raises(NotImplementedError):
        System(SystemConfig(camera=Camera.create(**CAM), **cfg))


@pytest.mark.slow
def test_chip_smoke_main_path_on_cpu():
    """chip_smoke.py's full-size fixture (1241x376, 2000 features, 108
    frames) tracks through the port's plain versions on the CPU."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke

    cam, poses, frames = chip_smoke.make_fixture()
    chip_smoke.phase_main_path(cam, poses, frames, device="cpu")
