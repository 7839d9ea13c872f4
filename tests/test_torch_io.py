"""The port's io modules against the reference's. Settings: every
SystemConfig field equal (camera intrinsics as the float32 the reference
holds) for the four texts tools/accuracy_eval.py writes and one with
distortion, comments, a quoted string and SLAM.* overrides. Trajectory
files: byte-equal. Checkpoints, both ways: a map saved by the reference
System loads into the port with every array equal (bits for packed words),
covisibility recomputed equal, and a map saved by the port loads into the
reference System with every array equal."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine import Sensor as JSensor
from orb_slam_cuda_tpu.engine import System as JSystem
from orb_slam_cuda_tpu.engine import SystemConfig as JConfig
from orb_slam_cuda_tpu.geometry.camera import Camera as JCamera
from orb_slam_cuda_tpu.io import checkpoint as jckpt
from orb_slam_cuda_tpu.io import config as jconfig
from orb_slam_cuda_tpu.io import trajectory as jtraj
from orb_slam_cuda_tpu.slam_map import MapConfig as JMapConfig
from orb_slam_cuda_tpu.slam_map import state as jstate
from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.io import checkpoint as tckpt
from orb_slam_cuda_tpu_torch.io import config as tconfig
from orb_slam_cuda_tpu_torch.io import trajectory as ttraj
from orb_slam_cuda_tpu_torch.utils import convert
from torch_parity import STEREO_CAM, STEREO_CFG, STEREO_H, STEREO_W, random_poses, stereo_scene, to_np

torch.set_num_threads(2)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
KITTI = (718.856, 718.856, 607.1928, 185.2157, 1241, 376, 10.0, 2000)
CAPS = "SLAM.max_keyframes: 256\nSLAM.max_points: 32768\n"
SETTINGS = {
    "mono_tum": ((517.306408, 516.469215, 318.643040, 255.313989, 640, 480, 30.0, 1000),
                 dict(k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314, extra=CAPS), "MONOCULAR"),
    "mono_kitti": (KITTI, dict(extra=CAPS), "MONOCULAR"),
    "stereo_kitti": (KITTI, dict(bf=386.1448, extra=CAPS), "STEREO"),
    "rgbd_tum": ((520.908620, 521.007327, 325.141442, 249.701764, 640, 480, 30.0, 1000),
                 dict(bf=40.0, extra="DepthMapFactor: 5000.0\n" + CAPS), "RGBD"),
}
HAND_WRITTEN = """%YAML:1.0
# a camera with distortion
Camera.fx: 458.654   # trailing comment
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.k1: -0.28340811
Camera.k2: 0.07395907
Camera.p1: 0.00019359
Camera.p2: 1.76187114e-05
Camera.width: 752
Camera.height: 480
Camera.fps: 20.0
Camera.RGB: 1
Dataset.name: "a # b: c"
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.25
ORBextractor.nLevels: 6
ORBextractor.iniThFAST: 18
ORBextractor.minThFAST: 5
ThDepth: 35
SLAM.kf_ref_ratio: 1.1
SLAM.async_mapping: 0
SLAM.min_frames_between_kf: 2
SLAM.kf_cull_redundancy: 0.8
SLAM.enable_loop_closing: 1
"""


def assert_configs_equal(jcfg, tcfg):
    jf = {f.name for f in dataclasses.fields(jcfg)}
    for f in dataclasses.fields(tcfg):
        assert f.name in jf, f.name
        jv, tv = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "camera":
            for c in Camera._fields:
                assert float(np.asarray(getattr(jv, c))) == float(getattr(tv, c)), c
        elif f.name == "sensor":
            assert jv.name == tv.name
        else:
            assert jv == tv and type(jv) is type(tv), (f.name, jv, tv)
    # Fields the port does not have are options of unported paths.
    assert jf - {f.name for f in dataclasses.fields(tcfg)} <= {"use_pallas_fast"}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_settings_equal_reference(tmp_path, name):
    import accuracy_eval

    args, kwargs, sensor = SETTINGS[name]
    path = str(tmp_path / "settings.yaml")
    accuracy_eval.settings_yaml(path, *args, **kwargs)
    jcfg = jconfig.load_settings(path, sensor=JSensor[sensor])
    tcfg = tconfig.load_settings(path, sensor=Sensor[sensor])
    assert_configs_equal(jcfg, tcfg)
    assert tcfg.max_keyframes == 256 and tcfg.max_points == 32768 and tcfg.th_depth_factor == 40.0
    assert tcfg.max_frames_between_kf == int(args[6])
    if name == "rgbd_tum":
        assert tcfg.depth_map_factor == 1.0 / 5000.0


def test_settings_with_distortion_comments_and_overrides(tmp_path):
    path = str(tmp_path / "settings.yaml")
    with open(path, "w") as f:
        f.write(HAND_WRITTEN)
    jcfg = jconfig.load_settings(path, sensor=JSensor.STEREO, n_features=900)
    tcfg = tconfig.load_settings(path, sensor=Sensor.STEREO, n_features=900)
    assert_configs_equal(jcfg, tcfg)
    assert tcfg.camera.has_distortion and tcfg.kf_ref_ratio == 1.1 and tcfg.async_mapping is False
    assert tcfg.n_features == 900 and tcfg.n_levels == 6
    d = tconfig.parse_opencv_yaml(HAND_WRITTEN)
    assert d["Dataset.name"] == "a # b: c" and d["Camera.RGB"] == 1 and d["ThDepth"] == 35


@pytest.mark.parametrize("text,err", [
    ("SLAM.camera: 3\n", ValueError), ("SLAM.mesh: 1\n", ValueError),
    ("Camera.width\n", tconfig.SettingsError),
], ids=["camera", "mesh", "no_colon"])
def test_bad_settings_raise(tmp_path, text, err):
    path = str(tmp_path / "settings.yaml")
    with open(path, "w") as f:
        f.write(HAND_WRITTEN + text)
    with pytest.raises(err):
        tconfig.load_settings(path)
    if err is ValueError:
        with pytest.raises(ValueError):
            jconfig.load_settings(path)


def test_missing_required_setting_raises(tmp_path):
    path = str(tmp_path / "settings.yaml")
    with open(path, "w") as f:
        f.write(HAND_WRITTEN.replace("Camera.width: 752\n", ""))
    with pytest.raises(tconfig.SettingsError, match="Camera.width"):
        tconfig.load_settings(path)


@pytest.fixture(scope="module")
def records():
    rng = np.random.default_rng(3)
    poses = random_poses(rng, 40, rot=1.5, trans=20.0)
    return [(i / 30.0, None if i % 7 == 3 else poses[i], i % 7 != 3 and i % 11 != 5) for i in range(40)]


@pytest.mark.parametrize("fmt", ["tum", "kitti"])
def test_trajectory_files_byte_equal(tmp_path, records, fmt):
    jp, tp = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    getattr(jtraj, f"save_trajectory_{fmt}")(records, jp)
    getattr(ttraj, f"save_trajectory_{fmt}")(records, tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert len(data.splitlines()) == sum(1 for _, T, ok in records if ok and T is not None)


def test_keyframe_trajectory_byte_equal_and_round_trip(tmp_path, records):
    poses = np.stack([T for _, T, ok in records if ok and T is not None][:6])
    st = jstate.empty(JMapConfig(max_keyframes=8, max_features=4, max_points=8))
    st = st._replace(kf_pose=st.kf_pose.at[:6].set(poses))
    order, stamps = [4, 0, 5, 2], {4: 0.5, 0: 1.25, 2: 3.0}
    jp, tp = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jtraj.save_keyframe_trajectory_tum(st, order, stamps, jp)
    ttraj.save_keyframe_trajectory_tum(convert.map_state(st), order, stamps, tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    back_j, back_t = jtraj.load_trajectory_tum(jp), ttraj.load_trajectory_tum(tp)
    for (t1, T1), (t2, T2), slot in zip(back_j, back_t, order):
        assert t1 == t2 == stamps.get(slot, 0.0)
        np.testing.assert_allclose(T1, T2, rtol=1e-5, atol=1e-5)  # float32 quaternion -> rotation
        np.testing.assert_allclose(T2, poses[slot], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def reference_run():
    """The reference RGB-D System after 8 frames of the orbit."""
    scene = stereo_scene()
    from orb_slam_cuda_tpu.utils import synthetic

    poses = synthetic.orbit_trajectory(20, radius=0.5)[:8]
    slam = JSystem(JConfig(camera=JCamera.create(**STEREO_CAM), sensor=JSensor.RGBD, **STEREO_CFG))
    K = np.asarray(slam.cam.K)
    for i, T in enumerate(poses):
        img, depth = scene.render_with_depth(K, T, STEREO_W, STEREO_H)
        slam.track_rgbd(img, depth, i * 0.1)
    assert slam.tracking_state.name == "OK" and len(slam.kf_order) >= 2
    return slam


def port_system(**kw):
    cfg = dict(STEREO_CFG, **kw)
    return System(SystemConfig(camera=Camera.create(**STEREO_CAM), sensor=Sensor.RGBD, **cfg), device="cpu")


def assert_states_equal(jst, tst, skip=()):
    for f in tst._fields:
        if f not in skip:
            np.testing.assert_array_equal(to_np(getattr(jst, f)), to_np(getattr(tst, f)), err_msg=f)


def test_reference_checkpoint_loads_into_port(reference_run, tmp_path):
    jslam = reference_run
    path = str(tmp_path / "map.npz")
    jslam.save_map(path)
    tslam = port_system()
    tslam.load_map(path)
    jst, jdb, jorder, jextras = jckpt.load_map(path)
    assert_states_equal(jst, tslam.state)  # covisibility recomputed on both sides
    assert_states_equal(jslam.state, tslam.state, skip=("covis",))
    assert int(tslam.state.covis.sum()) > 0
    for f in tslam.db._fields:
        np.testing.assert_array_equal(to_np(getattr(jdb, f)), to_np(getattr(tslam.db, f)), err_msg=f)
    ref_state = port_system().state
    assert all(getattr(tslam.state, f).dtype == getattr(ref_state, f).dtype for f in ref_state._fields)
    assert tslam.kf_order == jorder == jslam.kf_order
    assert tslam.kf_timestamps == jslam.kf_timestamps and tslam.recent_pts == jslam.recent_pts
    assert tslam.frame_id == jslam.frame_id + 1
    assert tslam._next_kf_slot == jslam._next_kf_slot
    assert tslam.mapper._next_pt_slot == jslam.mapper._next_pt_slot
    np.testing.assert_array_equal(tslam.mapper.mp_valid_host, to_np(jslam.state.mp_valid))
    st = tslam.get_status()
    assert st["state"] == "LOST" and st["localization_only"] and st["keyframes"] == len(jorder)


def test_port_checkpoint_loads_into_reference(reference_run, tmp_path):
    """reference -> port -> file -> reference: the file the port writes has
    the reference's keys and dtypes, and the reference reads it back."""
    first, second = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    reference_run.save_map(first)
    tslam = port_system()
    tslam.load_map(first, localization_only=False)
    assert not tslam.localization_only
    tslam.save_map(second)
    a, b = np.load(first), np.load(second)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if k == "extra_frame_id":  # a load resumes one frame on
            assert int(b[k]) == int(a[k]) + 1
        elif k != "map_covis":  # the port saves the recomputed one
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jslam = JSystem(JConfig(camera=JCamera.create(**STEREO_CAM), sensor=JSensor.RGBD, **STEREO_CFG))
    jslam.load_map(second)
    assert_states_equal(jslam.state, tslam.state)
    assert jslam.kf_order == tslam.kf_order and jslam.localization_only


def test_load_map_with_other_feature_capacity_raises(reference_run, tmp_path):
    path = str(tmp_path / "map.npz")
    reference_run.save_map(path)
    with pytest.raises(ValueError, match="feature capacity 600"):
        port_system(n_features=500).load_map(path)


def test_load_map_refuses_other_format_version(reference_run, tmp_path):
    path = str(tmp_path / "map.npz")
    reference_run.save_map(path)
    data = dict(np.load(path))
    data["format_version"] = np.asarray(2)
    np.savez_compressed(path, **data)
    with pytest.raises(ValueError, match="checkpoint format 2"):
        tckpt.load_map(path)
