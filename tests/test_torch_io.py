"""The port's io modules against the reference's. Settings: every
SystemConfig field equal (camera intrinsics as the float32 the reference
holds) for the four texts tools/accuracy_eval.py writes and one with
distortion, comments, a quoted string and SLAM.* overrides. Trajectory
files: byte-equal. Checkpoints, both ways: a map saved by the reference
System loads into the port with every array equal (bits for packed words),
covisibility recomputed equal, and a map saved by the port loads into the
reference System with every array equal. Dataset readers: on the same
cv2-written directories (KITTI mono and stereo, TUM RGB-D with an
association file and monocular from rgb.txt, with RGB frames and 16-bit
depth, EuRoC mono and stereo) the port's readers give the reference's
lengths, timestamps, frame keys, dtypes and arrays, exactly. BAL files:
a file written by either package loads into the other within 1e-6."""

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
from torch_parity import (STEREO_CAM, STEREO_CFG, STEREO_H, STEREO_W, assert_configs_equal, random_poses,
                          stereo_scene, to_np)

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


def _cv2():
    import cv2

    return cv2


@pytest.fixture(scope="module")
def dataset_dirs(tmp_path_factory):
    """One small directory per format, written with cv2: gray KITTI and
    EuRoC frames, RGB TUM frames with 16-bit depth."""
    cv2 = _cv2()
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.default_rng(4)

    def gray():
        return cv2.GaussianBlur(rng.integers(0, 256, (24, 36), dtype=np.uint8), (3, 3), 0)

    kitti = root / "kitti"
    for cam in ("image_0", "image_1"):
        (kitti / cam).mkdir(parents=True)
    (kitti / "times.txt").write_text("0.000000e+00\n1.036000e-01\n2.073000e-01\n")
    for i in range(3):
        for cam in ("image_0", "image_1"):
            cv2.imwrite(str(kitti / cam / f"{i:06d}.png"), gray())
    tum = root / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    rgb_lines, assoc = ["# color images", "# timestamp filename"], []
    for i, t in enumerate(("1305031102.175304", "1305031102.211214", "1305031102.243211")):
        cv2.imwrite(str(tum / "rgb" / f"{t}.png"), rng.integers(0, 256, (24, 36, 3), dtype=np.uint8))
        cv2.imwrite(str(tum / "depth" / f"{t}.png"), rng.integers(0, 65536, (24, 36), dtype=np.uint16))
        rgb_lines.append(f"{t} rgb/{t}.png")
        assoc.append(f"{t} rgb/{t}.png {t} depth/{t}.png")
    (tum / "rgb.txt").write_text("\n".join(rgb_lines) + "\n")
    (tum / "assoc.txt").write_text("\n".join(["# assoc"] + assoc) + "\n\n")
    euroc = root / "euroc"
    stamps = ["1403636579763555584", "1403636579813555456"]
    for cam in ("cam0", "cam1"):
        (euroc / cam / "data").mkdir(parents=True)
        for s in stamps:
            cv2.imwrite(str(euroc / cam / "data" / f"{s}.png"), gray())
    (root / "euroc_stamps.txt").write_text("\n".join(stamps) + "\n")
    return root


def _readers(mod, root):
    return {
        "kitti_mono": mod.KittiOdometryDataset(str(root / "kitti")),
        "kitti_stereo": mod.KittiOdometryDataset(str(root / "kitti"), stereo=True),
        "tum_rgbd": mod.TumRgbdDataset(str(root / "tum"), association_file=str(root / "tum" / "assoc.txt")),
        "tum_assoc_mono": mod.TumRgbdDataset(str(root / "tum"), association_file=str(root / "tum" / "assoc.txt"),
                                             monocular=True),
        "tum_rgb_txt": mod.TumRgbdDataset(str(root / "tum")),
        "euroc_mono": mod.EurocDataset(str(root / "euroc"), str(root / "euroc_stamps.txt")),
        "euroc_stereo": mod.EurocDataset(str(root / "euroc"), str(root / "euroc_stamps.txt"), stereo=True),
    }


@pytest.mark.parametrize("name", ["kitti_mono", "kitti_stereo", "tum_rgbd", "tum_assoc_mono", "tum_rgb_txt",
                                  "euroc_mono", "euroc_stereo"])
def test_dataset_readers_equal_reference(dataset_dirs, name):
    from orb_slam_cuda_tpu import io as jio
    from orb_slam_cuda_tpu_torch import io as tio

    jds, tds = _readers(jio, dataset_dirs)[name], _readers(tio, dataset_dirs)[name]
    assert len(jds) == len(tds) > 0
    jframes, tframes = list(jds), list(tds)
    assert len(jframes) == len(tframes) == len(tds)
    for (jt, jf), (tt_, tf) in zip(jframes, tframes):
        assert jt == tt_ and sorted(jf) == sorted(tf)
        for key in jf:
            assert tf[key].dtype == jf[key].dtype and isinstance(tf[key], np.ndarray), key
            np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)
    if name == "tum_rgbd":
        assert jframes[0][1]["depth"].dtype == np.uint16 and jframes[0][1]["image"].ndim == 2


def test_dataset_reader_missing_frame_raises(dataset_dirs, tmp_path):
    from orb_slam_cuda_tpu_torch.io import KittiOdometryDataset

    seq = tmp_path / "seq"
    (seq / "image_0").mkdir(parents=True)
    (seq / "times.txt").write_text("0.0\n")
    with pytest.raises(FileNotFoundError):
        list(KittiOdometryDataset(str(seq)))


def _ba_problem(rng, n_cam=4, n_pt=30, n_obs=90):
    poses = random_poses(rng, n_cam)
    xyz = rng.normal(0, 2.0, (n_pt, 3)).astype(np.float32)
    pt_valid = np.ones(n_pt, bool)
    pt_valid[-2:] = False
    obs_valid = np.ones(n_obs, bool)
    obs_valid[::7] = False
    return dict(cam_pose=poses, cam_fixed=np.arange(n_cam) == 0, xyz=xyz, pt_valid=pt_valid,
                obs_cam=rng.integers(0, n_cam, n_obs).astype(np.int32),
                obs_pt=rng.integers(0, n_pt, n_obs).astype(np.int32),
                obs_uv=rng.uniform(0, 640, (n_obs, 2)).astype(np.float32),
                obs_ur=np.full(n_obs, -1.0, np.float32), obs_inv_sigma2=np.ones(n_obs, np.float32),
                obs_valid=obs_valid)


def _assert_problems_close(a, b):
    for f in a._fields:
        x, y = to_np(getattr(a, f)), to_np(getattr(b, f))
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bal_files_cross_between_packages(tmp_path, writer):
    import jax.numpy as jnp

    from orb_slam_cuda_tpu.io import bal as jbal
    from orb_slam_cuda_tpu.solvers import bundle_adjust as jba
    from orb_slam_cuda_tpu_torch.io import bal as tbal
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as tba

    arrays = _ba_problem(np.random.default_rng(6))
    path = str(tmp_path / "problem.bal")
    if writer == "jax":
        jbal.save_bal(jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()}), path, 718.856)
    else:
        tbal.save_bal(tba.BAProblem(**{k: torch.as_tensor(v) for k, v in arrays.items()}), path, 718.856)
    (jp, jf), (tp, tf) = jbal.load_bal(path), tbal.load_bal(path, device="cpu")
    assert jf == tf == pytest.approx(718.856)
    _assert_problems_close(jp, tp)
    np.testing.assert_allclose(to_np(tp.cam_pose), arrays["cam_pose"], atol=1e-5)
    assert int(tp.obs_valid.sum()) == int(arrays["obs_valid"].sum())
    other = str(tmp_path / "again.bal")
    (tbal.save_bal if writer == "jax" else jbal.save_bal)(tp if writer == "jax" else jp, other, tf)
    _assert_problems_close(tbal.load_bal(other, device="cpu")[0], jbal.load_bal(other)[0])
