"""The port's command-line runner, status server, headless viewer,
powermon and accuracy tool against the JAX package's.

- CLI, by outcome, on tests/test_runner.py's 16-frame mini-KITTI shape
  (320x240, 600 features): both `run.main`s return 0; the trajectories
  hold the same timestamps; tracked counts within 1 frame, keyframes
  within max(2, 25%); ATE after a sim(3) alignment under 0.05 m in both.
  An RGB-D mini run saves its map and a second run resumes it with
  --load-map (localization-only: a pose within 3 frames, no keyframe).
  With no card the CLI raises at start unless given --device cpu.
- Status server: /status equals the reference's snapshot of the same
  System key for key and value for value; /map_changed is edge-triggered;
  /map.png decodes through io/png.py to an RGB image.
- Viewer: keyframe centres, the camera, covisibility edges (weight >= 100
  only) and map points land on the pixels topview_transform gives
  (exact); feature rings are green where bound, blue where not.
- Powermon: the prepare/start/stop/print lifecycle on the CPU.
- Accuracy tool: frames of undistorted configs equal the JAX tool's
  (exact: the same numpy noise, the same scene output); the TUM1 lens
  warp's maps within 0.1 px of cv2's (cv2.undistortPoints stops at 5
  rounds, up to 0.13 px short in the corners; the port's 20 converge
  under 1e-8 px) and the distorted frames within the measured remap
  tolerance (mean |difference| under 0.1 gray level, max 4: coordinates
  at 1/32 px round differently next to hard edges); `score` equal.
- Slow: the first 120 frames of config_mono_tum through both CLIs on the
  CPU, each under chip_smoke.py's gates (first pose by frame 60, tracked
  >= 0.85 from it on, ATE <= 1% of the whole config's 5.09 m).
"""

import csv
import io
import json
import os
import sys
import time
import types
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.io import serve as jserve
from orb_slam_cuda_tpu.run import main as jmain
from orb_slam_cuda_tpu_torch import run as trun
from orb_slam_cuda_tpu_torch.engine import Sensor, System
from orb_slam_cuda_tpu_torch.io import load_settings, png
from orb_slam_cuda_tpu_torch.io.datasets import KittiOdometryDataset
from orb_slam_cuda_tpu_torch.io.serve import StatusServer, snapshot
from orb_slam_cuda_tpu_torch.tools import accuracy_eval as tacc
from orb_slam_cuda_tpu_torch.utils import powermon, synthetic, viewer
from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import accuracy_eval as jacc  # noqa: E402

SETTINGS = """%YAML:1.0
Camera.fx: 260.0
Camera.fy: 260.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: 320
Camera.height: 240
Camera.fps: 10.0
ORBextractor.nFeatures: 600
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
K = np.array([[260.0, 0, 160], [0, 260.0, 120], [0, 0, 1]])
ATE_BOUND = 0.05


@pytest.fixture(scope="module")
def mini_kitti(tmp_path_factory):
    """tests/test_runner.py's sequence: 16 frames of the default orbit."""
    tmp = tmp_path_factory.mktemp("mini_kitti")
    rng = np.random.default_rng(3)
    scene = synthetic.PlanarScene.default(rng, tex_size=768)
    poses = synthetic.orbit_trajectory(16, radius=0.6)
    seq = tmp / "seq"
    (seq / "image_0").mkdir(parents=True)
    with open(seq / "times.txt", "w") as f:
        for i, T in enumerate(poses):
            cv2.imwrite(str(seq / "image_0" / f"{i:06d}.png"), scene.render(K, T, 320, 240).numpy())
            f.write(f"{i*0.1:.6f}\n")
    settings = tmp / "settings.yaml"
    settings.write_text(SETTINGS)
    return str(seq), str(settings), tmp, poses


def _gt_centres(poses, dt):
    return {round(i * dt, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}


def _traj_ate(path, gt):
    rows = np.loadtxt(path, ndmin=2)
    est = rows[:, 1:4]
    ref = np.asarray([gt[round(t, 6)] for t in rows[:, 0]])
    return rows[:, 0], ate_rmse(est, ref)


def _shutdown(err: str):
    line = next(ln for ln in err.splitlines() if ln.startswith("tracked "))
    tracked = int(line.split()[1].split("/")[0])
    keyframes = int(line.split(";")[-1].split()[0])
    return tracked, keyframes


@pytest.fixture(scope="module")
def both_runs(mini_kitti):
    seq, settings, tmp, poses = mini_kitti
    out = {}
    for name, main, extra in (("jax", jmain, []), ("port", trun.main, ["--device", "cpu"])):
        d = tmp / name
        d.mkdir()
        err = io.StringIO()
        sys_err, sys.stderr = sys.stderr, err
        try:
            rc = main(["--dataset", "kitti", "--sensor", "mono", "--sequence", seq, "--settings", settings,
                       "--save-tum", str(d / "traj.txt"), "--save-kitti", str(d / "traj_kitti.txt"),
                       "--save-kf-tum", str(d / "kf.txt"), "--save-map", str(d / "map.npz"),
                       "--timing-dir", str(d), "--diag", str(d / "diag.csv")] + extra)
        finally:
            sys.stderr = sys_err
        out[name] = (rc, d, err.getvalue())
    return out


def test_cli_matches_reference_by_outcome(both_runs, mini_kitti):
    *_, poses = mini_kitti
    gt = _gt_centres(poses, 0.1)
    (jrc, jdir, jerr), (trc, tdir, terr) = both_runs["jax"], both_runs["port"]
    assert jrc == 0 and trc == 0
    jt, jate = _traj_ate(jdir / "traj.txt", gt)
    tt_, tate = _traj_ate(tdir / "traj.txt", gt)
    print(f"jax: {_shutdown(jerr)} ATE {jate:.4f}; port: {_shutdown(terr)} ATE {tate:.4f}")
    np.testing.assert_array_equal(jt, tt_)
    (jtr, jkf), (ttr, tkf) = _shutdown(jerr), _shutdown(terr)
    assert abs(jtr - ttr) <= 1
    assert abs(jkf - tkf) <= max(2, 0.25 * jkf)
    assert jate < ATE_BOUND and tate < ATE_BOUND


def test_cli_writes_every_output_the_reference_writes(both_runs):
    jdir, tdir = both_runs["jax"][1], both_runs["port"][1]
    names = ("traj.txt", "traj_kitti.txt", "kf.txt", "map.npz", "times.csv", "timesTracking.csv", "diag.csv")
    for name in names:
        assert (jdir / name).exists() and (tdir / name).exists(), name
    jdiag = list(csv.DictReader(open(jdir / "diag.csv")))
    tdiag = list(csv.DictReader(open(tdir / "diag.csv")))
    assert list(jdiag[0]) == list(tdiag[0]) and len(jdiag) == len(tdiag) == 16
    assert [r["timestamp"] for r in jdiag] == [r["timestamp"] for r in tdiag]
    for err in (both_runs["jax"][2], both_runs["port"][2]):
        assert any(ln.startswith("loops closed: ") for ln in err.splitlines())


def test_cli_loads_the_reference_map(both_runs, mini_kitti, capsys):
    """A map the JAX CLI saved resumes in the port's CLI: localization-only,
    a pose within 3 frames, no keyframe inserted."""
    seq, settings, tmp, _ = mini_kitti
    diag = tmp / "resume_diag.csv"
    rc = trun.main(["--dataset", "kitti", "--sensor", "mono", "--sequence", seq, "--settings", settings,
                    "--load-map", str(both_runs["jax"][1] / "map.npz"), "--localization-only",
                    "--max-frames", "8", "--diag", str(diag), "--device", "cpu"])
    assert rc == 0
    rows = list(csv.DictReader(open(diag)))
    ok = [r["state"] == "OK" for r in rows]
    assert len(rows) == 8 and any(ok[:3]) and sum(ok) >= 6
    assert len({r["keyframes"] for r in rows}) == 1


def test_cli_raises_without_card_unless_cpu(mini_kitti, monkeypatch):
    seq, settings, *_ = mini_kitti
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--dataset", "kitti", "--sensor", "mono", "--sequence", seq, "--settings", settings]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available\\(\\) is False"):
        trun.main(argv)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available\\(\\) is False"):
        trun.main(argv + ["--device", "cuda"])
    assert trun.main(argv + ["--device", "cpu", "--max-frames", "1"]) == 0


def _write_rgbd(root, n=14):
    """A small TUM RGB-D sequence (RGB frames, 16-bit depth, association
    file) written with cv2: tests/test_stereo_rgbd.py's two planes and
    orbit, with its keyframe settings (a keyframe every few frames)."""
    scene = synthetic.PlanarScene.default(np.random.default_rng(0), depth=5.0, second_depth=8.0,
                                          extent=12.0, tex_size=768)
    poses = synthetic.orbit_trajectory(20, radius=0.5)[:n]
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    lines = []
    for i, T in enumerate(poses):
        img, z = scene.render_with_depth(K, T, 320, 240)
        ts = f"{i / 30.0:.6f}"
        cv2.imwrite(str(root / "rgb" / f"{ts}.png"), np.repeat(img.numpy()[..., None], 3, axis=2))
        cv2.imwrite(str(root / "depth" / f"{ts}.png"), np.clip(z.numpy() * 5000, 0, 65535).astype(np.uint16))
        lines.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png")
    (root / "assoc.txt").write_text("\n".join(lines) + "\n")
    (root / "settings.yaml").write_text(
        SETTINGS.replace("Camera.fps: 10.0", "Camera.fps: 8.0")
        + "Camera.bf: 52.0\nThDepth: 40.0\nDepthMapFactor: 5000.0\nSLAM.kf_ref_ratio: 1.1\n"
        "SLAM.stereo_init_min_features: 300\nSLAM.enable_loop_closing: 0\n")
    return poses


def test_rgbd_cli_saves_and_resumes_its_map(tmp_path):
    seq = tmp_path / "rgbd"
    poses = _write_rgbd(seq)
    common = ["--dataset", "tum", "--sensor", "rgbd", "--sequence", str(seq), "--settings",
              str(seq / "settings.yaml"), "--association", str(seq / "assoc.txt"), "--device", "cpu"]
    assert trun.main(common + ["--save-map", str(tmp_path / "map.npz"), "--save-tum",
                               str(tmp_path / "traj.txt")]) == 0
    _, ate = _traj_ate(tmp_path / "traj.txt", _gt_centres(poses, 1 / 30.0))
    assert ate < ATE_BOUND
    diag = tmp_path / "resume.csv"
    assert trun.main(common + ["--load-map", str(tmp_path / "map.npz"), "--max-frames", "6",
                               "--diag", str(diag)]) == 0
    rows = list(csv.DictReader(open(diag)))
    assert len(rows) == 6 and any(r["state"] == "OK" for r in rows[:3])
    assert len({r["keyframes"] for r in rows}) == 1


def test_status_server_answers_as_the_reference(mini_kitti):
    seq, settings, *_ = mini_kitti
    slam = System(load_settings(settings, sensor=Sensor.MONOCULAR), device="cpu")
    srv = StatusServer(slam).start()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}", timeout=30) as r:
            return r.read()

    try:
        assert json.loads(get("/status")) == jserve.snapshot(slam) == snapshot(slam)
        assert json.loads(get("/map_changed"))["map_changed"] is True
        assert json.loads(get("/map_changed"))["map_changed"] is False
        for i, (t, frame) in enumerate(KittiOdometryDataset(seq)):
            slam.track_monocular(frame["image"], t)
            if i >= 9:
                break
        st = json.loads(get("/status"))
        assert st == jserve.snapshot(slam) and st["frames"] == 10 and st["keyframes"] >= 2
        assert json.loads(get("/map_changed"))["map_changed"] is True
        assert json.loads(get("/map_changed"))["map_changed"] is False
        assert b"live map" in get("/")
        img = png.decode(get("/map.png"))
        assert img.dtype == np.uint8 and img.shape == (viewer.TOPVIEW_SIZE, viewer.TOPVIEW_SIZE, 3)
        assert (img == viewer.BLUE).all(-1).any()
        # The System's own cursor is apart from the server's.
        assert slam.map_changed() is True and slam.map_changed() is False
    finally:
        srv.stop()


def _fake_state():
    """Three keyframes on a line, covisibility 150 between 0 and 1 and 50
    between 1 and 2, a few map points."""
    kf_pose = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    centres = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 2.0], [3.0, 0.0, 1.0]], np.float32)
    for k, c in enumerate(centres):
        kf_pose[k, :3, 3] = -c  # identity rotation: Tcw translation = -centre
    covis = np.zeros((4, 4), np.int32)
    covis[0, 1] = covis[1, 0] = 150
    covis[1, 2] = covis[2, 1] = 50
    xyz = np.array([[0.5, 1.0, 3.0], [2.5, -1.0, -1.0], [9.0, 9.0, 9.0]], np.float32)
    state = types.SimpleNamespace(
        kf_pose=torch.as_tensor(kf_pose), kf_valid=torch.tensor([True, True, True, False]),
        mp_xyz=torch.as_tensor(xyz), mp_valid=torch.tensor([True, True, False]), covis=torch.as_tensor(covis))
    return state, centres, xyz


def test_viewer_draws_the_reference_content_where_expected(tmp_path):
    state, centres, xyz = _fake_state()
    cam = np.eye(4)
    cam[:3, 3] = -np.array([2.0, 0.0, 3.0])
    canvas = viewer.render_topview(state, covis=state.covis, current_pose=cam)
    frame_pts = np.concatenate([xyz[:2][:, [0, 2]], centres[:, [0, 2]], [[2.0, 3.0]]])
    to_pixel = viewer.topview_transform(frame_pts)

    def at(p):
        r, c = np.rint(to_pixel(p)[0]).astype(int)
        return tuple(canvas[r, c])

    for c in centres:
        assert at(c[[0, 2]]) == viewer.BLUE
    assert at([2.0, 3.0]) == viewer.RED
    for p in xyz[:2]:
        assert at(p[[0, 2]]) == viewer.POINT
    assert at((centres[0, [0, 2]] + centres[1, [0, 2]]) / 2) == viewer.GREEN  # weight 150
    assert at((centres[1, [0, 2]] + centres[2, [0, 2]]) / 2) == viewer.WHITE  # weight 50
    r0, c0 = np.rint(to_pixel(centres[0, [0, 2]])[0])
    r1, c1 = np.rint(to_pixel(centres[1, [0, 2]])[0])
    assert c1 > c0 and r1 < r0  # x to the right, z up
    path = viewer.draw_map_topview(state, str(tmp_path / "map.png"), covis=state.covis, current_pose=cam)
    assert np.array_equal(png.read(path), canvas)
    assert np.array_equal(png.decode(viewer.render_map_png(state, state.covis, cam)), canvas)


def test_viewer_frame_overlay(tmp_path):
    image = np.full((60, 80), 90, np.uint8)
    frame = types.SimpleNamespace(uv_raw=torch.tensor([[20.0, 30.0], [60.0, 15.0], [40.0, 40.0]]),
                                  valid=torch.tensor([True, True, False]), mp=torch.tensor([5, -1, 7]))
    canvas = viewer.render_frame(image, frame)
    assert tuple(canvas[30, 24]) == viewer.GREEN and tuple(canvas[30, 20]) == (90, 90, 90)
    assert tuple(canvas[15, 63]) == viewer.BLUE
    assert (canvas[36:45, 36:45] == 90).all()  # invalid: not drawn
    assert np.array_equal(png.read(viewer.draw_frame(image, frame, str(tmp_path / "f.png"))), canvas)


def test_powermon_lifecycle_on_cpu():
    pm = powermon.Powermon(period_s=0.01)
    assert pm.prepare()
    pm.start_async()
    time.sleep(0.1)
    pm.stop_async()
    s = pm.read_sync()
    assert len(pm.samples) >= 2 and isinstance(s, powermon.Sample)
    assert all(x.device_bytes_in_use == 0 for x in pm.samples)  # no card here
    assert all(0.0 <= x.host_cpu_util <= 1.0 for x in pm.samples)
    out = io.StringIO()
    pm.print_stats(file=out)
    assert out.getvalue().startswith(f"powermon: {len(pm.samples)} samples over ")


class _FixedScene:
    """Returns the same image from both tools' calls: what the JAX tool's
    cv2 renderer and the port's torch renderer would give is not at issue
    here, only what the generators do with it."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.cache = {}

    def _img(self, key, w, h):
        if (key, w, h) not in self.cache:
            img = cv2.GaussianBlur(self.rng.uniform(0, 255, (h, w)).astype(np.float32), (0, 0), 2.0)
            self.cache[key, w, h] = np.clip(img * 2 - 128, 0, 255).astype(np.uint8)
        return self.cache[key, w, h]

    def render(self, K, T, w, h, device=None):
        return self._img(("mono", float(T[0, 3])), w, h)

    def render_stereo(self, K, T, baseline, w, h, device=None):
        return self._img(("left", float(T[0, 3])), w, h), self._img(("right", float(T[0, 3])), w, h)

    def render_with_depth(self, K, T, w, h, device=None):
        z = self._img(("depth", float(T[0, 3])), w, h).astype(np.float32) / 40.0
        return self._img(("rgbd", float(T[0, 3])), w, h), z


def _same_files(a, b, names, reader):
    for name in names:
        assert np.array_equal(reader(os.path.join(a, name)), reader(os.path.join(b, name))), name


@pytest.mark.parametrize("stereo", [False, True])
def test_kitti_generator_frames_equal_reference_tool(tmp_path, stereo):
    poses = synthetic.circuit_trajectory(5, radius=2.0)
    Kk = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]])
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    base = 0.537 if stereo else None
    jacc.gen_kitti(jroot, Kk, 160, 120, poses, 0.1, _FixedScene(0), baseline=base)
    tacc.gen_kitti(troot, Kk, 160, 120, poses, 0.1, _FixedScene(0), baseline=base)
    names = [f"image_{c}/{i:06d}.png" for i in range(5) for c in ((0, 1) if stereo else (0,))]
    _same_files(jroot, troot, names, lambda p: cv2.imread(p, cv2.IMREAD_UNCHANGED))
    for name in ("times.txt", "groundtruth.txt"):
        assert open(os.path.join(jroot, name)).read() == open(os.path.join(troot, name)).read()


def test_rgbd_generator_frames_equal_reference_tool(tmp_path):
    poses = synthetic.circuit_trajectory(4, radius=1.8)
    cam = tacc.Camera.create(**tacc.TUM_RGBD, width=96, height=72)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jacc.gen_tum(jroot, tacc._K(tacc.TUM_RGBD), None, 96, 72, poses, 1 / 30.0, depth_factor=5000.0,
                 scene=_FixedScene(1))
    tacc.gen_tum(troot, cam, 96, 72, poses, 1 / 30.0, depth_factor=5000.0, scene=_FixedScene(1))
    names = [ln.split()[1] for ln in open(os.path.join(troot, "rgb.txt"))]
    names += [ln.split()[3] for ln in open(os.path.join(troot, "assoc.txt"))]
    _same_files(jroot, troot, names, lambda p: cv2.imread(p, cv2.IMREAD_UNCHANGED))
    for name in ("rgb.txt", "assoc.txt", "groundtruth.txt"):
        assert open(os.path.join(jroot, name)).read() == open(os.path.join(troot, name)).read()


@pytest.fixture(scope="module")
def tum1_maps():
    cam = tacc.Camera.create(**tacc.TUM1, width=640, height=480)
    K = tacc._K(tacc.TUM1)
    dist = np.array([tacc.TUM1[k] for k in ("k1", "k2", "p1", "p2", "k3")])
    return cam, tacc.distort_maps(cam), jacc._distort_maps(K, dist, 640, 480, tacc.PAD)


def test_lens_maps_converge_and_agree_with_cv2(tum1_maps):
    _, (mx, my, kpad, residual), (jx, jy, jkpad) = tum1_maps
    assert residual < 1e-8
    d = np.hypot(mx.numpy() - jx, my.numpy() - jy)
    assert d.max() < 0.1 and np.median(d) < 1e-3
    np.testing.assert_allclose(kpad, jkpad, atol=1e-4)


def test_distorted_tum_frames_within_remap_tolerance(tmp_path, tum1_maps):
    cam, *_ = tum1_maps
    scene = synthetic.room_scene(np.random.default_rng(5), half_size=4.5, tex_size=256, n_walls=8)
    poses = synthetic.circuit_trajectory(460, radius=1.8, laps=1.25)[::150]
    renders = {}

    class Scene:  # one render of each padded frame, handed to both tools
        def render(self, K, T, w, h, device=None):
            key = float(T[0, 3])
            if key not in renders:
                renders[key] = scene.render(K, T, w, h).numpy()
            return renders[key]

    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    K = tacc._K(tacc.TUM1)
    dist = np.array([tacc.TUM1[k] for k in ("k1", "k2", "p1", "p2", "k3")])
    jacc.gen_tum(jroot, K, dist, 640, 480, poses, 1 / 30.0, scene=Scene())
    tacc.gen_tum(troot, cam, 640, 480, poses, 1 / 30.0, scene=Scene())
    diffs = []
    for ln in open(os.path.join(troot, "rgb.txt")):
        name = ln.split()[1]
        a = cv2.imread(os.path.join(jroot, name), cv2.IMREAD_UNCHANGED).astype(int)
        diffs.append(np.abs(png.read(os.path.join(troot, name)).astype(int) - a))
    diffs = np.stack(diffs)
    print(f"distorted frames, port vs JAX tool: mean {diffs.mean():.4f}, max {diffs.max()}")
    assert diffs.mean() < 0.1 and diffs.max() <= 4
    assert open(os.path.join(jroot, "groundtruth.txt")).read() == open(os.path.join(troot, "groundtruth.txt")).read()


def test_score_and_settings_equal_reference_tool(tmp_path):
    poses = synthetic.circuit_trajectory(120, radius=1.8)
    rng = np.random.default_rng(2)
    gt = [tacc._gt_line(i / 30.0, T) for i, T in enumerate(poses)]
    (tmp_path / "groundtruth.txt").write_text("\n".join(gt) + "\n")
    est = []
    for line in gt[10:60] + gt[64:]:
        v = np.array(line.split(), float)
        v[1:4] = 1.7 * v[1:4] + rng.normal(0, 0.01, 3)
        est.append(" ".join(f"{x:.6f}" for x in v))
    (tmp_path / "traj.txt").write_text("\n".join(est) + "\n")
    assert repr(tacc.score(str(tmp_path), str(tmp_path / "traj.txt"))) == \
        repr(jacc.score(str(tmp_path), str(tmp_path / "traj.txt")))
    for name, make in tacc.CONFIGS.items():
        seq = tmp_path / name
        seq.mkdir()
        (seq / ("times.txt" if "kitti" in name else "rgb.txt")).write_text("")  # a sequence is there
        args = make(str(seq))
        text = open(args[args.index("--settings") + 1]).read()
        jacc.settings_yaml(str(tmp_path / "ref.yaml"), *_settings_args(name))
        assert text == open(tmp_path / "ref.yaml").read(), name


def _settings_args(name):
    """The JAX tool's settings_yaml call of each config, as its config_*
    functions make it."""
    caps = "SLAM.max_keyframes: 256\nSLAM.max_points: 32768\n"
    kitti = (718.856, 718.856, 607.1928, 185.2157, 1241, 376, 10.0, 2000)
    if name == "mono_tum":
        return (517.306408, 516.469215, 318.643040, 255.313989, 640, 480, 30.0, 1000, 0.262383, -0.953104,
                -0.005358, 0.002628, 1.163314, 0.0, caps)
    if name == "mono_kitti":
        return kitti + (0.0, 0.0, 0.0, 0.0, 0.0, 0.0, caps)
    if name == "stereo_kitti":
        return kitti + (0.0, 0.0, 0.0, 0.0, 0.0, 386.1448, caps)
    return (520.908620, 521.007327, 325.141442, 249.701764, 640, 480, 30.0, 1000, 0.0, 0.0, 0.0, 0.0, 0.0,
            40.0, "DepthMapFactor: 5000.0\n" + caps)


@pytest.mark.slow
def test_mono_tum_cut_through_both_clis_on_cpu(tmp_path):
    """chip_smoke.py's CLI path on the CPU, through the JAX CLI as well, on
    the same generated frames."""
    sys.path.insert(0, REPO)
    import chip_smoke

    seq = str(tmp_path / "mono_tum")
    args = tacc.make_mono_tum(seq, n_frames=chip_smoke.CLI_FRAMES)
    for name, main, extra in (("jax", jmain, []), ("port", trun.main, ["--device", "cpu"])):
        traj, diag = str(tmp_path / f"{name}_traj.txt"), str(tmp_path / f"{name}_diag.csv")
        assert main(args + ["--save-tum", traj, "--diag", diag] + extra) == 0
        ok = [r["state"] == "OK" for r in csv.DictReader(open(diag))]
        first = ok.index(True)
        ate, extent, n, extras = tacc.score(seq, traj)
        print(f"{name}: first pose {first}, tracked from it {sum(ok[first:]) / len(ok[first:]):.4f}, "
              f"ATE {ate:.4f} m ({100 * ate / extent:.3f}% of {extent:.2f} m), {n} scored, {extras}")
        assert first < chip_smoke.CLI_FIRST_POSE_BY
        assert sum(ok[first:]) >= 0.85 * len(ok[first:])
        assert ate <= chip_smoke.CLI_ATE_GATE
