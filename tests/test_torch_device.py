"""The port's System on a CUDA device against the same System on the CPU,
by outcome, on the 40-frame end-to-end orbit fixture rendered with the
port's own renderer: both track > 85% of frames with ATE < 0.10 m,
keyframe counts agree within max(2, 25%), relocalization counts agree,
the map stays on the card and every frame's 8 pyramid levels went
through the FAST kernel in one launch. Also: the renderer on the card equals it on the
CPU, and the LoopCloser on a CUDA drifted-ring map closes the same loop
as on the CPU, poses within 1e-3 after correction and global BA; Systems
of the depth sensors built with no device land on the card, initialize
from one frame and launch the kernel twice a stereo frame, once an RGB-D
frame; match_stereo on the card gives the CPU's depth mask, depths within
1e-3 relative; the CLI (`run.main` with no --device) runs on the card
with one launch a frame, writing its frames with the port's PNG writer,
and powermon reads the card's bytes in use; the System at
`pipeline_lag=3` tracks the orbit on the card with one launch a frame, one
more pipelined step runs under `torch.cuda.set_sync_debug_mode("error")`
without raising, and a local BA on its final map, solved twice, gives
torch.equal results. Marked
`cuda`; imports no JAX, so it runs with

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_device.py
"""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu_torch.engine import System, SystemConfig
from orb_slam_cuda_tpu_torch.engine.loop_closing import LoopCloser
from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.ops import fast_kernel
from orb_slam_cuda_tpu_torch.utils import synthetic
from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

torch.set_num_threads(2)
W, H = 320, 240
CAM = dict(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
CFG = dict(n_features=600, max_keyframes=64, max_points=8192, enable_loop_closing=False,
           max_frames_between_kf=10)


def _orbit():
    scene = synthetic.PlanarScene.default(np.random.default_rng(42), depth=5.0, second_depth=8.0,
                                          extent=12.0, tex_size=768)
    poses = synthetic.orbit_trajectory(40, radius=0.6)
    K = np.asarray(Camera.create(**CAM).K)
    return poses, [scene.render(K, T, W, H) for T in poses]


def _run(device, poses, images, **kw):
    slam = System(SystemConfig(camera=Camera.create(**CAM), **dict(CFG, **kw)), device=device)
    for i, img in enumerate(images):
        slam.track_monocular(img, i * 0.1)
    ts, est = camera_centers(slam.get_trajectory())
    gt = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    return slam, ate_rmse(est, np.asarray([gt[round(t, 6)] for t in ts]))


@pytest.mark.cuda
def test_system_on_card_matches_cpu_by_outcome(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FAST kernel has no CPU or interpret mode")
    poses, images = _orbit()
    cpu, cpu_ate = _run("cpu", poses, images)
    fast_kernel.launches = 0
    gpu, gpu_ate = _run("cuda", poses, images)
    assert fast_kernel.launches == len(images)
    print(f"cpu: tracked {cpu.tracked_ratio():.3f} ATE {cpu_ate:.4f} kfs {cpu.stats.n_keyframes}; "
          f"cuda: tracked {gpu.tracked_ratio():.3f} ATE {gpu_ate:.4f} kfs {gpu.stats.n_keyframes} "
          f"n_reloc {gpu.stats.n_reloc}")
    for slam, ate in ((cpu, cpu_ate), (gpu, gpu_ate)):
        assert slam.tracked_ratio() > 0.85 and ate < 0.10
    assert gpu.stats.n_reloc == cpu.stats.n_reloc
    kc, kg = cpu.stats.n_keyframes, gpu.stats.n_keyframes
    assert abs(kc - kg) <= max(2, 0.25 * kc)
    st = gpu.state
    assert all(getattr(st, f).device.type == "cuda" for f in st._fields)
    bound = st.kf_mp[st.kf_mp >= 0].long()
    assert bool(st.mp_valid[bound].all())
    assert sorted(gpu.kf_order) == torch.nonzero(st.kf_valid).flatten().tolist()
    path = tmp_path / "traj.txt"
    gpu.save_trajectory_tum(str(path))
    assert len(path.read_text().splitlines()) == sum(ok for _, _, ok in gpu.get_trajectory())


@pytest.mark.cuda
def test_synchronous_mapping_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FAST kernel has no CPU or interpret mode")
    poses, images = _orbit()
    slam, ate = _run("cuda", poses[:25], images[:25], async_mapping=False)
    assert slam.tracked_ratio() > 0.85 and ate < 0.10
    assert not slam._bg
    slam.reset()
    assert slam.tracking_state.name == "NO_IMAGES_YET" and slam.state.kf_valid.device.type == "cuda"


@pytest.fixture(scope="module")
def pipelined_on_card():
    """The orbit through the System at pipeline_lag=3 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FAST kernel has no CPU or interpret mode")
    poses, images = _orbit()
    fast_kernel.launches = 0
    slam, ate = _run("cuda", poses, images, pipeline_lag=3)
    return slam, ate, fast_kernel.launches, images


@pytest.mark.cuda
def test_pipelined_system_on_card(pipelined_on_card):
    slam, ate, launches, images = pipelined_on_card
    print(f"lag 3 on the card: tracked {slam.tracked_ratio():.3f} ATE {ate:.4f} kfs {slam.stats.n_keyframes}")
    assert launches == len(images)
    assert slam.tracked_ratio() > 0.85 and ate < 0.10
    assert not slam._pending and slam.stats.n_frames == len(images)


@pytest.mark.cuda
def test_pipelined_step_does_not_synchronize(pipelined_on_card):
    slam, _, _, images = pipelined_on_card
    if slam._carry is None:
        slam._carry = slam._make_carry()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, res, carry, host, copied = slam._dispatch_pipelined(images[-1], 3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    copied.synchronize()
    assert bool(torch.isfinite(host).all()) and carry.ref_kf.device.type == "cuda"


@pytest.mark.cuda
def test_local_ba_repeats_on_card(pipelined_on_card):
    from orb_slam_cuda_tpu_torch.engine.local_mapping import gather_local_ba_problem
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba

    slam = pipelined_on_card[0]
    m = slam.mapper
    problem, _, _ = gather_local_ba_problem(slam.state, slam.kf_order[-1], slam.cam, m.level_inv_sigma2,
                                            n_local=m.lba_local, n_fixed=m.lba_fixed, n_points=m.lba_points)
    a = ba.bundle_adjust(problem, slam.cam, lm_iters=10, cg_iters=15)
    b = ba.bundle_adjust(problem, slam.cam, lm_iters=10, cg_iters=15)
    for f in ba.BAResult._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the FAST kernel has no CPU or interpret mode")


@pytest.mark.cuda
def test_render_on_card_equals_cpu():
    _need_card()
    rng = np.random.default_rng(5)
    scene = synthetic.room_scene(rng, half_size=9.0, tex_size=384, n_walls=8)
    scene.planes.extend(synthetic.ring_obstacles(rng, 10, 7.0, tex_size=128))
    poses = synthetic.circuit_trajectory(40, radius=5.0, laps=1.3)
    K = np.asarray(Camera.create(**CAM).K)
    for f in (0, 13, 31):
        gpu = scene.render(K, poses[f], W, H, device="cuda")
        assert gpu.device.type == "cuda"
        assert torch.equal(gpu.cpu(), scene.render(K, poses[f], W, H))


@pytest.mark.cuda
def test_loop_closer_on_card_matches_cpu():
    """DetectLoop -> ComputeSim3 -> CorrectLoop -> global BA on the ring,
    keyframe after keyframe, on both devices."""
    import torch_ring

    _need_card()
    out = {}
    for dev in ("cpu", "cuda"):
        st, db, *_, vocab = torch_ring.build_drifted_ring(np.random.default_rng(0), device=dev)
        lc = LoopCloser(torch_ring.CFG, torch_ring.CAM, vocab)
        for k in (12, 13, 14, 15, 15):
            st, db = lc.process(st, db, k, list(range(16)))
        assert all(getattr(st, f).device.type == dev for f in st._fields)
        out[dev] = (lc.loop_edges, lc.n_loops_closed, st.kf_pose.cpu(), st.mp_xyz.cpu(), st.mp_valid.cpu())
    (e_c, n_c, pose_c, xyz_c, ok_c), (e_g, n_g, pose_g, xyz_g, ok_g) = out["cpu"], out["cuda"]
    assert e_c == e_g == [(0, 15)] and n_c == n_g == 1
    torch.testing.assert_close(pose_g, pose_c, rtol=1e-3, atol=1e-3)
    assert torch.equal(ok_g, ok_c)
    torch.testing.assert_close(xyz_g[ok_c], xyz_c[ok_c], rtol=1e-3, atol=1e-3)


STEREO_CAM = dict(CAM, bf=260.0 * 0.2)


def _stereo_frames(n):
    scene = synthetic.PlanarScene.default(np.random.default_rng(0), depth=5.0, second_depth=8.0,
                                          extent=12.0, tex_size=768)
    K = np.asarray(Camera.create(**STEREO_CAM).K)
    poses = synthetic.orbit_trajectory(20, radius=0.5)[:n]
    return scene, K, poses


@pytest.mark.cuda
def test_depth_sensors_land_on_card():
    """track_stereo and track_rgbd through Systems built with no device."""
    from orb_slam_cuda_tpu_torch.engine import Sensor

    _need_card()
    scene, K, poses = _stereo_frames(4)
    cfg = dict(CFG, stereo_init_min_features=300, kf_ref_ratio=1.1, max_frames_between_kf=8)
    for sensor, per_frame in ((Sensor.STEREO, 2), (Sensor.RGBD, 1)):
        slam = System(SystemConfig(camera=Camera.create(**STEREO_CAM), sensor=sensor, **cfg))
        assert slam.device.type == "cuda"
        fast_kernel.launches = 0
        for i, T in enumerate(poses):
            if sensor == Sensor.STEREO:
                pose = slam.track_stereo(*scene.render_stereo(K, T, 0.2, W, H, device="cuda"), i * 0.1)
            else:
                pose = slam.track_rgbd(*scene.render_with_depth(K, T, W, H, device="cuda"), i * 0.1)
            assert pose is not None, (sensor, i)
        assert fast_kernel.launches == per_frame * len(poses)
        st = slam.state
        assert all(getattr(st, f).device.type == "cuda" for f in st._fields)
        lf = slam.last_frame
        assert lf.depth.device.type == "cuda" and int((lf.depth > 0).sum()) > 0.5 * int(lf.valid.sum())


@pytest.mark.cuda
def test_match_stereo_on_card_matches_cpu():
    """5 stereo frames: the same features (extracted on the CPU) matched on
    both devices, with the SAD refinement."""
    from orb_slam_cuda_tpu_torch.engine import stereo
    from orb_slam_cuda_tpu_torch.frontend.extractor import ExtractorConfig, ORBExtractor
    from orb_slam_cuda_tpu_torch.ops import hamming

    _need_card()
    scene, K, poses = _stereo_frames(5)
    cam = Camera.create(**STEREO_CAM)
    ext = ORBExtractor(ExtractorConfig(n_features=600), H, W, device="cpu")
    sf = tuple(1.2**i for i in range(8))
    for T in poses:
        left, right = scene.render_stereo(K, T, 0.2, W, H)
        lf, rf = ext(left), ext(right)
        out = {}
        for dev in ("cpu", "cuda"):
            l, r = [type(f)(*[t.to(dev) for t in f]) for f in (lf, rf)]
            ur, depth = stereo.match_stereo(
                l.uv, l.octave, hamming.bipolar(l.desc), l.valid, r.uv, r.octave, hamming.bipolar(r.desc),
                r.valid, cam, sf, left_img=left.to(dev), right_img=right.to(dev))
            assert depth.device.type == dev
            out[dev] = (ur.cpu(), depth.cpu())
        mask = out["cpu"][1] > 0
        assert torch.equal(mask, out["cuda"][1] > 0) and int(mask.sum()) > 0.5 * int(lf.valid.sum())
        torch.testing.assert_close(out["cuda"][1][mask], out["cpu"][1][mask], rtol=1e-3, atol=0)
        torch.testing.assert_close(out["cuda"][0][mask], out["cpu"][0][mask], rtol=1e-3, atol=0)


@pytest.mark.cuda
def test_cli_runs_on_card_by_default(tmp_path):
    """`run.main` with no --device tracks a KITTI-format sequence on the
    card, one FAST launch a frame; powermon sees the bytes on the card."""
    from orb_slam_cuda_tpu_torch import run
    from orb_slam_cuda_tpu_torch.io import png
    from orb_slam_cuda_tpu_torch.utils import powermon

    _need_card()
    poses, images = _orbit()
    n = 12
    seq = tmp_path / "seq"
    (seq / "image_0").mkdir(parents=True)
    for i in range(n):
        png.write(str(seq / "image_0" / f"{i:06d}.png"), images[i].numpy())
    (seq / "times.txt").write_text("".join(f"{i * 0.1:.6f}\n" for i in range(n)))
    settings = tmp_path / "settings.yaml"
    settings.write_text("%YAML:1.0\n" + "".join(f"Camera.{k}: {v}\n" for k, v in CAM.items())
                        + "ORBextractor.nFeatures: 600\nCamera.fps: 10.0\nSLAM.max_keyframes: 64\n"
                        "SLAM.max_points: 8192\nSLAM.enable_loop_closing: 0\n")
    pm = powermon.Powermon(period_s=0.05)
    pm.prepare()
    pm.start_async()
    fast_kernel.launches = 0
    try:
        rc = run.main(["--dataset", "kitti", "--sensor", "mono", "--sequence", str(seq), "--settings",
                       str(settings), "--save-tum", str(tmp_path / "traj.txt")])
    finally:
        pm.stop_async()
    assert rc == 0 and fast_kernel.launches == n
    rows = np.loadtxt(tmp_path / "traj.txt", ndmin=2)
    assert len(rows) >= n - 4 and np.isfinite(rows).all()
    assert max(s.device_bytes_in_use for s in pm.samples) > 0  # sampled while the run held its map
