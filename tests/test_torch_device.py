"""The port's System on a CUDA device against the same System on the CPU,
by outcome, on the 40-frame end-to-end orbit fixture rendered with the
port's own renderer: both track > 85% of frames with ATE < 0.10 m,
keyframe counts agree within max(2, 25%), relocalization counts agree,
the map stays on the card and every frame's 8 pyramid levels went
through the FAST kernel in one launch. Also: the renderer on the card equals it on the
CPU, and the LoopCloser on a CUDA drifted-ring map closes the same loop
as on the CPU, poses within 1e-3 after correction and global BA. Marked
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
