"""Parity of the port's tracking step with the JAX package on a snapshot:
the JAX System runs 15 frames of the end-to-end orbit fixture, then both
packages track the next frame from the same converted state. Tolerances:
state-machine scalars and bindings exact, poses within 1e-4, visibility
counters within 1e-5.

Feature 0 of the tracked frame is marked invalid for both packages in the
parity tests: the reference's motion-model scatter clips unmatched rows
onto feature 0 and so erases a genuine match to it (tracking.py:133-141);
the port keeps that match. test_motion_model_keeps_match_to_feature0
records the difference on the unmodified frame (ROADMAP queue 3)."""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine import tracking as jtr
from orb_slam_cuda_tpu.engine.system import Sensor as JSensor
from orb_slam_cuda_tpu.engine.system import System as JSystem
from orb_slam_cuda_tpu.engine.system import SystemConfig as JConfig
from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu_torch.engine import tracking as ttr
from orb_slam_cuda_tpu_torch.utils import convert
from torch_parity import assert_same, to_np

torch.set_num_threads(2)
W, H = 320, 240
SF = tuple(1.2**i for i in range(8))


@pytest.fixture(scope="module")
def snapshot():
    rng = np.random.default_rng(42)
    cam = jcam.Camera.create(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
    scene = jsyn.PlanarScene.default(rng, depth=5.0, second_depth=8.0, extent=12.0, tex_size=768)
    poses = jsyn.orbit_trajectory(40, radius=0.6)
    slam = JSystem(JConfig(camera=cam, sensor=JSensor.MONOCULAR, n_features=600, max_keyframes=64,
                           max_points=8192, enable_loop_closing=False, max_frames_between_kf=10))
    K = np.asarray(cam.K)
    for i in range(15):
        slam.track_monocular(scene.render(K, poses[i], W, H), i * 0.1)
    assert slam.tracking_state.name == "OK" and len(slam.kf_order) >= 2
    raw = slam._frame_fn(scene.render(K, poses[15], W, H), slam.vocab)
    frame = raw._replace(valid=raw.valid.at[0].set(False))
    lf = slam.last_frame
    pose_pred = (slam.velocity @ slam.last_pose if slam.velocity is not None else slam.last_pose)
    min_obs = 3 if len(slam.kf_order) > 2 else 2
    jargs = dict(state=slam.state, frame=frame, pose_pred=pose_pred.astype(np.float32),
                 pose_last=slam.last_pose.astype(np.float32), lf=lf, ref_kf=slam.ref_kf, min_obs=min_obs)
    targs = dict(state=convert.map_state(slam.state), frame=convert.frame_data(frame),
                 pose_pred=torch.as_tensor(pose_pred, dtype=torch.float32),
                 pose_last=torch.as_tensor(slam.last_pose, dtype=torch.float32),
                 lf=convert.frame_data(lf), ref_kf=slam.ref_kf, min_obs=min_obs)
    jargs["raw"], targs["raw"] = raw, convert.frame_data(raw)
    return cam, convert.camera(cam), jargs, targs


def test_full_track_step(snapshot):
    jc, tc, ja, ta = snapshot
    lj, lt = ja["lf"], ta["lf"]
    rj = jtr.full_track_step(ja["state"], ja["frame"], ja["pose_pred"], ja["pose_last"],
                             lj.uv, lj.oct, lj.ang, lj.bip, lj.mp, lj.depth,
                             np.int32(ja["ref_kf"]), np.int32(ja["min_obs"]), jc,
                             np.asarray(SF, np.float32), 15.0, np.float32(0), np.float32(0))
    rt = ttr.full_track_step(ta["state"], ta["frame"], ta["pose_pred"], ta["pose_last"],
                             lt.uv, lt.oct, lt.ang, lt.bip, lt.mp, lt.depth,
                             ta["ref_kf"], ta["min_obs"], tc, SF, 15.0)
    vj, vt = to_np(rj.host_vec), to_np(rt.host_vec)
    np.testing.assert_array_equal(vj[:9], vt[:9], err_msg="state-machine scalars")
    assert vt[0] == 1, "fixture frame should track"
    np.testing.assert_allclose(vj[9:25], vt[9:25], atol=1e-4, err_msg="frame pose")
    np.testing.assert_allclose(vj[25:41], vt[25:41], atol=1e-6, err_msg="reference keyframe pose")
    assert_same(rj.mp, rt.mp, what="bindings")
    assert_same(rj.mp_visible, rt.mp_visible, rtol=1e-5, atol=1e-5)
    assert_same(rj.mp_found, rt.mp_found, rtol=1e-5, atol=1e-5)


def test_tracking_stages(snapshot):
    jc, tc, ja, ta = snapshot
    lj, lt = ja["lf"], ta["lf"]
    sj, st, fj, ft = ja["state"], ta["state"], ja["frame"], ta["frame"]
    mm_j = jtr.track_motion_model(sj, fj, ja["pose_pred"], lj.uv, lj.oct, lj.ang, lj.bip, lj.mp,
                                  lj.depth, ja["pose_last"], jc, np.asarray(SF, np.float32), 15.0)
    mm_t = ttr.track_motion_model(st, ft, ta["pose_pred"], lt.uv, lt.oct, lt.ang, lt.bip, lt.mp,
                                  lt.depth, ta["pose_last"], tc, SF, 15.0)
    assert_same(mm_j[0], mm_t[0], rtol=0, atol=1e-4, what="motion-model pose")
    for a, b, what in zip(mm_j[1:], mm_t[1:], ("bindings", "n_matches", "n_inliers")):
        assert_same(a, b, what=what)
    ref = ja["ref_kf"]
    rk_j = jtr.track_reference_kf(sj, fj, ja["pose_last"], ref, jc, np.asarray(SF, np.float32))
    rk_t = ttr.track_reference_kf(st, ft, ta["pose_last"], ref, tc, SF)
    assert_same(rk_j[0], rk_t[0], rtol=0, atol=1e-4, what="ref-KF pose")
    for a, b, what in zip(rk_j[1:], rk_t[1:], ("bindings", "n_matches", "n_inliers")):
        assert_same(a, b, what=what)
    lm_j = jtr.assemble_local_map(sj, mm_j[1])
    lm_t = ttr.assemble_local_map(st, mm_t[1])
    for a, b, what in zip(lm_j, lm_t, ("kf mask", "pt mask", "ref kf")):
        assert_same(a, b, what=what)
    tl_j = jtr.track_local_map(sj, fj._replace(mp=mm_j[1]), mm_j[0], lm_j[1], jc,
                               np.asarray(SF, np.float32), 1.0)
    tl_t = ttr.track_local_map(st, ft._replace(mp=mm_t[1]), mm_t[0], lm_t[1], tc, SF, 1.0)
    assert_same(tl_j[0], tl_t[0], rtol=0, atol=1e-4, what="local-map pose")
    for a, b, what in zip(tl_j[1:], tl_t[1:], ("bindings", "n_inliers", "n_visible", "visible")):
        assert_same(a, b, what=what)
    for min_obs in (2, 3):
        assert_same(jtr.count_ref_tracked(sj, ref, min_obs), ttr.count_ref_tracked(st, ref, min_obs))


def test_motion_model_keeps_match_to_feature0(snapshot):
    """On the unmodified frame the motion model matches feature 0. The port
    binds it; the reference's clipped scatter writes -1 back over it."""
    jc, tc, ja, ta = snapshot
    lj, lt = ja["lf"], ta["lf"]
    args_j = (ja["state"], ja["raw"], ja["pose_pred"], lj.uv, lj.oct, lj.ang, lj.bip, lj.mp,
              lj.depth, ja["pose_last"], jc, np.asarray(SF, np.float32), 15.0)
    args_t = (ta["state"], ta["raw"], ta["pose_pred"], lt.uv, lt.oct, lt.ang, lt.bip, lt.mp,
              lt.depth, ta["pose_last"], tc, SF, 15.0)
    _, mp_j, nm_j, _ = jtr.track_motion_model(*args_j)
    _, mp_t, nm_t, _ = ttr.track_motion_model(*args_t)
    assert int(nm_j) == int(nm_t)
    bj, bt = to_np(mp_j), to_np(mp_t)
    assert bt[0] >= 0 and bj[0] == -1
    np.testing.assert_array_equal(bj[1:], bt[1:])
