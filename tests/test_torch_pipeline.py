"""Pipelined tracking of the port against the JAX package.

The step: the JAX System runs 15 frames of the end-to-end orbit fixture;
its host state gives one `TrackCarry`, converted for the port, and both
`fused_pipeline_step`s take frame 15 from it. The extraction is the JAX
extractor's output fed to both (the extractors agree only to >= 95% of
descriptor rows, test_torch_frontend.py); both `build_frame_fn`s build
the frame and mark feature 0 invalid, as the other parity tests do
(ROADMAP queue 3, "by design"). Four cases: the motion model holds; a
0.2 rad yaw added to the carried velocity makes the motion model widen
its window; 0.3 rad makes it fall back to the reference keyframe; a blank
image fails the step. Scalars, bindings and the carry's bindings,
octaves, angles, descriptors, depths and reference keyframe exact; poses
and the carry's undistorted keypoints (float32 arithmetic that XLA fuses
its own way) within 1e-4; visibility counters within 1e-5.
The port's sync-free step equals its synchronous `full_track_step`
exactly in every case, and queues the whole frame without an op that
reads a value back to the host; so do the System's other per-frame
programs (the monocular, stereo and RGB-D frames and the lag-0 tracking
step), which the card captures as CUDA graphs.

The System: `pipeline_lag=2` on the 40-frame orbit through both packages
with strict lag on both sides (nothing retires before two frames are in
flight unless tracking is at risk), compared by outcome as
test_torch_system.py compares the synchronous runs: tracked ratio > 0.85
and ATE < 0.10 m in both, keyframes within max(2, 25%). Also: status and
trajectory retire the frames in flight, reset drops them, and (slow) the
pipelined blackout of tests/test_end_to_end.py recovers."""

import os
import traceback

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from orb_slam_cuda_tpu.engine import tracking as jtr
from orb_slam_cuda_tpu.engine.frame import build_frame as jbuild_frame
from orb_slam_cuda_tpu.engine.system import Sensor as JSensor
from orb_slam_cuda_tpu.engine.system import System as JSystem
from orb_slam_cuda_tpu.engine.system import SystemConfig as JConfig
from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
from orb_slam_cuda_tpu_torch.engine import tracking as ttr
from orb_slam_cuda_tpu_torch.engine.frame import build_frame as tbuild_frame
from orb_slam_cuda_tpu_torch.geometry import se3
from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.slam_map import ops as map_ops
from orb_slam_cuda_tpu_torch.utils import convert
from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers
from torch_parity import assert_same, to_np

torch.set_num_threads(2)
W, H = 320, 240
SF = tuple(1.2**i for i in range(8))
CAM = dict(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
CFG = dict(n_features=600, max_keyframes=64, max_points=8192, enable_loop_closing=False,
           max_frames_between_kf=10)
# Yaw (rad) added to the carried velocity, and whether the frame is blank.
CASES = {"motion_model": (0.0, False), "widened": (0.2, False), "fallback": (0.3, False),
         "fails": (0.0, True)}


def _drop_feature0(frame):
    return frame._replace(valid=frame.valid.at[0].set(False))


@pytest.fixture(scope="module")
def snapshot():
    rng = np.random.default_rng(42)
    cam = jcam.Camera.create(**CAM)
    scene = jsyn.PlanarScene.default(rng, depth=5.0, second_depth=8.0, extent=12.0, tex_size=768)
    poses = jsyn.orbit_trajectory(40, radius=0.6)
    slam = JSystem(JConfig(camera=cam, sensor=JSensor.MONOCULAR, **CFG))
    K = np.asarray(cam.K)
    for i in range(15):
        slam.track_monocular(scene.render(K, poses[i], W, H), i * 0.1)
    assert slam.tracking_state.name == "OK" and len(slam.kf_order) >= 2
    min_obs = 3 if len(slam.kf_order) > 2 else 2
    sf = np.asarray(SF, np.float32)
    voc = slam.vocab

    def jstep(state, image, carry, feats):
        return jtr.fused_pipeline_step(state, image, carry, min_obs, lambda _: feats,
                                       lambda f: _drop_feature0(jbuild_frame(f, cam, voc)), cam, sf, 15.0)

    jfn = jax.jit(jstep)
    tcam, tvoc = convert.camera(cam), convert.vocabulary(voc)

    def tbuild(feats):
        frame = tbuild_frame(feats, tcam, tvoc)
        valid = frame.valid.clone()
        valid[0] = False
        return frame._replace(valid=valid)

    images = {False: scene.render(K, poses[15], W, H), True: np.zeros((H, W), np.uint8)}
    return dict(slam=slam, jfn=jfn, carry=slam._make_carry(), images=images, min_obs=min_obs,
                tcam=tcam, tbuild=tbuild, tstate=convert.map_state(slam.state))


def _case(snap, name):
    """(image, JAX features, JAX carry, port features, port carry)."""
    yaw, blank = CASES[name]
    image = snap["images"][blank]
    jfeats = snap["slam"].extractor(image)
    jcarry = snap["carry"]
    if yaw:
        xi = np.zeros(6, np.float32)
        xi[4] = yaw
        turn = se3.exp(torch.as_tensor(xi)).numpy()
        jcarry = jcarry._replace(vel=jax.numpy.asarray(turn @ np.asarray(jcarry.vel)))
    return image, jfeats, jcarry, convert.features(jfeats), convert.track_carry(jcarry)


def _port_step(snap, tfeats, tcarry, step=ttr.fused_pipeline_step):
    return step(snap["tstate"], None, tcarry, snap["min_obs"], lambda _: tfeats, snap["tbuild"],
                snap["tcam"], torch.as_tensor(SF, dtype=torch.float32), 15.0)


@pytest.mark.parametrize("name", list(CASES))
def test_fused_pipeline_step_matches_reference(snapshot, name):
    image, jfeats, jcarry, tfeats, tcarry = _case(snapshot, name)
    jframe, jres, jnext = snapshot["jfn"](snapshot["slam"].state, image, jcarry, jfeats)
    tframe, tres, tnext = _port_step(snapshot, tfeats, tcarry)
    sj, st = to_np(jres.scalars), to_np(tres.scalars)
    print(f"{name}: scalars {st.tolist()}")
    np.testing.assert_array_equal(sj, st, err_msg="state-machine scalars")
    ok, used_fallback, n_m1 = st[0], st[6], st[4]
    if name == "fails":
        assert ok == 0
    else:
        assert ok == 1 and used_fallback == (name == "fallback")
    if name == "widened":
        narrow = ttr.track_motion_model(
            snapshot["tstate"], tframe, tcarry.vel @ tcarry.pose, tcarry.uv, tcarry.oct, tcarry.ang,
            tcarry.bip, map_ops.sanitize_bindings(snapshot["tstate"], tcarry.mp), tcarry.depth,
            tcarry.pose, snapshot["tcam"], SF, 15.0)
        assert int(narrow[2]) < ttr.MIN_MATCHES_MOTION <= n_m1, "the widened retry did not fire"
    assert_same(jres.mp, tres.mp, what="bindings")
    assert_same(jres.pose, tres.pose, rtol=0, atol=1e-4, what="pose")
    assert_same(jres.host_vec, tres.host_vec, rtol=0, atol=1e-4, what="host vector")
    assert_same(jres.mp_visible, tres.mp_visible, rtol=1e-5, atol=1e-5)
    assert_same(jres.mp_found, tres.mp_found, rtol=1e-5, atol=1e-5)
    for f in ("oct", "ang", "bip", "depth", "mp", "ref_kf"):
        assert_same(getattr(jnext, f), getattr(tnext, f), what=f"carry {f}")
    # The undistorted keypoints: float32 arithmetic that XLA fuses its own way.
    for f in ("uv", "pose", "vel"):
        assert_same(getattr(jnext, f), getattr(tnext, f), rtol=0, atol=1e-4, what=f"carry {f}")


@pytest.mark.parametrize("name", list(CASES))
def test_sync_free_step_equals_sync_step(snapshot, name):
    _, _, _, tfeats, tcarry = _case(snapshot, name)
    frame = snapshot["tbuild"](tfeats)
    args = (snapshot["tstate"], frame, tcarry.vel @ tcarry.pose, tcarry.pose, tcarry.uv, tcarry.oct,
            tcarry.ang, tcarry.bip, tcarry.mp, tcarry.depth)
    tail = (snapshot["min_obs"], snapshot["tcam"], SF, 15.0)
    sync = ttr.full_track_step(*args, int(tcarry.ref_kf), *tail)
    free = ttr.full_track_step_sync_free(*args, tcarry.ref_kf, *tail)
    for f in ttr.FullStepResult._fields:
        assert torch.equal(getattr(sync, f), getattr(free, f)), f


# Ops that read a device value back to the host, or copy host data to the
# device (which waits for the stream), when their tensors are on CUDA:
# `lift_fresh` is a tensor made from host data, `torch.as_tensor(list)` or
# the scalar of `x[i] = 1.0`.
_SYNCING = {"_local_scalar_dense", "is_nonzero", "item", "nonzero", "nonzero_static", "masked_select",
            "_linalg_check_errors", "lift_fresh", "lift_fresh_copy", "unique", "_unique2",
            "repeat_interleave", "bincount", "_assert_async"}


def _port_line():
    """The innermost line of the port on the stack."""
    frames = [f for f in traceback.extract_stack() if "orb_slam_cuda_tpu_torch" in f.filename]
    return f"{os.path.basename(frames[-1].filename)}:{frames[-1].lineno}: {frames[-1].line}" if frames else "?"


class _SyncSpy(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bool_index = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in (args[1] or ()))
        if name in _SYNCING or bool_index:
            self.hits.append(f"{func} at {_port_line()}")
        return func(*args, **(kwargs or {}))


def test_pipelined_step_reads_nothing_back(snapshot):
    """The whole step, the port's own extraction and frame build included,
    with the scale factors already a tensor as the System passes them."""
    from orb_slam_cuda_tpu_torch.frontend.extractor import ExtractorConfig, ORBExtractor

    image, _, _, _, tcarry = _case(snapshot, "widened")
    extractor = ORBExtractor(ExtractorConfig(n_features=600), H, W, device="cpu")
    img = extractor.upload(image)
    sf = torch.as_tensor(SF, dtype=torch.float32)
    tvoc = convert.vocabulary(snapshot["slam"].vocab)
    spy = _SyncSpy()
    with spy:
        _, res, carry = ttr.fused_pipeline_step(
            snapshot["tstate"], img, tcarry, snapshot["min_obs"], extractor._extract_impl,
            lambda f: tbuild_frame(f, snapshot["tcam"], tvoc), snapshot["tcam"], sf, 15.0)
    assert not spy.hits, sorted(set(spy.hits))
    assert res.host_vec.shape == (41,) and carry.ref_kf.shape == ()


@pytest.mark.parametrize("program", ["frame", "track", "stereo_frame", "rgbd_frame"])
def test_lag0_programs_read_nothing_back(snapshot, program):
    """The System's other per-frame programs, as the card captures them:
    the monocular frame (extraction and frame build), the lag-0 tracking
    step with its tensor inputs (poses, reference keyframe, min_obs,
    th_depth, vo_th_depth), and the stereo and RGB-D frames (both
    extractions and the stereo match; extraction and the depth lookup)."""
    sensor = {"stereo_frame": Sensor.STEREO, "rgbd_frame": Sensor.RGBD}.get(program, Sensor.MONOCULAR)
    cam = Camera.create(**CAM, bf=0.0 if sensor == Sensor.MONOCULAR else 40.0)
    slam = System(SystemConfig(camera=cam, sensor=sensor, **CFG), device="cpu")
    image = snapshot["images"][False]
    img = slam.extractor.upload(image)
    if program == "frame":
        args = (img,)
    elif program == "stereo_frame":
        args = (img, slam.extractor.upload(np.ascontiguousarray(np.roll(image, -8, axis=1))))
    elif program == "rgbd_frame":
        args = (img, torch.full((H, W), 5, dtype=torch.int32))
    else:
        _, _, _, tfeats, tcarry = _case(snapshot, "widened")
        last = (tcarry.uv, tcarry.oct, tcarry.ang, tcarry.bip, tcarry.mp, tcarry.depth)
        args = (snapshot["tstate"], snapshot["tbuild"](tfeats), tcarry.vel @ tcarry.pose, tcarry.pose, last,
                tcarry.ref_kf, torch.tensor(snapshot["min_obs"]), torch.tensor(0.0), torch.tensor(0.0))
    fn = getattr(slam, f"_{program}_fn")
    spy = _SyncSpy()
    with spy:
        out = fn(*args)
    assert not spy.hits, sorted(set(spy.hits))
    if program == "track":
        assert out.host_vec.shape == (41,)
    else:
        assert out.uv.shape == (slam.cfg.n_features, 2)


def test_track_carry_converts(snapshot):
    jcarry = snapshot["carry"]
    tcarry = convert.track_carry(jcarry)
    assert tcarry.ref_kf.dtype == torch.int64 and tcarry.ref_kf.shape == ()
    for f in ttr.TrackCarry._fields:
        assert_same(getattr(jcarry, f), getattr(tcarry, f), what=f)


# ---------------------------------------------------------------------------
# The System


@pytest.fixture(scope="module")
def orbit():
    rng = np.random.default_rng(42)
    scene = jsyn.PlanarScene.default(rng, depth=5.0, second_depth=8.0, extent=12.0, tex_size=768)
    poses = jsyn.orbit_trajectory(40, radius=0.6)
    K = np.asarray(jcam.Camera.create(**CAM).K)
    return poses, [scene.render(K, T, W, H) for T in poses]


def _ate(slam, poses):
    ts, est = camera_centers(slam.get_trajectory())
    gt = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    return ate_rmse(est, np.asarray([gt[round(t, 6)] for t in ts]))


class _NotReady:
    """A JAX host vector that never reports itself ready, so the JAX
    System retires a frame only at the lag or at risk."""

    def __init__(self, vec):
        self.vec = vec

    def is_ready(self):
        return False

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self.vec)
        return a if dtype is None else a.astype(dtype)


def _strict_jax(slam):
    pipe = slam._pipe_fn

    def strict(*args):
        frame, res, carry = pipe(*args)
        return frame, res._replace(host_vec=_NotReady(res.host_vec)), carry

    slam._pipe_fn = strict
    return slam


def _strict_port(slam):
    slam._readback_ready = lambda entry: False
    return slam


def _tsystem(**kw):
    return System(SystemConfig(camera=Camera.create(**CAM), sensor=Sensor.MONOCULAR, **dict(CFG, **kw)),
                  device="cpu")


def test_pipelined_system_matches_reference_by_outcome(orbit):
    poses, images = orbit
    jslam = _strict_jax(JSystem(JConfig(camera=jcam.Camera.create(**CAM), sensor=JSensor.MONOCULAR,
                                        pipeline_lag=2, **CFG)))
    tslam = _strict_port(_tsystem(pipeline_lag=2))
    for slam in (jslam, tslam):
        for i, img in enumerate(images):
            slam.track_monocular(img, i * 0.1)
    jate, tate = _ate(jslam, poses), _ate(tslam, poses)
    print(f"reference: tracked {jslam.tracked_ratio():.3f} ATE {jate:.4f} kfs {jslam.stats.n_keyframes}; "
          f"port: tracked {tslam.tracked_ratio():.3f} ATE {tate:.4f} kfs {tslam.stats.n_keyframes}")
    for slam, ate in ((jslam, jate), (tslam, tate)):
        assert slam.tracked_ratio() > 0.85
        assert ate < 0.10
        assert slam.stats.n_frames == len(images)
    kj, kt = jslam.stats.n_keyframes, tslam.stats.n_keyframes
    assert abs(kj - kt) <= max(2, 0.25 * kj)


def test_status_and_trajectory_flush_and_reset_clears(orbit):
    poses, images = orbit
    slam = _strict_port(_tsystem(pipeline_lag=3))
    for i, img in enumerate(images[:14]):
        slam.track_monocular(img, i * 0.1)
    assert slam.tracking_state.name == "OK"
    # Strict lag: up to three frames stay in flight; at risk, fewer.
    frames_seen = slam.stats.n_frames + len(slam._pending)
    assert frames_seen == 14 and slam._carry is not None
    for i in range(14, 20):
        slam.track_monocular(images[i], i * 0.1)
    assert slam._pending, "no frame in flight to flush"
    status = slam.get_status()
    assert not slam._pending and not slam._bg and status["frames"] == 20
    slam.track_monocular(images[20], 2.0)
    slam.track_monocular(images[21], 2.1)
    n_traj = len(slam.get_trajectory())
    assert not slam._pending and n_traj == 22
    slam.track_monocular(images[22], 2.2)
    slam.reset()
    assert not slam._pending and slam._carry is None and slam.tracking_state.name == "NO_IMAGES_YET"


@pytest.mark.slow
def test_pipelined_recovers_from_blackout():
    """tests/test_end_to_end.py::test_pipelined_recovers_from_blackout
    through the port: the loss is found L frames late, the frames queued
    after it are drained as lost, and the synchronous path relocalizes."""
    from orb_slam_cuda_tpu_torch.utils import synthetic as tsyn

    scene = tsyn.PlanarScene.default(np.random.default_rng(42), depth=5.0, second_depth=8.0,
                                     extent=12.0, tex_size=768)
    poses = tsyn.orbit_trajectory(44, radius=0.6)
    slam = _tsystem(max_frames_between_kf=4, kf_cull_redundancy=1.1, pipeline_lag=2, kf_ref_ratio=1.1)
    K = np.asarray(slam.cam.K)
    blank = np.zeros((H, W), np.uint8)
    for i, T in enumerate(poses):
        img = blank if 30 <= i < 33 else scene.render(K, T, W, H)
        slam.track_monocular(img, i * 0.1)
    status = slam.get_status()
    assert slam.stats.n_lost >= 2
    assert slam.stats.n_reloc >= 1
    assert status["state"] == "OK"
