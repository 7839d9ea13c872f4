"""System facade (torch port of orb_slam_cuda_tpu/engine/system.py).

`System(cfg)` owns the extractor, vocabulary, map state, tracking state
machine, local mapper and loop closer; every tensor it creates lives on
`device`, the card unless the caller passes `device="cpu"` (with no card
and no argument the constructor raises). Ported: `track_monocular`,
`track_stereo` and `track_rgbd`, two-view and depth initialization, the
fused tracking step, pipelined monocular tracking (`pipeline_lag` > 0),
relocalization of lost frames, keyframe creation (with depth points for
stereo/RGB-D), local mapping and loop closing with its chunked global BA
(synchronous, or through the background queue's units when
`async_mapping`), localization-only mode with its frame-to-frame visual
odometry, map save/load and trajectory export, and the distributed back
end: with `mesh` (parallel/mesh.Mesh, a process group) the loop closer's
global BA is solved over the group, and `cluster_refine_interval` > 0
queues a round of covisibility-cluster BA (parallel/cluster_ba.py, over
the mesh when set) every that many keyframes.

Pipelined tracking (`pipeline_lag` = L > 0, monocular only, as in the
reference): once tracking is OK each frame is queued on the device as one
`tracking.fused_pipeline_step` that reads the previous frame's
`TrackCarry` from the device, and its 41-float host vector is copied into
pinned memory behind a CUDA event. The host runs the state machine's tail
(trajectory, keyframe policy, loss) for a frame when its copy has landed
(`_readback_ready`), when L frames are in flight, or at once while
tracking is at risk; so keyframe decisions run up to L frames late.
Stereo and RGB-D frames stay synchronous at any lag.

On the card each per-frame stage is one device program
(engine/programs.py, the counterpart of the reference's `jax.jit`
closures), replayed as a captured CUDA graph: `_frame_fn` (extraction and
frame build, monocular at lag 0), `_track_fn` (the sync-free tracking
step, every sensor at lag 0), `_pipe_fn` (the fused pipelined step),
`_stereo_frame_fn` and `_rgbd_frame_fn`. Values that change from frame to
frame (poses, the reference keyframe, `min_obs`, `th_depth`,
`vo_th_depth`) enter as tensors; a capacity grow drops the map's graphs.
On the CPU the System runs the same stages eagerly, as it always has
(the tracking step's host-branch form at lag 0). Initialization,
relocalization, mapping, loop closing and BA run eagerly on both.

With a mesh every rank runs the same host program on the same frames and
must issue the same collectives in the same order, so no decision may
depend on host timing: the pipelined path then retires a frame at
exactly the lag (or at once while at risk), never because its copy has
happened to land.
"""

from __future__ import annotations

import enum
import math
from collections import deque
from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..frontend.extractor import ExtractorConfig, ORBExtractor
from ..geometry import camera as cam_mod
from ..geometry.camera import Camera
from ..matching import search
from ..ops import hamming
from ..slam_map import MapConfig, keyframe_db
from ..slam_map import ops as map_ops
from ..slam_map import state as mstate
from ..solvers import bundle_adjust as ba
from ..solvers import initializer as init_solver
from ..utils.device import resolve as resolve_device
from ..utils.timing import StageTimer
from ..vocab import build_vocabulary
from . import local_mapping, programs, relocalization, stereo, tracking
from .frame import FrameData, build_frame
from .loop_closing import LoopCloser


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


@dataclass
class SystemConfig:
    camera: Camera = None
    sensor: Sensor = Sensor.MONOCULAR
    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    max_keyframes: int = 128
    max_points: int = 16384
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 30
    vocab_words: int = 512
    init_min_matches: int = 60
    init_min_triangulated: int = 40
    # Stereo/RGB-D: close-point threshold = th_depth_factor * baseline, and
    # the least feature count for the one-frame bootstrap.
    th_depth_factor: float = 35.0
    stereo_init_min_features: int = 500
    depth_map_factor: float = 1.0
    enable_loop_closing: bool = True
    # Parsed from `SLAM.loop_min_kfs` so that a settings file gives the same
    # SystemConfig in both packages; neither package's code reads it.
    loop_min_kfs: int = 10
    kf_cull_redundancy: float = 0.9
    kf_ref_ratio: Optional[float] = None
    pipeline_lag: int = 0
    async_mapping: bool = True
    # Distributed back end (parallel/): a parallel.mesh.Mesh, over which
    # the loop closer's global BA and the cluster refinement are solved;
    # every rank must drive the same frames.
    mesh: object = None
    # Every this many keyframes (once the map holds 8) one round of
    # covisibility-cluster BA rides the background queue; 0 = off.
    cluster_refine_interval: int = 0


@dataclass
class TrackStats:
    n_frames: int = 0
    n_tracked: int = 0
    n_lost: int = 0
    n_keyframes: int = 0
    n_reloc: int = 0
    n_kf_grows: int = 0
    n_pt_grows: int = 0
    n_vo_frames: int = 0  # localization-mode visual-odometry frames
    n_cluster_refines: int = 0  # cluster-parallel map refinement rounds


class _InFlight(NamedTuple):
    """A pipelined frame whose host vector has not been read yet."""

    frame_id: int
    timestamp: float
    frame: FrameData
    res: tracking.FullStepResult
    host_vec: torch.Tensor  # (41,) on the CPU (pinned when copied from CUDA)
    copied: Optional[torch.cuda.Event]  # recorded after the copy; None on the CPU


def synthetic_vocabulary(vocab_words: int, seed: int = 0):
    """The reference's deterministic default: a k=8 tree trained on random
    descriptors."""
    rng = np.random.default_rng(seed)
    train = rng.integers(0, 2**32, size=(4096, 8), dtype=np.uint32)
    k = 8
    depth = max(2, int(round(math.log(vocab_words) / math.log(k))))
    return build_vocabulary(train, k=k, depth=depth, levelsup_depth=max(1, depth - 2))


class System:
    """End-to-end SLAM engine (monocular, stereo, RGB-D) on one torch device."""

    def __init__(self, config: SystemConfig, vocab=None, seed: int = 0, device="cuda"):
        self.cfg = config
        self.device = resolve_device(device)
        cam = config.camera
        assert cam is not None, "SystemConfig.camera required"
        self.cam = cam
        self.extractor = ORBExtractor(
            ExtractorConfig(
                n_features=config.n_features, scale_factor=config.scale_factor,
                n_levels=config.n_levels, ini_th_fast=config.ini_th_fast,
                min_th_fast=config.min_th_fast,
            ),
            cam.height, cam.width, device=self.device,
            upload_slots=max(2, config.pipeline_lag + 1),
        )
        self.map_cfg = MapConfig(
            max_keyframes=config.max_keyframes, max_features=config.n_features,
            max_points=config.max_points, n_levels=config.n_levels,
            scale_factor=config.scale_factor,
        )
        if vocab is None:
            vocab = synthetic_vocabulary(config.vocab_words, seed)
        self.vocab = vocab.to(self.device)
        self._bg = deque()  # deferred mapping units
        # Pipelined tracking: frames in flight, the device-side carry, the
        # first frame id dispatched after the last keyframe insertion (the
        # frames before it tracked the pre-keyframe map), and the number
        # of frames still to run drained after a keyframe or a weak frame.
        self._pending: deque = deque()
        self._carry: Optional[tracking.TrackCarry] = None
        self._kf_barrier = 0
        self._sync_window = 0
        self.state = mstate.empty(self.map_cfg, self.device)
        self.db = keyframe_db.empty(config.max_keyframes, config.n_features, self.device)
        mono = config.sensor == Sensor.MONOCULAR
        self.mapper = local_mapping.LocalMapper(
            self.map_cfg, cam, kf_cull_redundancy=config.kf_cull_redundancy,
            # Neighbour budgets: 20 monocular / 10 otherwise for
            # triangulation, twice that for fusion.
            n_triangulate_neighbors=20 if mono else 10,
            n_fuse_neighbors=40 if mono else 20, device=self.device,
        )
        self.scale_factors = tuple(self.map_cfg.scale_factors)
        # On the device once, so the pipelined step copies nothing to it.
        self._scale_factors_dev = torch.as_tensor(self.scale_factors, dtype=torch.float32, device=self.device)
        self._graphed = self.device.type == "cuda"
        self._programs = self._make_programs()
        (self._frame_fn, self._track_fn, self._pipe_fn, self._stereo_frame_fn,
         self._rgbd_frame_fn) = self._programs

        self.tracking_state = TrackingState.NO_IMAGES_YET
        self.velocity: Optional[np.ndarray] = None
        self.last_pose: Optional[np.ndarray] = None
        self.n_inliers_local = 0
        self.ref_tracked = 0
        self.close_tracked = 0
        self.close_untracked = 0
        self.last_frame: Optional[FrameData] = None
        self.init_frame: Optional[FrameData] = None
        self.ref_kf: int = 0
        self.kf_order: List[int] = []
        self.recent_pts: List[tuple] = []
        self._next_kf_slot = 0
        self.frame_id: int = 0
        self.frames_since_kf: int = 0
        # Per-frame records (timestamp, Tcw|None, ok, ref_slot, ref_gen, Tcr).
        self.trajectory: List[tuple] = []
        self.kf_gen = np.zeros(config.max_keyframes, np.int64)
        self.cull_repair = {}
        self.kf_timestamps = {}
        self.localization_only = False
        self.stats = TrackStats()
        self._last_map_change_idx = -1
        self.timer = StageTimer(enabled=True)
        self.reloc_stage_stats = {}
        self.reloc_trace = None  # a list here receives every relocalization candidate's outcome
        self.loop_closer = None
        if config.enable_loop_closing:
            self.loop_closer = LoopCloser(self.map_cfg, cam, self.vocab, fix_scale=not mono, mesh=config.mesh)
            self.loop_closer.timer = self.timer
        # Close-point threshold in meters (ThDepth = factor * baseline).
        self.th_depth = config.th_depth_factor * (cam.bf / cam.fx) if cam.bf > 0 else 0.0

    @property
    def _vo_th_depth(self) -> float:
        """Close-depth gate of the motion model's temporal points: they
        exist only in localization-only mode, so full SLAM passes 0."""
        return self.th_depth if self.localization_only else 0.0

    def _sync(self):
        return self.device if self.device.type == "cuda" else None

    def _make_programs(self):
        """The five per-frame programs. Their closure constants (camera,
        vocabulary, extractor, scale factors, search radius, depth factor)
        are fixed for the System's life; everything else is an argument."""
        cam, vocab, ex = self.cam, self.vocab, self.extractor
        sf, radius, depth_factor = self._scale_factors_dev, self._radius_mm, self.cfg.depth_map_factor

        def frame(image):
            return build_frame(ex._extract_impl(image), cam, vocab)

        def track(state, frame, pose_pred, pose_last, last, ref_kf, min_obs, th_depth, vo_th_depth):
            return tracking.full_track_step_sync_free(
                state, frame, pose_pred, pose_last, *last, ref_kf, min_obs, cam, sf, radius,
                th_depth, vo_th_depth)

        def pipe(state, image, carry, min_obs, th_depth, vo_th_depth):
            return tracking.fused_pipeline_step(
                state, image, carry, min_obs, ex._extract_impl, lambda feats: build_frame(feats, cam, vocab),
                cam, sf, radius, th_depth, vo_th_depth)

        def stereo_frame(left, right):
            lf, l_pyr = ex.extract_with_pyramid(left)
            rf, r_pyr = ex.extract_with_pyramid(right)
            frame = build_frame(lf, cam, vocab)
            ur, depth = stereo.match_stereo(
                frame.uv, frame.oct, frame.bip, frame.valid,
                rf.uv, rf.octave, hamming.bipolar(rf.desc), rf.valid,
                cam, sf, left_pyramid=l_pyr, right_pyramid=r_pyr,
            )
            return frame._replace(right=ur, depth=depth)

        def rgbd_frame(image, depth_map):
            frame = build_frame(ex._extract_impl(image), cam, vocab)
            depth = stereo.depth_from_rgbd(frame.uv_raw, frame.valid, depth_map, cam, depth_factor)
            return frame._replace(right=stereo.virtual_right(frame.uv, depth, cam), depth=depth)

        return tuple(programs.Program(fn, name) for fn, name in (
            (frame, "frame"), (track, "track"), (pipe, "pipe"), (stereo_frame, "stereo_frame"),
            (rgbd_frame, "rgbd_frame")))

    def _scalar(self, value, dtype=torch.float32):
        """A 0-d program input on the card (a fill, no host-to-device copy)."""
        return torch.full((), value, dtype=dtype, device=self.device)

    def _to_card(self, a):
        """A host array or tensor on the card, copied through pinned memory
        without waiting for the stream."""
        t = torch.as_tensor(a)
        if t.device.type != "cpu":
            return t.to(self.device)
        return t.contiguous().pin_memory().to(self.device, non_blocking=True)

    def _step_values(self, min_obs: int):
        """(min_obs, th_depth, vo_th_depth) as the tracking step takes them:
        on the card 0-d tensors, program inputs that a Python number would
        not be (it would be frozen at capture); on the CPU Python numbers."""
        if not self._graphed:
            return min_obs, self.th_depth, self._vo_th_depth
        return (self._scalar(min_obs, torch.int64), self._scalar(self.th_depth),
                self._scalar(self._vo_th_depth))

    def _drop_map_graphs(self):
        """The map's capacities changed: graphs keyed on the old ones can no
        longer replay."""
        self._track_fn.clear()
        self._pipe_fn.clear()

    def program_stats(self) -> dict:
        """Each per-frame program's captures, replays, capture seconds and
        live graphs, and the bytes of the shared graph pool (0 on the CPU)."""
        out = {p.name: p.stats() for p in self._programs}
        out["pool_bytes"] = programs.pool_bytes() if self._graphed else 0
        return out

    @property
    def _radius_mm(self) -> float:
        return (tracking.MOTION_MODEL_RADIUS_STEREO if self.cfg.sensor == Sensor.STEREO
                else tracking.MOTION_MODEL_RADIUS)

    # ------------------------------------------------------------------
    def track_monocular(self, image, timestamp: float):
        """Track one grayscale frame (numpy array or tensor, on any
        device). Returns the 4x4 Tcw (np.ndarray) or None while
        uninitialized/lost; at `pipeline_lag` > 0, the pose of the last
        frame retired by this call, or None if none was."""
        assert self.cfg.sensor == Sensor.MONOCULAR
        self.timer.set_frame(self.frame_id)
        if self.cfg.pipeline_lag > 0 and self.tracking_state == TrackingState.OK:
            # Host clock only: the stage must not wait for the device.
            with self.timer.stage("timesTracking.csv", "track"):
                return self._track_pipelined(image, timestamp)
        # As the reference's synchronous path does, the frames in flight
        # retire and the deferred mapping and loop units finish before
        # this frame tracks.
        self._flush_pipeline()
        if self._graphed:
            with self.timer.stage("times.csv", "orb_extract", sync=self._sync()):
                frame = self._frame_fn(self.extractor.upload(image))
        else:
            with self.timer.stage("times.csv", "orb_extract", sync=self._sync()):
                feats = self.extractor(image)
            with self.timer.stage("times.csv", "build_frame", sync=self._sync()):
                frame = build_frame(feats, self.cam, self.vocab)
        with self.timer.stage("timesTracking.csv", "track", sync=self._sync()):
            pose = self._track(frame, timestamp)
        self.frame_id += 1
        return pose

    # ------------------------------------------------------------------
    # Pipelined tracking: queue the frame now, read its result L frames on.
    def _make_carry(self) -> tracking.TrackCarry:
        """The device-side carry from the host state after a synchronous
        track."""
        lf = self.last_frame
        vel = self.velocity if self.velocity is not None else np.eye(4, dtype=np.float32)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)  # noqa: E731
        return tracking.TrackCarry(
            pose=f32(self.last_pose), vel=f32(vel), uv=lf.uv, oct=lf.oct, ang=lf.ang,
            bip=lf.bip, depth=lf.depth, mp=lf.mp,
            ref_kf=torch.full((), self.ref_kf, dtype=torch.int64, device=self.device),
        )

    def _dispatch_pipelined(self, image, min_obs: int):
        """Queue one frame's fused step on the device and the copy of its
        host vector. Returns (frame, result, carry, host vector, event)."""
        frame, res, carry = self._pipe_fn(self.state, self.extractor.upload(image), self._carry,
                                          *self._step_values(min_obs))
        if self.device.type != "cuda":
            return frame, res, carry, res.host_vec, None
        host = torch.empty(res.host_vec.shape, dtype=res.host_vec.dtype, pin_memory=True)
        host.copy_(res.host_vec, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record()
        return frame, res, carry, host, copied

    def _readback_ready(self, entry: _InFlight) -> bool:
        """Has the frame's host vector landed? (Always on the CPU.) Never
        asked with a mesh: host timing must not steer the ranks apart."""
        return entry.copied is None or entry.copied.query()

    def _track_pipelined(self, image, timestamp: float):
        """Queue one fused step; retire in-flight frames whose host vector
        has landed, all of them while tracking is at risk, and the oldest
        once more than `pipeline_lag` are in flight."""
        if self._carry is None:
            self._carry = self._make_carry()
        min_obs = 3 if len(self.kf_order) > 2 else 2
        frame, res, self._carry, host, copied = self._dispatch_pipelined(image, min_obs)
        self.state = self.state._replace(mp_visible=res.mp_visible, mp_found=res.mp_found)
        self._pending.append(_InFlight(self.frame_id, timestamp, frame, res, host, copied))
        self.frame_id += 1
        # One deferred mapping or loop unit rides each frame slot.
        self._pump_background()
        lag = self.cfg.pipeline_lag

        def risky():
            # A keyframe rescue that arrives L frames after the inliers
            # collapse comes too late: drain while the window after a
            # keyframe is open, while the weakness trigger is armed, or
            # while inliers are within twice the loss floor. Pure-cadence
            # mode (kf_ref_ratio > 1) never arms the weakness trigger.
            th_ref = self.cfg.kf_ref_ratio
            if th_ref is None:
                th_ref = 0.9 if self.cfg.sensor == Sensor.MONOCULAR else 0.75
            c2_armed = th_ref <= 1.0 and self.n_inliers_local < self.ref_tracked * th_ref
            return (self._sync_window > 0 or c2_armed
                    or self.n_inliers_local < 2 * tracking.MIN_INLIERS_LOCAL)

        at_risk = risky()
        if self._sync_window > 0:
            self._sync_window -= 1
        if at_risk:
            # The rescue is the next keyframe's points: finish the mapping
            # backlog too.
            self._drain_background()
        out = None
        while self._pending:
            if (not at_risk and len(self._pending) <= lag
                    and (self.cfg.mesh is not None or not self._readback_ready(self._pending[0]))):
                break
            out = self._retire_one()
            if self.tracking_state != TrackingState.OK:
                break
            at_risk = risky()
        return out

    def _retire_one(self):
        """Read the oldest in-flight frame's host vector (waiting for its
        copy) and run the state machine's tail for it: trajectory,
        keyframe policy, loss."""
        entry = self._pending.popleft()
        if entry.copied is not None:
            entry.copied.synchronize()
        vec = entry.host_vec.numpy()
        frame, res, fid, ts = entry.frame, entry.res, entry.frame_id, entry.timestamp
        ok = bool(vec[0])
        self.stats.n_frames += 1
        self.ref_kf = int(vec[2])
        self.n_inliers_local = int(vec[1])
        self.ref_tracked = int(vec[3])
        self.close_tracked = int(vec[7])
        self.close_untracked = int(vec[8])
        if ok:
            pose = vec[9:25].reshape(4, 4).astype(np.float32).copy()
            if self.last_pose is not None:
                self.velocity = pose @ np.linalg.inv(self.last_pose)
            self.last_pose = pose
            self.last_frame = frame._replace(mp=res.mp)
            self.stats.n_tracked += 1
            self.frames_since_kf += 1
            self._append_traj(ts, pose, True, self.ref_kf, vec[25:41].reshape(4, 4))
            if not self.localization_only and fid >= self._kf_barrier and self._need_new_keyframe(frame):
                self._create_keyframe(frame)
                self.kf_timestamps[self.ref_kf] = ts
                # The frames in flight tracked the pre-keyframe map: their
                # inlier counts must not trigger another keyframe.
                self._kf_barrier = self.frame_id
                self._sync_window = self.cfg.pipeline_lag + 1
            return pose
        self._append_traj(ts, None, False)
        self.stats.n_lost += 1
        if fid < self._kf_barrier:
            # Soft miss: the frame tracked the pre-keyframe map the policy
            # had already judged exhausted. Skip it and keep the chain (the
            # carry kept the last good pose with identity velocity).
            self._sync_window = max(self._sync_window, 1)
            return None
        # The loss is found L frames late: the frames queued after it
        # chained on the failed pose and are lost too. The next frame goes
        # through the synchronous path and relocalizes.
        while self._pending:
            lost = self._pending.popleft()
            self._append_traj(lost.timestamp, None, False)
            self.stats.n_frames += 1
            self.stats.n_lost += 1
        self.tracking_state = TrackingState.LOST
        self.velocity = None
        self._carry = None
        if 0 < len(self.kf_order) <= 5 and not self.localization_only:
            self.reset()
        return None

    def _flush_pipeline(self):
        """Retire every frame in flight, then finish the deferred units."""
        while self._pending:
            self._retire_one()
        self._drain_background()

    def track_stereo(self, left, right, timestamp: float):
        """Track one rectified stereo pair: extract both views, associate
        stereo depth (Hamming match along the row band, SAD refinement on
        the two pyramids the extractor has just built), then track. The
        first frame with enough features and depths initializes the map."""
        assert self.cfg.sensor == Sensor.STEREO
        self.timer.set_frame(self.frame_id)
        # As in the reference, only the monocular entry drains the
        # background queue first: here a keyframe's deferred units are
        # pumped one a frame, and drained when the next keyframe is due.
        if self._graphed:
            with self.timer.stage("times.csv", "orb_extract_stereo", sync=self._sync()):
                frame = self._stereo_frame_fn(self.extractor.upload(left), self.extractor.upload(right))
            return self._track_with_depth(frame, timestamp)
        with self.timer.stage("times.csv", "orb_extract_stereo", sync=self._sync()):
            lf, l_pyr = self.extractor.extract_with_pyramid(left)
            rf, r_pyr = self.extractor.extract_with_pyramid(right)
        with self.timer.stage("times.csv", "build_frame", sync=self._sync()):
            frame = build_frame(lf, self.cam, self.vocab)
        with self.timer.stage("times.csv", "stereo_match", sync=self._sync()):
            ur, depth = stereo.match_stereo(
                frame.uv, frame.oct, frame.bip, frame.valid,
                rf.uv, rf.octave, hamming.bipolar(rf.desc), rf.valid,
                self.cam, self.scale_factors, left_pyramid=l_pyr, right_pyramid=r_pyr,
            )
            frame = frame._replace(right=ur, depth=depth)
        return self._track_with_depth(frame, timestamp)

    def track_rgbd(self, image, depth_map, timestamp: float):
        """Track one grayscale frame with its registered depth map (any
        numeric type; meters after scaling by `cfg.depth_map_factor`)."""
        assert self.cfg.sensor == Sensor.RGBD
        self.timer.set_frame(self.frame_id)
        if isinstance(depth_map, np.ndarray) and depth_map.dtype.kind == "u":
            depth_map = depth_map.astype(np.int64 if depth_map.dtype.itemsize > 2 else np.int32)
        if self._graphed:
            with self.timer.stage("times.csv", "orb_extract_rgbd", sync=self._sync()):
                frame = self._rgbd_frame_fn(self.extractor.upload(image), self._to_card(depth_map))
            return self._track_with_depth(frame, timestamp)
        with self.timer.stage("times.csv", "orb_extract_rgbd", sync=self._sync()):
            feats = self.extractor(image)
        with self.timer.stage("times.csv", "build_frame", sync=self._sync()):
            frame = build_frame(feats, self.cam, self.vocab)
        with self.timer.stage("times.csv", "depth_lookup", sync=self._sync()):
            depth = stereo.depth_from_rgbd(
                frame.uv_raw, frame.valid, torch.as_tensor(depth_map).to(self.device),
                self.cam, self.cfg.depth_map_factor,
            )
            frame = frame._replace(right=stereo.virtual_right(frame.uv, depth, self.cam), depth=depth)
        return self._track_with_depth(frame, timestamp)

    def _track_with_depth(self, frame: FrameData, timestamp: float):
        if self.tracking_state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            with self.timer.stage("timesTracking.csv", "track", sync=self._sync()):
                pose = self._depth_initialize(frame)
                self._append_traj(timestamp, pose, pose is not None)
        else:
            with self.timer.stage("timesTracking.csv", "track", sync=self._sync()):
                pose = self._track(frame, timestamp)
        self.frame_id += 1
        return pose

    def _depth_initialize(self, frame: FrameData):
        """StereoInitialization: one keyframe at the origin; every feature
        with a depth becomes a map point at once."""
        dev = self.device
        if int(torch.sum(frame.valid)) < self.cfg.stereo_init_min_features:
            return None
        sel_t = torch.nonzero((frame.depth > 0) & frame.valid).flatten()
        n_new = int(sel_t.shape[0])
        if n_new < 100:
            return None
        T0 = np.eye(4, dtype=np.float32)
        slot = 0
        pt_slots = np.arange(n_new, dtype=np.int32)
        pt_slots_t = torch.as_tensor(pt_slots, device=dev)
        mp_row = torch.full((frame.capacity,), -1, dtype=torch.int32, device=dev)
        mp_row[sel_t] = pt_slots_t
        st = mstate.insert_keyframe(
            self.state, slot, torch.as_tensor(T0, device=dev), self.frame_id,
            frame.uv, frame.right, frame.depth, frame.oct, frame.ang,
            frame.desc, frame.valid, frame.word, frame.node, mp_row,
        )
        xyz = cam_mod.backproject(self.cam, frame.uv[sel_t], frame.depth[sel_t])
        ref = torch.full((n_new,), slot, dtype=torch.int32, device=dev)
        st = mstate.add_points(
            st, pt_slots_t, xyz, torch.ones((n_new,), dtype=torch.bool, device=dev),
            frame.desc[sel_t],
            torch.zeros((n_new, 3), dtype=torch.float32, device=dev),
            torch.zeros((n_new,), dtype=torch.float32, device=dev),
            torch.full((n_new,), 1e9, dtype=torch.float32, device=dev), ref, ref,
        )
        st = map_ops.update_point_stats(st, self.map_cfg)
        st = map_ops.refresh_covis_rows(st, torch.tensor([slot], device=dev))
        wu, wt = keyframe_db.compute_bow_row(frame.word, frame.idf, frame.valid)
        self.db = keyframe_db.insert(self.db, slot, wu, wt)
        self.state = st
        self.kf_order = [slot]
        self.kf_gen[slot] += 1
        self._next_kf_slot = 1
        self.mapper._next_pt_slot = n_new
        self.mapper.mp_valid_host[:] = False
        self.mapper.note_points_added(pt_slots)
        self.recent_pts = []
        self.ref_kf = slot
        self.last_pose = T0
        self.velocity = None
        self.last_frame = frame._replace(mp=mp_row)
        self.tracking_state = TrackingState.OK
        self.frames_since_kf = 0
        self.stats.n_keyframes = 1
        return T0

    # ------------------------------------------------------------------
    def _track(self, frame: FrameData, timestamp: float):
        self.stats.n_frames += 1
        if self.tracking_state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            pose = self._try_initialize(frame)
            self._append_traj(timestamp, pose, pose is not None)
            return pose

        ok = False
        pose = None
        ref_pose = None
        ref_slot_frame = -1
        if self.tracking_state == TrackingState.OK:
            lf = self.last_frame
            pose_pred = self.velocity @ self.last_pose if self.velocity is not None else self.last_pose
            min_obs = 3 if len(self.kf_order) > 2 else 2
            last = (lf.uv, lf.oct, lf.ang, lf.bip, lf.mp, lf.depth)
            if self._graphed:
                res = self._track_fn(
                    self.state, frame, self._to_card(pose_pred.astype(np.float32)),
                    self._to_card(self.last_pose.astype(np.float32)), last,
                    self._scalar(self.ref_kf, torch.int64), *self._step_values(min_obs),
                )
            else:
                res = tracking.full_track_step(
                    self.state, frame, pose_pred.astype(np.float32), self.last_pose.astype(np.float32),
                    *last, self.ref_kf, min_obs, self.cam, self.scale_factors, self._radius_mm,
                    self.th_depth, self._vo_th_depth,
                )
            vec = res.host_vec.cpu().numpy()
            scal = vec[:9].astype(np.int64)
            ok = bool(scal[0])
            self.state = self.state._replace(mp_visible=res.mp_visible, mp_found=res.mp_found)
            self.ref_kf = int(scal[2])
            self.n_inliers_local = int(scal[1])
            self.ref_tracked = int(scal[3])
            self.close_tracked = int(scal[7])
            self.close_untracked = int(scal[8])
            if ok:
                pose = vec[9:25].reshape(4, 4).copy()
                ref_pose = vec[25:41].reshape(4, 4).copy()
                ref_slot_frame = int(scal[2])
                self.last_frame = frame._replace(mp=res.mp)
        if self.tracking_state == TrackingState.LOST or not ok:
            ref_pose = None
            pose, ok = self._relocalize(frame)
            if ok:
                self.stats.n_reloc += 1
                pose2, ok = self._track_local_map(pose)
                if ok:
                    pose = pose2
            elif (
                self.localization_only
                and self.cfg.sensor != Sensor.MONOCULAR
                and self.last_frame is not None
                and self.last_pose is not None
            ):
                # Relocalization failed but the last frame carries depth:
                # track frame to frame on its temporal 3D points, so that
                # localization-only mode survives mapless regions (mbVO).
                pose, ok = self._track_visual_odometry(frame)
                if ok:
                    self.stats.n_vo_frames += 1

        if ok:
            self.tracking_state = TrackingState.OK
            self.stats.n_tracked += 1
            if self.last_pose is not None:
                self.velocity = pose @ np.linalg.inv(self.last_pose)
            self.last_pose = pose
            self.frames_since_kf += 1
            if not self.localization_only and self._need_new_keyframe(frame):
                self._create_keyframe(frame)
                self.kf_timestamps[self.ref_kf] = timestamp
        else:
            self.tracking_state = TrackingState.LOST
            self.stats.n_lost += 1
            self.velocity = None
            # Lost right after initialization -> full reset.
            if 0 < len(self.kf_order) <= 5 and not self.localization_only:
                self.reset()

        self._append_traj(
            timestamp, pose if ok else None, bool(ok),
            ref_slot_frame if ref_pose is not None else -1, ref_pose,
        )
        # The next pipelined frame rebuilds its carry from this host state.
        self._carry = None
        self._pump_background()
        return pose if ok else None

    # ------------------------------------------------------------------
    def _try_initialize(self, frame: FrameData):
        n_valid = int(torch.sum(frame.valid))
        min_feats = 2 * self.cfg.init_min_matches
        if self.tracking_state == TrackingState.NO_IMAGES_YET or self.init_frame is None:
            if n_valid >= min_feats:
                self.init_frame = frame
                self.tracking_state = TrackingState.NOT_INITIALIZED
            return None
        if n_valid < min_feats:
            self.init_frame = None
            return None

        f1 = self.init_frame
        m = search.for_initialization(
            f1.uv, f1.bip, f1.valid, f1.ang,
            frame.uv, frame.bip, frame.valid, frame.ang, frame.oct,
            f1.oct, window=100.0,
        )
        matched = m.idx >= 0
        if int(torch.sum(matched)) < self.cfg.init_min_matches:
            self.init_frame = frame if n_valid >= min_feats else None
            return None

        # Drawn on the CPU whatever the map's device, so that CPU and CUDA
        # runs see the same minimal sets; they are copied to the device.
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.frame_id)
        res = init_solver.initialize_two_view(
            f1.uv, frame.uv[torch.clamp(m.idx, min=0)], matched,
            self.cam.K_on(self.device), generator=gen,
            min_triangulated=self.cfg.init_min_triangulated,
        )
        if not bool(res.success):
            return None
        return self._create_initial_map(f1, frame, m, res)

    def _create_initial_map(self, f1: FrameData, f2: FrameData, m, res):
        """Two keyframes, triangulated points, full BA, median-depth scale."""
        dev = self.device
        T1 = np.eye(4, dtype=np.float32)
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = res.R.cpu().numpy()
        T2[:3, 3] = res.t.cpu().numpy()
        is_pt = res.is_point.cpu().numpy()
        pts = res.points.cpu().numpy()
        idx2 = m.idx.cpu().numpy()
        sel = np.flatnonzero(is_pt & (idx2 >= 0))
        n_new = len(sel)
        if n_new < self.cfg.init_min_triangulated:
            return None
        med_depth = float(np.median(pts[sel][:, 2]))
        if med_depth <= 0:
            return None
        inv_med = 1.0 / med_depth
        T2[:3, 3] *= inv_med
        pts_n = pts * inv_med

        st = self.state
        slot1, slot2 = 0, 1
        mp1 = np.full(f1.capacity, -1, np.int32)
        mp2 = np.full(f2.capacity, -1, np.int32)
        pt_slots = np.arange(n_new, dtype=np.int32)
        mp1[sel] = pt_slots
        mp2[idx2[sel]] = pt_slots
        for slot, fr, T, mp in ((slot1, f1, T1, mp1), (slot2, f2, T2, mp2)):
            st = mstate.insert_keyframe(
                st, slot, torch.as_tensor(T, device=dev),
                self.frame_id - (1 if slot == slot1 else 0),
                fr.uv, fr.right, fr.depth, fr.oct, fr.ang, fr.desc,
                fr.valid, fr.word, fr.node, torch.as_tensor(mp, device=dev),
            )
        sel_t = torch.as_tensor(sel, device=dev)
        ref = torch.full((n_new,), slot1, dtype=torch.int32, device=dev)
        st = mstate.add_points(
            st, torch.as_tensor(pt_slots, device=dev),
            torch.as_tensor(pts_n[sel], dtype=torch.float32, device=dev),
            torch.ones((n_new,), dtype=torch.bool, device=dev), f1.desc[sel_t],
            torch.zeros((n_new, 3), dtype=torch.float32, device=dev),
            torch.zeros((n_new,), dtype=torch.float32, device=dev),
            torch.full((n_new,), 1e9, dtype=torch.float32, device=dev), ref, ref,
        )
        st = map_ops.update_point_stats(st, self.map_cfg)
        st = map_ops.refresh_covis_rows(st, torch.tensor([slot1, slot2], device=dev))
        # Full BA on the two-view map (GlobalBundleAdjustemnt(20)).
        inv_sig = (1.0 / torch.as_tensor(self.map_cfg.level_sigma2, dtype=torch.float32)).tolist()
        problem, cam_slots, pt_slots_t = local_mapping.gather_local_ba_problem(
            st, slot2, self.cam, inv_sig, n_local=2, n_fixed=1,
            n_points=min(4096, self.map_cfg.max_points),
        )
        result = ba.bundle_adjust(problem, self.cam, lm_iters=20, cg_iters=20)
        st = local_mapping.scatter_ba_result(st, result, problem, cam_slots, pt_slots_t)

        db = self.db
        for slot, fr in ((slot1, f1), (slot2, f2)):
            wu, wt = keyframe_db.compute_bow_row(fr.word, fr.idf, fr.valid)
            db = keyframe_db.insert(db, slot, wu, wt)

        self.state = st
        self.db = db
        self.kf_order = [slot1, slot2]
        self.kf_gen[slot1] += 1
        self.kf_gen[slot2] += 1
        self._next_kf_slot = 2
        # Init points are pruned by BA chi2 only, never put on probation.
        self.recent_pts = []
        self.mapper._next_pt_slot = int(pt_slots[-1]) + 1
        self.mapper.mp_valid_host[:] = False
        self.mapper.note_points_added(pt_slots)
        self.ref_kf = slot2
        pose2 = st.kf_pose[slot2].cpu().numpy()
        self.last_pose = pose2
        self.velocity = None
        self.last_frame = f2._replace(mp=st.kf_mp[slot2].clone())
        self.tracking_state = TrackingState.OK
        self.frames_since_kf = 0
        self.stats.n_keyframes = 2
        return pose2

    def _track_visual_odometry(self, frame: FrameData):
        """Frame-to-frame VO against the last frame's depth points."""
        lf = self.last_frame
        vel = self.velocity if self.velocity is not None else np.eye(4, dtype=np.float32)
        pose_pred = (vel @ self.last_pose).astype(np.float32)
        pose, n_m, n_i = tracking.track_vo_last_frame(
            frame, lf.uv, lf.oct, lf.ang, lf.bip, lf.depth, lf.valid,
            self.last_pose.astype(np.float32), pose_pred, self.cam, self.scale_factors,
            tracking.MOTION_MODEL_RADIUS_STEREO,
        )
        if int(n_m) >= tracking.MIN_MATCHES_MOTION and int(n_i) >= tracking.MIN_INLIERS_TRACK:
            self.last_frame = frame._replace(mp=torch.full_like(frame.mp, -1))
            return pose.cpu().numpy(), True
        return None, False

    def _relocalize(self, frame: FrameData):
        """BoW candidates from the database, BoW matching, EPnP RANSAC and
        the staged pose ladder; on success the frame keeps its bindings."""
        with self.timer.stage("timesTracking.csv", "relocalize", sync=self._sync()):
            pose, mp, ok = relocalization.relocalize(
                self.state, self.db, frame, self.cam, self.vocab.n_words,
                self.scale_factors, stats=self.reloc_stage_stats, trace=self.reloc_trace,
            )
        if not ok:
            return None, False
        self.last_frame = frame._replace(mp=mp)
        return pose.cpu().numpy(), True

    def _track_local_map(self, pose):
        """TrackLocalMap after a relocalization: local keyframes and points
        of the new bindings, projection search, pose refinement."""
        frame = self.last_frame
        _, pt_mask, ref_kf = tracking.assemble_local_map(self.state, frame.mp)
        self.ref_kf = int(ref_kf)
        pose2, mp, n_inl, _, visible = tracking.track_local_map(
            self.state, frame, torch.as_tensor(pose, device=self.device), pt_mask, self.cam,
            self.scale_factors, 1.0,
        )
        P = visible.shape[0]
        ids = torch.arange(P, dtype=torch.int32, device=self.device)
        self.state = map_ops.increase_visible(self.state, torch.where(visible, ids, torch.full_like(ids, -1)))
        self.state = map_ops.increase_found(self.state, mp)
        self.last_frame = frame._replace(mp=mp)
        self.n_inliers_local = int(n_inl)
        return pose2.cpu().numpy(), self.n_inliers_local >= tracking.MIN_INLIERS_LOCAL

    # ------------------------------------------------------------------
    # Background queue: deferred mapping and loop units, one pumped after
    # each frame, the rest drained before the next frame tracks.
    def _pump_background(self, budget: int = 1):
        while budget > 0 and self._bg:
            self._run_bg_unit(self._bg.popleft())
            budget -= 1

    def _drain_background(self):
        while self._bg:
            self._run_bg_unit(self._bg.popleft())

    def _abort_pending_ba(self):
        """mbAbortBA: a new keyframe interrupts the pending BA round 2."""
        for unit in self._bg:
            if unit[0] == "lba2":
                unit[1].aborted = True

    def _run_bg_unit(self, unit):
        kind = unit[0]
        lc = self.loop_closer
        if kind == "lba2":
            with self.timer.stage("timesMapping.csv", "local_ba2", sync=self._sync()):
                self.state = self.mapper.run_ba_round2(self.state, unit[1])
        elif kind == "map_finish":
            _, pending, protected = unit
            cull_log = []
            with self.timer.stage("timesMapping.csv", "local_mapping_finish", sync=self._sync()):
                self.state, self.db = self.mapper.finish_keyframe(
                    self.state, self.db, pending, self.recent_pts, self.kf_order,
                    protected, cull_log,
                )
            self._record_culls(cull_log)
            if self.ref_kf not in self.kf_order:
                self.ref_kf = self.kf_order[-1]
        elif kind == "loop_detect":
            with self.timer.stage("timesMapping.csv", "loop_detect", sync=self._sync()):
                pending = lc.dispatch_detect(self.state, self.db, unit[1], self.kf_order)
            if pending is not None:
                self._bg.append(("loop_finish", pending))
        elif kind == "loop_finish":
            with self.timer.stage("timesMapping.csv", "loop_closing", sync=self._sync()):
                self.state, self.db = lc.finish_detect(self.state, self.db, unit[1], self.kf_order)
            if lc.gba_requested:
                lc.gba_requested = False
                self._bg.append(("gba_dispatch",))
        elif kind == "cluster_refine":
            from ..parallel.cluster_ba import cluster_block_ba

            with self.timer.stage("timesMapping.csv", "cluster_refine", sync=self._sync()):
                self.state = cluster_block_ba(
                    self.state, self.cam,
                    1.0 / torch.as_tensor(self.map_cfg.level_sigma2, dtype=torch.float32),
                    mesh=self.cfg.mesh, rounds=1, lm_iters=4, cg_iters=12,
                )
            self.stats.n_cluster_refines += 1
        elif kind == "gba_dispatch":
            with self.timer.stage("timesMapping.csv", "gba_dispatch", sync=self._sync()):
                pending = lc.dispatch_global_ba(self.state, self.kf_order, self.kf_gen,
                                                self.mapper.mp_valid_host)
            self._bg.append(("gba_chunk", pending))
        elif kind == "gba_chunk":
            # One chunk per pumped slot; a superseding loop aborts the rest.
            with self.timer.stage("timesMapping.csv", "gba_chunk", sync=self._sync()):
                done = lc.continue_global_ba(unit[1])
            self._bg.append(("gba_finish", unit[1]) if done else ("gba_chunk", unit[1]))
        elif kind == "gba_finish":
            with self.timer.stage("timesMapping.csv", "gba_finish", sync=self._sync()):
                self.state = lc.finish_global_ba(self.state, unit[1], self.kf_order, self.kf_gen,
                                                 self.mapper.mp_valid_host)
        else:
            raise ValueError(f"unknown background unit {kind!r}")

    # ------------------------------------------------------------------
    def _need_new_keyframe(self, frame: FrameData) -> bool:
        """NeedNewKeyFrame: c1a (max interval), c1b (min interval and
        mapper idle) or c1c (stereo/RGB-D: tracking weak, or close points
        running out), gated by c2 (weakening vs the reference keyframe,
        with the survival-floor clamp, or close points running out; and
        > 15 inliers)."""
        if len(self.kf_order) == 0:
            return False
        inliers = self.n_inliers_local
        mono = self.cfg.sensor == Sensor.MONOCULAR
        idle = not any(u[0] == "map_finish" for u in self._bg)
        # bNeedToInsertClose: few close points tracked, many untracked.
        need_close = (not mono) and self.close_tracked < 100 and self.close_untracked > 70
        # thRefRatio: 0.9 monocular, else 0.75, 0.4 for a one-keyframe map.
        th_ref = self.cfg.kf_ref_ratio
        if th_ref is None:
            th_ref = 0.9 if mono else (0.4 if len(self.kf_order) < 2 else 0.75)
        c1a = self.frames_since_kf >= self.cfg.max_frames_between_kf
        c1b = self.frames_since_kf >= self.cfg.min_frames_between_kf and idle
        c1c = (not mono) and (inliers < self.ref_tracked * 0.25 or need_close)
        weak = (
            th_ref > 1.0
            or inliers < self.ref_tracked * th_ref
            or inliers < 2 * tracking.MIN_INLIERS_LOCAL
        )
        c2 = (weak or need_close) and inliers > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        if idle:
            return True
        # Mapper busy: interrupt its BA, finish its queued units, insert.
        self._abort_pending_ba()
        self._drain_background()
        return True

    def _grow_keyframe_capacity(self):
        """Double keyframe capacity (all K-shaped map/db arrays)."""
        new_K = self.state.kf_valid.shape[0] * 2
        self.state = mstate.grow_keyframes(self.state, new_K)
        self.db = keyframe_db.grow(self.db, new_K)
        self.kf_gen = np.concatenate([self.kf_gen, np.zeros(new_K - len(self.kf_gen), np.int64)])
        self.cfg.max_keyframes = new_K
        self.map_cfg = self.map_cfg._replace(max_keyframes=new_K)
        self.mapper.cfg = self.map_cfg
        if self.loop_closer is not None:
            self.loop_closer.cfg = self.map_cfg
        self._drop_map_graphs()
        self.stats.n_kf_grows += 1

    def _grow_point_capacity(self):
        new_P = self.state.mp_valid.shape[0] * 2
        self.state = mstate.grow_points(self.state, new_P)
        self.cfg.max_points = new_P
        self.map_cfg = self.map_cfg._replace(max_points=new_P)
        self.mapper.cfg = self.map_cfg
        self.mapper.mp_valid_host = np.concatenate(
            [self.mapper.mp_valid_host, np.zeros(new_P - len(self.mapper.mp_valid_host), bool)]
        )
        if self.loop_closer is not None:
            self.loop_closer.cfg = self.map_cfg
        self._drop_map_graphs()
        self.stats.n_pt_grows += 1

    def _ensure_point_headroom(self):
        """Grow point capacity when the next keyframe could exhaust it."""
        need = self.mapper.n_tri_nb * 256 + 1024
        free = int(np.sum(~self.mapper.mp_valid_host))
        if free < need:
            self.mapper.resync_point_mirror(self.state)
            free = int(np.sum(~self.mapper.mp_valid_host))
        while free < need:
            self._grow_point_capacity()
            free = int(np.sum(~self.mapper.mp_valid_host))

    def _create_keyframe(self, frame: FrameData):
        """CreateNewKeyFrame + local mapping (dispatched into the
        background queue with async_mapping, else run to the end here)."""
        self._abort_pending_ba()
        self._drain_background()
        frame = self.last_frame
        kf_valid = np.zeros(self.cfg.max_keyframes, bool)
        kf_valid[self.kf_order] = True
        free = np.flatnonzero(~kf_valid)
        if len(free) == 0:
            self._grow_keyframe_capacity()
            kf_valid = np.zeros(self.cfg.max_keyframes, bool)
            kf_valid[self.kf_order] = True
            free = np.flatnonzero(~kf_valid)
        self._ensure_point_headroom()
        pos = np.searchsorted(free, self._next_kf_slot)
        free = np.concatenate([free[pos:], free[:pos]])
        slot = int(free[0])
        self.kf_gen[slot] += 1
        self._next_kf_slot = (slot + 1) % self.cfg.max_keyframes
        mp_clean = map_ops.sanitize_bindings(self.state, frame.mp)
        self.state = mstate.insert_keyframe(
            self.state, slot, torch.as_tensor(self.last_pose, dtype=torch.float32, device=self.device),
            self.frame_id, frame.uv, frame.right, frame.depth, frame.oct, frame.ang,
            frame.desc, frame.valid, frame.word, frame.node, mp_clean,
        )
        if self.cfg.sensor != Sensor.MONOCULAR:
            self._create_depth_points(slot)
        wu, wt = keyframe_db.compute_bow_row(frame.word, frame.idf, frame.valid)
        self.db = keyframe_db.insert(self.db, slot, wu, wt)
        self.kf_order.append(slot)
        self.ref_kf = slot
        self.frames_since_kf = 0
        self.stats.n_keyframes += 1
        # Periodic cluster-parallel map refinement: every N keyframes one
        # block-coordinate round over covisibility clusters rides the
        # background queue (over the mesh when set).
        if (self.cfg.cluster_refine_interval > 0
                and self.stats.n_keyframes % self.cfg.cluster_refine_interval == 0
                and len(self.kf_order) >= 8):
            self._bg.append(("cluster_refine",))

        # Keyframes on loop edges are never culled.
        lc = self.loop_closer
        protected = {k for e in lc.loop_edges for k in e} if lc is not None else set()
        if self.cfg.async_mapping:
            with self.timer.stage("timesMapping.csv", "local_mapping", sync=self._sync()):
                self.state, pending = self.mapper.dispatch_keyframe(
                    self.state, slot, self.recent_pts, self.kf_order
                )
            self._bg.append(("lba2", pending))
            self._bg.append(("map_finish", pending, protected))
            if lc is not None and len(self.kf_order) > 3:
                self._bg.append(("loop_detect", slot))
            return
        cull_log = []
        with self.timer.stage("timesMapping.csv", "local_mapping", sync=self._sync()):
            self.state, self.db = self.mapper.process_keyframe(
                self.state, self.db, slot, self.recent_pts, self.kf_order,
                protected=protected, cull_log=cull_log,
            )
        self._record_culls(cull_log)
        if self.ref_kf not in self.kf_order:
            self.ref_kf = self.kf_order[-1]
        if lc is not None and len(self.kf_order) > 3:
            with self.timer.stage("timesMapping.csv", "loop_closing", sync=self._sync()):
                self.state, self.db = lc.process(self.state, self.db, slot, self.kf_order)

    def _create_depth_points(self, slot: int):
        """A stereo/RGB-D keyframe spawns points for its unbound close
        features; they enter the probation list."""
        MAX_NEW = 512
        slots = self.mapper.peek_point_slots(self.state, MAX_NEW)
        self.state, n_used = local_mapping.create_depth_points(
            self.state, slot, self.cam, self.th_depth, slots, max_new=MAX_NEW,
        )
        n_used = int(n_used)
        self.mapper.advance_point_slots(slots, n_used)
        self.mapper.note_points_added(slots[:n_used])
        born = len(self.kf_order) + 1
        self.recent_pts.extend((int(p), born) for p in slots[:n_used])

    # ------------------------------------------------------------------
    def _append_traj(self, ts, pose, ok, ref_slot=-1, ref_pose=None):
        """Record one frame; with a reference keyframe pose, relative to it."""
        Tcr = None
        gen = -1
        if ok and ref_slot >= 0 and ref_pose is not None:
            Tcr = np.asarray(pose, np.float64) @ np.linalg.inv(np.asarray(ref_pose, np.float64))
            gen = int(self.kf_gen[ref_slot])
        self.trajectory.append(
            (ts, pose.copy() if pose is not None else None, bool(ok),
             int(ref_slot) if Tcr is not None else -1, gen, Tcr)
        )

    def _record_culls(self, cull_log):
        for nb, parent, Tcp in cull_log:
            self.cull_repair[(int(nb), int(self.kf_gen[nb]))] = (
                int(parent), int(self.kf_gen[parent]), Tcp,
            )

    def get_trajectory(self):
        """[(timestamp, Tcw or None, ok)], tracked frames recomposed against
        their reference keyframe's current pose (walking cull-repair
        chains to a live keyframe)."""
        self._flush_pipeline()
        kf_pose = self.state.kf_pose.cpu().numpy().astype(np.float64)
        live = set(self.kf_order)
        out = []
        for ts, pose, ok, ref_slot, ref_gen, Tcr in self.trajectory:
            if ok and ref_slot >= 0 and Tcr is not None:
                T = Tcr
                slot, gen = ref_slot, ref_gen
                for _ in range(64):
                    if slot in live and slot < len(self.kf_gen) and int(self.kf_gen[slot]) == gen:
                        pose = (T @ kf_pose[slot]).astype(np.float32)
                        break
                    rep = self.cull_repair.get((slot, gen))
                    if rep is None:
                        break
                    parent, parent_gen, Tcp = rep
                    T = T @ Tcp
                    slot, gen = parent, parent_gen
            out.append((ts, pose, ok))
        return out

    def tracked_ratio(self):
        return self.stats.n_tracked / max(self.stats.n_frames, 1)

    def map_changed(self) -> bool:
        """True once per map mutation epoch, keyframes inserted plus loops
        closed (reference System::MapChanged, src/System.cc:123-125, served
        over the ROS query/response channel, ros_mono.cc:148-159)."""
        idx = self.stats.n_keyframes + (self.loop_closer.n_loops_closed if self.loop_closer else 0)
        changed = idx != self._last_map_change_idx
        self._last_map_change_idx = idx
        return changed

    def get_status(self) -> dict:
        """Health snapshot."""
        self._flush_pipeline()
        return {
            "state": self.tracking_state.name,
            "frames": self.stats.n_frames,
            "tracked_ratio": round(self.tracked_ratio(), 4),
            "keyframes": self.stats.n_keyframes,
            "relocalizations": self.stats.n_reloc,
            "loops_closed": self.loop_closer.n_loops_closed if self.loop_closer else 0,
            "localization_only": self.localization_only,
        }

    def set_localization_mode(self, enabled: bool):
        """Localization-only switching: tracking and relocalization go on,
        mapping and loop closing stop."""
        self._flush_pipeline()
        self.localization_only = enabled

    def reset(self):
        """Full reset: map, database, state machine."""
        self._pending.clear()  # the frames in flight tracked the dying map
        self._carry = None
        self._kf_barrier = 0
        self._bg.clear()
        self.state = mstate.empty(self.map_cfg, self.device)
        self.db = keyframe_db.empty(self.cfg.max_keyframes, self.cfg.n_features, self.device)
        self.tracking_state = TrackingState.NO_IMAGES_YET
        self.velocity = None
        self.last_pose = None
        self.last_frame = None
        self.init_frame = None
        self.ref_kf = 0
        self.kf_order = []
        self.recent_pts = []
        self._next_kf_slot = 0
        self.mapper._next_pt_slot = 0
        self.mapper.mp_valid_host[:] = False
        self.frames_since_kf = 0
        lc = self.loop_closer
        if lc is not None:
            lc.consistent_groups = []
            lc.last_loop_kf_seen = -(10**9)
            lc.loop_edges = []
            lc.gba_idx += 1  # supersede any in-flight global BA
            lc.gba_requested = False

    # The io modules are imported where they are used: io/config.py
    # imports this module.
    def save_trajectory_tum(self, path: str):
        from ..io import trajectory as traj_io

        traj_io.save_trajectory_tum(self.get_trajectory(), path)

    def save_trajectory_kitti(self, path: str):
        from ..io import trajectory as traj_io

        traj_io.save_trajectory_kitti(self.get_trajectory(), path)

    def save_keyframe_trajectory_tum(self, path: str):
        from ..io import trajectory as traj_io

        self._flush_pipeline()
        traj_io.save_keyframe_trajectory_tum(self.state, self.kf_order, self.kf_timestamps, path)

    def save_map(self, path: str):
        """Write the map, the BoW database and the mapping bookkeeping to
        one .npz (the reference's checkpoint format, key for key)."""
        from ..io import checkpoint

        self._flush_pipeline()
        checkpoint.save_system(self, path)

    def load_map(self, path: str, localization_only: bool = True):
        """Load a checkpoint written by this package or by the reference;
        the system starts LOST and relocalizes against the loaded map.
        Frames in flight retire against the map they tracked first."""
        from ..io import checkpoint

        self._flush_pipeline()
        checkpoint.load_into_system(self, path, localization_only)
        self._drop_map_graphs()
