"""System facade, monocular (torch port of the monocular path of
orb_slam_cuda_tpu/engine/system.py).

`System(cfg)` owns the extractor, vocabulary, map state, tracking state
machine, local mapper and loop closer; every tensor it creates lives on
`device`, the card unless the caller passes `device="cpu"` (with no card
and no argument the constructor raises). Ported: `track_monocular` with
`pipeline_lag=0`, two-view initialization, the fused tracking step,
relocalization of lost frames, keyframe creation, local mapping and loop
closing with its chunked global BA (synchronous, or through the
background queue's units when `async_mapping`). Not ported yet, and
refused by the constructor: stereo/RGB-D, the pipelined lag, device
meshes and cluster refinement.
"""

from __future__ import annotations

import enum
import math
from collections import deque
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..frontend.extractor import ExtractorConfig, ORBExtractor
from ..geometry import se3
from ..geometry.camera import Camera
from ..matching import search
from ..slam_map import MapConfig, keyframe_db
from ..slam_map import ops as map_ops
from ..slam_map import state as mstate
from ..solvers import bundle_adjust as ba
from ..solvers import initializer as init_solver
from ..utils.device import resolve as resolve_device
from ..utils.timing import StageTimer
from ..vocab import build_vocabulary
from . import local_mapping, relocalization, tracking
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
    th_depth_factor: float = 35.0
    enable_loop_closing: bool = True
    kf_cull_redundancy: float = 0.9
    kf_ref_ratio: Optional[float] = None
    pipeline_lag: int = 0
    async_mapping: bool = True
    mesh: object = None
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


def _refuse(config: SystemConfig):
    unported = {
        "sensor != MONOCULAR": config.sensor != Sensor.MONOCULAR,
        "pipeline_lag > 0": config.pipeline_lag > 0,
        "mesh": config.mesh is not None,
        "cluster_refine_interval > 0": config.cluster_refine_interval > 0,
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError("not ported yet: " + ", ".join(bad))


def synthetic_vocabulary(vocab_words: int, seed: int = 0):
    """The reference's deterministic default: a k=8 tree trained on random
    descriptors."""
    rng = np.random.default_rng(seed)
    train = rng.integers(0, 2**32, size=(4096, 8), dtype=np.uint32)
    k = 8
    depth = max(2, int(round(math.log(vocab_words) / math.log(k))))
    return build_vocabulary(train, k=k, depth=depth, levelsup_depth=max(1, depth - 2))


class System:
    """End-to-end monocular SLAM engine on one torch device."""

    def __init__(self, config: SystemConfig, vocab=None, seed: int = 0, device="cuda"):
        _refuse(config)
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
        self.state = mstate.empty(self.map_cfg, self.device)
        self.db = keyframe_db.empty(config.max_keyframes, config.n_features, self.device)
        self.mapper = local_mapping.LocalMapper(
            self.map_cfg, cam, kf_cull_redundancy=config.kf_cull_redundancy,
            n_triangulate_neighbors=20, n_fuse_neighbors=40, device=self.device,
        )
        self.scale_factors = tuple(self.map_cfg.scale_factors)

        self.tracking_state = TrackingState.NO_IMAGES_YET
        self.velocity: Optional[np.ndarray] = None
        self.last_pose: Optional[np.ndarray] = None
        self.n_inliers_local = 0
        self.ref_tracked = 0
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
        self.stats = TrackStats()
        self.timer = StageTimer(enabled=True)
        self.reloc_stage_stats = {}
        self.loop_closer = None
        if config.enable_loop_closing:
            self.loop_closer = LoopCloser(self.map_cfg, cam, self.vocab)
            self.loop_closer.timer = self.timer

    def _sync(self):
        return self.device if self.device.type == "cuda" else None

    # ------------------------------------------------------------------
    def track_monocular(self, image, timestamp: float):
        """Track one grayscale frame (numpy array or tensor, on any
        device). Returns the 4x4 Tcw (np.ndarray) or None while
        uninitialized/lost."""
        self.timer.set_frame(self.frame_id)
        # As the reference's synchronous path does, the previous frames'
        # deferred mapping and loop units finish before this frame tracks.
        self._drain_background()
        with self.timer.stage("times.csv", "orb_extract", sync=self._sync()):
            feats = self.extractor(image)
        with self.timer.stage("times.csv", "build_frame", sync=self._sync()):
            frame = build_frame(feats, self.cam, self.vocab)
        with self.timer.stage("timesTracking.csv", "track", sync=self._sync()):
            pose = self._track(frame, timestamp)
        self.frame_id += 1
        return pose

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
            res = tracking.full_track_step(
                self.state, frame, pose_pred.astype(np.float32), self.last_pose.astype(np.float32),
                lf.uv, lf.oct, lf.ang, lf.bip, lf.mp, lf.depth,
                self.ref_kf, min_obs, self.cam, self.scale_factors,
                tracking.MOTION_MODEL_RADIUS,
            )
            vec = res.host_vec.cpu().numpy()
            scal = vec[:9].astype(np.int64)
            ok = bool(scal[0])
            self.state = self.state._replace(mp_visible=res.mp_visible, mp_found=res.mp_found)
            self.ref_kf = int(scal[2])
            self.n_inliers_local = int(scal[1])
            self.ref_tracked = int(scal[3])
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

        if ok:
            self.tracking_state = TrackingState.OK
            self.stats.n_tracked += 1
            if self.last_pose is not None:
                self.velocity = pose @ np.linalg.inv(self.last_pose)
            self.last_pose = pose
            self.frames_since_kf += 1
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
                self.kf_timestamps[self.ref_kf] = timestamp
        else:
            self.tracking_state = TrackingState.LOST
            self.stats.n_lost += 1
            self.velocity = None
            # Lost right after initialization -> full reset.
            if 0 < len(self.kf_order) <= 5:
                self.reset()

        self._append_traj(
            timestamp, pose if ok else None, bool(ok),
            ref_slot_frame if ref_pose is not None else -1, ref_pose,
        )
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

    def _relocalize(self, frame: FrameData):
        """BoW candidates from the database, BoW matching, EPnP RANSAC and
        the staged pose ladder; on success the frame keeps its bindings."""
        with self.timer.stage("timesTracking.csv", "relocalize", sync=self._sync()):
            pose, mp, ok = relocalization.relocalize(
                self.state, self.db, frame, self.cam, self.vocab.n_words,
                self.scale_factors, stats=self.reloc_stage_stats,
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
        """NeedNewKeyFrame, monocular: c1a (max interval) or c1b (min
        interval and mapper idle), gated by c2 (weakening vs the reference
        keyframe, with the survival-floor clamp, and > 15 inliers)."""
        if len(self.kf_order) == 0:
            return False
        inliers = self.n_inliers_local
        idle = not any(u[0] == "map_finish" for u in self._bg)
        th_ref = self.cfg.kf_ref_ratio if self.cfg.kf_ref_ratio is not None else 0.9
        c1a = self.frames_since_kf >= self.cfg.max_frames_between_kf
        c1b = self.frames_since_kf >= self.cfg.min_frames_between_kf and idle
        weak = (
            th_ref > 1.0
            or inliers < self.ref_tracked * th_ref
            or inliers < 2 * tracking.MIN_INLIERS_LOCAL
        )
        c2 = weak and inliers > 15
        if not ((c1a or c1b) and c2):
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
        wu, wt = keyframe_db.compute_bow_row(frame.word, frame.idf, frame.valid)
        self.db = keyframe_db.insert(self.db, slot, wu, wt)
        self.kf_order.append(slot)
        self.ref_kf = slot
        self.frames_since_kf = 0
        self.stats.n_keyframes += 1

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
        self._drain_background()
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

    def get_status(self) -> dict:
        """Health snapshot."""
        self._drain_background()
        return {
            "state": self.tracking_state.name,
            "frames": self.stats.n_frames,
            "tracked_ratio": round(self.tracked_ratio(), 4),
            "keyframes": self.stats.n_keyframes,
            "relocalizations": self.stats.n_reloc,
            "loops_closed": self.loop_closer.n_loops_closed if self.loop_closer else 0,
        }

    def reset(self):
        """Full reset: map, database, state machine."""
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

    def save_trajectory_tum(self, path: str):
        """TUM format: `t tx ty tz qx qy qz qw` of Twc per tracked frame."""
        with open(path, "w") as f:
            for t, Tcw, ok in self.get_trajectory():
                if not ok or Tcw is None:
                    continue
                Twc = np.linalg.inv(np.asarray(Tcw, np.float64))
                q = se3.rot_to_quat(torch.as_tensor(Twc[:3, :3])).numpy()
                tx, ty, tz = Twc[:3, 3]
                f.write(f"{t:.6f} {tx:.7f} {ty:.7f} {tz:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
