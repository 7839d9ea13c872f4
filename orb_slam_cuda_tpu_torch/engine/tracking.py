"""Tracking: motion model, reference-keyframe fallback, local-map tracking,
the fused per-frame step, the pipelined step and the localization-mode
visual odometry (torch port of orb_slam_cuda_tpu/engine/tracking.py).

The reference's per-frame step is one jitted program whose two
`lax.cond`s (the widened motion-model retry and the reference-keyframe
fallback) run only the branch they pick. The port has two forms of it:
`full_track_step` takes those branches with host `if`s (each a read-back
of a 0-d tensor), for the synchronous path; `full_track_step_sync_free`
computes both sides of each and picks with `torch.where`, so the
pipelined step (`fused_pipeline_step`, with its `TrackCarry`) queues a
whole frame on the device without one host sync, at the price of the
launches of the branches not taken. Both give the values the reference's
`lax.cond` picks."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..geometry.camera import Camera
from ..matching import search
from ..ops import hamming
from ..ops.segsum import last_writes
from ..slam_map import MapState
from ..slam_map import ops as map_ops
from ..solvers import pose_opt
from .frame import FrameData

MOTION_MODEL_RADIUS = 15.0
MOTION_MODEL_RADIUS_STEREO = 7.0
MIN_MATCHES_MOTION = 20
MIN_INLIERS_TRACK = 10
MIN_MATCHES_REF_KF = 15
MIN_INLIERS_LOCAL = 30


class TrackCarry(NamedTuple):
    """What frame n+1's pipelined step needs from frame n, all on the
    device: the last tracked pose, the constant-velocity model (identity
    when unknown), the last frame's features and bindings, and the
    reference keyframe slot as a 0-d int64 tensor."""

    pose: torch.Tensor  # (4,4) Tcw of the last tracked frame
    vel: torch.Tensor  # (4,4)
    uv: torch.Tensor  # (N,2)
    oct: torch.Tensor
    ang: torch.Tensor
    bip: torch.Tensor
    depth: torch.Tensor  # (N,) (<0 unknown; all <0 monocular)
    mp: torch.Tensor  # (N,) bindings
    ref_kf: torch.Tensor  # () int64


def _slot(ref_kf, device):
    """A keyframe slot (int or 0-d tensor) as a (1,) index: rows are then
    gathered on the device, where `x[t]` with a 0-d tensor reads t back."""
    return torch.as_tensor(ref_kf, device=device).reshape(1).long()


def inv_level_sigma2(scale_factors, octave):
    """Per-observation information 1/sigma2[octave]."""
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=octave.device)
    sigma2 = sf * sf
    return 1.0 / sigma2[torch.clamp(octave.long(), 0, sf.shape[0] - 1)]


def _bind(n, target_idx, values, ok, base=None):
    """(n,) int32 bindings: out[target_idx[q]] = values[q] where ok[q],
    else `base` (or -1). Unmatched rows write into a trash slot, so they
    cannot clobber a real match to feature 0. Two rows matched to one
    target (equal distances can tie in the duplicate resolution): the
    later row's value, as a serial scatter leaves it."""
    dev = target_idx.device
    out = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    if base is not None:
        out[:n] = base
    idx = _trash_unless(ok, target_idx, n)
    out[idx] = values.to(torch.int32)
    return out[:n]


def _trash_unless(ok, target_idx, n):
    """Scatter index: `target_idx` where `ok` and it is the last row to
    write its target, else the trash slot n."""
    idx = torch.where(ok, target_idx.long(), torch.full_like(target_idx, n, dtype=torch.int64))
    return torch.where(last_writes(idx, n + 1), idx, torch.full_like(idx, n))


def track_motion_model(state: MapState, frame: FrameData, pose_pred, last_uv,
                       last_oct, last_ang, last_bip, last_mp, last_depth,
                       pose_last, cam: Camera, scale_factors, radius,
                       th_depth: float = 0.0):
    """TrackWithMotionModel: project the last frame's bound points into
    the predicted pose, window-match, then pose-only LM. Temporal VO
    points (close-depth unbound features) join when th_depth > 0."""
    is_map = last_mp >= 0
    safe_mp = torch.clamp(last_mp, min=0).long()
    valid_map = is_map & state.mp_valid[safe_mp]
    Xw_map = state.mp_xyz[safe_mp]
    is_temp = ~is_map & (last_depth > 0) & (last_depth < th_depth)
    Xw_temp = se3.transform(
        se3.inverse(pose_last),
        cam_mod.backproject(cam, last_uv, torch.clamp(last_depth, min=1e-6)),
    )
    Xw = torch.where(is_map[:, None], Xw_map, Xw_temp)
    Xc = se3.transform(pose_pred, Xw)
    proj = cam_mod.project(cam, Xc)
    q_valid = (valid_map | is_temp) & (Xc[:, 2] > 0)

    m = search.by_projection(
        proj, last_bip, q_valid, last_oct,
        frame.uv, frame.oct, frame.ang, frame.bip, frame.valid,
        scale_factors, radius=radius,
        q_ang=last_ang, max_dist=100.0, ratio=0.9, check_rotation=True,
    )
    n = frame.capacity
    ok = m.idx >= 0
    mp_new = _bind(n, m.idx, last_mp, ok & is_map)
    temp_ok = ok & is_temp
    tidx = _trash_unless(temp_ok, m.idx, n)
    temp_bound = torch.zeros((n + 1,), dtype=torch.bool, device=Xw.device)
    temp_bound.index_fill_(0, tidx, True)
    temp_Xw = torch.zeros((n + 1, 3), dtype=torch.float32, device=Xw.device)
    temp_Xw[tidx] = Xw
    n_matches = torch.sum(ok)
    pose, mp_out, n_inl = _optimize_and_prune(
        state, frame, pose_pred, mp_new, cam, scale_factors,
        extra_Xw=temp_Xw[:n], extra_bound=temp_bound[:n],
    )
    return pose, mp_out, n_matches, n_inl


def track_reference_kf(state: MapState, frame: FrameData, pose_init, ref_kf,
                       cam: Camera, scale_factors):
    """TrackReferenceKeyFrame: BoW-gated matching against the reference
    keyframe's points, then pose-only LM from the last pose."""
    ref = _slot(ref_kf, state.device)
    kf_bip = hamming.bipolar(state.kf_desc[ref][0])
    kf_mp = state.kf_mp[ref][0]
    kf_has_pt = (kf_mp >= 0) & state.mp_valid[torch.clamp(kf_mp, min=0).long()]
    m = search.by_bow(
        state.kf_node[ref][0], kf_bip, state.kf_feat_valid[ref][0], state.kf_ang[ref][0],
        frame.node, frame.bip, frame.valid, frame.ang,
        ratio=0.7, check_rotation=True, f1_has_point=kf_has_pt,
    )
    ok = m.idx >= 0
    mp_new = _bind(frame.capacity, m.idx, kf_mp, ok)
    n_matches = torch.sum(ok)
    pose, mp_out, n_inl = _optimize_and_prune(state, frame, pose_init, mp_new, cam, scale_factors)
    return pose, mp_out, n_matches, n_inl


def _optimize_and_prune(state, frame, pose0, mp, cam, scale_factors,
                        extra_Xw=None, extra_bound=None):
    """Pose-only LM on the bindings, then unbind chi2 outliers; the inlier
    count is map-only."""
    bound = (mp >= 0) & frame.valid
    Xw = state.mp_xyz[torch.clamp(mp, min=0).long()]
    if extra_bound is not None:
        eb = extra_bound & frame.valid & ~bound
        Xw = torch.where(bound[:, None], Xw, extra_Xw)
        bound_all = bound | eb
    else:
        bound_all = bound
    inv_sigma2 = inv_level_sigma2(scale_factors, frame.oct)
    res = pose_opt.optimize_pose(pose0, Xw, frame.uv, frame.right, inv_sigma2, bound_all, cam)
    mp_out = torch.where(res.inliers, mp, torch.full_like(mp, -1))
    n_inl = torch.sum(res.inliers & (mp >= 0))
    return res.pose, mp_out, n_inl


def track_vo_last_frame(frame: FrameData, last_uv, last_oct, last_ang, last_bip,
                        last_depth, last_valid, pose_last, pose_pred, cam: Camera,
                        scale_factors, radius):
    """Localization-mode visual odometry (mbVO): track frame to frame
    against the points backprojected from the LAST frame's own depths, no
    map involved. Returns (pose, n_matches, n_inliers). Monocular frames
    carry no depth, so the path is inert for them.

    Unmatched rows go to a trash row; the reference scatters them onto
    feature 0 with that feature's own value, which leaves it unchanged
    except where a real match to feature 0 is written in the same
    scatter."""
    dev = frame.uv.device
    pose_last = torch.as_tensor(pose_last, dtype=torch.float32, device=dev)
    pose_pred = torch.as_tensor(pose_pred, dtype=torch.float32, device=dev)
    Xc_last = cam_mod.backproject(cam, last_uv, torch.clamp(last_depth, min=1e-6))
    Xw = se3.transform(se3.inverse(pose_last), Xc_last)
    Xc = se3.transform(pose_pred, Xw)
    proj = cam_mod.project(cam, Xc)
    q_valid = last_valid & (last_depth > 0) & (Xc[:, 2] > 0)

    m = search.by_projection(
        proj, last_bip, q_valid, last_oct,
        frame.uv, frame.oct, frame.ang, frame.bip, frame.valid,
        scale_factors, radius=radius,
        q_ang=last_ang, max_dist=100.0, ratio=0.9, check_rotation=True,
    )
    ok = m.idx >= 0
    n = frame.capacity
    tidx = _trash_unless(ok, m.idx, n)
    Xw_f = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev)
    Xw_f[tidx] = Xw
    bound = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    bound.index_fill_(0, tidx, True)
    inv_sigma2 = inv_level_sigma2(scale_factors, frame.oct)
    res = pose_opt.optimize_pose(pose_pred, Xw_f[:n], frame.uv, frame.right, inv_sigma2,
                                 bound[:n] & frame.valid, cam)
    return res.pose, torch.sum(ok), res.n_inliers


def assemble_local_map(state: MapState, frame_mp, max_local_kfs: int = 20):
    """UpdateLocalKeyFrames + UpdateLocalPoints. Returns (local_kf_mask
    (K,), local_pt_mask (P,), ref_kf best-sharing keyframe slot)."""
    K = state.kf_valid.shape[0]
    counts = map_ops.covisibility_counts_for_bindings(state, frame_mp)
    sharing = counts > 0
    ref_kf = torch.argmax(counts)
    top = map_ops.top_covisible(counts, max_local_kfs)
    kf_mask = map_ops.mark(K, torch.clamp(top, min=0), top >= 0) & sharing
    neigh_w = torch.amax(torch.where(kf_mask[:, None], state.covis, torch.zeros_like(state.covis)), dim=0)
    top_n = map_ops.top_covisible(neigh_w, 10)
    kf_mask = (kf_mask | map_ops.mark(K, torch.clamp(top_n, min=0), top_n >= 0)) & state.kf_valid
    pt_mask = map_ops.points_of_keyframes(state, kf_mask)
    return kf_mask, pt_mask, ref_kf


def track_local_map(state: MapState, frame: FrameData, pose, local_pt_mask,
                    cam: Camera, scale_factors, radius):
    """SearchLocalPoints + pose refinement: frustum-cull the local points,
    window-match the unmatched ones, re-run pose-only LM on all bindings."""
    P = state.mp_xyz.shape[0]
    already = map_ops.mark(P, torch.clamp(frame.mp, min=0), frame.mp >= 0)
    cand = local_pt_mask & state.mp_valid & ~already

    Xc = se3.transform(pose, state.mp_xyz)
    proj = cam_mod.project(cam, Xc)
    in_img = (
        (proj[:, 0] >= 0) & (proj[:, 0] < cam.width)
        & (proj[:, 1] >= 0) & (proj[:, 1] < cam.height)
    )
    in_front = Xc[:, 2] > 0
    Rwc_t = -(pose[:3, :3].T @ pose[:3, 3])
    vec = state.mp_xyz - Rwc_t[None, :]
    dist = torch.linalg.norm(vec, dim=-1)
    dist_ok = (dist >= state.mp_min_dist * 0.6) & (dist <= state.mp_max_dist * 1.6)
    view_cos = torch.sum(vec * state.mp_normal, dim=-1) / torch.clamp(dist, min=1e-9)
    visible = cand & in_front & in_img & dist_ok & (view_cos > 0.5)

    n_lvls = len(scale_factors)
    log_sf = torch.log(torch.as_tensor(scale_factors, dtype=torch.float32, device=pose.device)[1])
    pred_oct = search.predict_octave(dist, state.mp_max_dist, log_sf, n_lvls)
    r_scale = torch.where(view_cos > 0.998, torch.full_like(view_cos, 2.5),
                          torch.full_like(view_cos, 4.0)) / 4.0

    m = search.by_projection(
        proj, hamming.bipolar(state.mp_desc), visible, pred_oct,
        frame.uv, frame.oct, frame.ang, frame.bip, frame.valid,
        scale_factors, radius=radius * 4.0, q_radius_scale=r_scale,
        max_dist=100.0, ratio=0.8, t_has_point=frame.mp >= 0,
    )
    pt_ids = torch.arange(P, dtype=torch.int32, device=pose.device)
    mp_new = _bind(frame.capacity, m.idx, pt_ids, m.idx >= 0, base=frame.mp)
    pose2, mp_out, n_inl = _optimize_and_prune(state, frame, pose, mp_new, cam, scale_factors)
    return pose2, mp_out, n_inl, torch.sum(visible), visible


class FullStepResult(NamedTuple):
    """Output of the per-frame step. `host_vec` float32 (41,): the 9
    state-machine scalars [track_ok, n_inliers_local, ref_kf, ref_tracked,
    n_matches_mm, n_inl_mm, used_fallback, n_tracked_close,
    n_nontracked_close], the 4x4 frame pose, and the 4x4 pose of the
    reference keyframe."""

    pose: torch.Tensor
    mp: torch.Tensor
    mp_visible: torch.Tensor
    mp_found: torch.Tensor
    scalars: torch.Tensor
    host_vec: torch.Tensor


def _motion_ok(n_matches, n_inliers):
    return (n_matches >= MIN_MATCHES_MOTION) & (n_inliers >= MIN_INLIERS_TRACK)


def _pick(cond, a, b):
    """Element-wise `a if cond else b` over tuples of tensors."""
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def full_track_step(state: MapState, frame: FrameData, pose_pred, pose_last,
                    last_uv, last_oct, last_ang, last_bip, last_mp, last_depth,
                    ref_kf, min_obs, cam: Camera, scale_factors, radius_mm,
                    th_depth: float = 0.0, vo_th_depth: float = 0.0) -> FullStepResult:
    """The per-frame tracking pipeline: motion model (with the doubled
    window retry), reference-KF fallback, local map, visibility stats and
    the keyframe-policy counters. The two branches are host `if`s."""
    dev = state.device
    pose_pred = torch.as_tensor(pose_pred, dtype=torch.float32, device=dev)
    pose_last = torch.as_tensor(pose_last, dtype=torch.float32, device=dev)
    ref_kf = torch.full((), int(ref_kf), dtype=torch.int64, device=dev)
    last_mp = map_ops.sanitize_bindings(state, last_mp)

    args = (state, frame, pose_pred, last_uv, last_oct, last_ang, last_bip,
            last_mp, last_depth, pose_last, cam, scale_factors)
    r1 = track_motion_model(*args, radius_mm, vo_th_depth)
    if int(r1[2]) < MIN_MATCHES_MOTION:
        r1 = track_motion_model(*args, 2.0 * radius_mm, vo_th_depth)
    ok1 = _motion_ok(r1[2], r1[3])
    r2 = r1 if bool(ok1) else track_reference_kf(state, frame, pose_last, ref_kf, cam, scale_factors)
    return _track_local_map_tail(state, frame, r1, ok1, r2, ref_kf, min_obs, cam, scale_factors, th_depth)


def full_track_step_sync_free(state: MapState, frame: FrameData, pose_pred, pose_last,
                              last_uv, last_oct, last_ang, last_bip, last_mp, last_depth,
                              ref_kf, min_obs, cam: Camera, scale_factors, radius_mm,
                              th_depth: float = 0.0, vo_th_depth: float = 0.0) -> FullStepResult:
    """`full_track_step` without a host sync: the widened retry and the
    reference-keyframe fallback always run, and `torch.where` picks what
    the reference's `lax.cond`s pick. `pose_pred`, `pose_last` and `ref_kf`
    (0-d) are tensors on the map's device, and so is `scale_factors` on a
    CUDA device (a tuple there is copied to the card, which syncs)."""
    # First: the carry is L frames stale, and a binding to a point slot
    # culled (and maybe reused) since then must not alias another point.
    last_mp = map_ops.sanitize_bindings(state, last_mp)
    args = (state, frame, pose_pred, last_uv, last_oct, last_ang, last_bip,
            last_mp, last_depth, pose_last, cam, scale_factors)
    r1 = track_motion_model(*args, radius_mm, vo_th_depth)
    r1_wide = track_motion_model(*args, 2.0 * radius_mm, vo_th_depth)
    r1 = _pick(r1[2] < MIN_MATCHES_MOTION, r1_wide, r1)
    ok1 = _motion_ok(r1[2], r1[3])
    r2 = _pick(ok1, r1, track_reference_kf(state, frame, pose_last, ref_kf, cam, scale_factors))
    return _track_local_map_tail(state, frame, r1, ok1, r2, ref_kf, min_obs, cam, scale_factors, th_depth)


def _track_local_map_tail(state, frame, r1, ok1, r2, ref_kf, min_obs, cam, scale_factors, th_depth):
    """From the motion-model result `r1` (ok1) and the chosen result `r2`:
    local map, visibility statistics, keyframe-policy counters and the
    host vector. `ref_kf` is the incoming reference slot (0-d tensor)."""
    dev = state.device
    pose2, mp2, n_m2, n_i2 = r2
    ok2 = ok1 | ((n_m2 >= MIN_MATCHES_REF_KF) & (n_i2 >= MIN_INLIERS_TRACK))

    _, pt_mask, ref_kf_new = assemble_local_map(state, mp2, 20)
    pose3, mp3, n_i3, _, visible = track_local_map(
        state, frame._replace(mp=mp2), pose2, pt_mask, cam, scale_factors, 1.0,
    )
    pose3 = se3.orthonormalize(pose3)
    ok3 = ok2 & (n_i3 >= MIN_INLIERS_LOCAL)
    # A failed frame keeps the incoming reference keyframe.
    ref_kf_new = torch.where(ok3, ref_kf_new, ref_kf)

    P = state.mp_xyz.shape[0]
    mp_visible = state.mp_visible + visible.to(torch.float32)
    found_add = torch.zeros((P,), dtype=torch.float32, device=dev).index_add_(
        0, torch.clamp(mp3, min=0).long(), (mp3 >= 0).to(torch.float32))
    mp_found = state.mp_found + found_add

    ref_tracked = count_ref_tracked(state, ref_kf_new, min_obs)
    close = frame.valid & (frame.depth > 0) & (frame.depth < th_depth)
    n_close_tracked = torch.sum(close & (mp3 >= 0))
    n_close_untracked = torch.sum(close & (mp3 < 0))

    scalars = torch.stack([
        x.to(torch.int64).reshape(()) for x in
        (ok3, n_i3, ref_kf_new, ref_tracked, r1[2], r1[3], ~ok1, n_close_tracked, n_close_untracked)
    ])
    ref_pose = state.kf_pose[_slot(ref_kf_new, dev)][0]
    host_vec = torch.cat([scalars.to(torch.float32), pose3.reshape(16), ref_pose.reshape(16)])
    return FullStepResult(pose=pose3, mp=mp3, mp_visible=mp_visible,
                          mp_found=mp_found, scalars=scalars, host_vec=host_vec)


def fused_pipeline_step(state: MapState, image, carry: TrackCarry, min_obs,
                        extract_impl, build_frame_fn, cam: Camera, scale_factors,
                        radius_mm, th_depth: float = 0.0, vo_th_depth: float = 0.0):
    """Extraction, frame build, the sync-free tracking step and the
    velocity update, queued on the device in one call without a host sync:
    the pipelined hot path. The host reads `res.host_vec` L frames later.
    `image` is on the map's device; returns (frame, result, next carry)."""
    feats = extract_impl(image)
    frame = build_frame_fn(feats)
    pose_pred = carry.vel @ carry.pose
    res = full_track_step_sync_free(
        state, frame, pose_pred, carry.pose,
        carry.uv, carry.oct, carry.ang, carry.bip, carry.mp, carry.depth,
        carry.ref_kf, min_obs, cam, scale_factors, radius_mm, th_depth, vo_th_depth,
    )
    ok = res.scalars[0] > 0
    eye = torch.eye(4, dtype=torch.float32, device=carry.pose.device)
    vel_new = torch.where(ok, res.pose @ se3.inverse(carry.pose), eye)
    pose_new = torch.where(ok, res.pose, carry.pose)
    carry_new = TrackCarry(
        pose=pose_new, vel=vel_new, uv=frame.uv, oct=frame.oct, ang=frame.ang,
        bip=frame.bip, depth=frame.depth, mp=res.mp, ref_kf=res.scalars[2],
    )
    return frame, res, carry_new


def count_ref_tracked(state: MapState, ref_kf, min_obs):
    """TrackedMapPoints of the reference KF (KeyFrame::TrackedMapPoints)."""
    obs = map_ops.observation_counts(state)
    mp = state.kf_mp[_slot(ref_kf, state.device)][0]
    ok = (mp >= 0) & (obs[torch.clamp(mp, min=0).long()] >= min_obs)
    return torch.sum(ok)
