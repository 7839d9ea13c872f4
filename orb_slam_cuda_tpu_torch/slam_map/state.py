"""The map as a struct of tensors with static capacities (torch port of
orb_slam_cuda_tpu/slam_map/state.py).

Updates are functional, as in the reference: each returns a new
`MapState` whose changed fields are fresh tensors, so a state held by a
caller never changes under it. Scatters route padding to a trash row
that is sliced off, never onto index 0. A keyframe slot is a Python int
or a slot tensor (0-d or one element): the mapping programs pass tensors,
which index without reading a value back and are not frozen into a
captured graph.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.segsum import last_writes


class MapConfig(NamedTuple):
    max_keyframes: int = 256  # K
    max_features: int = 1024  # N per keyframe
    max_points: int = 32768  # P
    n_levels: int = 8
    scale_factor: float = 1.2

    @property
    def scale_factors(self):
        return tuple(self.scale_factor**i for i in range(self.n_levels))

    @property
    def level_sigma2(self):
        return tuple((self.scale_factor**i) ** 2 for i in range(self.n_levels))

    @property
    def log_scale_factor(self):
        return float(np.log(self.scale_factor))


class MapState(NamedTuple):
    """All SLAM map state; field meanings as in the reference. Packed
    descriptors are int32; kf_mp (K,N) int32 is the observation table."""

    kf_pose: torch.Tensor
    kf_valid: torch.Tensor
    kf_frame_id: torch.Tensor
    kf_uv: torch.Tensor
    kf_right: torch.Tensor
    kf_depth: torch.Tensor
    kf_oct: torch.Tensor
    kf_ang: torch.Tensor
    kf_desc: torch.Tensor
    kf_feat_valid: torch.Tensor
    kf_word: torch.Tensor
    kf_node: torch.Tensor
    kf_mp: torch.Tensor
    covis: torch.Tensor
    mp_xyz: torch.Tensor
    mp_valid: torch.Tensor
    mp_desc: torch.Tensor
    mp_normal: torch.Tensor
    mp_min_dist: torch.Tensor
    mp_max_dist: torch.Tensor
    mp_ref_kf: torch.Tensor
    mp_first_kf: torch.Tensor
    mp_visible: torch.Tensor
    mp_found: torch.Tensor

    @property
    def capacity(self):
        return tuple(self.kf_mp.shape)

    @property
    def device(self):
        return self.kf_mp.device

    def n_keyframes(self):
        return torch.sum(self.kf_valid)

    def n_points(self):
        return torch.sum(self.mp_valid)


_I32, _F32 = torch.int32, torch.float32


def _kf_fill(K, N, device):
    """Per-keyframe field shapes and fill values of a free slot."""
    return dict(
        kf_valid=((K,), torch.bool, False),
        kf_frame_id=((K,), _I32, -1),
        kf_uv=((K, N, 2), _F32, 0.0),
        kf_right=((K, N), _F32, -1.0),
        kf_depth=((K, N), _F32, -1.0),
        kf_oct=((K, N), _I32, 0),
        kf_ang=((K, N), _F32, 0.0),
        kf_desc=((K, N, 8), _I32, 0),
        kf_feat_valid=((K, N), torch.bool, False),
        kf_word=((K, N), _I32, -1),
        kf_node=((K, N), _I32, -1),
        kf_mp=((K, N), _I32, -1),
    )


def _mp_fill(P):
    return dict(
        mp_xyz=((P, 3), _F32, 0.0),
        mp_valid=((P,), torch.bool, False),
        mp_desc=((P, 8), _I32, 0),
        mp_normal=((P, 3), _F32, 0.0),
        mp_min_dist=((P,), _F32, 0.0),
        mp_max_dist=((P,), _F32, 1e9),
        mp_ref_kf=((P,), _I32, -1),
        mp_first_kf=((P,), _I32, -1),
        mp_visible=((P,), _F32, 1.0),
        mp_found=((P,), _F32, 1.0),
    )


def _eyes(K, device):
    return torch.eye(4, dtype=_F32, device=device).repeat(K, 1, 1)


def empty(cfg: MapConfig, device="cpu") -> MapState:
    K, N, P = cfg.max_keyframes, cfg.max_features, cfg.max_points
    fields = {**_kf_fill(K, N, device), **_mp_fill(P)}
    out = {k: torch.full(s, v, dtype=d, device=device) for k, (s, d, v) in fields.items()}
    return MapState(
        kf_pose=_eyes(K, device),
        covis=torch.zeros((K, K), dtype=_I32, device=device),
        **out,
    )


def grow_keyframes(state: MapState, new_K: int) -> MapState:
    """Copy with keyframe capacity padded to new_K (new rows are free)."""
    K_old = state.kf_valid.shape[0]
    if new_K <= K_old:
        return state
    pad = new_K - K_old
    N = state.kf_mp.shape[1]
    dev = state.device
    upd = {}
    for name, (shape, dtype, fill) in _kf_fill(pad, N, dev).items():
        upd[name] = torch.cat([getattr(state, name), torch.full(shape, fill, dtype=dtype, device=dev)])
    covis = torch.zeros((new_K, new_K), dtype=_I32, device=dev)
    covis[:K_old, :K_old] = state.covis
    return state._replace(
        kf_pose=torch.cat([state.kf_pose, _eyes(pad, dev)]), covis=covis, **upd
    )


def grow_points(state: MapState, new_P: int) -> MapState:
    """Copy with map-point capacity padded to new_P (new rows free)."""
    P_old = state.mp_valid.shape[0]
    if new_P <= P_old:
        return state
    dev = state.device
    upd = {}
    for name, (shape, dtype, fill) in _mp_fill(new_P - P_old).items():
        upd[name] = torch.cat([getattr(state, name), torch.full(shape, fill, dtype=dtype, device=dev)])
    return state._replace(**upd)


def slot_index(slot, device):
    """A keyframe slot (a Python int, or a tensor of one element) as a (1,)
    int64 index. A 0-d tensor index would be turned into a Python int, a
    read-back on the card."""
    if torch.is_tensor(slot):
        return slot.reshape(1).long()
    return torch.full((1,), int(slot), dtype=torch.int64, device=device)


def _set_row(arr, slot, value):
    """A copy of `arr` with row `slot` (a (1,) index) set to `value`, a
    tensor or a Python scalar (written by a fill: a scalar assigned through
    an index is copied from the host)."""
    out = arr.clone()
    if torch.is_tensor(value):
        out[slot] = value.to(arr.dtype)
    else:
        out.index_fill_(0, slot, value)
    return out


def insert_keyframe(state: MapState, slot, pose, frame_id, uv, right, depth,
                    oct_, ang, desc, feat_valid, word, node, mp_assoc) -> MapState:
    """Write a keyframe into `slot` (Map::AddKeyFrame + KeyFrame ctor);
    `frame_id` an int or a 0-d tensor."""
    slot = slot_index(slot, state.device)
    return state._replace(
        kf_pose=_set_row(state.kf_pose, slot, pose),
        kf_valid=_set_row(state.kf_valid, slot, True),
        kf_frame_id=_set_row(state.kf_frame_id, slot, frame_id if torch.is_tensor(frame_id) else int(frame_id)),
        kf_uv=_set_row(state.kf_uv, slot, uv),
        kf_right=_set_row(state.kf_right, slot, right),
        kf_depth=_set_row(state.kf_depth, slot, depth),
        kf_oct=_set_row(state.kf_oct, slot, oct_),
        kf_ang=_set_row(state.kf_ang, slot, ang),
        kf_desc=_set_row(state.kf_desc, slot, desc),
        kf_feat_valid=_set_row(state.kf_feat_valid, slot, feat_valid),
        kf_word=_set_row(state.kf_word, slot, word),
        kf_node=_set_row(state.kf_node, slot, node),
        kf_mp=_set_row(state.kf_mp, slot, mp_assoc),
    )


def add_points(state: MapState, slots, xyz, valid, desc, normal, min_dist,
               max_dist, ref_kf, first_kf) -> MapState:
    """Batch-insert map points into `slots` (unique indices); rows with
    ~valid leave their slot untouched."""
    slots = slots.long()

    def w(arr, vals):
        m = valid.reshape(valid.shape + (1,) * (vals.dim() - 1))
        out = arr.clone()
        out[slots] = torch.where(m, vals.to(arr.dtype), arr[slots])
        return out

    one = torch.ones_like(state.mp_visible[slots])
    return state._replace(
        mp_xyz=w(state.mp_xyz, xyz),
        mp_valid=w(state.mp_valid, torch.ones_like(valid)),
        mp_desc=w(state.mp_desc, desc),
        mp_normal=w(state.mp_normal, normal),
        mp_min_dist=w(state.mp_min_dist, min_dist),
        mp_max_dist=w(state.mp_max_dist, max_dist),
        mp_ref_kf=w(state.mp_ref_kf, ref_kf),
        mp_first_kf=w(state.mp_first_kf, first_kf),
        mp_visible=w(state.mp_visible, one),
        mp_found=w(state.mp_found, one),
    )


def bind_observations(state: MapState, kf_slot, feat_idx, point_idx, valid) -> MapState:
    """kf_mp[kf_slot, feat_idx[i]] = point_idx[i] where valid[i]. Invalid
    rows go to a trash column, so they cannot overwrite feature 0."""
    N = state.kf_mp.shape[1]
    kf_slot = slot_index(kf_slot, state.device)
    row = torch.cat([state.kf_mp[kf_slot][0], state.kf_mp.new_full((1,), -1)])
    idx = torch.where(valid, feat_idx.long(), torch.full_like(feat_idx, N, dtype=torch.int64))
    # A feature written twice keeps the later point, as a serial scatter does.
    idx = torch.where(last_writes(idx, N + 1), idx, torch.full_like(idx, N))
    row[idx] = point_idx.to(row.dtype)
    return state._replace(kf_mp=_set_row(state.kf_mp, kf_slot, row[:N]))


def erase_points(state: MapState, point_mask) -> MapState:
    """Invalidate points and unbind every observation of them."""
    kf_mp = state.kf_mp
    observed_bad = (kf_mp >= 0) & point_mask[torch.clamp(kf_mp, min=0).long()]
    return state._replace(
        mp_valid=state.mp_valid & ~point_mask,
        kf_mp=torch.where(observed_bad, torch.full_like(kf_mp, -1), kf_mp),
    )


def slot_mask(slot, n: int, device):
    """(n,) bool: True at a slot (int or slot tensor); a (n,) bool tensor
    is a mask of slots already."""
    if torch.is_tensor(slot) and slot.dtype == torch.bool:
        return slot
    return torch.zeros((n,), dtype=torch.bool, device=device).index_fill_(0, slot_index(slot, device), True)


def erase_keyframe(state: MapState, kf_slot) -> MapState:
    """Invalidate a keyframe (a slot, or a (K,) bool mask of slots), its
    observation row and covisibility."""
    gone = slot_mask(kf_slot, state.kf_valid.shape[0], state.device)
    return state._replace(
        kf_valid=state.kf_valid & ~gone,
        kf_mp=torch.where(gone[:, None], torch.full_like(state.kf_mp, -1), state.kf_mp),
        kf_feat_valid=state.kf_feat_valid & ~gone[:, None],
        covis=torch.where(gone[:, None] | gone[None, :], torch.zeros_like(state.covis), state.covis),
    )
