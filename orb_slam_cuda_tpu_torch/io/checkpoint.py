"""Map checkpoint / resume (torch port of orb_slam_cuda_tpu/io/checkpoint.py).

The map is a flat tuple of arrays, so a save is one npz: `map_<field>`,
`db_<field>`, `kf_order`, `format_version` and `extra_<name>`, key for key
the reference package's file. Packed descriptor words are stored as
uint32, as the reference stores them, and read back as the int32 that
holds the same bits; a file written by either package loads into the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..slam_map import keyframe_db as kdb
from ..slam_map import ops as map_ops
from ..slam_map.state import MapState

FORMAT_VERSION = 1
# Fields whose int32 words are the bits of the file's uint32 words.
_PACKED_WORDS = {"map_kf_desc", "map_mp_desc"}


def _to_file(key: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if key in _PACKED_WORDS else a


def _from_file(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def save_map(state: MapState, db, kf_order, path: str, extra: dict = None):
    """Serialize map state + BoW rows + keyframe order to one .npz."""
    arrays = {f"map_{k}": _to_file(f"map_{k}", v) for k, v in state._asdict().items()}
    arrays.update({f"db_{k}": _to_file(f"db_{k}", v) for k, v in db._asdict().items()})
    arrays["kf_order"] = np.asarray(kf_order, np.int64)
    arrays["format_version"] = np.asarray(FORMAT_VERSION)
    for k, v in (extra or {}).items():
        arrays[f"extra_{k}"] = np.asarray(v)
    np.savez_compressed(path, **arrays)


def load_map(path: str, device="cpu"):
    """-> (MapState, BowDB, kf_order list, extras dict) on `device`."""
    data = np.load(path, allow_pickle=False)
    ver = int(data["format_version"])
    if ver != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {ver} != {FORMAT_VERSION}")

    def group(prefix):
        return {k[len(prefix):]: _from_file(data[k], device) for k in data.files if k.startswith(prefix)}

    map_kwargs = group("map_")
    db_kwargs = group("db_")
    extras = {k[len("extra_"):]: data[k] for k in data.files if k.startswith("extra_")}
    if "covis" not in map_kwargs:
        K = map_kwargs["kf_valid"].shape[0]
        map_kwargs["covis"] = torch.zeros((K, K), dtype=torch.int32, device=device)
    state = MapState(**map_kwargs)
    # The stored covisibility may be stale relative to culls and fusions
    # after its last refresh: recompute it from the observation table.
    state = state._replace(covis=map_ops.covisibility_matrix(state).to(state.covis.dtype))
    db = kdb.BowDB(**db_kwargs)
    kf_order = [int(x) for x in data["kf_order"]]
    return state, db, kf_order, extras


def save_system(system, path: str):
    """Save a live System's map with the bookkeeping a load needs to go on
    mapping, not only localize: keyframe timestamps, the probation list,
    loop edges and the allocator cursors."""
    ts_slots = np.asarray(sorted(system.kf_timestamps), np.int64)
    ts_vals = np.asarray([system.kf_timestamps[int(s)] for s in ts_slots], np.float64)
    recent = np.asarray(system.recent_pts or np.zeros((0, 2)), np.int64)
    loop_edges = np.asarray(
        (system.loop_closer.loop_edges if system.loop_closer else []) or np.zeros((0, 2)),
        np.int64,
    )
    save_map(
        system.state, system.db, system.kf_order, path,
        extra={
            "frame_id": system.frame_id,
            "kf_ts_slots": ts_slots,
            "kf_ts_vals": ts_vals,
            "recent_pts": recent,
            "loop_edges": loop_edges,
            "next_kf_slot": system._next_kf_slot,
            "next_pt_slot": system.mapper._next_pt_slot,
        },
    )


def load_into_system(system, path: str, localization_only: bool = True):
    """Load a checkpoint into a System and (by default) enter
    localization-only mode: the state machine starts LOST and relocalizes
    against the map. With localization_only=False the mapping bookkeeping
    is restored too and the system goes on building the same map."""
    state, db, kf_order, extras = load_map(path, system.device)
    # Capacities follow the checkpoint (it may have been grown).
    K, N = state.kf_mp.shape
    P = state.mp_xyz.shape[0]
    if N != system.map_cfg.max_features:
        raise ValueError(
            f"checkpoint feature capacity {N} != extractor's "
            f"{system.map_cfg.max_features}; construct the System with "
            "matching n_features"
        )
    system.cfg.max_keyframes = K
    system.cfg.max_points = P
    system.map_cfg = system.map_cfg._replace(max_keyframes=K, max_points=P)
    system.mapper.cfg = system.map_cfg
    if system.loop_closer is not None:
        system.loop_closer.cfg = system.map_cfg
    system.state = state
    system.db = db
    system.kf_order = kf_order
    if len(system.kf_gen) < K:
        system.kf_gen = np.concatenate([system.kf_gen, np.zeros(K - len(system.kf_gen), np.int64)])
    system.mapper.mp_valid_host = np.zeros(P, bool)
    system.mapper.resync_point_mirror(state)
    system.frame_id = int(extras.get("frame_id", 0)) + 1
    ts_slots = extras.get("kf_ts_slots")
    if ts_slots is not None:
        system.kf_timestamps = {int(s): float(v) for s, v in zip(ts_slots, extras["kf_ts_vals"])}
    system.recent_pts = [(int(p), int(b)) for p, b in extras.get("recent_pts", [])]
    if system.loop_closer is not None:
        system.loop_closer.loop_edges = [(int(a), int(b)) for a, b in extras.get("loop_edges", [])]
    system._next_kf_slot = int(extras.get("next_kf_slot", 0))
    system.mapper._next_pt_slot = int(extras.get("next_pt_slot", 0))
    system.stats.n_keyframes = len(kf_order)
    system.ref_kf = kf_order[-1] if kf_order else 0
    system.tracking_state = type(system.tracking_state).LOST
    system.last_pose = None
    system.velocity = None
    system.set_localization_mode(localization_only)
    return system
