"""Carry state from the reference package into the port.

Each function takes the reference's object (its arrays as anything
`np.asarray` accepts) and returns the port's counterpart on `device`.
uint32 words keep their bits as int32; bfloat16 arrays become float32.
Nothing here imports the reference package or jax.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.frame import FrameData
from ..engine.tracking import TrackCarry
from ..frontend.extractor import Features
from ..geometry.camera import Camera
from ..slam_map.keyframe_db import BowDB
from ..slam_map.state import MapState
from ..solvers.bundle_adjust import BAProblem
from ..solvers.pose_graph import PoseGraphProblem
from ..vocab.vocabulary import Vocabulary


def tensor(a, device="cpu", dtype=None) -> torch.Tensor:
    """numpy-convertible array -> tensor; uint32 reinterpreted as int32,
    bfloat16 widened to float32."""
    arr = np.asarray(a)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    elif arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    t = torch.as_tensor(np.array(arr, order="C"), device=device)  # keeps 0-d shapes
    return t if dtype is None else t.to(dtype)


def camera(cam) -> Camera:
    f = lambda v: float(np.asarray(v))  # noqa: E731
    return Camera.create(f(cam.fx), f(cam.fy), f(cam.cx), f(cam.cy), f(cam.k1), f(cam.k2),
                         f(cam.p1), f(cam.p2), f(cam.k3), f(cam.bf),
                         int(cam.width), int(cam.height))


def vocabulary(voc, device="cpu") -> Vocabulary:
    """A trained or text-loaded reference vocabulary (levels of any, ragged
    sizes; early leaves in `node_word`)."""
    i64 = torch.int64
    return Vocabulary(
        children_packed=[tensor(a, device) for a in voc.children_packed],
        children_valid=[tensor(a, device) for a in voc.children_valid],
        child_base=[tensor(a, device, i64) for a in voc.child_base],
        node_word=[tensor(a, device, i64) for a in voc.node_word],
        word_weight=tensor(voc.word_weight, device),
        k=voc.k, depth=voc.depth, levelsup_depth=voc.levelsup_depth,
    )


def _named(cls, obj, device):
    return cls(**{f: tensor(getattr(obj, f), device) for f in cls._fields})


def map_state(state, device="cpu") -> MapState:
    return _named(MapState, state, device)


def bow_db(db, device="cpu") -> BowDB:
    return _named(BowDB, db, device)


def frame_data(frame, device="cpu") -> FrameData:
    """Every field, `right` and `depth` of a stereo/RGB-D frame included."""
    return _named(FrameData, frame, device)


def track_carry(carry, device="cpu") -> TrackCarry:
    """The pipelined step's carry; `ref_kf` becomes a 0-d int64 tensor."""
    fields = {f: tensor(getattr(carry, f), device) for f in TrackCarry._fields}
    fields["ref_kf"] = fields["ref_kf"].to(torch.int64).reshape(())
    return TrackCarry(**fields)


def features(feats, device="cpu") -> Features:
    return _named(Features, feats, device)


def sim3_triple(S, device="cpu"):
    """(R, t, s) of arrays -> the port's Sim3 triple of tensors."""
    return tuple(tensor(a, device, torch.float32) for a in S)


def pose_graph_problem(problem, device="cpu") -> PoseGraphProblem:
    return _named(PoseGraphProblem, problem, device)


def ba_problem(problem, device="cpu") -> BAProblem:
    return _named(BAProblem, problem, device)


def loop_closer_state(src, dst):
    """Copy the loop closer's host state (consistency groups, loop edges,
    counters) from the reference's LoopCloser onto the port's."""
    dst.consistent_groups = [(set(int(k) for k in g), int(c)) for g, c in src.consistent_groups]
    dst.loop_edges = [(int(a), int(b)) for a, b in src.loop_edges]
    for name in ("kf_seen", "last_loop_kf_seen", "n_loops_closed", "gba_idx", "gba_requested"):
        setattr(dst, name, type(getattr(dst, name))(getattr(src, name)))
    return dst
