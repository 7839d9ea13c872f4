"""Per-frame working set (torch port of orb_slam_cuda_tpu/engine/frame.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..frontend.extractor import Features
from ..geometry import camera as cam_mod
from ..ops import hamming


class FrameData(NamedTuple):
    """Fixed-capacity (N,) feature arrays for one frame."""

    uv: torch.Tensor  # (N,2) undistorted level-0 coords
    uv_raw: torch.Tensor  # (N,2) raw image coords
    oct: torch.Tensor  # (N,) int32
    ang: torch.Tensor  # (N,) float32 degrees
    response: torch.Tensor  # (N,)
    desc: torch.Tensor  # (N,8) int32 packed
    bip: torch.Tensor  # (N,256) float32 bipolar
    valid: torch.Tensor  # (N,) bool
    word: torch.Tensor  # (N,) int32 vocabulary leaf
    node: torch.Tensor  # (N,) int32 levelsup node
    idf: torch.Tensor  # (N,) float32 word idf
    right: torch.Tensor  # (N,) float32 stereo right-u (<0 mono)
    depth: torch.Tensor  # (N,) float32 (<0 unknown)
    mp: torch.Tensor  # (N,) int32 bound map point (-1 none)

    @property
    def capacity(self):
        return self.uv.shape[0]


def build_frame(feats: Features, cam: cam_mod.Camera, vocab=None,
                right=None, depth=None) -> FrameData:
    """FrameData from extractor output: undistortion + bipolar + BoW."""
    n = feats.capacity
    dev = feats.uv.device
    uv_und = cam_mod.undistort_points(cam, feats.uv)
    bip = hamming.bipolar(feats.desc)
    minus1 = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if vocab is not None:
        word, node, idf = vocab.transform(feats.desc)
        word = torch.where(feats.valid, word, minus1)
        node = torch.where(feats.valid, node, minus1)
    else:
        word, node = minus1, minus1.clone()
        idf = torch.zeros((n,), dtype=torch.float32, device=dev)
    neg = torch.full((n,), -1.0, dtype=torch.float32, device=dev)
    return FrameData(
        uv=uv_und,
        uv_raw=feats.uv,
        oct=feats.octave,
        ang=feats.angle,
        response=feats.response,
        desc=feats.desc,
        bip=bip,
        valid=feats.valid,
        word=word,
        node=node,
        idf=idf,
        right=neg if right is None else right,
        depth=neg.clone() if depth is None else depth,
        mp=minus1.clone(),
    )
