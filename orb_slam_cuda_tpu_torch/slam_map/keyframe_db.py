"""BoW keyframe database rows (torch port of the parts of
orb_slam_cuda_tpu/slam_map/keyframe_db.py that mapping uses: the
compacted tf-idf rows and their insert/grow/erase). Scoring and candidate
detection wait for relocalization and loop closing."""

from __future__ import annotations

from typing import NamedTuple

import torch

_PAD = 2**30  # sort-to-the-end sentinel for invalid words


class BowDB(NamedTuple):
    """word: (K,B) int32 unique word ids (-1 pad); weight: (K,B) float32
    L1-normalized tf-idf; valid: (K,) bool."""

    word: torch.Tensor
    weight: torch.Tensor
    valid: torch.Tensor


def empty(max_keyframes: int, bow_capacity: int, device="cpu") -> BowDB:
    return BowDB(
        word=torch.full((max_keyframes, bow_capacity), -1, dtype=torch.int32, device=device),
        weight=torch.zeros((max_keyframes, bow_capacity), dtype=torch.float32, device=device),
        valid=torch.zeros((max_keyframes,), dtype=torch.bool, device=device),
    )


def compute_bow_row(word_ids, idf, feat_valid):
    """(N,) word ids + idf -> compacted unique (word_u, weight_u), tf-idf
    accumulated and L1-normalized."""
    n = word_ids.shape[0]
    w = torch.where(feat_valid & (word_ids >= 0), word_ids.long(),
                    torch.full_like(word_ids, _PAD, dtype=torch.int64))
    order = torch.argsort(w, stable=True)
    ws = w[order]
    real = ws < _PAD
    idf_s = torch.where(real, idf[order], torch.zeros_like(idf))
    first = torch.ones_like(real)
    first[1:] = ws[1:] != ws[:-1]
    group = torch.cumsum(first.long(), 0) - 1
    sums = torch.zeros((n,), dtype=torch.float32, device=idf.device).index_add_(0, group, idf_s)
    word_u = torch.full((n,), -1, dtype=torch.int64, device=idf.device).scatter_reduce(
        0, group, torch.where(real, ws, torch.full_like(ws, -1)), reduce="amax", include_self=True
    )
    total = torch.sum(sums)
    weight_u = torch.where(word_u >= 0, sums / torch.clamp(total, min=1e-12), torch.zeros_like(sums))
    return word_u.to(torch.int32), weight_u


def insert(db: BowDB, slot, word_u, weight_u) -> BowDB:
    word, weight, valid = db.word.clone(), db.weight.clone(), db.valid.clone()
    word[slot] = word_u
    weight[slot] = weight_u
    valid[slot] = True
    return BowDB(word, weight, valid)


def grow(db: BowDB, new_K: int) -> BowDB:
    """Pad the database to new_K keyframe rows."""
    K_old = db.valid.shape[0]
    if new_K <= K_old:
        return db
    pad = new_K - K_old
    B = db.word.shape[1]
    dev = db.word.device
    return BowDB(
        word=torch.cat([db.word, torch.full((pad, B), -1, dtype=torch.int32, device=dev)]),
        weight=torch.cat([db.weight, torch.zeros((pad, B), dtype=torch.float32, device=dev)]),
        valid=torch.cat([db.valid, torch.zeros((pad,), dtype=torch.bool, device=dev)]),
    )


def erase(db: BowDB, slot) -> BowDB:
    word, weight, valid = db.word.clone(), db.weight.clone(), db.valid.clone()
    word[slot] = -1
    weight[slot] = 0.0
    valid[slot] = False
    return BowDB(word, weight, valid)
