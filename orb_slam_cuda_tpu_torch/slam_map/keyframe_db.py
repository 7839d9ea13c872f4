"""BoW keyframe database (torch port of
orb_slam_cuda_tpu/slam_map/keyframe_db.py): compacted tf-idf rows per
keyframe, and queries that scatter the query BoW into one dense (W,)
vector, then score every keyframe with one gather + min + sum. The
candidate funnel (common words, score floor, covisibility-group
accumulation) mirrors the reference's."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.segsum import segment_sum
from .state import slot_index, slot_mask

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
    sums = segment_sum(n, group, idf_s)
    word_u = torch.full((n,), -1, dtype=torch.int64, device=idf.device).scatter_reduce(
        0, group, torch.where(real, ws, torch.full_like(ws, -1)), reduce="amax", include_self=True
    )
    total = torch.sum(sums)
    weight_u = torch.where(word_u >= 0, sums / torch.clamp(total, min=1e-12), torch.zeros_like(sums))
    return word_u.to(torch.int32), weight_u


def insert(db: BowDB, slot, word_u, weight_u) -> BowDB:
    """Row `slot` (an int or a slot tensor) takes the keyframe's BoW."""
    s = slot_index(slot, db.word.device)
    word, weight = db.word.clone(), db.weight.clone()
    word[s] = word_u.to(word.dtype)
    weight[s] = weight_u
    return BowDB(word, weight, db.valid.clone().index_fill_(0, s, True))


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
    """Clear row `slot` (an int, a slot tensor, or a (K,) bool mask)."""
    gone = slot_mask(slot, db.valid.shape[0], db.word.device)
    return BowDB(torch.where(gone[:, None], torch.full_like(db.word, -1), db.word),
                 torch.where(gone[:, None], torch.zeros_like(db.weight), db.weight),
                 db.valid & ~gone)


def dense_bow(word_u, weight_u, n_words: int):
    """Compacted row -> dense (W,) vector (query side only)."""
    vals = torch.where(word_u >= 0, weight_u, torch.zeros_like(weight_u))
    out = torch.zeros((n_words,), dtype=torch.float32, device=word_u.device)
    return out.index_add_(0, torch.clamp(word_u, min=0).long(), vals)


def scores(db: BowDB, q_dense):
    """(K,) L1 similarity sum_w min(v_w, q_w) of every keyframe row."""
    q_at = q_dense[torch.clamp(db.word, min=0).long()]
    m = torch.where(db.word >= 0, torch.minimum(db.weight, q_at), torch.zeros_like(q_at))
    s = torch.sum(m, dim=1)
    return torch.where(db.valid, s, torch.zeros_like(s))


def common_words(db: BowDB, q_dense):
    """(K,) int32 count of words shared with the query."""
    hit = (db.word >= 0) & (q_dense > 0)[torch.clamp(db.word, min=0).long()]
    n = torch.sum(hit, dim=1).to(torch.int32)
    return torch.where(db.valid, n, torch.zeros_like(n))


def detect_candidates(db: BowDB, q_dense, exclude_mask, covis_matrix, min_score=None,
                      top_covis: int = 10):
    """Loop/relocalization candidates: keep > 0.8 * max common words, the
    optional score floor, then accumulate scores over each keyframe's
    top-`top_covis` covisibility group (ties to the lower index) and keep
    the best member of every group above 0.75 * the best group score.
    Returns (cand_mask (K,) bool, raw scores (K,))."""
    s = scores(db, q_dense)
    eligible = db.valid & ~exclude_mask
    cw = torch.where(eligible, common_words(db, q_dense), torch.zeros_like(s, dtype=torch.int32))
    min_common = 0.8 * torch.max(cw).to(torch.float32)
    ok = eligible & (cw.to(torch.float32) > min_common) & (cw > 0)
    if min_score is not None:
        ok = ok & (s >= min_score)

    k = min(top_covis, s.shape[0])
    w_top, i_top = torch.sort(covis_matrix, dim=1, descending=True, stable=True)
    w_top, i_top = w_top[:, :k], i_top[:, :k]
    zero = torch.zeros_like(s[i_top])
    grp = torch.where((w_top > 0) & ok[i_top], s[i_top], zero)
    own = torch.where(ok, s, torch.zeros_like(s))
    acc = own + torch.sum(grp, dim=1)
    best_in_group = torch.maximum(own, torch.max(torch.where(w_top > 0, s[i_top], zero), dim=1).values)
    group_ok = ok & (acc > 0.75 * torch.max(acc))
    return group_ok & (own >= best_in_group * 0.999), s
