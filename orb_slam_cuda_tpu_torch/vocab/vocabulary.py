"""BoW vocabulary tree as per-level tensors (torch port of
orb_slam_cuda_tpu/vocab/vocabulary.py): the batched packed-XOR descent
and the numpy trainer. The stock ORBvoc.txt loader is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import hamming


class Vocabulary:
    """Array-form k-ary vocabulary tree (same fields and conventions as the
    reference; packed centroids are int32 words with the reference's bits).

    children_packed: per level (n_nodes_l, k, 8) int32.
    children_valid: per level (n_nodes_l, k) bool.
    child_base: per level (n_nodes_l,) int64 first-child index.
    node_word: per level (n_nodes_{l+1},) int64 word id of each child node
      if it is a leaf, else -1.
    word_weight: (n_words,) float32 idf weights.
    levelsup_depth: FROM-ROOT depth whose node id gates SearchByBoW.
    """

    def __init__(self, children_packed, children_valid, child_base,
                 node_word, word_weight, k, depth, levelsup_depth):
        self.children_packed = tuple(children_packed)
        self.children_valid = tuple(children_valid)
        self.child_base = tuple(child_base)
        self.node_word = tuple(node_word)
        self.word_weight = word_weight
        self.k = int(k)
        self.depth = int(depth)
        self.levelsup_depth = int(levelsup_depth)

    @property
    def n_words(self):
        return int(self.word_weight.shape[0])

    def to(self, device) -> "Vocabulary":
        mv = lambda ts: tuple(t.to(device) for t in ts)  # noqa: E731
        return Vocabulary(
            mv(self.children_packed), mv(self.children_valid),
            mv(self.child_base), mv(self.node_word),
            self.word_weight.to(device), self.k, self.depth, self.levelsup_depth,
        )

    def transform(self, desc):
        """(N,8) int32 packed descriptors -> (word_id (N,) int32,
        node_id at levelsup_depth (N,) int32, idf weight (N,) float32).
        Descriptors whose path ends early above levelsup carry their
        terminal node as -2 - (level-unique id), as the reference does."""
        q = desc.to(torch.int32)
        n = q.shape[0]
        dev = q.device
        node = torch.zeros((n,), dtype=torch.int64, device=dev)
        node_at_levelsup = torch.zeros((n,), dtype=torch.int64, device=dev)
        word = torch.full((n,), -1, dtype=torch.int64, device=dev)
        active = torch.ones((n,), dtype=torch.bool, device=dev)
        glob = torch.zeros((n,), dtype=torch.int64, device=dev)
        glob_off = 1
        for level in range(self.depth):
            cpack = self.children_packed[level]
            cvalid = self.children_valid[level]
            base = self.child_base[level]
            nword = self.node_word[level]
            # Inactive rows may sit on a node id of an earlier level; clamp
            # like the reference's gathers do (their results are unused).
            nd = torch.clamp(node, 0, cpack.shape[0] - 1)
            my_cpack = cpack[nd]
            my_valid = cvalid[nd]
            dist = torch.sum(hamming.popcount32(my_cpack ^ q[:, None, :]), dim=-1)
            dist = torch.where(my_valid, dist, torch.full_like(dist, 1 << 30))
            best = torch.argmin(dist, dim=-1)
            step = active & my_valid.any(-1)
            nxt = base[nd] + best
            node = torch.where(step, nxt, node)
            glob = torch.where(step, glob_off + nxt, glob)
            glob_off += int(nword.shape[0])
            w_here = nword[torch.clamp(nxt, 0, nword.shape[0] - 1)]
            word = torch.where(step & (w_here >= 0), w_here, word)
            active = step & (w_here < 0)
            if level + 1 == self.levelsup_depth:
                node_at_levelsup = torch.where(active, node, -2 - glob)
        resolved = word >= 0
        word_id = torch.where(resolved, word, torch.zeros_like(word))
        weight = torch.where(resolved, self.word_weight[word_id], torch.zeros((), device=dev))
        return word_id.to(torch.int32), node_at_levelsup.to(torch.int32), weight


def _bit_majority(descs_bits):
    return (descs_bits.mean(axis=0) >= 0.5).astype(np.uint8)


def _kmeans_binary(bits, k, rng, iters=8):
    """k-means on {0,1}^256 with Hamming metric and majority centroids."""
    n = bits.shape[0]
    if n <= k:
        return bits.copy(), np.arange(n) % max(n, 1)
    centers = [bits[rng.integers(n)]]
    for _ in range(k - 1):
        d = np.abs(bits[:, None, :] - np.asarray(centers)[None, :, :]).sum(-1).min(1)
        p = d.astype(np.float64) ** 2
        p = p / p.sum() if p.sum() > 0 else np.full(n, 1.0 / n)
        centers.append(bits[rng.choice(n, p=p)])
    centers = np.asarray(centers)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = np.abs(bits[:, None, :].astype(np.int16) - centers[None, :, :].astype(np.int16)).sum(-1)
        assign = d.argmin(1)
        for c in range(k):
            sel = bits[assign == c]
            if len(sel):
                centers[c] = _bit_majority(sel)
    return centers, assign


def _np_pack_bits(bits01):
    """(N,256) {0,1} -> (N,8) uint32 in the hamming word order."""
    by = np.packbits(bits01.astype(np.uint8), axis=-1, bitorder="little")
    return np.ascontiguousarray(by).view("<u4").reshape(bits01.shape[0], 8)


def _np_unpack_bits(desc) -> np.ndarray:
    """(N,8) uint32/int32 words -> (N,256) uint8 bits."""
    words = np.ascontiguousarray(np.asarray(desc)).view(np.uint32).astype("<u4")
    by = words.view(np.uint8).reshape(words.shape[0], 32)
    return np.unpackbits(by, axis=-1, bitorder="little")


def build_vocabulary(descriptors, k: int = 8, depth: int = 3,
                     levelsup_depth: int = 1, seed: int = 0,
                     weights=None) -> Vocabulary:
    """Train a k^depth-word vocabulary from packed (N,8) descriptors with
    the reference's binary k-means (same RNG stream, same tree). Returns
    CPU tensors; `.to(device)` moves them."""
    rng = np.random.default_rng(seed)
    bits = _np_unpack_bits(descriptors)
    levels_desc, levels_valid, levels_base, levels_word = [], [], [], []
    current = [bits]
    for level in range(depth):
        cdescs, cvalids, bases = [], [], []
        next_clusters = []
        child_counter = 0
        for cluster in current:
            if len(cluster) == 0:
                centers = np.zeros((0, hamming.N_BITS), np.uint8)
                assign = np.zeros(0, np.int64)
            else:
                centers, assign = _kmeans_binary(cluster, k, rng)
            kk = len(centers)
            pad_desc = np.zeros((k, 8), np.uint32)
            if kk:
                pad_desc[:kk] = _np_pack_bits(centers.astype(np.uint8))
            valid = np.zeros(k, bool)
            valid[:kk] = True
            cdescs.append(pad_desc)
            cvalids.append(valid)
            bases.append(child_counter)
            child_counter += kk
            for c in range(kk):
                next_clusters.append(cluster[assign == c] if len(cluster) else cluster)
        levels_desc.append(torch.from_numpy(np.asarray(cdescs, np.uint32).view(np.int32).copy()))
        levels_valid.append(torch.from_numpy(np.asarray(cvalids)))
        levels_base.append(torch.as_tensor(np.asarray(bases, np.int64)))
        n_next = child_counter
        if level == depth - 1:
            levels_word.append(torch.arange(n_next, dtype=torch.int64))
        else:
            levels_word.append(torch.full((max(n_next, 1),), -1, dtype=torch.int64))
        current = next_clusters
    n_words = len(current)
    if weights is None:
        counts = np.array([max(len(c), 1) for c in current], np.float64)
        w = np.log(max(len(bits), 1) / counts)
        w = np.maximum(w, 1e-3)
    else:
        w = np.asarray(weights, np.float64)
    assert len(w) == n_words
    return Vocabulary(
        children_packed=tuple(levels_desc),
        children_valid=tuple(levels_valid),
        child_base=tuple(levels_base),
        node_word=tuple(levels_word),
        word_weight=torch.as_tensor(w.astype(np.float32)),
        k=k,
        depth=depth,
        levelsup_depth=levelsup_depth,
    )
