"""BoW vocabulary tree as per-level tensors (torch port of
orb_slam_cuda_tpu/vocab/vocabulary.py): the batched packed-XOR descent,
the numpy trainer and the loader of the DBoW2 text format (ORBvoc.txt),
whose parser is either the native scanner that `native_loader` compiles
at first use or numpy's; the caller chooses, and nothing switches silently.
"""

from __future__ import annotations

import time

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


PARSERS = ("native", "numpy")


def parse_orbvoc_numpy(path: str):
    """-> (k, depth, parents (n,), is_leaf (n,), desc_bytes (n,32),
    weights (n,)) of a DBoW2 text vocabulary, parsed with np.loadtxt."""
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        body = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if body.size == 0:
        raise ValueError(f"empty vocabulary file: {path}")
    return (k, depth, body[:, 0].astype(np.int64), body[:, 1] != 0,
            body[:, 2:34].astype(np.uint8), body[:, 34])


def load_orbvoc_text(path: str, levelsup: int = 4, parser: str = "native",
                     timings: dict = None) -> Vocabulary:
    """Load a DBoW2 text vocabulary (header `k L s1 s2`, then one line per
    node in BFS order: `parent is_leaf d0..d31 weight`). Returns CPU
    tensors; `.to(device)` moves them.

    `levelsup` counts levels up FROM THE LEAVES, as DBoW2 does: the
    direct-index node lives at depth `L - levelsup` from the root (at least
    1). `parser` is "native" (the C++ scanner, compiled at first use; a
    failed build or load raises) or "numpy"; both give equal arrays.
    `timings`, if given, receives the seconds of the two steps under
    "parse" and "assemble" and the file's node count under "nodes"."""
    t0 = time.perf_counter()
    if parser == "native":
        from . import native_loader

        k, depth, parents, is_leaf, desc_bytes, weights = native_loader.parse_orbvoc_text(path)
    elif parser == "numpy":
        k, depth, parents, is_leaf, desc_bytes, weights = parse_orbvoc_numpy(path)
    else:
        raise ValueError(f"parser must be one of {PARSERS}, not {parser!r}")
    t1 = time.perf_counter()
    voc = _assemble_from_flat(
        np.asarray(parents, np.int64), np.asarray(is_leaf).astype(bool),
        np.asarray(desc_bytes, np.uint8), np.asarray(weights, np.float64),
        int(k), int(depth), max(1, int(depth) - levelsup),
    )
    if timings is not None:
        timings.update(parse=t1 - t0, assemble=time.perf_counter() - t1, nodes=len(parents))
    return voc


def _assemble_from_flat(parents, is_leaf, desc_bytes, weights, k, depth, levelsup):
    """Per-level arrays from a flat node list that excludes the root: row
    i describes node i+1 of the DBoW2 id space, its parent (0 = root)
    precedes it. Vectorized: the stock vocabulary has ~1.1M nodes."""
    n_rows = len(parents)
    node_depth = np.ones(n_rows, np.int64)
    for _ in range(max(depth, 1)):
        parent_depth = np.where(parents > 0, node_depth[parents - 1], 0)
        nd = parent_depth + 1
        if (nd == node_depth).all():
            break
        node_depth = nd
    max_depth = int(node_depth.max())

    # Word ids in DBoW2 order: leaves numbered by their order in the file.
    word_of = np.full(n_rows, -1, np.int64)
    leaf_rows = np.flatnonzero(is_leaf)
    word_of[leaf_rows] = np.arange(len(leaf_rows))

    # Bytes -> packed words in the hamming module's order (bit b = byte
    # b//8 bit b%8 little-endian = word b//32 shift b%32).
    packed = np.ascontiguousarray(desc_bytes).view("<u4").reshape(-1, 8)

    # Per-level contiguous renumbering, stably grouped by parent, so each
    # parent's children are contiguous (base + position addressing).
    local_id = np.full(n_rows + 1, -1, np.int64)  # by DBoW2 id (0 = root)
    local_id[0] = 0
    levels_desc, levels_valid, levels_base, levels_word = [], [], [], []
    for d in range(max_depth):
        child_rows = np.flatnonzero(node_depth == d + 1)
        m = 1 if d == 0 else int(np.count_nonzero(node_depth == d))
        pl = local_id[parents[child_rows]]
        order = np.argsort(pl, kind="stable")
        ch = child_rows[order]
        pl_s = pl[order]
        counts = np.bincount(pl_s, minlength=m)
        total = len(ch)
        starts = np.cumsum(counts) - counts
        slot = np.arange(total) - np.repeat(starts, counts)
        if (slot >= k).any():
            raise ValueError("node with more than k children")
        cdesc = np.zeros((m, k, 8), np.uint32)
        cvalid = np.zeros((m, k), bool)
        cdesc[pl_s, slot] = packed[ch]
        cvalid[pl_s, slot] = True
        levels_desc.append(torch.from_numpy(cdesc.view(np.int32)))
        levels_valid.append(torch.from_numpy(cvalid))
        levels_base.append(torch.from_numpy(starts.astype(np.int64)))
        levels_word.append(torch.from_numpy(word_of[ch]))
        local_id = np.full(n_rows + 1, -1, np.int64)
        local_id[ch + 1] = np.arange(total)
    return Vocabulary(
        children_packed=tuple(levels_desc),
        children_valid=tuple(levels_valid),
        child_base=tuple(levels_base),
        node_word=tuple(levels_word),
        word_weight=torch.from_numpy(weights[leaf_rows].astype(np.float32)),
        k=k,
        depth=max_depth,
        levelsup_depth=min(levelsup, max_depth - 1),
    )
