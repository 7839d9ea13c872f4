"""Generate a vocabulary file of the stock ORBvoc.txt's size and format.

k=10, L=6 gives ~1.11M nodes and ~982k words in ~140 MB of DBoW2 text;
about 2% of the depth-(L-1) nodes are early leaves (their subtree dropped),
so the irregular-tree path of the loader and of the descent is exercised at
scale, as the stock vocabulary exercises it. Descriptors and weights are
random, from seed 3. `depth=4` gives the ~11k-node file the tests use.

Usage: python -m orb_slam_cuda_tpu_torch.vocab.stock_scale OUT.txt [depth]
"""

from __future__ import annotations

import sys
import time

import numpy as np

K = 10
DEPTH = 6
SEED = 3


def generate(path: str, depth: int = DEPTH, k: int = K, seed: int = SEED) -> float:
    """Write the vocabulary text to `path`; returns the seconds it took.
    Nodes carry BFS ids; each line is `parent is_leaf d0..d31 weight`."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    level_sizes = [k ** (d + 1) for d in range(depth)]
    # ~2% of the bottom-level subtrees go: their parents become leaves.
    early = rng.random(level_sizes[depth - 2]) < 0.02 if depth >= 2 else None
    with open(path, "w") as f:
        f.write(f"{k} {depth} 0 0\n")
        parent_keep_ids = None
        next_id_start = 1
        for d in range(depth):
            if d == 0:
                parent_ids = np.zeros(level_sizes[0], np.int64)
            else:
                parent_ids = np.repeat(parent_keep_ids, k)
            m = len(parent_ids)
            if d == depth - 2 and early is not None:
                is_leaf = np.zeros(m, np.int64)
                is_leaf[early[:m]] = 1
            else:
                is_leaf = np.full(m, 1 if d == depth - 1 else 0, np.int64)
            desc = rng.integers(0, 256, (m, 32))
            w = np.where(is_leaf > 0, rng.uniform(0.05, 4.0, m), 0.0)
            rows = np.column_stack([parent_ids, is_leaf, desc])
            for lo in range(0, m, 65536):
                hi = min(lo + 65536, m)
                f.write("\n".join(
                    " ".join(map(str, rows[i])) + f" {w[i]:.6f}" for i in range(lo, hi)
                ) + "\n")
            ids = np.arange(m, dtype=np.int64) + next_id_start
            next_id_start += m
            parent_keep_ids = ids[is_leaf == 0]  # the nodes that stay internal
    return time.perf_counter() - t0


if __name__ == "__main__":
    out = sys.argv[1]
    seconds = generate(out, int(sys.argv[2]) if len(sys.argv) > 2 else DEPTH)
    print(f"{out}: written in {seconds:.1f} s")
