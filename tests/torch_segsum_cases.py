"""Inputs of the segment sum (ops/segsum.py) as the solvers hand them over,
shared by the card tests (tests/test_torch_segsum_card.py) and the CPU
tests (tests/test_torch_segsum.py): the index, the valid mask and the
addends, with each left-out slot clamped onto segment 0 and a ±0 addend.
No JAX.

`case(name, device)` returns (n, idx, valid, vals) on `device`:

- `K<k>`: 53 segments, 3,000 slots, ~30% valid, at each addend width of
  the call sites (WIDTHS);
- `ragged`, `no_addends`, `all_invalid`;
- `<real>_K<k>`: the local and global BA's dense observation grids (REAL),
  camera or point segments;
- `tiles_K<k>`: six segments of 3T + 5, T, 0, 1, 2T - 1 and T + 1 valid
  addends, T the block kernel's rows a tile at width k (`block_tile_rows`,
  which mirrors csrc/segsum.cu's), so sums cross the ring of three tiles
  several times, fill one tile exactly and hold no addend;
- `one_segment_K<k>`: n = 1, 3T + 3 valid addends among padded slots;
- `offset<f>_K<k>`: the tiles case with `vals` a view that starts f floats
  into its buffer, so its base is only 4-byte (f = 1) or 8-byte (f = 2)
  aligned.
"""

from __future__ import annotations

import numpy as np
import torch

WIDTHS = {1: (), 3: (3,), 6: (6,), 7: (7,), 9: (3, 3), 36: (6, 6), 49: (7, 7)}
# (cameras or points, observation rows, slots a row, valid slots): the
# local BA's and the global BA's dense observation grids.
REAL = {"local_cams": (24, 24, 2000, 2139), "local_points": (4096, 24, 2000, 2139),
        "global_cams": (128, 128, 2000, 19000), "global_points": (32768, 128, 2000, 19000)}

CASES = ([f"K{k}" for k in WIDTHS] + ["ragged", "no_addends", "all_invalid"]
         + [f"local_cams_K{k}" for k in (6, 36)] + [f"local_points_K{k}" for k in (3, 9)]
         + [f"global_cams_K{k}" for k in (6, 36)] + [f"global_points_K{k}" for k in (3, 9)])
# The block kernel's widths and tile (csrc/segsum.cu): at most TILE_FLOATS
# floats and TILE_ROWS rows, a multiple of ADD_AHEAD rows.
BLOCK_WIDTHS = (1, 3, 6, 7, 9, 36, 49)
TILE_FLOATS, TILE_ROWS, ADD_AHEAD = 3456, 256, 16
LONG_CASES = ([f"tiles_K{k}" for k in WIDTHS] + ["one_segment_K1", "one_segment_K36"]
              + ["offset1_K6", "offset1_K7", "offset1_K9", "offset1_K36", "offset2_K36"])


def block_tile_rows(k):
    """Rows a tile of the block kernel holds at width `k`."""
    return min(TILE_ROWS, TILE_FLOATS // k) // ADD_AHEAD * ADD_AHEAD


def _signed_zeros(rng, vals, valid):
    """`vals` with a ±0 at each left-out slot."""
    e, tail = vals.shape[0], vals.shape[1:]
    sign = np.where(rng.random(vals.shape) < 0.5, -1.0, 1.0).astype(np.float32)
    return np.where(valid.reshape((e,) + (1,) * len(tail)), vals, np.float32(0.0) * sign)


def padded(rng, n, e, tail, share=0.3, live=None):
    """(idx, valid, vals) on the CPU: invalid slots clamped onto segment 0
    with ±0 addends."""
    idx = rng.choice(np.arange(n) if live is None else live, size=e)
    valid = rng.random(e) < share
    vals = _signed_zeros(rng, rng.normal(0, 1e3, (e,) + tail).astype(np.float32), valid)
    return torch.as_tensor(np.where(valid, idx, 0)), torch.as_tensor(valid), torch.as_tensor(vals)


def real(name, tail, seed=0):
    """A BA grid's index: rows of slots, each row one camera; the valid
    slots spread over the rows, each observing a point. The camera sums
    take the row, the point sums the point."""
    n, rows, per_row, n_valid = REAL[name]
    rng = np.random.default_rng(seed)
    e = rows * per_row
    valid = np.zeros(e, bool)
    valid[rng.choice(e, size=n_valid, replace=False)] = True
    seg = np.repeat(np.arange(rows), per_row) if name.endswith("cams") else rng.integers(0, n, e)
    vals = rng.normal(0, 1e3, (e,) + tail).astype(np.float32)
    vals[~valid] = 0.0
    return n, torch.as_tensor(np.where(valid, seg, 0)), torch.as_tensor(valid), torch.as_tensor(vals)


def lengths_case(rng, lengths, tail):
    """Segments of the given valid lengths, their slots shuffled among as
    many padded ones."""
    seg = np.repeat(np.arange(len(lengths)), lengths)
    e = 2 * seg.size
    idx = np.concatenate([seg, np.zeros(seg.size, np.int64)])
    valid = np.arange(e) < seg.size
    perm = rng.permutation(e)
    idx, valid = idx[perm], valid[perm]
    vals = _signed_zeros(rng, rng.normal(0, 1e3, (e,) + tail).astype(np.float32), valid)
    return len(lengths), torch.as_tensor(idx), torch.as_tensor(valid), torch.as_tensor(vals)


def _at_offset(vals, floats, device):
    """`vals` on `device` as a view `floats` floats into a buffer."""
    buf = torch.zeros(vals.numel() + floats, dtype=vals.dtype, device=device)
    out = buf[floats:].view(vals.shape)
    out.copy_(vals.to(device))
    return out


def case(name, device="cpu"):
    rng = np.random.default_rng(sum(map(ord, name)))
    offset = 0
    if name.startswith("offset"):
        head, k = name.split("_K")
        offset, name = int(head[len("offset"):]), f"tiles_K{k}"
    if name.startswith("K"):
        n, idx, valid, vals = (53,) + padded(rng, 53, 3000, WIDTHS[int(name[1:])])
    elif name == "ragged":
        n, idx, valid, vals = (400,) + padded(rng, 400, 20000, (6,), live=rng.choice(400, 150, replace=False))
    elif name == "no_addends":
        n, idx, valid, vals = (37,) + padded(rng, 37, 0, (3, 3))
    elif name == "all_invalid":
        n, idx, valid, vals = (37,) + padded(rng, 37, 5000, (6, 6), share=0.0)
    elif name.startswith(("tiles_K", "one_segment_K")):
        k = int(name.rsplit("_K", 1)[1])
        t = block_tile_rows(k)
        lengths = [3 * t + 5, t, 0, 1, 2 * t - 1, t + 1] if name.startswith("tiles") else [3 * t + 3]
        n, idx, valid, vals = lengths_case(rng, lengths, WIDTHS[k])
    else:
        base, k = name.rsplit("_K", 1)
        n, idx, valid, vals = real(base, WIDTHS[int(k)])
    vals = _at_offset(vals, offset, device) if offset else vals.to(device)
    return n, idx.to(device), valid.to(device), vals


def index_add(n, idx, vals):
    """The CPU's `index_add_` over every slot, the left-out ones included."""
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype).index_add_(0, idx.cpu(), vals.cpu())
