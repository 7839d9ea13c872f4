"""Segment sums and scatters in a fixed order.

`index_add_` on CUDA sums float addends with atomics, in no fixed order,
so the last bits of a sum (and, through the keyframe and relocalization
decisions, a whole run) differ from run to run. Here the segment index is
sorted once with a stable sort, which keeps each segment's addends in
their original order, and `torch.segment_reduce` then sums each segment in
that order. On the CPU the result is bit-equal to `index_add_`, which also
adds in index order; on CUDA it is the same from run to run. Integer
addends go through `index_add_`, which is exact in any order.

`last_writes` does the same for a plain scatter `out[idx] = v` that
writes one index more than once: CUDA writes them in no fixed order, and
keeping only the last write of each index gives what a serial scatter
(the CPU's, and the reference's) leaves.

Nothing here reads a value back to the host: the segment lengths come
from an integer `index_add_` (`torch.bincount` would read the maximum
back), and `segment_reduce` runs with `unsafe=True` (its checks of the
lengths read them back).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SegmentIndex(NamedTuple):
    """A segment index prepared for `segsum`: `idx` (E,) int64 in [0, n),
    `order` its stable sort permutation, `lengths` (n,) int64."""

    idx: torch.Tensor
    order: torch.Tensor
    lengths: torch.Tensor

    @property
    def n(self) -> int:
        return self.lengths.shape[0]


def segment_index(n: int, idx) -> SegmentIndex:
    """Sort `idx` (E,) (values in [0, n)) once, for any number of sums."""
    idx = idx.long()
    order = torch.argsort(idx, stable=True)
    lengths = torch.zeros((n,), dtype=torch.int64, device=idx.device)
    lengths.index_add_(0, idx, torch.ones_like(idx))
    return SegmentIndex(idx, order, lengths)


def segsum(seg: SegmentIndex, vals):
    """(n, ...) sums of `vals` (E, ...) over the segments, each in the
    order of its addends in `vals`; empty segments give 0."""
    if not vals.is_floating_point():
        out = torch.zeros((seg.n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, seg.idx, vals)
    return torch.segment_reduce(vals[seg.order], "sum", lengths=seg.lengths, axis=0, unsafe=True)


def segment_sum(n: int, idx, vals):
    """One sum over a segment index used once."""
    return segsum(segment_index(n, idx), vals)


def last_writes(idx, n: int):
    """(M,) bool, True where position i is the last to hold its value in
    `idx` (M,) int64, values in [0, n)."""
    at = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, idx, at, reduce="amax", include_self=True)
    return last[idx] == at
