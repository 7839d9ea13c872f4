"""Segment sums and scatters in a fixed order, and the hand-written CUDA
segment sum (csrc/segsum.cu) they launch on the card.

Counterpart of the JAX package's fused scatter-adds,
orb_slam_cuda_tpu/solvers/bundle_adjust.py:189-219 (`.at[ci].add` and
`.at[pi].add` for the normal equations and the CG matvec) and
orb_slam_cuda_tpu/solvers/pose_graph.py:94-112, which XLA fuses on the
TPU. `index_add_` on CUDA sums float addends with atomics, in no fixed
order, so the last bits of a sum (and, through the keyframe and
relocalization decisions, a whole run) would differ from run to run. Here
the segment index is sorted once with a stable sort, which keeps each
segment's addends in their original order, and every sum adds each
segment in that order, starting from +0: on the CPU bit-equal to
`index_add_`, which also adds in index order; on CUDA the same from run to
run.

`segment_index(n, idx, valid)` leaves out the slots where `valid` is
False: a padded slot (the BA's dense observation rows, clamped onto
segment 0) is sorted to the tail and no sum reads it. Where the left-out
addends are ±0, as the solvers' are, the sums keep the bits of an index
that holds them: a float sum that starts at +0 is never -0, and adding ±0
to it changes nothing.

`segsum(seg, vals)`, the dispatch: integer addends go through
`index_add_`, which is exact in any order; float32 addends on a CUDA
device launch the kernel (or raise: nothing falls back); on the CPU they
take `segsum_plain`, `torch.segment_reduce` on the same index. A launch
counts one in `launches` (module attribute), or in `recorded` under graph
capture; engine/programs.py adds a graph's recorded launches at each
replay. The kernel is built at first CUDA use with nvcc for sm_90a into
`build/kernels/` at the repository root, a shared library with a plain C
interface loaded through ctypes, as ops/sim3_kernel.py builds.

`last_writes` does the same for a plain scatter `out[idx] = v` that
writes one index more than once: CUDA writes them in no fixed order, and
keeping only the last write of each index gives what a serial scatter
(the CPU's, and the reference's) leaves.

Nothing here reads a value back to the host: the segment lengths come
from an integer `index_add_` (`torch.bincount` would read the maximum
back), the offsets from a cumulative sum on the device, and
`segment_reduce` runs with `unsafe=True` (its checks of the lengths read
them back).
"""

from __future__ import annotations

import ctypes
import math
import os
import sys
import time
from typing import NamedTuple

import torch

from ..utils import native_build
from .fast_kernel import BUILD_DIR, NVCC_FLAGS, _nvcc

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "segsum.cu")

launches = 0
recorded = 0
_lib = None


class SegmentIndex(NamedTuple):
    """A segment index prepared for `segsum`: `idx` (E,) int64, each slot's
    segment in [0, n), or n where the slot is left out; `order` (E,) its
    stable sort permutation (the left-out slots last); `lengths` (n,)
    int64, the slots each segment holds; `offsets` (n+1,) int64, their
    exclusive cumulative sum (segment s holds order[offsets[s]:
    offsets[s+1]])."""

    idx: torch.Tensor
    order: torch.Tensor
    lengths: torch.Tensor
    offsets: torch.Tensor

    @property
    def n(self) -> int:
        return self.lengths.shape[0]


def segment_index(n: int, idx, valid=None) -> SegmentIndex:
    """Sort `idx` (E,) (values in [0, n)) once, for any number of sums.
    `valid` (E,) bool, if given, leaves out the slots where it is False."""
    idx = idx.long()
    if valid is not None:
        idx = torch.where(valid, idx, torch.full_like(idx, n))
    order = torch.argsort(idx, stable=True)
    lengths = torch.zeros((n + 1,), dtype=torch.int64, device=idx.device)
    lengths = lengths.index_add_(0, idx, torch.ones_like(idx))[:n]
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int64, device=idx.device), torch.cumsum(lengths, 0)])
    return SegmentIndex(idx, order, lengths, offsets)


def segsum(seg: SegmentIndex, vals):
    """(n, ...) sums of `vals` (E, ...) over the segments, each in the
    order of its addends in `vals`, left-out slots skipped; empty segments
    give +0."""
    if not vals.is_floating_point():
        out = torch.zeros((seg.n + 1,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, seg.idx, vals)[: seg.n]
    if vals.device.type == "cpu":
        return segsum_plain(seg, vals)
    return launch(seg, vals)


def segsum_plain(seg: SegmentIndex, vals):
    """The kernel's plain version (any device): `torch.segment_reduce` over
    the index's segments and one trailing segment of the left-out slots,
    which is dropped. The addends go in as (E, K): on the card
    `segment_reduce` sums 1-D data by a tree (CUB's segmented reduction),
    and 2-D data one segment and column a thread in index order."""
    tail = vals.shape[0] - seg.offsets[-1:]
    lengths = torch.cat([seg.lengths, tail])
    flat = vals.reshape(vals.shape[0], math.prod(vals.shape[1:]))[seg.order]
    out = torch.segment_reduce(flat, "sum", lengths=lengths, axis=0, unsafe=True)[: seg.n]
    return out.reshape((seg.n,) + vals.shape[1:])


def segment_sum(n: int, idx, vals):
    """One sum over a segment index used once."""
    return segsum(segment_index(n, idx), vals)


def build() -> tuple:
    """Compile the kernel if its library is missing. Returns (library
    path, seconds spent here)."""
    t0 = time.perf_counter()
    path = native_build.build(SOURCE, "segsum kernel", flags=tuple(NVCC_FLAGS), build_dir=BUILD_DIR,
                              compiler=_nvcc())
    return path, time.perf_counter() - t0


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()[0])
        ptr = ctypes.c_void_p
        lib.segsum.argtypes = [ptr, ptr, ptr, ctypes.c_int64, ctypes.c_int, ptr, ptr]
        lib.segsum.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(seg: SegmentIndex, vals):
    """The kernel on CUDA tensors: `vals` (E, ...) float32, contiguous, on
    the device of the index. Returns (n, ...) float32."""
    device = vals.device
    if device.type != "cuda":
        raise ValueError(f"segsum: the kernel runs on CUDA tensors, got {device}")
    n, e = seg.n, seg.order.shape[0]
    if vals.dtype != torch.float32 or not vals.is_contiguous() or vals.dim() < 1 or vals.shape[0] != e:
        raise ValueError(f"segsum: vals must be a contiguous float32 ({e}, ...) tensor, got {vals.dtype} "
                         f"{tuple(vals.shape)} contiguous={vals.is_contiguous()}")
    if e >= 2**31:
        raise ValueError(f"segsum: the kernel indexes rows in 32 bits, got {e} rows")
    for name, t, shape in (("order", seg.order, (e,)), ("offsets", seg.offsets, (n + 1,))):
        if t.device != device or t.dtype != torch.int64 or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"segsum: {name} must be a contiguous int64 {shape} tensor on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device} contiguous={t.is_contiguous()}")
    k = math.prod(vals.shape[1:])
    out = torch.empty((n,) + vals.shape[1:], dtype=torch.float32, device=device)
    if n * k == 0:
        return out
    lib = _load()
    with torch.cuda.device(device):
        rc = lib.segsum(vals.data_ptr(), seg.order.data_ptr(), seg.offsets.data_ptr(), n, k, out.data_ptr(),
                        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError {rc}")
    mod = sys.modules[__name__]
    if torch.cuda.is_current_stream_capturing():
        mod.recorded += 1
    else:
        mod.launches += 1
    return out


def last_writes(idx, n: int):
    """(M,) bool, True where position i is the last to hold its value in
    `idx` (M,) int64, values in [0, n)."""
    at = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((n,), -1, dtype=torch.int64, device=idx.device)
    last = last.scatter_reduce(0, idx, at, reduce="amax", include_self=True)
    return last[idx] == at
