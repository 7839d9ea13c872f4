"""The fixed-order segment sum on the card: the kernel (csrc/segsum.cu
through ops/segsum.py) against its plain version (`segsum_plain`,
`torch.segment_reduce` on the same valid-aware index) and against the sums
the solvers took before padded slots were left out (`segment_reduce` on
the unmasked index, every padded slot's ±0 addend clamped onto segment 0).

Each case (marked `cuda`, skipped without a card) must be bit-equal, -0.0
apart from +0.0, to both and to the CPU's `index_add_` over every slot:
at every addend width of the call sites (K = 1, 3, 6, 7,
9, 36, 49), on ragged segments with empty ones between them, with no
addends, with every slot left out, and at the real shapes (the local BA's
24 x 2,000 = 48,000 slots over 24 cameras and 4,096 points, ~2,139 valid;
the global BA's 128 x 2,000 = 256,000 slots over 128 cameras and 32,768
points, ~19,000 valid). (Both plain sums take the addends as (E, K): on
the card `segment_reduce` sums 1-D addends, such as the BoW rows' K = 1
sums, by a tree in another order, so the kernel parts from the 1-D call
in their last bits; 2-D it sums in index order.) Also: the kernel
captured in a CUDA graph and replayed on new values equals eager; a launch counts one in `launches`,
one under capture in `recorded`; the wrapper raises on float64, on a
non-contiguous tensor and on a device mismatch; the mapping fixture's
local BA and a padded essential-graph ring through the kernel are
torch.equal to the same solves through the unmasked index and
`segment_reduce`, as the solvers ran before.

This file imports no JAX:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_segsum_card.py
"""

import chip_smoke
import numpy as np
import pytest
import torch
from torch_mapping_fixture import local_ba_problem
from torch_ring import padded_pose_graph

from orb_slam_cuda_tpu_torch.ops import segsum
from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba
from orb_slam_cuda_tpu_torch.solvers import pose_graph

torch.set_num_threads(2)
WIDTHS = {1: (), 3: (3,), 6: (6,), 7: (7,), 9: (3, 3), 36: (6, 6), 49: (7, 7)}
# (cameras or points, observation rows, slots a row, valid slots): the
# local BA's and the global BA's dense observation grids.
REAL = {"local_cams": (24, 24, 2000, 2139), "local_points": (4096, 24, 2000, 2139),
        "global_cams": (128, 128, 2000, 19000), "global_points": (32768, 128, 2000, 19000)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the segment-sum kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _padded(rng, n, e, tail, share=0.3, live=None):
    """(idx, valid, vals) on the CPU as a solver hands them over: invalid
    slots clamped onto segment 0 with ±0 addends."""
    idx = rng.choice(np.arange(n) if live is None else live, size=e)
    valid = rng.random(e) < share
    vals = rng.normal(0, 1e3, (e,) + tail).astype(np.float32)
    sign = np.where(rng.random((e,) + tail) < 0.5, -1.0, 1.0).astype(np.float32)
    vals = np.where(valid.reshape((e,) + (1,) * len(tail)), vals, np.float32(0.0) * sign)
    return torch.as_tensor(np.where(valid, idx, 0)), torch.as_tensor(valid), torch.as_tensor(vals)


def _real(name, tail, seed=0):
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


def _case(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("K"):
        return (53,) + _padded(rng, 53, 3000, WIDTHS[int(case[1:])])
    if case == "ragged":
        return (400,) + _padded(rng, 400, 20000, (6,), live=rng.choice(400, 150, replace=False))
    if case == "no_addends":
        return (37,) + _padded(rng, 37, 0, (3, 3))
    if case == "all_invalid":
        return (37,) + _padded(rng, 37, 5000, (6, 6), share=0.0)
    name, k = case.rsplit("_K", 1)
    return _real(name, WIDTHS[int(k)])


CASES = ([f"K{k}" for k in WIDTHS] + ["ragged", "no_addends", "all_invalid"]
         + [f"local_cams_K{k}" for k in (6, 36)] + [f"local_points_K{k}" for k in (3, 9)]
         + [f"global_cams_K{k}" for k in (6, 36)] + [f"global_points_K{k}" for k in (3, 9)])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_bit_equal_to_plain_and_unmasked_index(case):
    dev = _card()
    n, idx, valid, vals = (x.to(dev) if torch.is_tensor(x) else x for x in _case(case))
    seg = segsum.segment_index(n, idx, valid)
    launches = segsum.launches
    out = segsum.segsum(seg, vals)
    again = segsum.segsum(seg, vals)
    plain = segsum.segsum_plain(seg, vals)
    parent = segsum.segsum_plain(segsum.segment_index(n, idx), vals)  # the unmasked index
    cpu = torch.zeros((n,) + vals.shape[1:]).index_add_(0, idx.cpu(), vals.cpu())
    torch.cuda.synchronize()
    assert segsum.launches == launches + 2
    assert out.shape == (n,) + vals.shape[1:] and out.dtype == torch.float32
    assert torch.equal(_bits(out), _bits(again))
    assert torch.equal(_bits(out), _bits(plain)), "the kernel parts from segment_reduce on its index"
    assert torch.equal(_bits(out), _bits(parent)), "the kernel parts from segment_reduce on the unmasked index"
    assert torch.equal(_bits(out.cpu()), _bits(cpu)), "the kernel parts from the CPU's index_add_"


@pytest.mark.cuda
def test_kernel_graph_replays_equal_eager():
    """One launch captured in a CUDA graph, replayed on new values copied
    into its input: each replay equals an eager launch on those values."""
    dev = _card()
    n, idx, valid, vals = _real("local_cams", (6, 6), seed=1)
    seg = segsum.segment_index(n, idx.to(dev), valid.to(dev))
    static = vals.to(dev)
    segsum.segsum(seg, static)  # the library loads outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    recorded, launches = segsum.recorded, segsum.launches
    with torch.cuda.graph(graph):
        captured = segsum.segsum(seg, static)
    assert segsum.recorded == recorded + 1 and segsum.launches == launches
    for seed in (2, 3, 4):
        new = _real("local_cams", (6, 6), seed=seed)[3].to(dev)
        static.copy_(new)
        captured.fill_(7.0)
        graph.replay()
        eager = segsum.segsum(seg, new)
        torch.cuda.synchronize()
        assert torch.equal(_bits(captured), _bits(eager)), "a replay differs from eager"


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "device_mismatch", "rows"])
def test_kernel_wrapper_raises(bad):
    dev = _card()
    n, idx, valid, vals = _case("K36")
    seg = segsum.segment_index(n, idx.to(dev), valid.to(dev))
    vals = vals.to(dev)
    if bad == "float64":
        vals = vals.double()
    elif bad == "non_contiguous":
        vals = vals.transpose(1, 2)
    elif bad == "device_mismatch":
        seg = segsum.segment_index(n, idx, valid)  # the index on the CPU
    else:
        vals = vals[1:]
    launches = segsum.launches
    with pytest.raises(ValueError):
        segsum.segsum(seg, vals)
    assert segsum.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["local BA", "essential graph"])
def test_solvers_through_kernel_equal_unmasked_plain_sums(name):
    dev = _card()
    if name == "local BA":
        problem, cam = local_ba_problem(dev)

        def solve():
            return tuple(ba.bundle_adjust(problem, cam, lm_iters=5, cg_iters=15))
    else:
        problem = padded_pose_graph(dev)

        def solve():
            return pose_graph.optimize_pose_graph(problem, gn_iters=5, cg_iters=20)

    launches = segsum.launches
    out = solve()
    assert segsum.launches > launches
    with chip_smoke.unmasked_plain_sums():
        before = segsum.launches
        old = solve()
        assert segsum.launches == before  # no float sum through the kernel
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(a), _bits(b)) if a.is_floating_point() else torch.equal(a, b)
               for a, b in zip(out, old))
    assert all(bool(torch.isfinite(a).all()) for a in out if a.is_floating_point())
