"""The fixed-order segment sum on the card: the kernels (csrc/segsum.cu
through ops/segsum.py) against their plain version (`segsum_plain`,
`torch.segment_reduce` on the same valid-aware index) and against the sums
the solvers took before padded slots were left out (`segment_reduce` on
the unmasked index, every padded slot's ±0 addend clamped onto segment 0).

Each case (marked `cuda`, skipped without a card) runs through each of the
library's three entries: `segsum`, the dispatch the solvers call, and the
two kernels' own, `segsum_block` (a block a segment, rows staged through a
ring of tiles in shared memory) and `segsum_rows` (a thread a segment and
column), whatever the dispatch would pick. Each must be bit-equal, -0.0
apart from +0.0, to both plain sums and to the CPU's `index_add_` over
every slot: at every addend width of the call sites (K = 1, 3, 6, 7, 9,
36, 49), on ragged segments with empty ones between them, with no addends,
with every slot left out, at the real shapes (the local BA's 24 x 2,000 =
48,000 slots over 24 cameras and 4,096 points, ~2,139 valid; the global
BA's 128 x 2,000 = 256,000 slots over 128 cameras and 32,768 points,
~19,000 valid), on segments that cross the block kernel's ring several
times, fill exactly one tile or hold nothing, at every K, on one segment
alone, and with `vals` starting 1 or 2 floats into its buffer (a base
only 4- or 8-byte aligned; tests/torch_segsum_cases.py builds them all).
(Both plain sums take the addends as (E, K): on the card `segment_reduce`
sums 1-D addends, such as the BoW rows' K = 1 sums, by a tree in another
order, so the kernels part from the 1-D call in their last bits; 2-D it
sums in index order.) Also: each entry captured in a CUDA graph and
replayed on new values equals eager; a launch counts one in `launches`,
one under capture in `recorded`; the dispatch picks the block kernel at
the camera and vertex sums and the rows kernel at the point sums, and the
tile rows of tests/torch_segsum_cases.py mirror the source's; the wrapper raises on
float64, on a non-contiguous tensor and on a device mismatch; the mapping
fixture's local BA and a padded essential-graph ring through the kernels
are torch.equal to the same solves through the unmasked index and
`segment_reduce`, as the solvers ran before.

This file imports no JAX:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_segsum_card.py
"""

import chip_smoke
import pytest
import torch
import torch_segsum_cases as C
from torch_mapping_fixture import local_ba_problem
from torch_ring import padded_pose_graph

from orb_slam_cuda_tpu_torch.ops import segsum
from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba
from orb_slam_cuda_tpu_torch.solvers import pose_graph

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the segment-sum kernel has no CPU mode")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _sum(entry, seg, vals):
    """The sum through the dispatch (`segsum.segsum`, as the solvers call
    it) or one kernel's own entry."""
    return segsum.segsum(seg, vals) if entry == "segsum" else segsum.launch_entry(entry, seg, vals)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", segsum.ENTRIES)
@pytest.mark.parametrize("case", C.CASES + C.LONG_CASES)
def test_kernel_bit_equal_to_plain_and_unmasked_index(case, entry):
    dev = _card()
    n, idx, valid, vals = C.case(case, dev)
    seg = segsum.segment_index(n, idx, valid)
    launches = segsum.launches
    out = _sum(entry, seg, vals)
    again = _sum(entry, seg, vals)
    plain = segsum.segsum_plain(seg, vals)
    parent = segsum.segsum_plain(segsum.segment_index(n, idx), vals)  # the unmasked index
    cpu = C.index_add(n, idx, vals)
    torch.cuda.synchronize()
    assert segsum.launches == launches + 2
    assert out.shape == (n,) + vals.shape[1:] and out.dtype == torch.float32
    assert torch.equal(_bits(out), _bits(again))
    assert torch.equal(_bits(out), _bits(plain)), "the kernel parts from segment_reduce on its index"
    assert torch.equal(_bits(out), _bits(parent)), "the kernel parts from segment_reduce on the unmasked index"
    assert torch.equal(_bits(out.cpu()), _bits(cpu)), "the kernel parts from the CPU's index_add_"


@pytest.mark.cuda
def test_rule_and_tile_rows_as_the_source_states():
    """The dispatch takes the block kernel at the camera sums and the rows
    kernel at the point sums, the essential graph's vertex sums and the
    BoW rows; the cases' tile rows mirror the source's at every width."""
    _card()
    lib = segsum._load()
    assert [lib.segsum_tile_rows(k) for k in range(1, 65)] == [
        C.block_tile_rows(k) if k in C.BLOCK_WIDTHS else 0 for k in range(1, 65)]
    for n, k in ((24, 36), (24, 6), (24, 1), (128, 36), (512, 6)):
        assert segsum.kernel_name(n, k) == "segsum_block_kernel", (n, k)
    for n, k in ((4096, 9), (4096, 3), (32768, 9), (256, 49), (256, 7), (1000, 1), (513, 36), (24, 12)):
        assert segsum.kernel_name(n, k) == "segsum_rows_kernel", (n, k)


@pytest.mark.cuda
@pytest.mark.parametrize("entry", segsum.ENTRIES)
def test_kernel_graph_replays_equal_eager(entry):
    """One launch captured in a CUDA graph, replayed on new values copied
    into its input: each replay equals an eager launch on those values."""
    dev = _card()
    n, idx, valid, vals = C.real("local_cams", (6, 6), seed=1)
    seg = segsum.segment_index(n, idx.to(dev), valid.to(dev))
    static = vals.to(dev)
    _sum(entry, seg, static)  # the library loads outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    recorded, launches = segsum.recorded, segsum.launches
    with torch.cuda.graph(graph):
        captured = _sum(entry, seg, static)
    assert segsum.recorded == recorded + 1 and segsum.launches == launches
    for seed in (2, 3, 4):
        new = C.real("local_cams", (6, 6), seed=seed)[3].to(dev)
        static.copy_(new)
        captured.fill_(7.0)
        graph.replay()
        eager = _sum(entry, seg, new)
        torch.cuda.synchronize()
        assert torch.equal(_bits(captured), _bits(eager)), "a replay differs from eager"
        assert torch.equal(_bits(eager), _bits(segsum.segsum_plain(seg, new)))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "device_mismatch", "rows"])
def test_kernel_wrapper_raises(bad):
    dev = _card()
    n, idx, valid, vals = C.case("K36", dev)
    seg = segsum.segment_index(n, idx, valid)
    if bad == "float64":
        vals = vals.double()
    elif bad == "non_contiguous":
        vals = vals.transpose(1, 2)
    elif bad == "device_mismatch":
        seg = segsum.segment_index(n, idx.cpu(), valid.cpu())  # the index on the CPU
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
