"""The port's fixed-order segment sums (ops/segsum.py) are bit-equal to
`index_add_` on the CPU: float values of shapes (E,), (E,6) and (E,6,6),
ragged segments with empty ones between them, no addends at all, a large
ragged index; integer values through the same call; one sorted index
reused for several sums; and `_increase` with a float amount, which puts
the current value first in each segment. `last_writes` keeps, of the
writes of a scatter to one index, what a serial scatter leaves.

The valid-aware index (`segment_index(n, idx, valid)`, which leaves the
padded slots out, as the bundle adjustment and the essential graph use it):
bit-equal to `index_add_` over every slot when the left-out addends are ±0,
at every addend width of the call sites (K = 1, 3, 6, 7, 9, 36, 49) and
with every slot left out, none left out, -0.0 addends, no addends and
empty segments; its offsets against its lengths; on the mapping fixture's
local BA and on a padded essential-graph ring, `bundle_adjust` and
`optimize_pose_graph` give torch.equal results with it and with the
unmasked index the solvers used before; every addend those solvers hand
to a sum at a left-out slot is exactly ±0 (the premise of that equality);
and the BA reads nothing back with it (`_SyncSpy`). The kernel itself
(csrc/segsum.cu) runs only on the card: tests/test_torch_segsum_card.py.
(Run to run on CUDA, a card test in test_torch_device.py holds a local BA
to `torch.equal`, and chip_smoke.py a local BA and an essential-graph
solve.)"""

import chip_smoke
import numpy as np
import pytest
import torch
from torch_mapping_fixture import local_ba_problem
from torch_parity import _SyncSpy
from torch_ring import padded_pose_graph

from orb_slam_cuda_tpu_torch.ops import segsum
from orb_slam_cuda_tpu_torch.slam_map import ops as map_ops
from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba
from orb_slam_cuda_tpu_torch.solvers import pose_graph

torch.set_num_threads(2)


def _index_add(n, idx, vals):
    return torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype).index_add_(0, idx, vals)


def _ragged(rng, n, e):
    """An index over n segments in which about a third get no addend."""
    live = rng.choice(n, size=max(1, 2 * n // 3), replace=False)
    return torch.as_tensor(rng.choice(live, size=e))


@pytest.mark.parametrize("tail", [(), (6,), (6, 6)], ids=["E", "E6", "E66"])
@pytest.mark.parametrize("e", [0, 1, 1000])
def test_segsum_bit_equal_to_index_add(tail, e):
    rng = np.random.default_rng(e + len(tail))
    n = 37
    idx = _ragged(rng, n, e)
    vals = torch.as_tensor(rng.normal(0, 1e3, (e,) + tail).astype(np.float32))
    out = segsum.segment_sum(n, idx, vals)
    assert out.shape == (n,) + tail
    assert torch.equal(out, _index_add(n, idx, vals))
    empty = torch.ones(n, dtype=torch.bool)
    empty[idx] = False
    assert bool((out[empty] == 0).all())


def test_segsum_large_ragged_and_reused():
    rng = np.random.default_rng(1)
    n, e = 5000, 200_000
    seg = segsum.segment_index(n, _ragged(rng, n, e))
    for tail in ((3,), (6, 6)):
        vals = torch.as_tensor(rng.normal(0, 1.0, (e,) + tail).astype(np.float32))
        assert torch.equal(segsum.segsum(seg, vals), _index_add(n, seg.idx, vals))


def test_segsum_integer_values():
    rng = np.random.default_rng(2)
    idx = _ragged(rng, 50, 400)
    vals = torch.as_tensor(rng.integers(0, 3, 400).astype(np.int32))
    out = segsum.segment_sum(50, idx, vals)
    assert out.dtype == torch.int32 and torch.equal(out, _index_add(50, idx, vals))


def test_increase_with_float_amount_matches_index_add():
    rng = np.random.default_rng(3)
    arr = torch.as_tensor(rng.normal(10, 3, 300).astype(np.float32))
    ids = torch.as_tensor(rng.integers(-1, 300, 2000).astype(np.int32))
    amount = torch.as_tensor(rng.normal(0, 1, 2000).astype(np.float32))
    want = arr.clone().index_add_(0, torch.clamp(ids, min=0).long(),
                                  torch.where(ids >= 0, amount, torch.zeros_like(amount)))
    assert torch.equal(map_ops._increase(arr, ids, amount), want)
    ones = arr.clone().index_add_(0, torch.clamp(ids, min=0).long(), (ids >= 0).to(torch.float32))
    assert torch.equal(map_ops._increase(arr, ids, None), ones)


def test_last_writes_keeps_what_a_serial_scatter_leaves():
    rng = np.random.default_rng(4)
    idx = torch.as_tensor(rng.integers(0, 20, 300))
    vals = torch.arange(300, dtype=torch.int64)
    serial = torch.full((20,), -1, dtype=torch.int64)
    for i, v in zip(idx.tolist(), vals.tolist()):
        serial[i] = v
    keep = segsum.last_writes(idx, 20)
    out = torch.full((21,), -1, dtype=torch.int64)
    out[torch.where(keep, idx, torch.full_like(idx, 20))] = vals
    assert torch.equal(out[:20], serial)
    assert int(keep.sum()) == len(set(idx.tolist()))


def _bits(t):
    """A float32 tensor's bits, so that -0.0 and +0.0 differ."""
    return t.contiguous().view(torch.int32)


# The call sites' addend shapes: the map's and keyframe database's (E,),
# the BA's gradients (E,3), (E,6) and blocks (E,3,3), (E,6,6), the
# essential graph's (E,7) and (E,7,7).
WIDTHS = {1: (), 3: (3,), 6: (6,), 7: (7,), 9: (3, 3), 36: (6, 6), 49: (7, 7)}
CASES = [f"K{k}" for k in WIDTHS] + ["all_invalid", "none_invalid", "negative_zero", "no_addends", "empty_segments"]


def _padded_sum_case(case):
    """(n, idx, valid, vals) as a solver hands them over: invalid slots
    clamped onto segment 0 with ±0 addends."""
    rng = np.random.default_rng(len(case) * 7 + sum(map(ord, case)))
    tail = WIDTHS[int(case[1:])] if case.startswith("K") else (6,)
    n, e = 53, 0 if case == "no_addends" else 3000
    live = rng.choice(n, size=5, replace=False) if case == "empty_segments" else np.arange(n)
    idx = rng.choice(live, size=e)
    valid = {"all_invalid": np.zeros(e, bool), "none_invalid": np.ones(e, bool)}.get(case, rng.random(e) < 0.3)
    vals = rng.normal(0, 1e3, (e,) + tail).astype(np.float32)
    sign = np.where(rng.random((e,) + tail) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = valid.reshape((e,) + (1,) * len(tail))
    vals = np.where(mask, vals, np.float32(0.0) * sign)  # ±0 at the left-out slots
    if case == "negative_zero":  # -0.0 addends among the valid ones too
        vals = np.where(mask & (rng.random((e,) + tail) < 0.3), np.float32(-0.0), vals)
    idx = np.where(valid, idx, 0)
    return n, torch.as_tensor(idx), torch.as_tensor(valid), torch.as_tensor(vals)


@pytest.mark.parametrize("case", CASES)
def test_valid_aware_index_bit_equal_to_index_add(case):
    n, idx, valid, vals = _padded_sum_case(case)
    seg = segsum.segment_index(n, idx, valid)
    out = segsum.segsum(seg, vals)
    assert out.shape == (n,) + vals.shape[1:]
    want = _index_add(n, idx, vals)  # every slot, the left-out ones included
    assert torch.equal(_bits(out), _bits(want))
    parent = segsum.segsum(segsum.segment_index(n, idx), vals)  # the unmasked index
    assert torch.equal(_bits(out), _bits(parent))
    assert torch.equal(_bits(segsum.segsum_plain(seg, vals)), _bits(out))
    if case == "all_invalid":
        assert torch.equal(_bits(out), _bits(torch.zeros_like(out)))  # +0 everywhere
    counts = segsum.segsum(seg, valid.to(torch.int32))
    assert torch.equal(counts, _index_add(n, idx, valid.to(torch.int32)))


@pytest.mark.parametrize("case", ["K6", "all_invalid", "none_invalid", "no_addends", "empty_segments"])
def test_offsets_agree_with_lengths(case):
    n, idx, valid, _ = _padded_sum_case(case)
    seg = segsum.segment_index(n, idx, valid)
    assert seg.offsets.dtype == torch.int64 and seg.offsets.shape == (n + 1,)
    assert int(seg.offsets[0]) == 0 and int(seg.offsets[-1]) == int(valid.sum())
    assert torch.equal(torch.diff(seg.offsets), seg.lengths)
    assert torch.equal(seg.lengths, _index_add(n, idx, valid.long()))
    end = int(seg.offsets[-1])
    assert bool(valid[seg.order[:end]].all()) and not bool(valid[seg.order[end:]].any())
    for s in range(n):  # each segment's slots, in index order
        rows = seg.order[int(seg.offsets[s]):int(seg.offsets[s + 1])]
        assert bool((idx[rows] == s).all()) and bool((torch.diff(rows) > 0).all())


@pytest.fixture(scope="module")
def local_ba():
    problem, cam = local_ba_problem()
    valid = problem.obs_valid
    assert 0 < int(valid.sum()) < valid.shape[0] // 2  # padded slots, as on the card
    return problem, cam


def _solve(name, problem, cam=None):
    if name == "local BA":
        return tuple(ba.bundle_adjust(problem, cam, lm_iters=5, cg_iters=15))
    return pose_graph.optimize_pose_graph(problem, gn_iters=5, cg_iters=20)


@pytest.mark.parametrize("name", ["local BA", "essential graph"])
def test_solvers_equal_with_and_without_padded_slots(local_ba, name):
    problem, cam = local_ba if name == "local BA" else (padded_pose_graph(), None)
    new = _solve(name, problem, cam)
    with chip_smoke.unmasked_plain_sums():  # the index the solvers summed over before
        old = _solve(name, problem, cam)
    assert all(torch.equal(_bits(a), _bits(b)) if a.is_floating_point() else torch.equal(a, b)
               for a, b in zip(new, old))
    assert all(bool(torch.isfinite(a).all()) for a in new if a.is_floating_point())


@pytest.mark.parametrize("name", ["local BA", "essential graph"])
def test_left_out_addends_are_signed_zeros(local_ba, monkeypatch, name):
    module = ba if name == "local BA" else pose_graph
    problem, cam = local_ba if name == "local BA" else (padded_pose_graph(), None)
    valid = problem.obs_valid if name == "local BA" else problem.edge_valid
    seen = []

    def spy(seg, vals):
        if vals.is_floating_point():
            seen.append(vals[~valid])
        return segsum.segsum(seg, vals)

    monkeypatch.setattr(module, "segsum", spy)
    _solve(name, problem, cam)
    assert len(seen) > 20  # the normal equations and every CG matvec
    assert all(v.numel() > 0 and bool((v == 0).all()) for v in seen)


def test_bundle_adjust_reads_nothing_back(local_ba):
    problem, cam = local_ba
    with _SyncSpy() as spy:
        ba.bundle_adjust(problem, cam, lm_iters=2, cg_iters=4)
    assert not spy.hits, spy.hits
