"""The port's fixed-order segment sums (ops/segsum.py) are bit-equal to
`index_add_` on the CPU: float values of shapes (E,), (E,6) and (E,6,6),
ragged segments with empty ones between them, no addends at all, a large
ragged index; integer values through the same call; one sorted index
reused for several sums; and `_increase` with a float amount, which puts
the current value first in each segment. `last_writes` keeps, of the
writes of a scatter to one index, what a serial scatter leaves. (Run to
run on CUDA, a card test in test_torch_device.py holds a local BA to
`torch.equal`, and chip_smoke.py a local BA and an essential-graph
solve.)"""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu_torch.ops import segsum
from orb_slam_cuda_tpu_torch.slam_map import ops as map_ops

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
