"""The loop closer's Sim3 stage on the card: the Sim3 RANSAC kernel
(csrc/sim3_ransac.cu through ops/sim3_kernel.py) against its plain version
(solvers/sim3_solver.py::solve_sim3_ransac_plain, `torch.linalg.eigh`) on
the same inputs, and the stage's four programs replayed against eager.

Each case (marked `cuda`, skipped without a card) is a RANSAC problem of M
matches between two camera-frame point sets under a Sim3, a share of them
outliers, observed by a KITTI camera with the reference's per-octave
thresholds 9.210 sigma^2 (`sim3_kernel.synthetic_problem`), and 128 minimal
sets from the loop closer's own draw. Gates, each the same as
`chip_smoke.py`'s on the loop path's real inputs: `ok` equal; n_inliers
within 2; the inlier masks part on at most 2 matches (the kernel solves
Horn in double, the plain version in float32, so a match within rounding
of its threshold may fall the other way); R, t and s within 1e-4 of
float64 Horn on the inliers the kernel refitted on
(`sim3_kernel.reference64`); two launches torch.equal. Cases: M = 1000
(the RGB-D and CLI paths' keyframes) and 2000 (the loop path's), with and
without a fixed scale; every pair valid at M = 2000 and at 4500 (past one
tile of the kernel's shared-memory staging); 1 and 131 hypotheses; a
collinear minimal set; all matches invalid; fewer than 3 valid; two groups
of matches under two Sim3s that tie on their count, where the first
hypothesis of the tie must win, in either order, and ties between blocks
of the launch at other places, where the lowest index must win; three
eager launches and a captured CUDA graph replayed three times, all
torch.equal, the kernel's ticket 0 after each; one device launch a call
(torch.profiler). Then `sim3_match`, `sim3_ransac`, `sim3_refine` and `loop_gate` on the ring of
tests/torch_ring.py (built on the card with the port's own code): each
captured on one candidate and replayed on it and on another keyframe
pair, torch.equal to eager (`sim3_refine` captures at a key's second
call), with the kernel's launches counted inside the replays.

This file imports no JAX:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_loop_card.py
"""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu_torch.engine import loop_closing as tlc
from orb_slam_cuda_tpu_torch.engine import programs
from orb_slam_cuda_tpu_torch.geometry import sim3
from orb_slam_cuda_tpu_torch.ops import sim3_kernel
from orb_slam_cuda_tpu_torch.slam_map.state import slot_index
from orb_slam_cuda_tpu_torch.solvers import initializer, sim3_solver

torch.set_num_threads(2)
N_PARTED, N_DIFF, TOL64 = 2, 2, 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Sim3 RANSAC kernel and CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _run_both(cam, p, sets, fix_scale, min_inliers=20):
    args = (p["x1"], p["x2"], p["uv1"], p["uv2"], p["valid"], sets, p["th1"], p["th2"], cam, fix_scale, min_inliers)
    out = sim3_kernel.launch(*args)
    again = sim3_kernel.launch(*args)
    plain = sim3_solver.solve_sim3_ransac_plain(p["x1"], p["x2"], p["uv1"], p["uv2"], p["valid"], cam, p["th1"],
                                                p["th2"], fix_scale=fix_scale, min_inliers=min_inliers,
                                                sample_sets=sets)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again)), "two launches differ"
    return out, plain


def _check(cam, p, sets, fix_scale, out, plain, rotation=True):
    R, t, s, inl, n_in, ok, info, counts, params = out
    assert bool(ok) == bool(plain.ok)
    assert abs(int(n_in) - int(plain.n_inliers)) <= N_DIFF, (int(n_in), int(plain.n_inliers))
    assert int((inl != plain.inliers).sum()) <= N_PARTED
    assert int(n_in) == int(inl.sum()) and bool(ok) == (int(n_in) >= 20)
    assert int(counts[int(info[0])]) == int(counts.max())
    assert int((counts == counts.max()).nonzero()[0]) == int(info[0]), "not the first maximum"
    if fix_scale:
        assert float(s) == 1.0
    if rotation:
        R64, t64, s64 = sim3_kernel.reference64(p["x1"], p["x2"], p["uv1"], p["uv2"], p["valid"], sets, p["th1"],
                                                p["th2"], cam, fix_scale, info, params)
        for a, b in ((R, R64), (t, t64), (s, s64)):
            assert float((a.double() - b).abs().max()) <= TOL64, (a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1000, 2000])
@pytest.mark.parametrize("fix_scale", [False, True], ids=["free_scale", "fix_scale"])
def test_sim3_kernel_against_plain(m, fix_scale):
    dev = _card()
    cam, p = sim3_kernel.synthetic_problem(dev, m, seed=m, fix_scale=fix_scale)
    sets = sim3_kernel.synthetic_sets(p, 131 * 15)
    out, plain = _run_both(cam, p, sets, fix_scale)
    assert bool(out[5]) and int(out[4]) >= 0.6 * m
    _check(cam, p, sets, fix_scale, out, plain)


@pytest.mark.cuda
def test_sim3_kernel_collinear_minimal_set():
    """Hypothesis 0 is three collinear matches, whose rotation about the
    line is free: the kernel's Jacobi and `eigh` may pick other ones."""
    dev = _card()
    cam, p = sim3_kernel.synthetic_problem(dev, 2000, seed=3)
    line = torch.tensor([[0.0, 0.0, 10.0], [1.0, 0.5, 12.0], [2.0, 1.0, 14.0]], device=dev)
    p["x2"][:3] = line
    S = sim3.exp(torch.tensor([0.4, -0.1, 0.6, 0.03, -0.2, 0.01, 0.2], device=dev))
    p["x1"][:3] = sim3.transform(S, line)
    sets = sim3_kernel.synthetic_sets(p, 7)
    sets[0] = torch.tensor([0, 1, 2], device=dev)
    out, plain = _run_both(cam, p, sets, False)
    _check(cam, p, sets, False, out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [0, 2], ids=["all_invalid", "two_valid"])
def test_sim3_kernel_too_few_valid(n_valid):
    dev = _card()
    cam, p = sim3_kernel.synthetic_problem(dev, 1000, seed=4, n_valid=n_valid)
    sets = sim3_kernel.synthetic_sets(p, 9)
    out, plain = _run_both(cam, p, sets, False)
    assert not bool(out[5]) and int(out[4]) <= n_valid
    _check(cam, p, sets, False, out, plain, rotation=False)
    assert torch.equal(out[3], plain.inliers)


@pytest.mark.cuda
@pytest.mark.parametrize("first", ["a", "b"])
def test_sim3_kernel_tie_takes_the_first(first):
    """Two disjoint groups of 60 matches under two Sim3s: hypotheses from
    either group count 60. The first hypothesis wins, as `argmax` picks."""
    dev = _card()
    cam, p = sim3_kernel.synthetic_problem(dev, 1000, seed=5, groups=(60, 60))
    a = torch.arange(0, 60, device=dev)
    b = torch.arange(60, 120, device=dev)
    g = torch.Generator(device="cpu").manual_seed(11)
    pick = lambda grp: grp[torch.randperm(60, generator=g)[:3].to(dev)]  # noqa: E731
    order = (a, b) if first == "a" else (b, a)
    sets = torch.stack([pick(order[h % 2]) for h in range(128)])
    out, plain = _run_both(cam, p, sets, False)
    counts, info = out[7], out[6]
    assert int(counts[0]) == int(counts[1]) == int(counts.max()), counts[:4]
    assert int(info[0]) == 0
    group = order[0]
    assert bool(out[3][group].all()) and int(out[4]) == 60
    _check(cam, p, sets, False, out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2000, 4500])
def test_sim3_kernel_every_pair_valid(m):
    """Every pair valid: the full-width call at the loop path's M, and an M
    past one tile of the kernel's staging (2,048 slots), whose passes stage
    the tiles again."""
    dev = _card()
    cam, p = sim3_kernel.synthetic_problem(dev, m, seed=m + 1)
    assert bool(p["valid"].all())
    sets = sim3_kernel.synthetic_sets(p, 131 * 15)
    out, plain = _run_both(cam, p, sets, False)
    assert bool(out[5]) and int(out[4]) >= 0.6 * m
    _check(cam, p, sets, False, out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("nh", [1, 131])
def test_sim3_kernel_hypothesis_counts(nh):
    """One hypothesis (the launch's one block is the last) and 131 (past
    the choice's 128-wide step). The one hypothesis's problem has no
    outliers: a set with one would leave its refit a point or two, whose
    rotation is not unique (as the collinear case's), and the check
    against float64 Horn would compare two arbitrary rotations."""
    dev = _card()
    cam, p = sim3_kernel.synthetic_problem(dev, 1000, seed=nh, outliers=0.0 if nh == 1 else 0.3)
    sets = sim3_kernel.synthetic_sets(p, 13)
    sets = sets[:1].contiguous() if nh == 1 else torch.cat([sets, sets[:3]]).contiguous()
    out, plain = _run_both(cam, p, sets, False)
    assert out[7].shape == (nh,)
    _check(cam, p, sets, False, out, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("winners", [(37, 70, 101, 127), (127, 130), (64, 96, 128)])
def test_sim3_kernel_tie_across_blocks(winners):
    """Hypotheses from a group of 60 matches tie at the maximum, the rest
    come from a group of 40: the lowest of `winners` must win, wherever
    the tied blocks finish and whichever lanes of the choice hold them."""
    dev = _card()
    cam, p = sim3_kernel.synthetic_problem(dev, 1000, seed=6, groups=(60, 40))
    a, b = torch.arange(0, 60, device=dev), torch.arange(60, 100, device=dev)
    g = torch.Generator(device="cpu").manual_seed(12)
    nh = max(winners) + 1 if max(winners) >= 128 else 128
    sets = torch.stack([(a if h in winners else b)[torch.randperm(len(a if h in winners else b), generator=g)[:3]
                                                   .to(dev)] for h in range(nh)])
    out, plain = _run_both(cam, p, sets, False)
    counts, info = out[7], out[6]
    assert all(int(counts[w]) == int(counts.max()) == 60 for w in winners), counts[list(winners)]
    assert int((counts == 60).sum()) == len(winners)
    assert int(info[0]) == min(winners)
    _check(cam, p, sets, False, out, plain)


@pytest.mark.cuda
def test_sim3_kernel_graph_replays_equal_eager():
    """Three eager launches, then one launch captured in a CUDA graph and
    replayed three times: all torch.equal, and the ticket (which tells the
    last block) back at 0 after each."""
    dev = _card()
    cam, p = sim3_kernel.synthetic_problem(dev, 2000, seed=8)
    sets = sim3_kernel.synthetic_sets(p, 21)
    args = (p["x1"], p["x2"], p["uv1"], p["uv2"], p["valid"], sets, p["th1"], p["th2"], cam, False, 20)
    eager = []
    for _ in range(3):
        eager.append(sim3_kernel.launch(*args))
        torch.cuda.synchronize()
        assert int(sim3_kernel._tickets[dev.index or 0]) == 0
    assert all(torch.equal(a, b) for e in eager[1:] for a, b in zip(eager[0], e))
    graph = torch.cuda.CUDAGraph()
    recorded = sim3_kernel.recorded
    with torch.cuda.graph(graph):
        captured = sim3_kernel.launch(*args)
    assert sim3_kernel.recorded == recorded + 1
    for _ in range(3):
        for t in captured:
            t.fill_(0)
        graph.replay()
        torch.cuda.synchronize()
        assert int(sim3_kernel._tickets[dev.index or 0]) == 0
        assert all(torch.equal(a, b) for a, b in zip(eager[0], captured)), "a replay differs from eager"


@pytest.mark.cuda
def test_sim3_kernel_is_one_device_launch():
    """torch.profiler over one call between two one-element fills (a
    profile of the lone kernel can record no device event at all, as one
    did in chip_smoke.py's process): one device event between them, the
    kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    cam, p = sim3_kernel.synthetic_problem(dev, 2000, seed=9)
    sets = sim3_kernel.synthetic_sets(p, 22)
    args = (p["x1"], p["x2"], p["uv1"], p["uv2"], p["valid"], sets, p["th1"], p["th2"], cam, False, 20)
    sim3_kernel.launch(*args)  # builds and loads the kernel, and makes the ticket, outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=dev)
        sim3_kernel.launch(*args)
        torch.ones(1, device=dev)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    assert len(names) == 3 and "FillFunctor" in names[0] and "FillFunctor" in names[2], names
    assert "ransac_kernel" in names[1], names


def _flat(out):
    leaves = []
    programs._flatten(out, leaves)
    return leaves


def _graphed_equals_eager(program, args, args2):
    """`program` on `args` until it captures (its `capture_at` calls, eager
    before the capturing one), on `args` again and on `args2` (two
    replays of one graph), each torch.equal to eager."""
    assert programs.program_key(*args) == programs.program_key(*args2)
    with programs.eager():
        refs = [_flat(program(*a)) for a in (args, args2)]
    before = program.stats()
    calls = [args] * program.capture_at + [args, args2]
    outs = []
    for i, a in enumerate(calls):
        outs.append(_flat(program(*a)))
        if i < program.capture_at - 1:
            assert program.stats()["captures"] == before["captures"], f"{program.name} captured at call {i + 1}"
    torch.cuda.synchronize()
    stats = program.stats()
    assert stats["captures"] - before["captures"] == 1 and stats["replays"] - before["replays"] == 2
    for ref, out in zip([refs[0]] * (len(calls) - 1) + [refs[1]], outs):
        assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(ref, out)), program.name
    assert not all(torch.equal(a, b) for a, b in zip(*refs)), program.name
    return refs


@pytest.mark.cuda
def test_sim3_programs_graphed_equal_eager():
    """Each Sim3 program captured on the ring's loop candidate (keyframe 15
    against 0) and replayed on it and on keyframe 14 against 1."""
    import torch_ring

    dev = _card()
    st, db, _, _, vocab = torch_ring.build_drifted_ring(np.random.default_rng(0), device=dev)
    lc = tlc.LoopCloser(torch_ring.CFG, torch_ring.CAM, vocab)
    sig2, sf = lc._level_tables(dev)
    slots = [(slot_index(15, dev), slot_index(0, dev)), (slot_index(14, dev), slot_index(1, dev))]
    match = _graphed_equals_eager(lc._match_fn, (st, *slots[0], sig2), (st, *slots[1], sig2))
    matched = [tuple(r[1:]) for r in match]  # the pairs: idx, pair_ok, x1, x2, uv1, uv2, th1, th2
    draws = [initializer.default_sampler("sim3", 131 * k + c, pairs[1]) for (k, c), pairs in
             zip(((15, 0), (14, 1)), matched)]
    before = sim3_kernel.launches
    ransac = _graphed_equals_eager(lc._ransac_fn, (matched[0], draws[0]), (matched[1], draws[1]))
    # 2 eager calls, the capturing call and 2 replays, each one launch.
    assert sim3_kernel.launches - before == 5
    assert bool(ransac[0][0][1]), "the ring's loop candidate passes RANSAC"
    refine_in = [(st, *sl, *r[1:5], sf) for sl, r in zip(slots, ransac)]
    refine = _graphed_equals_eager(lc._refine_fn, *refine_in)
    gate_in = [(st, *sl, *r[1:6], sf, 4096) for sl, r in zip(slots, refine)]
    _graphed_equals_eager(lc._gate_fn, *gate_in)
    # The stage through the programs closes the ring's loop.
    hit = lc._compute_sim3(st, 15, [0])
    assert hit is not None and hit[0] == 0
