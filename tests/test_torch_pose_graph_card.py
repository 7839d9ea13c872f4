"""The essential graph's edge linearization on the card: the kernel
(csrc/pose_graph_edges.cu through ops/pose_graph_kernel.py) against its
plain version (`linearize_plain`, the float64 chain through
`torch.func.jvp`, run by torch on the card) on the same inputs, and the
solve through it captured against eager.

Each case is marked `cuda` and skips without a card. Inputs: the
256-keyframe drifted ring of chip_smoke.py's phase 5b (763 edges) padded
to the loop closer's bucket of 1,024 with identity edges, its first 65
edges (a last block of one edge), and `branch_edges`, whose residuals take
every branch of sim3.log (the identity, so3_log's small, generic and
near-pi branches, W's sigma ~ 0 and theta^2 < 1e-8, cos theta rounded past
1); and one block mixing valid, padded, out-of-range and non-finite edges. Gates, the same as
chip_smoke.py's: r within one float32 ulp of the plain version's or 1e-12
(double cancellation at r ~ 0), Ji and Jj within 2^-22 of the edge's
largest entry, the branch flags equal, padded edges zeros, two launches
torch.equal; one device launch a call (torch.profiler); a failed launch
raises. The solve: `optimize_pose_graph` on the ring (15 Gauss-Newton
steps, as the loop closer runs it) and the loop closer's
`essential_graph_solve` on the drifted-ring map of tests/torch_ring.py
(built on the card), each captured as a program and replayed twice,
torch.equal to eager, the kernel's launches counted inside the replays;
the padded ring's solve torch.equal to the unpadded one.

This file imports no JAX:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_pose_graph_card.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from orb_slam_cuda_tpu_torch.engine import loop_closing as tlc
from orb_slam_cuda_tpu_torch.engine import programs
from orb_slam_cuda_tpu_torch.geometry import se3, sim3
from orb_slam_cuda_tpu_torch.ops import pose_graph_kernel as pk
from orb_slam_cuda_tpu_torch.slam_map import ops as map_ops
from orb_slam_cuda_tpu_torch.solvers import pose_graph

torch.set_num_threads(2)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the edge-linearization kernel and CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _args(case, dev):
    if case == "branch_edges":
        return pk.branch_edges(7, dev)
    args = chip_smoke.pose_graph_args(chip_smoke.padded_ring(dev))
    if case == "ragged":  # 65 edges: the last block of 8 holds one
        return args[:3] + tuple(a[:65].contiguous() for a in args[3:])
    return args


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ring", "branch_edges", "ragged"])
def test_kernel_equals_plain(case):
    dev = _card()
    args = _args(case, dev)
    out, again = pk.launch(*args), pk.launch(*args)
    want = pk.linearize_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again)), "two launches differ"
    report = chip_smoke.pose_graph_against_plain(out, want, pk.branch_flags_plain(*args), args[-1])
    assert all(report["gates"].values()), report


def _mixed(dev):
    """`branch_edges(7)` whose first block of 8 edges mixes every kind: valid
    edges, a padded one (edge 3), a valid one whose index lies outside [0,
    K) (edge 2), and valid ones touching a vertex with a NaN rotation entry
    (vertex 3), an infinite translation (vertex 5) or a zero scale (vertex
    6), which take the generic chain. Returns the arguments and, for the
    plain version, the same with edge 2's index in range."""
    R, t, s, ei, ej, mR, mt, ms, valid = pk.branch_edges(7, "cpu")
    R[3, 1, 1] = float("nan")
    t[5, 0] = float("inf")
    s[6] = 0.0
    for e, (i, j) in zip((4, 5, 6), ((3, 1), (2, 5), (6, 4))):
        ei[e], ej[e] = i, j
    valid[3] = False
    plain_ei = ei.clone()
    ei[2] = R.shape[0] + 3
    to = lambda xs: tuple(x.to(dev) for x in xs)  # noqa: E731
    return to((R, t, s, ei, ej, mR, mt, ms, valid)), to((R, t, s, plain_ei, ej, mR, mt, ms, valid))


@pytest.mark.cuda
def test_mixed_block():
    """One block of every kind of edge: the padded edge zeros, the one out of
    range NaN and flags -1, the rest as the plain version's: Ji and Jj NaN
    exactly where it has NaN and within 2^-22 of the edge's largest finite
    entry elsewhere, r finite exactly where it is finite and within one
    float32 ulp or 1e-12 there, the flags equal; two launches bit-equal.
    (Where W is not finite the kernel's elimination and the plain solve
    part on r's rho, NaN against inf: ROADMAP queue 3, K.)"""
    dev = _card()
    args, plain_args = _mixed(dev)
    out, again = pk.launch(*args), pk.launch(*args)
    want = pk.linearize_plain(*plain_args)
    flags_plain = pk.branch_flags_plain(*plain_args)
    torch.cuda.synchronize()
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(out, again))
    r, Ji, Jj, flags = (x.cpu() for x in out)
    assert not (r[3].any() or Ji[3].any() or Jj[3].any() or flags[3])
    assert bool(torch.isnan(r[2]).all() and torch.isnan(Ji[2]).all() and torch.isnan(Jj[2]).all()) and flags[2] == -1
    keep = torch.ones(r.shape[0], dtype=torch.bool)
    keep[2] = False
    assert torch.equal(flags[keep], flags_plain.cpu()[keep])
    nan_edges = 0
    for got, w in zip((r, Ji, Jj), (x.cpu() for x in want)):
        got, w = got[keep].flatten(1), w[keep].flatten(1)
        nan = ~torch.isfinite(w) if got.shape[1] == 7 else torch.isnan(w)
        assert torch.equal(~torch.isfinite(got) if got.shape[1] == 7 else torch.isnan(got), nan)
        nan_edges = max(nan_edges, int(nan.any(1).sum()))
        if got.shape[1] == 7:
            ulp = torch.abs(torch.nextafter(w, torch.full_like(w, float("inf"))) - w)
            tol = torch.clamp(torch.where(torch.isfinite(ulp), ulp, 0.0), min=chip_smoke.POSE_GRAPH_R_ABS)
        else:
            tol = chip_smoke.POSE_GRAPH_J_REL * torch.clamp(torch.where(nan, 0.0, w).abs().amax(1, keepdim=True),
                                                            min=1.0)
        fin = ~nan
        assert bool((torch.abs(got - w)[fin] <= tol.expand_as(w)[fin]).all())
    assert nan_edges >= 2  # the non-finite vertices reached the outputs


@pytest.mark.cuda
def test_kernel_is_one_device_launch():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    args = _args("ring", dev)
    pk.launch(*args)  # builds and loads the kernel outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=dev)
        pk.launch(*args)
        torch.ones(1, device=dev)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    assert len(names) == 3 and "FillFunctor" in names[0] and "FillFunctor" in names[2], names
    assert "pose_graph_edges_kernel" in names[1], names


@pytest.mark.cuda
def test_failed_launch_raises(monkeypatch):
    dev = _card()
    args = _args("branch_edges", dev)
    lib = pk._load()
    # The C entry refuses a null pointer with cudaErrorInvalidValue, launching nothing.
    assert lib.pose_graph_edges(0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0) != 0

    class Failing:
        @staticmethod
        def pose_graph_edges(*a):
            return 700

    monkeypatch.setattr(pk, "_lib", Failing())
    launches = pk.launches
    with pytest.raises(RuntimeError, match="cudaError 700"):
        pk.launch(*args)
    assert pk.launches == launches


def _graphed_equals_eager(fn, args, replays=2):
    """`fn` as a program: its capturing call and `replays` replays, each
    torch.equal to an eager call; the kernel's launches counted at each
    replay (its GN steps' worth)."""
    program = programs.Program(fn, "test")
    with programs.eager():
        launches = pk.launches
        ref = fn(*args)
        per_call = pk.launches - launches
    assert per_call > 0
    outs = []
    for i in range(1 + replays):
        launches = pk.launches
        outs.append(program(*args))
        if i:
            assert pk.launches - launches == per_call  # counted inside the replay
    torch.cuda.synchronize()
    assert program.stats()["captures"] == 1 and program.stats()["replays"] == replays
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    return ref


@pytest.mark.cuda
def test_graphed_ring_solve_equals_eager():
    dev = _card()
    ref = _graphed_equals_eager(lambda p: pose_graph.optimize_pose_graph(p, gn_iters=15, cg_iters=30),
                                (chip_smoke.ring_pose_graph(chip_smoke.RING_KEYFRAMES, dev),))
    assert all(bool(torch.isfinite(x).all()) for x in ref)


@pytest.mark.cuda
def test_graphed_essential_graph_solve_equals_eager():
    from torch_ring import build_drifted_ring

    dev = _card()
    state = build_drifted_ring(np.random.default_rng(0), device=dev)[0]
    K = state.kf_valid.shape[0]
    covis = map_ops.covisibility_matrix(state)
    ei, ej = tlc.essential_graph_edges(state.kf_valid, covis, list(range(16)), [(3, 9)], (0, 15))
    loop_pos = torch.searchsorted(ei * K + ej, 15)
    S_loop = sim3.compose(sim3.exp(torch.tensor([0.05, -0.02, 0.03, 0.01, 0.02, -0.01, 0.0], device=dev)),
                          sim3.from_se3(state.kf_pose[15] @ se3.inverse(state.kf_pose[0])))
    pi, pj, valid = tlc.pad_edges(ei, ej, K)
    cand = torch.full((), 0, dtype=torch.int64, device=dev)
    ref = _graphed_equals_eager(tlc.essential_graph_solve, (state, state.kf_pose, pi, pj, loop_pos, S_loop, cand,
                                                            valid))
    assert not torch.equal(ref[0], state.kf_pose)


@pytest.mark.cuda
def test_padded_ring_solve_equals_unpadded():
    dev = _card()
    ring = chip_smoke.ring_pose_graph(chip_smoke.RING_KEYFRAMES, dev)
    want = pose_graph.optimize_pose_graph(ring, gn_iters=5, cg_iters=30)
    got = pose_graph.optimize_pose_graph(chip_smoke.padded_ring(dev), gn_iters=5, cg_iters=30)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
