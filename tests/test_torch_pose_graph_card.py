"""The essential graph's edge linearization on the card: the kernel
(csrc/pose_graph_edges.cu through ops/pose_graph_kernel.py) against its
plain version (`linearize_plain`, the float64 chain through
`torch.func.jvp`, run by torch on the card) on the same inputs, and the
solve through it captured against eager.

Each case is marked `cuda` and skips without a card. Inputs: the
256-keyframe drifted ring of chip_smoke.py's phase 5b (763 edges) padded
to the loop closer's bucket of 1,024 with identity edges, and
`branch_edges`, whose residuals take every branch of sim3.log (the
identity, so3_log's small, generic and near-pi branches, W's sigma ~ 0
and theta^2 < 1e-8, cos theta rounded past 1). Gates, the same as
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
    return chip_smoke.pose_graph_args(chip_smoke.padded_ring(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ring", "branch_edges"])
def test_kernel_equals_plain(case):
    dev = _card()
    args = _args(case, dev)
    out, again = pk.launch(*args), pk.launch(*args)
    want = pk.linearize_plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again)), "two launches differ"
    report = chip_smoke.pose_graph_against_plain(out, want, pk.branch_flags_plain(*args), args[-1])
    assert all(report["gates"].values()), report


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
