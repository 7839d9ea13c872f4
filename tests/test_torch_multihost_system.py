"""The port's whole engine on a 2-rank gloo process group (slow tier; the
port's side of tests/test_multihost_system.py): the JAX tool's
configuration through orb_slam_cuda_tpu_torch/tools/multihost_system.py
on the CPU, with that tool's gates: >= 1 loop closed, >= 1 cluster
refinement, > 90% tracked, and byte-equal trajectories on both ranks."""

import pytest

from orb_slam_cuda_tpu_torch.tools import multihost_system


@pytest.mark.slow
def test_full_system_two_ranks_on_cpu():
    out = multihost_system.run("cpu")
    print(out)
    assert out["ok"] is True, out
    assert out["ranks_agree"] is True, out
    assert out["loops_closed"] >= 1, out
    assert out["cluster_refines"] >= 1, out
    assert out["tracked_ratio"] > 0.9, out
