"""Multi-sequence work sharding over 2 gloo ranks on the CPU (slow tier;
the port's side of tests/test_multiseq_shard.py): two stereo sequences
through one hall, one a rank, merged and polished by a global BA over
the group (orb_slam_cuda_tpu_torch/tools/multiseq_shard.py), with the JAX
tool's gates: both ranks > 85% tracked, byte-equal merged poses, > 0
cross-map covisibility edges, and a merged ATE under twice the worse
rank's own."""

import pytest

from orb_slam_cuda_tpu_torch.tools import multiseq_shard


@pytest.mark.slow
def test_multiseq_work_sharding_two_ranks_on_cpu():
    out = multiseq_shard.run("cpu")
    print(out)
    assert out["ok"] is True, out
    assert out["ranks_agree"] is True, out
    assert out["cross_covis_edges"] > 0, out
    assert out["merged_ate_m"] < 2.0 * max(out["local_ate_m"]), out
    assert out["total_frames"] == 240
