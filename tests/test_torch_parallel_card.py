"""The distributed back end on the card (marked `cuda`; skipped without
one): parts (a) and (b) of chip_smoke.py's parallel phase at a small size,
and (c)'s repeatability. This file imports no JAX, so it runs on a
machine that has only the port's dependencies:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_parallel_card.py

(a) distributed_bundle_adjust on a 1-rank NCCL group against
bundle_adjust on the same card: poses within 1e-4, points within 1e-3,
inlier masks equal; (b) 2 spawned ranks sharing the card over gloo: the
ranks torch.equal and each within (a)'s tolerance of bundle_adjust;
(c) a cluster_block_ba round of the drifted ring on the card, twice:
torch.equal."""

import os

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.parallel import distributed_bundle_adjust, make_mesh
from orb_slam_cuda_tpu_torch.parallel.cluster_ba import cluster_block_ba
from orb_slam_cuda_tpu_torch.parallel.multihost import join_group, run_ranks
from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as ba
from orb_slam_cuda_tpu_torch.tools import dryrun_multichip
from orb_slam_cuda_tpu_torch.tools.multihost_demo import stereo_problem

ITERS = dict(lm_iters=8, cg_iters=15)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def problem():
    arrays, cam_args, _ = stereo_problem(np.random.default_rng(5), n_cams=6, n_pts=96, bf=50.0)
    return arrays, cam_args


def _on(arrays, device):
    return ba.BAProblem(**{k: torch.as_tensor(v, device=device) for k, v in arrays.items()})


def _close(a, b):
    return (float((a.cam_pose.cpu() - b.cam_pose.cpu()).abs().max()) <= 1e-4
            and float((a.xyz.cpu() - b.xyz.cpu()).abs().max()) <= 1e-3)


@pytest.mark.cuda
def test_one_rank_on_nccl_matches_bundle_adjust_on_card(problem, tmp_path):
    import torch.distributed as dist

    _needs_card()
    arrays, cam_args = problem
    cam = Camera.create(**cam_args)
    p = _on(arrays, "cuda")
    single = ba.bundle_adjust(p, cam, **ITERS)
    join_group(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl", device="cuda")
    try:
        mesh = make_mesh(device="cuda")
        assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
        one = distributed_bundle_adjust(p, cam, mesh, **ITERS)
    finally:
        dist.destroy_process_group()
    assert _close(single, one)
    assert torch.equal(single.obs_inlier, one.obs_inlier)


@pytest.mark.cuda
def test_two_ranks_share_the_card_over_gloo(problem, tmp_path):
    _needs_card()
    arrays, cam_args = problem
    path = str(tmp_path / "problem.pt")
    dryrun_multichip.save_problem(path, arrays, cam_args, **ITERS)
    outs = run_ranks(dryrun_multichip.rank_solve, 2, (path, "cuda:0"), root=str(tmp_path / "ranks"),
                     backend="gloo", device="cuda", timeout=300)
    assert [o["device"] for o in outs] == ["cuda:0", "cuda:0"] and outs[0]["backend"] == "gloo"
    res = [ba.BAResult(**o["result"]) for o in outs]
    assert all(torch.equal(x, y) for x, y in zip(res[0], res[1]))
    single = ba.bundle_adjust(_on(arrays, "cuda"), Camera.create(**cam_args), **ITERS)
    assert all(_close(single, r) for r in res)


@pytest.mark.cuda
def test_cluster_round_repeats_on_card(tmp_path):
    import sys

    import torch.distributed as dist

    _needs_card()
    sys.path.insert(0, os.path.dirname(__file__))
    import torch_ring

    st, _, _, _, _ = torch_ring.build_drifted_ring(np.random.default_rng(0), device="cuda")
    inv = 1.0 / torch.as_tensor(torch_ring.CFG.level_sigma2, dtype=torch.float32)
    join_group(f"file://{tmp_path / 'store'}", 1, 0, backend="nccl", device="cuda")
    try:
        mesh = make_mesh(device="cuda")
        a = cluster_block_ba(st, torch_ring.CAM, inv, mesh=mesh, n_clusters=4, rounds=1, cams_per=8, pts_per=1024)
        b = cluster_block_ba(st, torch_ring.CAM, inv, mesh=mesh, n_clusters=4, rounds=1, cams_per=8, pts_per=1024)
    finally:
        dist.destroy_process_group()
    assert torch.equal(a.kf_pose, b.kf_pose) and torch.equal(a.mp_xyz, b.mp_xyz)
