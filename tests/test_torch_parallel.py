"""The port's distributed back end (orb_slam_cuda_tpu_torch/parallel/)
against the JAX package's. The JAX side runs on conftest.py's 8-device
virtual CPU mesh; the port's side in 4 gloo ranks spawned once for the
module (tests/torch_ranks.py, a `file://` store under a temporary
directory), whose sub-groups of the first 1 and 2 ranks stand for the
smaller meshes, while the JAX side is computed here meanwhile.

Tolerances: covisibility_clusters equal; partition_problem's rows, pblk,
emax and obs_src for every rank equal to JAX device d's (floats too:
they are copies); distributed_bundle_adjust at 1, 2 and 4 ranks on
tests/test_bundle_adjust.py::build_problem: poses and points within 1e-3,
final_error within rtol 1e-3 of JAX on the mesh of the same size, inlier
masks equal, the ranks torch.equal to each other, and 1 rank within 1e-5
of the port's bundle_adjust; cluster_block_ba without a mesh against JAX
without one on test_parallel.py's noisy ring: kf_pose within 1e-4 and
mp_xyz within 1e-3, and the port on 2 ranks torch.equal to the port with
no group; map merging: find_cross_map_link's keyframe equal and S_ab
within 1e-3 (the reference's RANSAC draws injected), merge_maps' slot
maps and integer arrays exact and floats within 1e-5, fuse_seam's
bindings exact, merged_global_ba on 2 ranks within the BA tolerance of
JAX on a 2-device mesh; a System with a 1-rank mesh and cluster
refinement against the JAX System with a 1-device mesh on the same
frames by outcome (tracked frames and keyframes equal, the same number of
refinements, ATE < 0.10 m in both)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from orb_slam_cuda_tpu.engine import Sensor as JSensor
from orb_slam_cuda_tpu.engine import System as JSystem
from orb_slam_cuda_tpu.engine import SystemConfig as JConfig
from orb_slam_cuda_tpu.geometry.camera import Camera as JCamera
from orb_slam_cuda_tpu.parallel import cluster_ba as jcba
from orb_slam_cuda_tpu.parallel import dist_ba as jdist
from orb_slam_cuda_tpu.parallel import make_mesh as jmake_mesh
from orb_slam_cuda_tpu.parallel import map_merge as jmm
from orb_slam_cuda_tpu.parallel import multihost as jmh
from orb_slam_cuda_tpu.slam_map import MapConfig as JMapConfig
from orb_slam_cuda_tpu.slam_map import MapState as JMapState
from orb_slam_cuda_tpu.slam_map import ops as jmap_ops
from orb_slam_cuda_tpu.solvers import bundle_adjust as jba
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu_torch.parallel import cluster_ba as tcba
from orb_slam_cuda_tpu_torch.parallel import map_merge as tmm
from orb_slam_cuda_tpu_torch.parallel import multihost as tmh
from orb_slam_cuda_tpu_torch.slam_map import MapConfig
from orb_slam_cuda_tpu_torch.slam_map import ops as tmap_ops
from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as tba
from orb_slam_cuda_tpu_torch.utils import convert
from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers
import test_loop_closing as ring_fixture
import torch_ranks
from test_bundle_adjust import build_problem
from torch_parity import assert_same, jax_sampler, to_np

torch.set_num_threads(2)
WORLD = 4
BA_ITERS = dict(lm_iters=8, cg_iters=15)
CLUSTER_KW = dict(n_clusters=8, rounds=1, cams_per=8, pts_per=1024)
MERGED_CFG = dict(max_keyframes=64, max_features=256, max_points=4096, n_levels=4)
W, H = 320, 240
SYS_CAM = dict(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
# A keyframe every second frame, none culled: 16 frames give 9
# keyframes, and a refinement is queued at the 8th (every 4th once the map
# holds 8).
SYS_CFG = dict(n_features=600, max_keyframes=64, max_points=8192, enable_loop_closing=True,
               max_frames_between_kf=2, min_frames_between_kf=2, kf_ref_ratio=1.5,
               kf_cull_redundancy=2.0, cluster_refine_interval=4)
SYS_FRAMES = 16


def _arrays(nt) -> dict:
    return {k: np.array(to_np(v)) for k, v in nt._asdict().items()}


def _camera_args(cam) -> dict:
    return dict(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy), bf=float(cam.bf),
                width=int(cam.width), height=int(cam.height))


def _partition_problem():
    """build_problem with every 7th observation invalid and 11 padding
    rows (-1 indices) appended: round-robin and uneven blocks."""
    problem, _, _, _ = build_problem(np.random.default_rng(1), n_cams=5, n_pts=77, bf=50.0)
    a = _arrays(problem)
    a["obs_valid"][::7] = False
    pad = dict(obs_cam=-1, obs_pt=-1, obs_uv=0.0, obs_ur=-1.0, obs_inv_sigma2=1.0, obs_valid=False)
    for k, fill in pad.items():
        a[k] = np.concatenate([a[k], np.full((11,) + a[k].shape[1:], fill, a[k].dtype)])
    return a


def _noisy_ring():
    """test_parallel.py's fixture: the drifted ring without drift, points
    perturbed by 4 mm."""
    rng = np.random.default_rng(0)
    st, db, _, _, vocab = ring_fixture.build_drifted_ring(rng, drift=0.0)
    noise = jnp.asarray(rng.normal(0, 0.004, (st.mp_xyz.shape[0], 3)).astype(np.float32))
    st = st._replace(mp_xyz=jnp.where(st.mp_valid[:, None], st.mp_xyz + noise, st.mp_xyz))
    return st, db, vocab


def _rigid(angle_axis, t):
    from orb_slam_cuda_tpu.geometry import se3 as jse3

    R = np.asarray(jse3.so3_exp(jnp.asarray(np.asarray(angle_axis, np.float32))))
    return R.copy(), np.asarray(t, np.float32), np.float32(1.0)


def _moved_copy(st, S):
    """Map B: map A seen from another world frame, p_a = S(p_b)."""
    R, t, _ = S
    S4 = np.eye(4, dtype=np.float32)
    S4[:3, :3], S4[:3, 3] = R, t
    a = {k: np.asarray(v) for k, v in st._asdict().items()}
    a["kf_pose"] = (a["kf_pose"] @ S4).astype(np.float32)
    a["mp_xyz"] = ((a["mp_xyz"] - t) @ R).astype(np.float32)
    a["mp_normal"] = (a["mp_normal"] @ R).astype(np.float32)
    return JMapState(**{k: jnp.asarray(v) for k, v in a.items()})


def _seam_groups(merged, order_a, kf_map, a_link, b_link):
    covis = to_np(merged.covis)
    b_slots = set(kf_map.values())
    a_group = sorted(({a_link} | set(np.flatnonzero(covis[a_link] > 0).tolist())) & set(order_a))
    b_group = sorted(({b_link} | set(np.flatnonzero(covis[b_link] > 0).tolist())) & b_slots)
    return a_group, b_group


def _fuse_both_ways(mm, map_ops, merged, cfg, a_group, b_group, cam, sf, as_mask):
    a_mask = np.zeros(cfg.max_keyframes, bool)
    a_mask[a_group] = True
    b_mask = np.zeros(cfg.max_keyframes, bool)
    b_mask[b_group] = True
    pts_a = map_ops.points_of_keyframes(merged, as_mask(a_mask))
    pts_b = map_ops.points_of_keyframes(merged, as_mask(b_mask))
    merged = mm.fuse_seam(merged, cfg, b_group, pts_a, cam, sf)
    return mm.fuse_seam(merged, cfg, a_group, pts_b, cam, sf)


@pytest.fixture(scope="module")
def ring():
    st, db, vocab = _noisy_ring()
    return dict(jst=st, jdb=db, vocab=vocab, tst=convert.map_state(st), tdb=convert.bow_db(db),
                tvocab=convert.vocabulary(vocab))


@pytest.fixture(scope="module")
def merge(ring):
    """Both packages merge the ring with a moved copy of itself under the
    true S_ab, then fuse the seam."""
    S = _rigid([0.05, 0.3, -0.02], [1.0, 0.5, -2.0])
    jst_b = _moved_copy(ring["jst"], S)
    order = [int(k) for k in np.flatnonzero(np.asarray(ring["jst"].kf_valid))]
    jcfg, tcfg = JMapConfig(**MERGED_CFG), MapConfig(**MERGED_CFG)
    j = jmm.merge_maps(ring["jst"], order, ring["jdb"], jst_b, order, ring["jdb"],
                       tuple(jnp.asarray(x) for x in S), jcfg)
    t = tmm.merge_maps(ring["tst"], order, ring["tdb"], convert.map_state(jst_b), order, ring["tdb"],
                       tuple(torch.as_tensor(x) for x in S), tcfg)
    link = 5
    groups = _seam_groups(j[0], order, j[3], link, j[3][link])
    sf = ring_fixture.CFG.scale_factors
    jf = _fuse_both_ways(jmm, jmap_ops, j[0], jcfg, *groups, ring_fixture.CAM, sf, jnp.asarray)
    tf = _fuse_both_ways(tmm, tmap_ops, t[0], tcfg, *groups, convert.camera(ring_fixture.CAM), sf,
                         torch.as_tensor)
    return dict(S=S, jst_b=jst_b, order=order, j=j, t=t, groups=groups, jfused=jf, tfused=tf)


@pytest.fixture(scope="module")
def system_frames():
    rng = np.random.default_rng(42)
    scene = jsyn.PlanarScene.default(rng, depth=5.0, second_depth=8.0, extent=12.0, tex_size=768)
    poses = jsyn.orbit_trajectory(SYS_FRAMES, radius=0.6)
    K = np.asarray(JCamera.create(**SYS_CAM).K)
    return poses, [scene.render(K, T, W, H) for T in poses]


@pytest.fixture(scope="module")
def ba_case():
    problem, _, _, cam = build_problem(np.random.default_rng(0), n_cams=5, n_pts=80, bf=50.0)
    return problem, cam


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, ba_case, ring, merge, system_frames):
    """Start the 4 ranks; the JAX fixtures run while they work."""
    problem, cam = ba_case
    inputs = dict(
        partition_problem=_partition_problem(), ba_problem=_arrays(problem), ba_cam=_camera_args(cam),
        ba_iters=BA_ITERS, ring=_arrays(ring["tst"]), ring_cam=_camera_args(ring_fixture.CAM),
        ring_inv_sig2=(1.0 / np.asarray(ring_fixture.CFG.level_sigma2, np.float32)), cluster_kw=CLUSTER_KW,
        merged=_arrays(merge["tfused"]), merged_order=merge["j"][2], merged_cfg=MERGED_CFG,
        system=dict(cam=SYS_CAM, cfg=SYS_CFG, frames=system_frames[1]),
    )
    root = str(tmp_path_factory.mktemp("ranks"))
    return tmh.start_ranks(torch_ranks.parity_cases, WORLD, (inputs,), root=root, backend="gloo",
                           device="cpu")


@pytest.fixture(scope="module")
def jax_side(ranks, ba_case, ring, merge, system_frames):
    problem, cam = ba_case
    out = {"partition": {}, "dist_ba": {}}
    pp = _partition_problem()
    jpp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in pp.items()})
    for n in (2, 4):
        out["partition"][n] = jdist.partition_problem(jpp, jmake_mesh(n))
    for n in (1, 2, 4):
        out["dist_ba"][n] = jdist.distributed_bundle_adjust(problem, cam, jmake_mesh(n), **BA_ITERS)
    inv = 1.0 / jnp.asarray(ring_fixture.CFG.level_sigma2, jnp.float32)
    out["cluster"] = jcba.cluster_block_ba(ring["jst"], ring_fixture.CAM, inv, mesh=None, **CLUSTER_KW)
    out["merged_gba"] = jmm.merged_global_ba(merge["jfused"], merge["j"][2], JMapConfig(**MERGED_CFG),
                                            ring_fixture.CAM, mesh=jmake_mesh(2), lm_iters=6, cg_iters=15)
    poses, frames = system_frames
    slam = JSystem(JConfig(camera=JCamera.create(**SYS_CAM), sensor=JSensor.MONOCULAR, mesh=jmake_mesh(1),
                           **SYS_CFG))
    for i, img in enumerate(frames):
        slam.track_monocular(img, i * 0.1)
    out["system"] = slam
    return out


@pytest.fixture(scope="module")
def port_side(ranks, jax_side):
    return tmh.join_ranks(ranks, timeout=900)


@pytest.fixture(scope="module")
def ring_inv_sig2():
    return torch.as_tensor(1.0 / np.asarray(ring_fixture.CFG.level_sigma2, np.float32))


# ---------------------------------------------------------------------------
def test_covisibility_clusters_equal_reference():
    rng = np.random.default_rng(3)
    K = 16
    blobs = np.zeros((K, K), np.int32)
    for a in range(8):
        for b in range(8):
            if a != b:
                blobs[a, b] = blobs[8 + a, 8 + b] = 50
    noisy = rng.integers(0, 30, (24, 24)).astype(np.int32) * (rng.random((24, 24)) < 0.3)
    noisy = np.maximum(noisy, noisy.T)
    valid = rng.random(24) < 0.8
    for covis, kf_valid, n in ((blobs, np.ones(K, bool), 2), (noisy, valid, 3), (noisy, valid, 5),
                               (noisy, np.zeros(24, bool), 2)):
        assert_same(jmh.covisibility_clusters(covis, kf_valid, n), tmh.covisibility_clusters(covis, kf_valid, n),
                    what=f"{n} clusters")


def test_initialize_distributed_is_noop_for_one_process(monkeypatch):
    assert tmh.initialize_distributed() is False
    assert tmh.initialize_distributed("file:///nonexistent/store", num_processes=1, process_id=0) is False
    assert not dist.is_initialized()
    assert tmh.default_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmh.default_backend(2, "cuda") == "nccl"
    assert tmh.default_backend(3, "cuda") == "gloo"  # ranks share a card


@pytest.mark.parametrize("n", [2, 4])
def test_partition_matches_reference(port_side, jax_side, n):
    jp = jax_side["partition"][n]
    emax = jp.obs_src.shape[0] // n
    for d in range(n):
        tp = port_side[d]["partition"][n]
        assert tp["pblk"] == jp.pblk and tp["n_obs"] == jp.n_obs and tp["n_pts"] == jp.n_pts
        assert tp["obs_src"].shape == (emax,)
        assert_same(np.asarray(jp.obs_src)[d * emax:(d + 1) * emax], tp["obs_src"], what=f"obs_src {d}")
        rows = slice(d * emax, (d + 1) * emax)
        block = slice(d * jp.pblk, (d + 1) * jp.pblk)
        for k, v in _arrays(jp.local).items():
            want = v if k in ("cam_pose", "cam_fixed") else v[block] if k in ("xyz", "pt_valid") else v[rows]
            assert_same(want, tp["local"][k], what=f"rank {d} {k}")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_distributed_ba_matches_reference(port_side, jax_side, n):
    j = jax_side["dist_ba"][n]
    first = port_side[0]["dist_ba"][n]
    for d in range(n):
        t = port_side[d]["dist_ba"][n]
        for k in t:
            assert torch.equal(torch.as_tensor(t[k]), torch.as_tensor(first[k])), f"rank {d} {k}"
    assert_same(j.cam_pose, first["cam_pose"], rtol=0, atol=1e-3, what="cam_pose")
    assert_same(j.xyz, first["xyz"], rtol=0, atol=1e-3, what="xyz")
    assert_same(j.obs_inlier, first["obs_inlier"], what="obs_inlier")
    np.testing.assert_allclose(float(j.final_error), float(first["final_error"]), rtol=1e-3)


def test_one_rank_matches_single_device_solve(port_side, ba_case):
    problem, cam = ba_case
    single = tba.bundle_adjust(convert.ba_problem(problem), convert.camera(cam), **BA_ITERS)
    one = port_side[0]["dist_ba"][1]
    assert_same(single.cam_pose, one["cam_pose"], rtol=0, atol=1e-5, what="cam_pose")
    assert_same(single.xyz, one["xyz"], rtol=0, atol=1e-5, what="xyz")
    assert_same(single.obs_inlier, one["obs_inlier"], what="obs_inlier")
    np.testing.assert_allclose(float(single.final_error), float(one["final_error"]), rtol=1e-5)


@pytest.mark.parametrize("kw", [CLUSTER_KW, dict(n_clusters=4, rounds=2, cams_per=12, pts_per=1024)],
                         ids=["8x8", "4x12"])
def test_cluster_block_ba_matches_reference(ring, ring_inv_sig2, kw):
    """Every slot, slot 0 included: the port clips padding onto it as the
    reference does, so the maps agree after a second round too."""
    inv = 1.0 / jnp.asarray(ring_fixture.CFG.level_sigma2, jnp.float32)
    j = jcba.cluster_block_ba(ring["jst"], ring_fixture.CAM, inv, mesh=None, **kw)
    t = tcba.cluster_block_ba(ring["tst"], convert.camera(ring_fixture.CAM), ring_inv_sig2, mesh=None, **kw)
    assert_same(j.kf_pose, t.kf_pose, rtol=0, atol=1e-4, what="kf_pose")
    assert_same(j.mp_xyz, t.mp_xyz, rtol=0, atol=1e-3, what="mp_xyz")
    moved = np.abs(to_np(t.mp_xyz) - to_np(ring["tst"].mp_xyz)).max()
    assert moved > 1e-3, "the round moved nothing"


def test_cluster_padding_leaves_slot0_to_its_cluster(ring, ring_inv_sig2):
    """ROADMAP queue 3 G: padding rows clip onto slot 0 and write its old
    pose and point back after cluster 0 solved them, in both packages, so
    keyframe 0 (the map's frame) and point 0 keep their values while the
    round moves keyframe 1, which cluster 0 also solves."""
    inv = 1.0 / jnp.asarray(ring_fixture.CFG.level_sigma2, jnp.float32)
    j = jcba.cluster_block_ba(ring["jst"], ring_fixture.CAM, inv, mesh=None, **CLUSTER_KW)
    t = tcba.cluster_block_ba(ring["tst"], convert.camera(ring_fixture.CAM), ring_inv_sig2, mesh=None,
                              **CLUSTER_KW)
    for name, st in (("reference", j), ("port", t)):
        assert_same(ring["jst"].kf_pose[0], st.kf_pose[0], what=f"{name} keyframe 0 kept")
        assert_same(ring["jst"].mp_xyz[0], st.mp_xyz[0], what=f"{name} point 0 kept")
        assert not np.array_equal(to_np(ring["jst"].kf_pose[1]), to_np(st.kf_pose[1])), f"{name} keyframe 1"


def test_cluster_write_back_keeps_the_later_frontier_write_in_both_packages(ring, ring_inv_sig2):
    """ROADMAP queue 3 D: the reference scatters every cluster's camera
    rows in cluster order, a fixed frontier row writing the old pose back,
    so a keyframe that one cluster solves and a later cluster holds as
    frontier keeps its old pose. The clusters here are the keyframe order
    reversed (cluster 0 the last keyframes), so that later clusters hold
    earlier clusters' keyframes as frontier. The port mirrors it."""
    from orb_slam_cuda_tpu.parallel.cluster_ba import _gather_cluster_problems, _solve_and_scatter

    n = 8
    assign = (n - 1 - tmh.covisibility_clusters(to_np(ring["tst"].covis), to_np(ring["tst"].kf_valid), n))
    assign = np.where(to_np(ring["tst"].kf_valid), assign, -1).astype(np.int32)
    clusters = tcba._gather_cluster_problems(ring["tst"], assign, ring_inv_sig2, n, 8, 1024)
    free_in, reverted = set(), []
    for problem, cam_slots, _ in clusters:
        for slot, fixed in zip(cam_slots.tolist(), problem.cam_fixed.tolist()):
            if slot >= 0 and not fixed:
                free_in.add(slot)
            elif slot in free_in:
                reverted.append(slot)
    assert reverted, "no keyframe is free in one cluster and frontier in a later one"
    tcam = convert.camera(ring_fixture.CAM)
    t = tcba._solve_and_scatter(ring["tst"], clusters, tcam, 5, 15, None)
    inv = 1.0 / jnp.asarray(ring_fixture.CFG.level_sigma2, jnp.float32)
    problems, cam_slots, pt_slots = _gather_cluster_problems(ring["jst"], jnp.asarray(assign), inv, n, 8, 1024)
    j = _solve_and_scatter(ring["jst"], problems, cam_slots, pt_slots, ring_fixture.CAM, 5, 15)
    for slot in reverted:
        assert_same(ring["jst"].kf_pose[slot], j.kf_pose[slot], what=f"reference keyframe {slot}")
        assert_same(ring["tst"].kf_pose[slot], t.kf_pose[slot], what=f"port keyframe {slot}")
    assert_same(j.kf_pose, t.kf_pose, rtol=0, atol=1e-4, what="kf_pose")


def test_cluster_block_ba_two_ranks_equal_no_group(port_side, ring, ring_inv_sig2):
    t = tcba.cluster_block_ba(ring["tst"], convert.camera(ring_fixture.CAM), ring_inv_sig2, mesh=None,
                              **CLUSTER_KW)
    for d in (0, 1):
        got = port_side[d]["cluster"]
        assert torch.equal(torch.as_tensor(got["kf_pose"]), t.kf_pose), f"rank {d} kf_pose"
        assert torch.equal(torch.as_tensor(got["mp_xyz"]), t.mp_xyz), f"rank {d} mp_xyz"


def test_cross_map_link_matches_reference(ring, merge):
    cfg = ring_fixture.CFG
    args = (cfg.scale_factors, cfg.level_sigma2, ring["vocab"].n_words)
    kf_a, S_ab = jmm.find_cross_map_link(ring["jst"], ring["jdb"], merge["jst_b"], 5, ring_fixture.CAM, *args,
                                         fix_scale=True, word_weight=ring["vocab"].word_weight)
    tkf_a, tS_ab = tmm.find_cross_map_link(ring["tst"], ring["tdb"], convert.map_state(merge["jst_b"]), 5,
                                           convert.camera(ring_fixture.CAM), *args, fix_scale=True,
                                           word_weight=ring["tvocab"].word_weight, sampler=jax_sampler)
    assert kf_a is not None and tkf_a == kf_a
    for a, b, truth in zip(S_ab, tS_ab, merge["S"]):
        assert_same(a, b, rtol=0, atol=1e-3, what="S_ab")
        assert_same(truth, b, rtol=0, atol=5e-2, what="S_ab against the true S")


def test_merge_maps_matches_reference(merge):
    (jm, jdb, jorder, jkf, jpt), (tm, tdb, torder, tkf, tpt) = merge["j"], merge["t"]
    assert jorder == torder and jkf == tkf and jpt == tpt
    for k, v in jm._asdict().items():
        tv = getattr(tm, k)
        if np.issubdtype(to_np(tv).dtype, np.floating):
            assert_same(v, tv, rtol=0, atol=1e-5, what=k)
        else:
            assert_same(v, tv, what=k)
    for k in ("word", "valid"):
        assert_same(getattr(jdb, k), getattr(tdb, k), what=f"db.{k}")
    assert_same(jdb.weight, tdb.weight, rtol=0, atol=0, what="db.weight")


def test_fuse_seam_matches_reference(merge):
    jf, tf = merge["jfused"], merge["tfused"]
    a_group, b_group = merge["groups"]
    assert a_group and b_group
    for k in ("kf_mp", "mp_valid", "covis"):
        assert_same(getattr(jf, k), getattr(tf, k), what=k)
    cross = to_np(tf.covis)[np.ix_(merge["order"], sorted(merge["t"][3].values()))]
    assert (cross > 0).sum() > 0, "the seam bridges nothing"


def test_merged_global_ba_matches_reference(port_side, jax_side):
    j = jax_side["merged_gba"]
    for d in (0, 1):
        t = port_side[d]["merged_gba"]
        assert_same(j.kf_pose, t["kf_pose"], rtol=0, atol=1e-3, what=f"rank {d} kf_pose")
        assert_same(j.mp_xyz, t["mp_xyz"], rtol=0, atol=1e-3, what=f"rank {d} mp_xyz")
    for k in ("kf_pose", "mp_xyz"):
        assert np.array_equal(port_side[0]["merged_gba"][k], port_side[1]["merged_gba"][k]), k


def test_system_with_mesh_and_cluster_refinement_matches_reference(port_side, jax_side, system_frames):
    poses, _ = system_frames
    gt = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}

    def ate(traj):
        ts, est = camera_centers(traj)
        return ate_rmse(est, np.asarray([gt[round(t, 6)] for t in ts]))

    jslam = jax_side["system"]
    t = port_side[0]["system"]
    jate, tate = ate(jslam.get_trajectory()), ate(t["traj"])
    print(f"reference: tracked {jslam.tracked_ratio():.3f} kfs {jslam.stats.n_keyframes} refinements "
          f"{jslam.stats.n_cluster_refines} ATE {jate:.4f}; port: tracked {t['tracked_ratio']:.3f} kfs "
          f"{t['n_keyframes']} refinements {t['n_cluster_refines']} ATE {tate:.4f}")
    assert t["n_cluster_refines"] >= 1 and "cluster_refine" in t["stages"]
    assert t["n_cluster_refines"] == jslam.stats.n_cluster_refines
    assert t["tracked_ratio"] == pytest.approx(jslam.tracked_ratio())
    assert t["n_keyframes"] == jslam.stats.n_keyframes
    assert jate < 0.10 and tate < 0.10


def test_failing_rank_raises(tmp_path):
    """Rank 1 raises; the parent must raise too (whichever rank's error
    torch reports first: rank 0 may fail at its barrier when rank 1 is
    gone)."""
    from torch.multiprocessing.spawn import ProcessException

    with pytest.raises(ProcessException):
        tmh.run_ranks(torch_ranks.fail_on_rank_one, 2, root=str(tmp_path), backend="gloo", device="cpu",
                      timeout=120)


def test_mesh_retires_pipelined_frames_at_the_lag(system_frames, monkeypatch):
    """With a mesh the System must not let host timing (`_readback_ready`)
    decide when a frame retires: every rank has to take the same
    decisions. A 1-rank mesh record stands in for the group (no collective
    runs here: loop closing and cluster refinement are off)."""
    from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig
    from orb_slam_cuda_tpu_torch.geometry.camera import Camera
    from orb_slam_cuda_tpu_torch.parallel.mesh import Mesh

    def asked(self, entry):
        raise AssertionError("_readback_ready consulted with a mesh")

    monkeypatch.setattr(System, "_readback_ready", asked)
    cfg = SystemConfig(camera=Camera.create(**SYS_CAM), sensor=Sensor.MONOCULAR, n_features=600,
                       max_keyframes=64, max_points=8192, enable_loop_closing=False, pipeline_lag=2,
                       mesh=Mesh(group=None, rank=0, size=1, device=torch.device("cpu")))
    slam = System(cfg, device="cpu")
    pipelined, held = 0, 0
    for i, img in enumerate(system_frames[1][:12]):
        pipelined += int(slam._carry is not None)
        slam.track_monocular(torch.as_tensor(img), i * 0.1)
        assert len(slam._pending) <= 2
        held = max(held, len(slam._pending))
    # On the CPU a copy has always landed: without a mesh no frame would
    # stay in flight.
    assert pipelined >= 4 and held == 2 and slam.tracked_ratio() > 0.5
