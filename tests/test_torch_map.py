"""Parity of the port's map state, map ops, keyframe database and the
local-mapping map operations with the JAX package, run as the same
sequence of operations on one fixture map. Tolerances: integer and bool
arrays exact, floats within 1e-5. Two scatters where the reference
clips padding onto index 0 are checked separately (ROADMAP queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine import local_mapping as jlm
from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.slam_map import keyframe_db as jdb
from orb_slam_cuda_tpu.slam_map import ops as jops
from orb_slam_cuda_tpu.slam_map import state as jst
from orb_slam_cuda_tpu.solvers import bundle_adjust as jba
from orb_slam_cuda_tpu_torch.engine import local_mapping as tlm
from orb_slam_cuda_tpu_torch.slam_map import keyframe_db as tdb
from orb_slam_cuda_tpu_torch.slam_map import ops as tops
from orb_slam_cuda_tpu_torch.slam_map import state as tst
from orb_slam_cuda_tpu_torch.utils import convert
from torch_parity import assert_same, jx, random_poses, to_np, tt

torch.set_num_threads(2)
K, N, P = 8, 64, 300
CFG_J = jst.MapConfig(max_keyframes=K, max_features=N, max_points=P)
CFG_T = tst.MapConfig(max_keyframes=K, max_features=N, max_points=P)
CAM_ARGS = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0, width=320, height=240)


def _same_state(js, ts, what=""):
    for f in jst.MapState._fields:
        a = to_np(getattr(js, f))
        exact = not np.issubdtype(a.dtype, np.floating)
        assert_same(a, getattr(ts, f), rtol=None if exact else 1e-5, atol=0.0 if exact else 1e-5,
                    what=f"{what}: {f}")


def _fixture_arrays(seed=0):
    rng = np.random.default_rng(seed)
    poses = random_poses(rng, K, rot=0.05, trans=0.5)
    kf_mp = np.full((K, N), -1, np.int32)
    for k in range(K):
        n_bound = rng.integers(20, 50)
        kf_mp[k, rng.choice(N, n_bound, replace=False)] = rng.choice(P, n_bound, replace=False)
    kf_valid = np.ones(K, bool)
    kf_valid[6] = False
    mp_valid = rng.random(P) < 0.9
    xyz = (rng.uniform([-3, -2, 6], [3, 2, 10], (P, 3))).astype(np.float32)
    uv = np.zeros((K, N, 2), np.float32)
    for k in range(K):
        Xc = xyz[np.clip(kf_mp[k], 0, None)] @ poses[k][:3, :3].T + poses[k][:3, 3]
        uv[k] = Xc[:, :2] / Xc[:, 2:] * 200 + [160, 120]
    return dict(
        kf_pose=poses, kf_valid=kf_valid, kf_frame_id=np.arange(K, dtype=np.int32) * 3,
        kf_uv=uv, kf_right=np.full((K, N), -1.0, np.float32), kf_depth=np.full((K, N), -1.0, np.float32),
        kf_oct=rng.integers(0, 8, (K, N)).astype(np.int32),
        kf_ang=rng.uniform(0, 360, (K, N)).astype(np.float32),
        kf_desc=rng.integers(0, 2**32, (K, N, 8), dtype=np.uint32),
        kf_feat_valid=rng.random((K, N)) < 0.97,
        kf_word=rng.integers(0, 40, (K, N)).astype(np.int32),
        kf_node=rng.integers(0, 6, (K, N)).astype(np.int32),
        kf_mp=kf_mp, covis=np.zeros((K, K), np.int32),
        mp_xyz=xyz, mp_valid=mp_valid,
        mp_desc=rng.integers(0, 2**32, (P, 8), dtype=np.uint32),
        mp_normal=np.zeros((P, 3), np.float32), mp_min_dist=np.zeros(P, np.float32),
        mp_max_dist=np.full(P, 1e9, np.float32),
        mp_ref_kf=rng.integers(-1, K, P).astype(np.int32),
        mp_first_kf=rng.integers(0, K, P).astype(np.int32),
        mp_visible=rng.integers(1, 10, P).astype(np.float32),
        mp_found=rng.integers(1, 10, P).astype(np.float32),
    )


@pytest.fixture(scope="module")
def states():
    arr = _fixture_arrays()
    js = jst.MapState(**{k: jnp.asarray(v) for k, v in arr.items()})
    js = jops.update_point_stats(jops.refresh_covis_rows(js, jnp.arange(K, dtype=jnp.int32)), CFG_J)
    ts = convert.map_state(jst.MapState(**arr))
    ts = tops.update_point_stats(tops.refresh_covis_rows(ts, torch.arange(K)), CFG_T)
    _same_state(js, ts, "fixture")
    return js, ts


def test_empty_and_grow():
    _same_state(jst.empty(CFG_J), tst.empty(CFG_T), "empty")
    js, ts = jst.empty(CFG_J), tst.empty(CFG_T)
    _same_state(jst.grow_points(jst.grow_keyframes(js, 16), 512),
                tst.grow_points(tst.grow_keyframes(ts, 16), 512), "grow")


def test_counts_covisibility_and_membership(states):
    js, ts = states
    assert_same(jops.observation_counts(js), tops.observation_counts(ts))
    assert_same(jops.covisibility_matrix(js), tops.covisibility_matrix(ts))
    assert_same(jops.observation_matrix(js), tops.observation_matrix(ts), rtol=0, atol=0)
    ids = np.array([5, -1, 2, 0, -1], np.int32)
    _same_state(jops.refresh_covis_rows(js, jx(ids)), tops.refresh_covis_rows(ts, tt(ids)), "refresh")
    pts = np.array([0, 3, 7, -1, 11, 250, -1, 3], np.int32)
    assert_same(jops.covisibility_counts_for_bindings(js, jx(pts)),
                tops.covisibility_counts_for_bindings(ts, tt(pts)))
    mask = np.array([1, 0, 1, 1, 0, 0, 1, 0], bool)
    assert_same(jops.points_of_keyframes(js, jx(mask)), tops.points_of_keyframes(ts, tt(mask)))
    for k in range(K):
        assert_same(jops.top_covisible(js.covis[k], 5), tops.top_covisible(ts.covis[k], 5))
        assert_same(jops.top_covisible(js.covis[k], 12), tops.top_covisible(ts.covis[k], 12))
        assert_same(jops.keyframe_redundancy(js, k), tops.keyframe_redundancy(ts, k), rtol=1e-6)


def test_point_updates_and_culling(states):
    js, ts = states
    rng = np.random.default_rng(3)
    prob = rng.random(P) < 0.3
    age = rng.integers(0, 4, P).astype(np.int32)
    cj = jops.cull_points(js, jx(prob), jx(age))
    ct = tops.cull_points(ts, tt(prob), tt(age))
    assert_same(cj, ct)
    _same_state(jst.erase_points(js, cj), tst.erase_points(ts, ct), "erase_points")
    _same_state(jst.erase_keyframe(js, 3), tst.erase_keyframe(ts, 3), "erase_keyframe")
    mp = to_np(js.kf_mp[1])
    assert_same(jops.sanitize_bindings(js, jx(mp)), tops.sanitize_bindings(ts, tt(mp)))
    ids = np.array([4, -1, 4, 9, 299], np.int32)
    amt = np.array([1.0, 5.0, 2.0, 0.5, 3.0], np.float32)
    _same_state(jops.increase_visible(js, jx(ids)), tops.increase_visible(ts, tt(ids)), "visible")
    _same_state(jops.increase_found(js, jx(ids), jx(amt)), tops.increase_found(ts, tt(ids), tt(amt)), "found")


def test_insert_keyframe_add_and_bind(states):
    js, ts = states
    rng = np.random.default_rng(4)
    row = dict(uv=rng.uniform(0, 300, (N, 2)).astype(np.float32), right=np.full(N, -1.0, np.float32),
               depth=np.full(N, -1.0, np.float32), oct=rng.integers(0, 8, N).astype(np.int32),
               ang=rng.uniform(0, 360, N).astype(np.float32),
               desc=rng.integers(0, 2**32, (N, 8), dtype=np.uint32), valid=np.ones(N, bool),
               word=rng.integers(0, 40, N).astype(np.int32), node=rng.integers(0, 6, N).astype(np.int32),
               mp=np.where(rng.random(N) < 0.3, rng.integers(0, P, N), -1).astype(np.int32))
    pose = random_poses(rng, 1)[0]
    vals = [pose, 77] + list(row.values())
    js2 = jst.insert_keyframe(js, 6, *[jx(v) for v in vals])
    ts2 = tst.insert_keyframe(ts, 6, *[tt(v) for v in vals])
    _same_state(js2, ts2, "insert_keyframe")

    slots = np.array([5, 17, 40, 41, 299], np.int32)
    valid = np.array([1, 1, 0, 1, 1], bool)
    pts = dict(xyz=rng.normal(0, 1, (5, 3)).astype(np.float32), valid=valid,
               desc=rng.integers(0, 2**32, (5, 8), dtype=np.uint32),
               normal=np.zeros((5, 3), np.float32), min_dist=np.zeros(5, np.float32),
               max_dist=np.full(5, 1e9, np.float32), ref=np.full(5, 6, np.int32), first=np.full(5, 6, np.int32))
    js3 = jst.add_points(js2, jx(slots), *[jx(v) for v in pts.values()])
    ts3 = tst.add_points(ts2, tt(slots), *[tt(v) for v in pts.values()])
    _same_state(js3, ts3, "add_points")
    feat = np.array([3, 9, 12, 20, 33], np.int32)
    _same_state(jst.bind_observations(js3, 6, jx(feat), jx(slots), jx(valid)),
                tst.bind_observations(ts3, 6, tt(feat), tt(slots), tt(valid)), "bind")


def test_bind_observations_padding_keeps_feature0(states):
    """Padding must not overwrite a genuine bind of feature 0. The reference
    clips invalid rows onto feature 0 and writes its old value back
    (state.py bind_observations); the port routes them to a trash slot."""
    _, ts = states
    feat = torch.tensor([0, 7, 0], dtype=torch.int32)
    pts = torch.tensor([123, 124, 999], dtype=torch.int32)
    valid = torch.tensor([True, True, False])
    out = tst.bind_observations(ts, 2, feat, pts, valid)
    assert int(out.kf_mp[2, 0]) == 123 and int(out.kf_mp[2, 7]) == 124


def test_keyframe_db():
    rng = np.random.default_rng(6)
    words = rng.integers(-1, 30, 80).astype(np.int32)
    idf = rng.uniform(0.1, 2.0, 80).astype(np.float32)
    fv = rng.random(80) < 0.9
    wj = jdb.compute_bow_row(jx(words), jx(idf), jx(fv))
    wt = tdb.compute_bow_row(tt(words), tt(idf), tt(fv))
    assert_same(wj[0], wt[0])
    assert_same(wj[1], wt[1], rtol=1e-6, atol=1e-7)
    dj = jdb.insert(jdb.empty(K, 80), 3, *wj)
    dt = tdb.insert(tdb.empty(K, 80), 3, *wt)
    dj, dt = jdb.erase(jdb.insert(dj, 5, *wj), 3), tdb.erase(tdb.insert(dt, 5, *wt), 3)
    dj, dt = jdb.grow(dj, 12), tdb.grow(dt, 12)
    for a, b, c in zip(dj, dt, convert.bow_db(dj)):
        assert_same(a, b, rtol=1e-6, atol=1e-7)
        assert_same(a, c)


def test_fusion(states):
    js, ts = states
    jc = jcam.Camera.create(**CAM_ARGS)
    tc = convert.camera(jc)
    sf = tuple(CFG_T.scale_factors)
    for src, dst in ((0, 1), (2, 4), (7, 0)):
        pts_j, pts_t = js.kf_mp[src], ts.kf_mp[src]
        mj = jlm.fuse_into_keyframe(js, pts_j, dst, jc, jnp.asarray(sf, jnp.float32))
        mt = tlm.fuse_into_keyframe(ts, pts_t, dst, tc, sf)
        assert_same(mj.idx, mt.idx, what="fuse idx")
        # The same decisions applied to the same map.
        _same_state(jlm.apply_fusion(js, dst, pts_j, mj.idx), tlm.apply_fusion(ts, dst, pts_t, tt(to_np(mj.idx))),
                    f"apply_fusion {src}->{dst}")
    # Synthetic decisions with merges of both orientations.
    rng = np.random.default_rng(8)
    cand = np.where(rng.random(N) < 0.7, rng.integers(0, P, N), -1).astype(np.int32)
    first = np.zeros(N, bool)
    first[np.unique(cand, return_index=True)[1]] = True
    cand = np.where(first, cand, -1)  # a keyframe row binds each point once
    match = np.where(rng.random(N) < 0.5, rng.permutation(N), -1).astype(np.int32)
    _same_state(jlm.apply_fusion(js, 5, jx(cand), jx(match)), tlm.apply_fusion(ts, 5, tt(cand), tt(match)),
                "apply_fusion synthetic")


def test_dedup_paths_agree(states):
    """The (K,P) table path and the row-sort path keep the same bindings."""
    _, ts = states
    mp = ts.kf_mp.clone()
    mp[:, 10:20] = mp[:, 30:40]  # duplicate bindings within rows
    st = ts._replace(kf_mp=mp)
    table = tlm._dedup_observations(st)
    big = st._replace(mp_xyz=torch.zeros((16 * 1024 * 1024 // K + 1, 3)))
    assert torch.equal(table.kf_mp, tlm._dedup_observations(big).kf_mp)
    jd = jlm._dedup_observations(convert_back(st))
    assert_same(jd.kf_mp, table.kf_mp)


def convert_back(ts):
    return jst.MapState(**{f: jnp.asarray(to_np(getattr(ts, f))) for f in jst.MapState._fields})


def test_local_ba_gather_and_scatter(states):
    js, ts = states
    jc = jcam.Camera.create(**CAM_ARGS)
    tc = convert.camera(jc)
    inv_s2 = tuple(1.0 / s for s in CFG_T.level_sigma2)
    # n_points below the window's point count: no padding rows, so the
    # reference's pad-onto-slot-0 scatter cannot interfere.
    pj, cj, ptj = jlm.gather_local_ba_problem(js, 4, jc, jnp.asarray(inv_s2, jnp.float32),
                                              n_local=5, n_fixed=2, n_points=64)
    pt, ct, ptt = tlm.gather_local_ba_problem(ts, 4, tc, inv_s2, n_local=5, n_fixed=2, n_points=64)
    assert_same(cj, ct)
    assert_same(ptj, ptt)
    assert int((ptt < 0).sum()) == 0 and int((ct < 0).sum()) == 0
    for f in jba.BAProblem._fields:
        a = getattr(pj, f)
        exact = not np.issubdtype(to_np(a).dtype, np.floating)
        assert_same(a, getattr(pt, f), rtol=None if exact else 1e-6, atol=0.0, what=f)
    rj = jba.bundle_adjust(pj, jc, lm_iters=3, cg_iters=10)
    rt = convert_result(rj)
    _same_state(jlm.scatter_ba_result(js, rj, pj, cj, ptj), tlm.scatter_ba_result(ts, rt, pt, ct, ptt),
                "scatter_ba_result")


def convert_result(rj):
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as tba

    return tba.BAResult(*[tt(to_np(x)) for x in rj])


def test_scatter_ba_result_padding_keeps_slot0(states):
    """With padded camera/point slots the port writes the optimized slot-0
    pose and point 0; the reference's pads (clipped to 0) write the old
    values back over them (local_mapping.py scatter_ba_result)."""
    _, ts = states
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as tba

    cam_slots = torch.tensor([0, 2, -1])
    pt_slots = torch.tensor([0, 5, -1, -1])
    C = 3
    problem = tba.BAProblem(
        cam_pose=ts.kf_pose[cam_slots.clamp(min=0)], cam_fixed=torch.tensor([False, True, True]),
        xyz=ts.mp_xyz[pt_slots.clamp(min=0)], pt_valid=pt_slots >= 0,
        obs_cam=torch.zeros(C * N, dtype=torch.long), obs_pt=torch.zeros(C * N, dtype=torch.long),
        obs_uv=torch.zeros((C * N, 2)), obs_ur=torch.full((C * N,), -1.0),
        obs_inv_sigma2=torch.ones(C * N), obs_valid=torch.zeros(C * N, dtype=torch.bool),
    )
    new_pose = problem.cam_pose.clone()
    new_pose[0, :3, 3] += 1.0
    new_xyz = problem.xyz + 1.0
    res = tba.BAResult(new_pose, new_xyz, torch.zeros(C * N, dtype=torch.bool), torch.zeros(()))
    out = tlm.scatter_ba_result(ts, res, problem, cam_slots, pt_slots)
    assert torch.equal(out.kf_pose[0], new_pose[0])
    assert torch.equal(out.mp_xyz[0], new_xyz[0])
    assert torch.equal(out.kf_pose[2], ts.kf_pose[2])
