"""Parity of the port's Hamming helpers, matching primitives and search
strategies with the JAX package, on features of two rendered frames.
Tolerance: exact (indices, distances, masks)."""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine.system import System as JSystem
from orb_slam_cuda_tpu.engine.system import SystemConfig as JConfig
from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.geometry import triangulate as jtri
from orb_slam_cuda_tpu.matching import core as jcore
from orb_slam_cuda_tpu.matching import search as jsearch
from orb_slam_cuda_tpu.ops import hamming as jham
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu_torch.matching import core as tcore
from orb_slam_cuda_tpu_torch.matching import search as tsearch
from orb_slam_cuda_tpu_torch.ops import hamming as tham
from orb_slam_cuda_tpu_torch.utils import convert
from torch_parity import assert_same, jx, run_both, to_np, tt

torch.set_num_threads(2)
W, H = 320, 240
SF = tuple(1.2**i for i in range(8))
SIG2 = tuple(s * s for s in SF)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(42)
    cam = jcam.Camera.create(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, width=W, height=H)
    scene = jsyn.PlanarScene.default(rng, depth=5.0, second_depth=8.0, extent=12.0, tex_size=768)
    poses = jsyn.orbit_trajectory(40, radius=0.6)
    slam = JSystem(JConfig(camera=cam, n_features=600, enable_loop_closing=False))
    out = []
    for i in (0, 3):
        img = scene.render(np.asarray(cam.K), poses[i], W, H)
        jf = slam._frame_fn(img, slam.vocab)
        out.append((jf, convert.frame_data(jf), poses[i].astype(np.float32)))
    return cam, out


def test_hamming_helpers(frames):
    _, ((jf, tf, _), (jg, tg, _)) = frames
    d1, d2 = to_np(jf.desc), to_np(jg.desc)
    assert_same(jham.unpack_bits(jx(d1.view(np.uint32))), tham.unpack_bits(tt(d1)), what="unpack")
    bits = to_np(jham.unpack_bits(jx(d1.view(np.uint32))))
    assert_same(jham.pack_bits(jx(bits)), tham.pack_bits(tt(bits)), what="pack")
    assert_same(jham.bipolar(jx(d1.view(np.uint32))), tham.bipolar(tt(d1)), what="bipolar")
    assert_same(jham.hamming_matrix(jf.bip, jg.bip), tham.hamming_matrix(tf.bip, tg.bip), what="matrix")
    a, b = d1[:200], d2[:150]
    packed = tham.hamming_matrix_packed(tt(a), tt(b))
    assert_same(jham.hamming_matrix_packed(jx(a.view(np.uint32)), jx(b.view(np.uint32))), packed)
    assert_same(packed, tham.hamming_matrix(tham.bipolar(tt(a)), tham.bipolar(tt(b))))
    assert_same(jham.hamming_pairwise(jx(a.view(np.uint32)), jx(d2[:200].view(np.uint32))),
                tham.hamming_pairwise(tt(a), tt(d2[:200])))


def test_core_primitives():
    rng = np.random.default_rng(2)
    dist = rng.integers(0, 8, (60, 40)).astype(np.float32)  # heavy ties
    gate = rng.random((60, 40)) < 0.5
    gate[3] = False
    for a, b in zip(*run_both(jcore.best_two, tcore.best_two, dist, gate)):
        assert_same(a, b)
    rot = rng.uniform(-400, 400, 300).astype(np.float32)
    rot[:100] = rng.normal(20, 3, 100)
    valid = rng.random(300) < 0.8
    assert_same(*run_both(jcore.rotation_consistency, tcore.rotation_consistency, rot, valid))
    tgt = rng.integers(0, 30, 100).astype(np.int32)
    d = rng.integers(0, 5, 100).astype(np.float32)
    v = rng.random(100) < 0.9
    assert_same(jcore.resolve_duplicate_targets(jx(tgt), jx(d), jx(v), 30),
                tcore.resolve_duplicate_targets(tt(tgt), tt(d), tt(v), 30))


def _same_match(j, t, what):
    assert_same(j.idx, t.idx, what=f"{what} idx")
    assert_same(j.dist, t.dist, what=f"{what} dist")
    assert int(to_np(t.idx >= 0).sum()) > 0, f"{what}: fixture produced no matches"


def test_by_projection(frames):
    _, ((jf, tf, _), (jg, tg, _)) = frames
    # Frame-to-frame: queries at their own coordinates, as a motion model
    # with zero motion predicts them.
    kw = dict(radius=15.0, max_dist=100.0, ratio=0.9, check_rotation=True)
    j = jsearch.by_projection(jf.uv, jf.bip, jf.valid, jf.oct, jg.uv, jg.oct, jg.ang, jg.bip,
                              jg.valid, jx(np.float32(SF)), q_ang=jf.ang, **kw)
    t = tsearch.by_projection(tf.uv, tf.bip, tf.valid, tf.oct, tg.uv, tg.oct, tg.ang, tg.bip,
                              tg.valid, SF, q_ang=tf.ang, **kw)
    _same_match(j, t, "motion model")
    has = np.zeros(tg.capacity, bool)
    has[::7] = True
    scale = np.where(np.arange(tf.capacity) % 2 == 0, 0.625, 1.0).astype(np.float32)
    kw = dict(radius=4.0, max_dist=100.0, ratio=0.8)
    j = jsearch.by_projection(jf.uv, jf.bip, jf.valid, jf.oct, jg.uv, jg.oct, jg.ang, jg.bip,
                              jg.valid, jx(np.float32(SF)), t_has_point=jx(has),
                              q_radius_scale=jx(scale), **kw)
    t = tsearch.by_projection(tf.uv, tf.bip, tf.valid, tf.oct, tg.uv, tg.oct, tg.ang, tg.bip,
                              tg.valid, SF, t_has_point=tt(has), q_radius_scale=tt(scale), **kw)
    _same_match(j, t, "local map")


def test_for_initialization_and_bow(frames):
    _, ((jf, tf, _), (jg, tg, _)) = frames
    j = jsearch.for_initialization(jf.uv, jf.bip, jf.valid, jf.ang, jg.uv, jg.bip, jg.valid,
                                   jg.ang, jg.oct, jf.oct)
    t = tsearch.for_initialization(tf.uv, tf.bip, tf.valid, tf.ang, tg.uv, tg.bip, tg.valid,
                                   tg.ang, tg.oct, tf.oct)
    _same_match(j, t, "for_initialization")
    has = np.arange(tf.capacity) % 3 != 0
    j = jsearch.by_bow(jf.node, jf.bip, jf.valid, jf.ang, jg.node, jg.bip, jg.valid, jg.ang,
                       f1_has_point=jx(has))
    t = tsearch.by_bow(tf.node, tf.bip, tf.valid, tf.ang, tg.node, tg.bip, tg.valid, tg.ang,
                       f1_has_point=tt(has))
    _same_match(j, t, "by_bow")


def test_for_triangulation_and_fuse(frames):
    cam, ((jf, tf, T1), (jg, tg, T2)) = frames
    K = np.asarray(cam.K)
    F12 = np.asarray(jtri.fundamental_from_poses(jx(K), jx(T1), jx(K), jx(T2)))
    C1 = -T1[:3, :3].T @ T1[:3, 3]
    ep = np.asarray(jcam.project(cam, jx((T2[:3, :3] @ C1 + T2[:3, 3])[None])))[0]
    has1 = np.arange(tf.capacity) % 5 == 0
    args_j = (jf.node, jf.bip, jf.valid, jf.ang, jf.uv, jf.oct,
              jg.node, jg.bip, jg.valid, jg.ang, jg.uv, jg.oct, jx(F12), SIG2)
    args_t = (tf.node, tf.bip, tf.valid, tf.ang, tf.uv, tf.oct,
              tg.node, tg.bip, tg.valid, tg.ang, tg.uv, tg.oct, tt(F12), SIG2)
    j = jsearch.for_triangulation(*args_j, epipole_uv=jx(ep), scale_factors=SF, f1_has_point=jx(has1))
    t = tsearch.for_triangulation(*args_t, epipole_uv=tt(ep), scale_factors=SF, f1_has_point=tt(has1))
    _same_match(j, t, "for_triangulation")

    pred = np.clip(to_np(jf.oct), 0, 7)
    j = jsearch.fuse(jf.uv, jf.bip, jf.valid, jx(pred), jg.uv, jg.oct, jg.bip, jg.valid, jx(np.float32(SF)),
                    radius=15.0)
    t = tsearch.fuse(tf.uv, tf.bip, tf.valid, tt(pred), tg.uv, tg.oct, tg.bip, tg.valid, SF, radius=15.0)
    _same_match(j, t, "fuse")


def test_predict_octave():
    rng = np.random.default_rng(4)
    dist = rng.uniform(0.01, 20, 500).astype(np.float32)
    maxd = rng.uniform(0.5, 30, 500).astype(np.float32)
    logsf = np.log(np.float32(1.2))
    assert_same(jsearch.predict_octave(jx(dist), jx(maxd), jx(logsf), 8),
                tsearch.predict_octave(tt(dist), tt(maxd), tt(logsf), 8))


def test_duplicate_resolution_ties_in_both_packages():
    """The duplicate resolution's key, distance * 1e6 + query index in
    float32, cannot hold the query index once the distance passes about
    17 (2^24 / 1e6): two queries at distance 40 on one target tie, and both
    packages keep both claims (ROADMAP queue 3, a fault of the reference
    that the port mirrors). The port's binding then keeps the later
    query's value, as the reference's serial scatter does, on any device."""
    from orb_slam_cuda_tpu_torch.engine import tracking as ttr

    target = np.array([3, 3, 5, 3], np.int32)
    dist = np.array([40.0, 40.0, 40.0, 12.0], np.float32)
    valid = np.array([True, True, True, False])
    j = jcore.resolve_duplicate_targets(jx(target), jx(dist), jx(valid), 8)
    t = tcore.resolve_duplicate_targets(tt(target), tt(dist), tt(valid), 8)
    assert_same(j, t, what="kept claims")
    assert to_np(t).tolist() == [True, True, True, False]
    bound = ttr._bind(8, tt(target).long(), torch.tensor([10, 11, 12, 13]), t)
    assert bound.tolist() == [-1, -1, -1, 11, -1, 12, -1, -1]
