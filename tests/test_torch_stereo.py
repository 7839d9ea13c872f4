"""Parity of the port's stereo / RGB-D modules with the JAX package on the
same numpy inputs. match_stereo: the matched/unmatched mask exact, u_right
and depth within 1e-3 relative where matched; without images u_right is the
matched keypoint's column, exact. _sad_subpixel: `interior` exact, the
refined column within 1e-3 px. depth_from_rgbd and virtual_right: exact.
create_depth_points: chosen slots and features exact, xyz within 1e-5.
track_vo_last_frame: match count exact, pose within 1e-4. The stereo rows
of the solvers (u_right >= 0 on every observation): optimize_pose pose
within 1e-4 and inliers exact; bundle_adjust poses and points within 1e-3.

Feature 0 of the tracked frame is marked invalid in the visual-odometry
parity test: the reference scatters unmatched rows onto feature 0
(tracking.py:256-258), the port routes them to a trash row;
test_vo_keeps_match_to_feature0 records the port's side (ROADMAP queue 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine import local_mapping as jlm
from orb_slam_cuda_tpu.engine import stereo as jstereo
from orb_slam_cuda_tpu.engine import tracking as jtr
from orb_slam_cuda_tpu.engine.frame import build_frame as jbuild_frame
from orb_slam_cuda_tpu.frontend import ExtractorConfig as JExtractorConfig
from orb_slam_cuda_tpu.frontend import ORBExtractor as JExtractor
from orb_slam_cuda_tpu.frontend import image_ops as jimage_ops
from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.ops import hamming as jhamming
from orb_slam_cuda_tpu.slam_map import MapConfig as JMapConfig
from orb_slam_cuda_tpu.slam_map import state as jstate
from orb_slam_cuda_tpu.solvers import bundle_adjust as jba
from orb_slam_cuda_tpu.solvers import pose_opt as jpo
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu_torch.engine import local_mapping as tlm
from orb_slam_cuda_tpu_torch.engine import stereo as tstereo
from orb_slam_cuda_tpu_torch.engine import tracking as ttr
from orb_slam_cuda_tpu_torch.frontend import image_ops as timage_ops
from orb_slam_cuda_tpu_torch.frontend.extractor import ExtractorConfig, ORBExtractor
from orb_slam_cuda_tpu_torch.ops import hamming as thamming
from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as tba
from orb_slam_cuda_tpu_torch.solvers import pose_opt as tpo
from orb_slam_cuda_tpu_torch.utils import convert
from orb_slam_cuda_tpu_torch.utils import synthetic as tsyn
from torch_parity import (STEREO_BASELINE, STEREO_CAM, STEREO_H, STEREO_W, assert_same, jx,
                          known_disparity_set, random_poses, stereo_scene, to_np, tt)

torch.set_num_threads(2)
SF = tuple(1.2**i for i in range(8))
W, H = STEREO_W, STEREO_H


@pytest.fixture(scope="module")
def cams():
    jc = jcam.Camera.create(**STEREO_CAM)
    return jc, convert.camera(jc)


def assert_stereo_same(j, t):
    """(u_right, depth) of both packages: mask exact, values 1e-3 relative."""
    for a, b, what in zip(j, t, ("u_right", "depth")):
        a, b = to_np(a), to_np(b)
        np.testing.assert_array_equal(a >= 0, b >= 0, err_msg=f"{what} mask")
        np.testing.assert_array_equal(a[a < 0], b[a < 0])  # unmatched rows hold -1
        np.testing.assert_allclose(a[a >= 0], b[a >= 0], rtol=1e-3, err_msg=what)


def test_match_stereo_known_disparity(cams):
    jc, tc = cams
    desc, uv_l, uv_r, depth_true = known_disparity_set(np.random.default_rng(0))
    n = len(desc)
    zeros, ones = np.zeros(n, np.int32), np.ones(n, bool)
    jb = jhamming.bipolar(jx(desc))
    tb = thamming.bipolar(tt(desc))
    j = jstereo.match_stereo(jx(uv_l), jx(zeros), jb, jx(ones), jx(uv_r), jx(zeros), jb, jx(ones), jc, (1.0,))
    t = tstereo.match_stereo(tt(uv_l), tt(zeros), tb, tt(ones), tt(uv_r), tt(zeros), tb, tt(ones), tc, (1.0,))
    assert_stereo_same(j, t)
    ok = to_np(t[0]) >= 0
    assert ok.mean() > 0.9
    np.testing.assert_allclose(to_np(t[1])[ok], depth_true[ok], rtol=1e-3)
    # Without images u_right is the matched keypoint's own column.
    np.testing.assert_array_equal(to_np(j[0]), to_np(t[0]))
    assert set(to_np(t[0])[ok].tolist()) <= set(uv_r[:, 0].tolist())


@pytest.fixture(scope="module")
def rendered_pair(cams):
    """A rendered 320x240 pair, extracted on both sides by the reference."""
    jc, _ = cams
    scene = stereo_scene()
    T = jsyn.orbit_trajectory(20, radius=0.5)[3]
    left, right = scene.render_stereo(np.asarray(jc.K), T, STEREO_BASELINE, W, H)
    ext = JExtractor(JExtractorConfig(n_features=600), H, W)
    frame = jbuild_frame(ext(left), jc, None)
    return left, right, frame, ext(right)


def _match_both(cams, pair, with_images):
    jc, tc = cams
    left, right, jf, jr = pair
    tf, tr = convert.frame_data(jf), convert.features(jr)
    jimgs = dict(left_img=jx(left), right_img=jx(right)) if with_images else {}
    timgs = dict(left_img=tt(left), right_img=tt(right)) if with_images else {}
    j = jstereo.match_stereo(jf.uv, jf.oct, jf.bip, jf.valid, jr.uv, jr.octave,
                             jhamming.bipolar(jr.desc), jr.valid, jc, SF, **jimgs)
    t = tstereo.match_stereo(tf.uv, tf.oct, tf.bip, tf.valid, tr.uv, tr.octave,
                             thamming.bipolar(tr.desc), tr.valid, tc, SF, **timgs)
    return j, t, tf


@pytest.mark.parametrize("with_images", [True, False], ids=["sad", "no_sad"])
def test_match_stereo_rendered_pair(cams, rendered_pair, with_images):
    j, t, tf = _match_both(cams, rendered_pair, with_images)
    assert_stereo_same(j, t)
    matched = to_np(t[1]) > 0
    assert matched.sum() > 0.5 * int(tf.valid.sum()), matched.sum()
    assert not matched[~to_np(tf.valid)].any()
    if not with_images:
        np.testing.assert_array_equal(to_np(j[0]), to_np(t[0]))  # exact indices
    else:
        # The scene lies 5 m and 8 m away.
        assert 4.0 < np.median(to_np(t[1])[matched]) < 9.0


def test_match_stereo_takes_the_extractors_pyramids(cams, rendered_pair):
    """Handing over the pyramids the extractor built equals rebuilding them."""
    _, tc = cams
    left, right, jf, jr = rendered_pair
    ext = ORBExtractor(ExtractorConfig(n_features=600), H, W, device="cpu")
    lf, l_pyr = ext.extract_with_pyramid(left)
    rf, r_pyr = ext.extract_with_pyramid(right)
    for a, b in zip(l_pyr, timage_ops.build_pyramid(tt(left), 8, 1.2)):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(lf, ext(left)))
    args = (lf.uv, lf.octave, thamming.bipolar(lf.desc), lf.valid,
            rf.uv, rf.octave, thamming.bipolar(rf.desc), rf.valid, tc, SF)
    a = tstereo.match_stereo(*args, left_img=tt(left), right_img=tt(right))
    b = tstereo.match_stereo(*args, left_pyramid=l_pyr, right_pyramid=r_pyr)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_sad_subpixel(rendered_pair):
    left, right, jf, jr = rendered_pair
    rng = np.random.default_rng(2)
    # Seeds near the true column, some far off and some at the border.
    ur0 = to_np(jf.uv)[:, 0] - 52.0 / rng.uniform(4.5, 9.0, jf.capacity).astype(np.float32)
    ur0[::17] -= 9.0
    ur0[::23] = -3.0
    ur0 = ur0.astype(np.float32)
    jl, jr_ = jx(left).astype(jnp.float32), jx(right).astype(jnp.float32)
    j = jstereo._sad_subpixel(jl, jr_, jf.uv, jf.oct, jx(ur0), SF)
    pl, pr = timage_ops.build_pyramid(tt(left), 8, 1.2), timage_ops.build_pyramid(tt(right), 8, 1.2)
    for a, b in zip(jimage_ops.build_pyramid(jl, 8, 1.2), pl):
        assert_same(a, b, rtol=0, atol=0, what="pyramid level")
    t = tstereo._sad_subpixel(pl, pr, tt(to_np(jf.uv)), tt(to_np(jf.oct)), tt(ur0), SF)
    assert_same(j[1], t[1], what="interior")
    assert 0.2 < to_np(t[1]).mean() < 1.0
    assert_same(j[0], t[0], rtol=0, atol=1e-3, what="refined column")


def test_depth_from_rgbd_and_virtual_right(cams):
    jc, tc = cams
    rng = np.random.default_rng(4)
    depth_map = rng.uniform(0.5, 9.0, (H, W)).astype(np.float32)
    depth_map[:, :100] = 0.0
    uv = np.stack([rng.uniform(-2, W + 2, 300), rng.uniform(-2, H + 2, 300)], -1).astype(np.float32)
    uv[:4] = [[150.5, 100.5], [151.5, 99.5], [50.0, 50.0], [319.6, 239.6]]  # ties round to even
    valid = rng.random(300) < 0.9
    for dmap, factor in ((depth_map, 1.0), ((depth_map * 5000).astype(np.uint16), 1.0 / 5000.0)):
        tmap = tt(dmap.astype(np.int32)) if dmap.dtype == np.uint16 else tt(dmap)
        jd = jstereo.depth_from_rgbd(jx(uv), jx(valid), jx(dmap), jc, np.float32(factor))
        td = tstereo.depth_from_rgbd(tt(uv), tt(valid), tmap, tc, factor)
        assert_same(jd, td, what="depth")
        assert (to_np(td)[~valid] == -1).all() and (to_np(td) > 0).sum() > 100
        und = uv + 0.25
        assert_same(jstereo.virtual_right(jx(und), jd, jc), tstereo.virtual_right(tt(und), td, tc),
                    what="virtual right")
    d = tstereo.depth_from_rgbd(tt(uv[:3]), tt(np.ones(3, bool)), tt(np.where(depth_map > 0, 3.0, 0.0)
                                                                    .astype(np.float32)), tc)
    assert d.tolist() == [3.0, 3.0, -1.0]
    ur = tstereo.virtual_right(tt(uv[:3]), d, tc)
    np.testing.assert_allclose(float(ur[0]), 150.5 - tc.bf / 3.0, rtol=1e-6)
    assert float(ur[2]) == -1.0


@pytest.fixture(scope="module")
def depth_keyframe(cams):
    """A map with one keyframe whose features carry depths (many equal, so
    the sort meets ties), a third of them bound already."""
    jc, _ = cams
    rng = np.random.default_rng(6)
    N, P = 700, 2048
    cfg = JMapConfig(max_keyframes=4, max_features=N, max_points=P)
    depth = np.round(rng.uniform(0.5, 12.0, N), 1).astype(np.float32)  # 0.1 m steps: ties
    depth[rng.random(N) < 0.15] = -1.0
    valid = rng.random(N) < 0.9
    mp = np.where(rng.random(N) < 0.33, rng.permutation(N).astype(np.int32), -1).astype(np.int32)
    uv = np.stack([rng.uniform(0, W, N), rng.uniform(0, H, N)], -1).astype(np.float32)
    pose = random_poses(rng, 1, rot=0.2, trans=1.0)[0]
    st = jstate.empty(cfg)
    st = jstate.insert_keyframe(
        st, 2, jx(pose), 7, jx(uv), jx(uv[:, 0] - 52.0 / np.maximum(depth, 0.1)), jx(depth),
        jx(rng.integers(0, 8, N).astype(np.int32)), jx(rng.uniform(0, 360, N).astype(np.float32)),
        jx(rng.integers(0, 2**32, (N, 8), dtype=np.uint32)), jx(valid),
        jx(np.zeros(N, np.int32)), jx(np.zeros(N, np.int32)), jx(mp),
    )
    slots = (np.arange(512, dtype=np.int32) * 3 + 5) % P
    return st, slots


@pytest.mark.parametrize("th_depth", [0.7, 3.0, 7.0, 40.0])
def test_create_depth_points(cams, depth_keyframe, th_depth):
    jc, tc = cams
    jst, slots = depth_keyframe
    j, jn = jlm.create_depth_points(jst, jnp.int32(2), jc, jnp.float32(th_depth), jx(slots), max_new=512)
    t, tn = tlm.create_depth_points(convert.map_state(jst), 2, tc, th_depth, slots, max_new=512)
    assert int(jn) == int(tn) and int(tn) >= 100
    assert_same(j.mp_valid, t.mp_valid, what="chosen slots")
    assert_same(j.kf_mp[2], t.kf_mp[2], what="chosen features")
    used = to_np(t.mp_valid)
    assert_same(to_np(j.mp_xyz)[used], to_np(t.mp_xyz)[used], rtol=1e-5, atol=1e-5, what="xyz")
    for f in ("mp_desc", "mp_ref_kf", "mp_first_kf"):
        assert_same(to_np(getattr(j, f))[used], to_np(getattr(t, f))[used], what=f)
    depth = to_np(t.kf_depth[2])
    new = (to_np(t.kf_mp[2]) >= 0) & (to_np(jst.kf_mp[2]) < 0)
    assert new.sum() == int(tn)
    # All closer than th_depth (up to max_new), or the 100 closest.
    assert int(tn) == 100 or depth[new].max() < th_depth


@pytest.fixture(scope="module")
def vo_snapshot(cams):
    """Two consecutive RGB-D frames of the orbit, built by the reference."""
    jc, _ = cams
    scene = stereo_scene()
    poses = jsyn.orbit_trajectory(20, radius=0.5)
    ext = JExtractor(JExtractorConfig(n_features=600), H, W)
    K = np.asarray(jc.K)
    frames = []
    for T in poses[4:6]:
        img, dmap = scene.render_with_depth(K, T, W, H)
        f = jbuild_frame(ext(img), jc, None)
        d = jstereo.depth_from_rgbd(f.uv_raw, f.valid, jx(dmap), jc)
        frames.append(f._replace(depth=d, right=jstereo.virtual_right(f.uv, d, jc)))
    return frames, [T.astype(np.float32) for T in poses[4:6]]


def _vo_both(cams, snap, frame):
    jc, tc = cams
    (lf, _), (T_last, _) = snap
    tl, tf = convert.frame_data(lf), convert.frame_data(frame)
    j = jtr.track_vo_last_frame(frame, lf.uv, lf.oct, lf.ang, lf.bip, lf.depth, lf.valid,
                                jx(T_last), jx(T_last), jc, np.asarray(SF, np.float32), 7.0)
    t = ttr.track_vo_last_frame(tf, tl.uv, tl.oct, tl.ang, tl.bip, tl.depth, tl.valid,
                                T_last, T_last, tc, SF, 7.0)
    return j, t


def test_track_vo_last_frame(cams, vo_snapshot):
    frames, poses = vo_snapshot
    cur = frames[1]._replace(valid=frames[1].valid.at[0].set(False))
    j, t = _vo_both(cams, vo_snapshot, cur)
    assert int(j[1]) == int(t[1]) and int(t[1]) >= 50, "match count"
    assert int(j[2]) == int(t[2]), "inlier count"
    assert_same(j[0], t[0], rtol=0, atol=1e-4, what="pose")
    np.testing.assert_allclose(to_np(t[0]), poses[1], atol=0.05)


def test_vo_keeps_match_to_feature0(cams, vo_snapshot):
    """Tracking a frame against itself matches every feature with a depth
    to itself, feature 0 too; the port counts it among the inliers."""
    _, tc = cams
    (lf, _), (T_last, _) = vo_snapshot
    tl = convert.frame_data(lf)
    assert bool(tl.valid[0]) and float(tl.depth[0]) > 0

    def run(frame):
        return ttr.track_vo_last_frame(frame, tl.uv, tl.oct, tl.ang, tl.bip, tl.depth, tl.valid,
                                       T_last, T_last, tc, SF, 7.0)

    with0 = run(tl)
    valid = tl.valid.clone()
    valid[0] = False
    without0 = run(tl._replace(valid=valid))
    assert int(with0[1]) == int(without0[1]) + 1
    assert int(with0[2]) == int(without0[2]) + 1
    np.testing.assert_allclose(to_np(with0[0]), T_last, atol=1e-4)


def test_optimize_pose_all_stereo(cams):
    jc, tc = cams
    rng = np.random.default_rng(8)
    M = 300
    T = random_poses(rng, 1, rot=0.1, trans=0.3)[0]
    X = (rng.uniform(-2, 2, (M, 3)) + [0, 0, 6]).astype(np.float32)
    Xc = X @ T[:3, :3].T + T[:3, 3]
    uv = (Xc[:, :2] / Xc[:, 2:] * 260.0 + [W / 2, H / 2] + rng.normal(0, 0.5, (M, 2))).astype(np.float32)
    ur = (uv[:, 0] - 52.0 / Xc[:, 2] + rng.normal(0, 0.5, M)).astype(np.float32)
    uv[:30] += rng.uniform(15, 40, (30, 2)).astype(np.float32)
    ur[30:50] -= 12.0  # wrong depths only
    ur[250:] = -1.0  # some monocular edges among them
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 3, M))).astype(np.float32)
    valid = rng.random(M) < 0.95
    T0 = (random_poses(rng, 1, rot=0.01, trans=0.05)[0] @ T).astype(np.float32)
    j = jpo.optimize_pose(jx(T0), jx(X), jx(uv), jx(ur), jx(inv_s2), jx(valid), jc)
    t = tpo.optimize_pose(tt(T0), tt(X), tt(uv), tt(ur), tt(inv_s2), tt(valid), tc)
    assert_same(j.pose, t.pose, rtol=0, atol=1e-4, what="pose")
    assert_same(j.inliers, t.inliers, what="inliers")
    wrong = np.arange(M)[30:50][ur[30:50] >= 0]  # a negative u_right makes a monocular edge
    assert len(wrong) > 10 and not to_np(t.inliers)[wrong].any(), "the stereo row must reject wrong depths"
    np.testing.assert_allclose(to_np(t.pose), T, atol=0.02)


def test_bundle_adjust_all_stereo(cams):
    jc, tc = cams
    rng = np.random.default_rng(9)
    C, P = 5, 200
    poses = np.stack([np.eye(4, dtype=np.float32)] + list(random_poses(rng, C - 1, rot=0.05, trans=0.3)))
    X = rng.uniform([-2, -1.5, 4], [2, 1.5, 9], (P, 3)).astype(np.float32)
    cam_i, pt_i = np.nonzero(rng.random((C, P)) < 0.7)
    Xc = np.einsum("eij,ej->ei", poses[cam_i][:, :3, :3], X[pt_i]) + poses[cam_i][:, :3, 3]
    uv = (Xc[:, :2] / Xc[:, 2:] * 260.0 + [W / 2, H / 2] + rng.normal(0, 0.5, (len(cam_i), 2))).astype(np.float32)
    ur = (uv[:, 0] - 52.0 / Xc[:, 2] + rng.normal(0, 0.5, len(cam_i))).astype(np.float32)
    uv[:12] += 25.0
    ur[::9] = -1.0
    E = len(cam_i)
    pad = lambda a, v: np.concatenate([a, np.full((23,) + a.shape[1:], v, a.dtype)])  # noqa: E731
    fixed = np.zeros(C, bool)
    fixed[0] = True
    noisy = np.stack([poses[0]] + [(random_poses(rng, 1, rot=0.005, trans=0.02)[0] @ T).astype(np.float32)
                                   for T in poses[1:]])
    prob = dict(
        cam_pose=noisy, cam_fixed=fixed, xyz=(X + rng.normal(0, 0.05, X.shape)).astype(np.float32),
        pt_valid=np.ones(P, bool), obs_cam=pad(cam_i.astype(np.int32), -1), obs_pt=pad(pt_i.astype(np.int32), -1),
        obs_uv=pad(uv, 0.0), obs_ur=pad(ur, -1.0),
        obs_inv_sigma2=pad((1.0 / 1.2 ** (2 * rng.integers(0, 3, E))).astype(np.float32), 0.0),
        obs_valid=pad(np.ones(E, bool), False),
    )
    j = jba.bundle_adjust(jba.BAProblem(**{k: jx(v) for k, v in prob.items()}), jc, lm_iters=8, cg_iters=15)
    tp = tba.BAProblem(**{k: tt(v) for k, v in prob.items()})
    t = tba.bundle_adjust(tp, tc, lm_iters=8, cg_iters=15)
    assert_same(j.cam_pose, t.cam_pose, rtol=0, atol=1e-3, what="cam_pose")
    assert_same(j.xyz, t.xyz, rtol=0, atol=1e-3, what="xyz")
    assert_same(j.obs_inlier, t.obs_inlier, what="obs_inlier")
    np.testing.assert_allclose(float(j.final_error), float(t.final_error), rtol=1e-3)
    assert float(t.final_error) < float(tba.bundle_adjust(tp, tc, lm_iters=0).final_error)


def test_port_renders_depth_and_stereo_like_reference(cams):
    """The port's torch renderer against the reference's OpenCV one: gray
    levels agree as for the monocular render (a level or two), depth within
    1e-4 m where both see a surface, the right view is the left camera
    moved +baseline along its x axis."""
    jc, tc = cams
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    js = jsyn.PlanarScene.default(rng_j, depth=5.0, second_depth=8.0, extent=12.0, tex_size=768)
    ts = tsyn.PlanarScene.default(rng_t, depth=5.0, second_depth=8.0, extent=12.0, tex_size=768)
    T = jsyn.orbit_trajectory(20, radius=0.5)[7]
    K = np.asarray(jc.K)
    jimg, jdepth = js.render_with_depth(K, T, W, H)
    timg, tdepth = ts.render_with_depth(K, T, W, H)
    assert tdepth.dtype == torch.float32 and tuple(tdepth.shape) == (H, W)
    both = (jdepth > 0) & (tdepth.numpy() > 0)
    assert both.mean() > 0.95 and ((jdepth > 0) == (tdepth.numpy() > 0)).mean() > 0.999
    np.testing.assert_allclose(tdepth.numpy()[both], jdepth[both], atol=1e-4)
    assert np.abs(timg.numpy().astype(int) - jimg.astype(int)).mean() < 1.0
    jl, jr = js.render_stereo(K, T, STEREO_BASELINE, W, H)
    tl, tr = ts.render_stereo(K, T, STEREO_BASELINE, W, H)
    assert torch.equal(tl, timg)
    assert np.abs(tr.numpy().astype(int) - jr.astype(int)).mean() < 1.0
    assert not torch.equal(tl, tr)
