"""Parity of the port's vocabulary (numpy trainer and tree descent) and
build_frame with the JAX package. Tolerances: trained trees, word ids,
levelsup node ids and idf weights exact; undistorted coordinates rtol
1e-5; every other FrameData field exact."""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine import frame as jframe
from orb_slam_cuda_tpu.engine.system import System as JSystem
from orb_slam_cuda_tpu.engine.system import SystemConfig as JConfig
from orb_slam_cuda_tpu.frontend import extractor as jex
from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu.vocab import vocabulary as jvoc
from orb_slam_cuda_tpu_torch.engine import frame as tframe
from orb_slam_cuda_tpu_torch.engine.system import synthetic_vocabulary
from orb_slam_cuda_tpu_torch.utils import convert
from orb_slam_cuda_tpu_torch.vocab import vocabulary as tvoc
from torch_parity import assert_same, jx, to_np, tt

torch.set_num_threads(2)


def _assert_same_tree(jv, tv):
    assert (jv.k, jv.depth, jv.levelsup_depth) == (tv.k, tv.depth, tv.levelsup_depth)
    for name in ("children_packed", "children_valid", "child_base", "node_word"):
        for a, b in zip(getattr(jv, name), getattr(tv, name)):
            np.testing.assert_array_equal(to_np(a), to_np(b).astype(to_np(a).dtype), err_msg=name)
    assert_same(jv.word_weight, tv.word_weight, what="word_weight")


@pytest.fixture(scope="module")
def system_vocabs():
    """The System's default synthetic vocabulary, trained by both."""
    cam = jcam.Camera.create(fx=100.0, fy=100.0, cx=32.0, cy=32.0, width=64, height=64)
    jv = JSystem(JConfig(camera=cam, enable_loop_closing=False)).vocab
    return jv, synthetic_vocabulary(512, 0)


def test_trainer_builds_the_same_tree(system_vocabs):
    _assert_same_tree(*system_vocabs)


def test_trainer_on_small_clusters():
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 2**32, size=(300, 8), dtype=np.uint32)
    for k, depth in ((3, 3), (5, 2)):
        _assert_same_tree(jvoc.build_vocabulary(desc, k=k, depth=depth, seed=1),
                          tvoc.build_vocabulary(desc, k=k, depth=depth, seed=1))


@pytest.fixture(scope="module")
def descriptors():
    rng = np.random.default_rng(9)
    img = jsyn.make_texture(240, 320, rng, n_blobs=200)
    feats = jex.ORBExtractor(jex.ExtractorConfig(n_features=500), 240, 320)(img)
    rand = rng.integers(0, 2**32, size=(300, 8), dtype=np.uint32)
    return np.concatenate([np.asarray(feats.desc), rand]), feats


def _assert_transform(jv, tv, desc):
    for a, b, what in zip(jv.transform(jx(desc)), tv.transform(tt(desc)), ("word", "node", "idf")):
        assert_same(a, b, what=what)


def test_transform_exact(system_vocabs, descriptors):
    jv, tv = system_vocabs
    desc, _ = descriptors
    _assert_transform(jv, tv, desc)
    _assert_transform(jv, convert.vocabulary(jv), desc)


def test_transform_with_early_leaves(descriptors):
    """A DBoW2-style tree with leaves above the bottom level: words
    resolve where the path ends and early paths get negative node ids."""
    desc, _ = descriptors
    rng = np.random.default_rng(11)
    parents, is_leaf, depth_of = [], [], {0: 0}
    frontier = [0]
    nid = 1
    while frontier:
        p = frontier.pop(0)
        for _ in range(rng.integers(1, 4)):
            d = depth_of[p] + 1
            leaf = d == 3 or rng.random() < 0.3
            parents.append(p)
            is_leaf.append(leaf)
            depth_of[nid] = d
            if not leaf:
                frontier.append(nid)
            nid += 1
    n = len(parents)
    desc_bytes = rng.integers(0, 256, size=(n, 32)).astype(np.uint8)
    weights = rng.uniform(0.1, 3.0, n)
    jv = jvoc._assemble_from_flat(np.asarray(parents), np.asarray(is_leaf), desc_bytes,
                                  weights, 3, 3, 2)
    _assert_transform(jv, convert.vocabulary(jv), desc)


def test_build_frame(system_vocabs, descriptors):
    jv, _ = system_vocabs
    _, jfeats = descriptors
    cam_args = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, k1=0.1, k2=-0.05, width=320, height=240)
    jf = jframe.build_frame(jfeats, jcam.Camera.create(**cam_args), jv)
    tf = tframe.build_frame(convert.features(jfeats), convert.camera(jcam.Camera.create(**cam_args)),
                            convert.vocabulary(jv))
    for name in jframe.FrameData._fields:
        exact = name != "uv"
        assert_same(getattr(jf, name), getattr(tf, name), rtol=None if exact else 1e-5,
                    atol=0.0 if exact else 1e-3, what=name)
