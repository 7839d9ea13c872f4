"""Parity of the port's front end (image ops, FAST, extractor) with the JAX
package. Tolerances: FAST scores, NMS and the cell select exact; pyramid
and blur rtol 1e-5; extractor at 640x480 exact keypoints and octaves at
level 0, angles within 1e-3 degrees, descriptor bits exact or traced to a
bf16 rounding tie (< 1e-4 of all bits), >= 95% identical rows overall.
The CUDA kernel itself is tested in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.frontend import extractor as jex
from orb_slam_cuda_tpu.frontend import fast as jfast
from orb_slam_cuda_tpu.frontend import image_ops as jimg
from orb_slam_cuda_tpu.utils import synthetic as jsyn
from orb_slam_cuda_tpu_torch.frontend import extractor as tex
from orb_slam_cuda_tpu_torch.frontend import fast as tfast
from orb_slam_cuda_tpu_torch.frontend import image_ops as timg
from orb_slam_cuda_tpu_torch.ops import fast_kernel
from orb_slam_cuda_tpu_torch.utils import convert
from torch_parity import assert_same, jx, to_np, tt

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def textures():
    rng = np.random.default_rng(0)
    return {
        "small": jsyn.make_texture(64, 128, rng, n_blobs=40).astype(np.float32),
        "qvga": jsyn.make_texture(240, 320, rng, n_blobs=200).astype(np.float32),
    }


@pytest.mark.parametrize("name", ["small", "qvga"])
@pytest.mark.parametrize("th", [20.0, 7.0])
def test_fast_score_exact(textures, name, th):
    img = textures[name]
    assert_same(jfast.fast_score(jx(img), th), tfast.fast_score(tt(img), th), what="fast_score")


def test_fast_score_matches_pallas_interpret(textures):
    """The plain version against the TPU kernel itself, run in interpret
    mode as the reference's own test runs it."""
    from orb_slam_cuda_tpu.ops.pallas_fast import fast_score_pallas

    img = textures["small"]
    hi, lo = fast_score_pallas(jnp.asarray(img), 20.0, 7.0, interpret=True)
    thi, tlo = fast_kernel.fast_score_pair(tt(img), 20.0, 7.0)
    assert_same(hi, thi, what="hi")
    assert_same(lo, tlo, what="lo")


def test_nms_and_cell_select_exact(textures):
    img = textures["qvga"]
    hi = np.asarray(jfast.fast_score(jx(img), 20.0))
    lo = np.asarray(jfast.fast_score(jx(img), 7.0))
    assert_same(jfast.nms3x3(jx(hi)), tfast.nms3x3(tt(hi)), what="nms3x3")
    for cell in (32, 30):
        assert_same(jfast.two_threshold_cell_select(jx(hi), jx(lo), cell),
                    tfast.two_threshold_cell_select(tt(hi), tt(lo), cell), what="cell select")


def test_pyramid_and_blur(textures):
    img = textures["qvga"]
    assert timg.pyramid_shapes(240, 320, 8, 1.2) == jimg.pyramid_shapes(240, 320, 8, 1.2)
    for a, b in zip(jimg.build_pyramid(jx(img), 8, 1.2), timg.build_pyramid(tt(img), 8, 1.2)):
        assert_same(a, b, rtol=1e-5, atol=1e-4, what="pyramid level")
    assert_same(jimg.separable_gaussian(jx(img)), timg.separable_gaussian(tt(img)),
                rtol=1e-5, atol=1e-4, what="blur")
    np.testing.assert_array_equal(jimg.gaussian_kernel_1d(7, 2.0), timg.gaussian_kernel_1d(7, 2.0))


def test_spatial_topk_ties():
    """Integer scores tie constantly; the selection must keep the lower
    index first, as lax.top_k does."""
    rng = np.random.default_rng(5)
    score = rng.integers(0, 4, (120, 160)).astype(np.float32) * 10.0
    for quota in (50, 200):
        j = jex._select_spatial_topk(jx(score), quota, 19)
        t = tex._select_spatial_topk(tt(score), quota, 19)
        for a, b, what in zip(j, t, ("ys", "xs", "scores", "ok")):
            assert_same(a, b, what=what)


@pytest.fixture(scope="module")
def extracted():
    rng = np.random.default_rng(7)
    img = jsyn.make_texture(480, 640, rng)
    jcfg = jex.ExtractorConfig(n_features=1000)
    tcfg = tex.ExtractorConfig(n_features=1000)
    assert tuple(tcfg.features_per_level()) == tuple(jcfg.features_per_level())
    j = jex.ORBExtractor(jcfg, 480, 640)(img)
    t = tex.ORBExtractor(tcfg, 480, 640)(img)
    return img, j, t


def test_extractor_level0_exact(extracted):
    _, j, t = extracted
    oct_j = to_np(j.octave)
    assert_same(j.octave, t.octave, what="octave")
    assert_same(j.valid, t.valid, what="valid")
    lvl0 = oct_j == 0
    np.testing.assert_array_equal(to_np(j.uv)[lvl0], to_np(t.uv)[lvl0])
    np.testing.assert_array_equal(to_np(j.response)[lvl0], to_np(t.response)[lvl0])
    for f, a in zip(tex.Features._fields, convert.features(j)):
        assert_same(getattr(j, f), a, what=f"convert.features {f}")


def test_extractor_angles_and_descriptors(extracted):
    img, j, t = extracted
    valid = to_np(j.valid)
    ang_j, ang_t = to_np(j.angle), to_np(t.angle)
    d = np.abs(ang_j - ang_t)[valid]
    d = np.minimum(d, 360.0 - d)
    assert d.max() < 1e-3, d.max()

    dj, dt = to_np(j.desc), to_np(t.desc)
    rows_same = (dj == dt).all(1)[valid]
    share = rows_same.mean()
    print(f"identical descriptor rows over all levels: {share:.4f}")
    assert share >= 0.95
    lvl0 = (to_np(j.octave) == 0) & valid
    diff_bits = np.unpackbits((dj ^ dt)[lvl0].view(np.uint8)).sum()
    assert diff_bits <= 1e-4 * lvl0.sum() * 256, diff_bits
    if diff_bits:
        _assert_bf16_ties(img, t, lvl0 & ~(dj == dt).all(1))


def _assert_bf16_ties(img, t, rows):
    """Every differing level-0 bit compares two samples that are within one
    bf16 step of each other (a rounding tie, not a sampling error)."""
    blurred = timg.separable_gaussian(torch.as_tensor(img, dtype=torch.float32))
    xs = t.uv[:, 0].round().long()
    ys = t.uv[:, 1].round().long()
    idx = torch.as_tensor(np.flatnonzero(rows))
    patches = tex._extract_patches(blurred, ys[idx], xs[idx]).reshape(len(idx), -1)
    rot = torch.as_tensor(tex.build_rotation_index(tex.load_brief_pattern(), 30))
    bins = torch.remainder(torch.round(t.angle[idx] / 12.0).long(), 30)
    s = torch.gather(patches, 1, rot[bins])
    a, b = s[:, :256], s[:, 256:]
    close = (a - b).abs() <= torch.maximum(a.abs(), b.abs()) * 2.0**-7
    flipped = (a < b) != (a.to(torch.bfloat16) < b.to(torch.bfloat16))
    assert bool((close | ~flipped).all())
