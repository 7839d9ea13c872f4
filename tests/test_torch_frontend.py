"""Parity of the port's front end (image ops, FAST, extractor) with the JAX
package. Tolerances: FAST scores, NMS, the cell select and the fused
corner map (`fast_corners_plain`) exact; pyramid
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


def _jax_corner_map(img, th_hi, th_lo, cell, border):
    """The reference's composition: the Pallas kernel in interpret mode,
    NMS of each map, the cell choice, then the border mask that heads
    its _select_spatial_topk."""
    from orb_slam_cuda_tpu.ops.pallas_fast import fast_score_pallas

    hi, lo = fast_score_pallas(jnp.asarray(img), th_hi, th_lo, interpret=True)
    score = jfast.two_threshold_cell_select(jfast.nms3x3(hi), jfast.nms3x3(lo), cell)
    h, w = img.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    return jnp.where(inb, score, 0.0)


@pytest.fixture(scope="module")
def ragged():
    """75x121: neither side a multiple of the cell, so the last row and
    column of cells are ragged."""
    rng = np.random.default_rng(3)
    return jsyn.make_texture(75, 121, rng, n_blobs=60).astype(np.float32)


@pytest.mark.parametrize("cell,border", [(32, 19), (32, 0), (30, 19), (16, 5)])
def test_fast_corners_plain_matches_reference_composition(ragged, cell, border):
    want = _jax_corner_map(ragged, 20.0, 7.0, cell, border)
    got = tfast.fast_corners_plain(tt(ragged), 20.0, 7.0, cell, border)
    assert int((to_np(got) > 0).sum()) > 0
    assert_same(want, got, what=f"corner map cell {cell} border {border}")


def test_fast_corners_pyramid_on_cpu_is_plain_per_level(textures):
    levels = timg.build_pyramid(tt(textures["qvga"]), 4, 1.2)
    before = fast_kernel.launches
    maps = fast_kernel.fast_corners_pyramid(levels, 20.0, 7.0, 32, 19)
    assert fast_kernel.launches == before
    assert len(maps) == len(levels)
    for lv, m in zip(levels, maps):
        assert_same(_jax_corner_map(to_np(lv), 20.0, 7.0, 32, 19), m, what="pyramid level map")


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


def test_brief_pattern_is_the_ports_own_copy(monkeypatch):
    """The port reads its own copy of the rBRIEF pattern, byte for byte the
    reference's, and opens no file of the reference package."""
    import builtins
    import os

    ref_dir = os.path.dirname(os.path.abspath(jex.__file__))
    port_dir = os.path.dirname(os.path.abspath(tex.__file__))
    name = "brief_pattern_31.npy"
    with open(os.path.join(ref_dir, name), "rb") as f, open(os.path.join(port_dir, name), "rb") as g:
        assert f.read() == g.read()
    opened = []
    real_open = builtins.open

    def spy(file, *a, **kw):
        opened.append(os.path.abspath(file) if isinstance(file, (str, os.PathLike)) else file)
        return real_open(file, *a, **kw)

    monkeypatch.setattr(builtins, "open", spy)
    tex.ORBExtractor(tex.ExtractorConfig(n_features=100), 120, 160, device="cpu")
    assert os.path.join(port_dir, name) in opened
    ref_pkg = os.path.dirname(ref_dir) + os.sep
    assert not [p for p in opened if isinstance(p, str) and p.startswith(ref_pkg)]
    np.testing.assert_array_equal(tex.load_brief_pattern(), np.load(os.path.join(ref_dir, name)))


@pytest.fixture(scope="module")
def extracted():
    rng = np.random.default_rng(7)
    img = jsyn.make_texture(480, 640, rng)
    jcfg = jex.ExtractorConfig(n_features=1000)
    tcfg = tex.ExtractorConfig(n_features=1000)
    assert tuple(tcfg.features_per_level()) == tuple(jcfg.features_per_level())
    j = jex.ORBExtractor(jcfg, 480, 640)(img)
    t = tex.ORBExtractor(tcfg, 480, 640, device="cpu")(img)
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


@pytest.fixture(scope="module")
def continuous():
    rng = np.random.default_rng(7)
    img = jsyn.make_texture(480, 640, rng)
    j = jex.ORBExtractor(jex.ExtractorConfig(n_features=1000, rotation_bins=0), 480, 640)(img)
    t = tex.ORBExtractor(tex.ExtractorConfig(n_features=1000, rotation_bins=0), 480, 640, device="cpu")(img)
    return img, j, t


def test_rbrief_continuous_exact(continuous):
    """Per level, on the reference's blurred level, keypoints and angles."""
    img, j, _ = continuous
    pattern = tex.load_brief_pattern()
    levels = jimg.build_pyramid(jx(np.asarray(img, np.float32)), 8, 1.2)
    octave, uv, angle = to_np(j.octave), to_np(j.uv), to_np(j.angle)
    for lvl, level in enumerate(levels):
        sel = np.flatnonzero(octave == lvl)
        xs = np.rint(uv[sel, 0] / 1.2**lvl).astype(np.int32)
        ys = np.rint(uv[sel, 1] / 1.2**lvl).astype(np.int32)
        blurred = jimg.separable_gaussian(level, 7, 2.0)
        dj = jex._rbrief(blurred, jx(ys), jx(xs), jx(angle[sel]), jx(pattern.astype(np.int32)))
        dt = tex._rbrief(tt(np.asarray(blurred)), tt(ys).long(), tt(xs).long(), tt(angle[sel]),
                         tt(pattern.astype(np.int32)))
        assert_same(dj, dt, what=f"rBRIEF bits, level {lvl}")
        aj = jex._ic_angle(level, jx(ys), jx(xs))
        at = tex._ic_angle(tt(np.asarray(level)), tt(ys).long(), tt(xs).long(), tt(tex._IC_OFFSETS).long())
        d = np.abs(to_np(aj) - to_np(at))
        assert np.minimum(d, 360.0 - d).max() < 1e-3, f"IC angle, level {lvl}"


def _explained_flips(img, j, t, rows):
    """(keypoint, pair, offsets, samples, explained) of every differing
    bit. Explained: a sample offset of the pair lies within 1e-3 px of a
    rounding tie at either package's angle, or the two samples compared
    (on the port's blurred level) are within 1e-5 relative of each other,
    so that the blur's float32 rounding decides the bit."""
    pattern = tex.load_brief_pattern().astype(np.float64)
    dj, dt = to_np(j.desc), to_np(t.desc)
    levels = timg.build_pyramid(torch.as_tensor(np.asarray(img, np.float32)), 8, 1.2)
    out = []
    for k in rows:
        lvl = int(to_np(t.octave)[k])
        blurred = timg.separable_gaussian(levels[lvl], 7, 2.0).numpy()
        x, y = np.rint(to_np(t.uv)[k] / 1.2**lvl).astype(int)
        bits = np.unpackbits((dj[k] ^ dt[k]).view(np.uint8), bitorder="little")
        for p in np.flatnonzero(bits):
            offs, samples = [], []
            for side, ang in enumerate((float(to_np(j.angle)[k]), float(to_np(t.angle)[k]))):
                a, b = np.cos(np.radians(ang)), np.sin(np.radians(ang))
                for px, py in (pattern[p, :2], pattern[p, 2:]):
                    r, c = px * b + py * a, px * a - py * b
                    offs += [r, c]
                    if side:
                        samples.append(float(blurred[y + int(np.rint(r)), x + int(np.rint(c))]))
            tie = any(abs(abs(o - np.floor(o)) - 0.5) < 1e-3 for o in offs)
            close = abs(samples[0] - samples[1]) <= 1e-5 * max(abs(samples[0]), abs(samples[1]))
            out.append((int(k), int(p), np.round(offs, 5).tolist(), samples, tie or close))
    return out


def test_extractor_continuous_rotation(continuous):
    img, j, t = continuous
    for f in ("octave", "valid", "uv"):
        assert_same(getattr(j, f), getattr(t, f), what=f)
    lvl0 = to_np(j.octave) == 0
    np.testing.assert_array_equal(to_np(j.response)[lvl0], to_np(t.response)[lvl0])
    assert_same(j.response, t.response, rtol=1e-5, what="response")  # resized levels: float32 rounding
    valid = to_np(j.valid)
    d = np.abs(to_np(j.angle) - to_np(t.angle))[valid]
    assert np.minimum(d, 360.0 - d).max() < 1e-3
    dj, dt = to_np(j.desc), to_np(t.desc)
    rows = np.flatnonzero(valid & ~(dj == dt).all(1))
    flips = _explained_flips(img, j, t, rows)
    print(f"continuous rBRIEF: {len(flips)} differing bits of {valid.sum() * 256}: {flips}")
    assert len(flips) <= 1e-4 * valid.sum() * 256
    unexplained = [f[:4] for f in flips if not f[4]]
    assert not unexplained, f"bits that differ away from a tie (keypoint, pair, offsets, samples): {unexplained}"


def test_descriptors_to_bytes_exact():
    """The port's int32 words give the reference's bytes of the same
    uint32 bits, the top bit set included."""
    rng = np.random.default_rng(11)
    words = rng.integers(0, 2**32, (64, 8), dtype=np.uint64).astype(np.uint32)
    words[0] = 0xFFFFFFFF
    words[1] = 0x80000000
    words[2, ::2] = 0x80FF7F01
    assert (words.view(np.int32) < 0).sum() > 64
    want = jex.descriptors_to_bytes(jnp.asarray(words))
    for given in (torch.as_tensor(words.view(np.int32)), words.view(np.int32), words):
        got = tex.descriptors_to_bytes(given)
        assert got.dtype == np.uint8 and got.shape == (64, 32)
        np.testing.assert_array_equal(got, want)
