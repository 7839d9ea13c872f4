"""The hand-written FAST kernel's wrappers (ops/fast_kernel.py) and the
device rule of the port's entry points. On the CPU the wrappers take the
plain versions and launch nothing; on the card (marked `cuda`) both entry
points of the kernel equal their plain versions bit for bit at every
KITTI pyramid shape, and the 8 levels of a frame cost one launch. The
entry points run on the card unless the caller passes `device="cpu"`.
This file imports no JAX, so it also runs on a machine that has only the
port's dependencies:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu_torch.engine import System, SystemConfig
from orb_slam_cuda_tpu_torch.engine.local_mapping import LocalMapper
from orb_slam_cuda_tpu_torch.frontend import fast, image_ops
from orb_slam_cuda_tpu_torch.frontend.extractor import ExtractorConfig, ORBExtractor
from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.ops import fast_kernel
from orb_slam_cuda_tpu_torch.slam_map import MapConfig
from orb_slam_cuda_tpu_torch.utils import synthetic

torch.set_num_threads(2)
KITTI = (376, 1241)


@pytest.fixture(scope="module")
def texture():
    return synthetic.make_texture(*KITTI, np.random.default_rng(0)).astype(np.float32)


def test_wrapper_takes_plain_version_on_cpu(texture):
    img = torch.as_tensor(texture[:64, :128])
    before = fast_kernel.launches
    hi, lo = fast_kernel.fast_score_pair(img, 20.0, 7.0)
    assert fast_kernel.launches == before
    assert torch.equal(hi, fast.fast_score(img, 20.0))
    assert torch.equal(lo, fast.fast_score(img, 7.0))
    with pytest.raises(ValueError):
        fast_kernel.fast_score_pair(torch.empty((8, 8), device="meta"), 20.0, 7.0)


def test_pyramid_wrapper_takes_plain_version_on_cpu(texture):
    levels = [lv.contiguous() for lv in image_ops.build_pyramid(torch.as_tensor(texture[:150, :250]), 3, 1.2)]
    before = fast_kernel.launches
    maps = fast_kernel.fast_corners_pyramid(levels, 20.0, 7.0, 32, 19)
    assert fast_kernel.launches == before
    for lv, m in zip(levels, maps):
        assert m.shape == lv.shape and int((m > 0).sum()) > 0
        assert torch.equal(m, fast.fast_corners_plain(lv, 20.0, 7.0, 32, 19))
    # Caller-owned outputs are filled and handed back.
    out = fast_kernel.pyramid_buffers([tuple(lv.shape) for lv in levels], "cpu")
    got = fast_kernel.fast_corners_pyramid(levels, 20.0, 7.0, out=out)
    assert all(g is o and torch.equal(g, m) for g, o, m in zip(got, out, maps))
    # A cell size other than the kernel's tile is served by the plain version.
    for lv, m in zip(levels, fast_kernel.fast_corners_pyramid(levels, 20.0, 7.0, 24, 5)):
        assert torch.equal(m, fast.fast_corners_plain(lv, 20.0, 7.0, 24, 5))


@pytest.mark.parametrize("bad", ["empty", "dtype", "strided", "out_shape", "out_count", "negative", "meta"])
def test_pyramid_wrapper_refuses(bad):
    img = torch.zeros((40, 50))
    args, kw = ([img], 20.0, 7.0), {}
    if bad == "empty":
        args = ([], 20.0, 7.0)
    elif bad == "dtype":
        args = ([img.double()], 20.0, 7.0)
    elif bad == "strided":
        args = ([torch.zeros((50, 40)).t()], 20.0, 7.0)
    elif bad == "out_shape":
        kw = dict(out=[torch.zeros((40, 51))])
    elif bad == "out_count":
        kw = dict(out=[torch.zeros((40, 50)), torch.zeros((40, 50))])
    elif bad == "negative":
        args = ([img], 20.0, -1.0)
    elif bad == "meta":
        args = ([img, torch.zeros((40, 50), device="meta")], 20.0, 7.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_corners_pyramid(*args, **kw)


@pytest.mark.parametrize("kind", ["texture", "noise", "integers"])
def test_quick_test_bound_never_rejects_a_corner(texture, kind):
    """The kernel skips the full score where `score_upper_bound` does not
    pass the lower threshold; that is exact only if the bound is never
    below the score."""
    rng = np.random.default_rng(11)
    img = {"texture": texture[:200, :300],
           "noise": rng.uniform(0, 255, (120, 160)).astype(np.float32),
           "integers": rng.integers(0, 6, (120, 160)).astype(np.float32) * 25.0}[kind]
    img = torch.as_tensor(img)
    ub, score = fast.score_upper_bound(img), fast.corner_score(img)
    assert bool((ub >= score).all())
    assert bool((ub[score > 7.0] > 7.0).all()) and int((score > 7.0).sum()) > 0
    assert bool(fast.quick_test_candidates(img, 7.0)[fast.fast_score(img, 7.0) > 0].all())
    if kind == "texture":
        assert float((ub > 7.0).float().mean()) < 0.5  # and it does reject most pixels


def test_cell_with_high_corner_only_in_border_still_counts():
    """A cell whose only high-threshold corner lies inside the 19-px
    border keeps the high map (its vote is taken before the border is
    zeroed), so a weaker corner of that cell outside the border goes."""
    img = torch.full((64, 96), 100.0)
    img[8:13, 8:13] = 200.0   # strong square: high corners at (8..12, 8..12), in the border
    img[24:28, 24:28] = 112.0  # weak square in the same cell: low-threshold corners only
    hi = fast.nms3x3(fast.fast_score(img, 20.0))
    lo = fast.nms3x3(fast.fast_score(img, 7.0))
    cell0 = (slice(0, 32), slice(0, 32))
    assert int((hi[cell0] > 0).sum()) > 0 and float(hi[19:32, 19:32].max()) == 0.0
    assert int((lo[19:32, 19:32] > 0).sum()) > 0
    out = fast_kernel.fast_corners_pyramid([img], 20.0, 7.0, 32, 19)[0]
    assert torch.equal(out, fast.fast_corners_plain(img, 20.0, 7.0, 32, 19))
    assert float(out[cell0].max()) == 0.0
    # Without the strong square the weak corners of that cell come through.
    img2 = img.clone()
    img2[8:13, 8:13] = 100.0
    assert int((fast.fast_corners_plain(img2, 20.0, 7.0, 32, 19)[cell0] > 0).sum()) > 0


CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240)


def _entry_points():
    cam = Camera.create(**CAM)
    return {
        "System": lambda **kw: System(SystemConfig(camera=cam, n_features=300, max_keyframes=8,
                                                   max_points=1024, enable_loop_closing=False), **kw),
        "ORBExtractor": lambda **kw: ORBExtractor(ExtractorConfig(n_features=300), 240, 320, **kw),
        "LocalMapper": lambda **kw: LocalMapper(MapConfig(max_keyframes=8, max_features=300, max_points=1024),
                                                cam, **kw),
    }


@pytest.mark.parametrize("name", ["System", "ORBExtractor", "LocalMapper"])
def test_entry_point_without_device_raises_without_card(name):
    """No device argument means the card; with no card the constructor
    raises rather than carry on on the CPU. `device="cpu"` is explicit."""
    make = _entry_points()[name]
    assert make(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: test_entry_points_default_to_card covers the default")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


@pytest.mark.cuda
def test_entry_points_default_to_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name, make in _entry_points().items():
        assert make().device.type == "cuda", name


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(texture):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    levels = image_ops.build_pyramid(torch.as_tensor(texture, device="cuda"), 8, 1.2)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    noise = torch.rand(KITTI, generator=g, device="cuda") * 255.0
    for img in [lv.contiguous() for lv in levels] + [noise]:
        before = fast_kernel.launches
        hi, lo = fast_kernel.fast_score_pair(img, 20.0, 7.0)
        torch.cuda.synchronize()
        assert fast_kernel.launches == before + 1
        assert torch.equal(hi, fast.fast_score(img, 20.0)), tuple(img.shape)
        assert torch.equal(lo, fast.fast_score(img, 7.0)), tuple(img.shape)
    with pytest.raises(ValueError):
        fast_kernel.fast_score_pair(noise.double(), 20.0, 7.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_score_pair(noise.t(), 20.0, 7.0)


@pytest.mark.cuda
def test_pyramid_kernel_matches_plain_on_card(texture):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    levels = [lv.contiguous() for lv in image_ops.build_pyramid(torch.as_tensor(texture, device="cuda"), 8, 1.2)]
    assert [tuple(lv.shape) for lv in levels] == image_ops.pyramid_shapes(*KITTI, 8, 1.2)
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    noise = torch.rand(KITTI, generator=g, device="cuda") * 255.0
    before = fast_kernel.launches
    maps = fast_kernel.fast_corners_pyramid(levels, 20.0, 7.0, 32, 19)
    torch.cuda.synchronize()
    assert fast_kernel.launches == before + 1
    for lv, m in zip(levels, maps):
        assert int((m > 0).sum()) > 0
        assert torch.equal(m, fast.fast_corners_plain(lv, 20.0, 7.0, 32, 19)), tuple(lv.shape)
    for border in (19, 0):
        (m,) = fast_kernel.fast_corners_pyramid([noise], 20.0, 7.0, 32, border)
        assert torch.equal(m, fast.fast_corners_plain(noise, 20.0, 7.0, 32, border)), border
    out = fast_kernel.pyramid_buffers([tuple(lv.shape) for lv in levels], "cuda")
    got = fast_kernel.fast_corners_pyramid(levels, 20.0, 7.0, out=out)
    assert all(g_ is o and torch.equal(g_, m) for g_, o, m in zip(got, out, maps))
    with pytest.raises(ValueError):
        fast_kernel.fast_corners_pyramid(levels, 20.0, 7.0, 30, 19)
    with pytest.raises(ValueError):
        fast_kernel.fast_corners_pyramid([levels[0], levels[1].cpu()], 20.0, 7.0)
    with pytest.raises(ValueError):
        fast_kernel.fast_corners_pyramid([noise] * 17, 20.0, 7.0)
