"""The hand-written FAST kernel's wrapper (ops/fast_kernel.py). On the CPU
the wrapper takes the plain version and launches nothing; on the card
(marked `cuda`) the kernel equals the plain version bit for bit at every
KITTI pyramid shape. This file imports no JAX, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu_torch.frontend import fast, image_ops
from orb_slam_cuda_tpu_torch.ops import fast_kernel
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
