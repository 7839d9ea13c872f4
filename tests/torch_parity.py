"""Parity helpers for the tests that hold orb_slam_cuda_tpu_torch against
orb_slam_cuda_tpu: one numpy input goes to both packages, and the two
outputs come back as numpy for comparison."""

from __future__ import annotations

import dataclasses
import os
import traceback

import jax.numpy as jnp
import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.utils import convert


def to_np(x) -> np.ndarray:
    """JAX array / torch tensor / scalar -> numpy; uint32 words viewed as
    int32 (the port's storage of the same bits), bfloat16 widened."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a


def jx(a):
    return jnp.asarray(a)


def tt(a, dtype=None):
    return convert.tensor(a, "cpu", dtype)


def run_both(jax_fn, torch_fn, *np_args):
    """Feed the same numpy arguments to both functions."""
    return jax_fn(*[jx(a) for a in np_args]), torch_fn(*[tt(a) for a in np_args])


def assert_same(j, t, rtol=None, atol=0.0, what=""):
    """Exact for integer/bool outputs (rtol None), else allclose."""
    a, b = to_np(j), to_np(t)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    if rtol is None:
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=what)


def random_poses(rng, n, rot=0.3, trans=1.0):
    """(n,4,4) float32 world->camera poses near identity."""
    from orb_slam_cuda_tpu_torch.geometry import se3

    xi = np.concatenate([rng.normal(0, trans, (n, 3)), rng.normal(0, rot, (n, 3))], 1)
    return se3.exp(torch.as_tensor(xi.astype(np.float32))).numpy()


def jax_sets(seed: int, valid, n_hyp: int, k: int) -> np.ndarray:
    """The minimal sets the reference draws from PRNGKey(seed): split into
    n_hyp keys, one uniform key per row, invalid rows at -1, the k largest."""
    import jax

    keys = jax.random.split(jax.random.PRNGKey(int(seed)), n_hyp)
    v = jnp.asarray(np.asarray(to_np(valid), bool))
    draw = lambda kk: jnp.argsort(-jnp.where(v, jax.random.uniform(kk, v.shape), -1.0))[:k]  # noqa: E731
    return np.array(jax.vmap(draw)(keys))


def jax_sampler(site: str, seed: int, valid):
    """A port sampler that reproduces the reference's draws at each site."""
    from orb_slam_cuda_tpu_torch.solvers.initializer import SAMPLE_SHAPES

    n, k = SAMPLE_SHAPES[site]
    return torch.as_tensor(jax_sets(seed, valid, n, k), device=valid.device)


# Stereo / RGB-D fixtures shared by the parity tests: the camera and scene
# of tests/test_stereo_rgbd.py (320x240, baseline 0.2 m).
STEREO_W, STEREO_H = 320, 240
STEREO_BASELINE = 0.2
STEREO_CAM = dict(fx=260.0, fy=260.0, cx=STEREO_W / 2, cy=STEREO_H / 2, bf=260.0 * STEREO_BASELINE,
                  width=STEREO_W, height=STEREO_H)
STEREO_CFG = dict(n_features=600, max_keyframes=64, max_points=8192, enable_loop_closing=False,
                  max_frames_between_kf=8, stereo_init_min_features=300, kf_ref_ratio=1.1)


def stereo_scene(seed: int = 0):
    """The two-plane scene of tests/test_stereo_rgbd.py, from the reference
    package's renderer, and the orbit's poses are the caller's."""
    from orb_slam_cuda_tpu.utils import synthetic

    return synthetic.PlanarScene.default(np.random.default_rng(seed), depth=5.0, second_depth=8.0,
                                         extent=12.0, tex_size=768)


def known_disparity_set(rng, n: int = 64):
    """Left/right keypoints with identical descriptors, the right ones
    shifted by the disparity of a known depth (level 0 only)."""
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    uv_l = np.stack([rng.uniform(80, 300, n), rng.uniform(10, 230, n)], -1).astype(np.float32)
    depth = rng.uniform(1.0, 8.0, n).astype(np.float32)
    uv_r = uv_l.copy()
    uv_r[:, 0] -= np.float32(STEREO_CAM["bf"]) / depth
    return desc, uv_l, uv_r, depth


def assert_configs_equal(jcfg, tcfg):
    jf = {f.name for f in dataclasses.fields(jcfg)}
    for f in dataclasses.fields(tcfg):
        assert f.name in jf, f.name
        jv, tv = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "camera":
            for c in Camera._fields:
                assert float(np.asarray(getattr(jv, c))) == float(getattr(tv, c)), c
        elif f.name == "sensor":
            assert jv.name == tv.name
        else:
            assert jv == tv and type(jv) is type(tv), (f.name, jv, tv)
    # Fields the port does not have are options of unported paths.
    assert jf - {f.name for f in dataclasses.fields(tcfg)} <= {"use_pallas_fast"}


# Ops that read a device value back to the host, or copy host data to the
# device (which waits for the stream), when their tensors are on CUDA:
# `lift_fresh` is a tensor made from host data, `torch.as_tensor(list)` or
# the scalar of `x[i] = 1.0`; `eigh` and `svd` always wait for their
# status on the card.
_SYNCING = {"_local_scalar_dense", "is_nonzero", "item", "nonzero", "nonzero_static", "masked_select",
            "_linalg_check_errors", "lift_fresh", "lift_fresh_copy", "unique", "_unique2",
            "repeat_interleave", "bincount", "_assert_async", "_linalg_eigh", "_linalg_svd"}


def _port_line():
    """The innermost line of the port on the stack."""
    frames = [f for f in traceback.extract_stack() if "orb_slam_cuda_tpu_torch" in f.filename]
    return f"{os.path.basename(frames[-1].filename)}:{frames[-1].lineno}: {frames[-1].line}" if frames else "?"


class _SyncSpy(TorchDispatchMode):
    """Records every op dispatched inside it that would read back or copy
    from the host on CUDA (run on the CPU, where nothing is lost by it)."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bool_index = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in (args[1] or ()))
        if name in _SYNCING or bool_index:
            self.hits.append(f"{func} at {_port_line()}")
        return func(*args, **(kwargs or {}))
