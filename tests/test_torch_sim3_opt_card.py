"""OptimizeSim3's Jacobian on the card: the kernel
(csrc/sim3_opt_jacobian.cu through ops/sim3_opt_kernel.py) against its
plain version (`jacobian_plain`, the float64 chain through
`torch.func.jvp`, run by torch on the card) on the same inputs, and the
solver through it captured against eager.

Each case is marked `cuda` and skips without a card. Inputs:
`synthetic_pairs`' 64 pairs of an estimate of unit scale and one of scale
1.7 at rotation angles 0, 1e-3, 0.3 and 2.0, each with points at depth 0
(the clamp to 1e-6) or behind either camera and zero rows at their head,
its 2,000 pairs at full width, 33 pairs (a last warp of one pair) and 33
pairs whose first warp mixes rows with a NaN, an infinite and a 1e30
coordinate among the special ones. Gates, the same as chip_smoke.py's: J
within 2^-22 of the row's largest entry (a row: J[i], one projection's 2x7
derivative), NaN where the plain version has NaN, two launches
bit-equal; one device launch a call (torch.profiler); a failed launch
raises and counts nothing; M = 0 launches nothing. The solver:
`optimize_sim3` at full width captured as a program and replayed twice,
torch.equal to eager, the kernel's 15 launches counted inside each replay;
its outcome through the kernel as through the plain Jacobian.

This file imports no JAX:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_sim3_opt_card.py
"""

import pytest
import torch

import chip_smoke
from orb_slam_cuda_tpu_torch.engine import programs
from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel as sk
from orb_slam_cuda_tpu_torch.solvers import sim3_opt

torch.set_num_threads(2)
SCALES = {"unit_scale": 1.0, "scaled": 1.7}
CASES = [f"{name},angle={a:g}" for name in SCALES for a in sk.CASE_ANGLES]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the OptimizeSim3 Jacobian kernel and CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _args(case, dev):
    if case == "full_width":
        return chip_smoke.sim3_opt_full_width_args(dev)
    name, angle = case.split(",angle=")
    return sk.synthetic_pairs(CASES.index(case), 64, float(angle), SCALES[name], dev)


def _mixed(dev):
    """33 pairs whose first warp of 32 mixes every kind of row: the special
    rows (depth clamped, behind either camera, zeros), a NaN, a +inf and a
    -inf coordinate and a point at 1e30."""
    S, x1c, x2c, cam = sk.synthetic_pairs(11, 33, 2.0, 1.7, dev)
    x2c[7, 1] = float("nan")
    x1c[9, 0] = float("inf")
    x1c[10, 2] = -float("inf")
    x2c[11] = 1e30
    return S, x1c, x2c, cam


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["full_width", "nan_row", "ragged", "mixed"])
def test_kernel_equals_plain(case):
    dev = _card()
    if case == "ragged":  # 33 pairs: the second warp of each (family, direction) holds one
        args = sk.synthetic_pairs(33, 33, 0.3, 1.2, dev)
    elif case == "mixed":
        args = _mixed(dev)
    else:
        args = _args(CASES[3] if case == "nan_row" else case, dev)
    if case == "nan_row":
        args[2][7, 1] = float("nan")
    launches = sk.launches
    J, again = sk.launch(*args), sk.launch(*args)
    want = sk.jacobian_plain(*args)
    torch.cuda.synchronize()
    assert sk.launches == launches + 2
    assert J.shape == (2 * args[1].shape[0], 2, 7) and torch.equal(J.view(torch.int32), again.view(torch.int32))
    report = chip_smoke.sim3_opt_against_plain(J, want)
    assert all(report["gates"].values()), report
    assert bool(torch.isnan(J).any()) == (case in ("nan_row", "mixed"))


@pytest.mark.cuda
def test_no_pairs_launch_nothing():
    dev = _card()
    S, x1c, x2c, cam = _args("full_width", dev)
    launches = sk.launches
    J = sk.launch(S, x1c[:0], x2c[:0], cam)
    assert J.shape == (0, 2, 7) and sk.launches == launches


@pytest.mark.cuda
def test_kernel_is_one_device_launch():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = _card()
    args = _args("full_width", dev)
    sk.launch(*args)  # builds and loads the kernel outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device=dev)
        sk.launch(*args)
        torch.ones(1, device=dev)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    names = [e.name for e in events]
    assert len(names) == 3 and "FillFunctor" in names[0] and "FillFunctor" in names[2], names
    assert "sim3_opt_jacobian_kernel" in names[1], names


@pytest.mark.cuda
def test_failed_launch_raises(monkeypatch):
    dev = _card()
    args = _args(CASES[0], dev)
    lib = sk._load()
    # The C entry refuses a null pointer with cudaErrorInvalidValue, launching nothing.
    assert lib.sim3_opt_jacobian(0, 0, 0, 0, 0, 1, 1.0, 1.0, 0, 0) != 0

    class Failing:
        @staticmethod
        def sim3_opt_jacobian(*a):
            return 700

    monkeypatch.setattr(sk, "_lib", Failing())
    launches = sk.launches
    with pytest.raises(RuntimeError, match="cudaError 700"):
        sk.launch(*args)
    assert sk.launches == launches


def _full_width_problem(dev):
    """optimize_sim3's arguments at full width: the kernel's full-width
    pairs whose x1c = S x2c (the pairs it moved, and its special rows, not
    valid), each point observed where it projects in its own keyframe, every
    tenth of them 12 px off in keyframe 1 (outliers); the estimate S moved by
    a small tangent, as a RANSAC estimate is off."""
    from orb_slam_cuda_tpu_torch.geometry import sim3

    S, x1c, x2c, cam = _args("full_width", dev)
    rows = torch.arange(x1c.shape[0], device=dev)
    valid = (rows >= sk.SPECIAL_ROWS) & (torch.linalg.norm(x1c - sim3.transform(S, x2c), dim=-1) < 1e-3)

    def proj(y):
        z = torch.clamp(y[:, 2], min=sk.DEPTH_MIN)
        return torch.stack([cam.fx * y[:, 0] / z + cam.cx, cam.fy * y[:, 1] / z + cam.cy], -1)

    uv1 = proj(x1c)
    uv1[:, 0] += torch.where(rows % 10 == 0, 12.0, 0.0)
    xi = torch.tensor([0.005, -0.003, 0.004, 0.001, -0.0012, 0.0008, 0.002], device=dev)
    S0 = tuple(a.contiguous() for a in sim3.retract(S, xi))
    isig = torch.ones(x1c.shape[0], device=dev)
    return (S0, x1c, x2c, uv1, proj(x2c), isig, isig, valid, cam)


@pytest.mark.cuda
def test_graphed_optimize_sim3_equals_eager():
    dev = _card()
    args = _full_width_problem(dev)
    program = programs.Program(sim3_opt.optimize_sim3, "test")
    with programs.eager():
        launches = sk.launches
        ref = sim3_opt.optimize_sim3(*args)
        assert sk.launches - launches == chip_smoke.SIM3_OPT_LM_ITERS
    outs = []
    for i in range(3):
        launches = sk.launches
        outs.append(program(*args))
        if i:
            assert sk.launches - launches == chip_smoke.SIM3_OPT_LM_ITERS  # counted inside the replay
    torch.cuda.synchronize()
    assert program.stats()["captures"] == 1 and program.stats()["replays"] == 2
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert int(ref.n_inliers) > 0.8 * int(args[7].sum()) and bool(torch.isfinite(ref.t).all())


@pytest.mark.cuda
def test_optimize_sim3_through_kernel_as_through_plain(monkeypatch):
    dev = _card()
    args = _full_width_problem(dev)
    got = sim3_opt.optimize_sim3(*args)
    monkeypatch.setattr(sk, "jacobian", sk.jacobian_plain)
    want = sim3_opt.optimize_sim3(*args)
    assert torch.equal(got.inliers, want.inliers) and int(got.n_inliers) == int(want.n_inliers)
    for a, b in ((got.R, want.R), (got.t, want.t), (got.s, want.s)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
