"""OptimizeSim3's Jacobian (ops/sim3_opt_kernel.py) and the solver through
it on the CPU.

The plain version (`jacobian_plain`: the reprojection chain in float64
through `torch.func.jvp`, rounded once to float32) against `jax.jacfwd` of
the JAX package's `flat_res` (orb_slam_cuda_tpu/solvers/sim3_opt.py:95-101),
rebuilt here from its `_pair_residuals` (:43) and sim3.retract, on the
numpy-seeded pairs of `synthetic_pairs`: an estimate of unit scale and one
of scale 1.7, each at rotation angles 0, 1e-3, 0.3 and 2.0, with points
whose depth is 0 (to within float32 rounding: the clamp to 1e-6, tangent 0)
or negative in either family, zero rows as an invalid pair's, and outliers.
Tolerances: against JAX in float64 (`jax.enable_x64`), the same function,
within one float32 rounding (2^-22 of the row's largest entry, a row being
J[i], the 2x7 derivative of one projection); against JAX in float32, as
the JAX package runs, within 1e-5 of the row's largest entry. No case
needs more.

The kernel's source built by g++ for the host (the same templated
arithmetic, in double) against the plain version: within 2^-22 of the
row's largest entry, and bit-equal in every case here; NaN where the plain
version has NaN; its operation count; the wrapper's refusals. The solver
with the host build in place of the plain Jacobian gives
tests/test_torch_loop_solvers.py::test_optimize_sim3's outcome against JAX,
and the loop closer's `sim3_refine` program through it reads nothing back
(`_SyncSpy`). The kernel runs on the card: tests/test_torch_sim3_opt_card.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop_solvers import JCAM, TCAM, _opt_problem
from torch_parity import _SyncSpy, assert_same, tt
from torch_ring import CAM, CFG, build_drifted_ring

from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.geometry import sim3 as jsim3
from orb_slam_cuda_tpu.solvers import sim3_opt as jopt
from orb_slam_cuda_tpu_torch.engine import loop_closing as tlc
from orb_slam_cuda_tpu_torch.engine import programs
from orb_slam_cuda_tpu_torch.ops import sim3_kernel
from orb_slam_cuda_tpu_torch.ops import sim3_opt_kernel as sk
from orb_slam_cuda_tpu_torch.solvers import sim3_opt as topt

torch.set_num_threads(2)
M = 64
SCALES = {"unit_scale": 1.0, "scaled": 1.7}
CASES = [f"{name},angle={a:g}" for name in SCALES for a in sk.CASE_ANGLES]
J_REL = 2.0**-22
J_REL32 = 1e-5


def _case(case, m=M):
    name, angle = case.split(",angle=")
    return sk.synthetic_pairs(CASES.index(case), m, float(angle), SCALES[name])


@pytest.fixture(scope="module")
def cases():
    out = {}
    for case in CASES:
        S, x1c, x2c, cam = _case(case)
        out[case] = dict(args=(S, x1c, x2c, cam), plain=sk.jacobian_plain(S, x1c, x2c, cam))
    return out


def _jax_jacobians(cases, x64: bool):
    """jax.jacfwd of the JAX package's residual chain at xi = 0, each case's
    J as numpy float32 (from float64 under x64)."""
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32

        def flat_res(xi, R, t, s, x1c, x2c, cam):
            p1, p2, _, _ = jopt._pair_residuals(jsim3.retract((R, t, s), xi), x1c, x2c, cam)
            return jnp.concatenate([p1, p2], axis=0)

        jac = jax.jit(jax.jacfwd(flat_res))
        out = {}
        for case, c in cases.items():
            (R, t, s), x1c, x2c, cam = c["args"]
            jc = jcam.Camera.create(cam.fx, cam.fy, cam.cx, cam.cy, width=cam.width, height=cam.height)
            a = [jnp.asarray(x.numpy(), dt) for x in (R, t, s, x1c, x2c)]
            out[case] = np.asarray(jac(jnp.zeros((7,), dt), *a, jc), np.float64)
        return out


@pytest.fixture(scope="module")
def jax_jac(cases):
    return {x64: _jax_jacobians(cases, x64) for x64 in (True, False)}


def _within(got, want, rel):
    """|got - want| <= rel x the row's largest |want| (a row: J[i], 2x7)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max(axis=(1, 2), keepdims=True, initial=0.0)
    return np.abs(got - want) <= rel * scale


@pytest.mark.parametrize("x64", [True, False], ids=["jax_float64", "jax_float32"])
@pytest.mark.parametrize("case", CASES)
def test_plain_jacobian_equals_jax_jacfwd(cases, jax_jac, case, x64):
    got, want = cases[case]["plain"].numpy(), jax_jac[x64][case]
    assert got.shape == want.shape == (2 * M, 2, 7)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    ok = _within(got, want, J_REL if x64 else J_REL32)
    assert ok.all(), (np.argwhere(~ok)[:5], got[~ok][:5], want[~ok][:5])


@pytest.mark.parametrize("case", CASES)
def test_special_rows_take_their_branches(cases, case):
    """Rows 0-1 are clamped or behind keyframe 1, rows 2-3 keyframe 2, in
    the float64 chain. A clamped depth has no tangent: along rho_z, which
    moves S x2c along z only, row 0's and row 1's keyframe-1 derivatives are
    0 exactly, where an unclamped row's are -f y / z^2."""
    S, x1c, x2c, cam = cases[case]["args"]
    S64 = tuple(a.double() for a in S)
    _, _, ok1, ok2 = sk.pair_residuals(S64, x1c.double(), x2c.double(), cam)
    assert not ok1[:2].any() and not ok2[2:4].any()
    assert ok1[sk.SPECIAL_ROWS:].any() and ok2[sk.SPECIAL_ROWS:].any()
    J = cases[case]["plain"]
    assert not J[:2, :, 2].any()
    assert bool((J[:M][ok1, :, 2] != 0).all())


@pytest.mark.parametrize("case", CASES + ["full_width", "nan_row", "no_pairs"])
def test_host_build_of_the_kernel_equals_plain(cases, case):
    """The kernel's own source, built by g++ for the host, thread by thread:
    the same function as the plain version, bit-equal here."""
    if case in cases:
        args, want = cases[case]["args"], cases[case]["plain"]
    else:
        S, x1c, x2c, cam = sk.synthetic_pairs(2000, 2000 if case == "full_width" else M, 0.3, 1.2)
        if case == "nan_row":
            x2c[7, 1] = float("nan")
        elif case == "no_pairs":
            x1c, x2c = x1c[:0], x2c[:0]
        args = (S, x1c, x2c, cam)
        want = sk.jacobian_plain(*args)
    got = sk.host(*args)
    assert got.shape == want.shape == (2 * args[1].shape[0], 2, 7)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(nan.any()) == (case == "nan_row")
    finite = ~nan.flatten(1).any(dim=1)
    assert _within(got[finite].numpy(), want[finite].numpy(), J_REL).all()
    assert torch.equal(got[finite], want[finite])


def test_operation_count():
    S, x1c, x2c, cam = _case("scaled,angle=0.3")
    pose, primal, tangent = sk.pair_ops(S, x1c, x2c, cam)
    assert pose.shape == (8,) and primal.shape == (M,) and tangent.shape == (M, 7)
    assert int(pose[0]) > 0 and bool((pose[1:] > 0).all())
    assert bool((primal > 0).all()) and bool((tangent > 0).all())
    # Every pair takes the same primal chain; a rho direction's tangent is
    # linear in its seed: fewer operations than a phi direction's.
    assert int(primal.min()) == int(primal.max())
    assert bool((tangent[sk.SPECIAL_ROWS:, :3].sum(1) < tangent[sk.SPECIAL_ROWS:, 3:6].sum(1)).all())
    # A clamped depth has no tangent: row 0's family-1 chain counts fewer.
    assert bool((tangent[0] < tangent[sk.SPECIAL_ROWS]).any())
    total = int(pose[0] + pose[1:].sum() + primal.sum() + tangent.sum())
    assert 100 * M < total < 400 * M


def _bad(args, i, x):
    S, x1c, x2c, cam = args
    parts = list(S) + [x1c, x2c]
    parts[i] = x
    return tuple(parts[:3]), parts[3], parts[4], cam


@pytest.mark.parametrize("case", ["dtype", "shape", "non_contiguous", "cpu", "mixed_devices"])
def test_wrapper_refusals(cases, case):
    args = cases[CASES[2]]["args"]
    if case == "dtype":
        args = _bad(args, 3, args[1].double())
    elif case == "shape":
        args = _bad(args, 4, args[2][:-1])
    elif case == "non_contiguous":
        args = _bad(args, 0, args[0][0].t())
    elif case == "mixed_devices":
        args = _bad(args, 1, args[0][1].to("meta"))
    match = "runs on CUDA tensors" if case == "cpu" else "must be a contiguous"
    with pytest.raises(ValueError, match=match):
        sk.launch(*args)
    if case == "cpu":  # on the CPU the wrapper takes the plain version
        assert torch.equal(sk.jacobian(*args), cases[CASES[2]]["plain"])
    else:
        with pytest.raises(ValueError, match="must be a contiguous"):
            sk.host(*args)


def _host_in_place(monkeypatch, calls):
    def stand_in(S, x1c, x2c, cam):
        calls.append(x1c.shape[0])
        return sk.host(S, x1c, x2c, cam)

    monkeypatch.setattr(sk, "jacobian", stand_in)


@pytest.mark.parametrize("case", ["free_scale", "fix_scale", "under_ten"])
def test_optimize_sim3_through_the_host_build(monkeypatch, case):
    """test_optimize_sim3's problems and gates with the kernel's host build
    giving every Jacobian: the same outcome as the JAX package's, and the
    same bits as the plain Jacobian's solve."""
    rng = np.random.default_rng(4)
    m, n_out = (20, 15) if case == "under_ten" else (80, 20)
    S0, x1c, x2c, uv1, uv2, isig = _opt_problem(rng, m, n_out)
    fix = case == "fix_scale"
    valid = np.ones(m, bool)
    valid[0] = False
    j = jopt.optimize_sim3(tuple(jnp.asarray(a) for a in S0), jnp.asarray(x1c), jnp.asarray(x2c),
                           jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(isig), jnp.asarray(isig),
                           jnp.asarray(valid), JCAM, fix_scale=fix)
    args = (tuple(tt(a) for a in S0), tt(x1c), tt(x2c), tt(uv1), tt(uv2), tt(isig), tt(isig), tt(valid), TCAM)
    plain = topt.optimize_sim3(*args, fix_scale=fix)
    calls = []
    _host_in_place(monkeypatch, calls)
    t = topt.optimize_sim3(*args, fix_scale=fix)
    assert calls == [m] * 15
    for a, b in ((j.R, t.R), (j.t, t.t), (j.s, t.s)):
        assert_same(a, b, rtol=1e-4, atol=1e-4)
    assert_same(j.inliers, t.inliers, what="inliers")
    assert int(j.n_inliers) == int(t.n_inliers)
    if case == "under_ten":
        assert int(t.n_inliers) == 0
    for a, b in zip(t, plain):
        assert torch.equal(a, b)


def test_sim3_refine_through_the_host_build_reads_nothing_back(monkeypatch):
    """The loop closer's `sim3_refine` program (a captured CUDA graph on the
    card) on the drifted ring, its Jacobians from the host build standing in
    for the kernel, under the spy: no read-back, 15 Jacobians a call, and the
    plain Jacobian's result bit for bit."""
    state = build_drifted_ring(np.random.default_rng(0))[0]
    lc = tlc.LoopCloser(CFG, CAM, None)
    seen, program = [], lc._refine_fn

    def record(*args):
        seen.append(args)
        return program(*args)

    lc._refine_fn = record
    assert lc._compute_sim3(state, 15, [0]) is not None and len(seen) == 1
    want = lc._refine_program(*seen[0])
    calls = []
    _host_in_place(monkeypatch, calls)
    with _SyncSpy() as spy:
        got = lc._refine_program(*seen[0])
    assert not spy.hits, sorted(set(spy.hits))
    assert calls == [state.kf_mp.shape[1]] * 15
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert sk in programs.KERNELS and sim3_kernel in programs.KERNELS


# The direction classes: the columns of J whose seeds reach t alone (rho),
# R and t (phi), t and s (sigma).
CLASS_COLUMNS = {"rho": [0, 1, 2], "phi": [3, 4, 5], "sigma": [6]}


def _non_finite_rows():
    """33 pairs at 2 rad, scale 1.7, with a NaN, +inf and -inf coordinate
    and a point at 1e30 (finite), beside the special rows."""
    S, x1c, x2c, cam = sk.synthetic_pairs(11, 33, 2.0, 1.7)
    x2c[7, 1] = float("nan")
    x1c[9, 0] = float("inf")
    x1c[10, 2] = -float("inf")
    x2c[11] = 1e30
    return S, x1c, x2c, cam


@pytest.fixture(scope="module")
def split_outputs():
    """For a case, (the host build's, the plain version's) J on its
    inputs, each computed once for the module's class cases."""
    cache = {}

    def get(case):
        if case not in cache:
            args = sk.synthetic_pairs(3, M, 2.0, 1.7) if case == "special_rows" else _non_finite_rows()
            cache[case] = (sk.host(*args), sk.jacobian_plain(*args))
        return cache[case]

    return get


@pytest.mark.parametrize("case", ["special_rows", "non_finite"])
@pytest.mark.parametrize("cls", list(CLASS_COLUMNS))
def test_class_chain_equals_jvp_of_plain(split_outputs, cls, case):
    """Each direction class's columns of the kernel's items (run by the
    host build) against torch.func.jvp of the plain chain along the class's
    seeds (`jacobian_plain`'s columns): NaN exactly where the plain version
    has it, the finite rows torch.equal, and every other entry (inf
    included) equal to the plain version's."""
    cols = CLASS_COLUMNS[cls]
    got, want = (out[..., cols] for out in split_outputs(case))
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(nan.any()) == (case == "non_finite")
    finite = ~nan.flatten(1).any(dim=1)
    assert torch.equal(got[finite], want[finite])
    assert torch.equal(got[~nan], want[~nan])


def test_operation_count_is_the_generic_chains():
    """`pair_ops` gives the counts it gave before the kernel's redesign: the same counts at
    chip_smoke.py's full width (its bound) and on 64 pairs."""
    import chip_smoke

    pose, primal, tangent = sk.pair_ops(*chip_smoke.sim3_opt_full_width_args("cpu"))
    assert pose.tolist() == [20, 6, 6, 6, 24, 24, 24, 25]
    assert (int(primal.sum()), int(tangent.sum())) == (100_000, 373_800)
    _, primal, tangent = sk.pair_ops(*sk.synthetic_pairs(5, 64, 0.3, 1.7))
    assert (int(primal.sum()), int(tangent.sum())) == (3_200, 11_824)


def test_host_build_at_a_ragged_size():
    """33 pairs: the second group of 32 pairs holds one. Every entry written
    (none left at the fill) and the plain version's J, bit for bit."""
    S, x1c, x2c, cam = sk.synthetic_pairs(33, 33, 0.3, 1.2)
    J = torch.full((66, 2, 7), 777.0)
    sk.build_host()
    rc = sk._host_lib.sim3_opt_jacobian_host(*sk._pointers(S, x1c, x2c), 33, float(cam.fx), float(cam.fy),
                                             J.data_ptr())
    assert rc == 0 and not bool((J == 777.0).any())
    assert torch.equal(J, sk.jacobian_plain(S, x1c, x2c, cam))
