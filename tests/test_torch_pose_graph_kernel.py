"""The essential graph's edge linearization (ops/pose_graph_kernel.py) and
its solve on the CPU.

The plain version (`linearize_plain`: the residual chain in float64 through
`torch.func.jvp`, rounded once to float32) against the JAX package's
`_edge_residual` under `jax.vmap(jax.jacfwd(..., argnums=0/1))`, on the
numpy-seeded edges of `branch_edges`, one case a rotation angle (the
identity, theta ~ 1e-5 and 5e-5 in so3_log's small branch, 3e-4, 0.3, 2.0,
and 3.05 and 3.09 in its near-pi branch with no axis component near 0), each
with sigma = 0, |sigma| < 1e-5 and sigma ~ 0.1, and the residuals that are
the identity but for float32 rounding (where cos theta may round past 1).
Tolerances: against JAX in float64 (`jax.enable_x64`), the same function,
r, Ji and Jj within one float32 rounding (2^-22 relative, 1e-12 absolute
for entries that cancel to ~0); against JAX in float32, as the JAX package
runs, r within 1e-5 and the Jacobians within 1e-5 of the edge's largest
entry, 1e-2 at theta = 3e-4 (just past the small branch, where float32
so3_log's 0.5 theta / sin theta cancels: up to ~8e-3 in JAX's own
Jacobian, which its float64 run does not show).

The seeds the kernel starts from (the tangent of exp(xi) o S at 0 along each
coordinate, closed forms) against `torch.func.jvp` of sim3.exp at 0, exact
in float64. The kernel's source built by g++ for the host (the same
templated arithmetic, in double) against the plain version on the branch
edges and on a drifted ring: r within one float32 ulp or 1e-12, the
Jacobians within 2^-22 of the edge's largest entry, the branch flags equal
(`branch_flags_plain`), and its operation count. A solve with its edge
list padded to the program's bucket torch.equal to the unpadded one
(`optimize_pose_graph`, and the loop closer's `essential_graph_solve`
with `pad_edges`); the solve program reads nothing back (`_SyncSpy`); the
wrapper's refusals. The kernel runs on the card:
tests/test_torch_pose_graph_card.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import _SyncSpy
from torch_ring import CFG, build_drifted_ring

from orb_slam_cuda_tpu.solvers import pose_graph as jpg
from orb_slam_cuda_tpu_torch.engine import loop_closing as tlc
from orb_slam_cuda_tpu_torch.engine import programs
from orb_slam_cuda_tpu_torch.geometry import se3, sim3
from orb_slam_cuda_tpu_torch.ops import pose_graph_kernel as pk
from orb_slam_cuda_tpu_torch.slam_map import ops as map_ops
from orb_slam_cuda_tpu_torch.solvers import pose_graph as tpg

torch.set_num_threads(2)
SEED = 3
PER_ANGLE = len(pk.BRANCH_SIGMAS)
CASES = [f"angle={a:g}" for a in pk.BRANCH_ANGLES] + ["rounded_identity"]
TOL32 = {"angle=0.0003": 1e-2}


def _edges(case):
    """The branch edges' indices of a case (edge 0, the exact identity, with
    the angle-0 ones)."""
    if case == "rounded_identity":
        n = 1 + len(pk.BRANCH_ANGLES) * PER_ANGLE
        return np.arange(n, n + 8)
    k = CASES.index(case)
    idx = np.arange(1 + k * PER_ANGLE, 1 + (k + 1) * PER_ANGLE)
    return np.concatenate([[0], idx]) if k == 0 else idx


@pytest.fixture(scope="module")
def branch():
    args = pk.branch_edges(SEED)
    return dict(args=args, plain=pk.linearize_plain(*args), flags=pk.branch_flags_plain(*args))


def _jax_linearization(args, x64: bool):
    R, t, s, ei, ej, mR, mt, ms, _ = (a.numpy() for a in args)

    def res_fn(xi, xj, SiR, Sit, Sis, SjR, Sjt, Sjs, MR, Mt, Ms):
        return jpg._edge_residual(xi, xj, (SiR, Sit, Sis), (SjR, Sjt, Sjs), (MR, Mt, Ms))

    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        z = jnp.zeros((ei.shape[0], 7), dt)
        a = tuple(jnp.asarray(x, dt) for x in (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], mR, mt, ms))
        out = (jax.vmap(res_fn)(z, z, *a), jax.vmap(jax.jacfwd(res_fn, argnums=0))(z, z, *a),
               jax.vmap(jax.jacfwd(res_fn, argnums=1))(z, z, *a))
        return [np.asarray(o, np.float32) for o in out]


@pytest.fixture(scope="module")
def jax_lin(branch):
    return {x64: _jax_linearization(branch["args"], x64) for x64 in (False, True)}


@pytest.mark.parametrize("x64", [True, False], ids=["jax_float64", "jax_float32"])
@pytest.mark.parametrize("case", CASES)
def test_plain_linearization_equals_jax_jacfwd(branch, jax_lin, case, x64):
    idx = _edges(case)
    want = jax_lin[x64]
    got = [a.numpy() for a in branch["plain"]]
    for name, g, w in zip(("r", "Ji", "Jj"), got, want):
        g, w = g[idx].reshape(len(idx), -1), w[idx].reshape(len(idx), -1)
        assert np.isfinite(g).all() and np.isfinite(w).all(), name
        if x64:
            np.testing.assert_array_less(np.abs(g - w), 2.0**-22 * np.abs(w) + 1e-12, err_msg=name)
        elif name == "r":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
        else:
            scale = np.maximum(1.0, np.abs(w).max(axis=1, keepdims=True))
            np.testing.assert_array_less(np.abs(g - w), np.broadcast_to(TOL32.get(case, 1e-5) * scale, g.shape),
                                         err_msg=name)


def test_branch_edges_take_every_branch(branch):
    flags = branch["flags"].numpy()
    valid = branch["args"][-1].numpy()
    for f in (pk.FLAG_LOG_SMALL, pk.FLAG_LOG_NEAR_PI, pk.FLAG_COS_CLAMPED, pk.FLAG_SIGMA_ZERO, pk.FLAG_THETA_ZERO):
        assert (flags[valid] & f).any() and not (flags[valid] & f).all(), f
    assert (flags[valid] & (pk.FLAG_LOG_SMALL | pk.FLAG_LOG_NEAR_PI) == 0).any()  # the generic so3_log branch
    assert flags[0] == pk.FLAG_LOG_SMALL | pk.FLAG_SIGMA_ZERO | pk.FLAG_THETA_ZERO
    assert not branch["plain"][0][0].any()  # the exact identity: r = 0
    assert (flags[~valid] == 0).all()
    for out in branch["plain"]:
        assert not out[~torch.as_tensor(valid)].any()  # padded edges: zeros


@pytest.mark.parametrize("k", range(7))
def test_seeds_equal_jvp_of_exp_at_zero(k):
    """jvp of xi -> exp(xi) o S at 0 along e_k, in float64: the primal S
    itself and the kernel's closed-form tangent, exactly."""
    rng = np.random.default_rng(k)
    n = 6
    R = se3.so3_exp(torch.as_tensor(rng.normal(0, 1, (n, 3))))
    t = torch.as_tensor(rng.normal(0, 5, (n, 3)))
    s = torch.as_tensor(np.exp(rng.normal(0, 0.2, n)))
    tangent = torch.zeros((n, 7), dtype=torch.float64)
    tangent[:, k] = 1.0
    primal, (dR, dt, ds) = torch.func.jvp(lambda x: sim3.compose(sim3.exp(x), (R, t, s)),
                                          (torch.zeros((n, 7), dtype=torch.float64),), (tangent,))
    for a, b in zip(primal, (R, t, s)):
        assert torch.equal(a, b)
    zero3, zero = torch.zeros((n, 3, 3), dtype=torch.float64), torch.zeros(n, dtype=torch.float64)
    if k < 3:
        want = (zero3, tangent[:, :3], zero)
    elif k < 6:
        H = se3.hat(tangent[:, 3:6])
        want = (H @ R, (H @ t[..., None])[..., 0], zero)
    else:
        want = (zero3, t, s)
    for a, b in zip((dR, dt, ds), want):
        assert torch.equal(a, b)


def _ring_problem(n=24, pad=0, seed=5):
    """A drifted ring's pose graph (the chain, second neighbours, a loop edge
    with a drifted measurement), its edge list padded with `pad` edges."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    xi = np.zeros((n, 6))
    xi[:, 0], xi[:, 2], xi[:, 4] = 5 * np.cos(ang), 5 * np.sin(ang), ang
    T = se3.exp(torch.as_tensor(xi, dtype=torch.float32))
    R, t, s = T[:, :3, :3].contiguous(), T[:, :3, 3].contiguous(), torch.ones(n)
    ei = torch.cat([torch.arange(n - 1), torch.arange(n - 2), torch.tensor([0])])
    ej = torch.cat([torch.arange(1, n), torch.arange(2, n), torch.tensor([n - 1])])
    mR, mt, ms = tpg.relative_sim3((R[ei], t[ei], s[ei]), (R[ej], t[ej], s[ej]))
    mt[-1] += torch.tensor([0.3, 0.0, 0.2])
    ms[-1] *= 1.05
    t = t + torch.as_tensor(rng.normal(0, 0.05, (n, 3)), dtype=torch.float32)
    eye_R, eye_t, eye_s = sim3.identity((pad,))
    cat = lambda a, b: torch.cat([a, b]).contiguous()  # noqa: E731
    zeros = torch.zeros(pad, dtype=torch.int64)
    return tpg.PoseGraphProblem(
        vert_R=R, vert_t=t, vert_s=s, vert_fixed=torch.arange(n) == 0, edge_i=cat(ei, zeros), edge_j=cat(ej, zeros),
        meas_R=cat(mR, eye_R), meas_t=cat(mt, eye_t), meas_s=cat(ms, eye_s),
        edge_valid=torch.arange(ei.shape[0] + pad) < ei.shape[0])


def _close(name, got, want):
    if name == "r":
        ulp = torch.abs(torch.nextafter(want, torch.full_like(want, np.inf)) - want)
        assert bool((torch.abs(got - want) <= torch.clamp(ulp, min=1e-12)).all()), name
    else:
        scale = torch.clamp(want.abs().amax(dim=(1, 2), keepdim=True), min=1.0)
        assert bool((torch.abs(got - want) <= 2.0**-22 * scale).all()), name


@pytest.mark.parametrize("case", ["branch_edges", "ring"])
def test_host_build_of_the_kernel_equals_plain(branch, case):
    """The kernel's own source, built by g++ for the host, thread by thread:
    the same function as the plain version, and its operation count."""
    if case == "branch_edges":
        args = branch["args"]
    else:
        p = _ring_problem()
        args = (p.vert_R, p.vert_t, p.vert_s, p.edge_i, p.edge_j, p.meas_R, p.meas_t, p.meas_s, p.edge_valid)
    r, Ji, Jj, flags = pk.host(*args)
    want = pk.linearize_plain(*args)
    for name, a, b in zip(("r", "Ji", "Jj"), (r, Ji, Jj), want):
        assert bool(torch.isfinite(a).all()), name
        _close(name, a, b)
    assert torch.equal(flags, pk.branch_flags_plain(*args))
    primal, tangent = pk.edge_ops(*args)
    valid = args[-1]
    assert primal.shape == (args[3].shape[0],) and tangent.shape == (args[3].shape[0], pk.DIRECTIONS)
    assert bool((primal[valid] > 200).all()) and bool((tangent[valid] > 0).all())
    assert not (bool(primal[~valid].any()) or bool(tangent[~valid].any()))
    # A rho direction's tangent is linear in its seed: far fewer operations
    # than a phi direction's, which runs through so3_log and W.
    assert bool((tangent[valid][:, :3] < tangent[valid][:, 3:6]).all())


@pytest.mark.parametrize("edges", [46, 64, 65, 763])
def test_pad_edges_to_the_bucket(edges):
    ei = torch.arange(edges) % 7
    ej = torch.arange(edges) % 11 + 1
    pi, pj, valid = tlc.pad_edges(ei, ej, 256)
    bucket = max(tlc.EDGE_BUCKET_MIN, 1 << (edges - 1).bit_length())
    assert pi.shape == pj.shape == valid.shape == (bucket,)
    assert torch.equal(pi[:edges], ei) and torch.equal(pj[:edges], ej)
    assert bool(valid[:edges].all()) and not bool(valid[edges:].any())
    assert bool((pi[edges:] == 0).all()) and bool((pj[edges:] == 0).all())


def test_padded_pose_graph_solve_equals_unpadded():
    want = tpg.optimize_pose_graph(_ring_problem(), gn_iters=5, cg_iters=20)
    got = tpg.optimize_pose_graph(_ring_problem(pad=tlc.EDGE_BUCKET_MIN - 46), gn_iters=5, cg_iters=20)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(want[1]).all())


@pytest.fixture(scope="module")
def ring_map():
    state = build_drifted_ring(np.random.default_rng(0))[0]
    covis = map_ops.covisibility_matrix(state)
    K = state.kf_valid.shape[0]
    ei, ej = tlc.essential_graph_edges(state.kf_valid, covis, list(range(16)), [(3, 9)], (0, 15))
    loop_pos = torch.searchsorted(ei * K + ej, torch.tensor(15))
    S_loop = sim3.compose(sim3.exp(torch.tensor([0.05, -0.02, 0.03, 0.01, 0.02, -0.01, 0.0])),
                          sim3.from_se3(state.kf_pose[15] @ se3.inverse(state.kf_pose[0])))
    cand = torch.full((), 0, dtype=torch.int64)
    return state, ei, ej, loop_pos, S_loop, cand


def test_padded_essential_graph_solve_equals_unpadded(ring_map):
    state, ei, ej, loop_pos, S_loop, cand = ring_map
    pose_before = state.kf_pose
    want = tlc.essential_graph_solve(state, pose_before, ei, ej, loop_pos, S_loop, cand)
    pi, pj, valid = tlc.pad_edges(ei, ej, state.kf_valid.shape[0])
    assert pi.shape[0] > ei.shape[0]
    got = tlc.essential_graph_solve(state, pose_before, pi, pj, loop_pos, S_loop, cand, valid)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(want[0], state.kf_pose)  # the loop edge moved the poses


def test_essential_graph_program_reads_nothing_back(ring_map):
    """The loop closer's `essential_graph` program (a captured CUDA graph on
    the card) on a padded edge list, under the spy on the CPU."""
    state, ei, ej, loop_pos, S_loop, cand = ring_map
    lc = tlc.LoopCloser(CFG, None, None)
    assert lc._pose_graph_fn in lc.programs and lc._pose_graph_fn.name == "essential_graph"
    pi, pj, valid = tlc.pad_edges(ei, ej, state.kf_valid.shape[0])
    with _SyncSpy() as spy:
        kf_pose, mp_xyz = lc._pose_graph_fn(state, state.kf_pose, pi, pj, loop_pos, S_loop, cand, valid)
    assert not spy.hits, sorted(set(spy.hits))
    assert bool(torch.isfinite(kf_pose).all()) and bool(torch.isfinite(mp_xyz).all())
    assert pk in programs.KERNELS


def _bad(args, i, x):
    return tuple(x if j == i else a for j, a in enumerate(args))


@pytest.mark.parametrize("case", ["dtype", "index_dtype", "shape", "non_contiguous", "cpu", "mixed_devices",
                                  "no_edges"])
def test_wrapper_refusals(branch, case):
    args = branch["args"]
    if case == "dtype":
        args = _bad(args, 0, args[0].double())
    elif case == "index_dtype":
        args = _bad(args, 3, args[3].int())
    elif case == "shape":
        args = _bad(args, 6, args[6][:-1])
    elif case == "non_contiguous":
        args = _bad(args, 5, args[5].transpose(1, 2))
    elif case == "mixed_devices":
        args = _bad(args, 8, args[8].to("meta"))
    elif case == "no_edges":
        args = args[:3] + tuple(a[:0] for a in args[3:])
    match = "runs on CUDA tensors" if case == "cpu" else ("needs vertices and edges" if case == "no_edges"
                                                          else "must be a contiguous")
    with pytest.raises(ValueError, match=match):
        pk.launch(*args)
    if case == "cpu":  # on the CPU the wrapper takes the plain version
        for a, b in zip(pk.linearize(*args), branch["plain"]):
            assert torch.equal(a, b)
