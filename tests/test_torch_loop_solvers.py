"""The port's Sim(3) geometry and loop/relocalization solvers against the
JAX package's, on the same numpy inputs. Tolerances: Sim3 exp/log/compose
within 1e-5; Horn's exact recovery within 1e-4; Sim3 and EPnP RANSAC with
the reference's draws injected pick the same best hypothesis and return
the exact inlier mask (poses within 1e-4; >= 95% of the 512 EPnP
hypotheses, many of them degenerate six-point fits through outliers,
count the same inliers); optimize_sim3 and
optimize_pose_graph within 1e-4. The Sim3 RANSAC through its wrapper
(ops/sim3_kernel.py, the plain version on the CPU) equals the plain
version and the JAX function exactly; the loop closer's draw from uniform
keys (masked on the device inside its program) equals `draw_sets` and a
stable numpy argsort exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.geometry import sim3 as jsim3
from orb_slam_cuda_tpu.solvers import pnp as jpnp
from orb_slam_cuda_tpu.solvers import pose_graph as jpg
from orb_slam_cuda_tpu.solvers import sim3_opt as jopt
from orb_slam_cuda_tpu.solvers import sim3_solver as jsolver
from orb_slam_cuda_tpu_torch.geometry import sim3 as tsim3
from orb_slam_cuda_tpu_torch.solvers import pnp as tpnp
from orb_slam_cuda_tpu_torch.solvers import pose_graph as tpg
from orb_slam_cuda_tpu_torch.solvers import sim3_opt as topt
from orb_slam_cuda_tpu_torch.solvers import sim3_solver as tsolver
from orb_slam_cuda_tpu_torch.ops import sim3_kernel
from orb_slam_cuda_tpu_torch.solvers import initializer as tinit
from orb_slam_cuda_tpu_torch.solvers.initializer import default_sampler
from orb_slam_cuda_tpu_torch.utils import convert
from torch_parity import assert_same, jax_sets, to_np, tt

torch.set_num_threads(2)
JCAM = jcam.Camera.create(fx=400.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240)
TCAM = convert.camera(JCAM)


def _xi(rng, n, scale=0.4):
    return rng.normal(0, scale, (n, 7)).astype(np.float32)


def test_sim3_exp_log_compose_inverse_transform():
    rng = np.random.default_rng(0)
    xi = _xi(rng, 32)
    xi[:4, 3:6] = 0.0  # theta == 0 branch
    xi[4:8, 6] = 0.0  # sigma == 0 branch
    Sj, St = jsim3.exp(jnp.asarray(xi)), tsim3.exp(tt(xi))
    for a, b in zip(Sj, St):
        assert_same(a, b, rtol=1e-5, atol=1e-5, what="exp")
    assert_same(jsim3.log(Sj), tsim3.log(St), rtol=1e-5, atol=1e-5, what="log")
    Sj2, St2 = jsim3.exp(jnp.asarray(xi[::-1].copy())), tsim3.exp(tt(xi[::-1].copy()))
    for a, b in zip(jsim3.compose(Sj, jsim3.inverse(Sj2)), tsim3.compose(St, tsim3.inverse(St2))):
        assert_same(a, b, rtol=1e-5, atol=1e-5, what="compose")
    X = rng.normal(0, 2, (32, 5, 3)).astype(np.float32)
    assert_same(jsim3.transform(Sj, jnp.asarray(X)), tsim3.transform(St, tt(X)), rtol=1e-5, atol=1e-5)
    assert_same(jsim3.to_se3(Sj), tsim3.to_se3(St), rtol=1e-5, atol=1e-5, what="to_se3")
    for a, b in zip(jsim3.retract(Sj, jnp.asarray(xi)), tsim3.retract(St, tt(xi))):
        assert_same(a, b, rtol=1e-5, atol=1e-5, what="retract")


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_exact_recovery(fix_scale):
    rng = np.random.default_rng(1)
    x2 = rng.uniform(-2, 2, (30, 3)).astype(np.float32)
    xi = np.array([0.3, -0.2, 0.5, 0.2, -0.1, 0.15, 0.0 if fix_scale else 0.25], np.float32)
    S = tsim3.exp(tt(xi))
    x1 = tsim3.transform(S, tt(x2))
    Rj, tj, sj = jsolver.horn_sim3(jnp.asarray(to_np(x1)), jnp.asarray(x2), fix_scale)
    Rt, tt_, st = tsolver.horn_sim3(x1, tt(x2), fix_scale)
    for got, want in ((Rt, S[0]), (tt_, S[1]), (st, S[2]), (Rt, Rj), (tt_, tj), (st, sj)):
        np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-4)


def _sim3_problem(rng, m=100, n_out=25):
    x2 = np.stack([rng.uniform(-1.5, 1.5, m), rng.uniform(-1, 1, m), rng.uniform(3, 8, m)], -1)
    x2 = x2.astype(np.float32)
    S = tsim3.exp(tt(np.array([0.2, -0.1, 0.3, 0.05, -0.08, 0.02, 0.15], np.float32)))
    x1c = to_np(tsim3.transform(S, tt(x2)))
    x1 = x1c.copy()
    out = rng.choice(m, n_out, replace=False)
    x1[out] += rng.uniform(0.5, 2.0, (n_out, 3)).astype(np.float32)
    proj = lambda X: np.stack([400 * X[:, 0] / X[:, 2] + 160, 400 * X[:, 1] / X[:, 2] + 120], -1)  # noqa: E731
    valid = np.ones(m, bool)
    valid[-5:] = False
    return x1, x2, proj(x1c).astype(np.float32), proj(x2).astype(np.float32), valid


def test_sim3_ransac_with_reference_draws():
    rng = np.random.default_rng(2)
    x1, x2, uv1, uv2, valid = _sim3_problem(rng)
    th = np.full(len(x1), 9.21, np.float32)
    j = jsolver.solve_sim3_ransac(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(uv1), jnp.asarray(uv2),
                                  jnp.asarray(valid), JCAM, jax.random.PRNGKey(7), jnp.asarray(th),
                                  jnp.asarray(th))
    sets = jax_sets(7, valid, 128, 3)
    t = tsolver.solve_sim3_ransac(tt(x1), tt(x2), tt(uv1), tt(uv2), tt(valid), TCAM, tt(th), tt(th),
                                  sample_sets=sets)
    assert_same(j.inliers, t.inliers, what="inlier mask")
    assert int(j.n_inliers) == int(t.n_inliers) and bool(j.ok) == bool(t.ok)
    for a, b in ((j.R, t.R), (j.t, t.t), (j.s, t.s)):
        assert_same(a, b, rtol=1e-4, atol=1e-4)
    # The kernel's wrapper on CPU tensors and the plain version: the same.
    w = sim3_kernel.solve(tt(x1), tt(x2), tt(uv1), tt(uv2), tt(valid), torch.as_tensor(sets).long(), tt(th),
                          tt(th), TCAM)
    p = tsolver.solve_sim3_ransac_plain(tt(x1), tt(x2), tt(uv1), tt(uv2), tt(valid), TCAM, tt(th), tt(th),
                                        sample_sets=sets)
    for a, b, c in zip(t, w, p):
        assert torch.equal(a, b) and torch.equal(a, c)
    # The port's own draws (no injection) reach the same consensus here.
    d = tsolver.solve_sim3_ransac(tt(x1), tt(x2), tt(uv1), tt(uv2), tt(valid), TCAM, tt(th), tt(th),
                                  sample_sets=default_sampler("sim3", 7, tt(valid)))
    assert_same(j.inliers, d.inliers, what="own draws")


@pytest.mark.parametrize("m, n_valid", [(100, 100), (100, 2), (100, 0), (1000, 613), (777, 3)],
                         ids=["all_valid", "two_valid", "none_valid", "m1000", "m777_three_valid"])
def test_sim3_draw_from_keys(m, n_valid):
    """The loop closer's draw: uniform keys from the seeded CPU generator,
    masked by the pairs and reduced to the minimal sets on the device
    (`sets_from_keys`), equals a stable descending argsort of the masked
    keys (numpy), `draw_sets` on the same generator and `default_sampler`.
    Fewer than 3 valid rows fill up with invalid ones, lowest index first."""
    rng = np.random.default_rng(m + n_valid)
    valid = np.zeros(m, bool)
    valid[rng.choice(m, n_valid, replace=False)] = True
    keys = tinit.default_keys("sim3", 131 * 5 + 2, m)
    r = np.where(valid, keys.numpy(), -1.0)
    want = np.argsort(-r, axis=1, kind="stable")[:, :3]
    got = tinit.sets_from_keys(keys, tt(valid), 3)
    np.testing.assert_array_equal(to_np(got), want)
    gen = torch.Generator().manual_seed(131 * 5 + 2)
    np.testing.assert_array_equal(to_np(tinit.draw_sets(tt(valid), 128, gen, set_size=3)), want)
    np.testing.assert_array_equal(to_np(default_sampler("sim3", 131 * 5 + 2, tt(valid))), want)
    if n_valid >= 3:
        assert valid[want].all()
    else:
        assert valid[want].sum() == 128 * n_valid


def test_sim3_split_stamps_fit_the_kernel_source():
    """tests/torch_sim3_split.py, which times the Sim3 kernel's phases on
    the card from a stamped copy of its source, finds every line it stamps
    in this tree's csrc/sim3_ransac.cu exactly once."""
    import torch_sim3_split as split

    with open(sim3_kernel.SOURCE) as f:
        text = f.read()
    design = split._design(text)
    assert design == "one_launch"
    anchors = split.DESIGNS[design]["anchors"]
    stamped = split.instrument(text, anchors)
    inserted = sum(bool(before) + bool(after) for _, before, after in anchors)
    assert stamped.count("split_stamp(") == inserted + 1  # and the stamp's definition


def _pnp_problem(rng, m=200, n_out=80):
    X = np.stack([rng.uniform(-3, 3, m), rng.uniform(-2, 2, m), rng.uniform(4, 10, m)], -1)
    X = X.astype(np.float32)
    from orb_slam_cuda_tpu_torch.geometry import se3

    T = se3.exp(tt(np.array([0.4, -0.2, 0.3, 0.1, -0.15, 0.08], np.float32)))
    Xc = to_np(se3.transform(T, tt(X)))
    uv = np.stack([500 * Xc[:, 0] / Xc[:, 2] + 320, 500 * Xc[:, 1] / Xc[:, 2] + 240], -1)
    uv = uv + rng.normal(0, 0.3, uv.shape)
    sel = rng.choice(m, n_out, replace=False)
    uv[sel] += rng.uniform(30, 150, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    valid = np.ones(m, bool)
    valid[:7] = False
    return X, uv.astype(np.float32), valid, to_np(T)


def test_epnp_ransac_with_reference_draws():
    rng = np.random.default_rng(3)
    X, uv, valid, T_true = _pnp_problem(rng)
    jc = jcam.Camera.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
    th = np.full(len(X), 5.991, np.float32)
    j = jpnp.solve_pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(th),
                              jc, jax.random.PRNGKey(11))
    sets = jax_sets(11, valid, 512, 6)
    t = tpnp.solve_pnp_ransac(tt(X), tt(uv), tt(valid), tt(th), convert.camera(jc), sample_sets=sets)
    assert bool(j.ok) and bool(t.ok)
    assert_same(j.inliers, t.inliers, what="inlier mask")
    assert_same(j.pose, t.pose, rtol=1e-4, atol=1e-4, what="pose")
    np.testing.assert_allclose(to_np(t.pose), T_true, atol=2e-2)
    # Same best hypothesis: per-hypothesis inlier counts, both sides.
    def count_j(idx):
        w = jnp.zeros((len(X),)).at[idx].set(1.0)
        T = jpnp._epnp_from_weights(jnp.asarray(X), jnp.asarray(uv), w, jc)
        Xc = jnp.asarray(X) @ T[:3, :3].T + T[:3, 3]
        e2 = jnp.sum((jcam.project(jc, Xc) - jnp.asarray(uv)) ** 2, -1)
        return jnp.sum(jnp.asarray(valid) & (e2 < jnp.asarray(th)) & (Xc[:, 2] > 0))

    cj = np.asarray(jax.vmap(count_j)(jnp.asarray(sets)))
    Xt, uvt, vt, tht = tt(X), tt(uv), tt(valid), tt(th)
    Ts = tpnp._epnp_from_weights(Xt[sets], uvt[sets], torch.ones(sets.shape), convert.camera(jc))
    Xc = Xt @ Ts[..., :3, :3].transpose(-1, -2) + Ts[..., None, :3, 3]
    e2 = torch.sum((Xc[..., :2] / Xc[..., 2:] * 500 + torch.tensor([320.0, 240.0]) - uvt) ** 2, -1)
    ct = torch.sum(vt & (e2 < tht) & (Xc[..., 2] > 0), -1).numpy()
    assert int(np.argmax(cj)) == int(np.argmax(ct))
    assert (cj == ct).mean() >= 0.95, f"{(cj == ct).mean():.4f} of hypothesis counts agree"


def _opt_problem(rng, m=80, n_out=20):
    x2c = np.stack([rng.uniform(-1.5, 1.5, m), rng.uniform(-1, 1, m), rng.uniform(3, 8, m)], -1)
    x2c = x2c.astype(np.float32)
    S_true = tsim3.exp(tt(np.array([0.2, -0.1, 0.3, 0.05, -0.08, 0.02, 0.12], np.float32)))
    x1c = to_np(tsim3.transform(S_true, tt(x2c)))
    proj = lambda X: np.stack([400 * X[:, 0] / X[:, 2] + 160, 400 * X[:, 1] / X[:, 2] + 120], -1)  # noqa: E731
    uv1, uv2 = proj(x1c).astype(np.float32), proj(x2c).astype(np.float32)
    out = rng.choice(m, n_out, replace=False)
    uv1[out] += rng.uniform(20, 60, (n_out, 2)).astype(np.float32)
    isig = rng.choice([1.0, 1 / 1.44], m).astype(np.float32)
    S0 = tsim3.compose(tsim3.exp(tt(np.array([0.05, -0.04, 0.06, 0.02, -0.015, 0.01, 0.03], np.float32))),
                       S_true)
    return [to_np(a) for a in S0], x1c, x2c, uv1, uv2, isig


@pytest.mark.parametrize("case", ["free_scale", "fix_scale", "under_ten"])
def test_optimize_sim3(case):
    rng = np.random.default_rng(4)
    m, n_out = (20, 15) if case == "under_ten" else (80, 20)
    S0, x1c, x2c, uv1, uv2, isig = _opt_problem(rng, m, n_out)
    fix = case == "fix_scale"
    valid = np.ones(m, bool)
    valid[0] = False
    j = jopt.optimize_sim3(tuple(jnp.asarray(a) for a in S0), jnp.asarray(x1c), jnp.asarray(x2c),
                           jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(isig), jnp.asarray(isig),
                           jnp.asarray(valid), JCAM, fix_scale=fix)
    t = topt.optimize_sim3(tuple(tt(a) for a in S0), tt(x1c), tt(x2c), tt(uv1), tt(uv2), tt(isig),
                           tt(isig), tt(valid), TCAM, fix_scale=fix)
    for a, b in ((j.R, t.R), (j.t, t.t), (j.s, t.s)):
        assert_same(a, b, rtol=1e-4, atol=1e-4)
    assert_same(j.inliers, t.inliers, what="inliers")
    assert int(j.n_inliers) == int(t.n_inliers)
    if case == "under_ten":
        assert int(t.n_inliers) == 0


def _ring_graph(rng, n=12, drift=0.02):
    true = [tsim3.exp(tt(np.array([np.cos(a), np.sin(a), 0, 0, 0, a, 0.0], np.float32)))
            for a in 2 * np.pi * np.arange(n) / n]
    edges = [(k, k + 1) for k in range(n - 1)] + [(n - 1, 0), (2, 7)]
    est = [true[0]]
    for k in range(1, n):
        rel = tpg.relative_sim3(true[k - 1], true[k])
        est.append(tsim3.compose(tsim3.compose(tsim3.exp(tt(rng.normal(0, drift, 7).astype(np.float32))), rel),
                                 est[-1]))
    meas = [tpg.relative_sim3(true[i], true[j]) for i, j in edges]
    st = lambda Ss, c: np.stack([to_np(S[c]) for S in Ss])  # noqa: E731
    valid = np.ones(len(edges), bool)
    valid[-1] = False
    return dict(vert_R=st(est, 0), vert_t=st(est, 1), vert_s=st(est, 2),
                vert_fixed=np.arange(n) == 0, edge_i=np.array([e[0] for e in edges], np.int32),
                edge_j=np.array([e[1] for e in edges], np.int32), meas_R=st(meas, 0),
                meas_t=st(meas, 1), meas_s=st(meas, 2), edge_valid=valid)


def test_optimize_pose_graph():
    p = _ring_graph(np.random.default_rng(5))
    j = jpg.optimize_pose_graph(jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in p.items()}),
                                gn_iters=15, cg_iters=30)
    t = tpg.optimize_pose_graph(convert.pose_graph_problem(jpg.PoseGraphProblem(**p)),
                                gn_iters=15, cg_iters=30)
    for a, b in zip(j, t):
        assert_same(a, b, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(t[1][0]), p["vert_t"][0], atol=1e-6)
