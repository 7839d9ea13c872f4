"""The port's LoopCloser against the JAX package's on the drifted-ring map
of tests/test_loop_closing.py, carried across with utils/convert.py, with
the reference's Sim3 RANSAC draws injected. Tolerances: the same
candidate, loop pair and consistency groups, exactly; S_cm within 1e-4
and the projection gate's point matches exact; the essential graph's
sorted edge list exact; the global-BA problem's gather exact (floats
within 1e-6); keyframe poses and points after _correct_loop, and after
one chunked global BA, within 1e-3; an aborted global BA solves nothing
more and leaves the map as it was. The Sim3 stage's four programs
(`sim3_match`, `sim3_ransac`, `sim3_refine`, `loop_gate`) read nothing back: each runs
under `_SyncSpy` (tests/torch_parity.py) on the ring with the port's own
draws, the plain RANSAC standing in for the kernel with the spy suspended,
and the stage closes the reference's loop through them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine import loop_closing as jlc
from orb_slam_cuda_tpu.slam_map import ops as jmap_ops
from orb_slam_cuda_tpu.solvers import pose_graph as jpg
from orb_slam_cuda_tpu_torch.engine import loop_closing as tlc
from orb_slam_cuda_tpu_torch.slam_map import MapConfig
from orb_slam_cuda_tpu_torch.utils import convert
import test_loop_closing as ring_fixture
from torch_parity import _SyncSpy, assert_same, jax_sampler, to_np

torch.set_num_threads(2)
CAM, CFG = ring_fixture.CAM, ring_fixture.CFG
TCAM = convert.camera(CAM)
TCFG = MapConfig(**CFG._asdict())
KF_ORDER = list(range(16))


@pytest.fixture(scope="module")
def ring():
    st, db, T_true, T_est, vocab = ring_fixture.build_drifted_ring(np.random.default_rng(0))
    return dict(jst=st, jdb=db, tst=convert.map_state(st), tdb=convert.bow_db(db), vocab=vocab,
                tvocab=convert.vocabulary(vocab))


def _closers(ring, **kw):
    return (jlc.LoopCloser(CFG, CAM, ring["vocab"], **kw),
            tlc.LoopCloser(TCFG, TCAM, ring["tvocab"], sampler=jax_sampler, **kw))


@pytest.fixture(scope="module")
def sim3_hit(ring):
    j, t = _closers(ring)
    return j._compute_sim3(ring["jst"], 15, [0]), t._compute_sim3(ring["tst"], 15, [0])


def test_compute_sim3_same_loop_pair(sim3_hit):
    jhit, thit = sim3_hit
    assert jhit is not None and thit is not None
    assert jhit[0] == thit[0] == 0
    for a, b in zip(jhit[1], thit[1]):
        assert_same(a, b, rtol=1e-4, atol=1e-4, what="S_cm")
    assert_same(jhit[2], thit[2], what="projection-gate point matches")


@pytest.mark.parametrize("cand", [7, 8])
def test_compute_sim3_rejects_aliased_candidate(ring, cand):
    j, t = _closers(ring)
    assert j._compute_sim3(ring["jst"], 15, [cand]) is None
    assert t._compute_sim3(ring["tst"], 15, [cand]) is None


def test_detect_consistency_chain(ring):
    j, t = _closers(ring)
    for k in (13, 14, 15, 15):
        assert j._detect(ring["jst"], ring["jdb"], k) == t._detect(ring["tst"], ring["tdb"], k)
        assert j.consistent_groups == t.consistent_groups


def _record_pose_graph(monkeypatch):
    """Capture the PoseGraphProblem the reference builds, and run it."""
    seen = []
    solve = jpg.optimize_pose_graph

    def spy(problem, **kw):
        seen.append(problem)
        return solve(problem, **kw)

    monkeypatch.setattr(jpg, "optimize_pose_graph", spy)
    return seen


@pytest.mark.parametrize("past", [[], [(3, 9), (2, 30)]], ids=["first_loop", "past_loops"])
def test_correct_loop_and_essential_graph(ring, sim3_hit, monkeypatch, past):
    """Past loop edges join the graph; one of them ends on an empty slot
    and must be dropped. The port corrects from the reference's S_cm."""
    j, t = _closers(ring, run_global_ba=False)
    j.loop_edges, t.loop_edges = list(past), list(past)
    cand, S_cm, _ = sim3_hit[0]
    order = KF_ORDER[::2] + KF_ORDER[1::2]  # the chain is kf_order's, not slot order
    seen = _record_pose_graph(monkeypatch)
    jst = j._correct_loop(ring["jst"], 15, cand, S_cm, order)
    tst = t._correct_loop(ring["tst"], 15, cand, convert.sim3_triple(S_cm), order)
    (problem,) = seen
    covis_pre = convert.tensor(jmap_ops.covisibility_matrix(ring["jst"]))
    ei, ej = tlc.essential_graph_edges(ring["tst"].kf_valid, covis_pre, order, past, (0, 15))
    assert_same(problem.edge_i, ei.to(torch.int32), what="edge_i")
    assert_same(problem.edge_j, ej.to(torch.int32), what="edge_j")
    assert_same(jst.kf_mp, tst.kf_mp, what="bindings after fusion")
    assert_same(jst.kf_pose, tst.kf_pose, rtol=1e-3, atol=1e-3, what="keyframe poses")
    valid = to_np(tst.mp_valid)
    assert_same(jst.mp_valid, tst.mp_valid, what="point validity")
    np.testing.assert_allclose(to_np(tst.mp_xyz)[valid], to_np(jst.mp_xyz)[valid], rtol=1e-3, atol=1e-3)


def _run_gba(lc, st, order, solve_order=None):
    pending = lc.dispatch_global_ba(st, solve_order or order)
    while not lc.continue_global_ba(pending):
        pass
    return lc.finish_global_ba(st, pending, order), pending


@pytest.mark.parametrize("solve_upto", [16, 12], ids=["all", "catch_up_chain"])
def test_chunked_global_ba(ring, solve_upto):
    """One whole chunked solve; with 12 keyframes in the solve the other 4
    are re-posed through the catch-up chain."""
    j, t = _closers(ring)
    jst, jp = _run_gba(j, ring["jst"], KF_ORDER, KF_ORDER[:solve_upto])
    tst, tp = _run_gba(t, ring["tst"], KF_ORDER, KF_ORDER[:solve_upto])
    assert jp.iters_done == tp.iters_done == t.GBA_TOTAL_ITERS
    assert_same(jst.kf_pose, tst.kf_pose, rtol=1e-3, atol=1e-3, what="keyframe poses")
    valid = to_np(tst.mp_valid)
    np.testing.assert_allclose(to_np(tst.mp_xyz)[valid], to_np(jst.mp_xyz)[valid], rtol=1e-3, atol=1e-3)


def test_gather_global_ba_problem(ring):
    """The whole-map BA problem over 12 live keyframes padded to 16."""
    cams = np.array(KF_ORDER[:12] + [-1] * 4, np.int32)
    isig = [1.0 / s2 for s2 in CFG.level_sigma2]
    jp, _, _ = jlc.gather_global_ba_problem(ring["jst"], jnp.asarray(cams), 3, jnp.asarray(isig))
    tp, _, _ = tlc.gather_global_ba_problem(ring["tst"], convert.tensor(cams).long(), 3, isig)
    for f, j in convert.ba_problem(jp)._asdict().items():
        t = getattr(tp, f)
        if t.is_floating_point():
            assert_same(j, t, rtol=1e-6, atol=1e-6, what=f)
        else:
            assert_same(j.to(t.dtype), t, what=f)


def test_global_ba_abort_mid_solve(ring):
    _, t = _closers(ring)
    pending = t.dispatch_global_ba(ring["tst"], KF_ORDER)
    assert pending.iters_done == t.GBA_CHUNK_ITERS < t.GBA_TOTAL_ITERS
    t.gba_idx += 1  # a second loop closes while the solve is parked
    assert t.continue_global_ba(pending) is True
    assert pending.iters_done == t.GBA_CHUNK_ITERS
    assert t.finish_global_ba(ring["tst"], pending, KF_ORDER) is ring["tst"]


def test_process_closes_the_same_loop(ring):
    """The synchronous DetectLoop -> ComputeSim3 -> CorrectLoop -> global
    BA chain, keyframe after keyframe, as the engine calls it."""
    j, t = _closers(ring)
    jst, jdb, tst, tdb = ring["jst"], ring["jdb"], ring["tst"], ring["tdb"]
    for k in (12, 13, 14, 15, 15):
        jst, jdb = j.process(jst, jdb, k, KF_ORDER)
        tst, tdb = t.process(tst, tdb, k, KF_ORDER)
        assert (j.n_loops_closed, j.loop_edges, j.kf_seen, j.gba_idx) == \
               (t.n_loops_closed, t.loop_edges, t.kf_seen, t.gba_idx)
    assert t.n_loops_closed == 1 and t.loop_edges == [(0, 15)]
    assert_same(jst.kf_pose, tst.kf_pose, rtol=1e-3, atol=1e-3, what="keyframe poses")


def test_loop_closer_state_carries_across(ring):
    j, t = _closers(ring)
    j._detect(ring["jst"], ring["jdb"], 13)
    j.loop_edges, j.n_loops_closed, j.gba_idx = [(0, 15)], 1, 2
    convert.loop_closer_state(j, t)
    assert t.consistent_groups == j.consistent_groups and t.loop_edges == [(0, 15)]
    assert (t.n_loops_closed, t.gba_idx, t.kf_seen) == (1, 2, j.kf_seen)


def test_projection_gate_sees_every_group_point(ring):
    """pow2_bucket sizes match the reference's on the grown-map sizes."""
    for n in (0, 100, 4096, 4097, 9000, 70000):
        assert tlc.pow2_bucket(n, 4096, 32768) == jlc.pow2_bucket(n, 4096, 32768)
    jn, jk = jlc.loop_group_point_count(ring["jst"], np.int32(0))
    tn, tk = tlc.loop_group_point_count(ring["tst"], 0)
    assert int(jn) == int(tn)
    assert_same(jk, tk, what="loop keyframes")


def test_port_built_ring_equals_reference(ring):
    """tests/torch_ring.py (the ring made with the port's own code, for
    the card tests) equals the reference's ring: integer fields exact, float fields
    within 1e-5 relative or 1e-4 absolute (pixel coordinates near 400)."""
    import torch_ring

    st, db, *_, vocab = torch_ring.build_drifted_ring(np.random.default_rng(0))
    assert vocab.n_words == ring["vocab"].n_words
    for name, a, b in [(f, ring["tst"], st) for f in st._fields] + [(f, ring["tdb"], db) for f in db._fields]:
        x, y = getattr(a, name), getattr(b, name)
        if x.is_floating_point():
            assert_same(x, y, rtol=1e-5, atol=1e-4, what=name)
        else:
            assert_same(x, y, what=name)


def test_sim3_programs_read_nothing_back(ring, monkeypatch):
    """On the card each Sim3 stage of a candidate is one captured CUDA
    graph; on the CPU its function runs under the spy, and so does the
    default sampler's draw of the minimal sets between them. The RANSAC kernel
    launches on the card where `eigh` would read back: its plain version
    stands in here, with the spy suspended."""
    from torch.utils._python_dispatch import _disable_current_modes

    from orb_slam_cuda_tpu_torch.ops import sim3_kernel

    plain, kernel_calls = sim3_kernel.solve, []

    def stand_in(*args, **kw):
        kernel_calls.append(args[0].shape)
        with _disable_current_modes():
            return plain(*args, **kw)

    monkeypatch.setattr(sim3_kernel, "solve", stand_in)
    lc = tlc.LoopCloser(TCFG, TCAM, ring["tvocab"])  # the default sampler: keys drawn on the host
    spies = {}
    for program in lc.programs[2:]:
        spy, fn = _SyncSpy(), program.fn

        def run(*args, spy=spy, fn=fn):
            with spy:
                return fn(*args)

        program.fn, spies[program.name] = run, spy
    # The default sampler's draw runs between the programs, on the card too.
    spies["draw"], sampler = _SyncSpy(), lc.sampler

    def draw(*args):
        with spies["draw"]:
            return sampler(*args)

    lc.sampler = draw
    hit = lc._compute_sim3(ring["tst"], 15, [0])
    assert hit is not None and hit[0] == 0
    assert lc.sim3_counts == dict(match=1, ransac=1, refine=1, gate=1, accepted=1)
    assert kernel_calls == [(ring["tst"].kf_mp.shape[1], 3)]
    for name, spy in spies.items():
        assert not spy.hits, (name, sorted(set(spy.hits)))
