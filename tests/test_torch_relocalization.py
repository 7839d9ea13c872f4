"""The port's keyframe-database queries and relocalization against the JAX
package's, on the drifted-ring map of tests/test_loop_closing.py carried
across with utils/convert.py. Tolerances: BoW scores within 1e-6,
candidate masks and common-word counts exact (a tie case included);
relocalization with the reference's EPnP draws injected gives the same
accept decision, stage and bindings, and a pose within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu.engine import relocalization as jreloc
from orb_slam_cuda_tpu.slam_map import keyframe_db as jdb
from orb_slam_cuda_tpu_torch.engine import relocalization as treloc
from orb_slam_cuda_tpu_torch.slam_map import keyframe_db as tdb
from orb_slam_cuda_tpu_torch.utils import convert
import test_loop_closing as ring_fixture
from torch_parity import assert_same, jax_sampler, to_np, tt

CAM, CFG = ring_fixture.CAM, ring_fixture.CFG

torch.set_num_threads(2)
TCAM = convert.camera(CAM)


@pytest.fixture(scope="module")
def ring():
    st, db, T_true, T_est, vocab = ring_fixture.build_drifted_ring(np.random.default_rng(0))
    return dict(jst=st, jdb=db, tst=convert.map_state(st), tdb=convert.bow_db(db), vocab=vocab)


def _query(ring, k):
    jq = jdb.dense_bow(ring["jdb"].word[k], ring["jdb"].weight[k], ring["vocab"].n_words)
    tq = tdb.dense_bow(ring["tdb"].word[k], ring["tdb"].weight[k], ring["vocab"].n_words)
    return jq, tq


@pytest.mark.parametrize("k", [3, 15])
def test_bow_scores_and_common_words(ring, k):
    jq, tq = _query(ring, k)
    assert_same(jq, tq, rtol=1e-6, atol=1e-6, what="dense bow")
    assert_same(jdb.scores(ring["jdb"], jq), tdb.scores(ring["tdb"], tq), rtol=1e-6, atol=1e-6)
    assert_same(jdb.common_words(ring["jdb"], jq), tdb.common_words(ring["tdb"], tq), what="common words")


@pytest.mark.parametrize("case", ["reloc", "loop_floor", "ties"])
def test_detect_candidates(ring, case):
    k = 15 if case == "loop_floor" else 5
    jq, tq = _query(ring, k)
    covis = np.asarray(ring["jst"].covis)
    excl = np.zeros(CFG.max_keyframes, bool)
    min_score = None
    if case == "loop_floor":
        excl[k] = True
        excl |= covis[k] >= 15
        min_score = 0.01
    elif case == "ties":
        # Every off-diagonal covisibility weight equal: each keyframe's
        # top-10 group is decided by index order alone (lower index first).
        covis = np.full_like(covis, 7) - 7 * np.eye(len(covis), dtype=covis.dtype)
    jm, js = jdb.detect_candidates(ring["jdb"], jq, jnp.asarray(excl), jnp.asarray(covis),
                                   min_score=None if min_score is None else jnp.float32(min_score))
    tm, ts = tdb.detect_candidates(ring["tdb"], tq, tt(excl), tt(covis),
                                   min_score=None if min_score is None else torch.tensor(min_score))
    assert_same(js, ts, rtol=1e-6, atol=1e-6, what="scores")
    assert_same(jm, tm, what="candidate mask")
    assert case == "loop_floor" or bool(to_np(tm).any())


@pytest.mark.parametrize("keep", [250, 40], ids=["strong", "weak"])
def test_relocalize_matches_reference(ring, keep):
    jframe = ring_fixture.TestRelocalizationGate()._frame_from_keyframe(ring["jst"], ring["vocab"], 5, keep=keep)
    sf = CFG.scale_factors
    jstats, tstats = {}, {}
    jpose, jmp, jok = jreloc.relocalize(ring["jst"], ring["jdb"], jframe, CAM, ring["vocab"].n_words,
                                        jnp.asarray(sf, jnp.float32), stats=jstats)
    tpose, tmp, tok = treloc.relocalize(ring["tst"], ring["tdb"], convert.frame_data(jframe), TCAM,
                                        ring["vocab"].n_words, tuple(sf), stats=tstats, sampler=jax_sampler)
    assert jok == tok and jstats == tstats
    assert tok == (keep == 250)
    if tok:
        assert_same(jmp, tmp, what="bindings")
        assert_same(jpose, tpose, rtol=1e-4, atol=1e-4, what="pose")
        assert np.abs(to_np(tpose) - to_np(ring["tst"].kf_pose[5])).max() < 0.05


@pytest.mark.parametrize("keep", [250, 40], ids=["strong", "weak"])
def test_relocalize_trace_names_the_refusing_rung(ring, keep):
    """`trace` receives one row per candidate tried and changes nothing:
    every row but an accepted last one names the rung that refused it."""
    jframe = ring_fixture.TestRelocalizationGate()._frame_from_keyframe(ring["jst"], ring["vocab"], 5, keep=keep)
    frame = convert.frame_data(jframe)
    args = (ring["tst"], ring["tdb"], frame, TCAM, ring["vocab"].n_words, tuple(CFG.scale_factors))
    pose0, mp0, ok0 = treloc.relocalize(*args, sampler=jax_sampler)
    trace = []
    pose, mp, ok = treloc.relocalize(*args, sampler=jax_sampler, trace=trace)
    assert ok == ok0 == (keep == 250) and trace
    rungs = {"bow_matches", "pnp", "ladder"}
    assert all(row["refused_at"] in rungs for row in trace[:-1])
    if ok:
        assert_same(mp0, mp, what="bindings")
        assert_same(pose0, pose, what="pose")
        assert "refused_at" not in trace[-1] and trace[-1]["n_good"] >= treloc.MIN_INLIERS_ACCEPT
    else:
        assert trace[-1]["refused_at"] in rungs
    assert all(row["bow_matches"] >= 0 and 0 <= row["kf"] < ring["tst"].kf_valid.shape[0] for row in trace)
