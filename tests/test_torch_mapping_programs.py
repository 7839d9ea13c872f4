"""The keyframe path's programs on the CPU: local mapping's dispatch, BA
round 2 and keyframe erase, keyframe insertion and depth points, loop
detection and a global-BA chunk; and the essential-graph solve, which
runs eagerly on the card.

On the card each program runs as a captured CUDA graph
(engine/programs.py), so nothing inside may read a value back or copy
host data to the card, nor may the eager solve (it would stall the
mapping queue behind it): each
runs here under `_SyncSpy` (tests/torch_parity.py) with its inputs made as
the System makes them, on a map with real geometry
(tests/torch_mapping_fixture.py: seven live keyframes, six of them
covisible neighbours of the new one, neighbour lists -1 padded), and
records no such op.

The masked neighbour loops that replace the JAX package's scans
(`triangulate_and_insert_all`, `fuse_all`, `redundancy_all`) equal the
JAX functions on the same numpy state: integers and bools exact, floats
within 1e-5, except the triangulated points within 1e-3 of their size
(each package's float32 eigen-solver rounds its own way, as in
test_torch_geometry.py's DLT case). The kernel stands in for `eigh` on
the card; here the plain version runs with the spy suspended. A padded
neighbour list gives the same state bit for bit as the unpadded one; the
sync-free `nonzero_fixed` equals torch.nonzero's first `size` entries; a
changed keyframe-slot tensor changes the result and not the program key;
a young map's keyframes, with or without probation points, share one
dispatch key."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as hs

from orb_slam_cuda_tpu.engine import local_mapping as jlm
from orb_slam_cuda_tpu.geometry import camera as jcam
from orb_slam_cuda_tpu.slam_map import state as jst
from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig, programs
from orb_slam_cuda_tpu_torch.engine import local_mapping as tlm
from orb_slam_cuda_tpu_torch.engine import loop_closing as tlc
from orb_slam_cuda_tpu_torch.geometry import sim3
from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.slam_map import keyframe_db as tdb
from orb_slam_cuda_tpu_torch.slam_map import ops as tops
from orb_slam_cuda_tpu_torch.slam_map import state as tst
from orb_slam_cuda_tpu_torch.utils import convert
from torch_mapping_fixture import CAM_ARGS, K, N, N_LIVE, P, arrays
from torch_parity import _SyncSpy, assert_same, to_np

torch.set_num_threads(2)
NEW = N_LIVE - 1  # the new keyframe's slot
NB = 8  # neighbour list length: six live neighbours and two pads
MAX_NEW = 128
CFG_T = tst.MapConfig(max_keyframes=K, max_features=N, max_points=P)
SF = tuple(CFG_T.scale_factors)
SIG2 = tuple(CFG_T.level_sigma2)


def _same_state(js, ts, what="", xyz_rtol=1e-5):
    for f in jst.MapState._fields:
        a = to_np(getattr(js, f))
        exact = not np.issubdtype(a.dtype, np.floating)
        rtol = xyz_rtol if f == "mp_xyz" else 1e-5
        assert_same(a, getattr(ts, f), rtol=None if exact else rtol, atol=0.0 if exact else 1e-5,
                    what=f"{what}: {f}")


def _jstate(ts):
    return jst.MapState(**{f: jnp.asarray(to_np(getattr(ts, f))) for f in jst.MapState._fields})


@pytest.fixture(scope="module")
def fixture():
    ts = convert.map_state(jst.MapState(**arrays()))
    ts = tops.update_point_stats(tops.refresh_covis_rows(ts, torch.arange(K)), CFG_T)
    neighbors = tops.top_covisible(ts.covis[NEW], NB)
    assert int((neighbors >= 0).sum()) == N_LIVE - 1 and int(neighbors[-1]) == -1
    slot_matrix = torch.arange(P - NB * MAX_NEW, P, dtype=torch.int64).reshape(NB, MAX_NEW)
    tcam = Camera.create(**CAM_ARGS)
    return dict(ts=ts, neighbors=neighbors, slot_matrix=slot_matrix, tcam=tcam,
                jcam=jcam.Camera.create(**CAM_ARGS))


def _slot(k):
    return torch.full((), k, dtype=torch.int64)


def _triangulated(fx):
    """The port's triangulation of the fixture, with point statistics."""
    st, counts = tlm.triangulate_and_insert_all(fx["ts"], _slot(NEW), fx["neighbors"], fx["slot_matrix"],
                                                fx["tcam"], torch.tensor(SF), torch.tensor(SIG2),
                                                max_new=MAX_NEW, n_iter=NB)
    return tops.update_point_stats(st, CFG_T), counts


@pytest.mark.parametrize("fn", ["triangulate_and_insert_all", "fuse_all", "redundancy_all"])
def test_masked_scans_equal_jax(fixture, fn):
    fx = fixture
    nb = to_np(fx["neighbors"]).astype(np.int32)
    sf_j, sig2_j = jnp.asarray(SF, jnp.float32), jnp.asarray(SIG2, jnp.float32)
    if fn == "triangulate_and_insert_all":
        ts = fx["ts"]
        js, jn = jlm.triangulate_and_insert_all(_jstate(ts), np.int32(NEW), jnp.asarray(nb),
                                                jnp.asarray(to_np(fx["slot_matrix"]).astype(np.int32)),
                                                fx["jcam"], sf_j, sig2_j, max_new=MAX_NEW)
        ts2, tn = tlm.triangulate_and_insert_all(ts, _slot(NEW), fx["neighbors"], fx["slot_matrix"], fx["tcam"],
                                                 torch.tensor(SF), torch.tensor(SIG2), max_new=MAX_NEW,
                                                 n_iter=NB)
        assert_same(jn, tn, what="used counts")
        assert int(tn.sum()) > 20 and int((tn > 0).sum()) >= 3  # real triangulations, >= 3 neighbours
        # The fresh points are the two packages' float32 DLTs, whose
        # eigen-solvers round apart by up to ~1e-4 of a point here
        # (test_torch_geometry.py holds the DLT at pixel scale to 1e-3).
        _same_state(js, ts2, fn, xyz_rtol=1e-3)
        return
    ts = _triangulated(fx)[0]  # fusion and redundancy on a map with fresh points
    if fn == "fuse_all":
        js = jlm.fuse_all(_jstate(ts), np.int32(NEW), jnp.asarray(nb), fx["jcam"], sf_j)
        ts2 = tlm.fuse_all(ts, _slot(NEW), fx["neighbors"], fx["tcam"], torch.tensor(SF), n_iter=NB)
        assert not torch.equal(ts2.kf_mp, ts.kf_mp)  # something fused
        _same_state(js, ts2, fn)
    else:
        assert_same(jlm.redundancy_all(_jstate(ts), jnp.asarray(nb)),
                    tlm.redundancy_all(ts, fx["neighbors"], n_iter=NB), rtol=1e-6, what=fn)


def test_padded_neighbours_give_the_same_state(fixture):
    fx = fixture
    live = fx["neighbors"][fx["neighbors"] >= 0]
    padded = torch.cat([live, torch.full((10,), -1, dtype=torch.int64)])
    slots = fx["slot_matrix"][: live.shape[0]]
    slots_padded = torch.cat([slots, torch.zeros((10, MAX_NEW), dtype=torch.int64)])
    args = (fx["tcam"], torch.tensor(SF), torch.tensor(SIG2))
    a, na = tlm.triangulate_and_insert_all(fx["ts"], _slot(NEW), live, slots, *args, max_new=MAX_NEW)
    b, nb = tlm.triangulate_and_insert_all(fx["ts"], _slot(NEW), padded, slots_padded, *args, max_new=MAX_NEW)
    assert torch.equal(na, nb[: live.shape[0]]) and not bool(nb[live.shape[0]:].any())
    for f in tst.MapState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    ts = tops.update_point_stats(a, CFG_T)
    a = tlm.fuse_all(ts, _slot(NEW), live, fx["tcam"], torch.tensor(SF))
    b = tlm.fuse_all(ts, _slot(NEW), padded, fx["tcam"], torch.tensor(SF))
    for f in tst.MapState._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    ra = tlm.redundancy_all(ts, live)
    rb = tlm.redundancy_all(ts, padded)
    assert torch.equal(ra, rb[: live.shape[0]]) and not bool(rb[live.shape[0]:].any())


@settings(max_examples=60, deadline=None)
@given(n=hs.integers(0, 300), size=hs.integers(1, 400), density=hs.floats(0.0, 1.0), seed=hs.integers(0, 2**31))
def test_nonzero_fixed_equals_torch_nonzero(n, size, density, seed):
    mask = torch.as_tensor(np.random.default_rng(seed).random(n) < density)
    want = torch.full((size,), -1, dtype=torch.int64)
    idx = torch.nonzero(mask).flatten()[:size]
    want[: idx.shape[0]] = idx
    assert torch.equal(tlm.nonzero_fixed(mask, size), want)


def _mapper(device="cpu"):
    return tlm.LocalMapper(CFG_T, Camera.create(**CAM_ARGS), n_triangulate_neighbors=4, n_fuse_neighbors=8,
                           lba_local=5, lba_fixed=2, lba_points=256, device=device)


def _db(ts):
    db = tdb.empty(K, N)
    for k in range(N_LIVE):
        db = tdb.insert(db, k, *tdb.compute_bow_row(ts.kf_word[k], torch.ones(N), ts.kf_feat_valid[k]))
    return db


@pytest.fixture
def dlt_stand_in(monkeypatch):
    """On the card triangulate_dlt launches the DLT kernel (no eigen-solver,
    nothing read back); here its plain version (`eigh`) stands in, run with
    the spy suspended. Returns the list of its calls."""
    from torch.utils._python_dispatch import _disable_current_modes

    from orb_slam_cuda_tpu_torch.ops import dlt_kernel

    calls, plain = [], dlt_kernel.triangulate_dlt

    def stand_in(*args):
        calls.append(args[2].shape)
        with _disable_current_modes():
            return plain(*args)

    monkeypatch.setattr(dlt_kernel, "triangulate_dlt", stand_in)
    return calls


def _spy_on(program):
    """Run `program`'s function under a _SyncSpy from now on."""
    spy, fn = _SyncSpy(), program.fn

    def run(*args):
        with spy:
            return fn(*args)

    program.fn = run
    return spy


def _insert_system():
    cam = Camera.create(**CAM_ARGS, bf=40.0)
    return System(SystemConfig(camera=cam, sensor=Sensor.RGBD, n_features=600, max_keyframes=K,
                               max_points=P, enable_loop_closing=False), device="cpu")


@pytest.mark.parametrize("program", ["map_dispatch", "map_ba2", "map_erase", "kf_insert", "depth_points",
                                     "loop_detect", "loop_pose_graph", "gba_chunk"])
def test_keyframe_programs_read_nothing_back(fixture, dlt_stand_in, program):
    ts = fixture["ts"]
    if program.startswith("map_"):
        m = _mapper()
        spy = _spy_on({p.name: p for p in m.programs}[program])
        # As the System calls it: three keyframes of probation points.
        recent = [(p, b) for b, p in zip([3, 4, 5] * 10, range(40, 70))]
        kf_order = list(range(N_LIVE))
        m.mp_valid_host[:70] = True
        st, pending = m.dispatch_keyframe(ts, NEW, list(recent), kf_order)
        st = m.run_ba_round2(st, pending)
        m.kf_cull_redundancy = 0.5  # so that the finish erases a keyframe
        st, _ = m.finish_keyframe(st, _db(ts), pending, list(recent), kf_order)
        assert len(kf_order) < N_LIVE, "no keyframe culled: the erase program did not run"
        assert len(dlt_stand_in) == 4  # one DLT a triangulation neighbour, through the kernel's wrapper
    elif program in ("kf_insert", "depth_points"):
        slam = _insert_system()
        spy = _spy_on(getattr(slam, f"_{program}_fn"))
        rng = np.random.default_rng(2)
        n = 600
        frame = (torch.as_tensor(rng.uniform(0, 300, (n, 2)).astype(np.float32)), torch.full((n,), -1.0),
                 torch.as_tensor(rng.uniform(1, 8, n).astype(np.float32)), torch.zeros(n, dtype=torch.int32),
                 torch.zeros(n), torch.as_tensor(rng.integers(0, 2**31, (n, 8)).astype(np.int32)),
                 torch.ones(n, dtype=torch.bool), torch.as_tensor(rng.integers(0, 40, n).astype(np.int32)),
                 torch.as_tensor(rng.integers(0, 6, n).astype(np.int32)), torch.full((n,), -1, dtype=torch.int32),
                 torch.ones(n))
        st, db = slam._kf_insert_fn(slam.state, slam.db, frame, _slot(3), torch.eye(4),
                                    torch.full((), 42, dtype=torch.int32))
        st, used = slam._depth_points_fn(st, _slot(3), torch.full((), 5.0), torch.arange(100, 612))
        assert bool(db.valid[3]) and int(st.kf_frame_id[3]) == 42 and int(used) > 100
    else:
        lc = tlc.LoopCloser(CFG_T, Camera.create(**CAM_ARGS), type("Vocab", (), {"n_words": 12})())
        if program == "loop_pose_graph":  # the essential-graph solve, as the loop closer calls it
            ei = torch.cat([torch.arange(NEW), torch.tensor([0])])
            ej = torch.cat([torch.arange(1, NEW + 1), torch.tensor([NEW])])
            args = (ts, ts.kf_pose, ei, ej, torch.tensor(NEW), sim3.from_se3(ts.kf_pose[2]), _slot(0))
            with _SyncSpy() as spy:
                kf_pose, _ = tlc.essential_graph_solve(*args)
            assert bool(torch.isfinite(kf_pose).all())
            assert not spy.hits, sorted(set(spy.hits))
            return
        spy = _spy_on({p.name: p for p in lc.programs}[program])
        if program == "loop_detect":
            mask, covis = lc._candidates(ts, _db(ts), NEW)
            assert mask.shape == (K,) and covis.shape == (K, K)
        else:
            problem, _ = lc.global_ba_problem(ts, list(range(N_LIVE)))
            assert bool(torch.isfinite(lc._solve_chunk(problem, 3).cam_pose).all())
    assert not spy.hits, sorted(set(spy.hits))


def _no_probation():
    return (torch.zeros(P, dtype=torch.bool), torch.zeros(P, dtype=torch.int32),
            torch.full((P,), -1, dtype=torch.int32))


def test_slot_tensor_changes_result_not_key(fixture):
    ts = fixture["ts"]
    m = _mapper()
    sm = fixture["slot_matrix"][:4, :].repeat(1, 2)
    args = lambda k: (ts, _slot(k), sm, _no_probation(), 4, 8)  # noqa: E731
    assert programs.program_key(*args(NEW)) == programs.program_key(*args(NEW - 1))
    a, b = m._dispatch_fn(*args(NEW)), m._dispatch_fn(*args(NEW - 1))
    assert not torch.equal(a[1], b[1])  # the packed neighbours and counts
    assert not torch.equal(a[0].kf_mp, b[0].kf_mp)


@pytest.mark.parametrize("n_live", [2, 3, 4, 5])
def test_young_map_keyframes_share_the_dispatch_key(fixture, n_live):
    """With 1 to 4 live neighbours, with or without probation points, the
    dispatch's key is the one of a 5-keyframe map with 30 probation
    points: the neighbour loops run at least 4 entries, the probation ids
    are padded to at least 4096 (here the capacity), the redundancies are
    always computed. The packed vector still gives the host what it
    reads: the probation culls of its own points, the redundancies only
    past 3 keyframes."""
    ts = fixture["ts"]
    keys = []

    def dispatch_keys(m, kf_order, recent):
        calls = []
        fn = m._dispatch_fn.fn
        m._dispatch_fn.fn = lambda *args: calls.append(programs.program_key(*args)) or fn(*args)
        m.mp_valid_host[:70] = True
        _, pending = m.dispatch_keyframe(ts, kf_order[-1], list(recent), kf_order)
        return calls[0], pending

    ref, _ = dispatch_keys(_mapper(), list(range(5)), [(p, 3) for p in range(40, 70)])
    recent = [(p, 1) for p in range(40, 40 + 3 * n_live)] if n_live % 2 else []
    key, pending = dispatch_keys(_mapper(), list(range(n_live)), recent)
    assert key == ref
    assert pending.n_cull == len(recent) and pending.has_reds == (n_live > 3)
    assert pending.packed_host.shape[0] == 3 * 4 + P


