"""The keyframe path's programs and the DLT kernel (ops/dlt_kernel.py).

On the CPU the kernel's wrapper takes its plain version (`eigh`) and
launches nothing. On the card (marked `cuda`):

- the kernel against its plain version at N = 2000 points: two KITTI
  cameras 0.5 m apart, points 5-40 m away projected into both with 0.5 px
  of noise, as the mapper's triangulation hands them over. On the points
  in front of both cameras, the relative error of a point is at most 1e-4
  against the plain version computed in float64 (the kernel's Jacobi runs
  in double; what is left is the float32 inputs and output) and at most
  1e-2 against the plain version in float32 (whose `eigh` rounds its own
  way, ~1e-4 here);
- each keyframe program (the mapper's dispatch, BA round 2 and erase;
  keyframe insertion and depth points; loop detection and a global-BA
  chunk) on tests/torch_mapping_fixture.py's map: its first call (eager,
  then the capture), a replay on the same inputs and a replay on a second
  set with the same key (another keyframe slot; for the dispatch also
  another slot matrix and probation set) torch.equal to the same calls
  under `programs.eager()`, so that a value frozen into a graph shows;
  and the DLT launched inside the dispatch's replays;
- a point-capacity grow makes the dispatch recapture, and the new graph
  replays torch.equal to eager.

This file imports no JAX:

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_mapping_card.py
"""

import numpy as np
import pytest
import torch

from orb_slam_cuda_tpu_torch.engine import Sensor, System, SystemConfig, programs
from orb_slam_cuda_tpu_torch.engine import local_mapping as tlm
from orb_slam_cuda_tpu_torch.engine import loop_closing as tlc
from orb_slam_cuda_tpu_torch.geometry import triangulate
from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.ops import dlt_kernel
from orb_slam_cuda_tpu_torch.slam_map import keyframe_db as tdb
from orb_slam_cuda_tpu_torch.slam_map import ops as tops
from orb_slam_cuda_tpu_torch.slam_map import state as tst
from torch_mapping_fixture import CAM_ARGS, K, N, N_LIVE, P, arrays

torch.set_num_threads(2)
NEW = N_LIVE - 1
CFG = tst.MapConfig(max_keyframes=K, max_features=N, max_points=P)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the DLT kernel and CUDA graphs have no CPU or interpret mode")
    return torch.device("cuda")


def _dlt_inputs(device, n=2000, seed=0):
    rng = np.random.default_rng(seed)
    P1 = np.array([[718.856, 0, 607.1928, 0], [0, 718.856, 185.2157, 0], [0, 0, 1, 0]], np.float32)
    P2 = P1.copy()
    P2[0, 3] = -0.5 * 718.856
    X = rng.uniform([-10, -3, 5], [10, 3, 40], (n, 3))
    Xh = np.concatenate([X, np.ones((n, 1))], 1)

    def proj(P):
        y = Xh @ P.T.astype(np.float64)
        return (y[:, :2] / y[:, 2:] + rng.normal(0, 0.5, (n, 2))).astype(np.float32)

    return [torch.as_tensor(a, device=device) for a in (P1, P2, proj(P1), proj(P2))]


def test_dlt_wrapper_on_cpu_takes_the_plain_version():
    args = _dlt_inputs("cpu", n=64)
    before = dlt_kernel.launches
    got = triangulate.triangulate_dlt(*args)
    assert dlt_kernel.launches == before
    assert torch.equal(got, triangulate.triangulate_dlt_plain(*args))


@pytest.mark.cuda
def test_dlt_kernel_against_plain():
    dev = _card()
    P1, P2, xy1, xy2 = _dlt_inputs(dev)
    before = dlt_kernel.launches
    got = dlt_kernel.triangulate_dlt(P1, P2, xy1, xy2)
    torch.cuda.synchronize()
    assert dlt_kernel.launches == before + 1
    f32 = triangulate.triangulate_dlt_plain(P1, P2, xy1, xy2)
    f64 = triangulate.triangulate_dlt_plain(P1.double(), P2.double(), xy1.double(), xy2.double())
    front = (f64[:, 2] > 0) & torch.isfinite(got).all(-1)
    assert int(front.sum()) > 1900

    def rel(b):
        d = torch.linalg.norm(got.double() - b.double(), dim=-1) / torch.linalg.norm(b.double(), dim=-1)
        return float(d[front].max())

    assert rel(f64) <= 1e-4, rel(f64)
    assert rel(f32) <= 1e-2, rel(f32)


@pytest.fixture(scope="module")
def card_map():
    dev = _card()
    arr = arrays()
    st = tst.MapState(**{k: torch.as_tensor(v.view(np.int32) if v.dtype == np.uint32 else v, device=dev)
                         for k, v in arr.items()})
    st = tops.update_point_stats(tops.refresh_covis_rows(st, torch.arange(K, device=dev)), CFG)
    db = tdb.empty(K, N, dev)
    for k in range(N_LIVE):
        db = tdb.insert(db, k, *tdb.compute_bow_row(st.kf_word[k], torch.ones(N, device=dev), st.kf_feat_valid[k]))
    return st, db


def _slot(k, dev):
    return torch.full((), k, dtype=torch.int64, device=dev)


def _flat(out):
    leaves = []
    programs._flatten(out, leaves)
    return leaves


def _graphed_equals_eager(program, args, args2=None):
    """`program` on `args` (eager + capture), on `args` again and on
    `args2` (two replays of one graph), each torch.equal to eager."""
    args2 = args if args2 is None else args2
    assert programs.program_key(*args) == programs.program_key(*args2)
    with programs.eager():
        refs = [_flat(program(*a)) for a in (args, args2)]
    before = program.stats()
    outs = [_flat(program(*a)) for a in (args, args, args2)]
    torch.cuda.synchronize()
    stats = program.stats()
    assert stats["captures"] - before["captures"] == 1 and stats["replays"] - before["replays"] == 2
    for ref, out in zip((refs[0], refs[0], refs[1]), outs):
        assert len(out) == len(ref) and all(torch.equal(a, b) for a, b in zip(ref, out)), program.name
    if args2 is not args:  # the second inputs change the result
        assert not all(torch.equal(a, b) for a, b in zip(*refs)), program.name


def _mapper(dev):
    return tlm.LocalMapper(CFG, Camera.create(**CAM_ARGS), n_triangulate_neighbors=4, n_fuse_neighbors=8,
                           lba_local=5, lba_fixed=2, lba_points=256, device=dev)


def _dispatch_args(st, dev, slot=NEW, first_point=1000, probation=range(12), probation_age=2):
    slot_matrix = torch.arange(first_point, first_point + 4 * 256, device=dev).reshape(4, 256)
    on = torch.as_tensor(list(probation), device=dev)
    prob = torch.zeros(st.mp_valid.shape[0], dtype=torch.bool, device=dev)
    prob[on] = True
    age = torch.zeros(st.mp_valid.shape[0], dtype=torch.int32, device=dev)
    age[on] = probation_age
    ids = torch.full((256,), -1, dtype=torch.int32, device=dev)
    ids[:len(on)] = on.int()
    return st, _slot(slot, dev), slot_matrix, (prob, age, ids), 4, 8


def _keyframe_frame(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    n = 600
    return (torch.rand((n, 2), generator=g, device=dev) * 300, torch.full((n,), -1.0, device=dev),
            torch.rand(n, generator=g, device=dev) * 7 + 1, torch.zeros(n, dtype=torch.int32, device=dev),
            torch.zeros(n, device=dev), torch.randint(0, 2**31 - 1, (n, 8), generator=g, device=dev).int(),
            torch.ones(n, dtype=torch.bool, device=dev), torch.randint(0, 40, (n,), generator=g, device=dev).int(),
            torch.randint(0, 6, (n,), generator=g, device=dev).int(),
            torch.full((n,), -1, dtype=torch.int32, device=dev), torch.ones(n, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["map_dispatch", "map_ba2", "map_erase", "kf_insert", "depth_points",
                                     "loop_detect", "gba_chunk"])
def test_keyframe_program_graphed_equals_eager(card_map, program):
    st, db = card_map
    dev = st.device
    if program.startswith("map_"):
        m = _mapper(dev)
        args = _dispatch_args(st, dev)
        # Another keyframe, slot matrix, probation set and ages.
        args2 = _dispatch_args(st, dev, slot=NEW - 1, first_point=100, probation=range(20, 36), probation_age=1)
        if program == "map_dispatch":
            before = dlt_kernel.launches
            _graphed_equals_eager(m._dispatch_fn, args, args2)
            # 4 neighbours in each of 2 eager calls, the capturing call and 2 replays.
            assert dlt_kernel.launches - before == 5 * 4
            return
        if program == "map_ba2":
            with programs.eager():
                outs = [m._dispatch_fn(*a) for a in (args, args2)]
            _graphed_equals_eager(m._ba2_fn, (outs[0][0], *outs[0][2:]), (outs[1][0], *outs[1][2:]))
            return
        masks = torch.zeros((2, K), dtype=torch.bool, device=dev)
        masks[0, 2] = masks[1, 4] = True
        _graphed_equals_eager(m._erase_fn, (st, db, masks[0]), (st, db, masks[1]))
        return
    if program in ("kf_insert", "depth_points"):
        slam = System(SystemConfig(camera=Camera.create(**CAM_ARGS, bf=40.0), sensor=Sensor.RGBD, n_features=600,
                                   max_keyframes=K, max_points=P, enable_loop_closing=False))
        pose2 = torch.eye(4, device=dev)
        pose2[:3, 3] = torch.tensor([0.1, -0.05, 0.2], device=dev)
        ins = [(slam.state, slam.db, _keyframe_frame(dev, seed), _slot(slot, dev), pose,
                torch.full((), frame_id, dtype=torch.int32, device=dev))
               for seed, slot, pose, frame_id in ((3, 3, torch.eye(4, device=dev), 42), (4, 5, pose2, 57))]
        if program == "kf_insert":
            _graphed_equals_eager(slam._kf_insert_fn, *ins)
        else:
            with programs.eager():
                st3 = [slam._kf_insert_fn(*a)[0] for a in ins]
            _graphed_equals_eager(
                slam._depth_points_fn,
                (st3[0], _slot(3, dev), torch.full((), 5.0, device=dev), torch.arange(100, 612, device=dev)),
                (st3[1], _slot(5, dev), torch.full((), 4.0, device=dev), torch.arange(700, 1212, device=dev)))
        return
    lc = tlc.LoopCloser(CFG, Camera.create(**CAM_ARGS), type("Vocab", (), {"n_words": 12})())
    if program == "loop_detect":
        # Keyframes 0 and 1 unbound, so that they are candidates (not
        # covisible neighbours): slot 6 finds one, slot 3 both.
        st = st._replace(kf_mp=torch.where(torch.arange(K, device=dev)[:, None] < 2, -1, st.kf_mp))
        _graphed_equals_eager(lc._detect_fn, (st, db, _slot(NEW, dev)), (st, db, _slot(NEW - 3, dev)))
    else:
        problem, _ = lc.global_ba_problem(st, list(range(N_LIVE)))
        problem2 = problem._replace(xyz=problem.xyz + 0.01)
        _graphed_equals_eager(lc._chunk_fn, (problem, 3), (problem2, 3))


@pytest.mark.cuda
def test_capacity_grow_recaptures(card_map):
    st, _ = card_map
    dev = st.device
    m = _mapper(dev)
    for state in (st, tst.grow_points(st, 2 * P)):
        before = m._dispatch_fn.stats()["captures"]
        _graphed_equals_eager(m._dispatch_fn, _dispatch_args(state, dev),
                              _dispatch_args(state, dev, slot=NEW - 1, first_point=100))
        assert m._dispatch_fn.stats()["captures"] == before + 1
    m._dispatch_fn.clear()
    assert m._dispatch_fn.stats()["graphs"] == 0
    _graphed_equals_eager(m._dispatch_fn, _dispatch_args(st, dev))
