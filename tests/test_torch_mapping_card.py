"""The keyframe path's programs and the DLT kernel (ops/dlt_kernel.py).

On the CPU the kernel's wrappers take their plain versions (`eigh`) and
launch nothing. On the card (marked `cuda`):

- the DLT entry against its plain version at N = 2000 points: two KITTI
  cameras 0.5 m apart, points 5-40 m away projected into both with 0.5 px
  of noise, as the mapper's triangulation hands them over. On the points
  in front of both cameras, the relative error of a point is at most 1e-4
  against the plain version computed in float64 (the kernel's Jacobi runs
  in double; what is left is the float32 inputs and output) and at most
  1e-2 against the plain version in float32 (whose `eigh` rounds its own
  way, ~1e-4 here);
- the convergence exit: on points up to 10 km away (ill-conditioned
  systems) within 1e-4 of float64 and within 1e-6 of the same kernel
  built to run all 8 sweeps;
- the gated entry (the mapper's whole triangulation after the match) on
  the same two views, 5% of the points 150 m-10 km away, 80% matched
  into a shuffled neighbour with octaves 0-7: its points as the DLT
  entry's (1e-4 against float64, 1e-2 against float32 `eigh`), its `ok`
  equal to the plain gate stage on the kernel's own points but for at
  most 2 points (torch's float32 ops on the card may round a value on a
  threshold the other way), parting from the all-plain version on at
  most 2% of matched points, one launch a call; on the map below,
  `triangulate_with_neighbor` launches the gated entry once and at most
  one device kernel after it (feat_new's arange): nothing after the match
  runs op by op;
- the gated entry on tests/torch_mapping_fixture.py's degenerate cases
  (unmatched, behind both cameras, zero parallax, |w| clamped, the scale
  check's edges, octaves out of range), next to its plain version on the
  card: `ok` as expected and equal, the points within 1e-3 where they are
  well posed, the |w| clamp's point equal to the CPU's;
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
from torch_mapping_fixture import CAM_ARGS, DEGENERATE_CASES, K, N, N_LIVE, P, arrays, degenerate

torch.set_num_threads(2)
NEW = N_LIVE - 1
CFG = tst.MapConfig(max_keyframes=K, max_features=N, max_points=P)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the DLT kernel and CUDA graphs have no CPU or interpret mode")
    return torch.device("cuda")


KITTI = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, width=1241, height=376)


def _two_view(n, seed, far):
    """The camera, the world-to-camera poses T1, T2 (the second camera
    0.5 m to the right) and the image points xy1, xy2 (n,2) of `n` points
    5-40 m in front of two KITTI cameras, a share `far` of them moved 30-250
    times further out, projected with 0.5 px of noise."""
    rng = np.random.default_rng(seed)
    cam = Camera.create(**KITTI)
    T1, T2 = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    T2[0, 3] = -0.5
    X = rng.uniform([-10, -3, 5], [10, 3, 40], (n, 3))
    if far:
        out = rng.random(n) < far
        X[out] *= rng.uniform(30, 250, (int(out.sum()), 1))
    Xh = np.concatenate([X, np.ones((n, 1))], 1)

    def proj(T):
        y = Xh @ (cam.K.astype(np.float64) @ T[:3].astype(np.float64)).T
        return (y[:, :2] / y[:, 2:] + rng.normal(0, 0.5, (n, 2))).astype(np.float32)

    return cam, T1, T2, proj(T1), proj(T2)


def _dlt_inputs(device, n=2000, seed=0, far=0.0):
    """triangulate_dlt's arguments P1, P2 (3,4), xy1, xy2 (n,2) for
    `_two_view`'s points, as the mapper's triangulation hands them over."""
    cam, T1, T2, xy1, xy2 = _two_view(n, seed, far)
    return [torch.as_tensor(np.ascontiguousarray(a), device=device) for a in (cam.K @ T1[:3], cam.K @ T2[:3], xy1, xy2)]


def _gated_inputs(device, n=2000, seed=0) -> dict:
    """triangulate_gated's arguments for `_two_view`'s points, 5% of them
    far: 80% of the new keyframe's features matched into a shuffled
    neighbour (the rest -1, whose neighbour features are other points'
    views), octaves 0-7, the neighbour's octave the match's or one off."""
    cam, T1, T2, xy1, xy2 = _two_view(n, seed, 0.05)
    rng = np.random.default_rng(seed + 1)
    perm = rng.permutation(n)
    matched = rng.random(n) < 0.8
    idx = np.where(matched, perm, -1)
    uv2 = np.empty((n, 2), np.float32)
    uv2[perm] = xy2[rng.permutation(n)]  # unmatched slots: someone else's view
    uv2[perm[matched]] = xy2[matched]
    oct1 = rng.integers(0, 8, n).astype(np.int32)
    oct2 = np.empty(n, np.int32)
    oct2[perm] = np.clip(oct1 + rng.integers(-1, 2, n), 0, 7)
    cfg = tst.MapConfig()
    t = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    return dict(cam=cam, T1=t(T1), T2=t(T2), xy1=t(xy1), uv2=t(uv2), idx=t(idx, torch.int64), oct1=t(oct1),
                oct2=t(oct2), sig2=t(cfg.level_sigma2, torch.float32), sf=t(cfg.scale_factors, torch.float32))


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


def _rel(a, b, mask):
    d = torch.linalg.norm(a.double() - b.double(), dim=-1) / torch.linalg.norm(b.double(), dim=-1)
    return float(d[mask].max())


@pytest.mark.cuda
def test_dlt_convergence_exit_against_float64_and_eight_sweeps():
    dev = _card()
    P1, P2, xy1, xy2 = _dlt_inputs(dev, seed=3, far=0.05)
    got = dlt_kernel.triangulate_dlt(P1, P2, xy1, xy2)
    eight = dlt_kernel.bind(dlt_kernel.build(("-DDLT_EARLY_EXIT=0",))[0])
    full = torch.empty_like(got)
    assert eight.triangulate_dlt(P1.data_ptr(), P2.data_ptr(), xy1.data_ptr(), xy2.data_ptr(), full.data_ptr(),
                                 xy1.shape[0], torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    f64 = triangulate.triangulate_dlt_plain(P1.double(), P2.double(), xy1.double(), xy2.double())
    front = (f64[:, 2] > 0) & torch.isfinite(got).all(-1)
    assert int(front.sum()) > 1900 and float(f64[front, 2].max()) > 1000  # the far points are in
    assert _rel(got, f64, front) <= 1e-4, _rel(got, f64, front)
    assert _rel(got, full, front) <= 1e-6, _rel(got, full, front)


@pytest.mark.cuda
def test_gated_kernel_against_plain():
    dev = _card()
    g = _gated_inputs(dev)
    dlt0, gated0 = dlt_kernel.launches, dlt_kernel.gated.launches
    xyz, ok = dlt_kernel.triangulate_gated(**g)
    torch.cuda.synchronize()
    assert dlt_kernel.gated.launches == gated0 + 1 and dlt_kernel.launches == dlt0
    j = torch.clamp(g["idx"], min=0)
    xy2 = g["uv2"][j].contiguous()
    K = g["cam"].K_on(dev)
    P1, P2 = triangulate.projection_matrix(K, g["T1"]), triangulate.projection_matrix(K, g["T2"])
    f64 = triangulate.triangulate_dlt_plain(P1.double(), P2.double(), g["xy1"].double(), xy2.double())
    want_xyz, want_ok = triangulate.triangulate_gated_plain(**g)
    matched = g["idx"] >= 0
    assert int(ok.sum()) > 500 and bool((ok <= matched).all())
    front = matched & (f64[:, 2] > 0) & torch.isfinite(xyz).all(-1)
    assert _rel(xyz, f64, front) <= 1e-4, _rel(xyz, f64, front)
    both = ok & want_ok
    assert _rel(xyz, want_xyz, both) <= 1e-2, _rel(xyz, want_xyz, both)
    stage = triangulate.triangulation_gates(g["cam"], xyz, g["T1"], g["T2"], g["xy1"], xy2, matched, g["oct1"],
                                            g["oct2"][j], g["sig2"], g["sf"])
    assert int((stage != ok).sum()) <= 2, int((stage != ok).sum())
    assert int((want_ok != ok).sum()) <= 0.02 * int(matched.sum())
    # Unmatched features gated out however their feature-0 pairing falls.
    assert not bool(ok[~matched].any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", DEGENERATE_CASES)
def test_gated_kernel_degenerate_cases_against_plain(case):
    dev = _card()
    T1, T2, xy1, uv2, idx, oct1, oct2, expect = degenerate(case)
    cfg = tst.MapConfig()
    host = (torch.as_tensor(T1), torch.as_tensor(T2), torch.as_tensor(xy1), torch.as_tensor(uv2),
            torch.as_tensor(idx), torch.as_tensor(oct1), torch.as_tensor(oct2),
            torch.tensor(cfg.level_sigma2, dtype=torch.float32), torch.tensor(cfg.scale_factors, dtype=torch.float32))
    cam = Camera.create(**CAM_ARGS)
    args = (cam, *(a.to(dev) for a in host))
    before = dlt_kernel.gated.launches
    xyz, ok = dlt_kernel.triangulate_gated(*args)
    want_xyz, want_ok = triangulate.triangulate_gated_plain(*args)
    torch.cuda.synchronize()
    assert dlt_kernel.gated.launches == before + 1
    assert ok.tolist() == expect and want_ok.tolist() == expect
    if case == "w_clamped":  # A = 0: the clamp's point, as the CPU's plain version gives it
        assert torch.equal(xyz.cpu(), triangulate.triangulate_gated_plain(cam, *host)[0])
    elif case in ("behind", "scale_edge"):  # well posed: the points themselves
        assert torch.allclose(xyz, want_xyz, rtol=1e-3, atol=1e-4), (xyz, want_xyz)


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
            before = dlt_kernel.gated.launches
            _graphed_equals_eager(m._dispatch_fn, args, args2)
            # 4 neighbours in each of 2 eager calls, the capturing call and 2 replays.
            assert dlt_kernel.gated.launches - before == 5 * 4
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


@pytest.mark.cuda
def test_triangulation_after_the_match_is_one_launch(card_map):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    st, _ = card_map
    m = _mapper(st.device)
    args = (st, NEW, NEW - 1, m.cam, m.scale_factors, m.level_sigma2)
    tlm.triangulate_with_neighbor(*args)  # builds and loads the kernels outside the profile
    torch.cuda.synchronize()
    dlt0, gated0 = dlt_kernel.launches, dlt_kernel.gated.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tri = tlm.triangulate_with_neighbor(*args)
        torch.cuda.synchronize()
    assert dlt_kernel.gated.launches == gated0 + 1 and dlt_kernel.launches == dlt0
    kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    at = [i for i, e in enumerate(kernels) if "triangulate_gated" in e.name]
    assert len(at) == 1, [e.name for e in kernels]
    assert len(kernels) - at[0] - 1 <= 1, [e.name for e in kernels[at[0]:]]  # feat_new's arange at most
    assert int(tri.ok.sum()) > 0
