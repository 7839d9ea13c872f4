"""The loop fixture of tools/vocab_e2e.py and the sequence of
tools/long_sequence.py through each package, on each renderer's frames,
on the CPU: what the port's tools (orb_slam_cuda_tpu_torch/tools/
vocab_e2e.py, long_sequence.py) are held against.

vocab ENGINE RENDERER VOCAB [FRAMES]
    ENGINE's System (jax, port, or port:cuda on the card) on RENDERER's frames (cv2: the JAX
    package's renderer, as the JAX tool renders them; torch: the port's)
    of the vocab_e2e fixture (320x240, 800 features, the 8-wall room of
    seed 7, FRAMES (default 360) frames of 1.3 laps of radius 5 m, loop
    closing on, System seed 1), with VOCAB (stock: the 982k-word
    build/orbvoc_k10_L6.txt, generated if missing; synthetic: the
    engine's 512-word tree). The JAX System on cv2 frames is the JAX
    tool's run. Prints one line a frame (index, tracking state,
    keyframes, live map points, local-map inliers, relocalizations,
    loops), the loop closer's rounds (instrument_loops) and a RESULT line.
loop-dump OUT.pkl
    The JAX System on the port's frames with the stock vocabulary, to its
    first loop closure; pickles the detection round that closed it
    (loop_dump). JAX_PLATFORMS=cpu.
loop-inject IN.pkl DEVICE
    That round handed to the port's loop closer on DEVICE (cpu or cuda),
    with the reference's RANSAC draws and then with the port's own; no
    JAX needed (loop_inject).
step-dump OUT.pkl F1,F2,... [BA_BEFORE]
    The JAX System on the port's frames with the stock vocabulary; pickles
    its tracking step's inputs and result at frames F1, F2, ... and its
    last local BA before frame BA_BEFORE (step_dump). JAX_PLATFORMS=cpu.
step-inject IN.pkl DEVICE
    The port's tracking step and local BA on those inputs on DEVICE
    (step_inject).
longseq-cv2 DIR [FRAMES]
    Writes the JAX tool's sequence (its own generate(), cv2 renders) into
    DIR; the port's is written by its tool (long_sequence.generate).
longseq ENGINE DIR
    ENGINE's CLI on the TUM sequence in DIR on the CPU, scored as the
    tools score it; prints a RESULT line (tracked, loops, keyframes and
    relocalizations from the CLI's --diag file, ATE, extent).

Run as a script (JAX_PLATFORMS=cpu, from the repository root), 10-40
minutes each:
    python tests/torch_drivers_divergence.py vocab {jax,port,port:cuda} {cv2,torch} {stock,synthetic}
    python tests/torch_drivers_divergence.py longseq-cv2 build/longseq_cv2_520
    python tests/torch_drivers_divergence.py longseq {jax,port} build/longseq_520
"""

from __future__ import annotations

import csv
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tool(name: str):
    """The JAX package's tools/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def vocab_frames(renderer: str, n_frames: int, upto: int = None):
    """(poses, uint8 numpy frames) of the vocab_e2e fixture of `n_frames`
    from one renderer, the first `upto` of them if given."""
    from orb_slam_cuda_tpu_torch.tools import vocab_e2e as tve

    cam, scene, poses = tve.fixture(n_frames)
    poses = poses[:upto]
    K = np.asarray(cam.K)
    if renderer == "cv2":
        from orb_slam_cuda_tpu.utils import synthetic

        jscene = synthetic.room_scene(np.random.default_rng(7), half_size=9.0, tex_size=1024, n_walls=8)
        jposes = synthetic.circuit_trajectory(n_frames, radius=5.0, laps=tve.LAPS)[:upto]
        return jposes, [np.asarray(jscene.render(K, T, tve.W, tve.H)) for T in jposes]
    return poses, [scene.render(K, T, tve.W, tve.H, device="cpu").numpy() for T in poses]


def vocab_system(engine: str, vocab: str):
    """(System, feed) of the vocab_e2e configuration: the System and what
    turns a numpy frame into its input. ENGINE port:cuda is the port on
    the card."""
    from orb_slam_cuda_tpu_torch.tools import vocab_e2e as tve

    path = tve.vocab_path() if vocab == "stock" else None
    if engine == "jax":
        from orb_slam_cuda_tpu.engine import Sensor, System, SystemConfig
        from orb_slam_cuda_tpu.geometry.camera import Camera
        from orb_slam_cuda_tpu.vocab import load_orbvoc_text

        cam = Camera.create(fx=tve.FX, fy=tve.FX, cx=tve.W / 2, cy=tve.H / 2, width=tve.W, height=tve.H)
        cfg = SystemConfig(camera=cam, sensor=Sensor.MONOCULAR, n_features=800, max_keyframes=128,
                           max_points=16384, enable_loop_closing=True, max_frames_between_kf=30,
                           min_frames_between_kf=0)
        voc = load_orbvoc_text(path) if path else None
        return System(cfg, seed=1, vocab=voc), lambda f: f
    import torch

    from orb_slam_cuda_tpu_torch.engine import System
    from orb_slam_cuda_tpu_torch.vocab import load_orbvoc_text

    device = engine.partition(":")[2] or "cpu"
    cam = tve.fixture(1)[0]
    voc = load_orbvoc_text(path) if path else None
    return System(tve.system_config(cam), seed=1, vocab=voc, device=device), torch.as_tensor


def _host(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)


def instrument_loops(slam, engine: str) -> None:
    """Print every loop-detection round that reaches consistency chaining
    (LOOP: frame, BoW candidates, consistent candidates) and every Sim3
    candidate's gates (SIM3: RANSAC ok and inliers, the refined inliers,
    the loop group's projection matches), then the round's hit."""
    import contextlib
    import importlib

    pkg = "orb_slam_cuda_tpu" if engine == "jax" else "orb_slam_cuda_tpu_torch"
    lcm = importlib.import_module(f"{pkg}.engine.loop_closing")
    lc = slam.loop_closer
    chain, compute = lc._consistency_chain, lc._compute_sim3
    # Unwrapped, so that a second call does not log twice.
    ransac, refine, gate = (getattr(f, "__wrapped__", f) for f in (
        lcm.sim3_solver.solve_sim3_ransac, lcm.sim3_search_and_refine, lcm.loop_points_projection_gate))

    def logged_chain(cand_mask, covis):
        out = chain(cand_mask, covis)
        print("LOOP", slam.frame_id, "candidates", np.flatnonzero(_host(cand_mask)).tolist(), "consistent", out,
              flush=True)
        return out

    def logged_compute(state, kf_slot, cands):
        # The port's Sim3 stages are programs: the hooks below read back, so
        # on the card they run eagerly (a capture would refuse the reads).
        with (importlib.import_module(f"{pkg}.engine.programs").eager() if engine == "port"
              else contextlib.nullcontext()):
            out = compute(state, kf_slot, cands)
        print("LOOP", slam.frame_id, "kf", int(kf_slot), "hit", None if out is None else int(out[0]), flush=True)
        return out

    def logged_ransac(*a, **kw):
        res = ransac(*a, **kw)
        print("SIM3", slam.frame_id, "ransac ok", bool(_host(res.ok)), "inliers", int(_host(res.inliers).sum()),
              "pairs", int(_host(a[4]).sum()), flush=True)
        return res

    def logged_refine(*a, **kw):
        out = refine(*a, **kw)
        print("SIM3", slam.frame_id, "cand", int(a[2]), "refined inliers", int(_host(out[3])), flush=True)
        return out

    def logged_gate(*a, **kw):
        out = gate(*a, **kw)
        print("SIM3", slam.frame_id, "cand", int(a[2]), "projection matches", int(_host(out[0])), flush=True)
        return out

    logged_ransac.__wrapped__, logged_refine.__wrapped__, logged_gate.__wrapped__ = ransac, refine, gate
    lc._consistency_chain, lc._compute_sim3 = logged_chain, logged_compute
    lcm.sim3_solver.solve_sim3_ransac = logged_ransac
    lcm.sim3_search_and_refine, lcm.loop_points_projection_gate = logged_refine, logged_gate


def run_vocab(engine: str, renderer: str, vocab: str, n_frames: int = 360, trace: bool = True) -> dict:
    """One System over the fixture; its outcome as the tools report it."""
    from orb_slam_cuda_tpu_torch.utils.evaluation import ate_rmse, camera_centers

    poses, frames = vocab_frames(renderer, n_frames)
    slam, feed = vocab_system(engine, vocab)
    if trace:
        instrument_loops(slam, engine)
    first, lost = None, []
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        pose = slam.track_monocular(feed(f), i * 0.1)
        first = i if first is None and pose is not None else first
        if first is not None and pose is None:
            lost.append(i)
        if trace:
            print(i, slam.tracking_state.name, slam.stats.n_keyframes, int(_host(slam.state.mp_valid).sum()),
                  slam.n_inliers_local, slam.stats.n_reloc,
                  slam.loop_closer.n_loops_closed if slam.loop_closer else 0, flush=True)
    st = slam.get_status()
    wall = time.perf_counter() - t0
    ts, est = camera_centers(slam.get_trajectory())
    gt_by_t = {round(i * 0.1, 6): np.linalg.inv(T)[:3, 3] for i, T in enumerate(poses)}
    gt = np.asarray([gt_by_t[round(t, 6)] for t in ts])
    ate = float(ate_rmse(est, gt)) if len(est) >= 3 else None
    return dict(engine=engine, renderer=renderer, vocab=vocab, n_words=slam.vocab.n_words, frames=n_frames,
                first_pose=first, tracked=st["tracked_ratio"], loops=st["loops_closed"],
                relocalizations=st["relocalizations"], keyframes=st["keyframes"], ate_m=ate,
                lost=[lost[0], lost[-1], len(lost)] if lost else None, wall_s=round(wall, 1))


def loop_dump(out: str, vocab: str = "stock", n_frames: int = 360) -> dict:
    """Run the JAX System on the port's frames to its first loop closure
    and pickle what the loop closer had just before it: the map, the
    keyframe database, the detection round (keyframe slot, candidate mask,
    covisibility), the keyframe order, the closer's host state, the Sim3
    RANSAC draws it made (by seed, with the pairs they were drawn from)
    and its hit (candidate, Sim3)."""
    import pickle

    import jax.numpy as jnp

    from orb_slam_cuda_tpu.engine import loop_closing as jlc
    from orb_slam_cuda_tpu_torch.solvers.initializer import SAMPLE_SHAPES
    from torch_parity import jax_sets

    poses, frames = vocab_frames("torch", n_frames)
    slam, feed = vocab_system("jax", vocab)
    lc = slam.loop_closer
    finish, compute, ransac = lc.finish_detect, lc._compute_sim3, jlc.sim3_solver.solve_sim3_ransac
    seen = {"draws": {}}
    arrays = lambda nt: {f: np.asarray(getattr(nt, f)) for f in nt._fields}  # noqa: E731

    def recorded_ransac(*a, **kw):
        seed = int(np.asarray(jnp.asarray(a[6]))[1])  # PRNGKey(seed) holds seed in its low word
        pairs = np.asarray(a[4], bool)
        seen["draws"][seed] = (pairs, jax_sets(seed, pairs, *SAMPLE_SHAPES["sim3"]))
        return ransac(*a, **kw)

    def recorded_compute(state, kf_slot, cands):
        out = compute(state, kf_slot, cands)
        if out is not None:
            seen["hit"] = (int(out[0]), tuple(np.asarray(v) for v in out[1]))
        return out

    def recorded_finish(state, db, pending, kf_order):
        before = dict(state=arrays(state), db=arrays(db),
                      pending=(int(pending[0]), np.asarray(pending[1]), np.asarray(pending[2])),
                      kf_order=list(kf_order), consistent_groups=[(set(g), c) for g, c in lc.consistent_groups],
                      loop_edges=list(lc.loop_edges), frame=slam.frame_id,
                      counters={k: getattr(lc, k) for k in ("kf_seen", "last_loop_kf_seen", "n_loops_closed",
                                                            "gba_idx", "gba_requested")})
        seen["draws"] = {}
        out = finish(state, db, pending, kf_order)
        if lc.n_loops_closed > before["counters"]["n_loops_closed"] and "snapshot" not in seen:
            seen["snapshot"] = dict(before, draws=seen["draws"], hit=seen["hit"])
        return out

    lc.finish_detect, lc._compute_sim3 = recorded_finish, recorded_compute
    jlc.sim3_solver.solve_sim3_ransac = recorded_ransac
    for i, f in enumerate(frames):
        slam.track_monocular(feed(f), i * 0.1)
        if "snapshot" in seen:
            break
    snap = seen["snapshot"]
    with open(out, "wb") as fh:
        pickle.dump(snap, fh)
    return dict(frame=snap["frame"], kf=snap["pending"][0], hit=snap["hit"][0], s=float(snap["hit"][1][2]),
                candidates=np.flatnonzero(snap["pending"][1]).tolist(), draws=sorted(snap["draws"]))


def loop_inject(path: str, device: str, vocab: str = "stock", draws: str = "jax") -> dict:
    """Hand the JAX System's pickled detection round (loop_dump) to the
    port's loop closer on `device` and report what it does: the
    consistent candidates, each candidate's Sim3 gates, the hit and its
    Sim3 against JAX's. `draws`: "jax" replays the reference's RANSAC
    draws, "port" lets the port draw its own."""
    import pickle
    import types

    import torch

    from orb_slam_cuda_tpu_torch.utils import convert

    with open(path, "rb") as fh:
        snap = pickle.load(fh)
    slam, _ = vocab_system(f"port:{device}", vocab)
    lc = slam.loop_closer
    state = convert.map_state(types.SimpleNamespace(**snap["state"]), device)
    db = convert.bow_db(types.SimpleNamespace(**snap["db"]), device)
    kf_slot, cand_mask, covis = snap["pending"]
    pending = (kf_slot, convert.tensor(cand_mask, device), convert.tensor(covis, device))
    convert.loop_closer_state(types.SimpleNamespace(consistent_groups=snap["consistent_groups"],
                                                    loop_edges=snap["loop_edges"], **snap["counters"]), lc)
    pairs_equal = []
    if draws == "jax":
        def replay(site, seed, valid):
            pairs, sets = snap["draws"][int(seed)]
            pairs_equal.append(bool(np.array_equal(pairs, _host(valid).astype(bool))))
            return torch.as_tensor(sets, device=valid.device)

        lc.sampler = replay
    instrument_loops(slam, "port")
    hit = {}
    compute = lc._compute_sim3

    def kept(state, kf, cands):
        out = compute(state, kf, cands)
        hit["out"] = out
        return out

    lc._compute_sim3 = kept
    lc.finish_detect(state, db, pending, snap["kf_order"])
    out = hit.get("out")
    jc, (jR, jt, js) = snap["hit"]
    res = dict(device=device, draws=draws, frame=snap["frame"], kf=kf_slot, jax_hit=jc, port_hit=None,
               loops_closed=lc.n_loops_closed - snap["counters"]["n_loops_closed"], pairs_equal=pairs_equal)
    if out is not None:
        R, t, s = (_host(v).astype(np.float64) for v in out[1])
        res.update(port_hit=int(out[0]), s_jax=float(js), s_port=float(s), R_max_diff=float(np.abs(R - jR).max()),
                   t_max_diff=float(np.abs(t - jt).max()))
    return res


def _arrays(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def step_dump(out: str, at_frames, vocab: str = "stock", ba_before: int = None) -> dict:
    """Run the JAX System on the port's frames and pickle, for each frame
    of `at_frames`, its tracking step's arguments and result, and the last
    local BA it solved before frame `ba_before` (problem, keywords, result)."""
    import pickle

    from orb_slam_cuda_tpu.engine import tracking as jtr
    from orb_slam_cuda_tpu.solvers import bundle_adjust as jba

    _, frames = vocab_frames("torch", 360, upto=max(at_frames) + 1)
    slam, feed = vocab_system("jax", vocab)
    kept = {"steps": {}}
    step, solve = jtr.full_track_step, jba.bundle_adjust

    def kept_step(*a):
        res = step(*a)
        if slam.frame_id in at_frames:
            state, frame, *rest = a[:14]
            kept["steps"][slam.frame_id] = dict(
                state=_arrays(state), frame=_arrays(frame), cam=_arrays(a[12]),
                rest=[np.asarray(v) for v in rest[:10]], sf=np.asarray(a[13]),
                tail=[float(np.asarray(v)) for v in a[14:]], host_vec=np.asarray(res.host_vec),
                mp=np.asarray(res.mp))
        return res

    def kept_ba(problem, cam, *a, **kw):
        res = solve(problem, cam, *a, **kw)
        if ba_before is not None and slam.frame_id < ba_before:
            kept["ba"] = dict(problem=_arrays(problem), cam=_arrays(cam), a=a, kw=kw, frame=slam.frame_id,
                              cam_pose=np.asarray(res.cam_pose), xyz=np.asarray(res.xyz),
                              obs_inlier=np.asarray(res.obs_inlier))
        return res

    jtr.full_track_step, jba.bundle_adjust = kept_step, kept_ba
    try:
        for i, f in enumerate(frames):
            slam.track_monocular(feed(f), i * 0.1)
    finally:
        jtr.full_track_step, jba.bundle_adjust = step, solve
    with open(out, "wb") as fh:
        pickle.dump(kept, fh)
    return dict(steps=sorted(kept["steps"]), ba_frame=kept.get("ba", {}).get("frame"))


def step_inject(path: str, device: str) -> dict:
    """The port's tracking step and local BA on the JAX System's pickled
    inputs (step_dump), on `device`: the step's scalars (host_vec[:9]:
    the state, the inlier counts of its stages, the keyframe policy's
    inputs) and pose against JAX's, the bindings that differ; the BA's
    largest pose and point differences and the inlier flags that differ."""
    import pickle
    import types

    from orb_slam_cuda_tpu_torch.engine import tracking as ttr
    from orb_slam_cuda_tpu_torch.solvers import bundle_adjust as tba
    from orb_slam_cuda_tpu_torch.utils import convert

    with open(path, "rb") as fh:
        kept = pickle.load(fh)
    ns = lambda d: types.SimpleNamespace(**d)  # noqa: E731
    out = {}
    for frame, k in sorted(kept["steps"].items()):
        c = lambda x: convert.tensor(x, device)  # noqa: E731
        pose_pred, pose_last, uv, oct_, ang, bip, mp, depth, ref_kf, min_obs = k["rest"]
        tres = ttr.full_track_step(
            convert.map_state(ns(k["state"]), device), convert.frame_data(ns(k["frame"]), device), c(pose_pred),
            c(pose_last), c(uv), c(oct_), c(ang), c(bip), c(mp), c(depth), int(ref_kf), int(min_obs),
            convert.camera(ns(k["cam"])), tuple(float(v) for v in k["sf"]), *k["tail"])
        jv, tv = k["host_vec"], _host(tres.host_vec)
        out[f"step {frame}"] = dict(scalars_jax=jv[:9].astype(int).tolist(), scalars_port=tv[:9].astype(int).tolist(),
                                    pose_max_diff=float(np.abs(jv[9:25].astype(np.float64) - tv[9:25]).max()),
                                    bindings_differ=int((k["mp"] != _host(tres.mp)).sum()))
    if "ba" in kept:
        b = kept["ba"]
        tres = tba.bundle_adjust(convert.ba_problem(ns(b["problem"]), device), convert.camera(ns(b["cam"])),
                                 *b["a"], **b["kw"])
        out["local_ba"] = dict(frame=b["frame"], observations=int(b["problem"]["obs_valid"].sum()),
                               cam_pose_max_diff=float(np.abs(b["cam_pose"] - _host(tres.cam_pose)).max()),
                               xyz_max_diff=float(np.abs(b["xyz"] - _host(tres.xyz)).max()),
                               inlier_flags_differ=int((b["obs_inlier"] != _host(tres.obs_inlier)).sum()))
    return out


def longseq_cv2(root: str, n_frames: int = 520) -> None:
    """The JAX tool's generate() (cv2 renders) into `root`."""
    jls = jax_tool("long_sequence")
    jls.N_FRAMES, jls.ROOT = n_frames, root
    jls.generate()


def run_longseq(engine: str, root: str) -> dict:
    """ENGINE's CLI on the sequence in `root` on the CPU, scored as the
    port's tool scores it."""
    from orb_slam_cuda_tpu_torch.tools import long_sequence as tls

    tag = f"{engine}_cli"
    traj, diag = f"{root}/traj_{tag}.txt", f"{root}/diag_{tag}.csv"
    module = "orb_slam_cuda_tpu.run" if engine == "jax" else "orb_slam_cuda_tpu_torch.run"
    cmd = [sys.executable, "-m", module, "--dataset", "tum", "--sensor", "mono", "--sequence", root,
           "--settings", f"{root}/settings.yaml", "--save-tum", traj, "--diag", diag]
    if engine == "port":
        cmd += ["--device", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    with open(f"{root}/stderr_{tag}.log", "w") as f:
        f.write(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{module} failed with exit code {proc.returncode}:\n{proc.stderr[-3000:]}")
    cli = tls.parse_cli(proc.stderr)
    rows = list(csv.DictReader(open(diag)))
    states = [r["state"] for r in rows]
    first = next((i for i, s in enumerate(states) if s == "OK"), None)
    lost = [i for i, s in enumerate(states) if first is not None and i > first and s != "OK"]
    ate, extent, n = tls.score(root, traj)
    return dict(engine=engine, root=root, frames=len(rows), first_ok=first, tracked_pct=cli["tracked_pct"],
                loops=cli["loops_closed"], keyframes=int(rows[-1]["keyframes"]),
                relocalizations=int(rows[-1]["relocs"]), ate_m=ate, extent_m=extent,
                ate_pct_extent=None if ate is None else 100 * ate / extent, n_scored=n,
                lost=[lost[0], lost[-1], len(lost)] if lost else None, wall_s=round(wall, 1))


def main() -> int:
    sys.path.insert(0, REPO)
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "vocab":
        n = int(args[3]) if len(args) > 3 else 360
        print("RESULT", run_vocab(args[0], args[1], args[2], n), flush=True)
    elif mode == "loop-dump":
        print("RESULT", loop_dump(args[0]), flush=True)
    elif mode == "loop-inject":
        for draws in ("jax", "port"):
            print("RESULT", loop_inject(args[0], args[1], draws=draws), flush=True)
    elif mode == "step-dump":
        frames = [int(f) for f in args[1].split(",")]
        print("RESULT", step_dump(args[0], frames, ba_before=int(args[2]) if len(args) > 2 else None), flush=True)
    elif mode == "step-inject":
        print("RESULT", step_inject(args[0], args[1]), flush=True)
    elif mode == "longseq-cv2":
        longseq_cv2(args[0], int(args[1]) if len(args) > 1 else 520)
    elif mode == "longseq":
        print("RESULT", run_longseq(args[0], args[1]), flush=True)
    else:
        raise SystemExit(__doc__)
    return 0


if __name__ == "__main__":
    sys.exit(main())
