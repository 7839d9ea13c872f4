"""Multi-sequence work sharding (port of tools/multiseq_shard.py; the
`stereo_euroc` story of BASELINE.json: several flights through one
machine hall).

Each of 2 ranks tracks its OWN stereo sequence through the same 10-wall
hall (320x240, baseline 0.2 m, 800 features; 120 frames of an arc of
0.62 lap of radius 2.6 m, the second rank starting half a lap on) into a
rank-local map. The maps are saved; then every rank runs the same merge:
it locates the second map's keyframes in the first by BoW retrieval and a
fixed-scale Sim3 (parallel/map_merge.find_cross_map_link), merges the
maps, fuses the seam both ways, and polishes the merged map with a
global BA distributed over the 2-rank group (parallel/dist_ba.py).

Gates (the JAX tool's): both ranks track > 85% of their frames, the
ranks' merged poses are byte-equal, the fusion creates cross-map
covisibility edges, and the merged keyframe ATE (no scale alignment,
both sequences against ground truth) stays under twice the worse
rank's own ATE and under 0.40 m. Prints one JSON line.

Usage (from the repository root):
    python3 -m orb_slam_cuda_tpu_torch.tools.multiseq_shard [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

RANKS = 2
FRAMES_PER_RANK = 120
W, H = 320, 240
BASELINE_M = 0.2
RADIUS = 2.6
SEG_LAPS = 0.62  # each rank's arc; it overlaps the next rank's start


def rank_poses(rank: int):
    from ..utils import synthetic

    return synthetic.circuit_trajectory(FRAMES_PER_RANK, radius=RADIUS, laps=SEG_LAPS, start=0.5 * rank)


def rank_main(rank: int, world: int, device: str, tmp: str) -> dict:
    import torch.distributed as dist

    from ..engine import Sensor, System, SystemConfig
    from ..geometry.camera import Camera
    from ..io import checkpoint
    from ..parallel import map_merge
    from ..parallel.mesh import make_mesh
    from ..slam_map import MapConfig
    from ..slam_map import ops as map_ops
    from ..utils import synthetic
    from ..utils.evaluation import ate_rmse, camera_centers

    mesh = make_mesh(device=device)
    dev = mesh.device
    cam = Camera.create(fx=260.0, fy=260.0, cx=W / 2, cy=H / 2, bf=260.0 * BASELINE_M, width=W, height=H)
    scene = synthetic.room_scene(np.random.default_rng(7), half_size=6.0, tex_size=768, n_walls=10)
    poses = rank_poses(rank)
    cfg = SystemConfig(camera=cam, sensor=Sensor.STEREO, n_features=800, max_keyframes=96, max_points=12288,
                       enable_loop_closing=False)  # one arc does not loop
    slam = System(cfg, seed=1, device=dev)

    # Phase 1: each rank tracks its own sequence.
    t0 = time.perf_counter()
    for i, T in enumerate(poses):
        left, right = scene.render_stereo(cam.K, T, BASELINE_M, W, H, device=dev)
        slam.track_stereo(left, right, i * 0.1)
        dist.barrier()
    slam._flush_pipeline()
    track_wall = time.perf_counter() - t0
    ts_l, est_l = camera_centers(slam.get_trajectory())
    gt_l = np.asarray([np.linalg.inv(poses[int(round(t / 0.1))])[:3, 3] for t in ts_l])
    local_ate = float(ate_rmse(est_l, gt_l, with_scale=False))
    checkpoint.save_map(slam.state, slam.db, slam.kf_order, os.path.join(tmp, f"rank{rank}.npz"), extra={
        "kf_timestamps": np.asarray([slam.kf_timestamps.get(s, -1.0) for s in range(cfg.max_keyframes)]),
    })
    np.save(os.path.join(tmp, f"gt{rank}.npy"), np.asarray(poses))
    dist.barrier()

    # Phase 2: every rank runs the same merge, then the distributed BA.
    t1 = time.perf_counter()
    state_a, db_a, order_a, extra_a = checkpoint.load_map(os.path.join(tmp, "rank0.npz"), device=dev)
    state_b, db_b, order_b, extra_b = checkpoint.load_map(os.path.join(tmp, "rank1.npz"), device=dev)
    link = None
    for kf_b in order_b:
        kf_a, S_ab = map_merge.find_cross_map_link(
            state_a, db_a, state_b, int(kf_b), cam, slam.map_cfg.scale_factors, slam.map_cfg.level_sigma2,
            slam.vocab.n_words, fix_scale=True, word_weight=slam.vocab.word_weight)
        if kf_a is not None:
            link = (int(kf_b), kf_a, S_ab)
            break
    if link is None:
        raise RuntimeError("no cross-map link found")
    kf_b_link, kf_a_link, S_ab = link
    merged_cfg = MapConfig(max_keyframes=192, max_features=cfg.n_features, max_points=24576,
                           n_levels=slam.map_cfg.n_levels, scale_factor=slam.map_cfg.scale_factor)
    merged, _, order_m, kf_map, _ = map_merge.merge_maps(state_a, order_a, db_a, state_b, order_b, db_b,
                                                         S_ab, merged_cfg)
    # Seam fusion both ways, so that the merged BA sees cross-map
    # observations.
    covis_m = merged.covis.cpu().numpy()
    b_slots = set(kf_map.values())
    a_group = sorted(({kf_a_link} | set(np.flatnonzero(covis_m[kf_a_link] > 0).tolist())) & set(order_a))
    b_link = kf_map[kf_b_link]
    b_group = sorted(({b_link} | set(np.flatnonzero(covis_m[b_link] > 0).tolist())) & b_slots)
    masks = []
    for group in (a_group, b_group):
        m = torch.zeros(merged_cfg.max_keyframes, dtype=torch.bool, device=dev)
        m[group] = True
        masks.append(m)
    pts_a = map_ops.points_of_keyframes(merged, masks[0])
    pts_b = map_ops.points_of_keyframes(merged, masks[1])
    sf = slam.map_cfg.scale_factors
    merged = map_merge.fuse_seam(merged, merged_cfg, b_group, pts_a, cam, sf)
    merged = map_merge.fuse_seam(merged, merged_cfg, a_group, pts_b, cam, sf)
    covis_f = merged.covis.cpu().numpy()
    cross_edges = int((covis_f[np.ix_(sorted(set(order_a)), sorted(b_slots))] > 0).sum())
    merged_ba = map_merge.merged_global_ba(merged, order_m, merged_cfg, cam, mesh=mesh, lm_iters=10, cg_iters=20)
    kf_pose = merged_ba.kf_pose.cpu().numpy()
    merge_wall = time.perf_counter() - t1

    # Merged keyframe ATE against both sequences' ground truth.
    gt = [np.load(os.path.join(tmp, f"gt{r}.npy")) for r in range(RANKS)]
    ts = [np.asarray(extra_a["kf_timestamps"]), np.asarray(extra_b["kf_timestamps"])]
    b_of = {m: b for b, m in kf_map.items()}
    est, ref = [], []
    for slot in order_m:
        src, s = (1, b_of[slot]) if slot in b_of else (0, slot)
        t = float(ts[src][s])
        if t < 0:
            continue
        est.append(np.linalg.inv(kf_pose[slot].astype(np.float64))[:3, 3])
        ref.append(np.linalg.inv(gt[src][int(round(t / 0.1))])[:3, 3])
    ate = float(ate_rmse(np.asarray(est), np.asarray(ref), with_scale=False))
    dist.barrier()
    return dict(rank=rank, device=str(dev), backend=dist.get_backend(), tracked_ratio=slam.tracked_ratio(),
                keyframes_local=len(slam.kf_order), frames=FRAMES_PER_RANK, track_wall_s=track_wall,
                rank_fps=FRAMES_PER_RANK / track_wall, merge_wall_s=merge_wall, merged_kfs=len(order_m),
                link=[kf_b_link, kf_a_link], merged_ate_m=ate, local_ate_m=local_ate, cross_covis_edges=cross_edges,
                merged_sha256=hashlib.sha256(kf_pose.tobytes()).hexdigest())


def run(device="cuda") -> dict:
    from ..parallel.multihost import run_ranks
    from ..utils.device import resolve

    device = str(resolve(device))
    with tempfile.TemporaryDirectory() as tmp:
        outs = run_ranks(rank_main, RANKS, (device, tmp), root=os.path.join(tmp, "ranks"), device=device)
    agree = outs[0]["merged_sha256"] == outs[1]["merged_sha256"]
    total = sum(o["frames"] for o in outs)
    worst_local = max(o["local_ate_m"] for o in outs)
    m = outs[0]
    ok = (agree and all(o["tracked_ratio"] > 0.85 for o in outs) and m["cross_covis_edges"] > 0
          and m["merged_ate_m"] < 2.0 * worst_local and m["merged_ate_m"] < 0.40)
    return dict(
        metric="multiseq_shard", ok=bool(ok), ranks_agree=agree, processes=RANKS, backend=m["backend"],
        rank_devices=[o["device"] for o in outs], total_frames=total,
        total_fps_parallel_phase=total / max(o["track_wall_s"] for o in outs),
        rank_fps=[o["rank_fps"] for o in outs], tracked_ratio=[o["tracked_ratio"] for o in outs],
        keyframes_local=[o["keyframes_local"] for o in outs], merged_kfs=m["merged_kfs"], link=m["link"],
        merged_ate_m=m["merged_ate_m"], local_ate_m=[o["local_ate_m"] for o in outs],
        cross_covis_edges=m["cross_covis_edges"], merge_wall_s=m["merge_wall_s"],
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    result = run(args.device)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
