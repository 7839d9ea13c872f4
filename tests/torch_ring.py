"""The drifted-ring loop-closing map of tests/test_loop_closing.py, built
with the port's own code on any device (no JAX): a ring of keyframes
inside a cylinder of wall points, poses integrating noisy odometry, and
the two revisiting keyframes holding fresh duplicates of the start's
points. Same draws from `rng` in the same order as the reference's
`build_drifted_ring`, so both make the same map. Also `padded_pose_graph`,
an essential graph on a ring with padded edges among its real ones."""

from __future__ import annotations

import numpy as np
import torch

from orb_slam_cuda_tpu_torch.geometry import se3
from orb_slam_cuda_tpu_torch.geometry.camera import Camera
from orb_slam_cuda_tpu_torch.slam_map import MapConfig, keyframe_db
from orb_slam_cuda_tpu_torch.slam_map import ops as map_ops
from orb_slam_cuda_tpu_torch.slam_map import state as mstate
from orb_slam_cuda_tpu_torch.vocab import build_vocabulary

CAM = Camera.create(fx=320.0, fy=320.0, cx=200.0, cy=150.0, width=400, height=300)
CFG = MapConfig(max_keyframes=32, max_features=256, max_points=2048, n_levels=4)


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def build_drifted_ring(rng, n_kf: int = 16, drift: float = 0.02, device="cpu"):
    """Returns (state, db, T_true, T_est, vocab) on `device`."""
    n_pts = 800
    ang = rng.uniform(0, 2 * np.pi, n_pts)
    pts_true = np.stack([6.0 * np.sin(ang), rng.uniform(-2, 2, n_pts), -6.0 * np.cos(ang)], -1)
    pts_true = pts_true.astype(np.float32)
    desc = rng.integers(0, 2**32, (n_pts, 8), dtype=np.uint32).view(np.int32)
    pt_angle = rng.uniform(0, 360, n_pts).astype(np.float32)

    T_true = []
    for k in range(n_kf):
        th = 2 * np.pi * k / n_kf
        Rwc = se3.so3_exp(_f32([0, th, 0])).numpy()
        c = np.array([1.2 * np.sin(th), 0.0, -1.2 * np.cos(th) + 1.2])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rwc.T
        T[:3, 3] = -Rwc.T @ c
        T_true.append(T)
    T_est = [T_true[0]]
    for k in range(1, n_kf):
        noise = se3.exp(_f32(rng.normal(0, drift, 6))).numpy()
        T_est.append(noise @ (T_true[k] @ np.linalg.inv(T_true[k - 1])) @ T_est[-1])

    vocab = build_vocabulary(rng.integers(0, 2**32, (1024, 8), dtype=np.uint32).view(np.int32),
                             k=8, depth=2, levelsup_depth=1)
    word_n, node_n, idf_n = (a.numpy() for a in vocab.transform(torch.as_tensor(desc)))

    N, K_np, revisit_from = CFG.max_features, CAM.K, n_kf - 2
    pt_slot_of = np.full(n_pts, -1, np.int64)
    dup_slot_of = np.full(n_pts, -1, np.int64)
    slot_xyz, slot_src, slot_first = {}, {}, {}

    def store_point(p, k):
        slot = len(slot_xyz)
        Xc = pts_true[p] @ T_true[k][:3, :3].T + T_true[k][:3, 3]
        Te = T_est[k]
        slot_xyz[slot] = (Xc - Te[:3, 3]) @ Te[:3, :3]
        slot_src[slot], slot_first[slot] = p, k
        return slot

    st = mstate.empty(CFG, device)
    db = keyframe_db.empty(CFG.max_keyframes, CFG.max_features, device)
    dev = lambda a, dtype=None: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    for k in range(n_kf):
        Xc = pts_true @ T_true[k][:3, :3].T + T_true[k][:3, 3]
        uv = (Xc / Xc[:, 2:3]) @ K_np.T
        vis = (Xc[:, 2] > 1.0) & (uv[:, 0] >= 10) & (uv[:, 0] < 390) & (uv[:, 1] >= 10) & (uv[:, 1] < 290)
        vis_idx = np.flatnonzero(vis)[:N]
        n_v = len(vis_idx)
        mp_row = np.full(N, -1, np.int32)
        uv_row = np.zeros((N, 2), np.float32)
        for i, p in enumerate(vis_idx):
            if k < revisit_from:
                if pt_slot_of[p] < 0:
                    pt_slot_of[p] = store_point(p, k)
                slot = pt_slot_of[p]
            elif dup_slot_of[p] >= 0:
                slot = dup_slot_of[p]
            elif pt_slot_of[p] >= 0 and slot_first[pt_slot_of[p]] >= revisit_from - 3:
                slot = pt_slot_of[p]
            else:
                dup_slot_of[p] = store_point(p, k)
                slot = dup_slot_of[p]
            mp_row[i] = slot
            xc = slot_xyz[slot] @ T_est[k][:3, :3].T + T_est[k][:3, 3]
            uv_row[i] = (K_np @ (xc / xc[2]))[:2]

        def row(src, fill, dtype):
            out = np.full((N,) + src.shape[1:], fill, dtype)
            out[:n_v] = src[vis_idx]
            return out

        valid_row = np.arange(N) < n_v
        word_row, idf_row = row(word_n, -1, np.int32), row(idf_n, 0.0, np.float32)
        st = mstate.insert_keyframe(
            st, k, dev(T_est[k], torch.float32), k, dev(uv_row), dev(np.full(N, -1.0, np.float32)),
            dev(np.full(N, -1.0, np.float32)), dev(np.zeros(N, np.int32)),
            dev(row(pt_angle, 0.0, np.float32)), dev(row(desc, 0, np.int32)), dev(valid_row),
            dev(word_row), dev(row(node_n, -1, np.int32)), dev(mp_row),
        )
        wu, wt = keyframe_db.compute_bow_row(dev(word_row), dev(idf_row), dev(valid_row))
        db = keyframe_db.insert(db, k, wu, wt)

    slots = np.array(sorted(slot_xyz), np.int64)
    first = np.array([slot_first[s] for s in slots], np.int32)
    n = len(slots)
    st = mstate.add_points(
        st, dev(slots), dev(np.stack([slot_xyz[s] for s in slots]), torch.float32),
        dev(np.ones(n, bool)), dev(np.stack([desc[slot_src[s]] for s in slots])),
        dev(np.zeros((n, 3), np.float32)), dev(np.zeros(n, np.float32)),
        dev(np.full(n, 1e9, np.float32)), dev(first), dev(first),
    )
    st = map_ops.update_point_stats(st, CFG)
    st = st._replace(covis=map_ops.covisibility_matrix(st))
    return st, db, T_true, T_est, vocab.to(device)


def padded_pose_graph(device="cpu", n: int = 12, pad: int = 9):
    """A PoseGraphProblem of `n` keyframes on a circle (the chain, the
    second neighbours and a loop edge with a drifted measurement) with
    `pad` padded edges (-1 ends, identity measurements, edge_valid False)
    spread among the real ones. Vertex 3 is fixed; vertex 0, onto which
    the padded edges clamp, is free."""
    from orb_slam_cuda_tpu_torch.solvers import pose_graph

    g = torch.Generator().manual_seed(5)
    ang = torch.arange(n, dtype=torch.float64) * (2 * np.pi / n)
    xi = torch.zeros((n, 6), dtype=torch.float64)
    xi[:, 0], xi[:, 2], xi[:, 4] = 5 * torch.cos(ang), 5 * torch.sin(ang), ang
    T = se3.exp(xi.float())
    R, t, s = T[:, :3, :3], T[:, :3, 3], torch.ones(n)
    ei = torch.cat([torch.arange(n - 1), torch.arange(n - 2), torch.tensor([0])])
    ej = torch.cat([torch.arange(1, n), torch.arange(2, n), torch.tensor([n - 1])])
    mR, mt, ms = pose_graph.relative_sim3((R[ei], t[ei], s[ei]), (R[ej], t[ej], s[ej]))
    mt[-1] += torch.tensor([0.3, 0.0, 0.2])
    ms[-1] *= 1.05
    E = ei.shape[0] + pad
    real = torch.randperm(E, generator=g)[:ei.shape[0]]

    def spread(x, fill):
        out = fill.expand((E,) + x.shape[1:]).clone()
        out[real] = x
        return out

    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[3] = True
    valid = torch.zeros(E, dtype=torch.bool)
    valid[real] = True
    problem = pose_graph.PoseGraphProblem(
        vert_R=R, vert_t=t + torch.randn((n, 3), generator=g) * 0.05, vert_s=s, vert_fixed=fixed,
        edge_i=spread(ei, torch.tensor(-1)), edge_j=spread(ej, torch.tensor(-1)), meas_R=spread(mR, torch.eye(3)),
        meas_t=spread(mt, torch.zeros(3)), meas_s=spread(ms, torch.tensor(1.0)), edge_valid=valid)
    return pose_graph.PoseGraphProblem(*(x.to(device) for x in problem))
