"""Co-visibility frame graph from optical-flow distance (port of
rampvo_tpu/data/frame_graph.py; ref RGBDDataset.py:64-82): the mean flow
magnitude of a coarse grid of points moved between frame pairs."""

from __future__ import annotations

import numpy as np
import torch

from ..lie import ops as lops


def induced_flow_mag(poses, disps, intrinsics, i, j):
    """Mean |flow| moving frame i's coarse grid into frame j. poses [N, 7]
    world-to-camera xyz+xyzw, disps [N, h, w] (subsampled), intrinsics
    [N, 4] at the subsampled scale."""
    h, w = disps[i].shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fx, fy, cx, cy = intrinsics[i]
    d = disps[i]
    X0 = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(d), d],
                  axis=-1).reshape(-1, 4)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    Gij = lops.se3_mul(t(poses[j])[None], lops.se3_inv(t(poses[i])[None]))
    X1 = lops.se3_act4(Gij, t(X0)).numpy()
    Z = np.maximum(X1[:, 2], 0.1)
    fxj, fyj, cxj, cyj = intrinsics[j]
    x1 = fxj * X1[:, 0] / Z + cxj
    y1 = fyj * X1[:, 1] / Z + cyj
    flow = np.sqrt((x1 - xs.reshape(-1)) ** 2 + (y1 - ys.reshape(-1)) ** 2)
    valid = X1[:, 2] > 0.2
    if valid.sum() == 0:
        return np.inf
    return float(flow[valid].mean())


def compute_distance_matrix_flow(poses, disps, intrinsics):
    """Symmetric mean-flow distance over frame pairs less than 40 apart."""
    N = len(poses)
    d = np.full((N, N), np.inf, np.float32)
    for i in range(N):
        d[i, i] = 0.0
        for j in range(i + 1, min(i + 40, N)):
            f_ij = induced_flow_mag(poses, disps, intrinsics, i, j)
            f_ji = induced_flow_mag(poses, disps, intrinsics, j, i)
            d[i, j] = d[j, i] = 0.5 * (f_ij + f_ji)
    return d


def build_frame_graph(poses, depth_files, intrinsics, depth_read, f=16,
                      max_flow=256):
    """graph[i] = (neighbours, flow distances) (ref RGBDDataset.py:64-82)."""
    def read_disp(fn):
        depth = depth_read(fn)[f // 2::f, f // 2::f]
        depth[depth < 0.01] = np.mean(depth)
        return 1.0 / depth

    disps = np.stack([read_disp(fn) for fn in depth_files], 0)
    intr = np.asarray(intrinsics, np.float32) / f
    d = f * compute_distance_matrix_flow(np.asarray(poses), disps, intr)
    graph = {}
    for i in range(d.shape[0]):
        (j,) = np.where(d[i] < max_flow)
        graph[i] = (j, d[i, j])
    return graph
