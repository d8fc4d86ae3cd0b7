"""Projective geometry for the patch graph (port of the inference subset of
rampvo_tpu/geometry/projective.py).

Conventions: patches [..., 3, P, P] channels (x, y, inverse depth);
intrinsics [..., 4] (fx, fy, cx, cy); poses SE3 [..., 7] world-to-camera.
"""

from __future__ import annotations

import torch

from ..lie import ops as lops


def _intrinsics(intrinsics):
    """[..., 4] -> four [..., 1, 1] tensors (fx, fy, cx, cy)."""
    return intrinsics[..., None, None, :].unbind(-1)


def iproj(patches, intrinsics):
    """Inverse projection: patches [B, E, 3, P, P] with intrinsics [B, E, 4]
    -> homogeneous X [B, E, P, P, 4] (ref projective_ops.py:16-26)."""
    x = patches[..., 0, :, :]
    y = patches[..., 1, :, :]
    d = patches[..., 2, :, :]
    fx, fy, cx, cy = _intrinsics(intrinsics)
    return torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(d), d],
                       dim=-1)


def proj(X, intrinsics, depth: bool = False):
    """Pinhole projection with Z clamped at 0.1 (ref projective_ops.py:29-47).
    X [B, E, P, P, 4], intrinsics [B, E, 4]."""
    fx, fy, cx, cy = _intrinsics(intrinsics)
    d = 1.0 / torch.clamp(X[..., 2], min=0.1)
    x = fx * (d * X[..., 0]) + cx
    y = fy * (d * X[..., 1]) + cy
    if depth:
        return torch.stack([x, y, d], dim=-1)
    return torch.stack([x, y], dim=-1)


def transform_edges(poses_i, poses_j, patches, intrinsics):
    """Edge-wise patch reprojection with pre-gathered poses.

    poses_i/poses_j [E, 7]; patches [E, 3, P, P]; intrinsics [4] shared.
    Returns coords [E, P, P, 2]."""
    fx, fy, cx, cy = intrinsics.unbind(-1)
    x = patches[:, 0]
    y = patches[:, 1]
    d = patches[:, 2]
    X0 = torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(d), d],
                     dim=-1)
    Gij = lops.se3_mul(poses_j, lops.se3_inv(poses_i))
    X1 = lops.se3_act4(Gij[:, None, None, :], X0)
    Z = torch.clamp(X1[..., 2], min=0.1)
    u = fx * (X1[..., 0] / Z) + cx
    v = fy * (X1[..., 1] / Z) + cy
    return torch.stack([u, v], dim=-1)


def flow_mag_edges(poses_i, poses_j, patches, intrinsics, beta: float = 0.5):
    """Blend of full and translation-only flow magnitude
    (ref projective_ops.py:108-118). Returns [E, P, P]."""
    ident_rot = torch.zeros_like(poses_j[..., 3:7])
    ident_rot[..., 3].fill_(1.0)
    coords0 = transform_edges(poses_i, poses_i, patches, intrinsics)
    coords1 = transform_edges(poses_i, poses_j, patches, intrinsics)
    Gij = lops.se3_mul(poses_j, lops.se3_inv(poses_i))
    Gij_t = torch.cat([Gij[..., :3], ident_rot], dim=-1)
    coords2 = transform_edges(poses_i, lops.se3_mul(Gij_t, poses_i), patches,
                              intrinsics)
    flow1 = torch.linalg.norm(coords1 - coords0, dim=-1)
    flow2 = torch.linalg.norm(coords2 - coords0, dim=-1)
    return beta * flow1 + (1 - beta) * flow2
