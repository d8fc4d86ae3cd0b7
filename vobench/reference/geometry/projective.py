"""Projective geometry for the patch graph (port of
rampvo_tpu/geometry/projective.py; ref ramp/projective_ops.py).

Conventions: patches [..., 3, P, P] channels (x, y, inverse depth);
intrinsics [..., 4] (fx, fy, cx, cy); poses world-to-camera, an `SE3`
over [B, N, 7] for the batched functions (`transform`, `point_cloud`,
`flow_mag`) and raw [E, 7] tensors for the edge-wise ones the runtime
calls; ii, jj, kk [E] source frame / target frame / patch index.
"""

from __future__ import annotations

import torch

from ..lie import ops as lops
from ..lie.groups import SE3

MIN_DEPTH = 0.2


def extract_intrinsics(intrinsics):
    """[..., 4] -> four [..., 1, 1] tensors (fx, fy, cx, cy)."""
    return intrinsics[..., None, None, :].unbind(-1)


def iproj(patches, intrinsics):
    """Inverse projection: patches [B, E, 3, P, P] with intrinsics [B, E, 4]
    -> homogeneous X [B, E, P, P, 4] (ref projective_ops.py:16-26)."""
    x = patches[..., 0, :, :]
    y = patches[..., 1, :, :]
    d = patches[..., 2, :, :]
    fx, fy, cx, cy = extract_intrinsics(intrinsics)
    return torch.stack([(x - cx) / fx, (y - cy) / fy, torch.ones_like(d), d],
                       dim=-1)


def proj(X, intrinsics, depth: bool = False):
    """Pinhole projection with Z clamped at 0.1 (ref projective_ops.py:29-47).
    X [B, E, P, P, 4], intrinsics [B, E, 4]."""
    fx, fy, cx, cy = extract_intrinsics(intrinsics)
    d = 1.0 / torch.clamp(X[..., 2], min=0.1)
    x = fx * (d * X[..., 0]) + cx
    y = fy * (d * X[..., 1]) + cy
    if depth:
        return torch.stack([x, y, d], dim=-1)
    return torch.stack([x, y], dim=-1)


def relative_poses(poses: SE3, ii, jj, tonly: bool = False) -> SE3:
    """Gij = Tj o Ti^-1 per edge; `tonly` keeps its translation only."""
    Gij = poses[:, jj] * poses[:, ii].inv()
    if tonly:
        rot = torch.zeros_like(Gij.data[..., 3:7])
        rot[..., 3] = 1.0
        Gij = SE3(torch.cat([Gij.data[..., :3], rot], dim=-1))
    return Gij


def transform(poses: SE3, patches, intrinsics, ii, jj, kk, depth: bool = False,
              valid: bool = False, jacobian: bool = False,
              tonly: bool = False):
    """Reproject patch kk from frame ii into frame jj: patches [B, Np, 3,
    P, P], intrinsics [B, N, 4] -> coords [B, E, P, P, 2] (3 with
    `depth`), with `valid` also (Z > 0.2) per pixel, with `jacobian`
    (valid at the patch centre, (Ji, Jj, Jz)): the analytic [B, E, 2, 6]
    Jacobians of the centre's projection with respect to the left
    retraction of poses ii and jj, and [B, E, 2, 1] of its inverse depth
    (ref projective_ops.py:50-101)."""
    X0 = iproj(patches[:, kk], intrinsics[:, ii])
    Gij = relative_poses(poses, ii, jj, tonly=tonly)
    X1 = Gij[:, :, None, None] * X0                 # act4 on [B, E, P, P, 4]
    x1 = proj(X1, intrinsics[:, jj], depth=depth)
    if jacobian:
        p = X1.shape[2]
        X, Y, Z, H = X1[..., p // 2, p // 2, :].unbind(-1)
        o = torch.zeros_like(H)
        fx, fy, _, _ = intrinsics[:, jj].unbind(-1)
        far = Z.abs() > 0.2
        d = torch.where(far, 1.0 / torch.where(far, Z, torch.ones_like(Z)), o)
        # d(X1)/d(xi_j) for the left retraction at pose j: [H I | -hat(X1)]
        Ja = torch.stack([H, o, o, o, Z, -Y,
                          o, H, o, -Z, o, X,
                          o, o, H, Y, -X, o,
                          o, o, o, o, o, o], dim=-1).reshape(X.shape + (4, 6))
        # d(proj)/d(X1)
        Jp = torch.stack([fx * d, o, -fx * X * d * d, o,
                          o, fy * d, -fy * Y * d * d, o],
                         dim=-1).reshape(X.shape + (2, 4))
        Jj = Jp @ Ja                                  # [B, E, 2, 6]
        Ji = -Gij[:, :, None].adjT(Jj)
        Jz = Jp @ Gij.matrix()[..., :, 3:]            # [B, E, 2, 1]
        return x1, (Z > 0.2).to(x1.dtype), (Ji, Jj, Jz)
    if valid:
        return x1, (X1[..., 2] > 0.2).to(x1.dtype)
    return x1


def point_cloud(poses: SE3, patches, intrinsics, ix):
    """Back-project patches [B, n, 3, P, P] of frames ix to world points
    [B, n, P, P, 4] (ref projective_ops.py:103-105)."""
    return poses[:, ix, None, None].inv() * iproj(patches, intrinsics[:, ix])


def flow_mag(poses: SE3, patches, intrinsics, ii, jj, kk, beta: float = 0.3):
    """Blend of full and translation-only flow magnitude [B, E, P, P]
    (ref projective_ops.py:108-118)."""
    coords0 = transform(poses, patches, intrinsics, ii, ii, kk)
    coords1 = transform(poses, patches, intrinsics, ii, jj, kk)
    coords2 = transform(poses, patches, intrinsics, ii, jj, kk, tonly=True)
    flow1 = torch.linalg.norm(coords1 - coords0, dim=-1)
    flow2 = torch.linalg.norm(coords2 - coords0, dim=-1)
    return beta * flow1 + (1 - beta) * flow2


def coords_grid_with_index(d):
    """Pixel grid stacked with inverse depth, and the frame index: d [B, N,
    H, W] -> ([B, N, 3, H, W], [B, N, 1, H, W]) (ref ramp/utils.py:54-69)."""
    b, n, h, w = d.shape
    yy, xx = torch.meshgrid(torch.arange(h, dtype=d.dtype, device=d.device),
                            torch.arange(w, dtype=d.dtype, device=d.device),
                            indexing="ij")
    coords = torch.stack([xx.expand(b, n, h, w), yy.expand(b, n, h, w), d],
                         dim=2)
    index = torch.arange(n, dtype=d.dtype, device=d.device)[
        None, :, None, None, None].expand(b, n, 1, h, w)
    return coords, index


def set_depth(patches, depth):
    """A copy of patches with the inverse-depth channel set to depth
    [...] per patch (ref ramp/utils.py:99-101)."""
    out = patches.clone()
    out[..., 2, :, :] = depth[..., None, None]
    return out


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
