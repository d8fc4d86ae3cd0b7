"""Quaternion primitives (xyzw layout, Hamilton convention): port of
rampvo_tpu/lie/quaternion.py. Everything broadcasts over leading dims;
small-angle Taylor branches are selected with `where` on inputs masked
away from the unsafe denominators.
"""

from __future__ import annotations

import torch


def _split(x):
    return x.unbind(-1)


def quat_mul(a, b):
    """Hamilton product a (x) b for xyzw quaternions."""
    ax, ay, az, aw = _split(a)
    bx, by, bz, bw = _split(b)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def quat_inv(q):
    """Conjugate (== inverse for unit quaternions)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_act(q, v):
    """Rotate 3-vector(s) v by unit quaternion q (two-cross-product form)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, v)
    return v + qw * uv + _cross(qv, uv)


def quat_to_matrix(q):
    """Unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = _split(q)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_exp(phi):
    """Rotation vector -> unit quaternion."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    theta_p4 = theta_sq * theta_sq
    imag_taylor = 0.5 - theta_sq / 48.0 + theta_p4 / 3840.0
    real_taylor = 1.0 - theta_sq / 8.0 + theta_p4 / 384.0
    imag = torch.where(small, imag_taylor, torch.sin(0.5 * theta) / theta)
    real = torch.where(small, real_taylor, torch.cos(0.5 * theta))
    return torch.cat([imag * phi, real], dim=-1)


def quat_log(q):
    """Unit quaternion -> rotation vector (principal branch)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    sign = torch.where(qw < 0, -1.0, 1.0).to(q.dtype)
    qv = qv * sign
    qw = qw * sign
    norm_sq = (qv * qv).sum(-1, keepdim=True)
    small = norm_sq < 1e-12
    norm = torch.sqrt(torch.where(small, torch.ones_like(norm_sq), norm_sq))
    scale_exact = 2.0 * torch.atan2(norm, qw) / norm
    scale_taylor = 2.0 / qw * (1.0 - norm_sq / (3.0 * qw * qw))
    return torch.where(small, scale_taylor, scale_exact) * qv


def _safe_sqrt(x):
    """sqrt with a zero-safe gradient (clamps the primal away from 0)."""
    return torch.sqrt(torch.clamp(x, min=1e-24))


def quat_normalize(q):
    return q / _safe_sqrt((q * q).sum(-1, keepdim=True))
