"""SE3 operations on raw tensors (port of rampvo_tpu/lie/quaternion.py and
the SE3 part of rampvo_tpu/lie/ops.py).

Layouts (trailing dim): quaternion [qx, qy, qz, qw]; SE3
[tx, ty, tz, qx, qy, qz, qw]; SE3 tangent [tau, phi]. Everything
broadcasts over leading dims. Small-angle Taylor branches are selected
with `where` on inputs masked away from the unsafe denominators.
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


def hat_so3(phi):
    """3-vector -> skew-symmetric matrix."""
    x, y, z = _split(phi)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _so3_left_jacobian_terms(phi):
    """Coefficients (a, b) of V = I + a phi^ + b phi^^."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    th_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(th_sq)
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / th_sq)
    b = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (th_sq * theta),
    )
    return a, b


def _so3_left_jacobian_inv_terms(phi):
    """Coefficient c of V^-1 = I - 1/2 phi^ + c phi^^."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    th_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(th_sq)
    c_exact = (1.0 / th_sq) - (1.0 + torch.cos(theta)) / (
        2.0 * theta * torch.sin(theta)
    )
    c_taylor = 1.0 / 12.0 + theta_sq / 720.0
    return torch.where(small, c_taylor, c_exact)


def _apply_V(phi, tau):
    a, b = _so3_left_jacobian_terms(phi)
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    return tau + a * c1 + b * c2


def _apply_V_inv(phi, t):
    c = _so3_left_jacobian_inv_terms(phi)
    c1 = _cross(phi, t)
    c2 = _cross(phi, c1)
    return t - 0.5 * c1 + c * c2


def se3_identity(shape=(), dtype=torch.float32, device=None):
    base = torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype, device=device)
    return base.expand(tuple(shape) + (7,)).clone()


def se3_exp(xi):
    """Tangent [tau, phi] -> SE3 [t, q]."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    return torch.cat([_apply_V(phi, tau), quat_exp(phi)], dim=-1)


def se3_log(g):
    t, q = g[..., :3], g[..., 3:7]
    phi = quat_log(q)
    return torch.cat([_apply_V_inv(phi, t), phi], dim=-1)


def se3_inv(g):
    t, q = g[..., :3], g[..., 3:7]
    qi = quat_inv(q)
    return torch.cat([-quat_act(qi, t), qi], dim=-1)


def se3_mul(a, b):
    ta, qa = a[..., :3], a[..., 3:7]
    tb, qb = b[..., :3], b[..., 3:7]
    return torch.cat([quat_act(qa, tb) + ta, quat_mul(qa, qb)], dim=-1)


def se3_act(g, p):
    """Apply to 3-points: R p + t."""
    return quat_act(g[..., 3:7], p) + g[..., :3]


def se3_act4(g, p):
    """Apply to homogeneous 4-points: [R p + w t, w]."""
    xyz = quat_act(g[..., 3:7], p[..., :3]) + p[..., 3:4] * g[..., :3]
    return torch.cat([xyz, p[..., 3:4].expand(xyz.shape[:-1] + (1,))], dim=-1)


def se3_adj(g, x):
    """Adjoint action on tangent x = [v, w]: [Rv + t x (Rw), Rw]."""
    t, q = g[..., :3], g[..., 3:7]
    v, w = x[..., :3], x[..., 3:6]
    Rw = quat_act(q, w)
    return torch.cat([quat_act(q, v) + _cross(t, Rw), Rw], dim=-1)


def se3_adjT(g, x):
    """Transposed adjoint: AdjT [v, w] = [R^T v, R^T (w - t x v)]."""
    t, q = g[..., :3], g[..., 3:7]
    v, w = x[..., :3], x[..., 3:6]
    qi = quat_inv(q)
    return torch.cat([quat_act(qi, v), quat_act(qi, w - _cross(t, v))], dim=-1)


def se3_retr(g, xi):
    """Left retraction exp(xi) o g (ba_cuda.cu:156-174)."""
    return se3_mul(se3_exp(xi), g)
