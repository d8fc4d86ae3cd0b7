"""Lie-group operations on raw tensors (port of rampvo_tpu/lie/ops.py;
the quaternion primitives live in lie/quaternion.py).

Layouts (trailing dim): SO3 [qx, qy, qz, qw] (tangent phi); SE3
[tx, ty, tz, qx, qy, qz, qw] (tangent [tau, phi]); RxSO3 [qx, qy, qz,
qw, s] (tangent [phi, sigma]); Sim3 [tx, ty, tz, qx, qy, qz, qw, s]
(tangent [tau, phi, sigma]). Everything broadcasts over leading dims.
Small-angle Taylor branches are selected with `where` on inputs masked
away from the unsafe denominators, so values and gradients stay finite.
"""

from __future__ import annotations

import torch

from .quaternion import (
    _cross,
    _safe_sqrt,
    _split,
    quat_act,
    quat_exp,
    quat_inv,
    quat_log,
    quat_mul,
    quat_normalize,
    quat_to_matrix,
)


def hat_so3(phi):
    """3-vector -> skew-symmetric matrix."""
    x, y, z = _split(phi)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


so3_exp = quat_exp
so3_log = quat_log
so3_inv = quat_inv
so3_mul = quat_mul
so3_act = quat_act


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


def se3_matrix(g):
    """4x4 homogeneous matrix."""
    t, q = g[..., :3], g[..., 3:7]
    top = torch.cat([quat_to_matrix(q), t[..., None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=g.dtype,
                          device=g.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_normalize(g):
    return torch.cat([g[..., :3], quat_normalize(g[..., 3:7])], dim=-1)


# ---------------------------------------------------------------------------
# RxSO3 (rotation + scale)
# ---------------------------------------------------------------------------

def rxso3_exp(xi):
    """Tangent [phi, sigma] -> [q, s]."""
    return torch.cat([quat_exp(xi[..., :3]), torch.exp(xi[..., 3:4])], dim=-1)


def rxso3_log(g):
    return torch.cat([quat_log(g[..., :4]), torch.log(g[..., 4:5])], dim=-1)


def rxso3_inv(g):
    return torch.cat([quat_inv(g[..., :4]), 1.0 / g[..., 4:5]], dim=-1)


def rxso3_mul(a, b):
    return torch.cat([quat_mul(a[..., :4], b[..., :4]),
                      a[..., 4:5] * b[..., 4:5]], dim=-1)


def rxso3_act(g, p):
    return g[..., 4:5] * quat_act(g[..., :4], p)


# ---------------------------------------------------------------------------
# Sim3 (similarity transform)
# ---------------------------------------------------------------------------

def _sim3_W_terms(phi, sigma):
    """Coefficients (A, B, C) of W = C I + A phi^ + B phi^^ for Sim3 exp,
    with the four cases (sigma -> 0, theta -> 0, both, neither) selected
    by `where` after the unsafe denominators are masked to 1, at the JAX
    package's thresholds (|sigma| < 1e-5, theta^2 < 1e-8)."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta = _safe_sqrt(theta_sq)
    s = torch.exp(sigma)
    small_sigma = sigma.abs() < 1e-5
    small_theta = theta_sq < 1e-8
    one = torch.ones_like
    sig = torch.where(small_sigma, one(sigma), sigma)
    th = torch.where(small_theta, one(theta), theta)
    th_sq = torch.where(small_theta, one(theta_sq), theta_sq)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    c = th_sq + sig * sig

    # C = (s - 1) / sigma  (Taylor: 1 + sigma/2 + sigma^2/6)
    C = torch.where(small_sigma, 1.0 + sigma / 2.0 + sigma * sigma / 6.0,
                    (s - 1.0) / sig)
    a_small_sigma = (1.0 - cos_t) / th_sq
    a_small_theta = ((sig - 1.0) * s + 1.0) / (sig * sig)
    a_general = (s * sin_t * sig + (1.0 - s * cos_t) * th) / (th * c)
    A = torch.where(
        small_sigma,
        torch.where(small_theta, torch.full_like(theta, 0.5), a_small_sigma),
        torch.where(small_theta, a_small_theta, a_general))
    b_small_sigma = (theta - sin_t) / (th_sq * th)
    b_small_theta = (s * (0.5 * sig * sig + 1.0) - 1.0 - sig * s) / (
        sig * sig * sig)
    b_general = (C - ((s * cos_t - 1.0) * sig + s * sin_t * th) / c) / th_sq
    B = torch.where(
        small_sigma,
        torch.where(small_theta, torch.full_like(theta, 1.0 / 6.0),
                    b_small_sigma),
        torch.where(small_theta, b_small_theta, b_general))
    return A, B, C


def sim3_exp(xi):
    """Tangent [tau, phi, sigma] -> [t, q, s]."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    A, B, C = _sim3_W_terms(phi, sigma)
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    return torch.cat([C * tau + A * c1 + B * c2, quat_exp(phi),
                      torch.exp(sigma)], dim=-1)


def _sim3_apply_W_inv(phi, sigma, t):
    """W^-1 t by solving the (tiny, batched) 3x3 system."""
    A, B, C = _sim3_W_terms(phi, sigma)
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    P = hat_so3(phi)
    Wm = C[..., None] * eye + A[..., None] * P + B[..., None] * (P @ P)
    return torch.linalg.solve(Wm, t[..., None])[..., 0]


def sim3_log(g):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    phi = quat_log(q)
    sigma = torch.log(s)
    return torch.cat([_sim3_apply_W_inv(phi, sigma, t), phi, sigma], dim=-1)


def sim3_mul(a, b):
    ta, qa, sa = a[..., :3], a[..., 3:7], a[..., 7:8]
    tb, qb, sb = b[..., :3], b[..., 3:7], b[..., 7:8]
    return torch.cat([sa * quat_act(qa, tb) + ta, quat_mul(qa, qb), sa * sb],
                     dim=-1)


def sim3_inv(g):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    qi = quat_inv(q)
    return torch.cat([-quat_act(qi, t) / s, qi, 1.0 / s], dim=-1)


def sim3_act(g, p):
    t, q, s = g[..., :3], g[..., 3:7], g[..., 7:8]
    return s * quat_act(q, p) + t
