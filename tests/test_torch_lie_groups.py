"""rampvo_tpu_torch.lie (quaternion, ops, groups) against rampvo_tpu.lie
on the CPU: every function of the port's SO3/SE3/RxSO3/Sim3 surface on the
same numpy inputs as its JAX counterpart (the cases of tests/test_lie.py:
random tangents at scale 0.8 and 1e-5, and each small-angle / small-scale
branch of the Sim3 exponential), float32 within 1e-5; the group classes'
methods; gradients at and near the identity finite and equal to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu import lie as jlie
from rampvo_tpu.lie import ops as jl
from rampvo_tpu_torch import lie as plie
from rampvo_tpu_torch.lie import ops as pl

NAMES = ["SO3", "SE3", "RxSO3", "Sim3"]
PREFIX = {"SO3": "so3", "SE3": "se3", "RxSO3": "rxso3", "Sim3": "sim3"}
K = {"SO3": 3, "SE3": 6, "RxSO3": 4, "Sim3": 7}
ACT = {"SO3": 3, "SE3": 3, "RxSO3": 3, "Sim3": 3}
TOL = dict(atol=1e-5, rtol=1e-5)


def t(x):
    return torch.tensor(np.asarray(x))


def close(p, j, **kw):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                               **(kw or TOL))


def tangents(name, scale, n=32, seed=0):
    rng = np.random.RandomState(seed + K[name])
    return (scale * rng.randn(n, K[name])).astype(np.float32)


def sim3_branch_tangents():
    """Sim3 tangents in each branch of the W terms: sigma ~ 0 with theta ~
    0, sigma ~ 0 alone, theta ~ 0 alone, neither (thresholds |sigma| <
    1e-5, theta^2 < 1e-8)."""
    rng = np.random.RandomState(3)
    xi = rng.randn(4, 8, 7).astype(np.float32) * 0.7
    xi[0, :, 3:6] *= 1e-6
    xi[0, :, 6] *= 1e-7
    xi[1, :, 6] *= 1e-7
    xi[2, :, 3:6] *= 1e-6
    return xi.reshape(32, 7)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("scale", [0.8, 1e-5])
def test_exp_log_inv_mul_act_vs_jax(name, scale):
    """exp, log, inv, mul and act of each group == the JAX ops on the same
    tangents and points, float32 within 1e-5."""
    p, j = PREFIX[name], PREFIX[name]
    xi = tangents(name, scale)
    xi2 = tangents(name, 0.5, seed=9)
    pts = np.random.RandomState(4).randn(32, ACT[name]).astype(np.float32)
    pexp, jexp = getattr(pl, p + "_exp"), getattr(jl, j + "_exp")
    X, JX = pexp(t(xi)), jexp(jnp.asarray(xi))
    Y, JY = pexp(t(xi2)), jexp(jnp.asarray(xi2))
    close(X, JX)
    close(getattr(pl, p + "_log")(X), getattr(jl, j + "_log")(JX))
    close(getattr(pl, p + "_inv")(X), getattr(jl, j + "_inv")(JX))
    close(getattr(pl, p + "_mul")(X, Y), getattr(jl, j + "_mul")(JX, JY))
    close(getattr(pl, p + "_act")(X, t(pts)),
          getattr(jl, j + "_act")(JX, jnp.asarray(pts)))


def test_sim3_branches_vs_jax():
    """_sim3_W_terms, sim3_exp and sim3_log == JAX's in each of the four
    branches (small scale and angle, either, neither)."""
    xi = sim3_branch_tangents()
    phi, sig = xi[:, 3:6], xi[:, 6:7]
    for a, b in zip(pl._sim3_W_terms(t(phi), t(sig)),
                    jl._sim3_W_terms(jnp.asarray(phi), jnp.asarray(sig))):
        close(a, b)
    X, JX = pl.sim3_exp(t(xi)), jl.sim3_exp(jnp.asarray(xi))
    close(X, JX)
    close(pl.sim3_log(X), jl.sim3_log(JX))


def test_se3_matrix_normalize_quaternions_vs_jax():
    """se3_matrix, se3_normalize and the quaternion module (normalize,
    to_matrix, exp, log) == JAX's; lie.ops re-exports the quaternion
    functions."""
    rng = np.random.RandomState(5)
    g = rng.randn(16, 7).astype(np.float32)          # unnormalized rotation
    close(pl.se3_normalize(t(g)), jl.se3_normalize(jnp.asarray(g)))
    X = pl.se3_exp(t(tangents("SE3", 0.8)))
    close(pl.se3_matrix(X), jl.se3_matrix(jnp.asarray(X.numpy())))
    q = rng.randn(16, 4).astype(np.float32)
    close(plie.quat_normalize(t(q)), jlie.quat_normalize(jnp.asarray(q)))
    qn = plie.quat_normalize(t(q))
    close(plie.quat_to_matrix(qn), jlie.quat_to_matrix(jnp.asarray(qn.numpy())))
    close(plie.quat_log(qn), jlie.quat_log(jnp.asarray(qn.numpy())))
    assert pl.quat_mul is plie.quat_mul and pl.quat_act is plie.quat_act


@pytest.mark.parametrize("name", NAMES)
def test_group_classes_vs_jax(name):
    """The classes: exp/log/inv, `*` between groups and on points (4-vectors
    through act4 for SE3), Identity, IdentityLike, retr, indexing, stack,
    and SE3's matrix, adj, adjT, scale, translation, normalize == the JAX
    classes'."""
    P, J = getattr(plie, name), getattr(jlie, name)
    xi, xi2 = tangents(name, 0.8), tangents(name, 0.3, seed=2)
    X, JX = P.exp(t(xi)), J.exp(jnp.asarray(xi))
    Y, JY = P.exp(t(xi2)), J.exp(jnp.asarray(xi2))
    close(X.log(), JX.log())
    close(X.inv().data, JX.inv().data)
    close((X * Y).data, (JX * JY).data)
    close(X.retr(t(xi2)).data, JX.retr(jnp.asarray(xi2)).data)
    pts = np.random.RandomState(6).randn(32, 3).astype(np.float32)
    close(X * t(pts), JX * jnp.asarray(pts))
    close(P.Identity(2, 3).data, J.Identity(2, 3).data, atol=0, rtol=0)
    close(P.IdentityLike(X).data, J.IdentityLike(JX).data, atol=0, rtol=0)
    assert X[3:5].shape == (2,) and torch.equal(X[3:5].data, X.data[3:5])
    close(plie.stack([X, Y], axis=1).data, jlie.stack([JX, JY], axis=1).data)
    if name != "SE3":
        return
    p4 = np.random.RandomState(7).randn(32, 4).astype(np.float32)
    close(X * t(p4), JX * jnp.asarray(p4))
    close(X.matrix(), JX.matrix())
    v = np.random.RandomState(8).randn(32, 6).astype(np.float32)
    close(X.adj(t(v)), JX.adj(jnp.asarray(v)))
    close(X.adjT(t(v)), JX.adjT(jnp.asarray(v)))
    s = np.linspace(0.5, 2.0, 32).astype(np.float32)
    close(X.scale(t(s)).data, JX.scale(jnp.asarray(s)).data)
    close(X.scale(2.0).data, JX.scale(jnp.asarray(2.0)).data)
    close(X.translation(), JX.translation())
    close(X.normalize().data, JX.normalize().data)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("at", [0.0, 1e-6])
def test_exp_grad_vs_jax(name, at):
    """d/dxi sum(exp(xi)^2) at the identity and 1e-6 from it: finite and ==
    JAX's gradient (the Taylor branches' gradients; test_lie.py's
    test_exp_grad_finite_at_zero)."""
    xi = np.full(K[name], at, np.float32)
    x = t(xi).requires_grad_(True)
    (getattr(plie, name).exp(x).data ** 2).sum().backward()
    want = jax.grad(lambda v: jnp.sum(getattr(jlie, name).exp(v).data ** 2))(
        jnp.asarray(xi))
    assert torch.isfinite(x.grad).all()
    close(x.grad, want)


@pytest.mark.parametrize("name", ["SE3", "Sim3"])
def test_log_grad_near_identity_vs_jax(name):
    """d/dxi sum(log(exp(xi))^2) at xi = 1e-6: finite and == JAX's
    (test_lie.py's test_se3_log_grad_finite_near_identity)."""
    xi = np.full(K[name], 1e-6, np.float32)
    x = t(xi).requires_grad_(True)
    (getattr(plie, name).exp(x).log() ** 2).sum().backward()
    want = jax.grad(lambda v: jnp.sum(getattr(jlie, name).exp(v).log() ** 2))(
        jnp.asarray(xi))
    assert torch.isfinite(x.grad).all()
    close(x.grad, want, atol=1e-6, rtol=1e-4)
