"""rampvo_tpu_torch.geometry against rampvo_tpu.geometry on the CPU, on the
scene of tests/test_projective.py (4 frames of small random motion, 12
patches a frame, 3x3 patches, inverse depths 0.5-2): `transform` with each
of its options (depth, valid, tonly, and jacobian: the analytic Ji, Jj,
Jz against JAX's and against autograd of the port's own projection),
`relative_poses`, `extract_intrinsics`, `point_cloud`, `flow_mag`,
`coords_grid_with_index` and `set_depth`, float32 within 1e-5 of scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu import geometry as jg
from rampvo_tpu.lie import SE3 as JSE3
from rampvo_tpu_torch import geometry as pg
from rampvo_tpu_torch.lie import SE3

N_FRAMES, N_PATCHES, P = 4, 12, 3


def scene(seed=0):
    """(poses [1, N, 7], patches [1, Np, 3, P, P], intrinsics [1, N, 4],
    frame of each patch [Np]) as numpy."""
    rng = np.random.RandomState(seed)
    xi = (0.05 * rng.randn(N_FRAMES, 6)).astype(np.float32)
    poses = np.asarray(JSE3.exp(jnp.asarray(xi)).data)[None]
    intr = np.tile(np.float32([[120.0, 120.0, 80.0, 60.0]]), (N_FRAMES, 1))[None]
    n = N_FRAMES * N_PATCHES
    xy = rng.uniform(20, 140, (1, n, 2, 1, 1)).astype(np.float32)
    offs = np.stack(np.meshgrid(np.arange(P) - 1, np.arange(P) - 1,
                                indexing="xy"), 0).astype(np.float32)
    xy = np.tile(xy, (1, 1, 1, P, P)) + offs[None, None]
    d = rng.uniform(0.5, 2.0, (1, n, 1, P, P)).astype(np.float32)
    return poses, np.concatenate([xy, d], axis=2), intr, np.repeat(
        np.arange(N_FRAMES), N_PATCHES).astype(np.int32)


def edges():
    kk = np.arange(N_FRAMES * N_PATCHES, dtype=np.int32)
    ii = np.repeat(np.arange(N_FRAMES), N_PATCHES).astype(np.int32)
    return ii, ((ii + 1) % N_FRAMES).astype(np.int32), kk


def t(x):
    return torch.tensor(np.asarray(x))


def close(a, b, tol=1e-5):
    a, b = a.detach().numpy(), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol * max(1.0, np.abs(b).max()),
                               rtol=0)


def both(poses, patches, intr):
    return ((SE3(t(poses)), t(patches), t(intr)),
            (JSE3(jnp.asarray(poses)), jnp.asarray(patches),
             jnp.asarray(intr)))


@pytest.mark.parametrize("opts", [{}, {"depth": True}, {"valid": True},
                                  {"tonly": True},
                                  {"depth": True, "valid": True}])
def test_transform_vs_jax(opts):
    """transform(...) with each option == JAX's: coords (and inverse
    depth), validity."""
    (pp, px, pi), (jp, jx, ji) = both(*scene()[:3])
    ii, jj, kk = edges()
    a = pg.transform(pp, px, pi, t(ii).long(), t(jj).long(), t(kk).long(),
                     **opts)
    b = jg.transform(jp, jx, ji, jnp.asarray(ii), jnp.asarray(jj),
                     jnp.asarray(kk), **opts)
    if opts.get("valid"):
        close(a[1], b[1])
        a, b = a[0], b[0]
    close(a, b)


def test_transform_jacobians_vs_jax():
    """transform(jacobian=True): coords, the centre's validity and the
    analytic (Ji [1, E, 2, 6], Jj, Jz [1, E, 2, 1]) == JAX's."""
    (pp, px, pi), (jp, jx, ji) = both(*scene(1)[:3])
    ii, jj, kk = edges()
    x1, v, (Ji, Jj, Jz) = pg.transform(pp, px, pi, t(ii).long(),
                                       t(jj).long(), t(kk).long(),
                                       jacobian=True)
    y1, w, (Ki, Kj, Kz) = jg.transform(jp, jx, ji, jnp.asarray(ii),
                                       jnp.asarray(jj), jnp.asarray(kk),
                                       jacobian=True)
    assert Ji.shape == (1, 48, 2, 6) and Jz.shape == (1, 48, 2, 1)
    for a, b in ((x1, y1), (v, w), (Ji, Ki), (Jj, Kj), (Jz, Kz)):
        close(a, b)


def test_transform_jacobians_vs_autograd():
    """The port's analytic Jj and Ji == autograd of its own centre-pixel
    projection under a left retraction of pose jj / ii (float64), and Jz ==
    autograd with respect to the patch's inverse depth, for 6 edges
    (float64 with unit quaternions: within 1e-8)."""
    poses, patches, intr, _ = scene(2)
    ii, jj, kk = edges()
    P64 = lambda x: t(x).double()
    poses = SE3(P64(poses)).normalize().data   # unit quaternions in float64
    _, _, (Ji, Jj, Jz) = pg.transform(SE3(P64(poses)), P64(patches),
                                      P64(intr), t(ii).long(), t(jj).long(),
                                      t(kk).long(), jacobian=True)
    c = P // 2
    for e in range(0, 48, 8):
        mask = torch.zeros(patches.shape, dtype=torch.float64)
        mask[0, kk[e], 2] = 1.0

        def center(xi_i, xi_j, d):
            rows = list(P64(poses)[0])
            rows[ii[e]] = (SE3.exp(xi_i) * SE3(rows[ii[e]])).data
            rows[jj[e]] = (SE3.exp(xi_j) * SE3(rows[jj[e]])).data
            g = torch.stack(rows)[None]
            pt = P64(patches) + mask * (d - P64(patches)[0, kk[e], 2])
            out = pg.transform(SE3(g), pt, P64(intr), t(ii[e:e + 1]).long(),
                               t(jj[e:e + 1]).long(), t(kk[e:e + 1]).long())
            return out[0, 0, c, c]

        z6 = torch.zeros(6, dtype=torch.float64)
        d0 = P64(patches)[0, kk[e], 2]
        Ai, Aj, Ad = torch.autograd.functional.jacobian(center, (z6, z6, d0))
        np.testing.assert_allclose(Jj[0, e].numpy(), Aj.numpy(), atol=1e-8)
        np.testing.assert_allclose(Ji[0, e].numpy(), Ai.numpy(), atol=1e-8)
        # the whole patch shares one inverse depth: sum over its pixels
        np.testing.assert_allclose(Jz[0, e, :, 0].numpy(),
                                   Ad.sum(dim=(1, 2)).numpy(), atol=1e-8)


def test_relative_poses_intrinsics_point_cloud_flow_vs_jax():
    """relative_poses (with and without tonly), extract_intrinsics,
    point_cloud and flow_mag == JAX's."""
    poses, patches, intr, ix = scene(3)
    (pp, px, pi), (jp, jx, ji) = both(poses, patches, intr)
    ii, jj, kk = edges()
    for tonly in (False, True):
        close(pg.relative_poses(pp, t(ii).long(), t(jj).long(), tonly).data,
              jg.relative_poses(jp, jnp.asarray(ii), jnp.asarray(jj),
                                tonly).data)
    for a, b in zip(pg.extract_intrinsics(pi), jg.extract_intrinsics(ji)):
        close(a, b, tol=0)
    close(pg.point_cloud(pp, px, pi, t(ix).long()),
          jg.point_cloud(jp, jx, ji, jnp.asarray(ix)))
    close(pg.flow_mag(pp, px, pi, t(ii).long(), t(jj).long(), t(kk).long()),
          jg.flow_mag(jp, jx, ji, jnp.asarray(ii), jnp.asarray(jj),
                      jnp.asarray(kk)))
    assert pg.MIN_DEPTH == jg.MIN_DEPTH


def test_coords_grid_and_set_depth_vs_jax():
    """coords_grid_with_index (coords [B, N, 3, H, W], index [B, N, 1, H,
    W]) and set_depth == JAX's exactly; set_depth leaves its input alone."""
    d = np.random.RandomState(4).rand(2, 3, 5, 7).astype(np.float32)
    for a, b in zip(pg.coords_grid_with_index(t(d)),
                    jg.coords_grid_with_index(jnp.asarray(d))):
        close(a, b, tol=0)
    _, patches, _, _ = scene(5)
    depth = np.random.RandomState(6).rand(1, patches.shape[1]).astype(
        np.float32)
    before = t(patches)
    got = pg.set_depth(before, t(depth))
    close(got, jg.set_depth(jnp.asarray(patches), jnp.asarray(depth)), tol=0)
    assert torch.equal(before, t(patches))
