"""rampvo_tpu_torch's inference bundle adjustment against rampvo_tpu's
lattice ba_infer on the CPU, on the synthetic problems of tests/test_ba.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.ba import ba_infer as j_ba_infer
from rampvo_tpu.ba import core as jcore
from rampvo_tpu.lie import ops as jl
from rampvo_tpu_torch.ba import core as pba


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and torch's default (one thread per core, spinning) oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def npy(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ba_lattice_problem():
    """The lattice problem of tests/test_ba.py::TestLatticeAssembly."""
    rng = np.random.RandomState(11)
    NI, T, Mp = 5, 7, 4
    r = (T + 1) // 2
    n = 9
    E = NI * T * Mp
    Nwin, Mwin = 4, 10 * Mp
    i_row = np.arange(NI)[:, None]
    tt = np.arange(T)[None, :]
    i = n - 1 - np.mod(n - 1 - i_row, NI) + 0 * tt
    j = i + tt - (r - 1)
    cellv = (i >= 0) & (j >= 0) & (j <= n - 1) & (rng.rand(NI, T) < 0.8)
    ii = np.broadcast_to(i[:, :, None], (NI, T, Mp))
    jj = np.broadcast_to(j[:, :, None], (NI, T, Mp))
    kk = ii * Mp + np.arange(Mp)[None, None, :]
    valid = np.broadcast_to(cellv[:, :, None], (NI, T, Mp))
    iif = np.where(valid, ii, 0).reshape(E).astype(np.int32)
    jjf = np.where(valid, jj, 0).reshape(E).astype(np.int32)
    kkf = np.where(valid, kk, 0).reshape(E).astype(np.int32)
    poses7 = np.asarray(jl.se3_exp(jnp.asarray(
        0.02 * rng.randn(n, 6).astype(np.float32))))
    poses7 = np.concatenate([poses7, np.tile([0, 0, 0, 0, 0, 0, 1.0],
                                             (3, 1))], 0).astype(np.float32)
    pwin = rng.rand(Mwin, 3, 3, 3).astype(np.float32)
    pwin[:, 2] = 0.5 + 0.2 * pwin[:, 2]
    cwin = pwin[:, :, 1, 1]
    intr = np.array([40.0, 40.0, 32.0, 24.0], np.float32)
    targets = (rng.rand(E, 2) * 60).astype(np.float32)
    weights = rng.rand(E, 2).astype(np.float32)
    wf = np.arange(Mwin // Mp)
    wrow = np.mod(wf, NI)
    held = (n - 1 - np.mod(n - 1 - wrow, NI)) == wf
    win_rows = np.where(held & (wf < n), wrow, -1).astype(np.int32)
    return dict(poses=poses7, cwin=cwin, intr=intr, targets=targets,
                weights=weights, ii=iif, jj=jjf, kk=kkf,
                valid=valid.reshape(E).copy(), t0=1, t1=n, N=Nwin, M=Mwin,
                lattice=(NI, T, Mp), win_rows=win_rows)


def _ba_scene():
    """The pinhole scene of tests/test_ba.py::make_scene as a one-row
    lattice: 32 patches hosted in frame 0, observed in frames 1..3."""
    rng = np.random.RandomState(0)
    intr = np.array([120.0, 120.0, 160.0, 120.0], np.float32)
    xi = (0.05 * rng.randn(4, 6)).astype(np.float32)
    xi[0] = 0
    poses_gt = np.asarray(jl.se3_exp(jnp.asarray(xi)))
    Mp = 32
    x = rng.uniform(60, 260, Mp).astype(np.float32)
    y = rng.uniform(40, 200, Mp).astype(np.float32)
    d = rng.uniform(0.25, 1.0, Mp).astype(np.float32)
    centers = np.stack([x, y, d], -1)
    T = 4
    ii = np.zeros((1, T, Mp), np.int32)
    jj = np.broadcast_to(np.arange(T)[None, :, None], (1, T, Mp)).astype(
        np.int32)
    kk = np.broadcast_to(np.arange(Mp)[None, None, :], (1, T, Mp)).astype(
        np.int32)
    valid = (jj > 0).reshape(-1)
    from rampvo_tpu.ba import linearize_center

    E = T * Mp
    intr_e = np.broadcast_to(intr, (E, 4))
    targets, _, *_ = linearize_center(
        jnp.asarray(poses_gt), jnp.asarray(centers[kk.reshape(-1)]),
        jnp.asarray(intr_e), jnp.asarray(intr_e), jnp.asarray(ii.reshape(-1)),
        jnp.asarray(jj.reshape(-1)))
    noise = (0.02 * rng.randn(4, 6)).astype(np.float32)
    noise[:2] = 0
    poses0 = np.asarray(jl.se3_mul(jl.se3_exp(jnp.asarray(noise)),
                                   jnp.asarray(poses_gt)))
    cwin = np.concatenate([centers, np.zeros((3 * Mp, 3), np.float32)], 0)
    return dict(poses=poses0, cwin=cwin, intr=intr,
                targets=np.asarray(targets), weights=np.ones((E, 2),
                                                           np.float32),
                ii=ii.reshape(-1), jj=jj.reshape(-1), kk=kk.reshape(-1),
                valid=valid, t0=2, t1=4, N=2, M=4 * Mp, lattice=(1, T, Mp),
                win_rows=np.array([0, -1, -1, -1], np.int32)), poses_gt


def _run_ba(pb, iters):
    a = j_ba_infer(
        jnp.asarray(pb["poses"]), jnp.asarray(pb["cwin"]),
        jnp.asarray(pb["intr"]), jnp.asarray(pb["targets"]),
        jnp.asarray(pb["weights"]), jnp.float32(1e-4), jnp.asarray(pb["ii"]),
        jnp.asarray(pb["jj"]), jnp.asarray(pb["kk"]), jnp.int32(pb["t0"]),
        jnp.int32(pb["t1"]), N=pb["N"], M=pb["M"], iterations=iters,
        valid=jnp.asarray(pb["valid"]), lattice=pb["lattice"],
        win_rows=jnp.asarray(pb["win_rows"]))
    b = pba.ba_infer(
        t(pb["poses"]), t(pb["cwin"]), t(pb["intr"]), t(pb["targets"]),
        t(pb["weights"]), 1e-4, t(pb["ii"]).long(), t(pb["jj"]).long(),
        t(pb["kk"]).long(), pb["t0"], pb["t1"], N=pb["N"], M=pb["M"],
        lattice=pb["lattice"], win_rows=t(pb["win_rows"]).long(),
        iterations=iters, valid=t(pb["valid"]))
    return a, b


def test_ba_lattice_problem():
    """On the random lattice problem of tests/test_ba.py: the cell-wise
    linearization and the assembled normal equations match the JAX lattice
    path to f32 rounding (1e-5 of scale), the Schur solve to 1e-3 of
    scale; end to end, two
    GN iterations on this ill-conditioned problem amplify the summation
    order, so poses and depths are held to 0.05, the bound
    tests/test_ba.py uses between the JAX package's own two paths."""
    pb = _ba_lattice_problem()
    NI, T, Mp = pb["lattice"]
    centers = pb["cwin"][pb["kk"]]
    ii_c = pb["ii"].reshape(-1, Mp)[:, 0]
    jj_c = pb["jj"].reshape(-1, Mp)[:, 0]
    lin_j = jax.jit(jcore.linearize_center_cells, static_argnums=5)(
        jnp.asarray(pb["poses"]), jnp.asarray(centers), jnp.asarray(pb["intr"]),
        jnp.asarray(ii_c), jnp.asarray(jj_c), Mp)
    lin_p = pba.linearize_center_cells(
        t(pb["poses"]), t(centers), t(pb["intr"]), t(ii_c).long(),
        t(jj_c).long(), Mp)

    def close(a, b, what):
        a, b = npy(a).astype(np.float32), npy(b).astype(np.float32)
        scale = max(np.abs(a).max(), 1.0)
        assert np.abs(a - b).max() / scale < 1e-5, what

    for i, (a, b) in enumerate(zip(lin_j, lin_p)):
        close(a, b, f"linearize[{i}]")
    coords, Z, Ji, Jj, Jz = (npy(x) for x in lin_j)
    r = pb["targets"] - coords
    gate = ((np.linalg.norm(r, axis=-1) < 128.0) & (Z > 0.2)
            & (coords[:, 0] > -64) & (coords[:, 1] > -64)
            & (coords[:, 0] < 2 * 32.0 + 64) & (coords[:, 1] < 2 * 24.0 + 64)
            & pb["valid"])
    w = np.where(gate[:, None], pb["weights"], 0.0).astype(np.float32)
    rg = np.where(gate[:, None], r, 0.0).astype(np.float32)
    i_slot = (pb["ii"] - pb["t0"]).astype(np.int32)
    j_slot = (pb["jj"] - pb["t0"]).astype(np.int32)
    A = jax.jit(jcore._assemble_cellwise, static_argnums=(7, 8, 9))(
        jnp.asarray(rg), jnp.asarray(w), jnp.asarray(Ji), jnp.asarray(Jj),
        jnp.asarray(Jz), jnp.asarray(i_slot), jnp.asarray(j_slot), pb["N"],
        pb["M"], pb["lattice"], jnp.asarray(pb["win_rows"]))
    B = pba._assemble_cellwise(
        t(rg), t(w), t(Ji), t(Jj), t(Jz), t(i_slot).long(),
        t(j_slot).long(), pb["N"], pb["M"], pb["lattice"],
        t(pb["win_rows"]).long())
    for name, a, b in zip(["B", "E", "C", "v", "u", "touched"], A, B):
        close(a, b, name)
    n_dyn = pb["t1"] - pb["t0"]
    sj = jax.jit(jcore._solve_schur, static_argnums=(8,))(
        *A[:5], 1e-4, 1.0, 1e-4, False, jnp.int32(n_dyn))
    sp = pba._solve_schur(*B[:5], 1e-4, 1.0, 1e-4, n_dyn)
    # the damped solve on this random system has a large condition number:
    # its output carries the f32 rounding of the system at 1e-3 of scale
    for name, a, b in zip(["dX", "dZ"], sj, sp):
        a, b = npy(a), npy(b)
        assert np.abs(a - b).max() < 1e-3 * np.abs(a).max(), name

    (pa, da), (pb_, db) = _run_ba(pb, 2)
    np.testing.assert_allclose(npy(pb_), npy(pa), atol=0.05)
    np.testing.assert_allclose(npy(db), npy(da), atol=0.05)


def test_ba_converges_on_scene():
    """On the pinhole scene the port == JAX after 10 iterations (1e-5) and
    recovers the ground-truth poses (1e-3)."""
    pb, poses_gt = _ba_scene()
    (pa, _), (pp, _) = _run_ba(pb, 10)
    np.testing.assert_allclose(npy(pp), npy(pa), atol=1e-5)
    np.testing.assert_allclose(npy(pp), poses_gt, atol=1e-3)


