"""The other lattice correlation layouts of rampvo_tpu_torch against
rampvo_tpu on the CPU: the column maps and the folded corr_fc1 weights,
and the plain versions of K4 (unblended windows + finish), K5 (paired
layout) and K6 (target-major decomposition) against the Pallas kernels
they replace in interpret mode, with patch pixels inside those kernels'
SPREAD windows. The CUDA kernels are held against these plain versions
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.models.vonet import fold_corr_fc1 as j_fold_corr_fc1
from rampvo_tpu.ops import corr_pallas as jcp
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.models.vonet import VONet, fold_corr_fc1
from rampvo_tpu_torch.ops import corr_band_kernels as bk
from rampvo_tpu_torch.ops import corr_kernels as ck
from rampvo_tpu_torch.ops import corr_paired_kernels as pk
from rampvo_tpu_torch.ops.corr_perms import folded_corr_perm, paired_corr_perm
from test_torch_kernels_ref import _lattice, _torch_threads, npy, t  # noqa: F401

NI, T, M, MEM = 4, 5, 8, 5
BF = jnp.bfloat16


def _port_args(gmap, f1, f2, coords, cv, n, slotmap, r, tdt):
    u = t(coords[..., 0].reshape(NI * T, -1))
    v = t(coords[..., 1].reshape(NI * T, -1))
    return (t(gmap).to(tdt), t(f1).to(tdt), t(f2).to(tdt), u, v, t(cv), n,
            t(slotmap), r, (NI, T, M))


def _jax_args(gmap, f1, f2, coords, cv, n, slotmap):
    return (jnp.asarray(gmap, BF), jnp.asarray(f1, BF), jnp.asarray(f2, BF),
            jnp.asarray(coords), jnp.asarray(cv), jnp.int32(n),
            jnp.asarray(slotmap, jnp.int32))


def _live(cv, n, r):
    vm = ck.cell_vmask(NI, T, r, n, t(cv)).numpy()
    return np.broadcast_to(vm[:, :, None], (NI, T, M)).reshape(-1)


def _close(got, want, tol=2e-2):
    scale = np.abs(want).max()
    assert scale > 0 and np.abs(got - want).max() <= tol * scale


# ---------------------------------------------------------------------------
# column maps and the folded corr_fc1 weight
# ---------------------------------------------------------------------------

def test_perms_match_jax():
    """The port's paired/folded column maps == the JAX package's."""
    np.testing.assert_array_equal(paired_corr_perm(3, 3),
                                  jcp.paired_corr_perm(3, 3))
    np.testing.assert_array_equal(folded_corr_perm(3, 3),
                                  jcp.folded_corr_perm(3, 3))


@pytest.mark.parametrize("layout", ["paired", "folded"])
def test_fold_is_the_same_linear_map(layout):
    """A linear layer with the folded weight on the permuted input == the
    layer with the reference weight on the reference input (random data,
    f32: atol 2e-4 on sums of 882 products of size ~30, taken in another
    order); the paired zero columns get zero weights."""
    g = torch.Generator().manual_seed(3)
    net = VONet()
    with torch.no_grad():
        net.update.corr[0].weight.normal_(generator=g)
    x = torch.randn(50, 882, generator=g)
    want = x @ net.update.corr[0].weight.T
    w = fold_corr_fc1(net, layout)
    if layout == "paired":
        idx = torch.tensor(paired_corr_perm(3, 3), dtype=torch.long)
        xp = torch.zeros(50, 1152)
        xp[:, idx >= 0] = x[:, idx[idx >= 0]]
        assert w.shape == (384, 1152)
        assert (w[:, idx < 0] == 0).all()
    else:
        xp = x[:, torch.tensor(folded_corr_perm(3, 3), dtype=torch.long)]
        assert w.shape == (384, 882)
    torch.testing.assert_close(xp @ w.T, want, atol=2e-4, rtol=0)
    with pytest.raises(ValueError):
        fold_corr_fc1(net, "stacked")


@pytest.fixture(scope="module")
def jparams():
    params = jax.jit(JVONet().init)(
        jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 5)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("layout", ["paired", "folded"])
def test_fold_matches_jax(jparams, layout):
    """fold_corr_fc1(net, layout) == the JAX fold_corr_fc1 carried through
    from_flax_params, exactly."""
    params = jparams
    net = VONet()
    net.load_state_dict(from_flax_params(params))
    want = from_flax_params(jax.tree_util.tree_map(
        np.asarray, j_fold_corr_fc1(params, layout)))["update.corr.0.weight"]
    assert torch.equal(fold_corr_fc1(net, layout), want)


# ---------------------------------------------------------------------------
# K4: unblended windows + the plain finish
# ---------------------------------------------------------------------------

def test_k4_matches_corr_lattice2():
    """corr_lattice2 and corr_lattice2_stacked(folded=False/True) on the
    port's K4 (plain version, bf16 rings, bf16 bands) == the JAX ones on
    _lattice_bands in interpret mode: atol 2e-2 of scale (both round the
    windows to bf16; the stacked outputs round again). Dead cells zero."""
    n = 6
    prob = _lattice(4, n, NI, T, M, MEM)
    r = prob[-1]
    pa = _port_args(*prob[:5], n, prob[5], r, torch.bfloat16)
    ja = _jax_args(*prob[:5], n, prob[5])
    live = _live(prob[4], n, r)
    launches = (bk.corr_lattice_bands.launches, bk.corr_folded_cuda.launches)
    c1, c2 = bk.corr_lattice2(*pa)
    assert c1.dtype == torch.float32 and c1.shape == (NI * T * M, 3, 3, 49)
    j1, j2 = jcp.corr_lattice2(*ja, r, 3, interpret=True)
    for got, want in ((c1, j1), (c2, j2)):
        _close(npy(got)[live], npy(want)[live])
        assert (npy(got)[~live] == 0).all()
    for folded in (False, True):
        got = bk.corr_lattice2_stacked(*pa, folded=folded)
        assert got.dtype == torch.bfloat16 and got.shape == (NI * T * M, 882)
        want = jcp.corr_lattice2_stacked(*ja, r, 3, interpret=True,
                                         folded=folded)
        _close(npy(got)[live], npy(want)[live])
        assert (npy(got)[~live] == 0).all()
    # CPU tensors never launch the kernels
    assert (bk.corr_lattice_bands.launches,
            bk.corr_folded_cuda.launches) == launches


@pytest.mark.parametrize("n", [7, 3])
def test_k4_is_k1_function(n):
    """f32, exact windows (patch pixels up to 6 px from their center): the
    folded finish mapped through folded_corr_perm, and the unfolded one,
    == K1's plain version (atol 1e-4 of values ~30); the bands == corr_raw
    of the flat edges by construction, dead cells exactly zero."""
    prob = _lattice(5, n, NI, T, M, MEM, spread=6.0)
    r = prob[-1]
    pa = _port_args(*prob[:5], n, prob[5], r, torch.float32)
    ref = ck.corr_lattice(*pa).numpy()
    fol = bk.corr_lattice2_stacked(*pa, folded=True).numpy()
    inv = folded_corr_perm(3, 3)
    back = np.empty_like(fol)
    back[:, inv] = fol
    np.testing.assert_allclose(back, ref, atol=1e-4)
    np.testing.assert_allclose(bk.corr_lattice2_stacked(*pa).numpy(), ref,
                               atol=1e-4)
    bands = bk.corr_lattice_bands(*pa).numpy()
    assert bands.shape == (NI * T * M, 9, 2, 8, 8)
    assert (bands[~_live(prob[4], n, r)] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_folded_ref_matches_jax(dtype):
    """corr_folded_ref (the plain version of the folded kernel that CUDA
    tensors take: K1's plain version in the folded columns, dead cells
    zero) == the JAX corr_lattice2_stacked(folded=True) on _lattice_bands
    in interpret mode (atol 2e-2 of scale: the JAX band is bf16), and ==
    the port's CPU folded path (bands + finish) within 1e-5 of scale in
    float32, 2e-2 in bf16 (the band's rounding)."""
    n = 6
    prob = _lattice(6, n, NI, T, M, MEM)
    r = prob[-1]
    tdt = getattr(torch, dtype)
    pa = _port_args(*prob[:5], n, prob[5], r, tdt)
    cells = ck.cell_tables(NI, T, r, n, pa[5], pa[7], MEM)
    got = bk.corr_folded_ref(*pa[:5], cells, M)
    assert got.dtype == tdt and got.shape == (NI * T * M, 882)
    live = _live(prob[4], n, r)
    want = jcp.corr_lattice2_stacked(*_jax_args(*prob[:5], n, prob[5]), r, 3,
                                     interpret=True, folded=True)
    _close(npy(got)[live], npy(want)[live])
    assert (npy(got)[~live] == 0).all()
    _close(npy(got), npy(bk.corr_lattice2_stacked(*pa, folded=True)),
           1e-5 if dtype == "float32" else 2e-2)


# ---------------------------------------------------------------------------
# K5: the paired layout
# ---------------------------------------------------------------------------

def test_k5_matches_fused2():
    """corr_lattice_paired (plain version, bf16 rings) == corr_lattice_fused2
    (interpret mode, planar coords) on all 1152 columns, the 30 zero
    columns of each pixel and dead cells included: atol 2e-2 of scale (bf16
    outputs, and the TPU kernel's 10-bit blend weights)."""
    n = 6
    prob = _lattice(6, n, NI, T, M, MEM)
    r = prob[-1]
    gmap, f1, f2, coords, cv, slotmap = prob[:6]
    pa = _port_args(gmap, f1, f2, coords, cv, n, slotmap, r, torch.bfloat16)
    ja = _jax_args(gmap, f1, f2, coords, cv, n, slotmap)
    NC, MPP = NI * T, M * 9
    c = jnp.asarray(coords)
    planar = (c[..., 0].reshape(NC, MPP), c[..., 1].reshape(NC, MPP),
              c[:, :, :, 1, 1, 0].reshape(NC, M),
              c[:, :, :, 1, 1, 1].reshape(NC, M))
    want = npy(jcp.corr_lattice_fused2(
        ja[0], ja[1], ja[2], planar, *ja[4:], r, 3, interpret=True,
        lat=(NI, T, M, 3)))
    got = pk.corr_lattice_paired(*pa)
    assert got.dtype == torch.bfloat16 and got.shape == (NC * M, 1152)
    got = npy(got)
    _close(got, want)
    dead_cols = paired_corr_perm(3, 3) < 0
    assert (got[:, dead_cols] == 0).all() and (want[:, dead_cols] == 0).all()
    assert (got[~_live(cv, n, r)] == 0).all()


# ---------------------------------------------------------------------------
# K6: cells batched per (target, t-band)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tb", [2, 13])
@pytest.mark.parametrize("n", [6, 3, 2])
def test_k6_matches_fused4(n, tb):
    """cell_tables_a's group table == the JAX _cell_tables_a tabs exactly,
    its per-cell host slots and lattice cells == the JAX gslot and gidx on
    every walked entry; K6's plain version == K1's plain version exactly;
    and (bf16 rings) == corr_lattice_fused4 in interpret mode through
    paired_corr_perm, atol 2e-2 of scale; dead cells zero in both."""
    prob = _lattice(20 + n, n, NI, T, M, MEM)
    r = prob[-1]
    gmap, f1, f2, coords, cv, slotmap = prob[:6]
    pa32 = _port_args(gmap, f1, f2, coords, cv, n, slotmap, r, torch.float32)
    groups, cells_a, walked = ck.cell_tables_a(NI, T, r, n, t(cv),
                                               t(slotmap), MEM, tb)
    tabs, gidx, gslot, _ = jcp._cell_tables_a(
        NI, T, M, 9, r, jnp.int32(n), jnp.asarray(slotmap, jnp.int32), MEM,
        64, tb)
    np.testing.assert_array_equal(groups.numpy(), np.asarray(tabs))
    gidx, gslot = np.asarray(gidx).reshape(-1), np.asarray(gslot).reshape(-1)
    seen = np.zeros(NI * T, bool)
    for g, (_, _, _, _, lo, hi) in enumerate(groups.tolist()):
        for tc in range(lo, hi + 1):
            k = g * tb + tc
            c = int(cells_a[k, 0])
            c = -1 - c if c < 0 else c
            assert c == gidx[k] and int(cells_a[k, 1]) == gslot[k]
            seen[c] = True
    np.testing.assert_array_equal(seen, walked.numpy().astype(bool))

    launches = ck.corr_lattice_cb.launches
    a = ck.corr_lattice_cb(*pa32, tb=tb).numpy()
    np.testing.assert_array_equal(a, ck.corr_lattice(*pa32).numpy())
    assert ck.corr_lattice_cb.launches == launches

    pa = _port_args(gmap, f1, f2, coords, cv, n, slotmap, r, torch.bfloat16)
    got = npy(ck.corr_lattice_cb(*pa, tb=tb))
    want = npy(jcp.corr_lattice_fused4(
        *_jax_args(gmap, f1, f2, coords, cv, n, slotmap), r, 3,
        interpret=True, tb=tb))
    idx = paired_corr_perm(3, 3)
    cols = idx >= 0
    live = _live(cv, n, r)
    _close(got[:, idx[cols]][live], want[:, cols][live])
    assert (got[~live] == 0).all() and (want[~live] == 0).all()


# ---------------------------------------------------------------------------
# P1 and P2: the probes' plain versions
# ---------------------------------------------------------------------------

def _script(name):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dynlane_probe():
    """P1's plain version writes rows [tc*SP, (tc+1)*SP) for tc in the
    table's [2, 6] as x + vcol[.., 0], exactly the JAX probe's expected
    array (scripts/probe_dynlane.py:65-69), and leaves the other rows."""
    from rampvo_tpu_torch.probes import dynlane as p1

    jp = _script("probe_dynlane")
    assert (jp.SP, jp.T, jp.W) == (p1.SP, p1.T, p1.W)
    tabs, vcol, x = p1.inputs(seed=1)
    out = torch.full((1, p1.T * p1.SP, p1.W), -7.0)
    launches = p1.dynlane.launches
    p1.dynlane(tabs, vcol, x, out)
    assert p1.dynlane.launches == launches
    want = np.full((p1.T * p1.SP, p1.W), -7.0, np.float32)
    for tc in range(2, 7):
        rows = slice(tc * p1.SP, (tc + 1) * p1.SP)
        want[rows] = x.numpy() + vcol.numpy()[0, rows, 0:1]
    np.testing.assert_array_equal(out[0].numpy(), want)


def test_grid_probe_tables():
    """P2's tables == the JAX probe's make_tabs (both index modes), and
    its plain version zeroes exactly one 192-wide row per distinct
    (out_row, t) of the table in every output, leaving the rest."""
    from rampvo_tpu_torch.probes import grid_overhead as p2

    jp = _script("probe_grid_overhead")
    assert jp.NB == p2.NB == 900
    for varying in (True, False):
        tabs, nv = p2.make_tabs(varying)
        jtabs, jnv = jp.make_tabs(varying)
        np.testing.assert_array_equal(tabs.numpy(), np.asarray(jtabs))
        assert nv == jnv
    tabs, _ = p2.make_tabs(True)
    small = [(p2.NI + 1, p2.T, 2, 2, 1, p2.ROW)] * 2     # M, PP cut for size
    outs = [torch.full(s, 7.0, dtype=torch.bfloat16) for s in small]
    p2.grid_probe("two", tabs, outs)
    pairs = {(int(a), int(b)) for a, b in zip(tabs[:, 4], tabs[:, 1])}
    for o in outs:
        zero = (o == 0).all(-1)
        assert int(zero.sum()) == len(pairs)
        assert all(bool(zero[a, b, 0, 0, 0]) for a, b in pairs)
        assert bool(((o == 0) | (o == 7)).all())
    assert p2.output_shapes("noop") == []
    assert p2.output_shapes("one") == [(26, 25, 96, 18, 1, 192)]
