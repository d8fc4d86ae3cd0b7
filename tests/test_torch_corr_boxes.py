"""The plain mirror of the correlation kernels' box decomposition
(rampvo_tpu_torch/ops/corr_kernels.py::window_boxes, corr_lattice_box_ref;
ops/corr_train_kernels.py::corr_train_bwd_box_ref) against the kernels'
plain versions and against rampvo_tpu's exact correlation, on the CPU.

K1/K4/K5/K6 and K8 read each edge's windows as one box per level (the
union of its 9 pixels' 8x8 windows), dot or scatter over the whole box,
and pick each pixel's window out of it by an offset; an edge whose pixels
spread beyond the cap goes pixel by pixel. The mirrors do the same index
arithmetic in PyTorch, so these tests hold the box origin, the per-pixel
offsets, the cap, the borders and the non-finite coordinates to the plain
versions, case by case. Inputs are made with numpy from fixed seeds at a
small size (M = 8, 24x32 and 6x8 maps). Tolerances: 1e-5 of scale forward,
1e-4 backward (float32; only the summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.ops.corr import corr as j_corr
from rampvo_tpu.ops.corr import corr_stack as j_corr_stack
from rampvo_tpu.ops.corr import corr_train as j_corr_train
from rampvo_tpu_torch.ops import corr as pcorr
from rampvo_tpu_torch.ops import corr_kernels as ck
from rampvo_tpu_torch.ops import corr_train_kernels as ctk

H, W, M, MEM, NC = 24, 32, 8, 4, 6
E = NC * M
CASES = ["patch", "spread3", "wide", "borders", "identical_integer",
         "nonfinite"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def case_coords(kind, rng, n=E):
    """[n, 3, 3, 2] level-1 (x, y) coords of n patches.

    patch: a 3x3 grid +-1 px with 0.2 px jitter, centers over and 4 px
    beyond the map. spread3: pixels +-3 px around the center. wide: +-5 px
    (spans beyond the cap of 8 at level 1). borders: centers on, across and
    far outside each border (boxes crossing and wholly outside the map).
    identical_integer: all nine pixels on one integer point (fraction 0,
    span 0). nonfinite: patch coords with NaN, +-inf and +-1e30 pixels."""
    cen = rng.uniform([-4, -4], [W + 4, H + 4], (n, 1, 1, 2))
    grid = np.stack(np.meshgrid(np.arange(3.0) - 1, np.arange(3.0) - 1,
                                indexing="xy"), -1)
    patch = cen + grid + 0.2 * rng.randn(n, 3, 3, 2)
    if kind == "patch":
        co = patch
    elif kind == "spread3":
        co = cen + rng.uniform(-3, 3, (n, 3, 3, 2))
    elif kind == "wide":
        co = cen + rng.uniform(-5, 5, (n, 3, 3, 2))
    elif kind == "borders":
        spots = np.array([[-0.5, 5], [W - 0.5, 5], [7, -0.5], [7, H - 0.5],
                          [-3.2, -3.2], [W + 2.7, H + 2.7], [-12, 8],
                          [W + 12, 8], [9, -12], [9, H + 12], [-4.0, 3],
                          [W + 4.0, H + 4.0]])
        co = (spots[np.arange(n) % len(spots)][:, None, None] + grid
              + 0.2 * rng.randn(n, 3, 3, 2))
    elif kind == "identical_integer":
        co = np.broadcast_to(np.round(cen), (n, 3, 3, 2)).copy()
    elif kind == "nonfinite":
        co = patch.copy()
        bad = [np.nan, np.inf, -np.inf, 1e30, -1e30]
        for i in range(0, n, 3):
            co[i, (i // 3) % 3, i % 3, i % 2] = bad[(i // 3) % len(bad)]
    else:
        raise ValueError(kind)
    return co.astype(np.float32)


def close_nan(got, want, rel, what=""):
    """NaNs at the same places; elsewhere max |got - want| <= rel * max(1,
    max |want|)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = ~np.isnan(want)
    scale = max(1.0, float(np.abs(want[ok]).max())) if ok.any() else 1.0
    err = float(np.abs(got[ok] - want[ok]).max()) if ok.any() else 0.0
    assert err <= rel * scale, (what, err, scale)


def lattice_problem(kind, seed):
    rng = np.random.RandomState(seed)
    gmap = rng.randn(MEM, M, 3, 3, 128).astype(np.float32)
    f1 = rng.randn(MEM, H, W, 128).astype(np.float32)
    f2 = rng.randn(MEM, H // 4, W // 4, 128).astype(np.float32)
    co = case_coords(kind, rng).reshape(NC, M * 9, 2)
    cells = np.stack([rng.randint(0, MEM, NC), rng.randint(0, MEM, NC)],
                     1).astype(np.int32)
    cells[2, 0] = -1                                   # a dead cell
    return (t(gmap), t(f1), t(f2), t(co[..., 0].copy()), t(co[..., 1].copy()),
            t(cells), M)


def train_problem(kind, seed, NG=6, NF=3):
    rng = np.random.RandomState(seed)
    gmap = rng.randn(NG, 3, 3, 128).astype(np.float32)
    f1 = rng.randn(NF, H, W, 128).astype(np.float32)
    f2 = pcorr.avg_pool2d(t(f1), 4).numpy()
    co = case_coords(kind, rng)
    kk = rng.randint(0, NG, E).astype(np.int32)
    jj = rng.randint(0, NF, E).astype(np.int32)
    # the training forward's per-level keep masks, denser than its p = 0.2
    keep = rng.rand(E, 1, 2) < 0.6
    ct = (rng.randn(E, 441, 2) * keep).reshape(E, 882).astype(np.float32)
    return ct, gmap, f1, f2, co, kk, jj


@pytest.mark.parametrize("kind", CASES)
def test_window_boxes(kind):
    """window_boxes at both levels: where an edge fits, every pixel's 8x8
    window lies inside its box, the box is the tightest one (an offset 0
    and an offset span on each axis) and no side exceeds cap + 8; where it
    does not, the box is a pixel's 8x8 at offset 0. The case's cap
    behaviour is what it is built for."""
    rng = np.random.RandomState(1)
    co = t(case_coords(kind, rng).reshape(E, 9, 2))
    for scale, (h, w) in ((1.0, (H, W)), (0.25, (H // 4, W // 4))):
        b = ck.window_boxes(co[..., 0] * scale, co[..., 1] * scale, h, w)
        f = b.fits
        assert (b.bw <= ck.CAP + 8).all() and (b.bh <= ck.CAP + 8).all()
        assert (b.bw >= 8).all() and (b.bh >= 8).all()
        # window of pixel q: taps x0 - 3 .. x0 + 4 == bx + ox .. bx + ox + 7
        assert (b.bx[f, None] + b.ox[f] == b.x0[f] - 3).all()
        assert (b.by[f, None] + b.oy[f] == b.y0[f] - 3).all()
        assert (b.ox[f] >= 0).all() and (b.ox[f] + 8 <= b.bw[f, None]).all()
        assert (b.oy[f] >= 0).all() and (b.oy[f] + 8 <= b.bh[f, None]).all()
        assert (b.ox[f].min(1).values == 0).all()
        assert (b.ox[f].max(1).values + 8 == b.bw[f]).all()
        assert (b.oy[f].max(1).values + 8 == b.bh[f]).all()
        assert (b.bw[~f] == 8).all() and (b.ox[~f] == 0).all()
        assert (b.bh[~f] == 8).all() and (b.oy[~f] == 0).all()
        assert not b.inside[~f].any()
        if scale == 1.0:
            if kind in ("patch", "spread3", "borders", "identical_integer"):
                assert f.all()
            if kind in ("wide", "nonfinite"):
                assert (~f).any() and f.any()
            if kind == "identical_integer":
                assert (b.bw == 8).all() and (b.bh == 8).all()
            if kind == "borders":
                assert (~b.inside).any() and b.inside.any()


def test_floor_index_non_finite():
    """floor_index: the kernels' clamp before the int conversion."""
    x = t(np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, -0.5, 2.0, 2.9],
                   np.float32))
    assert ck.floor_index(x).tolist() == [-10 ** 6, 10 ** 6, -10 ** 6,
                                          10 ** 6, -10 ** 6, -1, 2, 2]


@pytest.mark.parametrize("kind", CASES)
def test_corr_lattice_box_ref(kind):
    """corr_lattice_box_ref == corr_lattice_ref (1e-5 of scale; NaN outputs
    of non-finite coords at the same places), dead cells exactly zero, and
    the edges that took the per-pixel path are those the case is built to
    send there."""
    args = lattice_problem(kind, 2)
    want = ck.corr_lattice_ref(*args)
    got, slow = ck.corr_lattice_box_ref(*args)
    close_nan(got, want, 1e-5, kind)
    assert not got[2 * M:3 * M].any() and not want[2 * M:3 * M].any()
    assert not slow[2 * M:3 * M].any()
    if kind in ("wide", "nonfinite"):
        assert slow.any() and not slow.all()
    else:
        assert not slow.any()
    if kind == "nonfinite":
        assert np.isnan(want.numpy()).any()


@pytest.mark.parametrize("cap", [0, 2, 5])
def test_corr_lattice_box_ref_any_cap(cap):
    """The result does not depend on the cap (cap 0 sends nearly every
    edge pixel by pixel, cap 5 about half of the +-3 px edges)."""
    args = lattice_problem("spread3", 3)
    want = ck.corr_lattice_ref(*args)
    got, slow = ck.corr_lattice_box_ref(*args, cap=cap)
    close_nan(got, want, 1e-5)
    assert slow.any()


def test_corr_lattice_box_ref_vs_jax():
    """corr_lattice_box_ref == rampvo_tpu's exact corr + corr_stack on the
    live edges of the patch-shaped case (atol 1e-4 on sums of 128 products
    of unit normals)."""
    gmap, f1, f2, u, v, cells, _ = lattice_problem("patch", 4)
    got, _ = ck.corr_lattice_box_ref(gmap, f1, f2, u, v, cells, M)
    cn = cells.numpy()
    live = np.repeat(cn[:, 0] >= 0, M)
    sj = np.repeat(np.clip(cn[:, 0], 0, None), M)
    gidx = np.repeat(cn[:, 1], M) * M + np.tile(np.arange(M), NC)
    cf = jnp.asarray(np.stack([u.numpy(), v.numpy()], -1).reshape(E, 3, 3, 2))
    gf = jnp.asarray(gmap.numpy().reshape(MEM * M, 3, 3, 128))
    ref = np.asarray(j_corr_stack(
        j_corr(gf, jnp.asarray(f1.numpy()), cf, jnp.asarray(gidx),
               jnp.asarray(sj), 3),
        j_corr(gf, jnp.asarray(f2.numpy()), cf / 4.0, jnp.asarray(gidx),
               jnp.asarray(sj), 3)))
    np.testing.assert_allclose(got.numpy()[live], ref[live], atol=1e-4)


@pytest.mark.parametrize("kind", CASES)
def test_corr_train_bwd_box_ref(kind):
    """corr_train_bwd_box_ref == corr_train_bwd_ref for all three
    gradients (1e-4 of each gradient's scale; NaNs of non-finite coords at
    the same places), with the per-pixel path taken where the case sends
    it."""
    ct, gmap, f1, f2, co, kk, jj = train_problem(kind, 5)
    a = (t(ct), t(gmap), t(f1), t(f2), t(co), t(kk), t(jj))
    want = ctk.corr_train_bwd_ref(*a)
    got, slow = ctk.corr_train_bwd_box_ref(*a)
    for g, w_, name in zip(got, want, ("gmap", "fmap1", "fmap2")):
        close_nan(g, w_, 1e-4, f"{kind} {name}")
        assert np.nanmax(np.abs(w_.numpy())) > 0
    if kind in ("wide", "nonfinite"):
        assert slow.any() and not slow.all()
    else:
        assert not slow.any()


def test_corr_train_bwd_box_ref_any_cap():
    """The gradients do not depend on the cap (cap 0: pixel by pixel)."""
    ct, gmap, f1, f2, co, kk, jj = train_problem("spread3", 6)
    a = (t(ct), t(gmap), t(f1), t(f2), t(co), t(kk), t(jj))
    want = ctk.corr_train_bwd_ref(*a)
    got, slow = ctk.corr_train_bwd_box_ref(*a, cap=0)
    assert slow.any()
    for g, w_ in zip(got, want):
        close_nan(g, w_, 1e-4)


def test_corr_train_bwd_box_ref_vs_jax():
    """corr_train_bwd_box_ref == the VJP of rampvo_tpu's corr_train at both
    levels (stacked by corr_stack) for grad gmap and both maps' gradients,
    patch-shaped case, 1e-4 of scale."""
    ct, gmap, f1, f2, co, kk, jj = train_problem("patch", 7)

    def fwd(g, a, b):
        k, j = jnp.asarray(kk), jnp.asarray(jj)
        c = jnp.asarray(co)
        return j_corr_stack(j_corr_train(g, a, c, k, j, 3),
                            j_corr_train(g, b, c / 4.0, k, j, 3))

    _, vjp = jax.vjp(fwd, jnp.asarray(gmap), jnp.asarray(f1), jnp.asarray(f2))
    want = vjp(jnp.asarray(ct))
    got, _ = ctk.corr_train_bwd_box_ref(t(ct), t(gmap), t(f1), t(f2), t(co),
                                        t(kk), t(jj))
    for g, w_, name in zip(got, want, ("gmap", "fmap1", "fmap2")):
        close_nan(g, np.asarray(w_), 1e-4, name)


def test_k8_wrapper_checks_slow_counter():
    """The K8 wrapper refuses a slow-path counter that is not one CUDA
    int32, before any build."""
    ct, gmap, f1, f2, co, kk, jj = train_problem("patch", 8)
    with pytest.raises(ValueError, match="CUDA"):
        ctk.corr_train_bwd_cuda(t(ct), t(gmap), t(f1), t(f2), t(co), t(kk),
                                t(jj), slow=torch.zeros(1, dtype=torch.int32))
