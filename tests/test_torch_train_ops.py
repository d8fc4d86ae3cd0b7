"""The training path's modules in rampvo_tpu_torch against rampvo_tpu on the
CPU: the plain training correlation (K7/K8's plain version) and its
gradient, gradient dropout, the edge schedule, static neighbours,
grad_clip, the update operator on a static schedule, both window
encoders, the differentiable BA, the losses, the optimizer, and the guard
that keeps the inference-only kernels K2/K3 off autograd graphs.

Inputs are made with numpy from fixed seeds and go through both packages;
network weights come from a seeded flax VONet.init carried over by
`from_flax_params`, which maps a flax gradient tree onto the port's
parameter names as well (its mapping is a transpose per leaf). Tolerances
are stated per test.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rampvo_tpu.ba.core import ba_train as j_ba_train
from rampvo_tpu.cli.train import make_optimizer as j_make_optimizer
from rampvo_tpu.lie import SE3
from rampvo_tpu.lie import ops as jl
from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.models.blocks import grad_clip as j_grad_clip
from rampvo_tpu.ops.corr import corr_stack as j_corr_stack
from rampvo_tpu.ops.corr import corr_train as j_corr_train
from rampvo_tpu.ops.neighbors import neighbors_presorted as j_presorted
from rampvo_tpu.ops.neighbors import neighbors_static_order as j_static_order
from rampvo_tpu.train import forward as jfw
from rampvo_tpu.train.loss import kabsch_umeyama_scale as j_kabsch
from rampvo_tpu.train.loss import masked_norm as j_masked_norm
from rampvo_tpu.train.loss import pose_loss_terms as j_pose_loss_terms
from rampvo_tpu_torch.ba.core import ba_train
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.lie import ops as pl
from rampvo_tpu_torch.models.blocks import grad_clip
from rampvo_tpu_torch.models.vonet import VONet
from rampvo_tpu_torch.ops import corr as pcorr
from rampvo_tpu_torch.ops import corr_train_kernels as ctk
from rampvo_tpu_torch.ops import encoder_kernels as ek
from rampvo_tpu_torch.ops import neighbors as pnb
from rampvo_tpu_torch.ops import singlescale_kernels as sk
from rampvo_tpu_torch.train import forward as pfw
from rampvo_tpu_torch.train.loss import (
    kabsch_umeyama_scale,
    masked_norm,
    pose_loss_terms,
)
from rampvo_tpu_torch.train.step import Trainer, onecycle_lr


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, rel, what=""):
    """max |got - want| <= rel * max(1, max |want|)."""
    got, want = npy(got), npy(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if want.size else 0.0
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert err <= rel * scale, (what, err, scale)


def grads_close(jgrads, pnet, mode, rel):
    """Every parameter gradient of the port's `pnet` against a flax
    gradient tree, mapped by `from_flax_params`."""
    want = from_flax_params(jax.tree_util.tree_map(np.asarray, jgrads), mode)
    named = dict(pnet.named_parameters())
    assert want.keys() == named.keys()
    for k, g in want.items():
        got = named[k].grad
        got = torch.zeros_like(g) if got is None else got
        close(got, g, rel, k)


@functools.lru_cache(maxsize=None)
def _weights(mode):
    """Seeded flax weights of one input mode and the port's VONet holding
    the same weights."""
    params = jax.jit(JVONet(input_mode=mode).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 5)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    params = jax.tree_util.tree_map(np.asarray, params)
    net = VONet(mode)
    net.load_state_dict(from_flax_params(params, mode))
    return mode, params, net


@pytest.fixture(scope="module", params=["MultiScale", "SingleScale"])
def weights(request):
    return _weights(request.param)


@pytest.fixture(scope="module")
def ms_weights():
    return _weights("MultiScale")


# ---------------------------------------------------------------------------
# plain training correlation (K7 / K8's plain version)
# ---------------------------------------------------------------------------

def _corr_problem(rng, E, NG=6, NF=3, H=12, W=16, C=128):
    gmap = rng.randn(NG, 3, 3, C).astype(np.float32)
    fmap = rng.randn(NF, H, W, C).astype(np.float32)
    # centers over and beyond the map (clip and zero padding), pixel offsets
    cen = rng.uniform([-6, -6], [W + 6, H + 6], (E, 1, 1, 2))
    coords = (cen + rng.uniform(-1.5, 1.5, (E, 3, 3, 2))).astype(np.float32)
    kk = rng.randint(0, NG, E).astype(np.int32)
    jj = rng.randint(0, NF, E).astype(np.int32)
    return gmap, fmap, coords, kk, jj


@pytest.mark.parametrize("E", [16, 13])
def test_corr_train_plain(E):
    """ops/corr.py::corr_train == the JAX corr_train: the output (atol
    1e-4 on sums of 128 products of unit normals) and its VJP for a random
    output gradient (grad gmap and grad fmap within 1e-4 of scale; the
    coords gradient is zero in both). E = 16 runs 8 edge chunks, E = 13
    one."""
    rng = np.random.RandomState(E)
    gmap, fmap, coords, kk, jj = _corr_problem(rng, E)
    ct = rng.randn(E, 3, 3, 49).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda g, f, c: j_corr_train(g, f, c, jnp.asarray(kk),
                                     jnp.asarray(jj), 3),
        jnp.asarray(gmap), jnp.asarray(fmap), jnp.asarray(coords))
    gg_j, gf_j, gc_j = vjp(jnp.asarray(ct))
    g, f, c = t(gmap, True), t(fmap, True), t(coords, True)
    out_p = pcorr.corr_train(g, f, c, t(kk).long(), t(jj).long(), 3)
    gg, gf, gc = torch.autograd.grad(out_p, (g, f, c), t(ct))
    close(out_p, out_j, 1e-4, "out")
    close(gg, gg_j, 1e-4, "gmap")
    close(gf, gf_j, 1e-4, "fmap")
    assert not npy(gc).any() and not npy(gc_j).any()


def test_corr_train_two_level_plain():
    """The kernel's plain version, `corr_train_fused` on CPU tensors, ==
    the JAX XLA training path (corr_train at both levels, coords / 4 on the
    4x pool, corr_stack): output atol 1e-4, and the VJP through
    avg_pool2d into the level-1 map within 1e-4 of scale.
    `corr_train_bwd_ref`, the kernel's plain backward, gives the same
    gradients as autograd through the forward."""
    rng = np.random.RandomState(3)
    E = 24
    gmap, fmap, coords, kk, jj = _corr_problem(rng, E, H=16, W=24)
    ct = rng.randn(E, 882).astype(np.float32)

    def j_fwd(g, f, c):
        k, j = jnp.asarray(kk), jnp.asarray(jj)
        f2 = jfw.avg_pool2d(f, 4)
        return j_corr_stack(j_corr_train(g, f, c, k, j, 3),
                            j_corr_train(g, f2, c / 4.0, k, j, 3))

    out_j, vjp = jax.vjp(j_fwd, jnp.asarray(gmap), jnp.asarray(fmap),
                         jnp.asarray(coords))
    gg_j, gf_j, _ = vjp(jnp.asarray(ct))
    launches = (ctk.corr_train_cuda.launches, ctk.corr_train_bwd_cuda.launches)
    g, f, c = t(gmap, True), t(fmap, True), t(coords, True)
    f2 = pcorr.avg_pool2d(f, 4)
    out_p = ctk.corr_train_fused(g, f, f2, c, t(kk).long(), t(jj).long())
    gg, gf, gc = torch.autograd.grad(out_p, (g, f, c), t(ct))
    assert (ctk.corr_train_cuda.launches,
            ctk.corr_train_bwd_cuda.launches) == launches  # CPU: plain
    assert out_p.shape == (E, 882)
    close(out_p, out_j, 1e-4, "out")
    close(gg, gg_j, 1e-4, "gmap")
    close(gf, gf_j, 1e-4, "fmap")
    assert not npy(gc).any()
    # the plain backward against autograd, level by level
    f2d = f2.detach()
    gb, g1, g2 = ctk.corr_train_bwd_ref(t(ct), t(gmap), t(fmap), f2d,
                                        t(coords), t(kk), t(jj))
    g_, f1_, f2_ = (x.detach().requires_grad_() for x in (t(gmap), t(fmap),
                                                          f2d))
    ref = ctk.corr_train_ref(g_, f1_, f2_, t(coords), t(kk).long(),
                             t(jj).long())
    a = torch.autograd.grad(ref, (g_, f1_, f2_), t(ct))
    for got, want, name in zip((gb, g1, g2), a, ("gmap", "fmap1", "fmap2")):
        close(got, want, 1e-5, name)


def test_corr_train_kernel_wrapper_checks():
    """The K7/K8 wrapper refuses what the kernel does not take, before any
    build: CPU tensors (the kernel entry), other channel counts, mixed
    dtypes."""
    rng = np.random.RandomState(4)
    gmap, fmap, coords, kk, jj = _corr_problem(rng, 8)
    f2 = pcorr.avg_pool2d(t(fmap), 4)
    with pytest.raises(ValueError, match="CUDA"):
        ctk.corr_train_cuda(t(gmap), t(fmap), f2, t(coords), t(kk), t(jj))
    with pytest.raises(ValueError, match="128"):
        ctk.corr_train_cuda(t(gmap)[..., :64], t(fmap), f2, t(coords), t(kk),
                            t(jj))
    with pytest.raises(TypeError):
        ctk.corr_train_cuda(t(gmap).double(), t(fmap), f2, t(coords), t(kk),
                            t(jj))


# ---------------------------------------------------------------------------
# gradient dropout, edge schedule, neighbours, grad_clip
# ---------------------------------------------------------------------------

def test_corr_grad_dropout():
    """corr_grad_dropout on the stacked layout with keep masks drawn as the
    JAX path draws them (uniform(k, (E,)) < 0.2, one key per level) ==
    the JAX per-level corr_grad_dropout before corr_stack: identity
    forward, equal gradients (exact: a mask multiply)."""
    rng = np.random.RandomState(5)
    E = 40
    c1 = rng.randn(E, 3, 3, 49).astype(np.float32)
    c2 = rng.randn(E, 3, 3, 49).astype(np.float32)
    ct = rng.randn(E, 882).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))

    def j_fwd(a, b):
        return j_corr_stack(jfw.corr_grad_dropout(a, k1, 0.2),
                            jfw.corr_grad_dropout(b, k2, 0.2))

    out_j, vjp = jax.vjp(j_fwd, jnp.asarray(c1), jnp.asarray(c2))
    g1_j, g2_j = vjp(jnp.asarray(ct))
    keep1 = np.asarray(jax.random.uniform(k1, (E,)) < 0.2)
    keep2 = np.asarray(jax.random.uniform(k2, (E,)) < 0.2)
    assert keep1.any() and not keep1.all() and (keep1 != keep2).any()
    x = pcorr.corr_stack(t(c1), t(c2)).detach().requires_grad_()
    y = pfw.corr_grad_dropout(x, t(keep1), t(keep2))
    (gx,) = torch.autograd.grad(y, x, t(ct))
    np.testing.assert_array_equal(npy(y), npy(out_j))
    want = npy(j_corr_stack(g1_j, g2_j))
    np.testing.assert_array_equal(npy(gx), want)


@pytest.mark.parametrize("cfg", [(15, 80, 18), (9, 4, 9), (10, 4, 12)])
def test_edge_schedule(cfg):
    """edge_schedule == the JAX schedule, array for array; the recipe's
    schedule has 18000 edges."""
    a = jfw.edge_schedule(*cfg)
    b = pfw.edge_schedule(*cfg)
    for name in a._fields:
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    if cfg == (15, 80, 18):
        assert b.ii.shape == (18000,)


def test_neighbors_on_schedule():
    """On the training schedule with a random validity mask, the port's
    sorting `neighbors` (what its training forward runs) == the JAX
    neighbors_presorted (what the JAX training forward runs), exact."""
    s = pfw.edge_schedule(10, 4, 12)
    rng = np.random.RandomState(6)
    valid = rng.rand(s.ii.shape[0]) < 0.7
    jo, jts = j_static_order(s.kk, s.jj)
    a = j_presorted(jo, jts, jnp.asarray(valid))
    b = pnb.neighbors(t(s.kk), t(s.jj), t(valid))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(npy(y), npy(x))


def test_grad_clip():
    """grad_clip: identity forward; backward zeroes NaNs and clamps to
    +-0.01, == the JAX custom VJP (exact)."""
    x = np.linspace(-1, 1, 8).astype(np.float32)
    g = np.array([np.nan, -5, -0.02, -0.005, 0, 0.003, 0.5, np.inf],
                 np.float32)
    _, vjp = jax.vjp(j_grad_clip, jnp.asarray(x))
    (gj,) = vjp(jnp.asarray(g))
    xt = t(x, True)
    y = grad_clip(xt)
    (gp,) = torch.autograd.grad(y, xt, t(g))
    np.testing.assert_array_equal(npy(y), x)
    np.testing.assert_array_equal(npy(gp), npy(gj))


# ---------------------------------------------------------------------------
# update operator on a static schedule
# ---------------------------------------------------------------------------

def test_update_static_schedule(ms_weights):
    """Update with the training forward's precompacted SoftAgg ids == the
    flax update_op with its static_sched: net, delta and weight (atol
    2e-4), and the gradients of a random linear functional of the three
    outputs with respect to every parameter and to net, inp and corr
    (within 2e-3 of scale: 384-wide float32 layers in both directions,
    LayerNorm variance formulas differ). The d/w heads' grad_clip is
    active: their incoming gradients exceed 0.01."""
    mode, params, net = ms_weights
    s = pfw.edge_schedule(9, 4, 9)
    E = s.ii.shape[0]
    rng = np.random.RandomState(7)
    valid = rng.rand(E) < 0.8
    h = rng.randn(E, 384).astype(np.float32)
    inp = rng.randn(E, 384).astype(np.float32)
    corr = rng.randn(E, 882).astype(np.float32)
    a, b, c = (rng.randn(E, 384).astype(np.float32),
               rng.randn(E, 2).astype(np.float32),
               rng.randn(E, 2).astype(np.float32))
    fj = jfw.TrainForward(JVONet(), n_frames=9, M=4, steps=9)
    fp = pfw.TrainForward(net, n_frames=9, M=4, steps=9)
    agg_ids = fp._tables(torch.device("cpu"))[4]
    vm = valid.astype(np.float32)[:, None]

    def j_loss(p, h_, i_, c_):
        n2, (d, w) = JVONet().apply(
            p, h_, i_, c_, jnp.asarray(s.ii), jnp.asarray(s.jj),
            jnp.asarray(s.kk), jnp.asarray(valid), None, fj.static_sched,
            method=JVONet.update_op)
        return (jnp.sum(vm * a * n2) + jnp.sum(vm * b * d)
                + jnp.sum(vm * c * w)), (n2, d, w)

    (lj, outs_j), gj = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        params, jnp.asarray(h), jnp.asarray(inp), jnp.asarray(corr))
    net.zero_grad()
    hp_, ip_, cp_ = t(h, True), t(inp, True), t(corr, True)
    n2, (d, w) = net.update(hp_, ip_, cp_, t(s.ii).long(), t(s.jj).long(),
                            t(s.kk).long(), t(valid), agg_ids=agg_ids)
    tv = t(vm)
    loss = (tv * t(a) * n2).sum() + (tv * t(b) * d).sum() + (tv * t(c) * w).sum()
    loss.backward()
    for x, y, name in zip((n2, d, w), outs_j, ("net", "delta", "weight")):
        close(npy(x)[valid], npy(y)[valid], 2e-4, name)
    grads_close(gj[0], net, mode, 2e-3)
    for x, y, name in zip((hp_, ip_, cp_), gj[1:], ("net", "inp", "corr")):
        close(x.grad, y, 2e-3, name)


# ---------------------------------------------------------------------------
# window encoders
# ---------------------------------------------------------------------------

def test_window_encoder(weights):
    """VONet.encode (a window from a fresh state) == the flax
    VONet.encode: fmap and imap (atol 1e-4 on O(1) maps) and the
    gradients of a random linear functional of both with respect to every
    parameter (within 2e-3 of scale; the 3x3/7x7 convolution chains sum
    in other orders in backward). MultiScale: the dataset's mask (one
    voxel between frames, a padded voxel at the end). SingleScale: one
    voxel per frame, the only window the reference defines (its encoder
    zips events with images)."""
    mode, params, net = weights
    NF, H, W = 3, 32, 48
    rng = np.random.RandomState(8)
    if mode == "MultiScale":
        mask = np.array([True, False, True, False, True, False])
    else:
        mask = np.ones(NF, bool)
    T = mask.size
    ev = rng.rand(T, H, W, 5).astype(np.float32)
    im = rng.rand(NF, H, W, 3).astype(np.float32)
    A = rng.randn(NF, H // 4, W // 4, 128).astype(np.float32)
    B = rng.randn(NF, H // 4, W // 4, 384).astype(np.float32)

    def j_loss(p):
        f, i, _ = JVONet(input_mode=mode).apply(
            p, jnp.asarray(ev), jnp.asarray(im), jnp.asarray(mask), None,
            NF, method=JVONet.encode)
        return jnp.sum(A * f) + jnp.sum(B * i), (f, i)

    (_, (fj, ij)), gj = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        params)
    net.zero_grad()
    fp, ip = net.encode(t(ev), t(im), mask, NF)
    ((t(A) * fp).sum() + (t(B) * ip).sum()).backward()
    close(fp, fj, 1e-4, "fmap")
    close(ip, ij, 1e-4, "imap")
    grads_close(gj, net, mode, 2e-3)


def test_singlescale_window_needs_one_image_per_voxel():
    """The SingleScale window encoder raises for fewer images than voxels
    (voxels between frames), where the reference's scan raises too."""
    enc = VONet("SingleScale").patchify.encoder
    mask = np.array([True, False, True, False])
    with pytest.raises(NotImplementedError, match="one image per voxel"):
        enc.encode_window(torch.zeros(4, 16, 16, 5),
                          torch.zeros(2, 16, 16, 3), mask, 2)


# ---------------------------------------------------------------------------
# differentiable BA
# ---------------------------------------------------------------------------

def _ba_problem(rng, NF=4, M=6, P=3):
    s = pfw.edge_schedule(8, M, 1)
    keep = (s.ii < NF) & (s.jj < NF)
    ii, jj, kk = s.ii[keep], s.jj[keep], s.kk[keep]
    xi = (0.05 * rng.randn(NF, 6)).astype(np.float32)
    xi[0] = 0
    poses = np.asarray(jl.se3_exp(jnp.asarray(xi)))
    Np = NF * M
    ctr = rng.uniform([4, 4], [20, 14], (Np, 2))
    off = np.stack(np.meshgrid(np.arange(P) - 1, np.arange(P) - 1,
                               indexing="xy"), 0)
    xy = ctr[:, :, None, None] + off[None]
    d = rng.uniform(0.3, 1.2, (Np, 1, 1, 1)) * np.ones((1, 1, P, P))
    patches = np.concatenate([xy, d], 1).astype(np.float32)
    intr = np.tile(np.array([20.0, 20.0, 12.0, 9.0], np.float32), (NF, 1))
    E = ii.shape[0]
    tgt = (ctr[kk] + rng.randn(E, 2)).astype(np.float32)
    wgt = rng.uniform(0.1, 1.0, (E, 2)).astype(np.float32)
    valid = rng.rand(E) < 0.9
    return poses, patches, intr, tgt, wgt, ii, jj, kk, valid


@pytest.mark.parametrize("structure_only", [False, True])
def test_ba_train(structure_only):
    """ba_train == the JAX ba_train (one Gauss-Newton step, 4 frames with
    frame 0 fixed, 6 patches each, self-edges included): the new poses and
    patches (atol 1e-4), and the gradients of a random linear functional
    of both with respect to poses, patches, targets and weights (within
    2e-3 of scale: a 6N x 6N Cholesky solve differentiated in float32).
    `structure_only` keeps the poses."""
    rng = np.random.RandomState(9 + structure_only)
    poses, patches, intr, tgt, wgt, ii, jj, kk, valid = _ba_problem(rng)
    bounds = (-20.0, -20.0, 44.0, 38.0)
    A = rng.randn(*poses.shape).astype(np.float32)
    B = rng.randn(*patches.shape).astype(np.float32)

    def j_loss(po, pa, tg, wg):
        G, pt = j_ba_train(SE3(po[None]), pa[None], jnp.asarray(intr)[None],
                           tg[None], wg[None], jnp.float32(1e-4),
                           jnp.asarray(ii), jnp.asarray(jj), jnp.asarray(kk),
                           bounds, ep=10.0, fixedp=1,
                           structure_only=structure_only,
                           valid=jnp.asarray(valid))
        G, pt = G.data[0], pt[0]
        return jnp.sum(A * G) + jnp.sum(B * pt), (G, pt)

    (_, (Gj, pj)), gj = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(poses), jnp.asarray(patches), jnp.asarray(tgt),
        jnp.asarray(wgt))
    ins = [t(x, True) for x in (poses, patches, tgt, wgt)]
    G, pt = ba_train(ins[0], ins[1], t(intr), ins[2], ins[3], 1e-4,
                     t(ii).long(), t(jj).long(), t(kk).long(), bounds,
                     ep=10.0, fixedp=1, structure_only=structure_only,
                     valid=t(valid))
    ((t(A) * G).sum() + (t(B) * pt).sum()).backward()
    close(G, Gj, 1e-4, "poses")
    close(pt, pj, 1e-4, "patches")
    if structure_only:
        np.testing.assert_array_equal(npy(G), poses)
    else:
        assert np.abs(npy(G) - poses).max() > 1e-4
    for x, y, name in zip(ins, gj, ("poses", "patches", "targets", "weights")):
        close(x.grad, y, 2e-3, name)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_losses():
    """pose_loss_terms (6 frames, 4 live), masked_norm (rows masked, one
    of them exactly zero) and kabsch_umeyama_scale == the JAX losses:
    values atol 1e-5 and gradients with respect to the predicted poses /
    the vectors within 1e-4 of scale; the zero row's gradient stays finite
    (zero)."""
    rng = np.random.RandomState(10)
    G = np.asarray(jl.se3_exp(jnp.asarray(0.2 * rng.randn(6, 6),
                                          jnp.float32)))
    P = np.asarray(jl.se3_exp(jnp.asarray(0.2 * rng.randn(6, 6),
                                          jnp.float32)))

    def j_pl(g):
        tr, ro = j_pose_loss_terms(g, jnp.asarray(P), 4)
        return tr + 2 * ro, (tr, ro)

    (_, (trj, roj)), gj = jax.jit(jax.value_and_grad(j_pl, has_aux=True))(
        jnp.asarray(G))
    gt = t(G, True)
    tr, ro = pose_loss_terms(gt, t(P), 4)
    (tr + 2 * ro).backward()
    close(tr, trj, 1e-5, "tr")
    close(ro, roj, 1e-5, "ro")
    close(gt.grad, gj, 1e-4, "dG")

    x = rng.randn(10, 3).astype(np.float32)
    x[2] = 0
    mask = rng.rand(10) < 0.6
    mask[2] = False
    w = rng.randn(10).astype(np.float32)
    vj, gxj = jax.jit(jax.value_and_grad(
        lambda a: jnp.sum(w * j_masked_norm(a, jnp.asarray(mask)))))(
        jnp.asarray(x))
    xt = t(x, True)
    (t(w) * masked_norm(xt, t(mask))).sum().backward()
    close(xt.grad, gxj, 1e-5, "masked_norm grad")
    A = rng.randn(12, 3).astype(np.float32)
    B = (1.7 * A[:, ::-1] + 0.01 * rng.randn(12, 3)).astype(np.float32)
    close(kabsch_umeyama_scale(t(A), t(B)),
          j_kabsch(jnp.asarray(A), jnp.asarray(B)), 1e-5, "umeyama")
    assert np.isfinite(npy(xt.grad)).all() and not npy(xt.grad)[2].any()
    close((t(w) * masked_norm(t(x), t(mask))).sum(), vj, 1e-5,
          "masked_norm")


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_onecycle_schedule():
    """onecycle_lr == optax.linear_onecycle_schedule as the JAX CLI builds
    it (pct_final 1, div 25, final div 1e4) at the recipe's length and at
    a short one (rtol 1e-6)."""
    for total in (400000, 300):
        ref = optax.linear_onecycle_schedule(
            transition_steps=total, peak_value=8e-5, pct_start=0.01,
            pct_final=1.0, div_factor=25.0, final_div_factor=1e4)
        for k in sorted({0, 1, 2, int(0.01 * total) - 1, int(0.01 * total),
                         int(0.01 * total) + 1, total // 2, total - 1, total,
                         total + 5}):
            np.testing.assert_allclose(
                onecycle_lr(k, total, 8e-5, 0.01),
                float(ref(k)), rtol=1e-6, err_msg=str((total, k)))


def test_trainer_matches_optax():
    """Three Trainer steps (global-norm clip 0.1, AdamW with weight decay,
    the one-cycle rate) == the JAX CLI's make_optimizer chain on the same
    parameters and gradients (rtol 1e-5, atol 1e-8). The first two
    gradients exceed the clip, the third does not."""
    rng = np.random.RandomState(11)
    cfg = {"steps": 300, "lr": 8e-5, "pct_start": 0.01, "clip": 0.1,
           "weight_decay": 1e-6}
    w0 = rng.randn(5, 4).astype(np.float32)
    b0 = rng.randn(5).astype(np.float32)
    grads = [(rng.randn(5, 4) * s, rng.randn(5) * s)
             for s in (1.0, 0.5, 0.001)]
    mod = torch.nn.Linear(4, 5)
    with torch.no_grad():
        mod.weight.copy_(t(w0))
        mod.bias.copy_(t(b0))
    tr = Trainer(mod, cfg)
    for gw, gb in grads:
        gw, gb = t(gw.astype(np.float32)), t(gb.astype(np.float32))

        def loss_fn():
            loss = (mod.weight * gw).sum() + (mod.bias * gb).sum()
            return loss, {"loss": loss}

        tr.step(loss_fn)
    opt = j_make_optimizer(cfg)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = opt.init(params)
    for gw, gb in grads:
        up, state = opt.update({"w": jnp.asarray(gw, jnp.float32),
                                "b": jnp.asarray(gb, jnp.float32)},
                               state, params)
        params = optax.apply_updates(params, up)
    np.testing.assert_allclose(npy(mod.weight), npy(params["w"]), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(npy(mod.bias), npy(params["b"]), rtol=1e-5,
                               atol=1e-8)
    assert tr.count == 3


# ---------------------------------------------------------------------------
# K2 / K3 stay off autograd graphs
# ---------------------------------------------------------------------------

def test_encoder_kernels_refuse_autograd():
    """K2's and K3's wrappers have no backward, so on the card they raise
    when grad is enabled and an input requires grad, instead of returning
    a tensor cut from the graph. The check runs first in the CUDA entry,
    so CPU tensors reach it here; under no_grad (the VO runtime) the entry
    goes on to its device check."""
    hw = 32
    x = torch.randn(8, hw)
    ss = torch.randn(16, hw)
    w2 = (torch.randn(8, 8 * 16, requires_grad=True), torch.randn(8 * 16),
          torch.randn(3 * 16, 16), torch.randn(16))
    with pytest.raises(RuntimeError, match="autograd"):
        ek.lstm_fold_cuda(x, ss, *w2)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        ek.lstm_fold_cuda(x, ss, *w2)
    hc = torch.randn(64, hw, requires_grad=True)
    w3 = (torch.randn(8, 128), torch.randn(32, 128), torch.randn(128),
          torch.randn(32, 16), torch.randn(16))
    pres = torch.ones(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="autograd"):
        sk.lstm_carry_fold_cuda(x, hc, ss, *w3, pres)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        sk.lstm_carry_fold_cuda(x, hc, ss, *w3, pres)
    # no input requires grad: the guard lets the call through to the check
    with pytest.raises(ValueError, match="CUDA"):
        sk.lstm_carry_fold_cuda(x, hc.detach(), ss, *w3, pres)
