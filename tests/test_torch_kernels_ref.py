"""The plain versions of rampvo_tpu_torch's two Hopper kernels against the
JAX package on the CPU: lstm_fold_ref against the Pallas lstm_fold_cm in
interpret mode, the encoder chain against VONet.encode, corr_lattice_ref
against the exact ops/corr.py and against the Pallas corr_lattice_fused3
in interpret mode (inside its SPREAD window, through paired_corr_perm).
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.models.encoders import MultiScaleEncoder as JMSEncoder
from rampvo_tpu.ops.corr import corr as j_corr
from rampvo_tpu.ops.corr import corr_stack as j_corr_stack
from rampvo_tpu.ops.corr_pallas import (
    _cell_tables,
    _cell_vmask,
    corr_lattice_fused3,
    paired_corr_perm,
)
from rampvo_tpu.ops.encoder_pallas import lstm_fold_cm as j_lstm_fold_cm
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.models.encoders import multiscale_init_state
from rampvo_tpu_torch.models.vonet import VONet
from rampvo_tpu_torch.ops import corr_kernels as ck
from rampvo_tpu_torch.ops import encoder_kernels as ek


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
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# K2: LSTM + fold
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_fold_ref_vs_pallas(h, dtype):
    """lstm_fold_ref == lstm_fold_cm(interpret=True). f32: atol 1e-5;
    bf16 inputs/outputs: within 1e-2 of scale (one bf16 output rounding)."""
    rng = np.random.RandomState(h)
    HW = 300
    x = rng.randn(8, HW).astype(np.float32)
    ss = rng.randn(h, HW).astype(np.float32)
    wg = (0.5 * rng.randn(8, 8 * h)).astype(np.float32)
    bg = (0.1 * rng.randn(8 * h)).astype(np.float32)
    wf = (rng.randn(3 * h, h) / np.sqrt(3 * h)).astype(np.float32)
    bf = (0.1 * rng.randn(h)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    a = j_lstm_fold_cm(jnp.asarray(x, jdt), jnp.asarray(ss, jdt),
                       jnp.asarray(wg), jnp.asarray(bg), jnp.asarray(wf),
                       jnp.asarray(bf), hwb=256, interpret=True)
    b = ek.lstm_fold_ref(t(x).to(tdt), t(ss).to(tdt), t(wg), t(bg), t(wf),
                         t(bf))
    assert b.dtype == tdt and b.shape == (h, HW)
    a, b = npy(a), npy(b)
    tol = 1e-5 if dtype == "float32" else 1e-2 * max(1.0, np.abs(a).max())
    assert np.abs(a - b).max() <= tol


def fold_problem(h, HW=300, seed=None):
    """Seeded K2 inputs (x, ss, wg, bg, wf, bf) as numpy float32."""
    rng = np.random.RandomState(h if seed is None else seed)
    return (rng.randn(8, HW).astype(np.float32),
            rng.randn(h, HW).astype(np.float32),
            (0.5 * rng.randn(8, 8 * h)).astype(np.float32),
            (0.1 * rng.randn(8 * h)).astype(np.float32),
            (rng.randn(3 * h, h) / np.sqrt(3 * h)).astype(np.float32),
            (0.1 * rng.randn(h)).astype(np.float32))


@pytest.mark.parametrize("h", [16, 32, 64])
def test_lstm_fold_bf16_ref(h):
    """lstm_fold_bf16_ref (the bf16 kernel's roundings: bf16 weights, bf16
    LSTM output before the fold, f32 sums) on bf16 inputs, rounded to bf16
    as the kernel's output is: within 1e-2 of scale of lstm_fold_ref and
    of the Pallas lstm_fold_cm(interpret=True) (a few bf16 roundings
    apart), and within half an output ulp of its own unrounded result."""
    x, ss, wg, bg, wf, bf = fold_problem(h)
    xb, ssb = t(x).bfloat16(), t(ss).bfloat16()
    w = (t(wg), t(bg), t(wf), t(bf))
    got = ek.lstm_fold_bf16_ref(xb, ssb, *w)
    assert got.dtype == torch.float32 and got.shape == (h, x.shape[1])
    gotb = npy(got.bfloat16())
    a = npy(j_lstm_fold_cm(jnp.asarray(x, jnp.bfloat16),
                           jnp.asarray(ss, jnp.bfloat16), jnp.asarray(wg),
                           jnp.asarray(bg), jnp.asarray(wf), jnp.asarray(bf),
                           hwb=256, interpret=True))
    b = npy(ek.lstm_fold_ref(xb, ssb, *w))
    for want in (a, b):
        assert np.abs(gotb - want).max() <= 1e-2 * max(1.0, np.abs(want).max())
    assert np.abs(gotb - npy(got)).max() <= 2.0 ** -8 * np.abs(npy(got)).max()


@pytest.mark.parametrize("h", [16, 32, 64])
def test_pack_fold_weights(h):
    """pack_fold_weights puts each weight where csrc/lstm_fold.cu reads
    it: lane l = 4g + t of gate chunk c, gate G (i, g, o) holds
    wg[2t + i, off_G + 8c + g] (i = 0, 1); lane l of fold k-step ks,
    n-tile nt holds wf[16 ks + 2t + i + 8 j, 8 nt + g] (j, i = 0, 1); the
    biases follow the same chunks. Weights in bf16, biases exact."""
    _, _, wg, bg, wf, bf = fold_problem(h, seed=h + 1)
    fw = ek.pack_fold_weights(t(wg), t(bg), t(wf), t(bf))
    assert fw.frag.dtype == torch.bfloat16 and fw.bias.dtype == torch.float32
    frag = fw.frag.float().numpy()
    nch, ks, nt = 2 * h // 8, 3 * h // 16, h // 8
    lane = np.arange(32)
    g, tt = lane // 4, lane % 4
    rb = lambda a: t(a).bfloat16().float().numpy()
    gate = frag[:48 * h].reshape(nch, 3, 32, 2)
    want = np.empty_like(gate)
    for c in range(nch):
        for G, off in enumerate((0, 4 * h, 6 * h)):
            for i in range(2):
                want[c, G, :, i] = rb(wg)[2 * tt + i, off + 8 * c + g]
    np.testing.assert_array_equal(gate, want)
    fold = frag[48 * h:].reshape(ks, nt, 32, 4)
    want = np.empty_like(fold)
    for k in range(ks):
        for n in range(nt):
            for j in range(4):
                want[k, n, :, j] = rb(wf)[16 * k + 2 * tt + j % 2 + 8 * (j // 2),
                                          8 * n + g]
    np.testing.assert_array_equal(fold, want)
    bias = fw.bias.numpy()
    gb = bias[:24 * nch].reshape(nch, 3, 8)
    for c in range(nch):
        for G, off in enumerate((0, 4 * h, 6 * h)):
            np.testing.assert_array_equal(gb[c, G], bg[off + 8 * c:off + 8 * c + 8])
    np.testing.assert_array_equal(bias[24 * nch:], bf)


def test_multiscale_weights_packed_once():
    """multiscale_encode with the weights packed once per network
    (multiscale_weights: 3 scales x both mask values) gives exactly what
    it gives composing them per call, for both mask values."""
    net = VONet().eval()
    enc = net.patchify.encoder
    packed = ek.multiscale_weights(enc)
    assert len(packed) == 3 and all(set(p) == {False, True} for p in packed)
    H, W = 32, 48
    rng = np.random.RandomState(3)
    s0 = s1 = multiscale_init_state(H, W)
    with torch.no_grad():
        for m in (True, False):
            ev = t(rng.rand(1, H, W, 5).astype(np.float32))
            im = t(rng.rand(1, H, W, 3).astype(np.float32))
            f0, i0, s0 = ek.multiscale_encode(enc, ev, im, np.array([m]), s0)
            f1, i1, s1 = ek.multiscale_encode(enc, ev, im, np.array([m]), s1,
                                              packed=packed)
            assert torch.equal(f0, f1) and torch.equal(i0, i1)
            assert all(torch.equal(a, b) for a, b in zip(s0["ss"], s1["ss"]))


def test_encoder_chain_vs_flax():
    """multiscale_encode (composed weights + lstm_fold_cm, whose CPU path is
    the plain version) == VONet.encode over 2 carried frames, the second
    with mask False: fmap/imap atol 1e-4, super-states atol 1e-5; with
    heads=False the same super-states exactly."""
    params = jax.jit(JVONet().init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 5)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    net = VONet().eval()
    net.load_state_dict(
        from_flax_params(jax.tree_util.tree_map(np.asarray, params)))
    H, W = 32, 48
    rng = np.random.RandomState(6)
    sj = JMSEncoder.init_state(H, W)
    sp = multiscale_init_state(H, W)
    launches = ek.lstm_fold_cm.launches
    for m in (True, False):
        ev = rng.rand(1, H, W, 5).astype(np.float32)
        im = rng.rand(1, H, W, 3).astype(np.float32)
        fj, ij, sj = JVONet().apply(params, jnp.asarray(ev), jnp.asarray(im),
                                    jnp.asarray([m]), sj, 1,
                                    method=JVONet.encode)
        with torch.no_grad():
            no_f, no_i, sp_only = ek.multiscale_encode(
                net.patchify.encoder, t(ev), t(im), np.array([m]), sp,
                heads=False)
            fp, ip, sp = ek.multiscale_encode(net.patchify.encoder, t(ev),
                                              t(im), np.array([m]), sp)
        # the state-only call (events-only frames) advances it exactly so
        assert no_f is None and no_i is None
        assert all(torch.equal(a, b) for a, b in zip(sp_only["ss"], sp["ss"]))
        np.testing.assert_allclose(npy(fp) / 4, npy(fj), atol=1e-4)
        np.testing.assert_allclose(npy(ip) / 4, npy(ij), atol=1e-4)
        for a, b in zip(sj["ss"], sp["ss"]):
            a = npy(a)
            np.testing.assert_allclose(npy(b), a.reshape(-1, a.shape[-1]).T,
                                       atol=1e-5)
    # CPU tensors never launch the kernel
    assert ek.lstm_fold_cm.launches == launches


# ---------------------------------------------------------------------------
# K1: lattice correlation
# ---------------------------------------------------------------------------

def _lattice(seed, n, NI=4, T=5, M=8, MEM=5, H=40, W=48, spread=2.0,
             dtype=np.float32):
    """A lattice problem: rings, coords [NI, T, M, 3, 3, 2] (patch pixels
    within `spread` px of a center that may lie beyond the borders),
    cell_valid with holes, slotmap of the last MEM frames."""
    rng = np.random.RandomState(seed)
    r = (T + 1) // 2
    gmap = rng.rand(MEM, M, 3, 3, 128).astype(dtype)
    f1 = rng.rand(MEM, H, W, 128).astype(dtype)
    f2 = rng.rand(MEM, H // 4, W // 4, 128).astype(dtype)
    cen = rng.rand(NI, T, M, 1, 1, 2) * np.array([W + 8, H + 8]) - 4
    off = rng.rand(NI, T, M, 3, 3, 2) * 2 * spread - spread
    coords = (cen + off).astype(np.float32)
    i_row = np.arange(NI)[:, None]
    tt = np.arange(T)[None, :]
    i = n - 1 - np.mod(n - 1 - i_row, NI) + 0 * tt
    j = i + tt - (r - 1)
    cv = (i >= 0) & (j >= 0) & (j <= n - 1) & (rng.rand(NI, T) < 0.8)
    slotmap = np.full(64, -1, np.int64)
    for f in range(max(0, n - MEM + 1), n):
        slotmap[f] = f % MEM
    return gmap, f1, f2, coords, cv, slotmap, r


def _port(gmap, f1, f2, coords, cv, n, slotmap, r, tdt=torch.float32):
    NI, T, M = coords.shape[:3]
    u = t(coords[..., 0].reshape(NI * T, -1))
    v = t(coords[..., 1].reshape(NI * T, -1))
    return ck.corr_lattice(t(gmap).to(tdt), t(f1).to(tdt), t(f2).to(tdt),
                           u, v, t(cv), n, t(slotmap), r, (NI, T, M))


@pytest.mark.parametrize("n", [7, 3])
def test_cell_tables_vs_reference(n):
    """cell_vmask == _cell_vmask; for live cells the (target slot, host
    slot) pair == the reference _cell_tables' entry."""
    NI, T, M, MEM = 4, 5, 8, 5
    gmap, f1, f2, coords, cv, slotmap, r = _lattice(1, n, NI, T, M, MEM)
    vm_j = np.asarray(_cell_vmask(NI, T, M, r, jnp.int32(n),
                                  jnp.asarray(cv))).reshape(NI, T, M)[:, :, 0]
    vm_p = ck.cell_vmask(NI, T, r, n, t(cv)).numpy()
    np.testing.assert_array_equal(vm_p, vm_j)
    cells = ck.cell_tables(NI, T, r, n, t(cv), t(slotmap), MEM).numpy()
    tabs, _ = _cell_tables(NI, T, M, r, jnp.int32(n), jnp.asarray(cv),
                           jnp.asarray(slotmap, jnp.int32), MEM, 64)
    seen = 0
    for in_row, tt, slot_j, gslot, out_row in np.asarray(tabs):
        if out_row == NI:
            continue
        seen += 1
        c = in_row * T + tt
        assert vm_p[in_row, tt]
        assert (cells[c, 0], cells[c, 1]) == (slot_j, gslot)
    assert seen == vm_p.sum()
    assert (cells[~vm_p.reshape(-1), 0] == -1).all()


@pytest.mark.parametrize("n", [7, 3])
def test_corr_lattice_ref_vs_exact_corr(n):
    """corr_lattice (CPU: the plain version) == ops/corr.py corr +
    corr_stack over the flat edge view, f32, atol 1e-4 of values ~30;
    dead cells exactly zero. Patch pixels up to 6 px from their center
    (beyond the TPU kernels' SPREAD) and centers beyond the borders."""
    NI, T, M, MEM = 4, 5, 8, 5
    gmap, f1, f2, coords, cv, slotmap, r = _lattice(2, n, NI, T, M, MEM,
                                                    spread=6.0)
    launches = ck.corr_lattice.launches
    out = _port(gmap, f1, f2, coords, cv, n, slotmap, r).numpy()
    assert ck.corr_lattice.launches == launches
    i_row = np.arange(NI)[:, None]
    tt = np.arange(T)[None, :]
    i = n - 1 - np.mod(n - 1 - i_row, NI) + 0 * tt
    j = i + tt - (r - 1)
    E = NI * T * M
    ii = np.broadcast_to(i[:, :, None], (NI, T, M)).reshape(E)
    jj = np.broadcast_to(j[:, :, None], (NI, T, M)).reshape(E)
    m = np.broadcast_to(np.arange(M), (NI, T, M)).reshape(E)
    slot_j = np.clip(slotmap[np.clip(jj, 0, 63)], 0, MEM - 1)
    gidx = np.clip(slotmap[np.clip(ii, 0, 63)], 0, MEM - 1) * M + m
    cf = jnp.asarray(coords.reshape(E, 3, 3, 2))
    gf = jnp.asarray(gmap.reshape(MEM * M, 3, 3, 128))
    ref = np.asarray(j_corr_stack(
        j_corr(gf, jnp.asarray(f1), cf, jnp.asarray(gidx),
               jnp.asarray(slot_j), 3),
        j_corr(gf, jnp.asarray(f2), cf / 4.0, jnp.asarray(gidx),
               jnp.asarray(slot_j), 3)))
    vm = ck.cell_vmask(NI, T, r, n, t(cv)).numpy()
    live = np.broadcast_to(vm[:, :, None], (NI, T, M)).reshape(E)
    assert live.any() and (~live).any()
    np.testing.assert_allclose(out[live], ref[live], atol=1e-4)
    assert (out[~live] == 0).all()


def test_corr_lattice_ref_vs_fused3():
    """corr_lattice (plain version, bf16 rings) == corr_lattice_fused3
    (interpret mode) on every live edge, through paired_corr_perm, with
    patch pixels inside the TPU kernel's SPREAD window. Both emit bf16:
    atol 2e-2 of scale (two roundings)."""
    n = 6
    NI, T, M = 4, 5, 8
    gmap, f1, f2, coords, cv, slotmap, r = _lattice(3, n, NI, T, M)
    bf = jnp.bfloat16
    a = corr_lattice_fused3(
        jnp.asarray(gmap, bf), jnp.asarray(f1, bf), jnp.asarray(f2, bf),
        jnp.asarray(coords), jnp.asarray(cv), jnp.int32(n),
        jnp.asarray(slotmap, jnp.int32), r, 3, interpret=True)
    a = npy(a)                                         # [E, 9 * 128] paired
    b = _port(gmap, f1, f2, coords, cv, n, slotmap, r, torch.bfloat16)
    assert b.dtype == torch.bfloat16
    b = npy(b)                                         # [E, 882] reference
    idx = paired_corr_perm(3, 3)
    cols = idx >= 0
    vm = ck.cell_vmask(NI, T, r, n, t(cv)).numpy()
    live = np.broadcast_to(vm[:, :, None], (NI, T, M)).reshape(-1)
    got = b[:, idx[cols]]
    want = a[:, cols]
    scale = np.abs(want[live]).max()
    assert np.abs(got[live] - want[live]).max() <= 2e-2 * scale
    assert (got[~live] == 0).all() and (want[~live] == 0).all()
