"""The SingleScale path of rampvo_tpu_torch against rampvo_tpu on the CPU:
the plain version of the K3 kernel (lstm_carry_fold_ref) against the
Pallas lstm_carry_fold_cm in interpret mode, the encoder (fused chain and
plain module) against the Pallas encode function and the flax
SingleScaleEncoder, the weight bridge, and the SingleScale VO slice frame
by frame against the JAX RampVO. The CUDA kernel itself is held against
lstm_carry_fold_ref on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.ckpt.torch_import import map_state_dict
from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.models.encoders import SingleScaleEncoder as JSSEncoder
from rampvo_tpu.ops import encoder_pallas as jep
from rampvo_tpu.vo import RampVO as JRampVO
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.models.encoders import SingleScaleEncoder
from rampvo_tpu_torch.models.vonet import VONet
from rampvo_tpu_torch.ops import singlescale_kernels as sk
from rampvo_tpu_torch.vo import RampVO, VOConfig

H, W = 64, 96
KW = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=5,
          OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
          MIXED_PRECISION=False, PROBE_THRESH=-1.0, MAX_FRAMES=64, MEM=16,
          KEYFRAME_THRESH=0.0)
INTR = np.array([50.0, 50.0, W / 2, H / 2], np.float32)
PADDED = [15, 31, 47, 63]          # hc rows of the padded unit (h = 15)


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


@pytest.fixture(scope="module")
def weights():
    """Seeded flax SingleScale VONet weights (init at 16x16: parameter
    shapes do not depend on the input size) with the flow head (d_fc)
    scaled by 0.1, carried over to the port. Unscaled, the random network
    makes the init burst's 12 Gauss-Newton updates chaotic."""
    params = jax.jit(JVONet(input_mode="SingleScale").init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 5)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["update"]["d_fc"]["kernel"] = (
        0.1 * params["params"]["update"]["d_fc"]["kernel"])
    net = VONet("SingleScale")
    net.load_state_dict(from_flax_params(params, "SingleScale"))
    return params, net.eval()


# ---------------------------------------------------------------------------
# K3: carried LSTM + presence-gated folds
# ---------------------------------------------------------------------------

def _k3_inputs(seed, HW=300, hp=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(8, HW).astype(np.float32)
    hc = rng.randn(4 * hp, HW).astype(np.float32)
    ss = rng.randn(hp, HW).astype(np.float32)
    wg = (0.5 * rng.randn(8, 8 * hp)).astype(np.float32)
    wh = (rng.randn(2 * hp, 8 * hp) / np.sqrt(2 * hp)).astype(np.float32)
    bg = (0.1 * rng.randn(8 * hp)).astype(np.float32)
    wf = (rng.randn(2 * hp, hp) / np.sqrt(2 * hp)).astype(np.float32)
    bf = (0.1 * rng.randn(hp)).astype(np.float32)
    return x, hc, ss, wg, wh, bg, wf, bf


@pytest.mark.parametrize("pres", [(1, 1), (1, 0), (0, 1), (0, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_carry_fold_ref_vs_pallas(pres, dtype):
    """lstm_carry_fold_ref == lstm_carry_fold_cm(interpret=True) on the
    same numpy-seeded inputs, each presence pattern. f32: atol 1e-5;
    bf16 storage: within 1e-2 of scale (one bf16 output rounding)."""
    x, hc, ss, wg, wh, bg, wf, bf = _k3_inputs(sum(pres) + 3 * pres[0])
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    pr = np.asarray(pres, np.int32)
    a_ss, a_hc = jep.lstm_carry_fold_cm(
        jnp.asarray(x, jdt), jnp.asarray(hc, jdt), jnp.asarray(ss, jdt),
        jnp.asarray(wg), jnp.asarray(wh), jnp.asarray(bg), jnp.asarray(wf),
        jnp.asarray(bf), jnp.asarray(pr), hwb=256, interpret=True)
    launches = sk.lstm_carry_fold_cm.launches
    b_ss, b_hc = sk.lstm_carry_fold_cm(
        t(x).to(tdt), t(hc).to(tdt), t(ss).to(tdt), t(wg), t(wh), t(bg),
        t(wf), t(bf), t(pr))
    assert sk.lstm_carry_fold_cm.launches == launches   # CPU: plain version
    assert b_ss.dtype == b_hc.dtype == tdt
    assert b_ss.shape == (16, 300) and b_hc.shape == (64, 300)
    for a, b in ((a_ss, b_ss), (a_hc, b_hc)):
        a, b = npy(a), npy(b)
        tol = 1e-5 if dtype == "float32" else 1e-2 * max(1.0, np.abs(a).max())
        assert np.abs(a - b).max() <= tol
    if not pres[0] and not pres[1]:
        np.testing.assert_array_equal(npy(b_ss), npy(t(ss).to(tdt)))


@pytest.mark.parametrize("pres", [(1, 1), (1, 0), (0, 1)])
def test_lstm_carry_fold_bf16_ref(pres):
    """lstm_carry_fold_bf16_ref (the bf16 kernel's roundings: bf16 weights,
    h' before each fold and ss1 before the image fold in bf16, f32 sums)
    on bf16 inputs, rounded to bf16 as the kernel's outputs are: within
    1e-2 of scale of lstm_carry_fold_ref and of the Pallas
    lstm_carry_fold_cm(interpret=True) (a few bf16 roundings apart), both
    outputs, each presence pattern."""
    x, hc, ss, wg, wh, bg, wf, bf = _k3_inputs(11 + 2 * pres[0] + pres[1])
    pr = np.asarray(pres, np.int32)
    xb, hcb, ssb = (t(a).bfloat16() for a in (x, hc, ss))
    w = (t(wg), t(wh), t(bg), t(wf), t(bf))
    got = sk.lstm_carry_fold_bf16_ref(xb, hcb, ssb, *w, t(pr))
    assert all(g.dtype == torch.float32 for g in got)
    assert got[0].shape == (16, 300) and got[1].shape == (64, 300)
    a = jep.lstm_carry_fold_cm(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(hc, jnp.bfloat16),
        jnp.asarray(ss, jnp.bfloat16), jnp.asarray(wg), jnp.asarray(wh),
        jnp.asarray(bg), jnp.asarray(wf), jnp.asarray(bf), jnp.asarray(pr),
        hwb=256, interpret=True)
    b = sk.lstm_carry_fold_ref(xb, hcb, ssb, *w, t(pr))
    for k in range(2):
        gotb = npy(got[k].bfloat16())
        for want in (npy(a[k]), npy(b[k])):
            assert np.abs(gotb - want).max() <= 1e-2 * max(1.0,
                                                           np.abs(want).max())
    # handed its own rounded intermediates (h', and ss1 as the event fold
    # alone gives it), the mirror gives exactly what it gives by itself
    ss1 = sk.lstm_carry_fold_bf16_ref(xb, hcb, ssb, *w,
                                      t(np.array([1, 0], np.int32)))[0]
    again = sk.lstm_carry_fold_bf16_ref(
        xb, hcb, ssb, *w, t(pr), h=got[1][:32].bfloat16(),
        ss1=ss1.bfloat16() if pres[0] else None)
    assert all(torch.equal(u, v) for u, v in zip(again, got))


def test_pack_carry_fold_weights():
    """pack_carry_fold_weights puts each weight where
    csrc/lstm_carry_fold.cu reads it: with column n = 32 G + 8 c + g of
    gate G (i, f, g, o), chunk c, lane l = 4 g + t of the x step holds
    wg[2t + i, n] (i = 0, 1), of h k-step ks wh[16 ks + 2t + i + 8 j, n]
    (word j); of fold k-step ks (ss, data), n-tile nt, wf[16 ks + 2t + i +
    8 j, 8 nt + g]. Weights in bf16; bias = [bg | bf] exact; the float32
    weights kept as given."""
    _, _, _, wg, wh, bg, wf, bf = _k3_inputs(21)
    cw = sk.pack_carry_fold_weights(t(wg), t(wh), t(bg), t(wf), t(bf))
    assert cw.frag.dtype == torch.bfloat16 and cw.bias.dtype == torch.float32
    assert cw.frag.numel() == 40 * 128 + 2 * 16 * 16
    for got, want in zip(cw[:5], (wg, wh, bg, wf, bf)):
        np.testing.assert_array_equal(got.numpy(), want)
    frag = cw.frag.float().numpy()
    rb = lambda a: t(a).bfloat16().float().numpy()
    lane = np.arange(32)
    g, tt = lane // 4, lane % 4
    gate = frag[:5120].reshape(4, 4, 320)
    for c in range(4):
        for G in range(4):
            n = 32 * G + 8 * c + g
            xs = gate[c, G, :64].reshape(32, 2)
            for i in range(2):
                np.testing.assert_array_equal(xs[:, i], rb(wg)[2 * tt + i, n])
            hs = gate[c, G, 64:].reshape(2, 32, 2, 2)
            for ks in range(2):
                for j in range(2):
                    for i in range(2):
                        np.testing.assert_array_equal(
                            hs[ks, :, j, i],
                            rb(wh)[16 * ks + 2 * tt + i + 8 * j, n])
    fold = frag[5120:].reshape(2, 2, 32, 2, 2)
    for ks in range(2):
        for nt in range(2):
            for j in range(2):
                for i in range(2):
                    np.testing.assert_array_equal(
                        fold[ks, nt, :, j, i],
                        rb(wf)[16 * ks + 2 * tt + i + 8 * j, 8 * nt + g])
    np.testing.assert_array_equal(cw.bias.numpy(), np.concatenate([bg, bf]))


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zero_ev", [False, True])
def test_singlescale_encode_vs_pallas_and_flax(weights, zero_ev):
    """Over 2 carried steps: singlescale_encode (packed weights +
    lstm_carry_fold_cm, whose CPU path is the plain version) ==
    pallas_singlescale_encode(interpret=True) == flax SingleScaleEncoder,
    and the plain SingleScaleEncoder module == flax. fmap, imap and the
    carried hc/ss within 1e-4; the padded rows exactly zero; heads=False
    gives the same carry exactly. zero_ev makes the events absent, so the
    event fold is skipped."""
    params, net = weights
    enc_p = params["params"]["patchify"]["encoder"]
    enc = net.patchify.encoder
    h, w = 32, 48
    rng = np.random.RandomState(8)
    sj = JSSEncoder.init_state(h, w)
    sj_cm = jep.singlescale_init_state_cm(h, w)
    sp_cm = sk.singlescale_init_state(h, w)
    sp = SingleScaleEncoder.init_state(h, w)
    packed = sk.singlescale_weights(enc)
    for step in range(2):
        ev = rng.rand(1, h, w, 5).astype(np.float32) * (not zero_ev)
        im = rng.rand(1, h, w, 3).astype(np.float32)
        fj, ij, sj = JSSEncoder().apply({"params": enc_p}, jnp.asarray(ev),
                                        jnp.asarray(im), sj)
        fk, ik, sj_cm = jep.pallas_singlescale_encode(
            enc_p, jnp.asarray(ev), jnp.asarray(im), sj_cm, interpret=True)
        with torch.no_grad():
            # the carry-only call (events-only frames) advances the state
            # exactly as the full call, which takes weights packed once
            no_f, no_i, sp_only = sk.singlescale_encode(
                enc, t(ev), t(im), sp_cm, heads=False)
            fp, ip, sp_cm = sk.singlescale_encode(enc, t(ev), t(im), sp_cm,
                                                  weights=packed)
            fm, im_, sp = enc(t(ev), t(im), sp)
        assert no_f is None and no_i is None
        for k in ("hc", "ss"):
            assert torch.equal(sp_only[k], sp_cm[k]), (step, k)
        for want in ((fj, ij), (fk, ik)):
            np.testing.assert_allclose(npy(fp), npy(want[0]), atol=1e-4)
            np.testing.assert_allclose(npy(ip), npy(want[1]), atol=1e-4)
        np.testing.assert_allclose(npy(fm), npy(fj), atol=1e-4)
        np.testing.assert_allclose(npy(im_), npy(ij), atol=1e-4)
        ref_cm = jep.singlescale_state_to_cm(sj)
        plain_cm = sk.singlescale_state_to_cm(sp)
        for k in ("hc", "ss"):
            for want in (ref_cm[k], sj_cm[k]):
                np.testing.assert_allclose(npy(sp_cm[k]), npy(want),
                                           atol=1e-4, err_msg=(step, k))
            np.testing.assert_allclose(npy(plain_cm[k]), npy(ref_cm[k]),
                                       atol=1e-4, err_msg=(step, k))
        assert (sp_cm["hc"][PADDED] == 0).all() and (sp_cm["ss"][15] == 0).all()


def test_singlescale_weight_bridge(weights):
    """SingleScale VONet state_dict -> map_state_dict -> the flax tree it
    came from (no key skipped or unmapped), and from_flax_params fills
    every parameter of the port's SingleScale VONet (strict load)."""
    params, net = weights
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back, skipped = map_state_dict(sd, "SingleScale")
    assert skipped == []
    a = dict(jax.tree_util.tree_leaves_with_path(params))
    b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
    fresh = VONet("SingleScale")
    fresh.load_state_dict(from_flax_params(params, "SingleScale"), strict=True)
    assert any("layer2" in k for k in fresh.state_dict())


# ---------------------------------------------------------------------------
# the SingleScale VO slice
# ---------------------------------------------------------------------------

def _frames(n, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, H, W, 5).astype(np.float32),
             rng.rand(1, H, W, 3).astype(np.float32)) for _ in range(n)]


def _rand_d(jstate, M):
    """The pre-initialization depths the JAX commit draws next."""
    _, k1 = jax.random.split(jstate.rng)
    return torch.tensor(np.asarray(jax.random.uniform(k1, (M,))))


def _assert_same_bookkeeping(js, ps, frame):
    assert (int(js.n), int(js.counter), bool(js.initialized)) == (
        ps.n, ps.counter, ps.initialized), frame
    for name in ("l2g", "slotmap", "slot_free", "cell_valid", "delta_parent"):
        assert np.asarray(getattr(js, name)).tolist() == \
            getattr(ps, name).tolist(), (frame, name)


def _max_diff(js, ps, name):
    c = ps.counter
    return float(np.abs(np.asarray(getattr(js, name))[:c]
                        - getattr(ps, name)[:c].numpy()).max())


def test_singlescale_slice(weights):
    """RampVO(input_mode="SingleScale") against the JAX RampVO at 64x96,
    M=8, f32: 14 frames and one events-only frame (after frame 9), then
    final_refinement(2), terminate() and point_cloud() (on the JAX
state's values, rtol 1e-5). Bookkeeping exact
    at every frame, poses within 1e-4 and inverse depths within 5e-3
    (float32 reassociation through the init burst); the carried encoder
    state after the events-only frame within 1e-5; trajectories within
    1e-4."""
    params, net = weights
    jvo = JRampVO(JVOConfig(**KW), params, input_mode="SingleScale", ht=H,
                  wd=W)
    pvo = RampVO(VOConfig(**KW), net, input_mode="SingleScale", ht=H, wd=W,
                 device="cpu")
    M = KW["PATCHES_PER_FRAME"]
    for f, (ev, im) in enumerate(_frames(14)):
        rd = _rand_d(jvo.state, M)
        jvo(f, jnp.asarray(ev), jnp.asarray(im), np.array([True]), INTR)
        pvo(f, ev, im, np.array([True]), INTR, rand_d=rd)
        _assert_same_bookkeeping(jvo.state, pvo.state, f)
        assert _max_diff(jvo.state, pvo.state, "poses") < 1e-4, f
        assert _max_diff(jvo.state, pvo.state, "pat_d") < 5e-3, f
        if f == 9:                  # events-only: the whole carried step
            jvo(f + 0.5, jnp.asarray(ev), jnp.asarray(im),
                np.array([False]), INTR)
            pvo(f + 0.5, ev, im, np.array([False]), INTR)
            js = {k: (tuple(t(x) for x in v) if isinstance(v, tuple)
                      else t(v)) for k, v in jvo.state.enc.items()}
            want = sk.singlescale_state_to_cm(js)
            for k in ("hc", "ss"):
                np.testing.assert_allclose(pvo.state.enc[k].numpy(),
                                           want[k].numpy(), atol=1e-5)
    assert pvo.state.initialized and pvo.state.n == 14
    jvo.final_refinement(2)
    pvo.final_refinement(2)
    _assert_same_bookkeeping(jvo.state, pvo.state, "final")
    (ta, sa), (tb, sb) = jvo.terminate(), pvo.terminate()
    assert tb.shape == ta.shape == (14, 7)
    np.testing.assert_array_equal(sb, sa)
    np.testing.assert_allclose(tb, ta, atol=1e-4)
    # point_cloud on identical state values (points are X / d, so the
    # slice's inverse-depth tolerance would be amplified near d = 0)
    for name in ("poses", "pat_cx", "pat_cy", "pat_d", "colors",
                 "intrinsics"):
        setattr(pvo.state, name, t(getattr(jvo.state, name)))
    (pa, ca), (pb, cb) = jvo.point_cloud(), pvo.point_cloud()
    assert pb.shape == pa.shape == (14 * M, 3)
    np.testing.assert_array_equal(cb, ca)
    np.testing.assert_allclose(pb, pa, rtol=1e-5, atol=1e-5)


def test_event_bias_false_runs_and_mode_mismatch_raises(weights):
    """RampVO(event_bias=False) runs the SingleScale frames with patches
    at random and ranked by image gradient (GRADIENT_BIAS; the selection
    itself is held to the JAX package in test_torch_selection.py): every
    selected patch center lies inside the 1/4-res map, away from its
    border, and each selector picks its own. A mode that disagrees with
    the network raises instead of running something else."""
    _, net = weights
    centers = []
    for gradient in (False, True):
        vo = RampVO(VOConfig(**dict(KW, GRADIENT_BIAS=gradient)), net,
                    ht=H, wd=W, device="cpu", event_bias=False, seed=1)
        for f, (ev, im) in enumerate(_frames(3)):
            vo(f, ev, im, np.ones(1, bool), INTR)
        st = vo.state
        assert st.n == 3 and bool(torch.isfinite(st.poses).all())
        cx, cy = st.pat_cx[:3], st.pat_cy[:3]
        assert 1 <= float(cx.min()) and float(cx.max()) < W // 4 - 1
        assert 1 <= float(cy.min()) and float(cy.max()) < H // 4 - 1
        centers.append(torch.stack([cx, cy]))
    assert not torch.equal(*centers)
    with pytest.raises(ValueError):
        RampVO(VOConfig(**KW), net, input_mode="MultiScale", ht=H, wd=W,
               device="cpu")
