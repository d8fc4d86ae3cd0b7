"""Event-bin counts other than 5 in rampvo_tpu_torch against rampvo_tpu on
the CPU: the plain versions of K2 (lstm_fold_ref) and K3
(lstm_carry_fold_ref) against the Pallas kernels in interpret mode at Cx =
bins + 3 image channels in {4, 8, 13, 18}, the kernels' weight packing
for those counts, the VO slice at 10 bins in both input modes frame by
frame against the JAX RampVO (64x96, M=8, f32), RampVO's check of the
network against the count, and the evaluation CLI on a 10-bin training
checkpoint. The CUDA kernels at these counts are held against the plain
versions on the card by chip_smoke.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
from test_torch_cli import SMALL_VO, eval_cfg
from test_torch_slice import INTR, KW, H, W, assert_same_bookkeeping, max_diff
from rampvo_tpu.models import VONet as JVONet
from rampvo_tpu.ops import encoder_pallas as jep
from rampvo_tpu.vo import RampVO as JRampVO
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu_torch.ckpt.train_state import save_checkpoint
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.cli import evaluate as pev
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.ops import encoder_kernels as ek
from rampvo_tpu_torch.ops import singlescale_kernels as sk
from rampvo_tpu_torch.vo import RampVO, VOConfig

BINS = 10
CXS = [4, 8, 13, 18]            # 1, 5, 10 and 15 bins + 3 image channels


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
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
# K2 and K3 at any input channel count
# ---------------------------------------------------------------------------

def _k2_inputs(cx, h=16, HW=300, seed=0):
    rng = np.random.RandomState(seed + cx)
    return (rng.randn(cx, HW).astype(np.float32),
            rng.randn(h, HW).astype(np.float32),
            (0.5 * rng.randn(cx, 8 * h)).astype(np.float32),
            (0.1 * rng.randn(8 * h)).astype(np.float32),
            (rng.randn(3 * h, h) / np.sqrt(3 * h)).astype(np.float32),
            (0.1 * rng.randn(h)).astype(np.float32))


def _k3_inputs(cx, hp=16, HW=300, seed=0):
    rng = np.random.RandomState(seed + 7 * cx)
    return (rng.randn(cx, HW).astype(np.float32),
            rng.randn(4 * hp, HW).astype(np.float32),
            rng.randn(hp, HW).astype(np.float32),
            (0.5 * rng.randn(cx, 8 * hp)).astype(np.float32),
            (rng.randn(2 * hp, 8 * hp) / np.sqrt(2 * hp)).astype(np.float32),
            (0.1 * rng.randn(8 * hp)).astype(np.float32),
            (rng.randn(2 * hp, hp) / np.sqrt(2 * hp)).astype(np.float32),
            (0.1 * rng.randn(hp)).astype(np.float32))


@pytest.mark.parametrize("cx", CXS)
def test_lstm_fold_ref_vs_pallas(cx):
    """lstm_fold_cm on CPU tensors (the plain version; no launch) ==
    the Pallas lstm_fold_cm(interpret=True) at Cx input rows, f32, within
    1e-5; lstm_fold_bf16_ref (the bf16 kernel's roundings) within 1e-2 of
    scale of it."""
    a = _k2_inputs(cx)
    want = npy(jep.lstm_fold_cm(*map(jnp.asarray, a), hwb=256,
                                interpret=True))
    launches = ek.lstm_fold_cm.launches
    got = ek.lstm_fold_cm(*map(t, a))
    assert ek.lstm_fold_cm.launches == launches
    assert got.shape == want.shape == (16, 300)
    assert np.abs(npy(got) - want).max() <= 1e-5
    mirror = npy(ek.lstm_fold_bf16_ref(*map(t, a)))
    assert np.abs(mirror - want).max() <= 1e-2 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("cx", CXS)
def test_lstm_carry_fold_ref_vs_pallas(cx):
    """lstm_carry_fold_cm on CPU tensors (the plain version) == the Pallas
    lstm_carry_fold_cm(interpret=True) at Cx input rows, both outputs,
    both modalities present, f32, within 1e-5; the bf16 mirror within
    1e-2 of scale."""
    a = _k3_inputs(cx)
    pr = np.ones(2, np.int32)
    want = jep.lstm_carry_fold_cm(*map(jnp.asarray, a), jnp.asarray(pr),
                                  hwb=256, interpret=True)
    launches = sk.lstm_carry_fold_cm.launches
    got = sk.lstm_carry_fold_cm(*map(t, a), t(pr))
    assert sk.lstm_carry_fold_cm.launches == launches
    mirror = sk.lstm_carry_fold_bf16_ref(*map(t, a), t(pr))
    for w, g, m in zip(want, got, mirror):
        w = npy(w)
        assert np.abs(npy(g) - w).max() <= 1e-5
        assert np.abs(npy(m) - w).max() <= 1e-2 * max(1.0, np.abs(w).max())


def _x_steps(wg, nx):
    """wg [Cx, n] rounded to bf16, rows zero-padded to 8 nx, as [nx k8
    steps][32 lanes][2]-indexable: B[2t + i] of step ks, lane 4 g + t."""
    wp = np.zeros((8 * nx, wg.shape[1]), np.float32)
    wp[:wg.shape[0]] = t(wg).bfloat16().float().numpy()
    return wp


@pytest.mark.parametrize("cx", [4, 13, 18])
def test_pack_fold_weights_any_cx(cx):
    """pack_fold_weights at Cx != 8 (csrc/lstm_fold.cu's layout for nx =
    ceil(Cx/8) k8 steps): lane l = 4g + t of gate chunk c, gate G (i, g,
    o), k8 step ks holds wg[8 ks + 2t + i, off_G + 8c + g] with rows past
    Cx zero; the fold's words and the biases are those of the same
    weights at any Cx (their place shifts with the gate words only)."""
    h = 16
    _, _, wg, bg, wf, bf = _k2_inputs(cx, h)
    nx, nch = -(-cx // 8), 2 * h // 8
    fw = ek.pack_fold_weights(t(wg), t(bg), t(wf), t(bf))
    assert fw.frag.numel() == 6 * h * 8 * nx + 3 * h * h
    assert fw.wg.shape == (cx, 8 * h)
    frag = fw.frag.float().numpy()
    gate = frag[:6 * h * 8 * nx].reshape(nch, 3, nx, 32, 2)
    lane = np.arange(32)
    g, tt = lane // 4, lane % 4
    wp = _x_steps(wg, nx)
    for c in range(nch):
        for G, off in enumerate((0, 4 * h, 6 * h)):
            for ks in range(nx):
                for i in range(2):
                    np.testing.assert_array_equal(
                        gate[c, G, ks, :, i],
                        wp[8 * ks + 2 * tt + i, off + 8 * c + g])
    wg8 = np.zeros((8, 8 * h), np.float32)
    ref = ek.pack_fold_weights(t(wg8), t(bg), t(wf), t(bf))
    np.testing.assert_array_equal(frag[6 * h * 8 * nx:],
                                  ref.frag.float().numpy()[48 * h:])
    np.testing.assert_array_equal(fw.bias.numpy(), ref.bias.numpy())


@pytest.mark.parametrize("cx", [4, 13, 18])
def test_pack_carry_fold_weights_any_cx(cx):
    """pack_carry_fold_weights at Cx != 8: per chunk c and gate G the x
    words come first, lane l = 4 g + t of k8 step kx holding wg[8 kx + 2t +
    i, 32 G + 8 c + g] with rows past Cx zero, then the h words of the
    same weights as at Cx = 8; the fold's words and the bias unchanged."""
    hp = 16
    _, _, _, wg, wh, bg, wf, bf = _k3_inputs(cx)
    nx = -(-cx // 8)
    cw = sk.pack_carry_fold_weights(t(wg), t(wh), t(bg), t(wf), t(bf))
    gwc = 64 * nx + 256                       # bf16 values a (chunk, gate)
    assert cw.frag.numel() == 16 * gwc + 2 * hp * hp
    frag = cw.frag.float().numpy()
    gate = frag[:16 * gwc].reshape(4, 4, gwc)
    ref = sk.pack_carry_fold_weights(t(np.zeros((8, 8 * hp), np.float32)),
                                     t(wh), t(bg), t(wf), t(bf))
    rgate = ref.frag.float().numpy()[:16 * 320].reshape(4, 4, 320)
    lane = np.arange(32)
    g, tt = lane // 4, lane % 4
    wp = _x_steps(wg, nx)
    for c in range(4):
        for G in range(4):
            xs = gate[c, G, :64 * nx].reshape(nx, 32, 2)
            for kx in range(nx):
                for i in range(2):
                    np.testing.assert_array_equal(
                        xs[kx, :, i], wp[8 * kx + 2 * tt + i, 32 * G + 8 * c + g])
            np.testing.assert_array_equal(gate[c, G, 64 * nx:],
                                          rgate[c, G, 64:])
    np.testing.assert_array_equal(frag[16 * gwc:],
                                  ref.frag.float().numpy()[16 * 320:])
    np.testing.assert_array_equal(cw.bias.numpy(), ref.bias.numpy())


# ---------------------------------------------------------------------------
# the VO slice at 10 event bins
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["MultiScale", "SingleScale"])
def weights(request):
    """(mode, seeded flax weights of a 10-bin VONet with the flow head
    (d_fc) scaled by 0.1, the port's VONet holding them). Unscaled, the
    random network makes the init burst's 12 Gauss-Newton updates
    chaotic (tests/test_torch_slice.py)."""
    mode = request.param
    params = jax.jit(JVONet(input_mode=mode, evs_ch=BINS).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, BINS)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["update"]["d_fc"]["kernel"] = (
        0.1 * params["params"]["update"]["d_fc"]["kernel"])
    net = VONet(mode, evs_ch=BINS)
    net.load_state_dict(from_flax_params(params, mode))
    return mode, params, net.eval()


def _frames(n, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, H, W, BINS).astype(np.float32),
             rng.rand(1, H, W, 3).astype(np.float32)) for _ in range(n)]


def _rand_d(jstate, M):
    """The pre-initialization depths the JAX commit draws next."""
    _, k1 = jax.random.split(jstate.rng)
    return torch.tensor(np.asarray(jax.random.uniform(k1, (M,))))


def _enc_cm(mode, jenc):
    """The JAX encoder state channel-major, as the port keeps it."""
    if mode == "MultiScale":
        return [np.asarray(s).reshape(-1, s.shape[-1]).T for s in jenc["ss"]]
    js = {k: (tuple(t(x) for x in v) if isinstance(v, tuple) else t(v))
          for k, v in jenc.items()}
    cm = sk.singlescale_state_to_cm(js)
    return [cm["hc"].numpy(), cm["ss"].numpy()]


def test_slice_ten_bins(weights):
    """RampVO(num_event_bins=10) against the JAX RampVO, each input mode:
    12 frames and one events-only frame (after frame 7) through both
    drivers, never evicting (KEYFRAME_THRESH=0), then final_refinement(2)
    and terminate(). test_torch_slice.py's tolerances: bookkeeping
    identical at every frame, poses within 1e-4 and inverse depths within
    5e-3 at every frame; the encoder state after the events-only frame
    within 1e-5; trajectories within 1e-4."""
    mode, params, net = weights
    kw = dict(KW, KEYFRAME_THRESH=0.0)
    jvo = JRampVO(JVOConfig(**kw), params, input_mode=mode,
                  num_event_bins=BINS, ht=H, wd=W)
    pvo = RampVO(VOConfig(**kw), net, input_mode=mode, num_event_bins=BINS,
                 ht=H, wd=W, device="cpu")
    M = KW["PATCHES_PER_FRAME"]
    for f, (ev, im) in enumerate(_frames(12)):
        rd = _rand_d(jvo.state, M)
        jvo(f, jnp.asarray(ev), jnp.asarray(im), np.array([True]), INTR)
        pvo(f, ev, im, np.array([True]), INTR, rand_d=rd)
        assert_same_bookkeeping(jvo.state, pvo.state, f)
        assert max_diff(jvo.state, pvo.state, "poses") < 1e-4, f
        assert max_diff(jvo.state, pvo.state, "pat_d") < 5e-3, f
        if f == 7:
            jvo(f + 0.5, jnp.asarray(ev), jnp.asarray(im),
                np.array([False]), INTR)
            pvo(f + 0.5, ev, im, np.array([False]), INTR)
            got = (pvo.state.enc["ss"] if mode == "MultiScale"
                   else [pvo.state.enc["hc"], pvo.state.enc["ss"]])
            for a, b in zip(_enc_cm(mode, jvo.state.enc), got):
                np.testing.assert_allclose(b.numpy(), a, atol=1e-5)
    assert pvo.state.initialized and pvo.state.n == 12
    jvo.final_refinement(2)
    pvo.final_refinement(2)
    assert_same_bookkeeping(jvo.state, pvo.state, "final")
    (ta, sa), (tb, sb) = jvo.terminate(), pvo.terminate()
    assert tb.shape == ta.shape == (12, 7)
    np.testing.assert_array_equal(sb, sa)
    np.testing.assert_allclose(tb, ta, atol=1e-4)


@pytest.mark.parametrize("mode", ["MultiScale", "SingleScale"])
def test_bins_network_mismatch_raises(mode):
    """A network whose event channels are not num_event_bins raises
    ValueError, as an input mode that disagrees does; load_params refuses
    a network of another count the same way."""
    net = VONet(mode, evs_ch=BINS)
    with pytest.raises(ValueError, match="event"):
        RampVO(VOConfig(**SMALL_VO), net, ht=H, wd=W, device="cpu")
    with pytest.raises(ValueError, match="event"):
        RampVO(VOConfig(**SMALL_VO), VONet(mode), num_event_bins=BINS,
               ht=H, wd=W, device="cpu")
    with pytest.raises(ValueError, match="event bins"):
        pev.load_params(net, mode)


@pytest.mark.parametrize("mode", ["MultiScale", "SingleScale"])
def test_evaluate_ten_bin_checkpoint(tmp_path, mode, monkeypatch):
    """A 10-bin training checkpoint ({"params", "opt", "step"}) loads
    through load_params bit for bit (and not as a 5-bin network), and
    evaluate() runs it on a synthetic scene whose loader builds 10-bin
    voxels: every frame tracked, finite ATE."""
    net = init_weights(VONet(mode, evs_ch=BINS),
                       torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path / "ckpt"), 3, net.state_dict(), {})
    got = pev.load_params(path, mode, BINS)
    assert got.evs_ch == BINS
    for k, v in net.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    with pytest.raises(RuntimeError):
        pev.load_params(path, mode)
    scene = str(tmp_path / "P000")
    synthetic.write_scene(scene, n_frames=10, H=60, W=80)
    cfg = eval_cfg(scene, mode)
    cfg["data_loader"]["train"]["args"]["num_event_bins"] = BINS
    made = []

    class Recorded(pev.RampVO):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(pev, "RampVO", Recorded)
    results = pev.evaluate(os.path.dirname(path), config_VO=VOConfig(
        **SMALL_VO), eval_cfg=cfg, save_dir=str(tmp_path / "t"),
        device="cpu")
    trial = results[scene]["trial_0"]
    assert len(made) == 1 and made[0].state.initialized
    assert made[0].vonet.evs_ch == BINS
    assert np.isfinite(trial["ate"]) and trial["ate"] != 1000.0
