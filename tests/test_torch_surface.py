"""The rest of the JAX package's public surface in rampvo_tpu_torch, each
name against its JAX counterpart on the same inputs and weights on the
CPU: models.SoftAggBasic, grad_zero, ConvLSTMCell and CorrBlock,
ops.pyramidify and segment_mean, data.resize_input, ckpt.map_state_dict
and vo.make_encode_only(cfg, vonet).

Tolerances: float32 ops 1e-5 (1e-4 for the correlation, sums of 128
products); the key mapping and the gradient masks exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu import ckpt as jckpt
from rampvo_tpu import data as jdata
from rampvo_tpu import models as jmodels
from rampvo_tpu import ops as jops
from rampvo_tpu.models.encoders import MultiScaleEncoder as JMultiScale
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu.vo import init_state as j_init_state
from rampvo_tpu.vo import make_encode_only as j_make_encode_only
from rampvo_tpu_torch import ckpt, data, models, ops
from rampvo_tpu_torch.ckpt.weights import conv_lstm_from_flax, \
    from_flax_params
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.vo import VOConfig, init_state, make_encode_only
from rampvo_tpu_torch.vo.runtime import make_enc_state


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def dense_into(linear, p):
    """A flax Dense's {kernel, bias} into a torch Linear."""
    with torch.no_grad():
        linear.weight.copy_(torch.tensor(np.asarray(p["kernel"]).T))
        linear.bias.copy_(torch.tensor(np.asarray(p["bias"])))


@pytest.mark.parametrize("masked", [False, True])
def test_soft_agg_basic(masked):
    """SoftAggBasic == JAX's on 40 rows in 7 scattered groups, with and
    without a validity mask (valid rows compared; invalid rows are
    garbage by contract)."""
    rng = np.random.RandomState(0)
    E, D = 40, 16
    x = rng.randn(E, D).astype(np.float32)
    ix = rng.choice([3, 9, 10, 40, 41, 77, 100], E).astype(np.int32)
    valid = rng.rand(E) < 0.7 if masked else np.ones(E, bool)
    jm = jmodels.SoftAggBasic(D)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ix))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(ix),
                    jnp.asarray(valid) if masked else None)
    pm = models.SoftAggBasic(D)
    for name in ("f", "g", "h"):
        dense_into(getattr(pm, name), params["params"][name])
    got = pm(torch.tensor(x), torch.tensor(ix),
             torch.tensor(valid) if masked else None)
    assert got.shape == (E, D)
    close(got.detach().numpy()[valid], np.asarray(want)[valid])


def test_grad_zero():
    """grad_zero is the identity going forward; its backward zeroes NaN
    gradients and those above 0.1 in magnitude, exactly as JAX's."""
    rng = np.random.RandomState(1)
    x = rng.randn(64).astype(np.float32)
    w = (rng.randn(64) * 0.2).astype(np.float32)
    w[:4] = [np.nan, 0.1, -0.1, 0.1000001]
    jg = jax.grad(lambda v: jnp.sum(jmodels.grad_zero(v) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    y = models.grad_zero(xt)
    assert torch.equal(y, torch.tensor(x))
    (y * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    assert 0 < int((xt.grad == 0).sum()) < 64


def test_conv_lstm_cell():
    """ConvLSTMCell with the JAX cell's parameters (conv_lstm_from_flax):
    two steps from the zero state, h and c within 1e-5."""
    rng = np.random.RandomState(2)
    H, W, Cin, hid = 6, 7, 5, 4
    xs = [rng.randn(H, W, Cin).astype(np.float32) for _ in range(2)]
    jm = jmodels.ConvLSTMCell(hid)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(xs[0]))
    pm = models.ConvLSTMCell(Cin, hid)
    pm.load_state_dict(conv_lstm_from_flax(params))
    js, ps = None, None
    for x in xs:
        jh, js = jm.apply(params, jnp.asarray(x), js)
        ph, ps = pm(torch.tensor(x), ps)
        close(ph.detach().numpy(), jh)
        close(ps[1].detach().numpy(), js[1])


def test_corr_block_and_pyramidify():
    """pyramidify == JAX's, and CorrBlock (both levels of the exact
    correlation, stacked) == JAX's on 3 frames of 16x20 features, 12
    patches and 30 edges with coordinates inside and beyond the map."""
    rng = np.random.RandomState(4)
    N, h, w, C, Mp = 3, 16, 20, 128, 4
    fmap = rng.randn(N, h, w, C).astype(np.float32)
    gmap = rng.randn(N * Mp, 3, 3, C).astype(np.float32)
    E = 30
    kk = rng.randint(0, N * Mp, E)
    jj = rng.randint(0, N, E)
    coords = (rng.rand(E, 3, 3, 2) * [w + 6, h + 6] - 3).astype(np.float32)
    for a, b in zip(ops.pyramidify(torch.tensor(fmap)),
                    jops.pyramidify(jnp.asarray(fmap))):
        close(a.numpy(), b)
    want = jmodels.CorrBlock(jnp.asarray(fmap), jnp.asarray(gmap))(
        jnp.asarray(kk), jnp.asarray(jj), jnp.asarray(coords))
    got = models.CorrBlock(torch.tensor(fmap), torch.tensor(gmap))(
        torch.tensor(kk), torch.tensor(jj), torch.tensor(coords))
    assert got.shape == (E, 2 * 49 * 9)
    close(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_segment_mean(masked):
    """segment_mean == JAX's over 50 rows in 9 segments (some empty),
    with and without a validity mask."""
    rng = np.random.RandomState(5)
    x = rng.randn(50, 3).astype(np.float32)
    seg = rng.randint(0, 7, 50)
    valid = rng.rand(50) < 0.6
    v = (torch.tensor(valid), jnp.asarray(valid)) if masked else (None, None)
    got = ops.segment_mean(torch.tensor(x), torch.tensor(seg), 9, v[0])
    want = jops.segment_mean(jnp.asarray(x), jnp.asarray(seg), 9, v[1])
    close(got.numpy(), want)


@pytest.mark.parametrize("shape", [(60, 80), (960, 1280)])
def test_resize_input(shape):
    """resize_input == JAX's: a smaller frame is centre-padded, a larger
    one resized, image and events alike."""
    rng = np.random.RandomState(6)
    img = rng.rand(1, *shape, 3).astype(np.float32)
    ev = rng.randint(-2, 3, (1, *shape, 5)).astype(np.float32)
    for a, b in zip(data.resize_input(img, ev), jdata.resize_input(img, ev)):
        assert a.shape == (1, 480, 640, a.shape[-1])
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["MultiScale", "SingleScale"])
def test_map_state_dict(mode):
    """map_state_dict on a reference-style state_dict ("module."
    prefixes, update.lmbda, and for MultiScale the heads' unused layer2 /
    conv2): the same skipped keys as JAX's, and the port's state_dict
    equals from_flax_params of JAX's variables key for key; an unmapped
    key raises in both."""
    net = init_weights(VONet(mode), torch.Generator().manual_seed(7))
    sd = {f"module.{k}": v for k, v in net.state_dict().items()}
    sd["module.update.lmbda"] = torch.tensor([1e-3])
    if mode == "MultiScale":
        for head in ("fmap", "imap"):
            pre = f"module.patchify.encoder.{head}_encoder"
            sd[f"{pre}.layer2.0.conv1.weight"] = torch.zeros(4, 4, 3, 3)
            sd[f"{pre}.conv2.bias"] = torch.zeros(4)
    got, skipped = ckpt.map_state_dict(sd, mode)
    variables, j_skipped = jckpt.map_state_dict(
        {k: v.numpy() for k, v in sd.items()}, mode)
    assert skipped == j_skipped and len(skipped) == (
        5 if mode == "MultiScale" else 1)
    want = from_flax_params(variables, mode)
    assert got.keys() == want.keys() == net.state_dict().keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert ckpt.import_pth(sd, mode).keys() == got.keys()
    bad = dict(sd, **{"module.update.nope.weight": torch.zeros(1)})
    with pytest.raises(KeyError):
        ckpt.map_state_dict(bad, mode)
    with pytest.raises(KeyError):
        jckpt.map_state_dict({k: v.numpy() for k, v in bad.items()}, mode)


def test_make_encode_only():
    """make_encode_only(cfg, vonet) == JAX's make_encode_only(cfg, vonet)
    on the same weights: three events-only steps from the zero state at
    64x96 (float32), the MultiScale super-states within 1e-5 after each;
    the state's other fields untouched."""
    H, W = 64, 96
    kw = dict(BUFFER_SIZE=16, MAX_FRAMES=16, PATCHES_PER_FRAME=8, MEM=8,
              MIXED_PRECISION=False)
    jcfg, pcfg = JVOConfig(**kw), VOConfig(**kw)
    jnet = jmodels.VONet()
    params = jax.jit(jnet.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 5)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    params = jax.tree_util.tree_map(np.asarray, params)
    net = VONet()
    net.load_state_dict(from_flax_params(params))
    jstate = j_init_state(jcfg, JMultiScale.init_state(H, W), H, W)
    pstate = init_state(pcfg, make_enc_state(pcfg, "MultiScale", H, W,
                                             "cpu"), H, W, device="cpu")
    poses = pstate.poses.clone()
    j_step = j_make_encode_only(jcfg, jnet)
    p_step = make_encode_only(pcfg, net)
    rng = np.random.RandomState(8)
    mask = np.zeros(1, bool)
    for _ in range(3):
        ev = rng.rand(1, H, W, 5).astype(np.float32)
        im = rng.rand(1, H, W, 3).astype(np.float32)
        jstate = j_step(params, jstate, jnp.asarray(ev), jnp.asarray(im),
                        jnp.asarray(mask))
        assert p_step(pstate, ev, im, mask) is pstate
        for a, b in zip(pstate.enc["ss"], jstate.enc["ss"]):
            b = np.asarray(b)
            close(a.numpy(), b.reshape(-1, b.shape[-1]).T)
    assert torch.equal(pstate.poses, poses) and pstate.n == 0


@pytest.mark.parametrize("mixed", [False, True])
def test_rampvo_builds_one_encoder(monkeypatch, mixed):
    """RampVO's events-only frames run its frame step's encoder: the
    driver makes one copy of the network for the frame step (bf16 under
    MIXED_PRECISION) and packs its kernel weights once, where
    make_encode_only(cfg, vonet) alone would make a second."""
    from rampvo_tpu_torch.vo import RampVO, runtime

    built = []
    make = runtime._make_encode_fn
    monkeypatch.setattr(runtime, "_make_encode_fn",
                        lambda net_h: built.append(net_h) or make(net_h))
    cfg = VOConfig(BUFFER_SIZE=16, MAX_FRAMES=16, PATCHES_PER_FRAME=8,
                   MEM=8, MIXED_PRECISION=mixed)
    net = init_weights(VONet(), torch.Generator().manual_seed(0))
    vo = RampVO(cfg, net, ht=32, wd=48, device="cpu")
    assert len(built) == 1
    rng = np.random.RandomState(3)
    vo(0.0, rng.rand(1, 32, 48, 5).astype(np.float32),
       rng.rand(1, 32, 48, 3).astype(np.float32), [False],
       torch.tensor([40.0, 40.0, 24.0, 16.0]))
    assert len(built) == 1 and vo.state.n == 0
    assert float(sum(s.abs().sum() for s in vo.state.enc["ss"])) > 0
