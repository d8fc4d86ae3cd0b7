"""The MultiScale VO slice: rampvo_tpu_torch's RampVO against rampvo_tpu's
RampVO on the CPU at MIXED_PRECISION=False, 64x96 input, M=8.

The JAX side runs its CPU defaults (exact XLA correlation over the flat
edge list, flax encoder); the port runs its lattice path with the plain
kernel versions. Both get the same weights (seeded flax init carried over
by from_flax_params), the same frames and the same pre-initialization
depths (derived from the JAX state's key).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.ops.corr_pallas import RING_PAD
from rampvo_tpu.vo import RampVO as JRampVO
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu_torch.ckpt.weights import from_flax_params
from rampvo_tpu_torch.models.vonet import VONet
from rampvo_tpu_torch.vo import RampVO, VOConfig
from rampvo_tpu_torch.vo.runtime import make_enc_state
from rampvo_tpu_torch.vo.state import init_state

H, W = 64, 96
KW = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=5,
          OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
          MIXED_PRECISION=False, PROBE_THRESH=-1.0, MAX_FRAMES=64, MEM=16)
INTR = np.array([50.0, 50.0, W / 2, H / 2], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once,
    and torch's default (one thread per core, spinning) oversubscribes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """Seeded flax weights with the update head's flow output (d_fc)
    scaled by 0.1, carried over to the port. Unscaled, the random network
    predicts flows of several pixels and the init burst's 12 Gauss-Newton
    updates become chaotic: perturbing one input pose at float32 rounding
    level changes their result far beyond any float32 tolerance."""
    from rampvo_tpu.models import VONet as JVONet

    params = jax.jit(JVONet().init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 5)),
        jnp.zeros((1, 16, 16, 3)), jnp.asarray([True]))
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["update"]["d_fc"]["kernel"] = (
        0.1 * params["params"]["update"]["d_fc"]["kernel"])
    net = VONet()
    net.load_state_dict(from_flax_params(params))
    return params, net


def frames(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, H, W, 5).astype(np.float32),
             rng.rand(1, H, W, 3).astype(np.float32)) for _ in range(n)]


def rand_d(jstate, M):
    """The pre-initialization depths the JAX commit draws next."""
    _, k1 = jax.random.split(jstate.rng)
    return torch.tensor(np.asarray(jax.random.uniform(k1, (M,))))


def bookkeeping(js, ps):
    """Keyframe bookkeeping of the two states, compared exactly."""
    return {
        "n": (int(js.n), ps.n),
        "counter": (int(js.counter), ps.counter),
        "initialized": (bool(js.initialized), ps.initialized),
        "l2g": (np.asarray(js.l2g).tolist(), ps.l2g.tolist()),
        "slotmap": (np.asarray(js.slotmap).tolist(), ps.slotmap.tolist()),
        "slot_free": (np.asarray(js.slot_free).tolist(),
                      ps.slot_free.tolist()),
        "cell_valid": (np.asarray(js.cell_valid).tolist(),
                       ps.cell_valid.tolist()),
        "delta_parent": (np.asarray(js.delta_parent).tolist(),
                         ps.delta_parent.tolist()),
    }


def assert_same_bookkeeping(js, ps, frame):
    for k, (a, b) in bookkeeping(js, ps).items():
        assert a == b, (frame, k)


def max_diff(js, ps, name):
    c = ps.counter
    return float(np.abs(np.asarray(getattr(js, name))[:c]
                        - getattr(ps, name)[:c].numpy()).max())


def port_state(js, cfg):
    """The port's VOState holding the same values as a JAX VOState (rings
    unpadded, encoder super-states channel-major)."""
    st = init_state(cfg, make_enc_state(cfg, "MultiScale", H, W, "cpu"), H,
                    W, device="cpu")
    for name in ("poses", "pat_x", "pat_y", "pat_d", "pat_cx", "pat_cy",
                 "colors", "delta_dP", "imap_r", "gmap_r", "cell_valid",
                 "net", "last_weight", "slot_free", "intrinsics"):
        setattr(st, name, torch.tensor(np.asarray(getattr(js, name))))
    for name in ("delta_parent", "l2g", "slotmap"):
        setattr(st, name, torch.tensor(np.asarray(getattr(js, name)),
                                       dtype=torch.int64))
    h, w = H // 4, W // 4
    st.fmap1_r = torch.tensor(np.asarray(js.fmap1_r)[
        :, RING_PAD:RING_PAD + h, RING_PAD:RING_PAD + w])
    st.fmap2_r = torch.tensor(np.asarray(js.fmap2_r)[
        :, RING_PAD:RING_PAD + h // 4, RING_PAD:RING_PAD + w // 4])
    st.enc = {"ss": [torch.tensor(np.asarray(s).reshape(-1, s.shape[-1]).T
                                  .copy()) for s in js.enc["ss"]]}
    st.n, st.counter = int(js.n), int(js.counter)
    st.initialized = bool(js.initialized)
    return st


def test_slice_free_running(weights):
    """14 frames (+1 events-only frame) through both drivers, never
    evicting (KEYFRAME_THRESH=0 keeps every decision away from the
    threshold), then final_refinement(2) and terminate().

    Bookkeeping (n, l2g, slotmap, slot_free, cell_valid, ...) identical at
    every frame; poses within 1e-4 and inverse depths within 5e-3 at every
    frame (float32 reassociation carried through the init burst's 12
    Gauss-Newton updates); terminate() trajectories within 1e-4; the
    events-only frame's super-states within 1e-5."""
    params, net = weights
    cfg_kw = dict(KW, KEYFRAME_THRESH=0.0)
    jvo = JRampVO(JVOConfig(**cfg_kw), params, ht=H, wd=W)
    pvo = RampVO(VOConfig(**cfg_kw), net, ht=H, wd=W, device="cpu")
    M = KW["PATCHES_PER_FRAME"]
    for f, (ev, im) in enumerate(frames(14)):
        rd = rand_d(jvo.state, M)
        jvo(f, jnp.asarray(ev), jnp.asarray(im), np.array([True]), INTR)
        pvo(f, ev, im, np.array([True]), INTR, rand_d=rd)
        assert_same_bookkeeping(jvo.state, pvo.state, f)
        assert max_diff(jvo.state, pvo.state, "poses") < 1e-4, f
        assert max_diff(jvo.state, pvo.state, "pat_d") < 5e-3, f
        if f == 9:                     # events-only frame: encoder state
            jvo(f + 0.5, jnp.asarray(ev), jnp.asarray(im),
                np.array([False]), INTR)
            pvo(f + 0.5, ev, im, np.array([False]), INTR)
            for a, b in zip(jvo.state.enc["ss"], pvo.state.enc["ss"]):
                a = np.asarray(a)
                np.testing.assert_allclose(
                    b.numpy(), a.reshape(-1, a.shape[-1]).T, atol=1e-5)
    assert pvo.state.initialized and pvo.state.n == 14
    jvo.final_refinement(2)
    pvo.final_refinement(2)
    assert_same_bookkeeping(jvo.state, pvo.state, "final")
    (ta, sa), (tb, sb) = jvo.terminate(), pvo.terminate()
    assert tb.shape == ta.shape == (14, 7)
    np.testing.assert_array_equal(sb, sa)
    np.testing.assert_allclose(tb, ta, atol=1e-4)
