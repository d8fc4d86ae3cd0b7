"""The MultiScale VO slice in bf16 (MIXED_PRECISION=True, the setting of
every shipped config_vo yaml): the port's frame step against rampvo_tpu's
frame by frame from the same state (CPU, 64x96, M=8, frames 0-9 with the
init burst at frame 7), under CORR_LAYOUT fused3 and fused4.

bf16 rounds at other places in the two frameworks, so no fixed tolerance
holds: from the same bf16 state one frame moves JAX's own bf16 result
away from its float32 result by an amount that depends on the frame. Each
compared quantity of the port must lie within SPREAD_MULTIPLE times that
spread of JAX's bf16 result (plus the float32 tolerance of
tests/test_torch_slice_stepwise.py, for frames where the spread is 0).
Events-only frames are not run: JAX casts their carry to bf16 where the
port keeps its dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.ops.corr_pallas import RING_PAD
from rampvo_tpu.vo import RampVO as JRampVO
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu_torch.vo import VOConfig
from rampvo_tpu_torch.vo import runtime as rt
from rampvo_tpu_torch.vo.state import init_state
from test_torch_slice import (  # noqa: F401  (weights is a fixture)
    INTR,
    KW,
    H,
    W,
    _torch_threads,
    assert_same_bookkeeping,
    frames,
    rand_d,
    weights,
)

MIXED = dict(KW, MIXED_PRECISION=True)
SPREAD_MULTIPLE = 4.0
# quantity -> the float32 tolerance of the stepwise slice test (the floor
# where JAX's bf16 and float32 results agree exactly, as before the
# first update)
FLOOR = {"poses": 1e-4, "pat_d": 5e-3, "delta_dP": 1e-4, "net": 1e-4,
         "last_weight": 1e-4}


def to_torch(x, dtype=None):
    """A JAX array as a torch tensor of its dtype (bf16 through float32:
    numpy's bfloat16 is not torch's)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.tensor(a.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(a, dtype=dtype)


def port_state(js, cfg):
    """The port's VOState holding the values of a JAX VOState of either
    precision (rings unpadded, encoder super-states channel-major), in the
    dtypes of `cfg`'s own state."""
    st = init_state(cfg, rt.make_enc_state(cfg, "MultiScale", H, W, "cpu"),
                    H, W, device="cpu")
    for name in ("poses", "pat_x", "pat_y", "pat_d", "pat_cx", "pat_cy",
                 "colors", "delta_dP", "imap_r", "gmap_r", "cell_valid",
                 "net", "last_weight", "slot_free", "intrinsics"):
        setattr(st, name, to_torch(getattr(js, name)).to(
            getattr(st, name).dtype))
    for name in ("delta_parent", "l2g", "slotmap"):
        setattr(st, name, to_torch(getattr(js, name), torch.int64))
    h, w = H // 4, W // 4
    p = RING_PAD
    st.fmap1_r = to_torch(js.fmap1_r[:, p:p + h, p:p + w]).to(
        st.fmap1_r.dtype)
    st.fmap2_r = to_torch(js.fmap2_r[:, p:p + h // 4, p:p + w // 4]).to(
        st.fmap2_r.dtype)
    st.enc = {"ss": [to_torch(s).reshape(-1, s.shape[-1]).T.contiguous().to(
        e.dtype) for s, e in zip(js.enc["ss"], st.enc["ss"])]}
    st.n, st.counter = int(js.n), int(js.counter)
    st.initialized = bool(js.initialized)
    return st


def as_f32(js):
    """A copy of a JAX state with every bf16 leaf cast to float32 (the
    state the float32 driver continues from; a copy, since the frame step
    donates its state's buffers)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.array(x, jnp.float32 if x.dtype == jnp.bfloat16
                            else x.dtype, copy=True), js)


def values(state, name, live):
    """float64 numpy values of one quantity over the state's first
    `counter` frames (the hidden state and weights on live cells only)."""
    x = getattr(state, name)
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    x = np.asarray(x, np.float64)
    if name in ("net", "last_weight"):
        return x[live]
    return x[:int(state.counter)]


@pytest.mark.parametrize("layout", ["fused3", "fused4"])
def test_mixed_precision_teacher_forced(weights, layout):
    """Frames 0-9, before each the port's state set to JAX's bf16 state:
    one frame in the JAX bf16 driver, in the JAX float32 driver from the
    same state cast to float32, and in the port's bf16 frame step.
    Bookkeeping identical to JAX bf16's; poses, inverse depths, eviction
    deltas, the live hidden state and the live weights each within
    SPREAD_MULTIPLE x max |JAX bf16 - JAX f32| (+ FLOOR) of JAX bf16. The
    port's correlation goes through the layout's wrapper (bf16 rings)."""
    params, net = weights
    jbf = JRampVO(JVOConfig(**MIXED, CORR_LAYOUT=layout), params, ht=H, wd=W)
    j32 = JRampVO(JVOConfig(**KW, CORR_LAYOUT=layout), params, ht=H, wd=W)
    pcfg = VOConfig(**MIXED, CORR_LAYOUT=layout)
    step = rt.make_vo_frame(pcfg, net, "cpu")
    M = MIXED["PATCHES_PER_FRAME"]
    worst = {}
    for f, (ev, im) in enumerate(frames(10, seed=1)):
        ps = port_state(jbf.state, pcfg)
        assert ps.gmap_r.dtype == ps.fmap1_r.dtype == torch.bfloat16
        rd = rand_d(jbf.state, M)
        j32.state = as_f32(jbf.state)
        args = (f, jnp.asarray(ev), jnp.asarray(im), np.array([True]), INTR)
        jbf(*args)
        j32(*args)
        ps = step(ps, ev, im, np.array([True]), INTR, rand_d=rd)
        assert_same_bookkeeping(jbf.state, ps, f)
        assert_same_bookkeeping(jbf.state, j32.state, f)
        live = np.asarray(jbf.state.cell_valid)
        for name, floor in FLOOR.items():
            ref = values(jbf.state, name, live)
            spread = float(np.abs(values(j32.state, name, live) - ref).max(
                initial=0.0))
            diff = float(np.abs(values(ps, name, live) - ref).max(
                initial=0.0))
            assert np.isfinite(diff), (f, name)
            assert diff <= SPREAD_MULTIPLE * spread + floor, (
                f, name, diff, spread)
            if spread > 0:
                worst[name] = max(worst.get(name, 0.0), diff / spread)
    assert bool(np.asarray(jbf.state.initialized)) and ps.initialized
    # the init burst and the updates after it moved every quantity
    assert set(worst) == set(FLOOR), worst
