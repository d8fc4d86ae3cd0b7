"""Patch selection without event bias in rampvo_tpu_torch on the CPU:
`select_coords_random` and `select_coords_gradient_bias` against
rampvo_tpu on its draws (exact), `RampVO(event_bias=False)` frame by frame
against the JAX RampVO with its selection and depth draws replayed from
its key (bookkeeping and selected patches exact, poses 1e-4, as the slice
tests), and the chunked driver against the eager one on the same draws,
bit for bit, with the branchless frame reading nothing on the host. Both
selectors: GRADIENT_BIAS true (image-gradient ranking of random
candidates) and false (uniform random). 64x96, M=8, float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rampvo_tpu.models import vonet as jvn
from rampvo_tpu.vo import RampVO as JRampVO
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu_torch.models import vonet as pvn
from rampvo_tpu_torch.vo import RampVO, VOConfig
from rampvo_tpu_torch.vo import runtime as rt
from rampvo_tpu_torch.vo.graph import copy_state, make_vo_frames_chunk
from test_torch_chunk import HostReads, assert_same_state, port_net
from test_torch_slice import (  # noqa: F401  (fixtures)
    INTR,
    KW,
    H,
    W,
    _torch_threads,
    assert_same_bookkeeping,
    frames,
    max_diff,
    weights,
)

M = KW["PATCHES_PER_FRAME"]
ONE = np.ones(1, dtype=bool)
SELECTORS = [False, True]
IDS = ["random", "gradient"]


def jax_sel(key, gradient, n, h, w):
    """The integers JAX's selector draws from `key` for n frames of a
    1/4-res map h x w (select_coords_random or _gradient_bias)."""
    C = 3 * M if gradient else M
    kx, ky = jax.random.split(key)
    x = jax.random.randint(kx, (n, C), 1, w - 1)
    y = jax.random.randint(ky, (n, C), 1, h - 1)
    return torch.tensor(np.asarray(x)), torch.tensor(np.asarray(y))


def sel_dims(gradient):
    return ((H - 1) // 4, (W - 1) // 4) if gradient else (H // 4, W // 4)


@pytest.mark.parametrize("gradient", SELECTORS, ids=IDS)
def test_selectors_match_jax(gradient):
    """On three frames and the same key: the port's selector given JAX's
    integers returns JAX's coordinates exactly (gradient: the ranking's
    ties included, since candidates repeat); `selection_draws` draws
    integers of the same shapes and ranges."""
    rng = np.random.RandomState(0)
    images = rng.rand(3, H, W, 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    h, w = sel_dims(gradient)
    draws = jax_sel(key, gradient, 3, h, w)
    if gradient:
        want = jvn.select_coords_gradient_bias(key, jnp.asarray(images), M)
        got = pvn.select_coords_gradient_bias(torch.tensor(images), M,
                                              draws=draws)
    else:
        want = jvn.select_coords_random(key, 3, M, h, w)
        got = pvn.select_coords_random(3, M, h, w, draws=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x, y = pvn.selection_draws(gradient, 3, M, H, W,
                               torch.Generator().manual_seed(0))
    assert x.shape == y.shape == draws[0].shape
    assert 1 <= int(x.min()) and int(x.max()) < w - 1
    assert 1 <= int(y.min()) and int(y.max()) < h - 1


def jax_frame_draws(key, gradient, n):
    """Per committed frame of the JAX driver without event bias: the
    selection integers (frame_post splits the state key first) and the
    pre-initialization depths (the commit splits it again)."""
    h, w = sel_dims(gradient)
    sel, depth = [], []
    for _ in range(n):
        key, k_sel = jax.random.split(key)
        sel.append(jax_sel(k_sel, gradient, 1, h, w))
        key, k_d = jax.random.split(key)
        depth.append(torch.tensor(np.asarray(jax.random.uniform(k_d, (M,)))))
    return sel, depth


@pytest.mark.parametrize("gradient", SELECTORS, ids=IDS)
def test_event_bias_false_matches_jax(weights, gradient):
    """RampVO(event_bias=False) in both packages on the same weights and
    frames, 12 frames (the init burst at frame 8, then updates, never
    evicting), the port given the JAX run's draws: after every frame the
    bookkeeping and the selected patch centers (pat_cx, pat_cy) are
    identical and the poses within 1e-4; the trajectories within 1e-4."""
    params, net = weights
    cfg_kw = dict(KW, KEYFRAME_THRESH=0.0, GRADIENT_BIAS=gradient)
    jvo = JRampVO(JVOConfig(**cfg_kw), params, ht=H, wd=W, event_bias=False)
    pvo = RampVO(VOConfig(**cfg_kw), net, ht=H, wd=W, device="cpu",
                 event_bias=False)
    sel, depth = jax_frame_draws(jvo.state.rng, gradient, 12)
    for f, (ev, im) in enumerate(frames(12, seed=3)):
        jvo(f, jnp.asarray(ev), jnp.asarray(im), ONE, INTR)
        pvo(f, ev, im, ONE, INTR, rand_d=depth[f], sel_draws=sel[f])
        assert_same_bookkeeping(jvo.state, pvo.state, f)
        for name in ("pat_cx", "pat_cy"):
            assert max_diff(jvo.state, pvo.state, name) == 0.0, (f, name)
        assert max_diff(jvo.state, pvo.state, "poses") < 1e-4, f
    assert pvo.state.initialized and pvo.state.n == 12
    (ta, sa), (tb, sb) = jvo.terminate(), pvo.terminate()
    np.testing.assert_array_equal(sb, sa)
    np.testing.assert_allclose(tb, ta, atol=1e-4)


@pytest.mark.parametrize("gradient", SELECTORS, ids=IDS)
def test_chunk_matches_eager_without_event_bias(gradient):
    """RampVO(event_bias=False, chunk=4) against chunk=1 over 16 frames:
    the pre-initialization frames take handed-in draws, the two chunks
    (frames 8-11, 12-15) draw theirs from the chunk's generator (seed 3),
    which the eager driver is handed; KEYFRAME_THRESH=1.5 evicts some
    frames and keeps others. States and trajectories equal bit for bit.
    The branchless frame then runs once more, on a copy, under
    `HostReads`: it reads nothing on the host and uploads nothing."""
    cfg = VOConfig(**dict(KW, KEYFRAME_THRESH=1.5, GRADIENT_BIAS=gradient))
    net = port_net()
    vo1, vo4 = (RampVO(cfg, net, ht=H, wd=W, device="cpu", seed=3,
                       event_bias=False, chunk=k) for k in (1, 4))
    g_chunk = torch.Generator().manual_seed(3)
    g_pre = torch.Generator().manual_seed(11)
    fr = frames(17, seed=4)
    for f, (ev, im) in enumerate(fr[:16]):
        if f < 8:
            d = pvn.selection_draws(gradient, 1, M, H, W, g_pre)
            vo4(f, ev, im, ONE, INTR, sel_draws=d)
        else:
            if f % 4 == 0:
                chunk_draws = pvn.selection_draws(gradient, 4, M, H, W,
                                                  g_chunk)
            d = tuple(x[f % 4:f % 4 + 1] for x in chunk_draws)
            vo4(f, ev, im, ONE, INTR)
        vo1(f, ev, im, ONE, INTR, sel_draws=d)
    assert not vo4._buf and vo4.state.n > 8
    assert vo4.state.n < 16, "no frame was evicted"
    assert_same_state(vo1.state, vo4.state, "chunks")
    (ta, sa), (tb, sb) = vo1.terminate(), vo4.terminate()
    np.testing.assert_array_equal(tb, ta)
    np.testing.assert_array_equal(sb, sa)

    st = copy_state(vo4.state)
    view = dataclasses.replace(st, n=torch.tensor(st.n),
                               counter=torch.tensor(st.counter))
    ev, im = (torch.tensor(x) for x in fr[16])
    sel = pvn.selection_draws(gradient, 1, M, H, W, g_pre)
    intr = torch.tensor(INTR)
    with HostReads() as reads:
        vo4._vo_frame.frame_init(view, ev, im, intr, sel)
    assert reads.seen == []
    assert int(view.counter) == st.counter + 1


def test_selection_refusals(weights):
    """The branchless frame without event bias needs its draws; an oracle
    runs neither in the branchless frame nor in the chunk."""
    _, net = weights
    vo = RampVO(VOConfig(**KW), net, ht=H, wd=W, device="cpu",
                event_bias=False)
    ev, im = (torch.tensor(x) for x in frames(1)[0])
    with pytest.raises(ValueError, match="selection draws"):
        vo._vo_frame.frame_init(vo.state, ev, im, torch.tensor(INTR))
    cfg = VOConfig(**KW)
    step = rt.make_vo_frame(cfg, vo.vonet, "cpu",
                            oracle=lambda state, ii, jj, kk, coords: None)
    with pytest.raises(ValueError, match="oracle"):
        step.frame_init(vo.state, ev, im, torch.tensor(INTR))
    with pytest.raises(ValueError, match="oracle"):
        make_vo_frames_chunk(cfg, vo.vonet, 4, "cpu", frame=step)
