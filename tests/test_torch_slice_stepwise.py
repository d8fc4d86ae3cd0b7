"""The MultiScale VO slice, step by step: before each frame the port's
state is set to rampvo_tpu's state, one frame runs in both drivers, and the
results are compared (CPU, MIXED_PRECISION=False, 64x96, M=8). Helpers
and weights are those of tests/test_torch_slice.py.
"""

import jax.numpy as jnp
import numpy as np

from rampvo_tpu.vo import RampVO as JRampVO
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu_torch.vo import VOConfig
from rampvo_tpu_torch.vo.runtime import make_vo_frame
from test_torch_slice import (  # noqa: F401  (weights is a fixture)
    INTR,
    KW,
    H,
    W,
    _torch_threads,
    assert_same_bookkeeping,
    frames,
    max_diff,
    port_state,
    rand_d,
    weights,
)


def test_slice_teacher_forced(weights):
    """Frame by frame from the same state: before each of 16 frames the
    port's state is set to the JAX state, one frame runs in both, and the
    results are compared. Default KEYFRAME_THRESH=15, so keyframes are
    evicted. Given identical states the motion magnitudes agree to ~1e-6,
    so the eviction decisions cannot differ unless one lands that close
    to the threshold.

    Bookkeeping identical; poses and eviction deltas within 1e-4, inverse
    depths within 5e-3 (the init-burst frame chains 12 updates)."""
    params, net = weights
    jcfg, pcfg = JVOConfig(**KW), VOConfig(**KW)
    jvo = JRampVO(jcfg, params, ht=H, wd=W)
    step = make_vo_frame(pcfg, net, "cpu")
    M = KW["PATCHES_PER_FRAME"]
    evicted = 0
    for f, (ev, im) in enumerate(frames(16, seed=1)):
        ps = port_state(jvo.state, pcfg)
        rd = rand_d(jvo.state, M)
        n0 = ps.n
        jvo(f, jnp.asarray(ev), jnp.asarray(im), np.array([True]), INTR)
        ps = step(ps, ev, im, np.array([True]), INTR, rand_d=rd)
        assert_same_bookkeeping(jvo.state, ps, f)
        evicted += ps.initialized and f != 7 and ps.n == n0
        assert max_diff(jvo.state, ps, "poses") < 1e-4, f
        assert max_diff(jvo.state, ps, "pat_d") < 5e-3, f
        assert max_diff(jvo.state, ps, "delta_dP") < 1e-4, f
    assert evicted > 0
