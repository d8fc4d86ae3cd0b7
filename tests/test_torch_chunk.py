"""The chunked VO path on the CPU: the branchless initialized frame
(`make_vo_frame(...).frame_init`, n and counter device scalars), the chunk
that runs K of them (`vo.graph.make_vo_frames_chunk`, a CUDA-graph replay
on the card, the same frames eagerly here) and the driver's buffering
(`RampVO(chunk=K)`), at tests/test_torch_slice.py's size (64x96, M=8,
float32).

The branchless frame computes what the host-driven frame computes, with
the same operations on the same values, so the two are held to each other
bit for bit; the port's chunked driver is held to the JAX driver's
chunked run within the slice tests' tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rampvo_tpu.vo import RampVO as JRampVO
from rampvo_tpu.vo import VOConfig as JVOConfig
from rampvo_tpu_torch.ba import core as bac
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.ops.corr_kernels import cell_tables_a
from rampvo_tpu_torch.vo import RampVO, VOConfig
from rampvo_tpu_torch.vo import runtime as rt
from rampvo_tpu_torch.vo.graph import (
    copy_state,
    make_vo_frames_chunk,
    state_tensors,
)
from rampvo_tpu_torch.vo.state import init_state
from test_torch_slice import (  # noqa: F401  (weights is a fixture)
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

ONE = np.ones(1, dtype=bool)
M = KW["PATCHES_PER_FRAME"]


def port_net(input_mode="MultiScale"):
    return init_weights(VONet(input_mode), torch.Generator().manual_seed(0))


def new_state(cfg, input_mode="MultiScale"):
    return init_state(cfg, rt.make_enc_state(cfg, input_mode, H, W, "cpu"),
                      H, W, device="cpu")


def assert_same_state(a, b, what):
    """Every tensor of the two states (encoder carry included) equal bit
    for bit, and the scalars equal."""
    assert (a.n, a.counter, a.initialized) == (b.n, b.counter,
                                               b.initialized), what
    ta, tb = state_tensors(a), state_tensors(b)
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta, tb)):
        assert torch.equal(x, y), (what, i)


def median_flow(cfg, step, state, frs):
    """The median keyframe flow (`runtime._keyframe_flow`, which the
    eviction compares with KEYFRAME_THRESH) of `frs` run from a copy of
    `state` by `step`, a never-evicting host-driven frame."""
    st, flows = copy_state(state), []
    for ev, im in frs:
        step(st, ev, im, ONE, INTR)
        flows.append(float(rt._keyframe_flow(cfg, st)))
    return float(np.median(flows))


@pytest.mark.parametrize("mixed", [False, True], ids=["no_evict", "evict"])
def test_branchless_frame_matches_host_frame(mixed):
    """Frame by frame from the same state, initialized and warmed without
    evictions to n = 12, past NI = 8 (the lattice rows wrap): the
    host-driven frame on a copy, the branchless frame on a view whose n
    and counter are 0-d tensors. The states are equal bit for bit after
    every frame, through 8 frames. `evict` sets KEYFRAME_THRESH to the
    median flow of the 8 frames run without evictions, so some frames
    evict and others are kept; `no_evict` never evicts."""
    cfg = VOConfig(**dict(KW, KEYFRAME_THRESH=0.0))
    net = port_net()
    step = rt.make_vo_frame(cfg, net, "cpu")
    st = new_state(cfg)
    fr = frames(20, seed=2)
    for ev, im in fr[:12]:
        step(st, ev, im, ONE, INTR)
    assert st.n == 12 > cfg.NI
    if mixed:
        cfg = VOConfig(**dict(KW, KEYFRAME_THRESH=median_flow(
            cfg, step, st, fr[12:])))
        step = rt.make_vo_frame(cfg, net, "cpu")
    evicted = 0
    for f, (ev, im) in enumerate(fr[12:], 12):
        host = copy_state(st)
        step(host, ev, im, ONE, INTR)
        view = dataclasses.replace(st, n=torch.tensor(st.n),
                                   counter=torch.tensor(st.counter))
        step.frame_init(view, torch.tensor(ev), torch.tensor(im),
                        torch.tensor(INTR))
        evicted += int(view.n) == st.n
        st.n, st.counter = int(view.n), int(view.counter)
        assert_same_state(host, st, f)
    assert (0 < evicted < 8) if mixed else evicted == 0, evicted


class HostReads(TorchDispatchMode):
    """Records each operation that reads a tensor on the host or makes one
    from host data: `.item()`, `bool()`, `int()` and a 0-d tensor used as
    an index (`_local_scalar_dense`), `torch.tensor`/`new_tensor` of
    Python data (`lift_fresh`), `nonzero` and indexing with a boolean
    mask. On the card each is a wait or a copy from the host, which a
    CUDA graph cannot hold."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bad = name in ("_local_scalar_dense", "lift_fresh", "nonzero")
        if name in ("index", "index_put", "index_put_"):
            bad = any(i is not None and i.dtype == torch.bool
                      for i in args[1])
        if bad:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("input_mode, layout", [
    ("MultiScale", "fused3"), ("SingleScale", "fused3"),
    ("MultiScale", "folded")])
def test_branchless_frame_reads_nothing_on_the_host(input_mode, layout):
    """The branchless frame, run on the CPU under `HostReads`, neither
    reads a tensor on the host nor uploads host data (an eviction frame
    and a kept one alike: both outcomes run on every frame). fused4 and
    fused2 are left out: their plain CPU versions walk the tables on the
    host, which their CUDA wrappers do not."""
    cfg = VOConfig(**dict(KW, KEYFRAME_THRESH=15.0, CORR_LAYOUT=layout))
    step = rt.make_vo_frame(cfg, port_net(input_mode), "cpu")
    st = new_state(cfg, input_mode)
    fr = frames(10, seed=7)
    for ev, im in fr[:9]:
        step(st, ev, im, ONE, INTR)
    view = dataclasses.replace(st, n=torch.tensor(st.n),
                               counter=torch.tensor(st.counter))
    ev, im = (torch.tensor(x) for x in fr[9])
    intr = torch.tensor(INTR)
    with HostReads() as reads:
        step.frame_init(view, ev, im, intr)
    assert reads.seen == []


@pytest.mark.parametrize("input_mode", ["MultiScale", "SingleScale"])
def test_chunk_matches_per_frame(input_mode):
    """RampVO(chunk=4) against RampVO(chunk=1) over 20 frames, an
    events-only frame after frame 13 (it flushes a partial buffer frame by
    frame) and a partial tail of 2 (flushed by final_refinement): two
    chunks run, and the states, the refined states and the trajectories
    are equal bit for bit. KEYFRAME_THRESH=1.5, about the median flow of
    these frames run without evictions (1.0-1.7), so a chunk holds both
    evicted and kept frames, and n passes NI = 8."""
    cfg = VOConfig(**dict(KW, KEYFRAME_THRESH=1.5))
    net = port_net(input_mode)
    vo1 = RampVO(cfg, net, ht=H, wd=W, device="cpu", seed=3)
    vo4 = RampVO(cfg, net, ht=H, wd=W, device="cpu", seed=3, chunk=4)
    chunk, evicted = vo4._vo_chunk, []

    def spy(state, *a):
        n0 = state.n
        chunk(state, *a)
        evicted.append(n0 + 4 - state.n)

    vo4._vo_chunk = spy
    for f, (ev, im) in enumerate(frames(20, seed=4)):
        for vo in (vo1, vo4):
            vo(f, ev, im, ONE, INTR)
            if f == 13:
                vo(f + 0.5, ev, im, np.zeros(1, bool), INTR)
    assert len(evicted) == 2 and len(vo4._buf) == 2
    assert any(0 < e < 4 for e in evicted), evicted
    vo1.final_refinement(2)
    vo4.final_refinement(2)
    assert vo1.state.n > cfg.NI, vo1.state.n
    assert_same_state(vo1.state, vo4.state, "final")
    (ta, sa), (tb, sb) = vo1.terminate(), vo4.terminate()
    np.testing.assert_array_equal(tb, ta)
    np.testing.assert_array_equal(sb, sa)


def jax_draws(rng, n):
    """The pre-initialization depths of the JAX driver's first n commits
    (each commit splits the state's key once)."""
    out = []
    for _ in range(n):
        rng, k1 = jax.random.split(rng)
        out.append(torch.tensor(np.asarray(jax.random.uniform(k1, (M,)))))
    return out


def test_chunk_matches_jax_chunk(weights):
    """The port's RampVO(chunk=4) against rampvo_tpu's RampVO(chunk=4) on
    the same weights, frames and pre-initialization depths: 17 frames
    with an events-only frame after frame 9 and a partial tail, never
    evicting (KEYFRAME_THRESH=0, as test_slice_free_running). After every
    call (both drivers buffer alike) the bookkeeping is identical, poses
    within 1e-4 and inverse depths within 5e-3; after final_refinement(2)
    the trajectories within 1e-4."""
    params, net = weights
    cfg_kw = dict(KW, KEYFRAME_THRESH=0.0)
    jvo = JRampVO(JVOConfig(**cfg_kw), params, ht=H, wd=W, chunk=4)
    pvo = RampVO(VOConfig(**cfg_kw), net, ht=H, wd=W, device="cpu", chunk=4)
    draws = jax_draws(jvo.state.rng, 17)
    for f, (ev, im) in enumerate(frames(17)):
        jvo(f, jnp.asarray(ev), jnp.asarray(im), ONE, INTR)
        pvo(f, ev, im, ONE, INTR, rand_d=draws[f])
        if f == 9:
            jvo(f + 0.5, jnp.asarray(ev), jnp.asarray(im),
                np.zeros(1, bool), INTR)
            pvo(f + 0.5, ev, im, np.zeros(1, bool), INTR)
        assert_same_bookkeeping(jvo.state, pvo.state, f)
        if pvo.state.counter:        # a buffered first chunk commits none
            assert max_diff(jvo.state, pvo.state, "poses") < 1e-4, f
            assert max_diff(jvo.state, pvo.state, "pat_d") < 5e-3, f
    assert len(pvo._buf) == 3 and pvo.state.n == 14
    jvo.final_refinement(2)
    pvo.final_refinement(2)
    assert_same_bookkeeping(jvo.state, pvo.state, "final")
    (ta, sa), (tb, sb) = jvo.terminate(), pvo.terminate()
    assert tb.shape == ta.shape == (17, 7)
    np.testing.assert_array_equal(sb, sa)
    np.testing.assert_allclose(tb, ta, atol=1e-4)


def test_state_keeps_its_storage():
    """Every tensor of the state (encoder carry included) keeps its
    storage through host-driven frames, the init burst, a chunk of
    branchless frames, an events-only step, a partial flush and
    final_refinement."""
    cfg = VOConfig(**dict(KW, KEYFRAME_THRESH=15.0))
    vo = RampVO(cfg, port_net(), ht=H, wd=W, device="cpu", chunk=4)
    ptrs = [t.data_ptr() for t in state_tensors(vo.state)]
    st = vo.state
    for f, (ev, im) in enumerate(frames(14, seed=5)):
        vo(f, ev, im, ONE, INTR)
        if f == 13:
            vo(f + 0.5, ev, im, np.zeros(1, bool), INTR)
    vo.final_refinement(2)
    assert vo.state is st and vo.state.initialized and vo.state.counter == 14
    assert [t.data_ptr() for t in state_tensors(vo.state)] == ptrs


def test_chunk_refuses():
    """The chunk runs initialized frames that fit the buffers, K at a
    time."""
    cfg = VOConfig(**KW)
    frames_k = make_vo_frames_chunk(cfg, port_net(), 4, "cpu")
    st = new_state(cfg)
    ev, im = torch.zeros(4, 1, H, W, 5), torch.zeros(4, 1, H, W, 3)
    with pytest.raises(ValueError, match="initialized"):
        frames_k(st, ev, im, INTR)
    st.initialized, st.n, st.counter = True, 8, cfg.MAX_FRAMES - 3
    with pytest.raises(ValueError, match="do not fit"):
        frames_k(st, ev, im, INTR)
    st.counter = 8
    with pytest.raises(ValueError, match="4 frames"):
        frames_k(st, ev[:3], im[:3], INTR)


@pytest.fixture(scope="module")
def ba_call():
    """The arguments of the last `ba_infer` call of a 12-frame run."""
    seen = []

    def spy(*a, **kw):
        seen.append((a, kw))
        return bac.ba_infer(*a, **kw)

    cfg = VOConfig(**dict(KW, KEYFRAME_THRESH=0.0))
    step = rt.make_vo_frame(cfg, port_net(), "cpu")
    st = new_state(cfg)
    orig, rt.ba_infer = rt.ba_infer, spy
    try:
        for ev, im in frames(12, seed=6):
            step(st, ev, im, ONE, INTR)
    finally:
        rt.ba_infer = orig
    return seen[-1]


@pytest.mark.parametrize("t0, t1", [(1, 3), (1, 9), (5, 9), (7, 9), (8, 9),
                                    (6, 5)])
def test_ba_infer_tensor_window(ba_call, t0, t1):
    """`ba_infer` with 0-d tensor t0/t1 (all window slots retracted, the
    live ones written) equals the host-int call bit for bit, for free
    windows narrower than N, clipped by the window's end, and empty."""
    a, kw = ba_call
    a = a[:9]
    want = bac.ba_infer(*a, t0, t1, **kw)
    got = bac.ba_infer(*a, torch.tensor(t0), torch.tensor(t1), **kw)
    for x, y in zip(want, got):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cfg_kw", [KW, {}], ids=["small", "default"])
def test_cell_tables_a_device_n(cfg_kw):
    """K6's tables built with a 0-d tensor n equal the host-int build, for
    n before and after the lattice fills."""
    cfg = VOConfig(**cfg_kw)
    NI, T, r = cfg.NI, cfg.T, cfg.PATCH_LIFETIME
    g = torch.Generator().manual_seed(1)
    cell_valid = torch.rand(NI, T, generator=g) < 0.7
    slotmap = torch.randint(-1, cfg.MEM, (64,), generator=g)
    for n in (1, 3, 8, NI, NI + 5, 60):
        want = cell_tables_a(NI, T, r, n, cell_valid, slotmap, cfg.MEM)
        got = cell_tables_a(NI, T, r, torch.tensor(n), cell_valid, slotmap,
                            cfg.MEM)
        for x, y in zip(want, got):
            assert torch.equal(x, y), n
