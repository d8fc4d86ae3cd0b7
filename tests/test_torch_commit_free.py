"""The commit's slot free (`vo/runtime.py::_commit`) against the
accumulating index write over the whole slot map, which
`vobench/reference/vo/runtime.py` keeps: `slotmap` and `slot_free` equal
bit for bit after the commit, from random states at two capacities with a
host `n` and a device one, and through a run of frames with evictions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rampvo_tpu_torch.vo import VOConfig
from rampvo_tpu_torch.vo import runtime as rt
from rampvo_tpu_torch.vo.graph import copy_state
from rampvo_tpu_torch.vo.state import init_state
from test_torch_chunk import ONE, new_state, port_net
from test_torch_slice import (  # noqa: F401  (a fixture)
    INTR,
    KW,
    H,
    W,
    _torch_threads,
    frames,
)

P, DIM = 3, 384


def accumulated_bookkeeping(cfg, slotmap, slot_free, n: int):
    """`_commit`'s slot bookkeeping with the free written as an
    accumulating index write over the slot map: (slotmap, slot_free)."""
    L, MEM = cfg.BUFFER_SIZE, cfg.MEM
    sm, free = slotmap.clone(), slot_free.clone()
    old = torch.arange(L) < n - cfg.FEATURE_WINDOW
    freed = torch.zeros(MEM + 1, dtype=torch.int32)
    freed.index_put_((torch.where(old & (sm >= 0), sm, MEM),),
                     torch.ones_like(sm, dtype=torch.int32), accumulate=True)
    free |= freed[:MEM] > 0
    sm.masked_fill_(old, -1)
    s = int(torch.argmax(free.int()))
    free[s] = False
    sm[n] = s
    return sm, free


def commit_inputs(cfg, hw4):
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    M = cfg.M
    return (z(1, *hw4, 128), z(1, M, P, P, 128), z(1, M, DIM),
            z(1, M, 3, P, P), z(1, M, 3), torch.tensor(INTR))


@pytest.mark.parametrize("device_n", [False, True], ids=["host_n",
                                                         "device_n"])
@pytest.mark.parametrize("capacity, n", [
    (64, 3), (64, 8), (64, 9), (64, 30), (64, 63),
    (16384, 5), (16384, 40), (16384, 9000), (16384, 16383)])
def test_free_matches_accumulated_write(capacity, n, device_n):
    """A random slot map (about half its rows -1, the others any slot,
    repeats included; above FEATURE_WINDOW the row that ages out now holds
    one) and free list, `n` below, at and above FEATURE_WINDOW: the commit
    leaves both as the accumulating write does."""
    cfg = VOConfig(**dict(KW, BUFFER_SIZE=capacity, MAX_FRAMES=capacity))
    st = init_state(cfg, None, H, W, P, DIM, device="cpu")
    rng = np.random.RandomState(capacity + n)
    sm = rng.randint(0, cfg.MEM, capacity)
    sm[rng.rand(capacity) < 0.5] = -1
    if n > cfg.FEATURE_WINDOW:      # a row that ages out now holds a slot
        sm[n - cfg.FEATURE_WINDOW - 1] = cfg.MEM - 1
    st.slotmap.copy_(torch.from_numpy(sm))
    st.slot_free.copy_(torch.from_numpy(rng.rand(cfg.MEM) < 0.3))
    st.initialized = True
    want = accumulated_bookkeeping(cfg, st.slotmap, st.slot_free, n)
    if device_n:
        st.n, st.counter = torch.tensor(n), torch.tensor(n)
    else:
        st.n, st.counter = n, n
    rt._commit(cfg, st, *commit_inputs(cfg, st.hw4), None)
    assert torch.equal(st.slotmap, want[0])
    assert torch.equal(st.slot_free, want[1])
    assert int(st.counter) == n + 1


@pytest.fixture(scope="module")
def warmed():
    """The network, the frame that keeps every keyframe, the state after
    twelve such frames (n = 12, past FEATURE_WINDOW = 8) and ten more
    frames."""
    net = port_net()
    keep = rt.make_vo_frame(VOConfig(**dict(KW, KEYFRAME_THRESH=0.0)), net,
                            "cpu")
    st = new_state(VOConfig(**KW))
    fr = frames(22, seed=3)
    for ev, im in fr[:12]:
        keep(st, ev, im, ONE, INTR)
    assert st.n == 12
    return net, keep, st, fr[12:]


@pytest.mark.parametrize("device_n", [False, True], ids=["host_n",
                                                         "device_n"])
def test_free_matches_accumulated_write_through_evictions(
        monkeypatch, warmed, device_n):
    """From the warmed state, ten frames of which every other one is
    forced to evict (KEYFRAME_THRESH far above any flow): before each
    commit the accumulating write runs on a copy of the slot map and free
    list, and the commit's slotmap and slot_free are held to it.
    `device_n` runs the ten as branchless frames with device `n` and
    counter."""
    net, keep, st, fr = warmed
    st = copy_state(st)
    seen = {"freed": 0}
    commit = rt._commit

    def checked(cfg, state, *args):
        n = int(state.n)
        want = accumulated_bookkeeping(cfg, state.slotmap, state.slot_free,
                                       n)
        aged = torch.arange(cfg.BUFFER_SIZE) < n - cfg.FEATURE_WINDOW
        seen["freed"] += int((aged & (state.slotmap >= 0)).sum())
        commit(cfg, state, *args)
        assert torch.equal(state.slotmap, want[0]), n
        assert torch.equal(state.slot_free, want[1]), n

    monkeypatch.setattr(rt, "_commit", checked)
    evict = rt.make_vo_frame(VOConfig(**dict(KW, KEYFRAME_THRESH=1e9)), net,
                             "cpu")
    ns = []
    for f, (ev, im) in enumerate(fr):
        step = evict if f % 2 else keep
        if device_n:
            view = dataclasses.replace(st, n=torch.tensor(st.n),
                                       counter=torch.tensor(st.counter))
            step.frame_init(view, torch.tensor(ev), torch.tensor(im),
                            torch.tensor(INTR))
            st.n, st.counter = int(view.n), int(view.counter)
        else:
            step(st, ev, im, ONE, INTR)
        ns.append(st.n)
    assert ns == [13, 13, 14, 14, 15, 15, 16, 16, 17, 17], ns
    assert seen["freed"] == 6, seen
