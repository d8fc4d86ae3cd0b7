"""K initialized VO frames per host call (port of
rampvo_tpu/vo/runtime.py::make_vo_frames_chunk, there a `lax.scan` of K
frames inside one jit).

On the card the K branchless frames (`make_vo_frame(...).frame_init`) are
captured once into one `torch.cuda.CUDAGraph` that reads static input
buffers; a call copies the K frames in and replays the graph, so the host
issues one replay where the eager frames issue ~2640 launches each. On the
CPU the same K frames run eagerly, so the CPU tests run every operation
the graph holds. A capture or a replay that fails raises: nothing falls
back to eager frames on the card.

Patch selection without event_bias draws its integers before each call,
on the device, from the chunk's own generator (or takes them from the
caller) into the static inputs the graph reads: the capture holds no
random number generation and no upload.

Launch counters: a kernel wrapper counts where the host issues its launch,
which for a graph is the capture, not the replay. `frames.captured` holds
the launches the capture counted, by wrapper name; every replay runs that
many again.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..models.vonet import VONet, selection_draws
from ..ops.corr_band_kernels import corr_folded_cuda, corr_lattice_bands
from ..ops.corr_kernels import corr_lattice, corr_lattice_cb
from ..ops.corr_paired_kernels import corr_lattice_paired
from ..ops.encoder_kernels import lstm_fold_cm
from ..ops.singlescale_kernels import lstm_carry_fold_cm
from .config import VOConfig
from .runtime import make_vo_frame
from .state import VOState

# the wrappers, with their launch counters, of the kernels a VO frame runs
VO_KERNELS = (corr_lattice, corr_lattice_cb, corr_lattice_paired,
              corr_folded_cuda, corr_lattice_bands, lstm_fold_cm,
              lstm_carry_fold_cm)


def launch_counts() -> dict:
    return {f.__name__: f.launches for f in VO_KERNELS}


def _leaves(x):
    """The tensors of a tree of dicts and lists."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone(v) for v in x)
    return x.clone() if isinstance(x, torch.Tensor) else x


def copy_state(state: VOState) -> VOState:
    """A state holding copies of every tensor of `state`."""
    return dataclasses.replace(state, **{
        f.name: _clone(getattr(state, f.name))
        for f in dataclasses.fields(state)})


def state_tensors(state: VOState) -> list:
    """Every tensor of a state, in field order (the encoder carry's too)."""
    return [t for f in dataclasses.fields(state)
            for t in _leaves(getattr(state, f.name))]


def make_vo_frames_chunk(cfg: VOConfig, vonet: VONet, K: int, device="cuda",
                         frame=None, seed: int = 0):
    """K initialized frames per call, with the semantics of K calls of the
    host-driven frame with a true mask.

    frames(state, events [K, 1, H, W, Ce], images [K, 1, H, W, 3],
    intrinsics [4], sel=None) -> state: `state` initialized, the same
    state object on every call (the graph holds its tensors); `intrinsics`
    serve all K frames, as the JAX chunk takes its first frame's. The host
    checks that the K frames fit the buffers, fills the device scalars `n`
    and `counter` from the state's host values, runs the frames and reads
    `n` back once (one wait a chunk). `frame` is a `make_vo_frame` step of
    the same network to share (weights packed once; its patch selection
    is the chunk's), else an event-biased one is made; `vonet` must live
    on `device`. A step without event_bias takes each frame's selection
    draws from `sel` ((x, y) [K, 1, C] integers) or draws them on the
    device from a generator seeded with `seed`. A step with an oracle is
    refused. `timing`, a pair of CUDA events, is recorded just before and
    just after the replay (the card only; probes/breakdown.py times
    replays so).
    """
    dev = resolve_device(device)
    step = make_vo_frame(cfg, vonet, dev) if frame is None else frame
    if step.oracle is not None:
        raise ValueError("the chunked frames run no oracle")
    gen = (None if step.event_bias
           else torch.Generator(device=dev).manual_seed(seed))
    n_dev = torch.zeros((), dtype=torch.int64, device=dev)
    counter_dev = torch.zeros((), dtype=torch.int64, device=dev)
    held: dict = {}

    def run(view, events, images, intrinsics, *sel):
        for k in range(K):
            step.frame_init(view, events[k], images[k], intrinsics,
                            tuple(s[k] for s in sel) or None)

    def capture(view, inputs):
        bufs = [x.clone() for x in inputs]           # the static inputs
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # every kernel's first launch (module loading, shared-memory
            # attributes, library handles) outside the capture, on a copy
            # of the state
            step.frame_init(copy_state(view), bufs[0][0], bufs[1][0],
                            bufs[2], tuple(s[0] for s in bufs[3:]) or None)
        cur.wait_stream(side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run(view, *bufs)
        after = launch_counts()
        frames.captured = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        held.update(graph=graph, bufs=bufs,
                    ptrs=[t.data_ptr() for t in state_tensors(view)])

    def frames(state: VOState, events, images, intrinsics, sel=None,
               timing=None):
        if not state.initialized:
            raise ValueError("make_vo_frames_chunk runs initialized frames")
        if state.counter + K > cfg.MAX_FRAMES or state.n + K > cfg.BUFFER_SIZE:
            raise ValueError(
                f"{K} more frames do not fit: counter {state.counter} of "
                f"MAX_FRAMES {cfg.MAX_FRAMES}, n {state.n} of BUFFER_SIZE "
                f"{cfg.BUFFER_SIZE}")
        inputs = [torch.as_tensor(x, device=dev).float()
                  for x in (events, images, intrinsics)]
        if inputs[0].shape[0] != K or inputs[1].shape[0] != K:
            raise ValueError(f"a chunk holds {K} frames")
        if gen is not None:
            if sel is None:
                ht, wd = inputs[1].shape[2:4]
                sel = [x[:, None] for x in selection_draws(
                    cfg.GRADIENT_BIAS, K, cfg.M, ht, wd, gen)]
            inputs += [torch.as_tensor(x, device=dev).long() for x in sel]
        n_dev.fill_(state.n)
        counter_dev.fill_(state.counter)
        view = dataclasses.replace(state, n=n_dev, counter=counter_dev)
        if dev.type != "cuda":
            run(view, *inputs)
        else:
            if not held:
                capture(view, inputs)
            elif held["ptrs"] != [t.data_ptr() for t in state_tensors(view)]:
                raise ValueError("the chunk's graph holds another state's "
                                 "tensors")
            for b, x in zip(held["bufs"], inputs):
                b.copy_(x)
            if timing is not None:
                timing[0].record()
            held["graph"].replay()
            if timing is not None:
                timing[1].record()
        state.n = int(n_dev)
        state.counter += K
        return state

    frames.captured = {}
    return frames
