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

Stage map: a replay runs none of the capture's Python, so the frame's
stage spans (`runtime.STAGES`) are mapped at capture, whether tracing is
on or not: at each stage's entry and exit the capture reads how many
device nodes (kernels, copies, fills) the graph under capture holds
(`capture_node_counter`: libcuda calls that add no node).
`frames.stage_nodes` is the ordered list of (stage, nodes) that covers
every device node of the graph, nodes outside any stage under `OTHER`; a
replay runs them in that order, one profiler activity each, so a
profiler's activities of one replay, ordered by start, split by it
(`probes.stages.split_replay`). None where libcuda gives no count.

The host's hand-over of a chunk: `vo.chunk.stage` (the stacking of the K
frames, their conversion and copies into the static buffers, the
selection draws and the scalar fills), `vo.chunk.launch` (the replay; on
the CPU the eager frames) and `vo.chunk.wait` (reading `n` back) are
spans, and `frames.host` sums their host seconds over the chunks run
since the capture ("stage", "launch", "wait", "chunks"), with tracing on
or off (three clock reads a chunk).
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import torch

from .. import resolve_device
from ..models.vonet import VONet, selection_draws
from ..ops.corr_band_kernels import corr_folded_cuda, corr_lattice_bands
from ..ops.corr_kernels import corr_lattice, corr_lattice_cb
from ..ops.corr_paired_kernels import corr_lattice_paired
from ..ops.encoder_kernels import lstm_fold_cm
from ..ops.singlescale_kernels import lstm_carry_fold_cm
from ..utils.timing import observe_spans, span
from .config import VOConfig
from .runtime import STAGES, make_vo_frame
from .state import VOState

OTHER = "vo.frame.other"
# the graph node types a replay runs on the device, one profiler activity
# each: CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY and _MEMSET
DEVICE_NODES = (0, 1, 2)

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


def capture_node_counter(stream: torch.cuda.Stream):
    """count() -> the device nodes (kernels, copies and fills) of the graph
    that `stream` is capturing into, through libcuda
    (cuStreamGetCaptureInfo_v2, cuGraphGetNodes, cuGraphNodeGetType); None
    where libcuda lacks them. The allocation and free nodes of
    stream-ordered allocations (cuSOLVER's triangular solves add a pair)
    run nothing a profiler sees, so they are not counted. A graph lists
    its nodes in the order they were added, so each call types only the
    nodes added since the last. count() raises RuntimeError when a call
    fails or the stream is not capturing."""
    try:
        cu = ctypes.CDLL("libcuda.so.1")
        info, nodes, kind = (cu.cuStreamGetCaptureInfo_v2, cu.cuGraphGetNodes,
                             cu.cuGraphNodeGetType)
    except (OSError, AttributeError):
        return None
    info.restype = nodes.restype = kind.restype = ctypes.c_int
    info.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                     ctypes.POINTER(ctypes.c_uint64),
                     ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_void_p),
                     ctypes.POINTER(ctypes.c_size_t)]
    nodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.POINTER(ctypes.c_size_t)]
    kind.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle = ctypes.c_void_p(stream.cuda_stream)
    done = [0, 0]               # nodes typed so far, device nodes among them

    def count() -> int:
        status, cid, graph = ctypes.c_int(), ctypes.c_uint64(), \
            ctypes.c_void_p()
        deps, ndeps, n = ctypes.c_void_p(), ctypes.c_size_t(), \
            ctypes.c_size_t()
        err = info(handle, ctypes.byref(status), ctypes.byref(cid),
                   ctypes.byref(graph), ctypes.byref(deps),
                   ctypes.byref(ndeps))
        if err or status.value != 1:      # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError(f"cuStreamGetCaptureInfo: error {err}, "
                               f"status {status.value}")
        err = nodes(graph, None, ctypes.byref(n))
        if not err and n.value > done[0]:
            arr = (ctypes.c_void_p * n.value)()
            err = nodes(graph, arr, ctypes.byref(n))
            t = ctypes.c_int()
            for x in arr[done[0]:n.value]:
                err = err or kind(x, ctypes.byref(t))
                done[1] += t.value in DEVICE_NODES
            done[0] = n.value
        if err:
            raise RuntimeError(f"cuGraphGetNodes / cuGraphNodeGetType: "
                               f"error {err}")
        return done[1]

    return count


def stage_map(marks, total: int) -> list:
    """The ordered (stage, nodes) of a graph of `total` nodes from the
    (stage, entering, nodes so far) marks of its capture: the nodes between
    two marks belong to the innermost stage open there, or to OTHER;
    neighbours of one stage merge and empty stretches drop."""
    out, open_, at = [], [], 0
    for name, entering, n in list(marks) + [(None, False, total)]:
        if n > at:
            stage = open_[-1] if open_ else OTHER
            if out and out[-1][0] == stage:
                out[-1] = (stage, out[-1][1] + n - at)
            else:
                out.append((stage, n - at))
            at = n
        if name is not None:
            if entering:
                open_.append(name)
            else:
                open_.remove(name)
    return out


def make_vo_frames_chunk(cfg: VOConfig, vonet: VONet, K: int, device="cuda",
                         frame=None, seed: int = 0):
    """K initialized frames per call, with the semantics of K calls of the
    host-driven frame with a true mask.

    frames(state, events [K, 1, H, W, Ce], images [K, 1, H, W, 3],
    intrinsics [4], sel=None) -> state (events, images and each of `sel`
    also as a list of the K frames' arrays): `state` initialized, the same
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
    cuda, now = dev.type == "cuda", time.perf_counter
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
        stream = torch.cuda.Stream(dev)
        count = capture_node_counter(stream)
        marks = []

        def mark(name, entering):
            if name in STAGES:
                marks.append((name, entering, count()))

        with torch.cuda.graph(graph, stream=stream):
            if count is None:
                run(view, *bufs)
            else:
                with observe_spans(mark):
                    run(view, *bufs)
                total = count()
        after = launch_counts()
        frames.captured = {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}
        frames.stage_nodes = (None if count is None
                              else stage_map(marks, total))
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
        t0 = now()
        capturing = cuda and not held
        with span("vo.chunk.stage"):
            inputs = [_stacked(x, dev).float()
                      for x in (events, images, intrinsics)]
            if inputs[0].shape[0] != K or inputs[1].shape[0] != K:
                raise ValueError(f"a chunk holds {K} frames")
            if gen is not None:
                if sel is None:
                    ht, wd = inputs[1].shape[2:4]
                    sel = [x[:, None] for x in selection_draws(
                        cfg.GRADIENT_BIAS, K, cfg.M, ht, wd, gen)]
                inputs += [_stacked(x, dev).long() for x in sel]
            n_dev.fill_(state.n)
            counter_dev.fill_(state.counter)
            view = dataclasses.replace(state, n=n_dev, counter=counter_dev)
            if capturing:
                capture(view, inputs)
            elif cuda and held["ptrs"] != [t.data_ptr()
                                            for t in state_tensors(view)]:
                raise ValueError("the chunk's graph holds another state's "
                                 "tensors")
            if cuda:
                for b, x in zip(held["bufs"], inputs):
                    b.copy_(x)
        t1 = now()
        with span("vo.chunk.launch"):
            if not cuda:
                run(view, *inputs)
            else:
                if timing is not None:
                    timing[0].record()
                held["graph"].replay()
                if timing is not None:
                    timing[1].record()
        t2 = now()
        with span("vo.chunk.wait"):
            state.n = int(n_dev)
        if not capturing:
            h = frames.host
            h["stage"] += t1 - t0
            h["launch"] += t2 - t1
            h["wait"] += now() - t2
            h["chunks"] += 1
        state.counter += K
        return state

    frames.captured = {}
    frames.stage_nodes = None
    frames.host = {"stage": 0.0, "launch": 0.0, "wait": 0.0, "chunks": 0}
    return frames


def _stacked(x, dev):
    """`x` on `dev`; a list or tuple of per-frame arrays stacked first."""
    if isinstance(x, (list, tuple)):
        return torch.stack([torch.as_tensor(v, device=dev) for v in x])
    return torch.as_tensor(x, device=dev)
