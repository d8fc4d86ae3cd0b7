"""The program's tracing (`utils.timing`: `set_tracing`, `span`,
`observe_spans`), the spans the VO frame, the chunk, the loader and the
training step open, the chunk's host counters, the graph's stage map
(`vo.graph.stage_map`) and the reduction of a trace by the program's spans
(`probes.stages`), on the CPU: the port alone, at small sizes."""

import json

import numpy as np
import pytest
import torch

from rampvo_tpu_torch.cli import train as ptrain
from rampvo_tpu_torch.data import synthetic as psyn
from rampvo_tpu_torch.data.augmentation import EventRGBDAugmentor
from rampvo_tpu_torch.models.vonet import VONet, init_weights
from rampvo_tpu_torch.probes import stages as pst
from rampvo_tpu_torch.utils import timing
from rampvo_tpu_torch.vo import RampVO, VOConfig
from rampvo_tpu_torch.vo.graph import OTHER, stage_map
from rampvo_tpu_torch.vo.runtime import INIT_FRAMES, STAGES

H, W = 64, 96
KW = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=5,
          OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
          MIXED_PRECISION=False, PROBE_THRESH=-1.0, MAX_FRAMES=64, MEM=16)
INTR = np.array([50.0, 50.0, W / 2, H / 2], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def traced():
    """Tracing on for the test, off again after it."""
    timing.set_tracing(True)
    yield
    timing.set_tracing(False)


def frames(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(1, H, W, 5).astype(np.float32),
             rng.rand(1, H, W, 3).astype(np.float32)) for _ in range(n)]


def host_spans(prof, prefix):
    """(name, start_ns, end_ns) of the session's host spans whose name
    starts with `prefix`, by start."""
    out = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if str(e.activity_type()) == "user_annotation"
           and e.name().startswith(prefix)]
    return sorted(out, key=lambda s: s[1])


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------

def test_span_off_is_the_shared_noop(monkeypatch):
    """Tracing off (the default): `span` returns the one shared no-op and
    builds no profiler span; it enters and exits."""
    def refuse(name):
        raise AssertionError("a record_function was built")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = timing.span("vo.frame.encoder"), timing.span("data.window")
    assert a is b is timing.NO_SPAN
    with a:
        pass


def test_span_on_is_a_profiler_span(traced):
    """Tracing on: a profiler span, which `probes.stages.from_profiler`
    reads back with the other names it is given (the host holds no CUDA
    calls here)."""
    with torch.profiler.profile() as prof:
        with torch.profiler.record_function("caller"):
            with timing.span("vo.chunk.stage"):
                torch.ones(3).sum()
    assert [s[0] for s in host_spans(prof, "vo.")] == ["vo.chunk.stage"]
    ev = pst.from_profiler(prof, ("caller",))
    assert sorted(s[0] for s in ev.spans) == ["caller", "vo.chunk.stage"]
    assert [s[0] for s in ev.program_spans()] == ["vo.chunk.stage"]
    assert ev.device == [] and ev.launches == []
    timing.set_tracing(False)
    assert timing.span("vo.chunk.stage") is timing.NO_SPAN


def test_observe_spans_sees_spans_with_tracing_off():
    seen = []
    with timing.observe_spans(lambda n, entering: seen.append((n, entering))):
        with timing.span("a"):
            with timing.span("b"):
                pass
        with pytest.raises(RuntimeError):
            with timing.observe_spans(print):
                pass
    assert seen == [("a", True), ("b", True), ("b", False), ("a", False)]
    assert timing.span("a") is timing.NO_SPAN


# ---------------------------------------------------------------------------
# the VO frame and the chunk
# ---------------------------------------------------------------------------

def make_vo(chunk):
    net = init_weights(VONet("MultiScale"), torch.Generator().manual_seed(0))
    return RampVO(VOConfig(**KW), net, ht=H, wd=W, device="cpu",
                  chunk=chunk)


def test_eager_frame_opens_the_seven_stages_in_order(traced):
    """Each initialized host-driven frame opens the seven stage spans,
    once each and in order, inside its own time."""
    vo = make_vo(1)
    frs = frames(INIT_FRAMES + 2)
    for i, (ev, im) in enumerate(frs[:INIT_FRAMES]):
        vo(i, ev, im, [True], INTR)
    assert vo.state.initialized
    with torch.profiler.profile() as prof:
        for i, (ev, im) in enumerate(frs[INIT_FRAMES:]):
            with torch.profiler.record_function("frame"):
                vo(INIT_FRAMES + i, ev, im, [True], INTR)
    spans = host_spans(prof, "vo.frame.")
    assert [s[0] for s in spans] == list(STAGES) * 2
    for f in host_spans(prof, "frame"):
        inside = [s[0] for s in spans if f[1] <= s[1] and s[2] <= f[2]]
        assert inside == list(STAGES)


def test_chunk_opens_its_spans_and_counts_host_seconds(traced):
    """A CPU chunk opens vo.chunk.stage, launch and wait in turn, its K
    branchless frames' stages inside the launch, and adds to `frames.host`
    (no capture on the CPU: every chunk counts)."""
    K = 4
    vo = make_vo(K)
    frs = frames(INIT_FRAMES + 2 * K)
    for i, (ev, im) in enumerate(frs[:INIT_FRAMES]):
        vo(i, ev, im, [True], INTR)
        vo.flush()
    assert vo.state.initialized
    host = vo._vo_chunk.host
    assert host == {"stage": 0.0, "launch": 0.0, "wait": 0.0, "chunks": 0}
    with torch.profiler.profile() as prof:
        for i, (ev, im) in enumerate(frs[INIT_FRAMES:]):
            vo(INIT_FRAMES + i, ev, im, [True], INTR)
    chunk = host_spans(prof, "vo.chunk.")
    assert [s[0] for s in chunk] == ["vo.chunk.stage", "vo.chunk.launch",
                                     "vo.chunk.wait"] * 2
    stages = host_spans(prof, "vo.frame.")
    assert [s[0] for s in stages] == list(STAGES) * 2 * K
    for launch in chunk[1::3]:
        assert sum(launch[1] <= s[1] and s[2] <= launch[2]
                   for s in stages) == 7 * K
    assert host["chunks"] == 2 and vo.state.counter == INIT_FRAMES + 2 * K
    assert all(host[k] > 0 for k in ("stage", "launch", "wait"))
    assert vo._vo_chunk.stage_nodes is None       # no capture on the CPU


def test_stage_map_covers_every_node():
    """The capture's marks (stage, entering, nodes so far) to (stage,
    nodes): stretches outside a stage under OTHER, neighbours merged,
    empty stretches dropped, the total covered."""
    marks = [("vo.frame.encoder", True, 2), ("vo.frame.encoder", False, 5),
             ("vo.frame.patchify", True, 5), ("vo.frame.patchify", False, 5),
             ("vo.frame.commit", True, 6), ("vo.frame.commit", False, 9),
             ("vo.frame.encoder", True, 9), ("vo.frame.encoder", False, 12)]
    m = stage_map(marks, 14)
    assert m == [(OTHER, 2), ("vo.frame.encoder", 3), (OTHER, 1),
                 ("vo.frame.commit", 3), ("vo.frame.encoder", 3), (OTHER, 2)]
    assert sum(n for _, n in m) == 14
    assert stage_map([], 5) == [(OTHER, 5)] and stage_map([], 0) == []


# ---------------------------------------------------------------------------
# the loader and the training step
# ---------------------------------------------------------------------------

def train_config(augment):
    cfg = json.loads(json.dumps(psyn.EVAL_CFG))
    cfg["data_loader"]["train"]["args"].update(
        type="train", load_sampled_frames=True, data_drop="no",
        augment_data=augment, n_events_in_between=1, num_events_selected=400,
        n_frames=8, image_height=32, image_width=48, lr=1e-4, steps=2,
        steps_to_save_ckpt=2, clip=10.0, pose_weight=10.0, flow_weight=0.1,
        weight_decay=1e-6, pct_start=0.01)
    return cfg


def test_loader_and_step_spans(traced):
    """One MemoryDataset window (with augmentation) and one TrainLoop step:
    data.window with data.events inside it, data.augment, data.normalize,
    data.collate, then train.h2d, train.forward, train.backward and
    train.apply."""
    cfg = train_config(augment=True)
    data = psyn.MemoryDataset(psyn.memory_scene(24, 32, 48), cfg, seed=1,
                              fmin=0.001, fmax=1000.0)
    data.augmentor = EventRGBDAugmentor((32, 48), seed=1)   # crops to 32x48
    args = ptrain.parse_args(["--config_path", "unused.json", "--device",
                              "cpu", "--unroll_steps", "10",
                              "--structure_only_steps", "0"])
    loop = ptrain.TrainLoop(args, cfg, data, M=8)
    with torch.profiler.profile() as prof:
        m = loop.step(loop.make_batch())
    assert np.isfinite(m["loss"])
    data_spans = host_spans(prof, "data.")
    names = [s[0] for s in data_spans]
    window = [s for s in data_spans if s[0] == "data.window"]
    events = [s for s in data_spans if s[0] == "data.events"]
    assert len(window) == 1 and len(events) >= 8
    assert all(window[0][1] <= s[1] and s[2] <= window[0][2] for s in events)
    assert [n for n in names if n != "data.events"] == [
        "data.window", "data.augment", "data.normalize", "data.collate"]
    assert [s[0] for s in host_spans(prof, "train.")] == [
        "train.h2d", "train.forward", "train.backward", "train.apply"]


# ---------------------------------------------------------------------------
# probes.stages on synthetic traces
# ---------------------------------------------------------------------------

STAGE_NODES = [(OTHER, 1), ("vo.frame.encoder", 2), ("vo.frame.ba", 1)]


def synthetic_events():
    """Two graph replays of 4 nodes (correlations 7 and 9), an eager copy
    and kernel launched under spans (correlations 3 and 4), one launch
    without a span (5); host spans of the program and of a caller."""
    rep = lambda c, t: [(f"k{i}", t + 10 * i, t + 10 * i + 8, c)
                        for i in (2, 0, 3, 1)]       # out of start order
    device = (rep(7, 100) + rep(9, 300)
              + [("Memcpy HtoD", 60, 70, 3), ("elementwise", 80, 90, 4),
                 ("gemm", 200, 230, 5)])
    launches = [("cudaGraphLaunch", 95, 98, 7), ("cudaGraphLaunch", 290, 292, 9),
                ("cudaMemcpyAsync", 50, 52, 3), ("cudaLaunchKernel", 55, 57, 4),
                ("cudaLaunchKernel", 190, 191, 5)]
    spans = [("vo.handoff", 40, 300), ("vo.chunk.stage", 45, 58),
             ("vo.frame.commit", 54, 58), ("vo.chunk.launch", 94, 99),
             ("vo.chunk.wait", 99, 180), ("vobench.slice", 0, 400)]
    return pst.Events(device, launches, spans)


def test_split_replay_by_the_stage_map():
    acts = [("a", 0, 1, 7), ("b", 1, 2, 7), ("c", 2, 3, 7), ("d", 3, 4, 7)]
    parts = pst.split_replay(acts, STAGE_NODES)
    assert [(s, [a[0] for a in x]) for s, x in parts] == [
        (OTHER, ["a"]), ("vo.frame.encoder", ["b", "c"]),
        ("vo.frame.ba", ["d"])]
    assert pst.split_replay(acts[:3], STAGE_NODES) is None
    assert pst.split_replay(acts + acts[:1], STAGE_NODES) is None
    assert pst.split_replay(acts, None) is None


def test_replays_split_by_launch_and_start():
    ev = synthetic_events()
    reps = pst.replays(ev)
    assert [[a[0] for a in r] for r in reps] == [["k0", "k1", "k2", "k3"]] * 2
    us = pst.stage_device_us(ev, STAGE_NODES)
    assert us == {OTHER: 16.0, "vo.frame.encoder": 32.0, "vo.frame.ba": 16.0}
    assert pst.stage_device_us(ev, STAGE_NODES[:2]) is None
    g = pst.group({"vo.frame.corr": 1.0, "vo.frame.update_net": 2.0,
                   "vo.frame.patchify": 4.0, "vo.frame.ba": 8.0, OTHER: 16.0})
    assert g == {"encoder": 0.0, "commit": 4.0, "update": 3.0, "ba": 8.0,
                 "keyframe": 0.0}


def test_eager_work_goes_to_the_span_of_its_launch():
    """By correlation id: the copy launched in vo.chunk.stage, the kernel
    in vo.frame.commit (the innermost), the gemm outside every program
    span; replays are left to the stage map."""
    assert pst.eager_device_us(synthetic_events()) == {
        "vo.chunk.stage": 10.0, "vo.frame.commit": 10.0, "other": 30.0}


def test_idle_gaps_are_named_by_the_program_span():
    ev = synthetic_events()
    gaps = pst.idle_gaps(ev, 0, 400, fallback=("vo.handoff",))
    assert [g for g in gaps if g[2] - g[1] > 5] == [
        ("other", 0, 60), ("vo.handoff", 70, 80), ("vo.chunk.launch", 90, 100),
        ("vo.chunk.wait", 138, 200), ("vo.handoff", 230, 300),
        ("other", 338, 400)]
    # the 2 µs gaps between a replay's kernels: in the wait, then (past
    # vo.handoff's end) in no span
    assert [g[0] for g in gaps if g[2] - g[1] <= 5] == [
        "vo.chunk.wait"] * 3 + ["other"] * 3
    assert pst.idle_gaps(ev, 0, 400)[1][0] == "other"


def test_host_time_under_spans_and_a_launch():
    """Loader seconds are the union of its spans; host µs a launch counts
    the kernel launches (not the copies) made inside the step's spans."""
    spans = [("data.window", 0, 50), ("data.events", 10, 20),
             ("data.normalize", 60, 70), ("train.forward", 100, 140),
             ("train.backward", 150, 170), ("train.apply", 180, 190)]
    device = [("k", 0, 1, 1), ("k", 0, 1, 2), ("Memcpy HtoD", 0, 1, 3),
              ("k", 0, 1, 4), ("k", 0, 1, 5)]
    launches = [("cudaLaunchKernel", 101, 102, 1),
                ("cudaLaunchKernel", 155, 156, 2),
                ("cudaMemcpyAsync", 120, 121, 3),
                ("cudaLaunchKernel", 185, 186, 4),
                ("cudaLaunchKernel", 175, 176, 5)]    # between the spans
    ev = pst.Events(device, launches, spans)
    data = [n for n in {s[0] for s in spans} if n.startswith("data.")]
    assert pst.span_union_us(ev, data) == 60.0
    assert pst.host_us_per_launch(ev) == pytest.approx(70.0 / 3)
    assert pst.host_us_per_launch(pst.Events([], [], spans)) is None
