"""The port's own spans in a profiler trace: device time by VO stage, the
host's idle gaps named by the span it was in, the loader's host time and
the host's time a launch. The trace is one `torch.profiler` session (CPU
and CUDA activities) over work run with tracing on
(`utils.timing.set_tracing(True)`); the reduction itself is plain Python
over lists, so the tests drive it with synthetic traces.

- Device work launched eagerly is put down to the innermost program span
  open at its launch call (the CUDA runtime or libcuda call with the same
  correlation id).
- A CUDA-graph replay runs none of the capture's Python: its activities
  share the correlation id of their `cudaGraphLaunch`, run in the order
  the capture recorded them, and split by the graph's stage map
  (`vo.graph`: `frames.stage_nodes`, the ordered (stage, nodes) of the
  capture).
- An idle gap of the device is named by the innermost program span open
  on the host at the gap's middle, else by the innermost of `fallback`
  (a caller's own span names), else "other".

`GROUPS` folds the seven frame stages into the five of `probes/breakdown.py`'s
stage split (encoder, commit with selection, update with correlation, BA,
keyframe).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..vo.runtime import STAGES

PROGRAM = STAGES + (                     # every span the program opens
    "vo.chunk.stage", "vo.chunk.launch", "vo.chunk.wait", "data.window",
    "data.events", "data.augment", "data.normalize", "data.collate",
    "train.h2d", "train.forward", "train.backward", "train.apply")
LOADER = tuple(n for n in PROGRAM if n.startswith("data."))
GROUPS = {
    "encoder": ("vo.frame.encoder",),
    "commit": ("vo.frame.patchify", "vo.frame.commit"),
    "update": ("vo.frame.corr", "vo.frame.update_net"),
    "ba": ("vo.frame.ba",),
    "keyframe": ("vo.frame.keyframe",),
}
TRAIN_STEP = ("train.forward", "train.backward", "train.apply")


@dataclass
class Events:
    """device: [(name, start_us, end_us, correlation)] (kernels, copies,
    fills); launches: [(name, start_us, end_us, correlation)] (the host's
    CUDA runtime and libcuda calls); spans: [(name, start_us, end_us)]
    (host spans: the program's, and any others the trace holds)."""
    device: list
    launches: list
    spans: list

    def program_spans(self):
        return [s for s in self.spans if s[0] in PROGRAM]


def from_profiler(prof, names=()) -> Events:
    """Events of a finished `torch.profiler.profile` session: host spans
    named in PROGRAM or `names`, the CUDA runtime and libcuda calls (host
    events named cuda* or cu*), and every device activity but the device
    side of those spans."""
    from torch.autograd import DeviceType

    span_names = set(PROGRAM) | set(names)
    dev, calls, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        item = (name, e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            if name not in span_names:
                dev.append(item + (e.correlation_id(),))
        elif name in span_names:
            spans.append(item)
        elif name.startswith("cu"):
            calls.append(item + (e.correlation_id(),))
    return Events(dev, calls, spans)


def innermost(spans, t: float, names=None):
    """The name of the innermost span of `spans` (the latest to open) open
    at host time t, among `names` when given; None if none is."""
    best = None
    for n, s, e in spans:
        if s <= t <= e and (names is None or n in names) and (
                best is None or s >= best[1]):
            best = (n, s)
    return best[0] if best else None


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def union_us(ivs, lo=float("-inf"), hi=float("inf")) -> list:
    """The union of the intervals [(start, end), ...] clipped to [lo, hi]."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in ivs
                       if e > lo and s < hi):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def graph_launches(ev: Events) -> dict:
    """{correlation: host start_us} of the trace's graph launches."""
    return {c: s for n, s, _, c in ev.launches if n.startswith("cudaGraphLaunch")}


def replays(ev: Events) -> list:
    """Each graph replay's device activities, ordered by start; replays in
    the order of their launches."""
    launch = graph_launches(ev)
    by: dict = {c: [] for c in launch}
    for d in ev.device:
        if d[3] in by:
            by[d[3]].append(d)
    return [sorted(by[c], key=lambda d: d[1])
            for c in sorted(by, key=launch.get)]


def split_replay(acts, stage_nodes):
    """[(stage, activities)] of one replay's ordered activities split by
    the stage map [(stage, nodes)], or None when the activities are not as
    many as the map's nodes."""
    if stage_nodes is None or len(acts) != sum(n for _, n in stage_nodes):
        return None
    out, at = [], 0
    for stage, n in stage_nodes:
        out.append((stage, acts[at:at + n]))
        at += n
    return out


def stage_device_us(ev: Events, stage_nodes) -> dict | None:
    """{stage: device µs} over every replay of the trace, split by the
    stage map; None when a replay's activities do not match the map."""
    out: dict = {}
    for acts in replays(ev):
        parts = split_replay(acts, stage_nodes)
        if parts is None:
            return None
        for stage, a in parts:
            out[stage] = out.get(stage, 0.0) + sum(e - s for _, s, e, _ in a)
    return out


def eager_device_us(ev: Events) -> dict:
    """{innermost program span at the launch, or "other": device µs} of
    the activities launched outside a graph replay."""
    graphs = graph_launches(ev)
    at = {c: s for _, s, _, c in ev.launches}
    spans = ev.program_spans()
    out: dict = {}
    for _, s, e, c in ev.device:
        if c in graphs:
            continue
        name = innermost(spans, at[c]) if c in at else None
        out[name or "other"] = out.get(name or "other", 0.0) + e - s
    return out


def group(stage_us: dict) -> dict:
    """`GROUPS`' five sums of a {stage: value} dict."""
    return {g: sum(stage_us.get(s, 0.0) for s in names)
            for g, names in GROUPS.items()}


def idle_gaps(ev: Events, lo: float, hi: float, fallback=()) -> list:
    """[(name, start_us, end_us)] of the device's idle gaps in [lo, hi],
    each named by the innermost program span open at its middle, else by
    the innermost span named in `fallback`, else "other"."""
    spans = ev.program_spans()
    out, at = [], lo
    busy = union_us([(s, e) for _, s, e, _ in ev.device], lo, hi)
    for s, e in busy + [[hi, hi]]:
        if s > at:
            mid = (at + s) / 2
            name = (innermost(spans, mid)
                    or innermost(ev.spans, mid, set(fallback)) or "other")
            out.append((name, at, s))
        at = max(at, e)
    return out


def span_union_us(ev: Events, names) -> float:
    """Host µs under the spans named in `names` (their union)."""
    return sum(e - s for s, e in union_us(
        [(s, e) for n, s, e in ev.spans if n in names]))


def host_us_per_launch(ev: Events, names=TRAIN_STEP) -> float | None:
    """Host µs under the spans named in `names` (their union) over the
    kernel launches made inside them: the launch calls that start inside
    one and whose correlation id some kernel of the trace carries."""
    ivs = union_us([(s, e) for n, s, e in ev.spans if n in names])
    kernels = {c for n, _, _, c in ev.device if is_kernel(n)}
    launches = sum(1 for _, s, _, c in ev.launches if c in kernels and any(
        a <= s <= b for a, b in ivs))
    if not launches:
        return None
    return sum(e - s for s, e in ivs) / launches
