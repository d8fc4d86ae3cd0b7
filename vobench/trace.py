"""The traced slice of a run: torch.profiler over a fixed number of chunks
or steps, reduced to what the per-layer readers and the result's `device`
and `breakdown` need.

Device activities are the profiler's CUDA events (kernels, copies,
fills); kernels are those that are neither a copy nor a fill. Busy time
is the union of the activities' intervals clipped to the slice (never a
sum of kernel times, which double-counts overlap); the slice is the host
span `vobench.slice` that the loop opens around the traced work. Idle
gaps are named by the innermost benchmark span (`SPANS`) that the host
was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

SPANS = ("vo.handoff", "vo.pose_readout", "loader.next", "train.step",
         "optimizer")
SLICE = "vobench.slice"


@dataclass
class Trace:
    """Device activities [(name, start_us, end_us)], host spans
    [(name, start_us, end_us)], the slice (start_us, end_us), and what the
    loop counted over it (`work`: frames or steps and their work
    counts; `counters`: launch counters and the like)."""
    device: list
    spans: list
    slice: tuple
    work: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.slice[1] - self.slice[0]) / 1e6

    def kernels(self):
        return [d for d in self.device if not _is_copy(d[0])]

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels whose name holds one of `names`
        (clipped to the slice)."""
        lo, hi = self.slice
        return sum(max(0.0, min(e, hi) - max(s, lo)) for n, s, e in
                   self.kernels() if any(k in n for k in names)) / 1e6

    def busy_s(self) -> float:
        """Seconds of the slice in which some device activity ran."""
        lo, hi = self.slice
        return sum(e - s for s, e in _union(self.device, lo, hi)) / 1e6

    def gaps(self):
        """Idle intervals [(start_us, end_us)] of the slice."""
        lo, hi = self.slice
        out, at = [], lo
        for s, e in _union(self.device, lo, hi):
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if hi > at:
            out.append((at, hi))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The slice's top device operations by time, and its longest idle
        gaps named by the host span around them, [[name, seconds]]."""
        lo, hi = self.slice
        by: dict = {}
        for n, s, e in self.device:
            d = max(0.0, min(e, hi) - max(s, lo))
            by[n] = by.get(n, 0.0) + d / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[self.host_at((s + e) / 2), (e - s) / 1e6]
                              for s, e in gaps]}

    def host_at(self, t: float) -> str:
        """The innermost benchmark span open at host time t."""
        best = None
        for n, s, e in self.spans:
            if n in SPANS and s <= t <= e and (best is None
                                               or s >= best[1]):
                best = (n, s)
        return best[0] if best else "other"


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _union(acts, lo, hi):
    """The union of the activities' intervals clipped to [lo, hi]."""
    ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in acts
                 if e > lo and s < hi)
    out = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@contextlib.contextmanager
def profiled(on: bool):
    """torch.profiler (CPU and CUDA activities) around the block when
    `on`; yields a holder whose `.trace` is set to a `Trace` after the
    block (None when off)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    class Holder:
        trace = None

    h = Holder()
    if not on:
        yield h
        return
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield h
        torch.cuda.synchronize()
    dev, spans, sl = [], [], None
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            if item[0] not in SPANS and item[0] != SLICE:
                dev.append(item)    # not a span's device-side annotation
        elif item[0] == SLICE:
            sl = item[1:]
        elif item[0] in SPANS:
            spans.append(item)
    if sl is None:
        raise RuntimeError(f"the trace holds no {SLICE} span")
    if not dev:
        raise RuntimeError("the profiler saw no device activity")
    h.trace = Trace(dev, spans, sl)
