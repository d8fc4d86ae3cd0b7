"""Section timing and the program's tracing switch (port of
rampvo_tpu/utils/timing.py; ref ramp/utils.py:22-44, the reference's
CUDA-event Timer).

Tracing is off by default and turned on for the whole process by
`set_tracing(True)`; nothing else turns it on (no environment variable, no
flag). `span(name)` is the program's one way to open a span: with tracing
off it returns one shared no-op context manager (no profiler object is
made and no clock is read), with tracing on a
`torch.profiler.record_function(name)`, which a running profiler records
on its host clock beside the device activities it traces. A stage that
the VO frame opens inside a CUDA-graph capture is also seen by the
capture's observer (`observe_spans`), whether tracing is on or not:
vo/graph.py maps the graph's nodes to stages so.

A section is timed on the card by default: by CUDA events recorded on the
current stream (the device time between them, read after a synchronize at
the section's end). With `device="cpu"`, and only when asked so, it is
timed by the host clock. A `Timer` opens its span through `span`, always
(an enabled Timer asks for it), so it appears in profiler traces, where
the JAX package opens a `jax.profiler.TraceAnnotation`.

`queued_ms` times a call's device work alone, without the host's issue.
"""

from __future__ import annotations

import contextlib
import time

import torch

_tracing = False
_observer = None        # observe_spans' callback, during a graph capture


class _NoSpan:
    """The span of a switched-off trace: enters and exits, does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def set_tracing(on: bool) -> None:
    """Turn the program's spans on or off for the whole process."""
    global _tracing
    _tracing = bool(on)


class _ObservedSpan:
    """A span inside `observe_spans`: the observer sees its entry and its
    exit; with tracing on it is a profiler span as well."""

    __slots__ = ("name", "inner")

    def __init__(self, name: str, inner):
        self.name, self.inner = name, inner

    def __enter__(self):
        _observer(self.name, True)
        self.inner.__enter__()
        return self

    def __exit__(self, *exc):
        self.inner.__exit__(*exc)
        _observer(self.name, False)
        return False


def span(name: str, on: bool | None = None):
    """A context manager spanning a section named `name`: a profiler span
    when tracing is on (or `on` is true), else the shared no-op."""
    inner = (torch.profiler.record_function(name)
             if (_tracing if on is None else on) else NO_SPAN)
    if _observer is None:
        return inner
    return _ObservedSpan(name, inner)


@contextlib.contextmanager
def observe_spans(fn):
    """Call fn(name, entering) at each span's entry (True) and exit
    (False) inside the block."""
    global _observer
    if _observer is not None:
        raise RuntimeError("spans are already observed")
    _observer = fn
    try:
        yield
    finally:
        _observer = None


class Timer:
    """with Timer("BA", enabled=True, device=...): ... -- the section's
    time in seconds, appended to results[name] when `results` is given,
    else printed in ms."""

    def __init__(self, name: str, enabled: bool = True,
                 results: dict | None = None, device="cuda"):
        self.name = name
        self.enabled = enabled
        self.results = results
        self.cuda = torch.device(device).type == "cuda"
        self._span = None

    def __enter__(self):
        if self.enabled:
            self._span = span(self.name, on=True)
            self._span.__enter__()
            if self.cuda:
                self._start = torch.cuda.Event(enable_timing=True)
                self._end = torch.cuda.Event(enable_timing=True)
                self._start.record()
            else:
                self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.enabled:
            if self.cuda:
                self._end.record()
                self._end.synchronize()
                dt = self._start.elapsed_time(self._end) / 1e3
            else:
                dt = time.perf_counter() - self.t0
            self._span.__exit__(*exc)
            if self.results is not None:
                self.results.setdefault(self.name, []).append(dt)
            else:
                print(f"{self.name}: {dt * 1e3:.2f} ms")
        return False


def queued_ms(fn, n: int = 20, device="cuda") -> float:
    """ms per call of `fn`, device work only: on the card by CUDA events
    around n calls queued behind a spinning kernel (`torch.cuda._sleep`),
    so that the host issues every launch while the card spins and the
    events time the kernels back to back, not the host's issue. The spin
    is sized from the host's issue time of one call. The card holds only
    so many pending launches (about a thousand kernels on an H100): when
    the queue fills, the host waits for the spin and the first event has
    run before the last call is issued; n then halves, and at n = 1 the
    spin grows. With `device="cpu"`, and only when asked so, the host
    clock times n calls (the CPU's plain versions; not a device time).
    Raises RuntimeError on a machine without CUDA unless asked for the
    CPU, and when one call cannot be queued."""
    if torch.device(device).type != "cuda":
        fn()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) * 1e3 / n
    if not torch.cuda.is_available():
        raise RuntimeError("queued_ms times the card, and CUDA is not "
                           "available (device='cpu' times the host)")
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    issue_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    cycles = int(max(2e6 * 4 * issue_ms, 2e6))   # ~2e6 cycles a ms
    for _ in range(12):
        torch.cuda._sleep(cycles * n)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        queued = not a.query()
        torch.cuda.synchronize()
        if queued:
            return a.elapsed_time(b) / n
        if n > 1:
            n //= 2
        else:
            cycles *= 4
    raise RuntimeError("queued_ms: a call could not be queued behind the "
                       "spin")
