"""Section timing (port of rampvo_tpu/utils/timing.py; ref
ramp/utils.py:22-44, the reference's CUDA-event Timer).

A section is timed on the card by default: by CUDA events recorded on the
current stream (the device time between them, read after a synchronize at
the section's end). With `device="cpu"`, and only when asked so, it is
timed by the host clock. A
`torch.profiler.record_function` span opens with the section, so it
appears in profiler traces, where the JAX package opens a
`jax.profiler.TraceAnnotation`.

`queued_ms` times a call's device work alone, without the host's issue.
"""

from __future__ import annotations

import time

import torch


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
            self._span = torch.profiler.record_function(self.name)
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
