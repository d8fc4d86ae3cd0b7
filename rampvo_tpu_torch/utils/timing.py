"""Section timing (port of rampvo_tpu/utils/timing.py; ref
ramp/utils.py:22-44, the reference's CUDA-event Timer).

A section is timed on the card by default: by CUDA events recorded on the
current stream (the device time between them, read after a synchronize at
the section's end). With `device="cpu"`, and only when asked so, it is
timed by the host clock. A
`torch.profiler.record_function` span opens with the section, so it
appears in profiler traces, where the JAX package opens a
`jax.profiler.TraceAnnotation`.
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
