"""Training logger (port of rampvo_tpu/utils/logger.py; ref
ramp/logger.py:8-57): running means printed, and written to TensorBoard
when it is installed, every SUM_FREQ steps."""

from __future__ import annotations

SUM_FREQ = 100


class Logger:
    def __init__(self, name: str, log_dir: str = "runs"):
        self.total_steps = 0
        self.running = {}
        self.name = name
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:   # tensorboard is optional: stdout only
            self.writer = None
        else:
            self.writer = SummaryWriter(f"{log_dir}/{name}")

    def _print_and_reset(self):
        means = {k: v / SUM_FREQ for k, v in self.running.items()}
        print(f"[{self.name} step {self.total_steps}] " + " ".join(
            f"{k}={v:.5f}" for k, v in sorted(means.items())), flush=True)
        if self.writer is not None:
            for k, v in means.items():
                self.writer.add_scalar(k, v, self.total_steps)
        self.running = {}

    def push(self, metrics: dict):
        self.total_steps += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.total_steps % SUM_FREQ == SUM_FREQ - 1:
            self._print_and_reset()

    def write_dict(self, results: dict):
        if self.writer is not None:
            for k, v in results.items():
                self.writer.add_scalar(k, float(v), self.total_steps)

    def close(self):
        if self.writer is not None:
            self.writer.close()
