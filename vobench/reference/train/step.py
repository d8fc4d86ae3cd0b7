"""The optimizer and one training step (port of
rampvo_tpu/cli/train.py::make_optimizer and
rampvo_tpu/parallel/mesh.py::make_train_step on one device).

AdamW behind global-norm clipping, with optax's linear one-cycle learning
rate, written in optax's formulas: the clip scales the gradients by
max_norm / norm only when norm >= max_norm (clip_grad_norm_ would add 1e-6
to the norm and scale always), and step k (from 0) uses schedule(k).
"""

from __future__ import annotations

import numpy as np
import torch


def onecycle_lr(step: int, total: int, peak: float, pct_start: float = 0.01,
                pct_final: float = 1.0, div_factor: float = 25.0,
                final_div_factor: float = 1e4) -> float:
    """optax.linear_onecycle_schedule(total, peak, pct_start, pct_final,
    div_factor, final_div_factor) at `step`, by optax's construction: a
    {boundary: scale} dict (with pct_final = 1 the middle boundary is the
    last one and its scale is overwritten), values = running products
    from peak / div_factor, linear in between. One deviation: optax
    divides by an empty first phase when int(pct_start * total) == 0
    (total < 100 at pct_start 0.01) and returns NaN at every step; here the
    empty phase is skipped."""
    scales = {int(pct_start * total): div_factor,
              int(pct_final * total): 1.0 / div_factor,
              total: 1.0 / final_div_factor}
    bounds = [0] + sorted(scales)
    values = np.cumprod([peak / div_factor] + [scales[b] for b in bounds[1:]])
    if step >= bounds[-1]:
        return float(values[-1])
    for i in range(len(bounds) - 1):
        if bounds[i] <= step < bounds[i + 1]:
            pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
            return float(values[i] + pct * (values[i + 1] - values[i]))
    return float(values[-1])


def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm on the .grad of `params`, in place; a
    missing gradient counts as zero. Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Trainer:
    """AdamW + one-cycle + global-norm clip over a network's parameters
    (the reference recipe: lr, steps, clip, weight_decay, pct_start of a
    config's train args). `step(loss_fn)` runs one optimizer step;
    `apply()` runs one on the gradients already in .grad. `schedule`
    (count -> rate) replaces the one-cycle rate, as a flat
    `optax.adamw(lr)` does."""

    def __init__(self, net: torch.nn.Module, train_cfg: dict, schedule=None):
        self.net = net
        self.schedule = schedule
        self.params = [p for p in net.parameters() if p.requires_grad]
        self.total = int(train_cfg["steps"])
        self.peak = float(train_cfg["lr"])
        self.pct_start = float(train_cfg.get("pct_start", 0.01))
        self.clip = float(train_cfg["clip"])
        self.opt = torch.optim.AdamW(
            self.params, lr=self.lr(0), betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(train_cfg["weight_decay"]))
        self.count = 0

    def lr(self, count: int) -> float:
        if self.schedule is not None:
            return float(self.schedule(count))
        return onecycle_lr(count, self.total, self.peak, self.pct_start)

    def step(self, loss_fn):
        """loss_fn() -> (loss, metrics) with autograd; backward, clip,
        AdamW at this step's learning rate. Returns (loss, metrics,
        gradient norm before clipping)."""
        self.opt.zero_grad(set_to_none=False)
        loss, metrics = loss_fn()
        loss.backward()
        gnorm = self.apply()
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            gnorm

    def apply(self) -> torch.Tensor:
        """Clip the gradients in .grad, then one AdamW step at this step's
        learning rate. Returns the norm before clipping."""
        gnorm = clip_by_global_norm(self.params, self.clip)
        for g in self.opt.param_groups:
            g["lr"] = self.lr(self.count)
        self.opt.step()
        self.count += 1
        return gnorm

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict):
        self.opt.load_state_dict(sd["opt"])
        self.count = int(sd["count"])
