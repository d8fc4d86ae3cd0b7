"""Data-parallel training and scene-sharded evaluation (port of
rampvo_tpu/parallel/mesh.py).

The JAX package shards a batch over a 1-D device mesh and lets XLA's
sharding propagation average the gradients. Here a mesh is a group of
processes under torch.distributed, one device each (`torchrun
--nproc_per_node N`, or a caller's `init_process_group`): each rank takes
its contiguous block of the batch (`shard_batch`), runs the forward and
backward of its samples, and the ranks average their gradients.

The gradient is that of the mean loss over the global batch, as the JAX
step's: each sample's backward starts from 1 / (global batch size), and
one all-reduce sums the ranks' gradients. Averaging per-rank means instead
would differ, not just by rounding: the update operator's `grad_clip`
(models/blocks.py) clamps the gradient flowing back, so a sample's
gradient is not linear in the factor its backward starts from. The loss
and the metrics ride in the same flat buffer (summed, then divided by the
world size).

An explicit all-reduce, not `DistributedDataParallel`: `TrainForward` is
not an `nn.Module` forward (DDP's hooks hang on a wrapped module's call),
each of a rank's samples runs its own backward to keep one sample's graph
alive at a time, and the global-norm clip must see the whole batch's
gradient, as optax clips the gradient that XLA has already summed. One
all-reduce after a rank's last backward gives exactly that.

Evaluation scenes are independent, so they are round-robined across
workers on the host (`eval_shard_scenes`, the fleet's `shard_scenes`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils.timing import span
from .eval_fleet import shard_scenes as eval_shard_scenes


@dataclass
class Mesh:
    """The ranks of one data-parallel run: this process's rank and device,
    and the process group (None for a one-member mesh without one)."""
    world_size: int
    rank: int
    device: torch.device
    group: Any = None
    axis: str = "batch"


def make_mesh(devices=None, axis: str = "batch") -> Mesh:
    """The mesh of this process. With an initialized process group: its
    world size and rank, and as device `devices[rank]` (a list), `devices`
    (one device) or, for None or "cuda" without an index, cuda:LOCAL_RANK.
    Without one: a one-member mesh on `devices` (default "cuda")."""
    if isinstance(devices, (list, tuple)):
        rank = dist.get_rank() if dist.is_initialized() else 0
        devices = devices[rank]
    if not dist.is_initialized():
        return Mesh(1, 0, resolve_device(devices or "cuda"), None, axis)
    dev = torch.device(devices or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(dist.get_world_size(), dist.get_rank(), dev,
                dist.group.WORLD, axis)


def shard_batch(mesh: Mesh, batch: Any):
    """This rank's contiguous block of the leading batch dimension of every
    array in `batch` (a dict, list or tuple of arrays or tensors), on the
    rank's device: the block NamedSharding(mesh, P("batch")) gives device
    `rank`. Raises unless the batch divides by the world size."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    x = batch if torch.is_tensor(batch) else torch.as_tensor(
        np.asarray(batch))
    B, n = x.shape[0], mesh.world_size
    if B % n:
        raise ValueError(f"batch of {B} does not divide over {n} ranks")
    return x[mesh.rank * (B // n):(mesh.rank + 1) * (B // n)].to(mesh.device)


def all_reduce_sum(mesh: Mesh, tensors: list) -> None:
    """Sum `tensors` over the mesh's ranks in place: one all-reduce of
    their flat concatenation."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    o = 0
    for t in tensors:
        t.copy_(flat[o:o + t.numel()].view_as(t))
        o += t.numel()


def assert_replicated(mesh: Mesh, params) -> None:
    """Raise unless every rank holds rank 0's parameters bit for bit."""
    if mesh.group is None:
        return
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=mesh.group)
    same = torch.tensor([float(torch.equal(ref, flat))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=mesh.group)
    if float(same) != 1.0:
        raise RuntimeError("the ranks start from different parameters")


BATCH_KEYS = ("events", "images", "poses", "disps", "intrinsics", "mask")


def make_train_step(fwd: Callable, trainer, mesh: Mesh | None = None,
                    structure_only: bool = False):
    """The data-parallel training step (rampvo_tpu/parallel/mesh.py::
    make_train_step with the port's `train/step.py::Trainer` as the
    optimizer).

    step(batch, draws=None, generator=None) -> (loss, metrics): `batch` a
    dict of the rank's samples (BATCH_KEYS, leading dimension B, on the
    device; poses world-to-camera), `draws` one `TrainForward` draws dict
    per sample (the JAX step's B keys split from one) or `generator` for
    all of them. Each sample's backward runs on its own, scaled by 1 /
    (B x world size); with a mesh the ranks' gradients are then summed and
    their losses and metrics averaged, before the trainer's global-norm
    clip and AdamW step. Returns the loss and the metrics (the mean over
    the global batch). Spans (`utils.timing.span`, with tracing on):
    `train.forward` and `train.backward` for each sample, `train.apply`
    around the trainer's step."""
    reduce = mesh is not None and mesh.group is not None
    ranks = mesh.world_size if reduce else 1

    def step(batch, draws=None, generator=None):
        B = int(batch["events"].shape[0])
        if draws is not None and len(draws) != B:
            raise ValueError(f"{len(draws)} draws for {B} samples")
        trainer.opt.zero_grad(set_to_none=False)
        loss, metrics = 0.0, {}
        for b in range(B):
            mask = batch["mask"][b]
            with span("train.forward"):
                lb, mb = fwd(*(batch[k][b] for k in BATCH_KEYS[:5]),
                             mask.cpu() if torch.is_tensor(mask) else mask,
                             structure_only=structure_only,
                             generator=generator,
                             draws=None if draws is None else draws[b])
            if lb.requires_grad:        # not under ablate "ba": no gradient
                with span("train.backward"):
                    (lb / (B * ranks)).backward()
            loss = loss + lb.detach() / B
            for k, v in mb.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() / B
        for p in trainer.params:        # a parameter no loss reached has
            if p.grad is None:          # optax's zero gradient
                p.grad = torch.zeros_like(p)
        if reduce:
            names = list(metrics)
            scalars = torch.stack([loss] + [metrics[k] for k in names])
            all_reduce_sum(mesh, [p.grad for p in trainer.params] + [scalars])
            scalars = scalars / ranks
            loss, metrics = scalars[0], dict(zip(names, scalars[1:]))
        with span("train.apply"):
            trainer.apply()
        return loss, metrics

    return step


__all__ = ["Mesh", "make_mesh", "shard_batch", "make_train_step",
           "eval_shard_scenes", "all_reduce_sum", "assert_replicated"]
