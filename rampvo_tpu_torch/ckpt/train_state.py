"""Training checkpoints (the port's counterpart of
rampvo_tpu/ckpt/orbax_io.py): `torch.save` of {"params": the VONet
state_dict, "opt": the optimizer state, "step"} as
checkpoints/<name>/step_<N>.pth, newest found by step number."""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"step_(\d+)\.pth$")


def save_checkpoint(ckpt_dir: str, step: int, params: dict, opt: dict) -> str:
    """Write step `step`'s checkpoint (tensors moved to the CPU); returns
    its path. The file appears atomically."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}.pth")
    tmp = path + ".tmp"
    torch.save({"params": {k: v.detach().cpu() for k, v in params.items()},
                "opt": opt, "step": int(step)}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str):
    """Path of the highest-step checkpoint in `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [(int(m.group(1)), f) for f in os.listdir(ckpt_dir)
             if (m := _NAME.search(f))]
    return os.path.join(ckpt_dir, max(steps)[1]) if steps else None


def restore_checkpoint(path: str) -> dict:
    """A checkpoint file, or the newest one of a checkpoint directory, as
    {"params", "opt", "step"} on the CPU. A .pth file of another format
    (a reference state_dict) comes back as it was saved; callers tell the
    two apart by the "params" key."""
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = found
    # tensors, containers and numbers only: no code runs on load
    return torch.load(path, map_location="cpu", weights_only=True)
