"""Global seeding (port of rampvo_tpu/utils/seeding.py; ref
utils/seed_everything.py:5-12)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int = 1234) -> torch.Generator:
    """Seed Python's `random`, numpy and torch (CPU and every CUDA device)
    and return a torch.Generator seeded with `seed`, where the JAX
    package returns a PRNG key, for explicit draws."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)           # also seeds every CUDA device
    return torch.Generator().manual_seed(seed)
