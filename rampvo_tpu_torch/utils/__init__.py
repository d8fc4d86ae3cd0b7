"""Trajectory metrics, timing, seeding and host utilities (port of
rampvo_tpu/utils)."""

from .logger import Logger
from .metrics import (
    associate_trajectories,
    ate_rmse,
    interpolate_poses,
    rot_error_per_axis,
    umeyama_alignment,
)
from .seeding import seed_everything
from .timing import Timer

__all__ = [
    "umeyama_alignment",
    "ate_rmse",
    "rot_error_per_axis",
    "associate_trajectories",
    "interpolate_poses",
    "Timer",
    "Logger",
    "seed_everything",
]
