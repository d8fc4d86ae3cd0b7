"""VO runtime: config, state, per-frame step and the RampVO driver."""

from .config import VOConfig
from .graph import make_vo_frames_chunk
from .runtime import (
    RampVO,
    make_encode_only,
    make_final_updates,
    make_vo_frame,
)
from .state import VOState, init_state

__all__ = [
    "VOConfig",
    "VOState",
    "init_state",
    "RampVO",
    "make_vo_frame",
    "make_vo_frames_chunk",
    "make_encode_only",
    "make_final_updates",
]
