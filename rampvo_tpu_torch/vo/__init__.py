"""VO runtime: config, state, per-frame step and the RampVO driver."""

from .config import VOConfig
from .runtime import RampVO

__all__ = ["VOConfig", "RampVO"]
