"""VONet: MultiScale and SingleScale encoders, update operator, patch selection."""

from .vonet import VONet

__all__ = ["VONet"]
