"""VONet: MultiScale encoder, update operator, patch selection."""

from .vonet import VONet

__all__ = ["VONet"]
