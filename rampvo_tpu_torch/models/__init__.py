"""Networks: the RAMP encoders, the update operator, VONet and their
blocks (port of rampvo_tpu/models)."""

from .blocks import (
    GatedResidual,
    LayerNorm1D,
    SoftAgg,
    SoftAggBasic,
    grad_clip,
    grad_zero,
)
from .encoders import (
    BasicEncoder4,
    ConvLSTMCell,
    LSTMEncoder,
    MultiScaleBasicEncoder4,
    MultiScaleEncoder,
    PixelLSTM,
    ResidualBlock,
    SingleScaleEncoder,
    SuperStateEncoder,
)
from .update import Update
from .vonet import CorrBlock, Patchifier, VONet

__all__ = [
    "GatedResidual",
    "LayerNorm1D",
    "SoftAgg",
    "SoftAggBasic",
    "grad_clip",
    "grad_zero",
    "ConvLSTMCell",
    "CorrBlock",
    "ResidualBlock",
    "BasicEncoder4",
    "MultiScaleBasicEncoder4",
    "PixelLSTM",
    "LSTMEncoder",
    "SuperStateEncoder",
    "SingleScaleEncoder",
    "MultiScaleEncoder",
    "Update",
    "VONet",
    "Patchifier",
]
