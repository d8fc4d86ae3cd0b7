"""SE3/SO3/RxSO3/Sim3 Lie groups on torch tensors (port of
rampvo_tpu/lie)."""

from . import ops
from .groups import SE3, SO3, RxSO3, Sim3, stack
from .quaternion import (
    quat_act,
    quat_exp,
    quat_inv,
    quat_log,
    quat_mul,
    quat_normalize,
    quat_to_matrix,
)

__all__ = [
    "SE3", "SO3", "RxSO3", "Sim3", "stack", "ops",
    "quat_act", "quat_exp", "quat_inv", "quat_log", "quat_mul",
    "quat_normalize", "quat_to_matrix",
]
