"""Bundle adjustment: `ba_infer` (Gauss-Newton over the edge lattice or a
flat edge list) and the differentiable `ba_train`, on one linearization
(port of rampvo_tpu/ba)."""

from .core import ba_infer, ba_train, linearize_center

__all__ = ["ba_train", "ba_infer", "linearize_center"]
