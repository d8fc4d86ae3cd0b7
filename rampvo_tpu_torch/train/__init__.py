"""Training (port of rampvo_tpu/train): the unrolled forward, its losses
and the optimizer step."""

from .forward import TrainForward, edge_schedule
from .loss import kabsch_umeyama_scale, pose_loss_terms

__all__ = ["TrainForward", "edge_schedule", "kabsch_umeyama_scale",
           "pose_loss_terms"]
