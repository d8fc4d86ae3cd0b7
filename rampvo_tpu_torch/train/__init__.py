"""Training (port of rampvo_tpu/train): the unrolled forward, its losses
and the optimizer step."""
