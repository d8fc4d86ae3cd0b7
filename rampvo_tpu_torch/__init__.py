"""PyTorch / CUDA port of rampvo_tpu for NVIDIA Hopper (sm_90a).

The JAX package `rampvo_tpu` is the reference this package is held
against. This package imports neither JAX nor anything of `rampvo_tpu`.
Its tree mirrors the reference (vo/, lie/, geometry/, models/, ops/, ba/,
ckpt/, data/, utils/, cli/); the three Pallas kernels of the inference
paths have hand-written CUDA counterparts under csrc/
(ops/corr_kernels.py, ops/encoder_kernels.py for MultiScale,
ops/singlescale_kernels.py for SingleScale).

Entry points (`python -m rampvo_tpu_torch.cli.evaluate`, `vo.RampVO`,
`vo.runtime.make_vo_frame`, `vo.state.init_state`) run on the card by
default and on the CPU only when asked (`device="cpu"`, `--device cpu`).
"""

import torch


def resolve_device(device) -> torch.device:
    """torch.device for an entry point; raises when CUDA is asked for and
    missing (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rampvo_tpu_torch: device 'cuda' requested but CUDA is not "
            "available; pass device='cpu' to run the plain versions"
        )
    return dev
