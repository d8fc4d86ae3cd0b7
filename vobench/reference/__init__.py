"""The benchmark's plain reference: a frozen copy of the plain PyTorch code
of the VO frame and the training step (networks, correlation, Lie groups,
projective geometry, bundle adjustment, the unrolled training forward, its
loss and the optimizer), with no kernel, no CUDA graph and nothing of the
measured package. Float32, or bfloat16 where the configuration states
mixed precision, as the configuration runs. It judges what the program
produced: it takes only the weights and inputs that the benchmark made,
and the program's state where it follows the program step by step.

Edits against the port's files are listed in each file's docstring; the
rest is as copied, so that its tests can hold it against the port on the
CPU bit for bit.
"""

import torch


def resolve_device(device) -> torch.device:
    return torch.device(device)
