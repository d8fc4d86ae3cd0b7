"""Random network weights, made on the device from the run's seed.

The distribution is the port's `init_weights` (convolutions and linears
normal with variance 1/fan_in, 2/fan_out for 3x3 and larger convolutions;
LSTMs uniform(+-1/sqrt(hidden)); norms at identity; biases zero), drawn in
two large calls from one generator on the card instead of leaf by leaf.
The same state dict is loaded into the program's network and into the
reference's, so neither takes anything the other made.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


def _std(mod) -> float:
    w = mod.weight
    if isinstance(mod, nn.Conv2d) and w.shape[-1] > 1:
        return math.sqrt(2.0 / (w.shape[0] * w.shape[2] * w.shape[3]))
    return math.sqrt(1.0 / w[0].numel())


def make_weights(net: nn.Module, seed: int, device) -> dict:
    """{parameter name: tensor} for every parameter of `net` (a module of
    any device, meta included: only its structure is read), float32 on
    `device`, drawn from a generator on `device` seeded with `seed`."""
    normal, uniform, out = [], [], {}
    for mname, mod in sorted(net.named_modules()):
        prefix = mname + "." if mname else ""
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            normal.append((prefix + "weight", mod.weight.shape, _std(mod)))
            if mod.bias is not None:
                out[prefix + "bias"] = torch.zeros(mod.bias.shape,
                                                   device=device)
        elif isinstance(mod, nn.LSTM):
            k = 1.0 / math.sqrt(mod.hidden_size)
            for pname, p in mod.named_parameters(recurse=False):
                uniform.append((prefix + pname, p.shape, k))
        elif isinstance(mod, nn.LayerNorm):
            out[prefix + "weight"] = torch.ones(mod.weight.shape,
                                                device=device)
            out[prefix + "bias"] = torch.zeros(mod.bias.shape, device=device)
    g = torch.Generator(device=device).manual_seed(int(seed))
    for leaves, draw in ((normal, torch.randn), (uniform, torch.rand)):
        n = sum(math.prod(s) for _, s, _ in leaves)
        flat = draw(n, generator=g, device=device)
        if draw is torch.rand:
            flat = flat * 2 - 1
        at = 0
        for name, shape, scale in leaves:
            k = math.prod(shape)
            out[name] = flat[at:at + k].reshape(shape) * scale
            at += k
    names = {n for n, _ in net.named_parameters()}
    if set(out) != names:
        raise ValueError("weights: parameters of no known kind: "
                         f"{sorted(names - set(out))}")
    return out
