"""Network building blocks (port of rampvo_tpu/models/blocks.py; ref
ramp/blocks.py). Submodule names follow the reference state_dict keys.
The reference's GradientClip is an identity in the forward pass and the
port runs inference only, so it becomes nn.Identity."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.scatter import compact_ids, segment_softmax, segment_sum


class GatedResidual(nn.Module):
    """x + sigmoid(W_g x) * MLP(x)  (ref blocks.py:15-31)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gate = nn.Sequential(nn.Linear(dim, dim), nn.Sigmoid())
        self.res = nn.Sequential(nn.Linear(dim, dim), nn.ReLU(),
                                 nn.Linear(dim, dim))

    def forward(self, x):
        return x + self.gate(x) * self.res(x)


class SoftAgg(nn.Module):
    """Softmax attention-pooling over index groups (ref blocks.py:33-50).

    x [E, D], ix [E] group ids. `valid` masks fixed-capacity padding rows:
    they contribute nothing and their own output is garbage. With
    `lattice=(NI, T, M)` the groups are whole lattice axes (`axis` 1 = patch
    track, 2 = frame pair) and the pooling is a masked axis reduction."""

    def __init__(self, dim: int):
        super().__init__()
        self.f = nn.Linear(dim, dim)
        self.g = nn.Linear(dim, dim)
        self.h = nn.Linear(dim, dim)

    def forward(self, x, ix, valid=None, lattice=None, axis=None):
        E, D = x.shape
        if lattice is not None:
            NI, T, M = lattice
            xl = x.reshape(NI, T, M, D)
            vl = (torch.ones((NI, T, M, 1), dtype=torch.bool, device=x.device)
                  if valid is None else valid.reshape(NI, T, M, 1))
            gx = self.g(xl)
            mx = torch.where(vl, gx, torch.full_like(gx, float("-inf")))
            mx = mx.amax(dim=axis, keepdim=True)
            mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
            ex = torch.where(vl, torch.exp(gx - mx), torch.zeros_like(gx))
            denom = torch.clamp(ex.sum(dim=axis, keepdim=True), min=1e-20)
            y = (self.f(xl) * (ex / denom)).sum(dim=axis, keepdim=True)
            return self.h(y).expand(NI, T, M, D).reshape(E, D)

        jx = compact_ids(ix)
        w = segment_softmax(self.g(x), jx, E, valid=valid)
        y = segment_sum(self.f(x) * w, jx, E, valid=valid)
        return self.h(y)[jx]


class LayerNorm1D(nn.Module):
    """LayerNorm over the channel dim of [B, C, L] inputs (ref
    blocks.py:7-13)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-4)

    def forward(self, x):
        return self.norm(x.transpose(-1, -2)).transpose(-1, -2)
