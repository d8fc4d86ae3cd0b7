"""Network building blocks (port of rampvo_tpu/models/blocks.py; ref
ramp/blocks.py). Submodule names follow the reference state_dict keys."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.scatter import compact_ids, segment_softmax, segment_sum


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = torch.where(torch.isnan(g), torch.zeros_like(g), g)
        return g.clamp(-0.01, 0.01)


def grad_clip(x):
    """Identity whose backward zeroes NaN gradients and clamps the rest to
    +-0.01 (ref blocks.py:76-91)."""
    return _GradClip.apply(x)


class _GradZero(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        drop = torch.isnan(g) | (g.abs() > 0.1)
        return torch.where(drop, torch.zeros_like(g), g)


def grad_zero(x):
    """Identity whose backward zeroes NaN gradients and those above 0.1 in
    magnitude (ref blocks.py:93-109)."""
    return _GradZero.apply(x)


class GradClip(nn.Module):
    """`grad_clip` as a module (the reference's GradientClip, which has no
    parameters)."""

    def forward(self, x):
        return grad_clip(x)


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

    def forward(self, x, ix, valid=None, lattice=None, axis=None,
                precompacted: bool = False):
        """`precompacted`: ix already holds dense ranks (a static edge
        schedule's ids, compacted once)."""
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

        jx = ix.long() if precompacted else compact_ids(ix)
        w = segment_softmax(self.g(x), jx, E, valid=valid)
        y = segment_sum(self.f(x) * w, jx, E, valid=valid)
        return self.h(y)[jx]


class SoftAggBasic(nn.Module):
    """SoftAgg with a scalar attention logit per row (ref blocks.py:52-69):
    x [E, D], ix [E] group ids, `valid` as SoftAgg's."""

    def __init__(self, dim: int):
        super().__init__()
        self.f = nn.Linear(dim, dim)
        self.g = nn.Linear(dim, 1)
        self.h = nn.Linear(dim, dim)

    def forward(self, x, ix, valid=None):
        E = x.shape[0]
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
