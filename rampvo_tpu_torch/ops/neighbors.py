"""Temporal-neighbour indices for patch tracks (port of
rampvo_tpu/ops/neighbors.py::neighbors; reference fastba ba.cpp:59-97)."""

from __future__ import annotations

import torch


def neighbors(kk, jj, valid=None):
    """(ix, jx): per edge, the index of the previous / next edge of the same
    patch track kk ordered by jj; -1 where none exists or the edge is
    invalid. Ties in jj keep the original order (stable sorts)."""
    E = kk.shape[0]
    kk = kk.long()
    jj = jj.long()
    if valid is None:
        valid = torch.ones(E, dtype=torch.bool, device=kk.device)

    # lexicographic stable sort by (invalid, kk, jj): stable sorts from the
    # least significant key up
    order = torch.argsort(jj, stable=True)
    order = order[torch.argsort(kk[order], stable=True)]
    order = order[torch.argsort((~valid[order]).int(), stable=True)]

    kk_s = kk[order]
    valid_s = valid[order]
    false = torch.zeros(1, dtype=torch.bool, device=kk.device)
    prev_same = torch.cat(
        [false, (kk_s[1:] == kk_s[:-1]) & valid_s[1:] & valid_s[:-1]])
    next_same = torch.cat([prev_same[1:], false])

    idx = torch.arange(E, device=kk.device)
    minus1 = torch.full_like(order, -1)
    prev_idx = torch.where(prev_same, order[torch.clamp(idx - 1, min=0)],
                           minus1)
    next_idx = torch.where(next_same, order[torch.clamp(idx + 1, max=E - 1)],
                           minus1)
    ix = torch.empty_like(order).scatter_(0, order, prev_idx)
    jx = torch.empty_like(order).scatter_(0, order, next_idx)
    return ix, jx
