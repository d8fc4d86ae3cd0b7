"""Temporal-neighbour indices for patch tracks (port of
rampvo_tpu/ops/neighbors.py: `neighbors` over a flat edge list, reference
fastba ba.cpp:59-97, and `lattice_neighbors` over the edge lattice)."""

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


def lattice_neighbors(cell_valid, NI: int, T: int, M: int):
    """`neighbors` over the edge lattice [NI, T, M] by index arithmetic
    (port of rampvo_tpu/ops/neighbors.py::lattice_neighbors). A patch
    track is one lattice row (host, m) with its edges in t order, so the
    previous / next edge of cell (row, t) is the nearest valid cell at
    t' < t / t' > t in the same row: two [NI, T] running scans.

    cell_valid [NI, T] bool. Returns (ix, jx) flat [NI*T*M] int32, -1 where
    no neighbour exists."""
    dev = cell_valid.device
    t = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    # previous valid t: exclusive running max of t where valid
    prev_in = torch.cummax(torch.where(cell_valid, t, -1), dim=1).values
    prev_t = torch.cat([torch.full((NI, 1), -1, dtype=torch.int32,
                                   device=dev), prev_in[:, :-1]], dim=1)
    # next valid t: exclusive running min of t where valid, from the right
    tw = torch.where(cell_valid, t, T).flip(1)
    next_in = torch.cummin(tw, dim=1).values.flip(1)
    next_t = torch.cat([next_in[:, 1:], torch.full((NI, 1), T,
                                                   dtype=torch.int32,
                                                   device=dev)], dim=1)
    row = torch.arange(NI, dtype=torch.int32, device=dev)[:, None, None]
    m = torch.arange(M, dtype=torch.int32, device=dev)[None, None, :]

    def flat(tsel, ok):
        e = (row * T + tsel[:, :, None]) * M + m
        return torch.where(ok[:, :, None], e, -1).reshape(-1).to(torch.int32)

    return flat(prev_t, prev_t >= 0), flat(next_t, next_t < T)
