"""The update's two-level lattice correlation, plain (frozen copy of the
plain version beside the port's K1 wrapper): for every edge of the
[NI, T, M] lattice, the correlation of its 3x3 patch features with exact
8x8 windows of the target frame's feature ring, blended to 7x7, in the
reference layout [E, 2*49*9]; edges of dead cells are zero."""

from __future__ import annotations

import torch

from .corr import corr, corr_stack


RADIUS = 3
C = 128
D = 2 * RADIUS + 2   # raw window side
CAP = 8              # largest span of an edge's 9 floors per axis that the
                     # kernels take as one box (csrc/corr_window.cuh,
                     # csrc/corr_train.cu)


def cell_vmask(NI: int, T: int, r: int, n, cell_valid):
    """[NI, T] cells the lattice correlation computes (mirror of the
    reference's _cell_vmask): live cell, host and target inside
    [0, n), target inside the last NI + r - 2 frames."""
    NTGT = NI + r - 2
    dev = cell_valid.device
    i_row = torch.arange(NI, device=dev)[:, None]
    tt = torch.arange(T, device=dev)[None, :]
    i_host = n - 1 - torch.remainder(n - 1 - i_row, NI) + 0 * tt
    j_tgt = i_host + tt - (r - 1)
    return (cell_valid & (i_host >= 0) & (j_tgt >= 0) & (j_tgt <= n - 1)
            & (j_tgt >= n - NTGT))


def cell_tables(NI: int, T: int, r: int, n, cell_valid, slotmap,
                MEM: int):
    """Per-cell [NI*T, 2] int32 (target feature slot, or -1 for a dead cell;
    host gmap slot), lattice order. Slots are clipped like the reference's
    _cell_tables."""
    dev = cell_valid.device
    L = slotmap.shape[0]
    i_row = torch.arange(NI, device=dev)[:, None]
    tt = torch.arange(T, device=dev)[None, :]
    i = n - 1 - torch.remainder(n - 1 - i_row, NI) + 0 * tt
    j = i + tt - (r - 1)
    slot_j = slotmap[j.clamp(0, L - 1)].clamp(0, MEM - 1)
    gslot = slotmap[i.clamp(0, L - 1)].clamp(0, MEM - 1)
    vm = cell_vmask(NI, T, r, n, cell_valid)
    slot_j = torch.where(vm, slot_j, torch.full_like(slot_j, -1))
    return torch.stack([slot_j, gslot], -1).reshape(NI * T, 2).to(
        torch.int32).contiguous()


def corr_lattice_ref(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int,
                     chunk: int = 4096):
    """Plain version: exact `corr` + `corr_stack` over the lattice edges,
    dead cells zeroed. gmap_r [MEM, M, P, P, C]; fmap rings
    [MEM, H, W, C] (level 1, level 2); u, v [NC, M*P*P] level-1 coords;
    cells from `cell_tables`. Returns [NC*M, 2*49*P*P] in the rings' dtype.
    Edges are processed `chunk` at a time to bound the gathered windows."""
    MEM, _, P, _, _ = gmap_r.shape
    NC = cells.shape[0]
    E = NC * M
    dev = gmap_r.device
    gflat = gmap_r.reshape(MEM * M, P, P, C)
    m = torch.arange(M, device=dev).repeat(NC)
    slot_j = cells[:, 0].long().repeat_interleave(M)
    gidx = cells[:, 1].long().repeat_interleave(M) * M + m
    coords = torch.stack([u.reshape(E, P, P), v.reshape(E, P, P)], -1)
    out = torch.empty((E, 2 * (2 * RADIUS + 1) ** 2 * P * P),
                      dtype=gmap_r.dtype, device=dev)
    for s in range(0, E, chunk):
        sl = slice(s, min(s + chunk, E))
        sj = slot_j[sl].clamp(min=0)
        c1 = corr(gflat, fmap1_r, coords[sl], gidx[sl], sj, RADIUS)
        c2 = corr(gflat, fmap2_r, coords[sl] / 4.0, gidx[sl], sj, RADIUS)
        st = corr_stack(c1, c2)
        dead = (slot_j[sl] < 0)[:, None]
        out[sl] = torch.where(dead, torch.zeros_like(st), st).to(out.dtype)
    return out


def corr_lattice(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n, slotmap,
                 r: int, lat):
    """[NI*T*M, 882] correlation of every lattice edge (`corr_lattice_ref`
    over `cell_tables`), in the rings' dtype."""
    NI, T, M = lat
    cells = cell_tables(NI, T, r, n, cell_valid, slotmap, gmap_r.shape[0])
    return corr_lattice_ref(gmap_r, fmap1_r, fmap2_r, u, v, cells, M)
