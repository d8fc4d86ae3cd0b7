"""Lattice correlation: the Hopper kernel (csrc/corr_lattice.cu) and its
plain version. Port of rampvo_tpu/ops/corr_pallas.py::corr_lattice_fused3.

The function: for every edge of the [NI, T, M] lattice, the two-level
(1/4 and 1/16 resolution) correlation of its 3x3 patch features with exact
8x8 windows of the target frame's feature ring, blended to 7x7, in the
reference layout [E, 2*49*9] that corr_fc1 reads unpermuted (corr_stack).
Edges of dead cells are zero. Unlike the TPU kernel there is no SPREAD
clamp: every window is exact.

`corr_lattice` launches the kernel for CUDA tensors and runs
`corr_lattice_ref` for CPU tensors; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .corr import corr, corr_stack

RADIUS = 3
C = 128


def cell_vmask(NI: int, T: int, r: int, n: int, cell_valid):
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


def cell_tables(NI: int, T: int, r: int, n: int, cell_valid, slotmap,
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


_SIG = {"corr_lattice_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_void_p]}


def corr_lattice_cuda(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int):
    """Launch the Hopper kernel (same contract as `corr_lattice_ref`)."""
    MEM, Mg, P, _, Cg = gmap_r.shape
    _, H1, W1, C1 = fmap1_r.shape
    _, H2, W2, C2 = fmap2_r.shape
    NC = cells.shape[0]
    E = NC * M
    dt = gmap_r.dtype
    if not (Mg == M and P == 3 and Cg == C1 == C2 == C):
        raise ValueError("corr_lattice: needs 3x3 patches of 128 channels")
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"corr_lattice: unsupported dtype {dt}")
    for t in (gmap_r, fmap1_r, fmap2_r, u, v, cells):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("corr_lattice: inputs must be contiguous CUDA")
        if t.data_ptr() % 16:
            raise ValueError("corr_lattice: inputs must be 16-byte aligned")
    if fmap1_r.dtype != dt or fmap2_r.dtype != dt:
        raise TypeError("corr_lattice: gmap and fmap rings differ in dtype")
    if u.dtype != torch.float32 or v.dtype != torch.float32 \
            or u.numel() != E * P * P or v.numel() != E * P * P \
            or cells.dtype != torch.int32:
        raise ValueError("corr_lattice: coords/cells shape or dtype")
    out = torch.empty((E, 2 * (2 * RADIUS + 1) ** 2 * P * P), dtype=dt,
                      device=gmap_r.device)
    lib = build.load("corr_lattice", _SIG)
    err = lib.corr_lattice_launch(
        gmap_r.data_ptr(), fmap1_r.data_ptr(), fmap2_r.data_ptr(),
        u.data_ptr(), v.data_ptr(), cells.data_ptr(), out.data_ptr(),
        E, M, H1, W1, H2, W2, int(dt == torch.bfloat16),
        torch.cuda.current_stream(gmap_r.device).cuda_stream,
    )
    build.check(err, "corr_lattice_launch")
    corr_lattice.launches += 1
    return out


def corr_lattice(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n: int,
                 slotmap, r: int, lat):
    """Two-level lattice correlation for the VO update.

    gmap_r [MEM, M, 3, 3, 128]; fmap1_r [MEM, H, W, 128] and fmap2_r
    [MEM, H/4, W/4, 128] (the 1/4-res frame features and their 4x pool);
    u, v [NI*T, M*9] level-1 reprojected patch pixels; cell_valid [NI, T];
    n live keyframes; slotmap [L]; r = PATCH_LIFETIME; lat = (NI, T, M).
    Returns [NI*T*M, 882] in the rings' dtype."""
    NI, T, M = lat
    cells = cell_tables(NI, T, r, n, cell_valid, slotmap, gmap_r.shape[0])
    args = (gmap_r, fmap1_r, fmap2_r, u.contiguous(), v.contiguous(), cells, M)
    if gmap_r.is_cuda:
        return corr_lattice_cuda(*args)
    return corr_lattice_ref(*args)


corr_lattice.launches = 0
