"""Lattice correlation: the Hopper kernels K1 (csrc/corr_lattice.cu, port of
rampvo_tpu/ops/corr_pallas.py::corr_lattice_fused3) and K6
(csrc/corr_lattice_cb.cu, port of corr_lattice_fused4), and their plain
versions.

The function: for every edge of the [NI, T, M] lattice, the two-level
(1/4 and 1/16 resolution) correlation of its 3x3 patch features with exact
8x8 windows of the target frame's feature ring, blended to 7x7, in the
reference layout [E, 2*49*9] that corr_fc1 reads unpermuted (corr_stack).
Edges of dead cells are zero. Unlike the TPU kernel there is no SPREAD
clamp: every window is exact.

K6 computes the same function with work grouped per (target frame,
t-band) and bit-identical arithmetic. `corr_lattice` / `corr_lattice_cb`
launch their kernel for CUDA tensors and run `corr_lattice_ref` /
`corr_lattice_cb_ref` for CPU tensors; nothing falls back. The K4 and K5
wrappers (ops/corr_band_kernels.py, ops/corr_paired_kernels.py) share
`cell_tables`, `check_lattice_inputs` and `launch_lattice`.
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


def check_lattice_inputs(name: str, gmap_r, fmap1_r, fmap2_r, u, v, M: int,
                         tables=()):
    """Raise unless the inputs are what the lattice kernels take: 3x3
    patches of 128 channels, one float dtype (f32 or bf16) for gmap and
    both rings, float32 coords [.., M*9] per cell, int32 tables, every
    tensor contiguous, 16-byte aligned and on the card."""
    MEM, Mg, P, _, Cg = gmap_r.shape
    if not (Mg == M and P == 3 and Cg == fmap1_r.shape[3] == fmap2_r.shape[3]
            == C):
        raise ValueError(f"{name}: needs 3x3 patches of 128 channels")
    dt = gmap_r.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {dt}")
    if fmap1_r.dtype != dt or fmap2_r.dtype != dt:
        raise TypeError(f"{name}: gmap and fmap rings differ in dtype")
    for t in (gmap_r, fmap1_r, fmap2_r, u, v, *tables):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous CUDA")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    if u.dtype != torch.float32 or v.dtype != torch.float32 \
            or u.shape != v.shape or u.shape[-1] != M * P * P \
            or any(t.dtype != torch.int32 for t in tables):
        raise ValueError(f"{name}: coords/tables shape or dtype")


def launch_lattice(lib_name: str, fn: str, ncol: int, gmap_r, fmap1_r,
                   fmap2_r, u, v, cells, M: int):
    """Launch a warp-per-(edge, pixel) lattice kernel of csrc/<lib_name>.cu
    (K1's contract, `ncol` output columns per edge); returns [E, ncol] in
    the rings' dtype."""
    check_lattice_inputs(lib_name, gmap_r, fmap1_r, fmap2_r, u, v, M,
                         (cells,))
    _, H1, W1, _ = fmap1_r.shape
    _, H2, W2, _ = fmap2_r.shape
    E = cells.shape[0] * M
    if u.numel() != E * 9:
        raise ValueError(f"{lib_name}: coords do not match the cell table")
    dt = gmap_r.dtype
    out = torch.empty((E, ncol), dtype=dt, device=gmap_r.device)
    lib = build.load(lib_name, {fn: _SIG["corr_lattice_launch"]})
    err = getattr(lib, fn)(
        gmap_r.data_ptr(), fmap1_r.data_ptr(), fmap2_r.data_ptr(),
        u.data_ptr(), v.data_ptr(), cells.data_ptr(), out.data_ptr(),
        E, M, H1, W1, H2, W2, int(dt == torch.bfloat16),
        torch.cuda.current_stream(gmap_r.device).cuda_stream,
    )
    build.check(err, fn)
    return out


def corr_lattice_cuda(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int):
    """Launch the Hopper kernel (same contract as `corr_lattice_ref`)."""
    out = launch_lattice("corr_lattice", "corr_lattice_launch",
                         2 * (2 * RADIUS + 1) ** 2 * 9, gmap_r, fmap1_r,
                         fmap2_r, u, v, cells, M)
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


# ---------------------------------------------------------------------------
# K6: the same function, cells batched per (target frame, t-band)
# (port of rampvo_tpu/ops/corr_pallas.py::corr_lattice_fused4)
# ---------------------------------------------------------------------------

TB = 13    # lattice offsets t per group (the reference's TB4)
EB = 4     # patches per block of a group (csrc/corr_lattice_cb.cu; the
           # fastest bf16 choice of chip_smoke.py --k6-splits)


def cell_tables_a(NI: int, T: int, r: int, n: int, cell_valid, slotmap,
                  MEM: int, tb: int = TB):
    """Per-(target, t-band) tables of K6 (mirror of the reference's
    _cell_tables_a). Target a = 0..NTGT-1 is frame j = n - NTGT + a
    (NTGT = NI + r - 2); its live offsets are t in [tlo_a, thi_a] (host
    i = j - t + r - 1 in the last NI frames and >= 0), cut into bands of
    `tb`. Returns

      groups [NTGT*NTB, 6] int32: (a, band, target slot, NTGT if the group
        is empty, lo, hi), lo..hi relative to the band (lo = 1, hi = 0
        when empty); the slot of an empty group is its predecessor's;
      cells_a [NTGT*Tp, 2] int32 at a*Tp + band*tb + tc = g*tb + tc for
        group row g: (lattice cell row*T + t, or -1 - that when the cell
        is dead per `cell_vmask`; host gmap slot), Tp = NTB*tb;
      walked [NI*T] int32: 1 for every lattice cell some group walks.
    """
    dev = cell_valid.device
    NTGT = NI + r - 2
    NTB = -(-T // tb)
    Tp = NTB * tb
    L = slotmap.shape[0]
    a = torch.arange(NTGT, device=dev)
    j = n - NTGT + a
    tlo_a = (a - NI + 2).clamp(min=0)
    thi_a = (a + 1 + min(0, n - NI)).clamp(max=T - 1)
    a2 = a.repeat_interleave(NTB)
    j2 = j.repeat_interleave(NTB)
    band = torch.arange(NTB, device=dev).repeat(NTGT)
    lo = (tlo_a.repeat_interleave(NTB) - band * tb).clamp(0, tb)
    hi = (thi_a.repeat_interleave(NTB) - band * tb).clamp(-1, tb - 1)
    valid = (j2 >= 0) & (hi >= lo)
    slot = slotmap[j2.clamp(0, L - 1)].clamp(0, MEM - 1)
    NB = NTGT * NTB
    vidx = torch.where(valid, torch.arange(NB, device=dev),
                       torch.full_like(a2, -1))
    fill = torch.cummax(vidx, 0).values.clamp(min=0)
    fill = torch.maximum(fill, torch.argmax(valid.int()))
    slot = torch.where(valid, slot, slot[fill])
    one = torch.ones_like(a2)
    groups = torch.stack([
        torch.where(valid, a2, 0 * a2), torch.where(valid, band, 0 * band),
        slot, torch.where(valid, a2, NTGT * one),
        torch.where(valid, lo, one), torch.where(valid, hi, 0 * hi)], 1)

    tt = torch.arange(Tp, device=dev)[None, :]
    i_cell = j[:, None] - tt + (r - 1)                     # [NTGT, Tp]
    row = torch.remainder(i_cell, NI)
    t_c = tt.clamp(max=T - 1) + 0 * row
    c = row * T + t_c
    live = cell_vmask(NI, T, r, n, cell_valid)[row, t_c]
    gslot = slotmap[i_cell.clamp(0, L - 1)].clamp(0, MEM - 1)
    cells_a = torch.stack([torch.where(live, c, -1 - c), gslot], -1)

    tc = torch.arange(tb, device=dev)[None, :]
    walk = (tc >= groups[:, 4:5]) & (tc <= groups[:, 5:6])   # [NB, tb]
    at = (groups[:, 0:1] * Tp + groups[:, 1:2] * tb + tc)[walk]
    walked = torch.zeros(NI * T, dtype=torch.int32, device=dev)
    walked[c.reshape(-1)[at]] = 1
    return (groups.to(torch.int32).contiguous(),
            cells_a.reshape(NTGT * Tp, 2).to(torch.int32).contiguous(),
            walked)


def corr_lattice_cb_ref(gmap_r, fmap1_r, fmap2_r, u, v, tables, M: int):
    """Plain version of K6: walks `cell_tables_a` group by group, cell by
    cell, with `corr` + `corr_stack`; dead walked cells and unwalked cells
    zero. Returns [NC*M, 882] in the rings' dtype."""
    groups, cells_a, walked = tables
    MEM, _, P, _, _ = gmap_r.shape
    NC = walked.shape[0]
    E = NC * M
    tb = cells_a.shape[0] // groups.shape[0]
    dev = gmap_r.device
    gflat = gmap_r.reshape(MEM * M, P, P, C)
    ncol = 2 * (2 * RADIUS + 1) ** 2 * P * P
    out = torch.full((E, ncol), float("nan"), dtype=gmap_r.dtype, device=dev)
    out.reshape(NC, M, ncol)[walked == 0] = 0
    coords = torch.stack([u.reshape(E, P, P), v.reshape(E, P, P)], -1)
    m = torch.arange(M, device=dev)
    for g, (_, _, slot, _, lo, hi) in enumerate(groups.tolist()):
        for tc in range(lo, hi + 1):
            cenc, gslot = cells_a[g * tb + tc].tolist()
            e = (-1 - cenc if cenc < 0 else cenc) * M + m
            if cenc < 0:
                out[e] = 0
                continue
            gidx = gslot * M + m
            sj = torch.full_like(m, slot)
            c1 = corr(gflat, fmap1_r, coords[e], gidx, sj, RADIUS)
            c2 = corr(gflat, fmap2_r, coords[e] / 4.0, gidx, sj, RADIUS)
            out[e] = corr_stack(c1, c2).to(out.dtype)
    return out


_SIG_CB = {"corr_lattice_cb_launch": [ctypes.c_void_p] * 9
           + [ctypes.c_int] * 10 + [ctypes.c_void_p]}


def corr_lattice_cb_cuda(gmap_r, fmap1_r, fmap2_r, u, v, tables, M: int,
                         eb: int = EB):
    """Launch K6 (same contract as `corr_lattice_cb_ref`); `eb` patches
    per block."""
    groups, cells_a, walked = tables
    check_lattice_inputs("corr_lattice_cb", gmap_r, fmap1_r, fmap2_r, u, v,
                         M, tables)
    _, H1, W1, _ = fmap1_r.shape
    _, H2, W2, _ = fmap2_r.shape
    NB, NC = groups.shape[0], walked.shape[0]
    if u.numel() != NC * M * 9 or groups.shape[1:] != (6,) \
            or cells_a.shape[1:] != (2,) or cells_a.shape[0] % NB:
        raise ValueError("corr_lattice_cb: coords/tables do not match")
    dt = gmap_r.dtype
    out = torch.empty((NC * M, 2 * (2 * RADIUS + 1) ** 2 * 9), dtype=dt,
                      device=gmap_r.device)
    lib = build.load("corr_lattice_cb", _SIG_CB)
    err = lib.corr_lattice_cb_launch(
        gmap_r.data_ptr(), fmap1_r.data_ptr(), fmap2_r.data_ptr(),
        u.data_ptr(), v.data_ptr(), groups.data_ptr(), cells_a.data_ptr(),
        walked.data_ptr(), out.data_ptr(), NB, NC, eb, cells_a.shape[0] // NB,
        M, H1, W1, H2, W2, int(dt == torch.bfloat16),
        torch.cuda.current_stream(gmap_r.device).cuda_stream,
    )
    build.check(err, "corr_lattice_cb_launch")
    corr_lattice_cb.launches += 1
    return out


def corr_lattice_cb(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n: int,
                    slotmap, r: int, lat, tb: int = TB):
    """`corr_lattice`'s function and contract ([NI*T*M, 882], the
    reference layout) through K6's target-major decomposition
    (CORR_LAYOUT "fused4")."""
    NI, T, M = lat
    tables = cell_tables_a(NI, T, r, n, cell_valid, slotmap,
                           gmap_r.shape[0], tb)
    args = (gmap_r, fmap1_r, fmap2_r, u.contiguous(), v.contiguous(), tables,
            M)
    if gmap_r.is_cuda:
        return corr_lattice_cb_cuda(*args)
    return corr_lattice_cb_ref(*args)


corr_lattice_cb.launches = 0
