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

K6 computes the same function over the edges its walk tables reach (per
(target frame, t-band) group), binned by target tile on the card with
each bin's taps staged in shared memory (ops/corr_bins.py), with
bit-identical arithmetic. `corr_lattice` / `corr_lattice_cb`
launch their kernel for CUDA tensors and run `corr_lattice_ref` /
`corr_lattice_cb_ref` for CPU tensors; nothing falls back. The K4 and K5
wrappers (ops/corr_band_kernels.py, ops/corr_paired_kernels.py) share
`cell_tables`, `check_lattice_inputs` and `launch_lattice`.

The kernels read each edge's windows as one box per level (the union of
its 9 pixels' 8x8 windows, csrc/corr_window.cuh). `window_boxes`,
`box_passes`, `box_taps` and `corr_lattice_box_ref` mirror that index
arithmetic (box origin, per-pixel offsets, the cap and its per-pixel slow
path, borders) in plain PyTorch (`box_corr` is the forward that K1 and the
training forward K7 share); the tests and chip_smoke.py hold them against
`corr_lattice_ref`. No wrapper calls them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .corr import _gather_2d, corr, corr_stack

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


# ---------------------------------------------------------------------------
# plain mirror of the kernels' box decomposition
# ---------------------------------------------------------------------------

class Boxes(NamedTuple):
    """One level's window boxes of E edges (`window_boxes`)."""
    x0: torch.Tensor      # [E, 9] floor of each pixel's x (clamped, int64)
    y0: torch.Tensor
    bx: torch.Tensor      # [E] map coords of the box's first tap
    by: torch.Tensor
    bw: torch.Tensor      # [E] box size in taps (8 where not `fits`)
    bh: torch.Tensor
    fits: torch.Tensor    # [E] both spans <= cap: the edge is read as one box
    ox: torch.Tensor      # [E, 9] each pixel's window offset inside the box
    oy: torch.Tensor
    inside: torch.Tensor  # [E] the box meets the map


def floor_index(x):
    """floor(x) as int64 the way the kernels convert it: clamped to +-1e6
    before the conversion, NaN as -1e6 (fmaxf drops it), so far and
    non-finite coords land outside every map."""
    f = torch.nan_to_num(torch.floor(x.float()), nan=-1e6, posinf=1e6,
                         neginf=-1e6)
    return f.clamp(-1e6, 1e6).long()


def window_boxes(u, v, H: int, W: int, cap: int = CAP) -> Boxes:
    """The box of each edge at one level: u, v [E, 9] that level's coords of
    the 9 patch pixels, H, W the level's map size. The union of the 8x8
    windows at floor(u, v) - 3 is a box of (8 + span_x) x (8 + span_y)
    taps; an edge whose span exceeds `cap` on an axis does not fit and is
    read pixel by pixel (8x8 boxes at offset 0)."""
    x0, y0 = floor_index(u), floor_index(v)
    xlo, xhi = x0.min(1).values, x0.max(1).values
    ylo, yhi = y0.min(1).values, y0.max(1).values
    fits = (xhi - xlo <= cap) & (yhi - ylo <= cap)
    bw = torch.where(fits, xhi - xlo + D, torch.full_like(xlo, D))
    bh = torch.where(fits, yhi - ylo + D, torch.full_like(ylo, D))
    bx, by = xlo - RADIUS, ylo - RADIUS
    zero = torch.zeros_like(x0)
    ox = torch.where(fits[:, None], x0 - xlo[:, None], zero)
    oy = torch.where(fits[:, None], y0 - ylo[:, None], zero)
    inside = fits & (bx < W) & (bx + bw > 0) & (by < H) & (by + bh > 0)
    return Boxes(x0, y0, bx, by, bw, bh, fits, ox, oy, inside)


def box_passes(b: Boxes, cap: int = CAP):
    """The kernels' passes over the edges of `b`, as (edge index [n],
    pixels (a list of q), bx, by, bw, bh [n], ox, oy [n, len(pixels)], box
    side): one pass reads every fitting edge as one box with all 9 pixels;
    the edges that do not fit take 9 more, pass q reading pixel q's own
    8x8 window as the box."""
    idx = torch.nonzero(b.fits)[:, 0]
    if idx.numel():
        yield (idx, list(range(9)), b.bx[idx], b.by[idx], b.bw[idx],
               b.bh[idx], b.ox[idx], b.oy[idx], D + cap)
    idx = torch.nonzero(~b.fits)[:, 0]
    if idx.numel():
        eight = torch.full_like(idx, D)
        zero = torch.zeros_like(idx)[:, None]
        for q in range(9):
            yield (idx, [q], b.x0[idx, q] - RADIUS, b.y0[idx, q] - RADIUS,
                   eight, eight, zero, zero, D)


def box_taps(fmap, slot, bx, by, bw, bh, side: int):
    """The taps of n boxes in the kernels' order: tap t = ty * bw + tx for
    t < bw * bh, the rest of the side * side slots empty. Returns (features
    [n, side*side, C] float32, zero for taps outside the map or the box;
    linear index [n, side*side] into fmap's [N*H*W] rows; in-map mask)."""
    N, H, W, _ = fmap.shape
    t = torch.arange(side * side, device=fmap.device)[None]
    ty = t // bw[:, None]
    tx = t - ty * bw[:, None]
    y, x = by[:, None] + ty, bx[:, None] + tx
    inb = (ty < bh[:, None]) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
    lin = (slot[:, None] * H + y.clamp(0, H - 1)) * W + x.clamp(0, W - 1)
    f = fmap.reshape(N * H * W, -1)[lin].float()
    return torch.where(inb[..., None], f, torch.zeros_like(f)), lin, inb


def window_pick(ox, oy, bw):
    """[n, Q, 8, 8] tap index of each pixel's window (dy, dx) inside its
    box: (oy + dy) * bw + ox + dx."""
    dd = torch.arange(D, device=bw.device)
    return ((oy[..., None, None] + dd[:, None]) * bw[:, None, None, None]
            + ox[..., None, None] + dd[None, :])


def box_corr(g, fmap1, fmap2, slot, x1, y1, cap: int = CAP,
             chunk: int = 1024):
    """The kernels' forward box decomposition over E edges: per level, the
    dots of the 9 pixel features against the edge's whole box, each
    pixel's 8x8 window picked out of the box by its offset, then the
    blend. g [E, 9, C] float32 patch features; slot [E] index into both
    maps; x1, y1 [E, 9] level-1 coords. Returns (out [E, 882] float32 in
    the reference layout, edges that did not fit at either level)."""
    E = g.shape[0]
    dev = g.device
    levels, slow = [], torch.zeros(E, dtype=torch.bool, device=dev)
    for fmap, x, y in ((fmap1, x1, y1), (fmap2, x1 * 0.25, y1 * 0.25)):
        b = window_boxes(x, y, fmap.shape[1], fmap.shape[2], cap)
        slow |= ~b.fits
        raw = torch.zeros((E, 9, D, D), dtype=torch.float32, device=dev)
        for idx, qs, bx, by, bw, bh, ox, oy, side in box_passes(b, cap):
            for s in range(0, idx.numel(), chunk):
                c = slice(s, s + chunk)
                f, _, _ = box_taps(fmap, slot[idx[c]], bx[c], by[c], bw[c],
                                   bh[c], side)
                dots = torch.einsum("nqc,ntc->nqt", g[idx[c]][:, qs], f)
                pick = window_pick(ox[c], oy[c], bw[c])
                raw[idx[c][:, None], torch.tensor(qs, device=dev)[None]] = \
                    torch.gather(dots, 2, pick.flatten(2)).reshape(
                        -1, len(qs), D, D)
        fx = (x - torch.floor(x))[..., None, None]
        fy = (y - torch.floor(y))[..., None, None]
        d = D - 1
        out = ((1 - fy) * (1 - fx) * raw[..., :d, :d]
               + (1 - fy) * fx * raw[..., :d, 1:]
               + fy * (1 - fx) * raw[..., 1:, :d]
               + fy * fx * raw[..., 1:, 1:])
        levels.append(out.transpose(-1, -2).reshape(E, 3, 3, d * d))
    return corr_stack(*levels), slow


def corr_lattice_box_ref(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int,
                         cap: int = CAP, chunk: int = 1024):
    """`corr_lattice_ref`'s function computed the way the kernels compute
    it (`box_corr`). Returns (out [NC*M, 882] float32, live edges that did
    not fit at either level)."""
    MEM, _, P, _, _ = gmap_r.shape
    NC = cells.shape[0]
    E = NC * M
    dev = gmap_r.device
    m = torch.arange(M, device=dev).repeat(NC)
    slot = cells[:, 0].long().repeat_interleave(M)
    live = slot >= 0
    g = gmap_r.reshape(MEM * M, P * P, C)[
        cells[:, 1].long().repeat_interleave(M) * M + m].float()
    st, slow = box_corr(g, fmap1_r, fmap2_r, slot.clamp(min=0),
                        u.reshape(E, P * P).float(),
                        v.reshape(E, P * P).float(), cap, chunk)
    return torch.where(live[:, None], st, torch.zeros_like(st)), slow & live


_SIG = {"corr_lattice_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
        + [ctypes.c_void_p],
        "corr_lattice_slow_edges": [ctypes.POINTER(ctypes.c_uint),
                                    ctypes.c_int]}


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
                   fmap2_r, u, v, cells, M: int, defines=()):
    """Launch a warp-per-edge lattice kernel of csrc/<lib_name>.cu
    (K1's contract, `ncol` output columns per edge); returns [E, ncol] in
    the rings' dtype. `defines` picks a build variant."""
    check_lattice_inputs(lib_name, gmap_r, fmap1_r, fmap2_r, u, v, M,
                         (cells,))
    _, H1, W1, _ = fmap1_r.shape
    _, H2, W2, _ = fmap2_r.shape
    E = cells.shape[0] * M
    if u.numel() != E * 9:
        raise ValueError(f"{lib_name}: coords do not match the cell table")
    dt = gmap_r.dtype
    out = torch.empty((E, ncol), dtype=dt, device=gmap_r.device)
    lib = build.load(lib_name, {fn: _SIG["corr_lattice_launch"]}, defines)
    err = getattr(lib, fn)(
        gmap_r.data_ptr(), fmap1_r.data_ptr(), fmap2_r.data_ptr(),
        u.data_ptr(), v.data_ptr(), cells.data_ptr(), out.data_ptr(),
        E, M, H1, W1, H2, W2, int(dt == torch.bfloat16),
        torch.cuda.current_stream(gmap_r.device).cuda_stream,
    )
    build.check(err, fn)
    return out


def corr_lattice_cuda(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int,
                      defines=()):
    """Launch the Hopper kernel (same contract as `corr_lattice_ref`);
    `defines` picks a build variant."""
    out = launch_lattice("corr_lattice", "corr_lattice_launch",
                         2 * (2 * RADIUS + 1) ** 2 * 9, gmap_r, fmap1_r,
                         fmap2_r, u, v, cells, M, defines)
    corr_lattice.launches += 1
    return out


def corr_lattice_slow_edges(reset: bool = True, defines=()) -> int:
    """How many edges of K1's launches took the kernel's slow path
    (pixel spread beyond CAP) since the last reset; waits for the device."""
    lib = build.load("corr_lattice", {
        "corr_lattice_slow_edges": _SIG["corr_lattice_slow_edges"]}, defines)
    n = ctypes.c_uint(0)
    build.check(lib.corr_lattice_slow_edges(ctypes.byref(n), int(reset)),
                "corr_lattice_slow_edges")
    return n.value


def corr_lattice(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n,
                 slotmap, r: int, lat):
    """Two-level lattice correlation for the VO update.

    gmap_r [MEM, M, 3, 3, 128]; fmap1_r [MEM, H, W, 128] and fmap2_r
    [MEM, H/4, W/4, 128] (the 1/4-res frame features and their 4x pool);
    u, v [NI*T, M*9] level-1 reprojected patch pixels; cell_valid [NI, T];
    n live keyframes (a host int or a 0-d device tensor); slotmap [L];
    r = PATCH_LIFETIME; lat = (NI, T, M). Returns [NI*T*M, 882] in the rings' dtype."""
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


def cell_tables_a(NI: int, T: int, r: int, n, cell_valid, slotmap,
                  MEM: int, tb: int = TB):
    """Per-(target, t-band) tables of K6 (mirror of the reference's
    _cell_tables_a), built on the device: `n` a host int or a 0-d device
    tensor, and nothing is read on the host. Target a = 0..NTGT-1 is frame
    j = n - NTGT + a (NTGT = NI + r - 2); its live offsets are t in
    [tlo_a, thi_a] (host i = j - t + r - 1 in the last NI frames and
    >= 0), cut into bands of `tb`. Returns

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
    short = min(0, n - NI) if isinstance(n, int) else (n - NI).clamp(max=0)
    thi_a = (a + 1 + short).clamp(max=T - 1)
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
    at = groups[:, 0:1] * Tp + groups[:, 1:2] * tb + tc
    walked = torch.zeros(NI * T, dtype=torch.int32, device=dev)
    walked.index_add_(0, c.reshape(-1)[at.reshape(-1)],
                      walk.reshape(-1).to(torch.int32))
    walked.clamp_(max=1)
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


_SIG_CB = {"corr_lattice_cb_launch": [ctypes.c_void_p] * 10
           + [ctypes.c_long, ctypes.c_void_p] + [ctypes.c_int] * 9
           + [ctypes.c_void_p],
           "corr_lattice_cb_slow_edges": [ctypes.POINTER(ctypes.c_uint),
                                          ctypes.c_int]}


def corr_lattice_cb_cuda(gmap_r, fmap1_r, fmap2_r, u, v, tables, M: int,
                         grid=None, defines=(), scratch=None):
    """Launch K6 (same contract as `corr_lattice_cb_ref`): the edges
    binned by target tile (`grid`, ops/corr_bins.py::bin_grid's default
    for these maps when None), each bin's taps staged in shared memory.
    `defines` picks a build variant; `scratch` an int32 buffer of
    corr_bins.scratch_words words to build the bins in (chip_smoke.py
    reads the bins back from it), else a new one."""
    from . import corr_bins

    groups, cells_a, walked = tables
    check_lattice_inputs("corr_lattice_cb", gmap_r, fmap1_r, fmap2_r, u, v,
                         M, tables)
    MEM, H1, W1, _ = fmap1_r.shape
    _, H2, W2, _ = fmap2_r.shape
    NB, NC = groups.shape[0], walked.shape[0]
    if u.numel() != NC * M * 9 or groups.shape[1:] != (6,) \
            or cells_a.shape[1:] != (2,) or cells_a.shape[0] % NB:
        raise ValueError("corr_lattice_cb: coords/tables do not match")
    dt = gmap_r.dtype
    out = torch.empty((NC * M, 2 * (2 * RADIUS + 1) ** 2 * 9), dtype=dt,
                      device=gmap_r.device)
    grid = grid or corr_bins.bin_grid(H1, W1, MEM)
    scratch, gi = corr_bins.launch_scratch(NC * M, grid, gmap_r.device,
                                           scratch)
    lib = build.load("corr_lattice_cb", _SIG_CB, defines)
    err = lib.corr_lattice_cb_launch(
        gmap_r.data_ptr(), fmap1_r.data_ptr(), fmap2_r.data_ptr(),
        u.data_ptr(), v.data_ptr(), groups.data_ptr(), cells_a.data_ptr(),
        walked.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), gi, NB, NC, cells_a.shape[0] // NB, M, H1, W1, H2,
        W2, int(dt == torch.bfloat16),
        torch.cuda.current_stream(gmap_r.device).cuda_stream,
    )
    build.check(err, "corr_lattice_cb_launch")
    corr_lattice_cb.launches += 1
    return out


def corr_lattice_cb_slow_edges(reset: bool = True, defines=()) -> int:
    """How many edges of K6's launches took K1's slow path (residual edges
    with a span beyond CAP) since the last reset; waits for the device."""
    lib = build.load("corr_lattice_cb", _SIG_CB, defines)
    n = ctypes.c_uint(0)
    build.check(lib.corr_lattice_cb_slow_edges(ctypes.byref(n), int(reset)),
                "corr_lattice_cb_slow_edges")
    return n.value


def corr_lattice_cb(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n,
                    slotmap, r: int, lat, tb: int = TB):
    """`corr_lattice`'s function and contract ([NI*T*M, 882], the
    reference layout) through K6's walk tables and binned kernel
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
