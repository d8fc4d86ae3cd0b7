"""Lattice correlation for the folded layout: the Hopper kernel K4
(csrc/corr_bands.cu, port of rampvo_tpu/ops/corr_pallas.py::
_lattice_bands and of the folded `corr_lattice2_stacked` on top of it),
its plain versions, and the plain PyTorch finish of `corr_lattice2` and
`corr_lattice2_stacked`.

The band kernel (`corr_bands_launch`) emits, for every (edge, patch pixel,
level) of the lattice, the exact 8x8 integer-aligned window [E, 9, 2, 8, 8]
(dy, dx) in the rings' dtype, dead cells zero. The JAX band is bf16
whatever its input (corr_pallas.py:551-552); the port's band follows the
rings' dtype, so it is bf16 on the main path and float32 in the f32 tests.
`corr_lattice2` and `corr_lattice2_stacked(folded=False)` finish it (the
dead-cell mask, the 2x2 bilinear blend and the layout) in plain PyTorch,
as the JAX package finishes it in XLA; the TPU kernel's SPREAD `ok` mask
has no counterpart, since every window is exact.

CORR_LAYOUT "folded" runs `corr_lattice2_stacked(folded=True)`, which the
update operator reads through `models.vonet.fold_corr_fc1(net, "folded")`.
On the card that is one launch of the folded kernel (`corr_folded_launch`:
K1's blend inside the kernel, written in the folded layout, equal to K1's
output through `ops.corr_perms.folded_corr_perm` bit for bit); on the CPU
it is the band's plain version and the finish, as in the JAX package.
"""

from __future__ import annotations

import torch

from .corr import corr_raw
from .corr_kernels import (
    RADIUS,
    C,
    cell_tables,
    cell_vmask,
    corr_lattice_ref,
    launch_lattice,
)
from .corr_perms import folded_corr_perm

D = 2 * RADIUS + 2
d = 2 * RADIUS + 1
NCOL = 9 * 2 * D * D     # band columns an edge
NFOLD = 2 * 9 * d * d    # folded columns an edge


def corr_bands_ref(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int,
                   chunk: int = 4096):
    """Plain version of K4: `corr_raw` at both levels over the lattice
    edges, dead cells zero. Arguments as `corr_lattice_ref`. Returns
    [E, 9, 2, 8, 8] in the rings' dtype."""
    MEM, _, P, _, _ = gmap_r.shape
    E = cells.shape[0] * M
    dev = gmap_r.device
    gflat = gmap_r.reshape(MEM * M, P, P, C)
    m = torch.arange(M, device=dev).repeat(cells.shape[0])
    slot_j = cells[:, 0].long().repeat_interleave(M)
    gidx = cells[:, 1].long().repeat_interleave(M) * M + m
    coords = torch.stack([u.reshape(E, P, P), v.reshape(E, P, P)], -1)
    out = torch.empty((E, P * P, 2, D, D), dtype=gmap_r.dtype, device=dev)
    for s in range(0, E, chunk):
        sl = slice(s, min(s + chunk, E))
        sj = slot_j[sl].clamp(min=0)
        r1 = corr_raw(gflat, fmap1_r, coords[sl], gidx[sl], sj, RADIUS)
        r2 = corr_raw(gflat, fmap2_r, coords[sl] / 4.0, gidx[sl], sj, RADIUS)
        st = torch.stack([r1, r2], 3).reshape(-1, P * P, 2, D, D)
        dead = (slot_j[sl] < 0)[:, None, None, None, None]
        out[sl] = torch.where(dead, torch.zeros_like(st), st).to(out.dtype)
    return out


def corr_bands_cuda(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int):
    """Launch K4 (same contract as `corr_bands_ref`)."""
    out = launch_lattice("corr_bands", "corr_bands_launch", NCOL, gmap_r,
                         fmap1_r, fmap2_r, u, v, cells, M)
    corr_lattice_bands.launches += 1
    return out.reshape(-1, 9, 2, D, D)


def corr_lattice_bands(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n,
                       slotmap, r: int, lat):
    """`ops.corr_kernels.corr_lattice`'s arguments; returns the raw windows
    [NI*T*M, 9, 2, 8, 8] in the rings' dtype."""
    NI, T, M = lat
    cells = cell_tables(NI, T, r, n, cell_valid, slotmap, gmap_r.shape[0])
    args = (gmap_r, fmap1_r, fmap2_r, u.contiguous(), v.contiguous(), cells, M)
    if gmap_r.is_cuda:
        return corr_bands_cuda(*args)
    return corr_bands_ref(*args)


corr_lattice_bands.launches = 0


def corr_folded_ref(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int):
    """Plain version of the folded kernel: `corr_lattice_ref` (reference
    layout) in the folded columns. Arguments as `corr_lattice_ref`;
    returns [E, 882] in the rings' dtype."""
    ref = corr_lattice_ref(gmap_r, fmap1_r, fmap2_r, u, v, cells, M)
    return ref[:, torch.tensor(folded_corr_perm(3, 3), dtype=torch.long,
                               device=ref.device)]


def corr_folded_cuda(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int):
    """Launch K4's folded kernel (same contract as `corr_folded_ref`)."""
    out = launch_lattice("corr_bands", "corr_folded_launch", NFOLD, gmap_r,
                         fmap1_r, fmap2_r, u, v, cells, M)
    corr_folded_cuda.launches += 1
    return out


corr_folded_cuda.launches = 0


def finish_bands(bands, u, v, vmask):
    """The finish of the reference's `_finish_aligned`: bands [E, 9, 2, 8,
    8], u, v level-1 coords ([E*9] values), vmask [E] (the cells the kernel
    computed). Returns the two levels' blended windows [E, 9, 7, 7] (y, x),
    float32."""
    E = bands.shape[0]
    bands = torch.where(vmask[:, None, None, None, None], bands,
                        torch.zeros_like(bands))
    x = u.reshape(E, 9)
    y = v.reshape(E, 9)
    outs = []
    for lvl in range(2):
        if lvl:
            x, y = x / 4.0, y / 4.0
        fx = (x - torch.floor(x))[..., None, None]
        fy = (y - torch.floor(y))[..., None, None]
        vol = bands[:, :, lvl].float()
        outs.append((1 - fy) * (1 - fx) * vol[..., :d, :d]
                    + (1 - fy) * fx * vol[..., :d, 1:]
                    + fy * (1 - fx) * vol[..., 1:, :d]
                    + fy * fx * vol[..., 1:, 1:])
    return outs


def _bands_and_mask(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n, slotmap,
                    r, lat):
    NI, T, M = lat
    bands = corr_lattice_bands(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n,
                               slotmap, r, lat)
    vmask = cell_vmask(NI, T, r, n, cell_valid)[:, :, None].expand(
        NI, T, M).reshape(-1)
    return finish_bands(bands, u, v, vmask)


def corr_lattice2(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n,
                  slotmap, r: int, lat):
    """Port of the reference's corr_lattice2: the two levels' correlation
    [E, 3, 3, 49] each, float32, in the reference window order (x, y)."""
    o1, o2 = _bands_and_mask(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n,
                             slotmap, r, lat)
    E = o1.shape[0]
    return tuple(o.transpose(-1, -2).reshape(E, 3, 3, d * d) for o in (o1, o2))


def corr_lattice2_stacked(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n,
                          slotmap, r: int, lat, folded: bool = False):
    """Port of the reference's corr_lattice2_stacked, in the rings' dtype:
    folded=False, the reference layout [E, 882] (level fastest, as
    corr_stack); folded=True, the folded layout [E, (level, pixel, y, x)]
    that `ops.corr_perms.folded_corr_perm` maps to the reference -- on
    the card one launch of the folded kernel, with no finish."""
    if folded and gmap_r.is_cuda:
        NI, T, M = lat
        cells = cell_tables(NI, T, r, n, cell_valid, slotmap,
                            gmap_r.shape[0])
        return corr_folded_cuda(gmap_r, fmap1_r, fmap2_r, u.contiguous(),
                                v.contiguous(), cells, M)
    o1, o2 = _bands_and_mask(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n,
                             slotmap, r, lat)
    return stack_levels(o1, o2, folded).to(gmap_r.dtype)


def stack_levels(o1, o2, folded: bool):
    """The two levels' blended windows [E, 9, 7, 7] (y, x) in one layout:
    folded=False the reference [E, 882] (x, y order, level fastest),
    folded=True [E, (level, pixel, y, x)]."""
    E = o1.shape[0]
    if folded:
        return torch.cat([o1.reshape(E, -1), o2.reshape(E, -1)], 1)
    return torch.stack([o1.transpose(-1, -2), o2.transpose(-1, -2)],
                       -1).reshape(E, -1)
