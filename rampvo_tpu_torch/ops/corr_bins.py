"""Edge bins of the binned lattice correlation kernels K5 and K6
(csrc/corr_bins.cuh): the bin geometry, the launch scratch, and the plain
PyTorch version of the bin builder.

At each launch the kernels group the live edges by where they look: bin
(target slot, tile of the level-1 box origin). Each bin has a fixed staged
region per level -- the tile's box origins plus room for a box of at most
`b1` (level 1) or `b2` (level 2) taps a side -- and an edge goes to its bin
when both its boxes fit their regions (csrc/corr_window.cuh's geometry:
spans within CAP, box sides within b1 / b2). The other live edges (wide
spans, far or non-finite coords, boxes off the map) go to the residual
list, which the kernels run with K1's global-memory routine. A block
stages the union of its bin's boxes (clipped to the map) per level in
shared memory and dots its edges from there.

`edge_bins` is the plain version of the builder (histogram, bboxes; the
kernels add the scan and the scatter into a permutation); `bins_walk_ref`
walks the bins in bin order with each bin's maps cut to its staged
regions, the plain counterpart of what a block sees. The tests hold both
against `corr_lattice_ref`; chip_smoke.py holds the kernels' builder
against `edge_bins` on the card. No wrapper calls them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .corr_kernels import RADIUS, corr_lattice_ref, window_boxes

TS = (12, 12)  # tile (x, y) in level-1 box origins (multiples of 4)
B1 = 12   # largest level-1 box side a binned edge may have (span <= 4)
B2 = 9    # largest level-2 box side (span <= 1)
BIG = 2 ** 31 - 1
IE = 64   # edges per work item of the shipped build (CB_WARPS * CB_K)


class BinGrid(NamedTuple):
    tsx: int    # tile width (level-1 taps)
    tsy: int    # tile height
    b1: int     # largest binned box side, level 1
    b2: int     # largest binned box side, level 2
    off: int    # shift of the level-1 floors before tiling (multiple of 4)
    ntx: int    # tiles per row
    nty: int    # tile rows
    s1x: int    # staged region width, level 1
    s1y: int    # staged region height, level 1
    s2x: int    # staged region width, level 2
    s2y: int    # staged region height, level 2
    mem: int    # target slots

    @property
    def nbin(self) -> int:
        return self.mem * self.nty * self.ntx

    @property
    def region_taps(self) -> int:
        """Taps of the shared-memory regions (both levels)."""
        return self.s1x * self.s1y + self.s2x * self.s2y


def bin_grid(H1: int, W1: int, MEM: int, ts=TS, b1: int = B1,
             b2: int = B2) -> BinGrid:
    """The bins of a launch, tile ts = (tsx, tsy) (or one side for both):
    tile (tx, ty) holds the edges whose level-1 floor minima satisfy
    (xlo + off) // tsx == tx and (ylo + off) // tsy == ty; every box that
    meets the map has xlo + off >= 0 and falls in one of ntx x nty tiles.
    Its level-1 region starts at (tx * tsx - off - 3, ...) and is
    (tsx + b1 - 1) x (tsy + b1 - 1) taps; its level-2 region starts at
    ((tx * tsx - off) // 4 - 3, ...) and is (tsx / 4 - 1 + b2) x
    (tsy / 4 - 1 + b2) taps."""
    tsx, tsy = (ts, ts) if isinstance(ts, int) else ts
    if tsx % 4 or tsy % 4 or not 8 <= b1 <= 16 or not 8 <= b2 <= 16:
        raise ValueError("bin grid: tiles of multiples of 4, box sides in "
                         "8..16")
    off = -(-b1 // 4) * 4
    return BinGrid(tsx, tsy, b1, b2, off, (W1 + 2 + off) // tsx + 1,
                   (H1 + 2 + off) // tsy + 1, tsx + b1 - 1, tsy + b1 - 1,
                   tsx // 4 - 1 + b2, tsy // 4 - 1 + b2, MEM)


def scratch_words(E: int, grid: BinGrid) -> int:
    """int32 words of a launch's scratch (csrc/corr_bins.cuh::Scratch):
    items [4E], key, rank, perm [E], meta [2E], counts and offsets
    [nbin + 1] each, bboxes [8 nbin], control [4]."""
    return 9 * E + 10 * grid.nbin + 6


def launch_scratch(E: int, grid: BinGrid, device, scratch=None):
    """The scratch and the grid argument of a binned launch: an int32
    buffer of `scratch_words` words on `device` (`scratch` if given and
    large enough) and the grid as a ctypes int array."""
    import ctypes

    need = scratch_words(E, grid)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.int32, device=device)
    elif scratch.dtype != torch.int32 or scratch.numel() < need \
            or not scratch.is_contiguous() or scratch.device != device:
        raise ValueError(f"bin scratch: needs {need} contiguous int32 words")
    return scratch, (ctypes.c_int * len(grid))(*grid)  # corr_bins.cuh::Grid


def scratch_views(scratch, E: int, grid: BinGrid) -> dict:
    """The bins a launch built into `scratch` (csrc/corr_bins.cuh::carve):
    key [E], perm [E], counts [nbin + 1], bbox [nbin, 2, 4], items [E, 4]
    (bin, first perm index, edges, 0; the first ctrl[0] are used), ctrl
    (items, residual edges, work counter, residual base)."""
    nb = grid.nbin
    c0 = 9 * E
    return dict(items=scratch[:4 * E].view(E, 4), key=scratch[4 * E:5 * E],
                perm=scratch[6 * E:7 * E], counts=scratch[c0:c0 + nb + 1],
                bbox=scratch[c0 + 2 * nb + 2:c0 + 10 * nb + 2].view(nb, 2, 4),
                ctrl=scratch[c0 + 10 * nb + 2:c0 + 10 * nb + 6])


def edge_bins(u, v, slot, H1: int, W1: int, H2: int, W2: int,
              grid: BinGrid):
    """Plain version of the kernels' bin builder. u, v [E, 9] level-1
    coords; slot [E] the target slot of each live edge, -1 for an edge the
    launch does not compute (dead or unwalked). Returns

      key [E] int64: the edge's bin, grid.nbin for the residual list, -1
        for no bin;
      bbox [nbin, 2, 4] int64: per bin and level the union (x0, y0, x1, y1)
X
        where no box meets it;
      counts [nbin + 1] int64: edges per bin, the residual list last."""
    u, v = u.float(), v.float()
    E = u.shape[0]
    dev = u.device
    g = grid
    b1 = window_boxes(u, v, H1, W1)
    b2 = window_boxes(u * 0.25, v * 0.25, H2, W2)
    xlo = b1.bx + RADIUS
    ylo = b1.by + RADIUS
    tx = torch.div(xlo + g.off, g.tsx, rounding_mode="floor")
    ty = torch.div(ylo + g.off, g.tsy, rounding_mode="floor")
    x1 = tx * g.tsx - g.off - RADIUS
    y1 = ty * g.tsy - g.off - RADIUS
    x2 = torch.div(tx * g.tsx - g.off, 4, rounding_mode="floor") - RADIUS
    y2 = torch.div(ty * g.tsy - g.off, 4, rounding_mode="floor") - RADIUS
    ok = (b1.fits & b2.fits & (b1.bw <= g.b1) & (b1.bh <= g.b1)
          & (b2.bw <= g.b2) & (b2.bh <= g.b2)
          & (tx >= 0) & (tx < g.ntx) & (ty >= 0) & (ty < g.nty)
          & (b1.bx >= x1) & (b1.bx + b1.bw <= x1 + g.s1x)
          & (b1.by >= y1) & (b1.by + b1.bh <= y1 + g.s1y)
          & (b2.bx >= x2) & (b2.bx + b2.bw <= x2 + g.s2x)
          & (b2.by >= y2) & (b2.by + b2.bh <= y2 + g.s2y))
    slot = slot.long()
    key = torch.where(ok, (slot * g.nty + ty) * g.ntx + tx,
                      torch.full_like(slot, g.nbin))
    key = torch.where(slot >= 0, key, torch.full_like(slot, -1))
    counts = torch.bincount(key[key >= 0], minlength=g.nbin + 1)
    bbox = torch.tensor([BIG, BIG, -BIG - 1, -BIG - 1], device=dev).repeat(
        g.nbin, 2, 1)
    binned = (key >= 0) & (key < g.nbin)
    for lvl, (b, H, W) in enumerate(((b1, H1, W1), (b2, H2, W2))):
        cx0, cy0 = b.bx.clamp(min=0), b.by.clamp(min=0)
        cx1 = (b.bx + b.bw - 1).clamp(max=W - 1)
        cy1 = (b.by + b.bh - 1).clamp(max=H - 1)
        meet = binned & (cx0 <= cx1) & (cy0 <= cy1)
        k = key[meet]
        for col, val, red in ((0, cx0, "amin"), (1, cy0, "amin"),
                              (2, cx1, "amax"), (3, cy1, "amax")):
            bbox[:, lvl, col].scatter_reduce_(0, k, val[meet], red)
    assert int(counts.sum()) == int((slot >= 0).sum()) and E == key.numel()
    return key, bbox, counts


def bin_order(key, nbin: int):
    """The permutation the kernels walk: edges of bin 0, bin 1, ..., the
    residual list last, each in edge order (the kernels' order inside a
    bin is the order of their atomics and may differ); edges without a
    bin are left out."""
    idx = torch.nonzero(key >= 0)[:, 0]
    return idx[torch.sort(key[idx], stable=True).indices]


def bins_walk_ref(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int,
                  grid: BinGrid):
    """`corr_lattice_ref`'s function walked bin by bin in bin order, each
    bin's edges against maps that hold only the bin's staged regions
    (its bboxes; zeros elsewhere), then the residual list against the
    whole maps; edges of dead cells zero. cells [NC, 2] as
    `cell_tables`. Equal to `corr_lattice_ref` bit for bit when every
    binned edge's in-map taps lie inside its bin's regions."""
    NC = cells.shape[0]
    E = NC * M
    _, H1, W1, _ = fmap1_r.shape
    _, H2, W2, _ = fmap2_r.shape
    slot = cells[:, 0].long().repeat_interleave(M)
    uu, vv = u.reshape(E, 9), v.reshape(E, 9)
    key, bbox, _ = edge_bins(uu, vv, slot, H1, W1, H2, W2, grid)
    out = torch.zeros((E, 2 * (2 * RADIUS + 1) ** 2 * 9),
                      dtype=gmap_r.dtype, device=gmap_r.device)
    order = bin_order(key, grid.nbin)
    ko = key[order]
    starts = torch.nonzero(torch.cat([torch.ones(1, dtype=torch.bool,
                                                 device=ko.device),
                                      ko[1:] != ko[:-1]]))[:, 0].tolist()
    for s, t in zip(starts, starts[1:] + [order.numel()]):
        k = int(ko[s])
        e = order[s:t]
        c = e // M
        sub = cells[c].clone()
        maps = []
        if k < grid.nbin:
            for lvl, f in enumerate((fmap1_r, fmap2_r)):
                x0, y0, x1, y1 = bbox[k, lvl].tolist()
                cut = torch.zeros_like(f)
                if x0 <= x1:
                    sl = (int(sub[0, 0]), slice(y0, y1 + 1),
                          slice(x0, x1 + 1))
                    cut[sl] = f[sl]
                maps.append(cut)
        else:
            maps = [fmap1_r, fmap2_r]
        # one cell per edge: the edge's own patch m in a one-patch lattice
        g1 = gmap_r[sub[:, 1].long(), (e % M)][:, None]
        sub1 = torch.stack([sub[:, 0], torch.arange(
            e.numel(), dtype=sub.dtype, device=sub.device)], 1)
        out[e] = corr_lattice_ref(g1, *maps, uu[e], vv[e], sub1, 1)
    return out
