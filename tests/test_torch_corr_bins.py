"""The bin builder of the binned correlation kernels K5 and K6
(ops/corr_bins.py, the plain version of csrc/corr_bins.cuh's): on a small
lattice with seeded coordinates of every kind the kernels meet -- plain
patches, every edge of a target clustered into one tile, patches
straddling tile borders, spans beyond the binned box sides and beyond
CAP, far and non-finite coordinates -- every live walked edge lies in
exactly one bin or in the residual list, dead and unwalked edges in
none, each binned edge's boxes inside its bin's staged regions, and a
walk of the bins in bin order against maps cut to those regions gives
`corr_lattice_ref`'s output bit for bit. CPU only.
"""

import numpy as np
import pytest
import torch

from rampvo_tpu_torch.ops import corr_bins as cb
from rampvo_tpu_torch.ops import corr_kernels as ck

NI, T, R, M, MEM = 4, 5, 3, 8, 8
H1, W1 = 24, 40
H2, W2 = H1 // 4, W1 // 4
N = 10
KINDS = ["plain", "clustered", "straddle", "wide", "far", "nonfinite"]
GRIDS = [dict(), dict(ts=8, b1=14, b2=10), dict(ts=(4, 12), b1=14, b2=10)]


def coords(kind, seed=0):
    """[NC, M*9] u and v (level-1 coords) of one kind, float32; half the
    patches of the non-plain kinds are plain."""
    rng = np.random.RandomState(seed)
    E = NI * T * M
    grid = np.stack(np.meshgrid(np.arange(3.0) - 1, np.arange(3.0) - 1,
                                indexing="xy"), -1).reshape(9, 2)
    cen = rng.rand(E, 1, 2) * [W1 + 12.0, H1 + 12.0] - 6.0
    off = grid + 0.2 * rng.randn(E, 9, 2)
    odd = (np.arange(E) % 2 == 1)[:, None, None]
    if kind == "clustered":     # every edge's level-1 floors in one tile
        cen = 20.0 + rng.rand(E, 1, 2) * 0.9
        off = grid * 0.0 + 0.05 * rng.rand(E, 9, 2)
    elif kind == "straddle":    # level-1 floor minima at 4k - 1 and 4k:
        # on both sides of every tile border (borders are multiples of 4)
        b = rng.randint(1, 8, (E, 1, 2)) * 4.0 + 1.0
        cen = np.where(odd, b + rng.choice([-0.5, 0.5], (E, 1, 2)), cen)
        off = grid + 0.1 * rng.rand(E, 9, 2)
    elif kind == "wide":        # spans 3..12: some fit CAP but not b1 / b2
        span = rng.randint(3, 13, (E, 1, 1))
        off = np.where(odd, rng.rand(E, 9, 2) * span - span / 2, off)
        off[:, 0] = np.where(odd[:, 0], -span[:, 0] / 2, off[:, 0])
        off[:, 1] = np.where(odd[:, 0], span[:, 0] / 2 - 0.01, off[:, 1])
    xy = cen + off
    if kind == "far":           # far centres, and one pixel at +-1e30
        xy = np.where(odd, xy + rng.choice([-60.0, 60.0], (E, 1, 2)), xy)
        xy[::4, 4, 0] = rng.choice([-1e30, 1e30], E)[::4]
    elif kind == "nonfinite":
        bad = rng.choice([np.nan, np.inf, -np.inf], E)
        xy[1::2, 2, 1] = bad[1::2]
    xy = torch.tensor(xy.reshape(NI * T, M * 9, 2), dtype=torch.float32)
    return xy[..., 0].contiguous(), xy[..., 1].contiguous()


def lattice(seed=0, dt=torch.float32):
    g = torch.Generator().manual_seed(seed)
    gmap = torch.randn(MEM, M, 3, 3, 128, generator=g).to(dt)
    f1 = torch.randn(MEM, H1, W1, 128, generator=g).to(dt)
    f2 = torch.randn(MEM, H2, W2, 128, generator=g).to(dt)
    cell_valid = torch.rand(NI, T, generator=g) < 0.8
    slotmap = torch.full((64,), -1, dtype=torch.int64)
    slotmap[:N] = torch.arange(N) % MEM
    return gmap, f1, f2, cell_valid, slotmap


def walked_slots(tables):
    """[E] target slot of every edge K6's walk computes (-1 for dead and
    unwalked edges) and how many times the walk reaches each edge."""
    groups, cells_a, _ = tables
    tb = cells_a.shape[0] // groups.shape[0]
    slot = torch.full((NI * T * M,), -1, dtype=torch.int64)
    hits = torch.zeros(NI * T * M, dtype=torch.int64)
    for g, (_, _, s, _, lo, hi) in enumerate(groups.tolist()):
        for tc in range(lo, hi + 1):
            cenc = int(cells_a[g * tb + tc, 0])
            c = cenc if cenc >= 0 else -1 - cenc
            e = torch.arange(c * M, (c + 1) * M)
            hits[e] += 1
            if cenc >= 0:
                slot[e] = s
    return slot, hits


@pytest.mark.parametrize("grid_kw", GRIDS, ids=["default", "ts8", "ts4x12"])
@pytest.mark.parametrize("kind", KINDS)
def test_bins_partition_and_regions(kind, grid_kw):
    """K6's walked live edges and K5's live cells: each edge in exactly one
    bin (of its own target slot) or in the residual list, none twice;
    dead and unwalked edges in no bin; each binned edge's boxes (clipped
    to the map) inside its bin's bboxes, and those inside the bin's fixed
    regions of s1 / s2 taps (what the kernels' shared buffer holds)."""
    gmap, f1, f2, cv, slotmap = lattice()
    u, v = coords(kind)
    E = NI * T * M
    grid = cb.bin_grid(H1, W1, MEM, **grid_kw)
    tables = ck.cell_tables_a(NI, T, R, N, cv, slotmap, MEM)
    slot6, hits = walked_slots(tables)
    assert int(hits.max()) == 1          # the walk is a partition
    cells = ck.cell_tables(NI, T, R, N, cv, slotmap, MEM)
    slot5 = cells[:, 0].long().repeat_interleave(M)
    # K5's live edges are K6's walked live edges, on the same slots
    assert torch.equal(slot5, slot6)
    uu, vv = u.reshape(E, 9), v.reshape(E, 9)
    key, bbox, counts = cb.edge_bins(uu, vv, slot6, H1, W1, H2, W2, grid)
    live = slot6 >= 0
    assert bool((key[~live] == -1).all())
    assert bool((key[live] >= 0).all()) and bool((key <= grid.nbin).all())
    assert int(counts.sum()) == int(live.sum())
    assert torch.equal(counts, torch.bincount(key[live],
                                              minlength=grid.nbin + 1))
    order = cb.bin_order(key, grid.nbin)
    assert torch.equal(torch.sort(order).values,
                       torch.nonzero(live)[:, 0])   # each once
    binned = live & (key < grid.nbin)
    assert bool((key[binned] // (grid.nty * grid.ntx) == slot6[binned]).all())
    if kind == "clustered":   # one bin a target slot, nothing residual
        assert int(counts[-1]) == 0
        assert int((counts[:-1] > 0).sum()) == len(set(
            slot6[live].tolist()))
    elif kind in ("wide", "far", "nonfinite"):
        assert int(counts[-1]) > 0
    elif kind == "straddle":  # binned on both sides of tile borders
        b = ck.window_boxes(uu, vv, H1, W1)
        r = (b.bx + 3 + grid.off) % grid.tsx
        assert bool((r[binned] == 0).any() & (r[binned] == grid.tsx - 1)
                    .any())
    tile = key % (grid.nty * grid.ntx)
    ty, tx = tile // grid.ntx, tile % grid.ntx
    sides = ((grid.s1x, grid.s1y), (grid.s2x, grid.s2y))
    for lvl, (sc, H, W) in enumerate(((1.0, H1, W1), (0.25, H2, W2))):
        b = ck.window_boxes(uu * sc, vv * sc, H, W)
        for o, t, w, ts, s in ((b.bx, tx, b.bw, grid.tsx, sides[lvl][0]),
                               (b.by, ty, b.bh, grid.tsy, sides[lvl][1])):
            org = t[binned] * ts - grid.off
            org = (org if lvl == 0 else torch.div(
                org, 4, rounding_mode="floor")) - 3
            assert bool((o[binned] >= org).all())
            assert bool((o[binned] + w[binned] <= org + s).all())
        x0, y0 = b.bx.clamp(min=0), b.by.clamp(min=0)
        x1 = (b.bx + b.bw - 1).clamp(max=W - 1)
        y1 = (b.by + b.bh - 1).clamp(max=H - 1)
        meet = binned & (x0 <= x1) & (y0 <= y1)
        bb = bbox[key[meet], lvl]
        assert bool((bb[:, 0] <= x0[meet]).all() & (bb[:, 1] <= y0[meet])
                    .all() & (bb[:, 2] >= x1[meet]).all()
                    & (bb[:, 3] >= y1[meet]).all())
        used = counts[:-1] > 0
        w = bbox[used, lvl, 2] - bbox[used, lvl, 0] + 1
        h = bbox[used, lvl, 3] - bbox[used, lvl, 1] + 1
        ok = bbox[used, lvl, 2] >= bbox[used, lvl, 0]
        assert bool((w[ok] <= sides[lvl][0]).all()
                    & (h[ok] <= sides[lvl][1]).all())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_bins_walk_matches_ref(kind, dt):
    """A plain walk of the bins in bin order, each bin's edges against maps
    that hold only the bin's staged regions, then the residual list:
    `corr_lattice_ref`'s output bit for bit (NaN outputs of non-finite
    coords at the same places), dead cells zero."""
    gmap, f1, f2, cv, slotmap = lattice(seed=1, dt=dt)
    u, v = coords(kind, seed=2)
    cells = ck.cell_tables(NI, T, R, N, cv, slotmap, MEM)
    grid = cb.bin_grid(H1, W1, MEM)
    ref = ck.corr_lattice_ref(gmap, f1, f2, u, v, cells, M)
    walk = cb.bins_walk_ref(gmap, f1, f2, u, v, cells, M, grid)
    it = torch.int16 if dt == torch.bfloat16 else torch.int32
    assert torch.equal(walk.view(it), ref.view(it))
    if kind == "nonfinite":
        assert bool(torch.isnan(ref.float()).any())


def test_scratch_layout():
    """The scratch views carve the buffer as csrc/corr_bins.cuh::carve:
    disjoint, in order, and of scratch_words words."""
    grid = cb.bin_grid(120, 160, 40)
    E = 25 * 25 * 96
    n = cb.scratch_words(E, grid)
    buf = torch.arange(n, dtype=torch.int32)
    views = cb.scratch_views(buf, E, grid)
    assert grid.nbin == 40 * grid.nty * grid.ntx
    assert views["items"].shape == (E, 4) and int(views["items"][0, 0]) == 0
    assert int(views["key"][0]) == 4 * E and int(views["perm"][0]) == 6 * E
    assert int(views["counts"][0]) == 9 * E
    assert views["counts"].numel() == grid.nbin + 1
    assert views["bbox"].shape == (grid.nbin, 2, 4)
    assert int(views["ctrl"][-1]) == n - 1
    # the default grid's regions and the warps' raw buffers fit one block
    # of the H100 (232448 bytes): 8 warps, raw rows of 168 floats (boxes
    # <= 12 x 12), RefStore's stage
    raw = 9 * 168 + 448
    assert grid.b1 <= 12 and grid.region_taps * 256 + 8 * raw * 4 <= 232448
    with pytest.raises(ValueError):
        cb.bin_grid(120, 160, 40, ts=10)
