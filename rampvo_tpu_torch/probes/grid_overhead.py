"""P2: the cost of a launch and of a block (port of
scripts/probe_grid_overhead.py:65-135; kernels `grid_noop` and `grid_rows`
in csrc/probes.cu).

NB = NTGT * T = 900 blocks, the JAX probe's grid (NI = 25, T = 25,
M = 96, PP = 9, NTGT = NI + 13 - 2), in three variants:

  "noop"  (A) blocks that do nothing;
  "two"   (B) blocks that read their row of `tabs` [NB, 5] and write one
          192-wide bf16 row of zeros into each of two outputs
          [NI+1, T, M, PP, 1, 192] at (tabs[b, 4], tabs[b, 1], 0, 0, 0);
  "one"   (C) the same into one output [NI+1, T, M, 2*PP, 1, 192].

`grid_probe` launches the kernel for CUDA tensors and runs
`grid_probe_ref` (torch indexing) for CPU tensors; both write into the
outputs they are given.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import build

NI, T, M, PP = 25, 25, 96, 9
ROW = 192                      # D * TX of the TPU band
NTGT = NI + 13 - 2
NB = NTGT * T
MEM = 32
VARIANTS = ("noop", "two", "one")

_SIG = {"grid_probe_launch": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]}


def make_tabs(varying: bool = True):
    """[NB, 5] int32 (in_row, t, gslot, gslot, out_row) of the JAX probe's
    make_tabs at n = 40: live cells at their lattice row, the others (and
    every block when not `varying`) at the trash row NI, t = 0. Returns
    (tabs, live blocks)."""
    b = np.arange(NB)
    a, t = b // T, b % T
    n = 40
    j = n - NTGT + a
    i = j - t + 12
    row = np.mod(i, NI)
    occupied = (n - 1 - np.mod(n - 1 - row, NI)) == i
    valid = occupied & (i >= 0) & (j >= 0) & (j <= n - 1) & (i >= n - 22)
    if varying:
        in_row = np.where(valid, row, 0)
        t_io = np.where(valid, t, 0)
        gslot = np.where(valid, np.mod(i, MEM), 0)
        out_row = np.where(valid, row, NI)
    else:
        in_row = t_io = gslot = np.zeros(NB, np.int64)
        out_row = np.full(NB, NI)
    tabs = np.stack([in_row, t_io, gslot, gslot, out_row], 1)
    return torch.from_numpy(tabs.astype(np.int32)), int(valid.sum())


def output_shapes(variant: str):
    """Shapes of the outputs a variant writes (none for "noop")."""
    if variant == "two":
        return [(NI + 1, T, M, PP, 1, ROW)] * 2
    if variant == "one":
        return [(NI + 1, T, M, 2 * PP, 1, ROW)]
    return []


def grid_probe_ref(variant: str, tabs, outs):
    """Plain version: the same writes with torch indexing."""
    for o in outs:
        o[tabs[:, 4].long(), tabs[:, 1].long(), 0, 0, 0, :] = 0
    return outs


def grid_probe_cuda(variant: str, tabs, outs):
    """Launch P2's variant (same contract as `grid_probe_ref`)."""
    shapes = output_shapes(variant)
    if [tuple(o.shape) for o in outs] != shapes \
            or any(not o.is_cuda or o.dtype != torch.bfloat16
                   or not o.is_contiguous() for o in outs) \
            or not tabs.is_cuda or tabs.dtype != torch.int32 \
            or tuple(tabs.shape) != (NB, 5):
        raise ValueError("grid_probe: tabs [NB, 5] int32 and bf16 outputs "
                         "of the variant's shapes, on the card")
    ptrs = [o.data_ptr() for o in outs] + [0] * (2 - len(outs))
    cell = int(np.prod(shapes[0][2:])) if shapes else 0
    lib = build.load("probes", _SIG)
    err = lib.grid_probe_launch(
        VARIANTS.index(variant), NB, tabs.data_ptr(), *ptrs, T, cell,
        torch.cuda.current_stream(tabs.device).cuda_stream)
    build.check(err, "grid_probe_launch")
    grid_probe.launches += 1
    return outs


def grid_probe(variant: str, tabs, outs):
    if tabs.is_cuda:
        return grid_probe_cuda(variant, tabs, outs)
    return grid_probe_ref(variant, tabs, outs)


grid_probe.launches = 0


def host_us_per_launch(reps: int = 1000) -> float:
    """P2's host issue cost on the card: µs per launch over `reps`
    back-to-back "noop" launches on the host clock, ending in a
    synchronize (the cost the host pays for each launch of an eager
    frame)."""
    import time

    tabs = make_tabs(True)[0].cuda()
    grid_probe_cuda("noop", tabs, [])
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        grid_probe_cuda("noop", tabs, [])
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e6 / reps
