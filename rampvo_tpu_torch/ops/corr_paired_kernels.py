"""Lattice correlation in the paired layout: the Hopper kernel K5
(csrc/corr_paired.cu, port of rampvo_tpu/ops/corr_pallas.py::
corr_lattice_fused2) and its plain version.

K1's function (ops/corr_kernels.py: exact windows, both levels, blended,
dead cells zero) in the layout the TPU kernel hands its consumer: per
edge 9 * 128 columns, column q*128 + l*64 + y*8 + x holding level l's
blended window of pixel q at (y, x) for y, x < 7, the other 30 columns of
each 128 zero (`ops.corr_perms.paired_corr_perm`). The update operator
reads it through `models.vonet.fold_corr_fc1(net, "paired")`
(CORR_LAYOUT "fused2"). `corr_lattice_paired` launches the kernel for CUDA
tensors and runs `corr_lattice_paired_ref` for CPU tensors. On the card
the live edges are binned by target tile and each bin's taps staged in
shared memory (ops/corr_bins.py, csrc/corr_bins.cuh).
"""

from __future__ import annotations

import ctypes

import torch

from . import build, corr_bins
from .corr_kernels import cell_tables, check_lattice_inputs, corr_lattice_ref
from .corr_perms import paired_corr_perm

NCOL = 9 * 128


def corr_lattice_paired_ref(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int):
    """Plain version: `corr_lattice_ref` (reference layout) scattered into
    the paired columns, zeros elsewhere. Returns [E, 1152] in the rings'
    dtype."""
    ref = corr_lattice_ref(gmap_r, fmap1_r, fmap2_r, u, v, cells, M)
    idx = torch.tensor(paired_corr_perm(3, 3), dtype=torch.long,
                       device=ref.device)
    out = ref.new_zeros((ref.shape[0], NCOL))
    live = idx >= 0
    out[:, live] = ref[:, idx[live]]
    return out


_SIG = {"corr_paired_launch": [ctypes.c_void_p] * 8
        + [ctypes.c_long, ctypes.c_void_p] + [ctypes.c_int] * 7
        + [ctypes.c_void_p],
        "corr_paired_slow_edges": [ctypes.POINTER(ctypes.c_uint),
                                   ctypes.c_int]}


def corr_lattice_paired_cuda(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int,
                             grid=None, defines=(), scratch=None):
    """Launch K5 (same contract as `corr_lattice_paired_ref`): the live
    edges binned by target tile (`grid`, corr_bins.bin_grid's default for
    these maps when None), each bin's taps staged in shared memory.
    `defines` picks a build variant; `scratch` as
    ops/corr_kernels.py::corr_lattice_cb_cuda."""
    check_lattice_inputs("corr_paired", gmap_r, fmap1_r, fmap2_r, u, v, M,
                         (cells,))
    MEM, H1, W1, _ = fmap1_r.shape
    _, H2, W2, _ = fmap2_r.shape
    E = cells.shape[0] * M
    if u.numel() != E * 9:
        raise ValueError("corr_paired: coords do not match the cell table")
    dt = gmap_r.dtype
    out = torch.empty((E, NCOL), dtype=dt, device=gmap_r.device)
    grid = grid or corr_bins.bin_grid(H1, W1, MEM)
    scratch, gi = corr_bins.launch_scratch(E, grid, gmap_r.device, scratch)
    lib = build.load("corr_paired", _SIG, defines)
    err = lib.corr_paired_launch(
        gmap_r.data_ptr(), fmap1_r.data_ptr(), fmap2_r.data_ptr(),
        u.data_ptr(), v.data_ptr(), cells.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), scratch.numel(), gi, E, M, H1, W1, H2, W2,
        int(dt == torch.bfloat16),
        torch.cuda.current_stream(gmap_r.device).cuda_stream,
    )
    build.check(err, "corr_paired_launch")
    corr_lattice_paired.launches += 1
    return out


def corr_paired_slow_edges(reset: bool = True, defines=()) -> int:
    """How many edges of K5's launches took K1's slow path (residual edges
    with a span beyond CAP) since the last reset; waits for the device."""
    lib = build.load("corr_paired", _SIG, defines)
    n = ctypes.c_uint(0)
    build.check(lib.corr_paired_slow_edges(ctypes.byref(n), int(reset)),
                "corr_paired_slow_edges")
    return n.value


def corr_lattice_paired(gmap_r, fmap1_r, fmap2_r, u, v, cell_valid, n,
                        slotmap, r: int, lat):
    """`ops.corr_kernels.corr_lattice`'s arguments; returns the paired
    layout [NI*T*M, 1152] in the rings' dtype."""
    NI, T, M = lat
    cells = cell_tables(NI, T, r, n, cell_valid, slotmap, gmap_r.shape[0])
    args = (gmap_r, fmap1_r, fmap2_r, u.contiguous(), v.contiguous(), cells, M)
    if gmap_r.is_cuda:
        return corr_lattice_paired_cuda(*args)
    return corr_lattice_paired_ref(*args)


corr_lattice_paired.launches = 0
