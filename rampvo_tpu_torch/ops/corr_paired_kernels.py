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
tensors and runs `corr_lattice_paired_ref` for CPU tensors.
"""

from __future__ import annotations

import torch

from .corr_kernels import cell_tables, corr_lattice_ref, launch_lattice
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


def corr_lattice_paired_cuda(gmap_r, fmap1_r, fmap2_r, u, v, cells, M: int):
    """Launch K5 (same contract as `corr_lattice_paired_ref`)."""
    out = launch_lattice("corr_paired", "corr_paired_launch", NCOL, gmap_r,
                         fmap1_r, fmap2_r, u, v, cells, M)
    corr_lattice_paired.launches += 1
    return out


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
