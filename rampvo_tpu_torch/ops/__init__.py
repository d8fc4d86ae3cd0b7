"""Correlation, scatter and neighbour ops and the Hopper kernels (port of
rampvo_tpu/ops). `corr` and `neighbors` stay reachable as the submodules
of those names (ops.corr.corr, ops.neighbors.neighbors): exporting the
functions here would shadow the modules. `corr_lattice_fused2` is the
port's `corr_paired_kernels.corr_lattice_paired` (K5, the paired layout)
under the JAX package's name."""

from .corr import avg_pool2d, corr_stack, patchify, pyramidify
from .corr_band_kernels import corr_lattice2
from .corr_paired_kernels import corr_lattice_paired as corr_lattice_fused2
from .neighbors import lattice_neighbors
from .scatter import compact_ids, segment_mean, segment_softmax, segment_sum

__all__ = [
    "avg_pool2d", "corr_stack", "corr_lattice2", "corr_lattice_fused2",
    "patchify", "pyramidify", "lattice_neighbors",
    "compact_ids", "segment_mean", "segment_softmax", "segment_sum",
]
