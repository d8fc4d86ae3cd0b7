"""Correlation, scatter and neighbour ops and the Hopper kernels (port of
rampvo_tpu/ops). `corr` and `neighbors` stay reachable as the submodules
of those names (ops.corr.corr, ops.neighbors.neighbors): exporting the
functions here would shadow the modules."""

from .corr import avg_pool2d, corr_stack, patchify
from .neighbors import lattice_neighbors
from .scatter import compact_ids, segment_softmax, segment_sum

__all__ = [
    "avg_pool2d", "corr_stack", "patchify", "lattice_neighbors",
    "compact_ids", "segment_softmax", "segment_sum",
]
