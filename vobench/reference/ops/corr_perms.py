"""Column maps between the correlation layouts the lattice kernels emit
(port of rampvo_tpu/ops/corr_pallas.py::paired_corr_perm and
folded_corr_perm).

The reference layout (corr_stack) holds, in column
((py*P + px)*d*d + a*d + b)*2 + l, level l's blended window of patch pixel
(py, px) at x shift a and y shift b (d = 2R + 1). The paired layout (K5)
holds it in column q*128 + l*64 + b*8 + a, 128 columns per pixel, with
zeros where a or b is d; the folded layout (K4's folded kernel) in column
l*(P*P*d*d) + q*d*d + b*d + a. `models.vonet.fold_corr_fc1` turns these
maps into corr_fc1 weights that read each layout directly.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=4)
def paired_corr_perm(P: int = 3, R: int = 3) -> np.ndarray:
    """[P*P*128] int32: the reference column held by each paired column,
    or -1 for the 30 zero columns of each pixel's 128."""
    d = 2 * R + 1
    idx = np.full(P * P * 128, -1, np.int32)
    for q in range(P * P):
        for l in range(2):
            for y in range(d):
                for x in range(d):
                    idx[q * 128 + l * 64 + y * 8 + x] = (
                        (q * d * d + x * d + y) * 2 + l)
    idx.setflags(write=False)      # cached: one array for every caller
    return idx


@functools.lru_cache(maxsize=4)
def folded_corr_perm(P: int = 3, R: int = 3) -> np.ndarray:
    """[P*P*d*d*2] int32: inv[folded column] = reference column, so a
    reference-layout weight W [.., 882] reads folded input as W[.., inv]."""
    d = 2 * R + 1
    PP = P * P
    inv = np.zeros(PP * d * d * 2, np.int32)
    for q in range(PP):
        for a in range(d):
            for b in range(d):
                for l in range(2):
                    inv[l * PP * d * d + q * d * d + b * d + a] = (
                        (q * d * d + a * d + b) * 2 + l)
    inv.setflags(write=False)
    return inv
