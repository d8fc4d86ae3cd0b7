"""Event-to-tensor representations (port of the numpy implementations in
rampvo_tpu/data/representations.py; ref utils/transformers.py).

Both produce channels-FIRST [bins, H, W] numpy arrays like the reference;
the loader transposes to channels-last. A native (C++) version is not
ported yet (ROADMAP): these are the numpy versions the JAX package falls
back to.
"""

from __future__ import annotations

import numpy as np

from .events import Events


class EventToStack:
    """Count-binned polarity stack, int8 output (ref
    utils/transformers.py:128-161). Bins by event COUNT, not time: event k
    of N goes to bin floor(num_bins * k / N)."""

    def __init__(self, num_bins: int):
        self.num_bins = num_bins

    def __call__(self, events: Events) -> np.ndarray:
        grid = np.zeros((self.num_bins, events.height, events.width),
                        np.float32)
        n = len(events)
        if n < 2:
            return grid.astype(np.int8)

        b = (self.num_bins * np.arange(n, dtype="float32") / n).astype("int32")
        x = events.x.astype(np.int64)
        y = events.y.astype(np.int64)
        ok = (x >= 0) & (y >= 0) & (x < events.width) & (y < events.height)
        np.add.at(grid, (b[ok], y[ok], x[ok]), events.p[ok].astype(np.float32))
        return grid.astype(np.int8)


class EventsToVoxelGrid:
    """Bilinear-in-time voxel grid with nonzero-mean/std normalization
    (ref utils/transformers.py:21-125)."""

    def __init__(self, num_bins: int, normalize: bool = True):
        self.num_bins = num_bins
        self.normalize = normalize

    def __call__(self, events: Events) -> np.ndarray:
        B, H, W = self.num_bins, events.height, events.width
        grid = np.zeros((B * H * W,), np.float32)
        n = len(events)
        if n == 0:
            return grid.reshape(B, H, W)

        t = events.t.astype(np.float64)
        dT = t[-1] - t[0]
        if dT == 0:
            dT = 1.0
        ts = (B - 1) * (t - t[0]) / dT
        xs = events.x.astype(np.int64)
        ys = events.y.astype(np.int64)
        pols = events.p.astype(np.float32)

        tis = np.floor(ts)
        dts = (ts - tis).astype(np.float32)
        tl = tis.astype(np.int64)

        ok = (tis < B) & (tis >= 0)
        np.add.at(grid, xs[ok] + ys[ok] * W + tl[ok] * W * H,
                  pols[ok] * (1 - dts[ok]))
        ok = (tis + 1 < B) & (tis >= 0)
        np.add.at(grid, xs[ok] + ys[ok] * W + (tl[ok] + 1) * W * H,
                  pols[ok] * dts[ok])
        grid = grid.reshape(B, H, W)
        return self._normalize(grid) if self.normalize else grid

    @staticmethod
    def _normalize(grid: np.ndarray) -> np.ndarray:
        nz = grid != 0
        if nz.any():
            mean = grid[nz].mean()
            std = grid[nz].std()
            grid[nz] = (grid[nz] - mean) / std if std > 0 else grid[nz] - mean
        return grid
