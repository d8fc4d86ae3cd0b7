"""Validated struct-of-arrays event container (port of
rampvo_tpu/data/events.py; ref data/events.py:6-50)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Events:
    x: np.ndarray  # uint16
    y: np.ndarray  # uint16
    t: np.ndarray  # int64
    p: np.ndarray  # int8, values in {-1, +1} (0 remapped to -1)
    width: int
    height: int

    def __post_init__(self):
        assert self.x.shape == self.y.shape == self.t.shape == self.p.shape
        self.x = np.ascontiguousarray(self.x, dtype=np.uint16)
        self.y = np.ascontiguousarray(self.y, dtype=np.uint16)
        self.t = np.ascontiguousarray(self.t, dtype=np.int64)
        p = np.ascontiguousarray(self.p, dtype=np.int8)
        # polarity 0 -> -1 (ref: data/events.py:27-29)
        p = np.where(p == 0, np.int8(-1), p)
        self.p = p

    def __len__(self) -> int:
        return len(self.x)

    def __getitem__(self, idx) -> "Events":
        # (the reference's __getitem__ references a nonexistent `divider`,
        # data/events.py:44-50; this is the intended slicing behavior)
        return Events(
            x=self.x[idx], y=self.y[idx], t=self.t[idx], p=self.p[idx],
            width=self.width, height=self.height,
        )

    def to_array(self) -> np.ndarray:
        """[N, 4] columns (x, y, t, p)."""
        return np.stack(
            [self.x.astype(np.float64), self.y.astype(np.float64),
             self.t.astype(np.float64), self.p.astype(np.float64)], axis=1
        )
