"""Lazy HDF5 event stream view (port of rampvo_tpu/data/event_handle.py;
ref data/event_handle.py:8-55). h5py, and hdf5plugin where installed (the
compressed ECD/EDS files need it), are imported when a file is opened."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .events import Events


class H5EventHandle:
    """View over an `events/{x,y,t,p,height,width}` HDF5 layout."""

    def __init__(self, handle, height=None, width=None):
        g = handle["events"]
        for k in ("x", "y", "t", "p", "height", "width"):
            if k not in g.keys():
                raise KeyError(f"missing events/{k}")
        self.height = int(g["height"][()]) if height is None else height
        self.width = int(g["width"][()]) if width is None else width
        self.handle = handle

    @property
    def t(self):
        return self.handle["events/t"]

    @classmethod
    def from_path(cls, path: Path, height=None, width=None) -> "H5EventHandle":
        import h5py

        try:  # compressed files need the plugin; plain h5 does not
            import hdf5plugin  # noqa: F401
        except ImportError:
            pass
        return cls(h5py.File(str(path), "r"), height=height, width=width)

    def close(self):
        self.handle.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def get_between_idx(self, i0: int, i1: int) -> Events:
        g = self.handle["events"]
        return Events(
            x=np.asarray(g["x"][i0:i1]),
            y=np.asarray(g["y"][i0:i1]),
            t=np.asarray(g["t"][i0:i1]),
            p=np.asarray(g["p"][i0:i1]),
            height=self.height,
            width=self.width,
        )

    def __len__(self) -> int:
        return len(self.handle["events/t"])
