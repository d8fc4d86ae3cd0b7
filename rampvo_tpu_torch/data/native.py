"""ctypes bindings of the native event-tensor builders (port of
rampvo_tpu/data/native.py; source csrc/event_ops.cpp).

g++ compiles the source at first use into rampvo_tpu_torch/_build/ (the
library's name carries a hash of the source and flags, so an edited source
rebuilds). When it cannot be built or loaded, `event_stack` and
`voxel_grid` return None and the callers (data/representations.py) run
their numpy versions; the reason is printed once. Both equal the numpy
versions bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SRC = PKG / "csrc" / "event_ops.cpp"
BUILD = PKG / "_build"
FLAGS = ["-O3", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_STATE: dict = {}   # "lib": the loaded library or None once tried


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD / f"libevent_ops-{digest.hexdigest()[:12]}.so"


def _build() -> ctypes.CDLL:
    out = lib_path()
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        res = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed:\n{res.stderr[-2000:]}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i64 = ctypes.c_int64
    lib.event_stack.argtypes = [i8p, u16p, u16p, i8p, i64, i64, i64, i64]
    lib.event_stack.restype = None
    lib.voxel_grid.argtypes = [f32p, u16p, u16p, i64p, i8p, i64, i64, i64,
                               i64]
    lib.voxel_grid.restype = None
    return lib


def library():
    """The loaded library, built first if needed; None (after printing
    why, once) when it cannot be built or loaded."""
    with _LOCK:
        if "lib" not in _STATE:
            try:
                _STATE["lib"] = _build()
            except (OSError, RuntimeError) as e:
                print(f"rampvo_tpu_torch.data.native: the native event "
                      f"builders are unavailable, numpy runs instead: {e}",
                      file=sys.stderr)
                _STATE["lib"] = None
        return _STATE["lib"]


def event_stack(events, num_bins: int):
    """Native count-binned stack [bins, H, W] int8; None without the
    library or with fewer than 2 events (numpy's zero stack)."""
    lib = library()
    if lib is None or len(events) < 2:
        return None
    out = np.empty((num_bins, events.height, events.width), np.int8)
    lib.event_stack(out, events.x, events.y, events.p, len(events),
                    num_bins, events.height, events.width)
    return out


def voxel_grid(events, num_bins: int):
    """Native bilinear voxel grid [bins, H, W] float32, not normalized;
    None without the library."""
    lib = library()
    if lib is None:
        return None
    out = np.empty((num_bins, events.height, events.width), np.float32)
    lib.voxel_grid(out, events.x, events.y, events.t, events.p, len(events),
                   num_bins, events.height, events.width)
    return out
