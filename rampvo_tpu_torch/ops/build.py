"""Build and load the port's CUDA kernels.

Each kernel source under csrc/ has a plain C interface; `nvcc` compiles it
into a shared library under rampvo_tpu_torch/_build/ at first use and
ctypes loads it (no PyTorch headers, so a build takes seconds). The
library name carries a hash of the source and of the shared headers
(csrc/*.cuh), so an edited source or header rebuilds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME or PATH)")
    return found


def _flags(defines=()) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _lib_path(name: str, defines=()) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def start_build(name: str, defines=()):
    """Start nvcc for csrc/<name>.cu, with `-D` for each of `defines` (a
    build variant), unless its library exists. Returns (process, temporary
    output, library path), or None when already built. The library
    appears atomically when `finish_build` succeeds."""
    out = _lib_path(name, defines)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish_build(started) -> str:
    """Wait for a build from `start_build`; raises on failure. Returns the
    compiler's output (register and shared-memory use)."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(items) -> dict:
    """Build several kernels in parallel (one nvcc each, started together).
    `items`: kernel names, or (name, defines) pairs for build variants.
    Returns {item: compiler output}."""
    started = {it: start_build(*((it,) if isinstance(it, str) else it))
               for it in items}
    return {it: finish_build(st) for it, st in started.items()}


def load(name: str, signatures: dict, defines=()) -> ctypes.CDLL:
    """Load (building first if needed) csrc/<name>.cu's library, or its
    build variant with `defines`, and declare `signatures` {function:
    argtypes}; every function returns an int (the cudaError_t after a
    launch)."""
    key = (name, tuple(defines))
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            finish_build(start_build(name, defines))
            lib = ctypes.CDLL(str(_lib_path(name, defines)))
            _LIBS[key] = lib
        for fn, argtypes in signatures.items():  # several wrappers, one lib
            f = getattr(lib, fn)
            if f.argtypes is None:
                f.argtypes = argtypes
                f.restype = ctypes.c_int
        return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
