"""Build and load the port's CUDA kernels.

Each kernel source under csrc/ has a plain C interface; `nvcc` compiles it
into a shared library under rampvo_tpu_torch/_build/ at first use and
ctypes loads it (no PyTorch headers, so a build takes seconds). The
library name carries a hash of the source, so an edited source rebuilds.
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


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def start_build(name: str):
    """Start nvcc for csrc/<name>.cu unless its library exists. Returns
    (process, temporary output, library path), or None when already
    built. The library appears atomically when `finish_build` succeeds."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
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


def build_all(names) -> dict:
    """Build several kernels in parallel (one nvcc each, started together).
    Returns {name: compiler output}."""
    started = {n: start_build(n) for n in names}
    return {n: finish_build(st) for n, st in started.items()}


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Load (building first if needed) csrc/<name>.cu's library and declare
    `signatures` {function: argtypes}; every function returns an int (the
    cudaError_t after its launch)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            finish_build(start_build(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
