"""Build a CUDA C++ kernel source of ``csrc/`` into a shared library with
a plain C interface and load it with ``ctypes``.

The library is compiled from the source in this checkout at first use,
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
-Xcompiler -fPIC``, into ``build/torch_kernels/`` beside the package.
Its file name carries a hash of the source and the flags, so an edited
source is never served by a stale build; the compile writes a temporary
file and renames it, so a half-written library is never loaded.  A
failed build raises :class:`MXNetError` with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

from ..base import MXNetError

__all__ = ["build_library", "build_dir", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
# name → (CDLL, nvcc output of the build, seconds the build took)
_LIBS: Dict[str, Tuple[ctypes.CDLL, str, float]] = {}


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise MXNetError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda):"
                     " CUDA kernels are built on a machine with the CUDA "
                     "toolkit")


def build_library(name: str) -> Tuple[ctypes.CDLL, str, float]:
    """Compile ``csrc/<name>.cu`` (once per process and source hash) and
    return ``(library, nvcc output, build seconds)``; the seconds are 0
    when an earlier build of the same source was found on disk."""
    import time
    with _LOCK:
        hit = _LIBS.get(name)
        if hit is not None:
            return hit
        src = os.path.join(_CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, f"lib{name}-{digest}.so")
        log, seconds = "", 0.0
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise MXNetError(f"nvcc failed for {src} "
                                 f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, so)
        hit = _LIBS[name] = (ctypes.CDLL(so), log, seconds)
        return hit
