"""Build CUDA C++ kernel sources with nvcc.

``build_library(name)`` compiles ``csrc/<name>.cu`` into a shared
library with a plain C interface and loads it with ``ctypes``, with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
-Xcompiler -fPIC``, into ``build/torch_kernels/`` beside the package.
``build_cubin(source, options)`` compiles a source *string* (a runtime
kernel of ``rtc.py``) into a cubin under ``build/torch_kernels/rtc/``.

Each output's file name carries a hash of the source and the flags, so
an edited source is never served by a stale build; a compile writes a
temporary file and renames it, so a half-written output is never
loaded.  Builds of different sources run at once (each holds only its
own lock).  A failed build raises :class:`MXNetError` with the
compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Sequence, Tuple

from ..base import MXNetError

__all__ = ["build_library", "build_cubin", "build_dir", "NVCC_FLAGS",
           "CUBIN_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
CUBIN_FLAGS = ("-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
               "-std=c++17")

_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_GUARD = threading.Lock()
# name → (CDLL, nvcc output of the build, seconds the build took)
_LIBS: Dict[str, Tuple[ctypes.CDLL, str, float]] = {}


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")


def _lock(key: str) -> threading.Lock:
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(key, threading.Lock())


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


def _digest(source: bytes, flags: Sequence[str]) -> str:
    return hashlib.sha256(source + b"\0" + " ".join(flags).encode()
                          ).hexdigest()[:16]


def _compile(flags: Sequence[str], src: str, out: str) -> Tuple[str, float]:
    """nvcc ``src`` into ``out`` unless it is already there; returns
    (compiler output, seconds), ``("", 0.0)`` for a build found on
    disk."""
    if os.path.exists(out):
        return "", 0.0
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", tmp, src],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise MXNetError(f"nvcc failed for {src} (exit {proc.returncode}):"
                         f"\n{log}")
    os.replace(tmp, out)
    return log, seconds


def build_library(name: str) -> Tuple[ctypes.CDLL, str, float]:
    """Compile ``csrc/<name>.cu`` (once per process and source hash) and
    return ``(library, nvcc output, build seconds)``; the seconds are 0
    when an earlier build of the same source was found on disk."""
    with _lock(f"lib:{name}"):
        hit = _LIBS.get(name)
        if hit is not None:
            return hit
        src = os.path.join(_CSRC, f"{name}.cu")
        with open(src, "rb") as f:
            digest = _digest(f.read(), NVCC_FLAGS)
        out_dir = build_dir()
        os.makedirs(out_dir, exist_ok=True)
        so = os.path.join(out_dir, f"lib{name}-{digest}.so")
        log, seconds = _compile(NVCC_FLAGS, src, so)
        hit = _LIBS[name] = (ctypes.CDLL(so), log, seconds)
        return hit


def build_cubin(source: str, options: Sequence[str] = ()
                ) -> Tuple[str, str, float]:
    """Compile a CUDA C source string with ``CUBIN_FLAGS`` plus
    ``options`` into ``build/torch_kernels/rtc/<hash>.cubin`` and return
    ``(path, nvcc output, build seconds)``; the seconds are 0 when the
    cubin of the same source, options and flags is already on disk."""
    flags = (*CUBIN_FLAGS, *options)
    digest = _digest(source.encode(), flags)
    out_dir = os.path.join(build_dir(), "rtc")
    os.makedirs(out_dir, exist_ok=True)
    cubin = os.path.join(out_dir, f"{digest}.cubin")
    with _lock(f"rtc:{digest}"):
        if os.path.exists(cubin):
            return cubin, "", 0.0
        src = os.path.join(out_dir, f"{digest}.cu")
        tmp = f"{src}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(source)
        os.replace(tmp, src)
        log, seconds = _compile(flags, src, cubin)
        return cubin, log, seconds
