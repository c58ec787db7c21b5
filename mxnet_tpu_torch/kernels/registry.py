"""Kernel registry: hand-written kernels + tunable configs + oracles
(counterpart of ``mxnet_tpu/kernels/registry.py``).

Each :class:`KernelSpec` names a kernel's launch function, its tunable
config space (block sizes, warps per block), and the plain PyTorch
version of the same function.  The plain version is the oracle the
kernel is held against and the path CPU tensors take; it is never taken
for a CUDA tensor — a CUDA call launches the kernel or raises.

Registered kernels (each by importing its module under ``ops/``):
``flash_attention`` (K1–K3, ``ops/attention.py``), ``paged_attention``
(K4), ``rope`` (K5) and ``layer_norm_residual`` (K6,
``ops/layernorm_residual.py``).  The runtime kernels of ``rtc.py`` (K7)
are users' own and are not registered, as in the reference.

Config lookup order: in-process memo → on-disk cache
(``MXNET_KERNEL_CACHE_DIR``, ticks ``kernel.cache_hits``) → the
autotuner when ``MXNET_KERNEL_TUNE=1`` and measurement inputs are at
hand → the spec's default (ticks ``kernel.cache_misses``).

Cache key anatomy::

    <op>|v<kernel version>|<backend>|ndev<N>|<dtype>|<shape signature>

The backend is ``cuda:<device name>`` (``cpu`` without a GPU), so an
H100's tuned configs get keys of their own, apart from any TPU entry in
a shared cache file.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .. import telemetry
from ..base import MXNetError

__all__ = ["KernelSpec", "register_kernel", "get_kernel", "list_kernels",
           "resolve", "commit", "invalidate", "warm_cache", "cache_key",
           "stats", "tune_enabled"]

_C_HITS = telemetry.counter("kernel.cache_hits")
_C_MISSES = telemetry.counter("kernel.cache_misses")
_C_TUNE_MS = telemetry.counter("kernel.tune_ms")
_C_TUNE_RUNS = telemetry.counter("kernel.tune_measurements")
_C_WARM = telemetry.counter("kernel.warm_loaded")

_LOCK = threading.Lock()


class KernelSpec:
    """One registered kernel.

    ``run(config, *tensors, **params)``
        launch the kernel under ``config`` (CUDA tensors).
    ``fallback(*tensors, **params)``
        the plain PyTorch version: the CPU path and the oracle.
    ``signature(*tensors, **params) -> (sig, dtype)``
        bucketed shape signature + dtype string for the cache key.
    ``make_args(case) -> (tensors, params)``
        measurement inputs for one ``tune_grid`` case (``case["device"]``
        defaults to ``cuda``).
    ``version``
        bump after any kernel rewrite; stale tuned entries stop matching.
    """

    __slots__ = ("name", "version", "run", "fallback", "config_space",
                 "default_config", "signature", "make_args", "tune_grid")

    def __init__(self, name: str, *, version: int,
                 run: Callable, fallback: Callable,
                 config_space: Dict[str, Sequence[Any]],
                 default_config: Dict[str, Any],
                 signature: Callable,
                 make_args: Optional[Callable] = None,
                 tune_grid: Sequence[dict] = ()):
        self.name = name
        self.version = int(version)
        self.run = run
        self.fallback = fallback
        self.config_space = {k: tuple(v) for k, v in config_space.items()}
        self.default_config = dict(default_config)
        self.signature = signature
        self.make_args = make_args
        self.tune_grid = tuple(tune_grid)

    def __repr__(self):
        return f"<KernelSpec {self.name} v{self.version}>"


_SPECS: Dict[str, KernelSpec] = {}

# key → (config, source) where source ∈ {"disk", "tuned", "default"}
_MEMO: Dict[str, Tuple[Dict[str, Any], str]] = {}

# one parse of the on-disk JSON per process (re-read when the cache dir
# changes or after invalidate())
_DISK: Dict[str, Any] = {"dir": False, "entries": None}

_TOPO: Optional[Tuple[str, int]] = None


def register_kernel(spec: KernelSpec) -> KernelSpec:
    if spec.name in _SPECS:
        raise MXNetError(f"kernel {spec.name!r} registered twice")
    _SPECS[spec.name] = spec
    return spec


def get_kernel(name: str) -> KernelSpec:
    try:
        return _SPECS[name]
    except KeyError:
        raise MXNetError(f"unknown kernel {name!r}") from None


def list_kernels() -> List[str]:
    return sorted(_SPECS)


def tune_enabled() -> bool:
    """The MXNET_KERNEL_TUNE switch: measure on first encounter of an
    untuned key (stalls that call)."""
    return os.environ.get("MXNET_KERNEL_TUNE", "0") == "1"


def _topology() -> Tuple[str, int]:
    global _TOPO
    if _TOPO is None:
        import torch
        if torch.cuda.is_available():
            _TOPO = (f"cuda:{torch.cuda.get_device_name(0)}",
                     torch.cuda.device_count())
        else:
            _TOPO = ("cpu", 1)
    return _TOPO


def _capturing() -> bool:
    """Whether this thread's current CUDA stream is capturing a graph
    (a tune's timing launches and synchronisation cannot run there)."""
    import torch
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


def cache_key(spec: KernelSpec, sig: str, dtype: str) -> str:
    backend, ndev = _topology()
    return f"{spec.name}|v{spec.version}|{backend}|ndev{ndev}|{dtype}|{sig}"


def _disk_entries() -> Dict[str, dict]:
    from . import cache
    d = cache.cache_dir()
    if _DISK["entries"] is None or _DISK["dir"] != d:
        _DISK["dir"] = d
        _DISK["entries"] = cache.load()
    return _DISK["entries"]


def resolve(name: str, sig: str, dtype: str, *,
            tune_args: Optional[tuple] = None,
            allow_tune: Optional[bool] = None) -> Dict[str, Any]:
    """The config for one (kernel, shape-sig, dtype) on this topology.
    Steady state is one memo lookup; the hit/miss counters tick only on
    the first resolution of a key in this process.  Raises MXNetError
    when it would tune while a CUDA graph is being captured."""
    spec = get_kernel(name)
    key = cache_key(spec, sig, dtype)
    can_tune = ((tune_enabled() if allow_tune is None else allow_tune)
                and tune_args is not None)
    with _LOCK:
        hit = _MEMO.get(key)
        if hit is not None and not (hit[1] == "default" and can_tune):
            return hit[0]
        entry = _disk_entries().get(key)
        if entry is not None:
            cfg = dict(entry["config"])
            _MEMO[key] = (cfg, "disk")
            _C_HITS.inc()
            return cfg
    if can_tune:
        if _capturing():
            raise MXNetError(
                f"kernel {name!r} ({sig}, {dtype}) would be tuned inside a "
                f"CUDA graph capture: resolve it in a warm-up run before "
                f"capturing (e.g. DecodeEngine.warmup)")
        from . import autotune
        arrays, params = tune_args
        cfg, ms, _rows = autotune.tune(spec, arrays, params=params)
        commit(spec, sig, dtype, cfg, ms)
        return cfg
    with _LOCK:
        if _MEMO.get(key) is None:
            _MEMO[key] = (dict(spec.default_config), "default")
            _C_MISSES.inc()
        return _MEMO[key][0]


def commit(spec: KernelSpec, sig: str, dtype: str,
           config: Dict[str, Any], ms: Optional[float] = None) -> str:
    """Record a tuned winner: in-process memo + the persistent cache."""
    from . import cache
    key = cache_key(spec, sig, dtype)
    entry: Dict[str, Any] = {"config": dict(config),
                             "kernel_version": spec.version}
    if ms is not None:
        entry["ms"] = round(float(ms), 4)
    with _LOCK:
        _MEMO[key] = (dict(config), "tuned")
        _disk_entries()[key] = entry
    cache.store({key: entry})
    return key


def invalidate(name: Optional[str] = None) -> None:
    """Drop in-process resolutions (all kernels, or one) and the cached
    disk snapshot; the on-disk file itself is never touched."""
    with _LOCK:
        if name is None:
            _MEMO.clear()
        else:
            for k in [k for k in _MEMO if k.split("|", 1)[0] == name]:
                del _MEMO[k]
        _DISK["entries"] = None


def warm_cache() -> int:
    """Prefetch every on-disk entry matching a registered kernel (at its
    current version) into the memo; returns the number loaded."""
    n = 0
    with _LOCK:
        for key, entry in _disk_entries().items():
            spec = _SPECS.get(key.split("|", 1)[0])
            if spec is None or f"|v{spec.version}|" not in key:
                continue
            if key not in _MEMO:
                _MEMO[key] = (dict(entry["config"]), "disk")
                _C_HITS.inc()
                n += 1
    if n:
        _C_WARM.inc(n)
    return n


def stats() -> Dict[str, float]:
    """Snapshot of the kernel-layer counters."""
    return {"cache_hits": _C_HITS.value,
            "cache_misses": _C_MISSES.value,
            "tune_ms": _C_TUNE_MS.value,
            "tune_measurements": _C_TUNE_RUNS.value,
            "resolved": len(_MEMO)}
