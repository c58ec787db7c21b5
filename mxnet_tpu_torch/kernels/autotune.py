"""Measured autotuner over a KernelSpec's config space (counterpart of
``mxnet_tpu/kernels/autotune.py``).

Exhaustive: each candidate config is launched, timed, and the argmin
committed.  On CUDA tensors a run is timed with ``torch.cuda.Event``s
around a loop of launches (the device, not the host's enqueue); on the
CPU with the host clock.  A config that fails to launch for a shape is
skipped and reported in the rows; the spec's default is always a
candidate, so the winner is never slower than the untuned default on
the shapes measured.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import registry as _kreg
from .registry import _C_TUNE_MS, _C_TUNE_RUNS

__all__ = ["candidates", "tune", "tune_registered", "time_ms"]


def time_ms(fn, device, warmup: int = 3, runs: int = 20) -> float:
    """Median ms of one ``fn()`` call.  On CUDA every sample is a pair
    of events around one call, synchronised once at the end."""
    import torch
    for _ in range(warmup):
        fn()
    if getattr(device, "type", device) == "cuda":
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(runs)]
        torch.cuda.synchronize(device)
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize(device)
        samples = sorted(a.elapsed_time(b) for a, b in pairs)
    else:
        samples = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            samples.append((time.perf_counter() - t0) * 1e3)
        samples.sort()
    return samples[len(samples) // 2]


def candidates(spec) -> List[Dict[str, Any]]:
    """The cartesian product of the config space, default first (so
    ties resolve to the untuned behaviour)."""
    keys = sorted(spec.config_space)
    out = [dict(spec.default_config)]
    for combo in itertools.product(*(spec.config_space[k] for k in keys)):
        cfg = dict(spec.default_config)
        cfg.update(zip(keys, combo))
        if cfg not in out:
            out.append(cfg)
    return out


def tune(spec, arrays: Sequence[Any], params: Optional[dict] = None,
         warmup: int = 1, runs: int = 5, verbose: bool = False
         ) -> Tuple[Dict[str, Any], float, List[dict]]:
    """Measure every candidate config on ``arrays``; returns
    ``(best_config, best_ms, rows)``."""
    params = params or {}
    device = arrays[0].device
    t_start = time.perf_counter()
    rows: List[dict] = []
    best_cfg, best_ms = dict(spec.default_config), float("inf")
    for cfg in candidates(spec):

        def run_once(cfg=cfg):
            spec.run(cfg, *arrays, **params)
            _C_TUNE_RUNS.inc()

        try:
            run_once()                       # build/launch probe
            ms = time_ms(run_once, device, warmup, runs)
        except Exception as e:               # config invalid for shape
            rows.append({"kernel": spec.name, "config": cfg, "ms": None,
                         "error": f"{type(e).__name__}: {e}"})
            if verbose:
                print(f"    {cfg}  FAILED ({type(e).__name__})")
            continue
        rows.append({"kernel": spec.name, "config": cfg,
                     "ms": round(ms, 4)})
        if verbose:
            print(f"    {cfg}  {ms:9.4f} ms")
        if ms < best_ms:
            best_cfg, best_ms = cfg, ms
    _C_TUNE_MS.inc((time.perf_counter() - t_start) * 1e3)
    if best_ms == float("inf"):              # nothing ran: keep default
        best_ms = 0.0
    return best_cfg, best_ms, rows


def tune_registered(names: Optional[Sequence[str]] = None,
                    warmup: int = 1, runs: int = 5,
                    verbose: bool = False) -> List[dict]:
    """Drive the tuner over each kernel's shape grid and commit the
    winners; one row per (kernel, case, config) plus a ``winner`` row
    per case."""
    all_rows: List[dict] = []
    for name in (list(names) if names else _kreg.list_kernels()):
        spec = _kreg.get_kernel(name)
        if spec.make_args is None or not spec.tune_grid:
            continue
        for case in spec.tune_grid:
            arrays, params = spec.make_args(case)
            sig, dtype = spec.signature(*arrays, **params)
            cfg, ms, rows = tune(spec, arrays, params=params,
                                 warmup=warmup, runs=runs, verbose=verbose)
            key = _kreg.commit(spec, sig, dtype, cfg, ms)
            for r in rows:
                r.update({"sig": sig, "dtype": dtype})
            all_rows.extend(rows)
            all_rows.append({"kernel": name, "sig": sig, "dtype": dtype,
                             "winner": cfg, "ms": round(ms, 4),
                             "key": key})
    return all_rows
