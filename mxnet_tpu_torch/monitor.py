"""``mx.monitor.Monitor`` (counterpart of ``mxnet_tpu/monitor.py``):
per-layer output, weight and gradient statistics.

:meth:`Monitor.install` attaches Gluon forward hooks to a Block tree,
so each layer call reports its output's statistic, and ``toc()`` sweeps
the weights and gradients of the matching parameters.  Every statistic
lands in the telemetry registry as a ``monitor.<name>`` gauge.

A Block with forward hooks declines the whole-step capture and
``hybridize``'s graph (``imperative/cached_step.py``): hooks see real
activations, so a monitored loop runs eagerly, as the reference's
does; the weight and gradient sweep works either way.

``MXNET_MONITOR=0`` disarms every Monitor (the hooks return at once).
"""
from __future__ import annotations

import math
import os
import re
from typing import Any, Callable, List, Optional, Tuple

from . import telemetry
from .ndarray import NDArray

__all__ = ["Monitor"]


def enabled() -> bool:
    """The MXNET_MONITOR master switch (default on; set 0/false/off to
    disarm every installed Monitor, read per call so long-lived
    processes can toggle it)."""
    return os.environ.get("MXNET_MONITOR", "1").lower() \
        not in ("0", "false", "off")


def _asum_stat(arr) -> float:
    """The default statistic, ||x|| / sqrt(size), in float64."""
    import torch
    t = arr._data if isinstance(arr, NDArray) else torch.as_tensor(arr)
    t = t.detach().to(torch.float64).reshape(-1)
    if t.numel() == 0:
        return 0.0
    return float(torch.linalg.vector_norm(t).cpu()) / math.sqrt(t.numel())


class Monitor:
    """Per-layer output, weight and gradient watcher.

    Usage::

        mon = mx.monitor.Monitor(interval=1, pattern=".*dense.*")
        mon.install(net)
        for batch in data:
            mon.tic()
            ...forward/backward/step...
            mon.toc_print()

    ``interval`` rate-limits collection (every N-th ``tic``); ``pattern``
    is a regex over stat names; ``stat_func`` maps an NDArray to the
    recorded value (default ||x||/sqrt(size)); ``monitor_all`` also
    watches layer *inputs* (parity: the monitor_all ctor flag).
    """

    def __init__(self, interval: int = 1,
                 stat_func: Optional[Callable[[Any], float]] = None,
                 pattern: str = ".*", sort: bool = False,
                 monitor_all: bool = False):
        self.interval = max(1, int(interval))
        self.stat_func = stat_func or _asum_stat
        self.re = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all
        self.step = 0
        self.activated = False
        self.queue: List[Tuple[int, str, float]] = []
        self._handles: List[Any] = []
        self._roots: List[Any] = []

    # -- installation ------------------------------------------------------
    def install(self, block) -> "Monitor":
        """Attach forward hooks to ``block`` and every child (each block
        hooked once even when shared); returns self so
        ``Monitor(...).install(net)`` chains."""
        self._roots.append(block)
        visited = set()

        def attach(blk, path):
            if id(blk) in visited:
                return
            visited.add(id(blk))
            self._handles.append(
                blk.register_forward_hook(self._make_hook(path)))
            for name, child in blk._children.items():
                attach(child, f"{path}.{name}" if path else name)

        attach(block, "")
        return self

    def uninstall(self) -> None:
        """Detach every hook this monitor installed."""
        for h in self._handles:
            h.detach()
        self._handles = []
        self._roots = []

    def _make_hook(self, path):
        def hook(blk, inputs, out):
            if not (self.activated and enabled()):
                return
            name = path or type(blk).__name__
            if self.monitor_all:
                for i, a in enumerate(inputs):
                    if isinstance(a, NDArray):
                        self._observe(f"{name}_input{i}", a)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for i, o in enumerate(outs):
                if isinstance(o, NDArray):
                    suffix = "_output" if len(outs) == 1 \
                        else f"_output{i}"
                    self._observe(name + suffix, o)
        return hook

    def _observe(self, name: str, arr) -> None:
        if not self.re.match(name):
            return
        try:
            stat = float(self.stat_func(arr))
        except Exception:
            return
        self.queue.append((self.step, name, stat))
        telemetry.gauge(f"monitor.{name}").set(stat)

    # -- collection cycle (parity: tic/toc/toc_print) ----------------------
    def tic(self) -> None:
        """Arm collection for this step when the interval says so."""
        if enabled() and self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self) -> List[Tuple[int, str, float]]:
        """Disarm and return this step's (step, name, stat) list —
        layer outputs observed since ``tic`` plus a weight/grad sweep of
        every matching parameter of the installed blocks."""
        if not self.activated:
            return []
        self.activated = False
        seen = set()
        for root in self._roots:
            for pname, p in root.collect_params().items():
                if id(p) in seen or p._data is None:
                    continue
                seen.add(id(p))
                if self.re.match(pname):
                    self._observe_param(pname, p.data())
                gname = pname + "_grad"
                if p._grad is not None and self.re.match(gname):
                    self._observe_param(gname, p.grad())
        res = self.queue
        self.queue = []
        if self.sort:
            res = sorted(res, key=lambda x: x[1])
        return res

    def _observe_param(self, name: str, arr) -> None:
        try:
            stat = float(self.stat_func(arr))
        except Exception:
            return
        self.queue.append((self.step - 1, name, stat))
        telemetry.gauge(f"monitor.{name}").set(stat)

    def toc_print(self) -> None:
        """toc() + print one aligned line per stat (parity:
        monitor.py toc_print)."""
        for step, name, stat in self.toc():
            print(f"Batch: {step:7d} {name:30s} {stat:.5g}")
