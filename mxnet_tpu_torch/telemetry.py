"""Process-wide metrics registry and per-step records (the part of
``mxnet_tpu/telemetry.py`` that decode serving, the trainers and the
checkpoint service call).

Counters, gauges and histograms always accumulate (plain attribute
adds; a histogram keeps count, total, min, max and a bounded ring of
the most recent samples).  A step
funnel brackets its work with ``begin_step``/``end_step``; the record is
built and fanned out only while a sink is attached, so with no sink the
per-step cost is one list check.  A sink is any object with
``emit(record)``.  The reference's JSONL/log/TensorBoard sinks and
reports come with the telemetry port of a later slice.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge",
           "histogram", "metrics", "reset", "snapshot", "add_sink",
           "remove_sink", "clear_sinks", "enabled", "begin_step",
           "end_step", "record_compile", "last_record"]

_LOCK = threading.Lock()

# samples a histogram keeps (the most recent), beside its aggregates
_RESERVOIR = 64


class Counter:
    """Add-only counter; ``value`` may be int or float."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def get(self):
        return self.value

    def reset(self):
        self.value = 0

    def describe(self):
        return self.value


class Gauge:
    """Last-value metric."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v):
        self.value = v

    def get(self):
        return self.value

    def reset(self):
        self.value = None

    def describe(self):
        return self.value


class Histogram:
    """A distribution: count, total, min and max, and a ring of the most
    recent ``_RESERVOIR`` samples (O(1) in time and memory a sample)."""

    __slots__ = ("name", "count", "total", "min", "max", "_ring", "_pos")

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def observe(self, v: float):
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if len(self._ring) < _RESERVOIR:
            self._ring.append(v)
        else:
            self._ring[self._pos] = v
            self._pos = (self._pos + 1) % _RESERVOIR

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    def samples(self) -> List[float]:
        """The most recent samples (at most ``_RESERVOIR``)."""
        return list(self._ring)

    def get(self):
        return self.describe()

    def reset(self):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._ring: List[float] = []
        self._pos = 0

    def describe(self):
        return {"count": self.count, "total": self.total,
                "min": self.min, "max": self.max, "mean": self.mean}


_REGISTRY: Dict[str, Any] = {}


def _get_or_create(name: str, cls):
    m = _REGISTRY.get(name)
    if m is None:
        with _LOCK:
            m = _REGISTRY.get(name)
            if m is None:
                m = _REGISTRY[name] = cls(name)
    if not isinstance(m, cls):
        from .base import MXNetError
        raise MXNetError(
            f"telemetry metric {name!r} already registered as "
            f"{type(m).__name__}, not {cls.__name__}")
    return m


def counter(name: str) -> Counter:
    return _get_or_create(name, Counter)


def gauge(name: str) -> Gauge:
    return _get_or_create(name, Gauge)


def histogram(name: str) -> Histogram:
    return _get_or_create(name, Histogram)


def metrics(prefix: str = "") -> Dict[str, Any]:
    """The live metric objects whose names start with ``prefix``."""
    with _LOCK:
        items = sorted(_REGISTRY.items())
    return {k: v for k, v in items if k.startswith(prefix)}


def snapshot(prefix: str = "") -> Dict[str, Any]:
    """Plain-data view of the registry (JSON-serializable)."""
    return {k: v.describe() for k, v in metrics(prefix).items()}


def reset(prefix: str = "") -> None:
    """Zero the values of the metrics whose names start with ``prefix``,
    in place: modules keep references to their metrics."""
    for v in metrics(prefix).values():
        v.reset()


_C_COMPILES = counter("compile.count")
_C_COMPILE_MS = counter("compile.ms")
_C_STEPS = counter("telemetry.steps")


def record_compile(seconds: float, kind: str) -> None:
    """Account one materialised executable at compile site ``kind``."""
    ms = seconds * 1e3
    _C_COMPILES.inc()
    _C_COMPILE_MS.inc(ms)
    counter(f"compile.{kind}.count").inc()
    counter(f"compile.{kind}.ms").inc(ms)


# -- sinks -------------------------------------------------------------------

_SINKS: List[Any] = []


def add_sink(sink) -> None:
    with _LOCK:
        if sink not in _SINKS:
            _SINKS.append(sink)


def remove_sink(sink) -> None:
    with _LOCK:
        if sink in _SINKS:
            _SINKS.remove(sink)
    close = getattr(sink, "close", None)
    if close is not None:
        close()


def clear_sinks() -> None:
    for s in list(_SINKS):
        remove_sink(s)


def enabled() -> bool:
    """True when a sink is attached — the step-record stream only runs
    then; bare counters always do."""
    return bool(_SINKS)


# -- the per-step record stream ---------------------------------------------

# the whole-step capture's counters and the dispatch counter, whose
# deltas each step record carries
_CACHED_STEP = ("hits", "compiles", "fallbacks", "graph_breaks")
_C_CACHED = tuple(counter(f"cachedstep.{k}") for k in _CACHED_STEP)
_C_DISPATCH = counter("dispatch.count")


class _StepToken:
    __slots__ = ("t0", "compiles", "compile_ms", "dispatches", "cached")

    def __init__(self):
        self.t0 = time.perf_counter()
        self.compiles = _C_COMPILES.value
        self.compile_ms = _C_COMPILE_MS.value
        self.dispatches = _C_DISPATCH.value
        self.cached = tuple(c.value for c in _C_CACHED)


_tls = threading.local()
_last_record: Optional[dict] = None


def begin_step():
    """Enter a step funnel: None (the no-op path) when no sink is
    attached, "nested" inside another funnel on this thread, else a
    token holding the counter baselines for this step's deltas."""
    depth = getattr(_tls, "depth", 0)
    if depth == 0 and not enabled():
        return None
    _tls.depth = depth + 1
    if depth:
        return "nested"
    return _StepToken()


def end_step(token, source: str, extra: Optional[dict] = None) -> None:
    """Leave a step funnel; the outermost one emits one record to every
    sink (``extra`` merges into it)."""
    global _last_record
    if token is None:
        return
    _tls.depth = getattr(_tls, "depth", 1) - 1
    if token == "nested":
        return
    host_ms = (time.perf_counter() - token.t0) * 1e3
    _C_STEPS.inc()
    record = {
        "step": _C_STEPS.value,
        "ts": round(time.time(), 3),
        "source": source,
        "host_ms": round(host_ms, 3),
        "compiles": _C_COMPILES.value - token.compiles,
        "compile_ms": round(_C_COMPILE_MS.value - token.compile_ms, 3),
        "dispatches": _C_DISPATCH.value - token.dispatches,
        "cached_step": {k: c.value - v for k, c, v in
                        zip(_CACHED_STEP, _C_CACHED, token.cached)},
    }
    if extra:
        record.update(extra)
    _last_record = record
    with _LOCK:
        sinks_now = list(_SINKS)
    for s in sinks_now:
        try:
            s.emit(record)
        except Exception:
            # a broken sink must never take down the serving step
            from .log import get_logger
            get_logger("mxnet_tpu_torch.telemetry").exception(
                "telemetry sink %r failed; detaching", s)
            remove_sink(s)


def last_record() -> Optional[dict]:
    """The most recently emitted step record (None before any)."""
    return _last_record
