"""Span flight recorder (the part of ``mxnet_tpu/tracing.py`` that
serving and training call): ``begin``/``end`` for spans that
cross threads, ``span`` for a ``with`` block,
``record_span`` for intervals measured out of band, ``instant`` for
markers.  Completed spans land as Chrome-trace ``"X"`` events in a
bounded ring (``MXNET_TRACE_BUFFER``, default 4096); ``open_spans``,
``span_count`` and ``dropped_count`` are what ``GET /tracez`` shows
beside ``recent``.

With ``MXNET_TRACE`` unset or off and no ``enable()``, every call
returns at the ``enabled()`` check (``begin`` hands back a shared no-op
span).  Export, the watchdog and the critical-path buckets come with
the observability port of a later slice.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from . import telemetry

__all__ = ["begin", "end", "span", "record_span", "instant", "enabled",
           "enable", "disable", "recent", "open_spans", "span_count",
           "dropped_count", "clear"]

_LOCK = threading.Lock()
_PID = os.getpid()
_EPOCH = time.perf_counter()
_ids = itertools.count(1)
_OFF_VALUES = ("", "0", "false", "off", "no")
_C_SPANS = telemetry.counter("tracing.spans")
_C_DROPPED = telemetry.counter("tracing.spans_dropped")

_forced: Optional[bool] = None      # enable()/disable() override env
_ring: Optional[deque] = None
_open: Dict[int, "Span"] = {}       # begun, not yet ended


def enable() -> None:
    """Force tracing on for this process (overrides env)."""
    global _forced
    _forced = True


def disable() -> None:
    """Force tracing off for this process (overrides env)."""
    global _forced
    _forced = False


def _env_default() -> None:
    """Drop an ``enable()``/``disable()`` override: ``MXNET_TRACE``
    decides again."""
    global _forced
    _forced = None


def enabled() -> bool:
    if _forced is not None:
        return _forced
    v = os.environ.get("MXNET_TRACE")
    return v is not None and v.strip().lower() not in _OFF_VALUES


class _NullSpan:
    __slots__ = ()


_NULL = _NullSpan()


class Span:
    """One open interval from ``begin``; finished by ``end``."""

    __slots__ = ("name", "attrs", "t0", "tid", "span_id")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.tid = threading.get_ident()
        self.span_id = next(_ids)
        with _LOCK:
            _open[self.span_id] = self
        self.t0 = time.perf_counter()


def begin(name: str, **attrs) -> Any:
    """Open a span that may end on another thread; pair with
    ``end(sp)``."""
    if not enabled():
        return _NULL
    return Span(name, attrs)


def end(sp, **attrs) -> None:
    """Finish a span from ``begin`` (None/no-op span tolerated)."""
    if sp is None or sp is _NULL:
        return
    sp.attrs.update(attrs)
    _store(sp.name, sp.t0, time.perf_counter(), sp.tid,
           dict(sp.attrs, span_id=sp.span_id), span_id=sp.span_id)


class _SpanScope:
    """``with span(...) as sp:`` — ``sp.annotate(**attrs)`` adds to the
    span's attributes before it ends."""

    __slots__ = ("_sp",)

    def __init__(self, sp):
        self._sp = sp

    def __enter__(self):
        return self

    def annotate(self, **attrs):
        if self._sp is not _NULL:
            self._sp.attrs.update(attrs)

    def __exit__(self, *exc):
        end(self._sp)
        return False


_NULL_SCOPE = _SpanScope(_NULL)


def span(name: str, **attrs) -> _SpanScope:
    """A span around a ``with`` block on this thread."""
    if not enabled():
        return _NULL_SCOPE
    return _SpanScope(Span(name, attrs))


def record_span(name: str, t_start: float, t_end: float, **attrs) -> None:
    """Book an interval measured out of band (``time.perf_counter``
    values)."""
    if not enabled():
        return
    _store(name, t_start, t_end, threading.get_ident(),
           dict(attrs, span_id=next(_ids)))


def instant(name: str, **attrs) -> None:
    """Zero-duration marker event."""
    t = time.perf_counter()
    record_span(name, t, t, **attrs)


def _capacity() -> int:
    try:
        return max(16, int(os.environ.get("MXNET_TRACE_BUFFER", 4096)))
    except ValueError:
        return 4096


def _store(name: str, t0: float, t1: float, tid: int, args: dict,
           span_id: Optional[int] = None) -> None:
    global _ring
    ev = {"name": name, "ph": "X", "cat": name.split(".", 1)[0],
          "ts": round((t0 - _EPOCH) * 1e6, 3),
          "dur": round(max(0.0, t1 - t0) * 1e6, 3),
          "pid": _PID, "tid": tid, "args": args}
    with _LOCK:
        if span_id is not None:
            _open.pop(span_id, None)
        if _ring is None:
            _ring = deque(maxlen=_capacity())
        if len(_ring) == _ring.maxlen:
            _C_DROPPED.inc()
        _ring.append(ev)
        _C_SPANS.inc()


def recent(n: int = 100) -> List[Dict[str, Any]]:
    """The most recent ≤ n completed spans (Chrome-event dicts)."""
    with _LOCK:
        evs = list(_ring or ())
    return evs[-n:]


def open_spans() -> List[Dict[str, Any]]:
    """Begun, unfinished spans with their age so far."""
    now = time.perf_counter()
    with _LOCK:
        spans = list(_open.values())
    return [{"name": sp.name, "span_id": sp.span_id, "tid": sp.tid,
             "ts": round((sp.t0 - _EPOCH) * 1e6, 3),
             "elapsed_ms": round((now - sp.t0) * 1e3, 3),
             "args": dict(sp.attrs)} for sp in spans]


def span_count() -> int:
    """Spans completed in this process."""
    return _C_SPANS.value


def dropped_count() -> int:
    """Completed spans the full ring pushed out."""
    return _C_DROPPED.value


def clear() -> None:
    """Empty the ring (it is made again at the next span, at the
    ``MXNET_TRACE_BUFFER`` then set); open spans and counters stay."""
    global _ring
    with _LOCK:
        _ring = None
