"""Serving request identity and the slowest-request ring (the
request-identity half of ``mxnet_tpu/serving/slo.py``).

- :func:`next_request_id` mints the monotonic id the batcher and the
  decode scheduler stamp into every admitted request's spans
  (``serving.enqueue``, ``serving.request``, the ``request_ids`` of
  ``serving.coalesce`` / ``serving.dispatch``), so one request can be
  followed through admission, coalescing and dispatch.
- :func:`observe_request` takes each finished request's latency
  decomposition into a bounded min-heap of the N slowest requests
  (``MXNET_SERVING_SLOW_RING``, default 16), served at
  ``GET /requestz``.  It records only while tracing is on, the
  reference's gating when no objective is declared.
- :func:`slo_view` is ``GET /slo``'s body with no objective declared.

Declared objectives (``ServingSLO``, :func:`declare`,
``MXNET_SLO_LATENCY_MS``) evaluate burn rates into clustermon's
incident store and the advice plane, which come with the observability
port (queue 1 item 10): :func:`declare` raises "not ported yet", and a
set ``MXNET_SLO_LATENCY_MS`` raises at the first :func:`get` /
:func:`active` / :func:`declared` instead of being ignored.  With
nothing declared and tracing off, nothing here runs on the serving path
beyond the id increment, and no thread is made in any mode.
"""
from __future__ import annotations

import heapq
import os
import threading
import time
import weakref
from typing import List, Optional

from .. import telemetry
from .. import tracing
from ..base import MXNetError

__all__ = ["declare", "declared", "get", "active",
           "next_request_id", "request_count", "observe_request",
           "slo_view", "requestz", "burning_cause", "clear_ring",
           "note_weights_published", "weights_age_s", "note_batcher",
           "SAT_SIGNALS"]

_NOT_PORTED = ("serving SLO objectives (ServingSLO, declare, "
               "MXNET_SLO_LATENCY_MS) need clustermon's incident store and "
               "the advice plane, which are not ported yet (queue 1 item 10)")

# the per-request signals a declared objective attributes latency to
SAT_SIGNALS = ("queue_wait", "compute", "padding", "compile")


# -- request identity --------------------------------------------------------

_RID_LOCK = threading.Lock()
_rid = 0


def next_request_id() -> int:
    """Monotonic per-process request id."""
    global _rid
    with _RID_LOCK:
        _rid += 1
        return _rid


def request_count() -> int:
    """Ids minted so far (requests admitted to a queue)."""
    return _rid


# -- slowest-request ring ----------------------------------------------------

def _ring_capacity() -> int:
    v = os.environ.get("MXNET_SERVING_SLOW_RING")
    try:
        return max(1, int(v)) if v else 16
    except ValueError:
        return 16


_RING_LOCK = threading.Lock()
_ring: List[tuple] = []       # min-heap of (latency_ms, seq, entry)
_ring_seq = 0


def _ring_add(entry: dict) -> None:
    global _ring_seq
    cap = _ring_capacity()
    with _RING_LOCK:
        _ring_seq += 1
        item = (float(entry.get("latency_ms") or 0.0), _ring_seq, entry)
        if len(_ring) < cap:
            heapq.heappush(_ring, item)
        elif item[0] > _ring[0][0]:
            heapq.heapreplace(_ring, item)
        while len(_ring) > cap:     # the capacity shrank mid-run
            heapq.heappop(_ring)


def clear_ring() -> None:
    with _RING_LOCK:
        _ring.clear()


def requestz(limit: Optional[int] = None) -> dict:
    """The ``GET /requestz`` body: the N slowest requests served, each
    with its latency decomposition, slowest first."""
    with _RING_LOCK:
        tracked = len(_ring)
        items = sorted(_ring, key=lambda it: (-it[0], it[1]))
    entries = [dict(it[2]) for it in items]
    if limit is not None:
        entries = entries[:max(0, int(limit))]
    return {"ring_capacity": _ring_capacity(), "tracked": tracked,
            "requests_seen": _rid, "slowest": entries}


# -- weights staleness -------------------------------------------------------

_weights_ts: Optional[float] = None


def note_weights_published(ts: Optional[float] = None) -> None:
    """Stamp a parameter-set publication (the ``serving.weights_age_s``
    gauge then reads the age of the weights served)."""
    global _weights_ts
    _weights_ts = time.time() if ts is None else float(ts)
    telemetry.gauge("serving.weights_age_s").set(0.0)


def weights_age_s() -> Optional[float]:
    """Seconds since the last published weight set (None when never
    stamped)."""
    if _weights_ts is None:
        return None
    age = round(max(0.0, time.time() - _weights_ts), 3)
    telemetry.gauge("serving.weights_age_s").set(age)
    return age


# -- live batchers -----------------------------------------------------------

_batchers: "weakref.WeakSet" = weakref.WeakSet()


def note_batcher(batcher) -> None:
    """Batchers register at construction (weakly), as the target of the
    queue-saturation advice a declared objective publishes."""
    _batchers.add(batcher)


# -- declaration -------------------------------------------------------------

def _refresh_env() -> None:
    v = os.environ.get("MXNET_SLO_LATENCY_MS")
    if not v:
        return
    try:
        lat = float(v)
    except ValueError:
        return                  # the reference ignores an unparseable value
    if lat > 0:
        raise MXNetError(f"MXNET_SLO_LATENCY_MS={v}: {_NOT_PORTED}")


def declare(latency_ms: float, percentile: float = 95.0,
            availability: Optional[float] = None,
            window_s: Optional[float] = None,
            burn_threshold: Optional[float] = None,
            min_samples: Optional[int] = None,
            directory: Optional[str] = None,
            ttft_ms: Optional[float] = None):
    """Declare serving objectives: not ported yet (queue 1 item 10)."""
    raise MXNetError(_NOT_PORTED)


def declared() -> bool:
    _refresh_env()
    return False


def get():
    """The live objectives' engine: None (raises while
    ``MXNET_SLO_LATENCY_MS`` asks for one)."""
    _refresh_env()
    return None


def active() -> bool:
    """True when per-request accounting should run: objectives declared
    or tracing live (the slow-request ring).  The batcher's guard."""
    return declared() or tracing.enabled()


def observe_request(entry: dict) -> None:
    """Per-request feed from the batcher and the decode scheduler: into
    the slow ring while tracing is on."""
    if tracing.enabled():
        _ring_add(entry)


def burning_cause() -> Optional[str]:
    """The burning objective's cause: None (no objective can burn)."""
    get()
    return None


def slo_view() -> dict:
    """The ``GET /slo`` body with no objective declared."""
    _refresh_env()
    ring = {"capacity": _ring_capacity(), "tracked": len(_ring)}
    return {"declared": False, "objectives": None,
            "requests_seen": _rid, "weights_age_s": weights_age_s(),
            "ring": ring}
