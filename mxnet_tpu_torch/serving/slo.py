"""Per-request identity and accounting (the part of
``mxnet_tpu/serving/slo.py`` the decode plane calls).

``next_request_id`` mints the monotonic id stamped into a request's
spans; ``observe_request`` takes each finished request's entry (id, ok,
latency, queue wait, TTFT) into a bounded ring that ``recent_requests``
reads.  Declared objectives and burn rates come with a later slice.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import List

__all__ = ["next_request_id", "observe_request", "recent_requests"]

_RID_LOCK = threading.Lock()
_rid = 0

_RING_LOCK = threading.Lock()
_ring: deque = deque(maxlen=1024)


def next_request_id() -> int:
    """Monotonic per-process request id."""
    global _rid
    with _RID_LOCK:
        _rid += 1
        return _rid


def observe_request(entry: dict) -> None:
    """Per-request feed from the schedulers."""
    with _RING_LOCK:
        _ring.append(dict(entry))


def recent_requests(n: int = 1024) -> List[dict]:
    """The most recent ≤ n finished requests' entries, oldest first."""
    with _RING_LOCK:
        return list(_ring)[-n:]
