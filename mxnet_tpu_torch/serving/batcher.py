"""Request futures and env knobs shared by the serving queues (the part
of ``mxnet_tpu/serving/batcher.py`` the decode plane needs; the
``DynamicBatcher`` comes with the batch-serving slice)."""
from __future__ import annotations

import os
import threading
from typing import Optional

from .engine import RequestTimeoutError

__all__ = ["_Future", "_getenv_float"]


def _getenv_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        return default


class _Future:
    """Minimal thread-safe future."""

    __slots__ = ("_event", "_result", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc = None

    def set_result(self, result):
        self._result = result
        self._event.set()

    def set_exception(self, exc):
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                f"no response within {timeout:.3f}s")
        if self._exc is not None:
            raise self._exc
        return self._result
