"""Serving error classes (the part of ``mxnet_tpu/serving/engine.py``
that the decode plane and the server need).  The batch
``InferenceEngine`` is ported with a later slice."""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["BadRequestError", "QueueFullError", "RequestTimeoutError",
           "ServingClosedError"]


class BadRequestError(MXNetError):
    """Request rejected at admission (shape, token ids, budget) — raised
    before the request enters the queue."""


class QueueFullError(MXNetError):
    """Request shed at admission: the bounded queue is at depth."""


class RequestTimeoutError(MXNetError):
    """Request expired before it finished (per-request deadline)."""


class ServingClosedError(MXNetError):
    """Request arrived after shutdown/drain began."""
