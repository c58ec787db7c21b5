"""Serving (counterpart of ``mxnet_tpu/serving``): so far the decode
plane and the decode half of :class:`ServingServer`."""
from . import slo  # noqa: F401
from .decode import DecodeEngine, DecodeModel, DecodeScheduler
from .engine import (BadRequestError, QueueFullError, RequestTimeoutError,
                     ServingClosedError)
from .server import ServingServer

__all__ = ["DecodeEngine", "DecodeModel", "DecodeScheduler",
           "ServingServer", "BadRequestError", "QueueFullError",
           "RequestTimeoutError", "ServingClosedError", "slo"]
