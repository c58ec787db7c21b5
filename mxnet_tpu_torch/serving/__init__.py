"""Serving (counterpart of ``mxnet_tpu/serving``).

queue → :class:`DynamicBatcher` → shape-bucketed :class:`InferenceEngine`
(one captured forward per bucket) → per-request futures;
:class:`ServingServer` fronts the pair with an in-process ``predict()``
and an optional stdlib HTTP JSON endpoint.  ``slo`` carries request
identity and the slowest-request ring.  The ``decode`` subpackage is the
autoregressive plane: continuous batching (:class:`DecodeScheduler`)
over a paged KV cache with chunked prefill and speculative decode,
served through the same server's ``/generate``.
"""
from . import slo
from .engine import (InferenceEngine, BadRequestError, QueueFullError,
                     RequestTimeoutError, ServingClosedError,
                     serving_enabled)
from .batcher import DynamicBatcher
from .server import ServingServer
from . import decode
from .decode import (DecodeEngine, DecodeModel, DecodeScheduler,
                     OutOfPagesError, PagedKVCache)

__all__ = ["InferenceEngine", "DynamicBatcher", "ServingServer",
           "BadRequestError", "QueueFullError", "RequestTimeoutError",
           "ServingClosedError", "serving_enabled", "slo", "decode",
           "DecodeEngine", "DecodeModel", "DecodeScheduler",
           "OutOfPagesError", "PagedKVCache"]
