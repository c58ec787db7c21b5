"""Autoregressive decode serving: continuous batching over a paged KV
cache with optional speculative decode (counterpart of
``mxnet_tpu/serving/decode``).

- :mod:`paged_kv` — pre-allocated device page pool + host free-list
  allocator with per-slot page tables;
- :mod:`engine` — the small causal LM + decode / prefill / draft /
  verify paths over the ``paged_attention`` and ``rope`` kernels;
- :mod:`scheduler` — the continuous batcher (``DecodeScheduler``).
"""
from .paged_kv import OutOfPagesError, PageAllocator, PagedKVCache
from .engine import DecodeEngine, DecodeModel
from .scheduler import DecodeScheduler

__all__ = ["PageAllocator", "PagedKVCache", "OutOfPagesError",
           "DecodeModel", "DecodeEngine", "DecodeScheduler"]
