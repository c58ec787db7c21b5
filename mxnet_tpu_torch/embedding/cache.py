"""``EmbeddingLookupCache``: the serving side's lookup tier in front of
the parameter servers (counterpart of ``mxnet_tpu/embedding/cache.py``).

A bounded LRU of table rows between an ``InferenceEngine``
(``attach_embedding``) and a ``ShardedEmbedding``: a batch's ids are
deduplicated, hot rows come from the cache, and only the cold rest
travels on the sparse pull.  Serving never writes rows, so an entry is
good until capacity evicts it or its owner invalidates it after a
training push.  Counters ``embedding.cache_hits`` / ``cache_misses`` /
``cache_evictions``, and each cache's totals in :meth:`stats`.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as onp

from .. import telemetry
from ..base import getenv

__all__ = ["EmbeddingLookupCache", "cache_rows_env"]


def cache_rows_env(default: int = 4096) -> int:
    """Serving lookup-tier capacity default: ``MXNET_EMB_CACHE_ROWS``
    (rows; >=1), read when a cache is built without explicit
    ``capacity``."""
    try:
        return max(1, int(getenv("MXNET_EMB_CACHE_ROWS", str(default))
                          or default))
    except ValueError:
        return max(1, int(default))


class EmbeddingLookupCache:
    """Bounded LRU of table rows fronting a :class:`ShardedEmbedding`
    (or anything with ``pull_rows(ids) -> (n, dim)`` and ``dim``)."""

    def __init__(self, table, capacity: Optional[int] = None):
        self._table = table
        self.dim = int(table.dim)
        self.capacity = cache_rows_env() if capacity is None \
            else max(1, int(capacity))
        self._rows: "OrderedDict[int, onp.ndarray]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, ids) -> onp.ndarray:
        """Gather rows for ``ids`` (any shape; flattened, duplicates
        deduplicated) as a dense ``(ids.size, dim)`` host block.  Hot
        rows never touch the wire; misses are pulled once per distinct
        id and admitted LRU."""
        flat = onp.asarray(ids, onp.int64).reshape(-1)
        if flat.size == 0:
            return onp.empty((0, self.dim),
                             getattr(self._table, "dtype", onp.float32))
        uniq, inv = onp.unique(flat, return_inverse=True)
        out = None
        with self._lock:
            miss_mask = onp.ones(uniq.size, bool)
            hot_vals = {}
            for i, r in enumerate(uniq):
                vec = self._rows.get(int(r))
                if vec is not None:
                    hot_vals[i] = vec
                    miss_mask[i] = False
                    self._rows.move_to_end(int(r))
            n_hits = uniq.size - int(miss_mask.sum())
            self.hits += n_hits
            self.misses += int(miss_mask.sum())
            telemetry.counter("embedding.cache_hits").inc(n_hits)
            telemetry.counter("embedding.cache_misses").inc(
                int(miss_mask.sum()))
            need = uniq[miss_mask]
            pulled = self._table.pull_rows(need) if need.size else None
            if pulled is not None:
                out = onp.empty((uniq.size, pulled.shape[1]),
                                pulled.dtype)
                out[miss_mask] = pulled
                for i, v in hot_vals.items():
                    out[i] = v
                # admit the cold rows, evicting LRU over capacity
                for r, v in zip(need, pulled):
                    self._rows[int(r)] = v
                    self._rows.move_to_end(int(r))
                evicted = 0
                while len(self._rows) > self.capacity:
                    self._rows.popitem(last=False)
                    evicted += 1
                if evicted:
                    self.evictions += evicted
                    telemetry.counter(
                        "embedding.cache_evictions").inc(evicted)
            else:
                first = next(iter(hot_vals.values()))
                out = onp.empty((uniq.size, first.shape[0]), first.dtype)
                for i, v in hot_vals.items():
                    out[i] = v
        return out[inv]

    def invalidate(self, rows=None) -> None:
        """Drop cached rows (all when ``rows`` is None) — call after a
        training push touched them; the PS copy is the authority."""
        with self._lock:
            if rows is None:
                self._rows.clear()
                return
            for r in onp.asarray(rows, onp.int64).reshape(-1):
                self._rows.pop(int(r), None)

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {"capacity": self.capacity,
                    "resident": len(self._rows),
                    "hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "hit_rate": (self.hits / total) if total else None}
