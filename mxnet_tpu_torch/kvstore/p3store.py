"""P3: the priority-based parameter propagation store (counterpart of
``mxnet_tpu/kvstore/p3store.py``).

``p3store_dist`` cuts a big gradient into slices of at most
``MXNET_KVSTORE_SLICE_THRESHOLD`` values (default 40000) and queues one
all-reduce a slice at the push's priority; a flush issues the queue
highest priority first (the reference's priority is ``-layer index``, so
the layers the next forward needs first reduce first).  With
``gluon.Trainer`` each parameter's pushpull is dispatched by the
grad-ready hook (``autograd.set_grad_ready_hook``) the moment its
gradient is final, overlapping the rest of the backward.  P3 reduces
gradients only: it has no server-side optimizer.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Any, List

import torch

from .. import telemetry
from ..base import getenv_int
from ..ndarray.ndarray import NDArray
from .base import KVStoreBase
from .dist import DistKVStore

__all__ = ["P3StoreDist"]


@KVStoreBase.register
class P3StoreDist(DistKVStore):
    """``p3store_dist``: sliced, priority-scheduled pushpull."""

    def __init__(self, name: str = "p3store_dist"):
        super().__init__(name)
        self.type = "p3store_dist"
        self._slice_threshold = getenv_int(
            "MXNET_KVSTORE_SLICE_THRESHOLD", 40000)
        self._queue: List = []           # (-priority, seq, task)
        self._seq = itertools.count()

    def _slices(self, value: NDArray):
        n = value.size
        nslices = max(1, -(-n // self._slice_threshold))
        flat = value._data.reshape(n)
        bounds = [(i * n // nslices, (i + 1) * n // nslices)
                  for i in range(nslices)]
        return flat, bounds

    @torch.no_grad()
    def pushpull(self, key, value, out=None, priority=0):
        """Slice, queue each slice's all-reduce at ``priority``, flush,
        and write the reduced value into ``out`` (``value`` itself when
        None) in place."""
        tok = telemetry.begin_step()
        try:
            out = out if out is not None else value
            flat, bounds = self._slices(value)
            pieces: List[Any] = [None] * len(bounds)

            def make_task(si, lo, hi):
                def task():
                    pieces[si] = self._allreduce(
                        NDArray._wrap(flat[lo:hi]))._data
                return task

            for si, (lo, hi) in enumerate(bounds):
                heapq.heappush(self._queue,
                               (-priority, next(self._seq),
                                make_task(si, lo, hi)))
            self._flush()
            merged = torch.cat(pieces).reshape(value.shape)
            out._data.copy_(merged)
            self._data[key] = NDArray._wrap(merged)
            return out
        finally:
            telemetry.end_step(tok, "kvstore")

    def _flush(self):
        while self._queue:
            _, _, task = heapq.heappop(self._queue)
            task()
