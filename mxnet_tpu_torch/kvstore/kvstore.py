"""The single-process kvstore, ``"local"`` / ``"device"`` (counterpart of
``mxnet_tpu/kvstore/kvstore.py``).

Values are NDArrays on one card.  ``push`` stores a key's value (the sum
of a list of values); with an optimizer set (``set_optimizer``, the
reference's update on the store) a push to a key that holds a weight
updates that weight instead, through the fused whole-set step for a
push of several keys, else one key at a time.  ``pull`` copies a key's
value into each ``out`` in place, so a Gluon parameter pulled into keeps
the tensor its layers read.  ``init`` keeps a copy of each value."""
from __future__ import annotations

from typing import Any, Dict

import torch

from .. import telemetry
from .. import tracing
from ..base import MXNetError
from .base import KVStoreBase, payload_nbytes

__all__ = ["KVStore"]

_COMM_BYTES = telemetry.counter("comm.bytes")


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


@KVStoreBase.register
class KVStore(KVStoreBase):
    """The store of ``create("local" | "device")``."""

    def __init__(self, name: str = "device"):
        self.type = name
        self._data: Dict[Any, Any] = {}
        self._updater = None
        self._optimizer = None

    @staticmethod
    def is_capable(capability: str) -> bool:
        return True                   # the store can run the optimizer

    @staticmethod
    def _reduce(value):
        """The sum of a list of values (a new NDArray), or the value."""
        from ..ndarray.ndarray import NDArray
        if isinstance(value, (list, tuple)):
            with torch.no_grad():
                acc = value[0]._data
                for v in value[1:]:
                    acc = acc + v._data.to(acc.device)
            return NDArray._wrap(acc)
        return value

    def init(self, key, value):
        from ..ndarray.ndarray import NDArray
        for k, v in zip(_as_list(key), _as_list(value)):
            self._data[k] = NDArray._wrap(v._data.detach().clone())

    @staticmethod
    def _keyed(key, value):
        """(keys, values): a list of keys takes a list of values, one a
        key (each a value or a list of values to sum)."""
        if isinstance(key, (list, tuple)):
            return list(key), list(value)
        return [key], [value]

    def push(self, key, value, priority=0):
        tok = telemetry.begin_step()
        try:
            with tracing.span("comm.push") as sp:
                b0 = _COMM_BYTES.value
                self._push(key, value)
                sp.annotate(payload_nbytes=_COMM_BYTES.value - b0)
        finally:
            telemetry.end_step(tok, "kvstore")

    def _push(self, key, value):
        batch = []
        for k, v in zip(*self._keyed(key, value)):
            reduced = self._reduce(v)
            telemetry.record_comm_bytes(payload_nbytes(reduced), "local")
            if self._updater is None:
                self._data[k] = reduced
            elif k in self._data:
                batch.append((k, reduced))
            else:                      # the first push of a key: a weight
                self.init(k, reduced)
        if batch:
            self._apply_updates(batch)

    def _apply_updates(self, batch):
        """The store's optimizer over one push: the fused step for several
        keys when it accepts them, else one key at a time."""
        if len(batch) > 1:
            from ..optimizer import fused_step
            if fused_step.step(self._updater,
                               [(_key_int(k), self._data[k], r)
                                for k, r in batch]):
                return
        for k, r in batch:
            self._updater(_key_int(k), r, self._data[k])

    @torch.no_grad()
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys = _as_list(key)
        outs = _as_list(out) if isinstance(key, (list, tuple)) else [out]
        for k, o in zip(keys, outs):
            if k not in self._data:
                raise MXNetError(f"kvstore: key {k!r} was never initialized")
            val = self._data[k]._data
            for t in _as_list(o):
                if t is not None:
                    t._data.copy_(val)
        return out

    def pushpull(self, key, value, out=None, priority=0):
        tok = telemetry.begin_step()
        try:
            with tracing.span("comm.pushpull") as sp:
                b0 = _COMM_BYTES.value
                if self._updater is not None:
                    self._push(key, value)
                else:
                    for k, v in zip(*self._keyed(key, value)):
                        self._data[k] = self._reduce(v)
                        telemetry.record_comm_bytes(
                            payload_nbytes(self._data[k]), "local")
                if out is not None:
                    self.pull(key, out, priority)
                sp.annotate(payload_nbytes=_COMM_BYTES.value - b0)
            return out
        finally:
            telemetry.end_step(tok, "kvstore")

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)

    def set_optimizer(self, optimizer):
        from .. import optimizer as opt_mod
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        dev = next((v._data.device for v in self._data.values()), None)
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), device=dev)
