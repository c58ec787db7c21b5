"""The single-process kvstore, ``"local"`` / ``"device"`` (counterpart of
``mxnet_tpu/kvstore/kvstore.py``).

Values are NDArrays on one card.  ``push`` stores a key's value (the sum
of a list of values); with an optimizer set (``set_optimizer``, the
reference's update on the store) a push to a key that holds a weight
updates that weight instead, through the fused whole-set step for a
push of several keys, else one key at a time.  ``pull`` copies a key's
value into each ``out`` in place, so a Gluon parameter pulled into keeps
the tensor its layers read.  ``init`` keeps a copy of each value.

Row-sparse values (``RowSparseNDArray``) stay sparse: a list of them is
summed by ``ndarray.sparse.reduce_list`` at nnz cost, the store's
optimizer applies its lazy update, and each push ticks the
``embedding.*`` counters.  ``row_sparse_pull`` returns only the rows
asked for."""
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


def _is_rsp(v) -> bool:
    return getattr(v, "stype", "default") == "row_sparse"


def _dense(v):
    """A row-sparse value made dense; any other value as it is."""
    return v.todense() if _is_rsp(v) else v


def _dense_bytes(rsp) -> int:
    import numpy as onp
    return int(onp.prod(rsp.shape)) * rsp.data.element_size()


def _row_ids(r):
    """Row ids (an NDArray, tensor, array or list) sorted, each once, as
    int64 numpy."""
    import numpy as onp
    if hasattr(r, "asnumpy"):
        r = r.asnumpy()
    elif isinstance(r, torch.Tensor):
        r = r.cpu().numpy()
    return onp.unique(onp.asarray(r, onp.int64).reshape(-1))


def _count_rows(rows_counter, rows, sparse_bytes, dense_bytes) -> None:
    """The ``embedding.*`` counters of one row-sparse store exchange."""
    telemetry.counter(rows_counter).inc(int(rows))
    telemetry.counter("embedding.sparse_bytes").inc(int(sparse_bytes))
    telemetry.counter("embedding.dense_equiv_bytes").inc(int(dense_bytes))


@KVStoreBase.register
class KVStore(KVStoreBase):
    """The store of ``create("local" | "device")``."""

    def __init__(self, name: str = "device"):
        self.type = name
        self._data: Dict[Any, Any] = {}
        self._updater = None
        self._optimizer = None
        self._compression = None

    @staticmethod
    def is_capable(capability: str) -> bool:
        return True                   # the store can run the optimizer

    @staticmethod
    def _reduce(value):
        """The sum of a list of values (a new NDArray, or a row-sparse
        array when every value is one), or the value."""
        from ..ndarray.ndarray import NDArray
        if isinstance(value, (list, tuple)):
            if all(_is_rsp(v) for v in value):
                from ..ndarray.sparse import reduce_list
                return reduce_list(list(value))
            with torch.no_grad():
                dense = [_dense(v) for v in value]
                acc = dense[0]._data
                for v in dense[1:]:
                    acc = acc + v._data.to(acc.device)
            return NDArray._wrap(acc)
        return value

    def init(self, key, value):
        from ..ndarray.ndarray import NDArray
        for k, v in zip(_as_list(key), _as_list(value)):
            self._data[k] = v.copy() if _is_rsp(v) else \
                NDArray._wrap(v._data.detach().clone())

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
            if _is_rsp(reduced):
                # row-sparse store traffic is the sparse-embedding path
                _count_rows("embedding.rows_pushed", reduced.nnz,
                            payload_nbytes(reduced), _dense_bytes(reduced))
            if self._updater is None:
                self._data[k] = reduced
            elif k in self._data:
                batch.append((k, reduced))
            else:                      # the first push of a key: a weight
                self.init(k, _dense(reduced))
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
            val = self._data[k]
            for t in _as_list(o):
                if t is None:
                    continue
                if _is_rsp(t):          # a row-sparse out takes the rows
                    val.copyto(t)
                else:
                    t._data.copy_(_dense(val)._data)
        return out

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The rows ``row_ids`` of each key as a ``RowSparseNDArray``
        (``mxnet_tpu/kvstore/kvstore.py:164-207``): into each ``out``
        (filled in place) or returned.  Each out slot may take its own
        row ids."""
        from ..ndarray.sparse import RowSparseNDArray
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        keys = _as_list(key)
        if out is not None and not isinstance(out, (list, tuple)) \
                and len(keys) > 1:
            raise MXNetError("row_sparse_pull: multiple keys need one "
                             "out buffer per key")
        outs = (out if isinstance(out, (list, tuple))
                else [out] * len(keys))
        rids = row_ids if isinstance(row_ids, (list, tuple)) else [row_ids]
        if len(rids) == 1 and len(keys) > 1:
            rids = rids * len(keys)
        if not (len(keys) == len(outs) == len(rids)):
            raise MXNetError("row_sparse_pull: keys/out/row_ids length "
                             "mismatch")
        results = []
        for k, o, r in zip(keys, outs, rids):
            dense = _dense(self._data[k])._data
            ridx = _row_ids(r)
            if len(ridx) and (ridx[0] < 0 or ridx[-1] >= dense.shape[0]):
                raise MXNetError(
                    f"row_sparse_pull: row_ids out of range for key "
                    f"{k!r} with {dense.shape[0]} rows")
            idx = torch.as_tensor(ridx, device=dense.device)
            rsp = RowSparseNDArray(dense.index_select(0, idx), idx,
                                   tuple(dense.shape))
            _count_rows("embedding.rows_pulled", len(ridx),
                        payload_nbytes(rsp),
                        dense.numel() * dense.element_size())
            if o is not None:
                rsp.copyto(o)
            results.append(rsp)
        if out is None:
            return results[0] if len(results) == 1 else results
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

    def set_gradient_compression(self, compression_params):
        """Kept for the distributed stores' protocol: one process moves
        nothing over a wire, so the local store compresses nothing."""
        from .gradient_compression import GradientCompression
        self._compression = GradientCompression(**compression_params)

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
