"""The distributed kvstore over ``torch.distributed`` (counterpart of
``mxnet_tpu/kvstore/dist.py``): ``dist_sync``, ``dist_device_sync`` and
``dist_async``.

Every process is a worker and owns one rank of the process group
(``parallel/_dist.py``: torchrun's variables, ``tools/launch.py``'s
``MXNET_COORDINATOR_ADDR`` / ``DMLC_NUM_WORKER`` / ``DMLC_WORKER_ID``, or
a group of one).  The reference dissolves the parameter server into
collectives, and so does the port:

- ``pushpull`` all-reduces.  All keys of one push ride one collective a
  dtype (key batching); under AMP float gradients cross the wire in the
  compute dtype and come back in their own.
- ``update_on_kvstore`` (the server's optimizer) is weight-update
  sharding, ZeRO-1: each rank owns the flat slice ``[rank·c, rank·c +
  c)`` (``c = ⌈n / ranks⌉``) of every weight and its optimizer state,
  updates that slice and one all-gather a dtype rebuilds the weights.
- ``dist_async`` is stale-synchronous: a push applies this rank's own
  gradient to its own slice at once, with no collective, and every
  ``MXNET_ASYNC_STALENESS_BOUND``-th push call (default 16) all-gathers
  the slices (a rendezvous), so a replica reads other ranks' slices at
  most that many pushes old.  Every rank makes the same number of push
  calls; :meth:`DistKVStore.reconcile` flushes the tail window.
  ``MXNET_ASYNC_UNCOORDINATED=1`` instead sends every push to the
  parameter server of ``ps_server.py`` (a thread of rank 0;
  ``MXNET_PS_ADDR`` names it to the others), which applies it on
  arrival: ranks may then push unequal counts.
- Row-sparse gradients are summed at nnz cost on the plain sync path
  (:meth:`_GlobalCollectives.allreduce_rowsparse_batch`: one all-gather
  of the counts, then one of the indices and one of the values a dtype),
  and the server's optimizer applies its lazy update to them.
- Gradient compression (``set_gradient_compression``, 2-bit) all-gathers
  the packed codes, a 16th of the f32 bytes, and each rank sums the
  ranks' dequantized values in rank order.

Over one rank every collective is elided, as the meshes elide theirs.
Optimizer states save as the reference's ``mxnet_tpu-zero-states-v1``
npz (no pickle), which either package loads.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as onp
import torch
import torch.distributed as dist

from .. import telemetry
from .. import tracing
from ..base import MXNetError, getenv_int, numpy_bits, tensor_from_bits
from ..ndarray.ndarray import NDArray
from .base import KVStoreBase, payload_nbytes
from .kvstore import (_count_rows, _dense, _dense_bytes, _is_rsp, _key_int,
                      _row_ids)

__all__ = ["DistKVStore", "init_distributed"]

_PS_SERVER = None      # the process's uncoordinated-async server
_PS_ADDR = None


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, device=None) -> torch.device:
    """Join (once) the process group the store's collectives run on and
    return this rank's device.  Given ``coordinator_address`` (``host:
    port``), ``num_processes`` and ``process_id``, the group meets at a
    ``TCPStore`` there; otherwise ``parallel._dist.init`` reads the
    environment (torchrun's, or ``tools/launch.py``'s).  ``device``:
    ``None`` (the card) or ``"cpu"`` (gloo)."""
    from ..parallel import _dist
    if _dist.is_initialized() or coordinator_address is None:
        return _dist.init(device)
    from datetime import timedelta
    world = int(num_processes or getenv_int("DMLC_NUM_WORKER", 1))
    rank = int(process_id if process_id is not None
               else getenv_int("DMLC_WORKER_ID", 0))
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=timedelta(seconds=300))
    return _dist.init(device, store=store, rank=rank, world_size=world)


def _world() -> Tuple[int, int]:
    """(rank, world size) of the group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class _GlobalCollectives:
    """The store's collectives over the default process group."""

    def __init__(self):
        self.rank, self.nproc = _world()

    def allreduce(self, v: torch.Tensor) -> torch.Tensor:
        """The sum of ``v`` over ranks (a new tensor)."""
        out = v.clone()
        if self.nproc > 1:
            dist.all_reduce(out)
        return out

    def allgather(self, v: torch.Tensor) -> torch.Tensor:
        """Every rank's ``v`` stacked in rank order, ``(nproc,
        *v.shape)``."""
        v = v.contiguous()
        if self.nproc == 1:
            return v[None].clone()
        parts = [torch.empty_like(v) for _ in range(self.nproc)]
        dist.all_gather(parts, v)
        return torch.stack(parts)

    def broadcast(self, v: torch.Tensor, src: int = 0) -> torch.Tensor:
        out = v.clone().contiguous()
        if self.nproc > 1:
            dist.broadcast(out, src)
        return out

    def allreduce_rowsparse_batch(self, items):
        """The row-sparse sum over ranks of every ``(indices, values)``
        of one push, never dense (``mxnet_tpu/kvstore/dist.py:124-188``):
        one all-gather of every key's row count, then for each values
        dtype one all-gather of the keys' indices (int32, padded with -1
        to the largest count) and one of their flattened values (padded
        with 0).  The gathered rows are summed by id in rank order
        (``ndarray.sparse.segment_sum``).  Returns ``([(indices,
        values)], payload bytes)``."""
        from ..ndarray.sparse import segment_sum
        dev = items[0][1].device
        counts = self.allgather(torch.tensor(
            [int(i.shape[0]) for i, _ in items], dtype=torch.int32,
            device=dev)).cpu().numpy()
        budgets = counts.reshape(self.nproc, len(items)).max(axis=0)
        out = [None] * len(items)
        payload = int(counts.nbytes)
        by_dtype: Dict[torch.dtype, list] = {}
        for j, (idx, vals) in enumerate(items):
            if budgets[j] == 0:
                out[j] = (idx.new_zeros((0,), dtype=torch.int64),
                          vals.new_zeros((0,) + tuple(vals.shape[1:])))
                continue
            by_dtype.setdefault(vals.dtype, []).append(j)
        for js in by_dtype.values():
            idx_pads, val_pads = [], []
            for j in js:
                idx, vals = items[j]
                B, n = int(budgets[j]), int(idx.shape[0])
                rowsz = int(onp.prod(vals.shape[1:])) if vals.dim() > 1 \
                    else 1
                ip = torch.full((B,), -1, dtype=torch.int32, device=dev)
                ip[:n] = idx.to(torch.int32)
                vp = vals.new_zeros((B * rowsz,))
                vp[:n * rowsz] = vals.reshape(-1)
                idx_pads.append(ip)
                val_pads.append(vp)
            all_idx = self.allgather(torch.cat(idx_pads))
            all_val = self.allgather(torch.cat(val_pads))
            payload += all_idx.numel() * all_idx.element_size() \
                + all_val.numel() * all_val.element_size()
            io = vo = 0
            for j in js:
                idx, vals = items[j]
                B = int(budgets[j])
                row_shape = tuple(vals.shape[1:])
                rowsz = int(onp.prod(row_shape)) if row_shape else 1
                g_idx = all_idx[:, io:io + B].reshape(-1)
                g_val = all_val[:, vo:vo + B * rowsz].reshape(
                    (self.nproc * B,) + row_shape)
                io += B
                vo += B * rowsz
                live = g_idx >= 0
                out[j] = segment_sum(g_val[live], g_idx[live])
        return out, payload


@KVStoreBase.register
class DistKVStore(KVStoreBase):
    """The ``dist_sync`` / ``dist_device_sync`` / ``dist_async`` store
    (see the module docstring)."""

    def __init__(self, name: str = "dist_sync"):
        self.type = name
        init_distributed()
        self._data: Dict[Any, Any] = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        self._rank, self._nproc = _world()
        # the store knows this process's rank: the checkpoint's commit
        # barrier and clustermon's stamps take it from here
        from .. import checkpoint as _ckpt
        from .. import clustermon as _cmon
        _ckpt.set_rank(self._rank, self._nproc)
        _cmon.note_rank(self._rank, self._nproc)
        self._coll: Optional[_GlobalCollectives] = None
        # ZeRO-1: each key's state on this rank's slice
        self._opt_states: Dict[Any, tuple] = {}
        self._sparse_opt_states: Dict[Any, tuple] = {}
        self._key_index: Dict[Any, int] = {}
        self._async = name == "dist_async"
        self._staleness_bound = max(
            1, getenv_int("MXNET_ASYNC_STALENESS_BOUND", 16))
        self._async_pushes = 0
        self._uncoordinated = self._async and os.environ.get(
            "MXNET_ASYNC_UNCOORDINATED", "0") not in ("0", "")
        self._ps_server = None
        self._ps_client = None
        # the last push's bytes: packed codes against f32, sparse
        # payload against the dense gradients
        self.last_compressed = None
        self.last_sparse_comm = None
        if self._uncoordinated:
            self._init_ps()

    def _init_ps(self):
        from .ps_server import ParamServer, PSClient
        addr = os.environ.get("MXNET_PS_ADDR")
        if self._rank == 0:
            # one server a process: a second dist_async store reuses it
            global _PS_SERVER, _PS_ADDR
            if _PS_SERVER is None:
                host, port = ("127.0.0.1", 0)
                if addr:
                    host, port = addr.rsplit(":", 1)
                    port = int(port)
                _PS_SERVER = ParamServer(host, port)
                _PS_ADDR = addr or _PS_SERVER.address
                import atexit
                atexit.register(_PS_SERVER.stop)
            self._ps_server = _PS_SERVER
            addr = _PS_ADDR
        elif not addr:
            raise MXNetError(
                "uncoordinated dist_async with >1 process needs "
                "MXNET_PS_ADDR=host:port shared by all ranks")
        self._ps_client = PSClient(addr)
        self._ps_client.hello(self._rank)   # liveness

    def get_num_dead_node(self, node_id=0, timeout=60) -> int:
        """Dead workers: in uncoordinated mode the server's count of
        distinct connected worker ranks, subtracted from the world (a
        dead process closes its socket; a lost host is reaped by TCP
        keepalive); 0 for the collective stores, which have no
        heartbeat."""
        if self._uncoordinated:
            ranks = self._ps_client.alive_ranks()
            alive = len([r for r in ranks if 0 <= r < self._nproc])
            return max(0, self._nproc - alive)
        return 0

    @staticmethod
    def is_capable(capability: str) -> bool:
        return True

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def num_workers(self) -> int:
        return self._nproc

    def _collectives(self) -> _GlobalCollectives:
        if self._coll is None:
            self._coll = _GlobalCollectives()
        return self._coll

    def _allreduce(self, value: NDArray) -> NDArray:
        if self._nproc == 1:
            return value
        telemetry.record_comm_bytes(payload_nbytes(value), "dense")
        return NDArray._wrap(self._collectives().allreduce(value._data))

    # -- ZeRO-1 slices -------------------------------------------------------
    def _slice_bounds(self, n: int) -> Tuple[int, int, int]:
        """(lo, hi, chunk) of this rank's flat slice of an n-element
        weight; chunk is the padded size every rank gathers."""
        chunk = -(-n // self._nproc)
        lo = min(n, self._rank * chunk)
        hi = min(n, lo + chunk)
        return lo, hi, chunk

    def _update_own_slice(self, k, grad_flat) -> tuple:
        """The optimizer on this rank's slice of key ``k``: ``(new slice,
        shape, dtype, n, lo, hi, chunk)``."""
        weight = self._data[k]
        shape, dtype = weight.shape, weight._data.dtype
        n = int(onp.prod(shape)) if shape else 1
        lo, hi, chunk = self._slice_bounds(n)
        w_slice = NDArray._wrap(weight._data.reshape(-1)[lo:hi].clone())
        g_slice = NDArray._wrap(grad_flat[lo:hi])
        idx = self._key_index.setdefault(k, len(self._key_index))
        if k not in self._opt_states:
            self._opt_states[k] = self._optimizer.create_state(idx, w_slice)
        self._optimizer.update(idx, w_slice, g_slice, self._opt_states[k])
        return w_slice._data, shape, dtype, n, lo, hi, chunk

    def _gather_shards(self, items):
        """One all-gather a dtype rebuilding whole weights from the
        ranks' slices; ``items``: ``(k, slice, shape, dtype, n, lo, hi,
        chunk)``."""
        from .. import profiler
        by_dtype: Dict[torch.dtype, list] = {}
        for it in items:
            by_dtype.setdefault(it[1].dtype, []).append(it)
        for group in by_dtype.values():
            padded = []
            for (_, sl, shape, dtype, n, lo, hi, chunk) in group:
                p = sl.new_zeros((chunk,))
                p[: hi - lo] = sl
                padded.append(p)
            cat = torch.cat(padded) if len(padded) > 1 else padded[0]
            t0 = profiler.op_timer()
            gathered = self._collectives().allgather(cat)   # (nproc, tot)
            profiler.op_record("kvstore_fused_allgather", t0)
            telemetry.record_comm_bytes(payload_nbytes(cat), "dense")
            off = 0
            for (k, sl, shape, dtype, n, lo, hi, chunk) in group:
                full = gathered[:, off:off + chunk].reshape(-1)[:n]
                self._data[k] = NDArray._wrap(full.reshape(shape).to(dtype))
                off += chunk

    def _sharded_update_batch(self, kv):
        """The server's optimizer as weight-update sharding: every key
        of the push updates this rank's slice, one all-gather a dtype
        rebuilds them."""
        items = []
        for k, reduced in kv:
            sl, shape, dtype, n, lo, hi, chunk = self._update_own_slice(
                k, reduced._data.reshape(-1))
            if self._nproc == 1:
                self._data[k] = NDArray._wrap(sl.reshape(shape).to(dtype))
            else:
                items.append((k, sl, shape, dtype, n, lo, hi, chunk))
        if items:
            self._gather_shards(items)

    # -- dist_async: stale-synchronous over the slices -----------------------
    def _async_apply(self, kv):
        """This rank's own gradient on its own slice, at once: no
        collective; every K-th push call a rendezvous."""
        for k, local in kv:
            sl, shape, dtype, n, lo, hi, _ = self._update_own_slice(
                k, local._data.reshape(-1))
            flat = self._data[k]._data.reshape(-1).clone()
            flat[lo:hi] = sl
            self._data[k] = NDArray._wrap(flat.reshape(shape).to(dtype))
        self._async_pushes += 1
        if self._nproc > 1 and \
                self._async_pushes % self._staleness_bound == 0:
            self._async_reconcile()

    def reconcile(self):
        """The stale-synchronous rendezvous now (a collective: call it on
        every rank), after the last push, so that the tail window leaves
        no replica behind.  Nothing for sync stores, one rank, or the
        uncoordinated mode (the server holds the one copy: pull it)."""
        if self._uncoordinated:
            return
        if self._async and self._nproc > 1 and self._opt_states:
            self._async_reconcile()

    def _async_reconcile(self):
        items = []
        for k in self._opt_states:
            weight = self._data[k]
            shape, dtype = weight.shape, weight._data.dtype
            n = int(onp.prod(shape)) if shape else 1
            lo, hi, chunk = self._slice_bounds(n)
            sl = weight._data.reshape(-1)[lo:hi]
            items.append((k, sl, shape, dtype, n, lo, hi, chunk))
        if items:
            self._gather_shards(items)

    # -- row-sparse -----------------------------------------------------------
    def _sparse_allreduce_batch(self, values):
        """The ranks' row-sparse values summed at nnz wire cost, every
        key of the push in the same collectives; ``last_sparse_comm``
        keeps the payload against what dense gradients would move."""
        from .. import profiler
        from ..ndarray.sparse import RowSparseNDArray
        dense_bytes = sum(_dense_bytes(v) for v in values)
        if self._nproc == 1:
            self.last_sparse_comm = {"payload_bytes": 0,
                                     "dense_bytes": dense_bytes}
            return list(values)
        t0 = profiler.op_timer()
        merged, payload = self._collectives().allreduce_rowsparse_batch(
            [(v.indices, v.data) for v in values])
        profiler.op_record("kvstore_sparse_allgather", t0)
        telemetry.record_comm_bytes(int(payload), "sparse")
        self.last_sparse_comm = {"payload_bytes": int(payload),
                                 "dense_bytes": dense_bytes}
        _count_rows("embedding.rows_pushed", sum(v.nnz for v in values),
                    payload, dense_bytes)
        return [RowSparseNDArray(vals, idx, tuple(v.shape))
                for v, (idx, vals) in zip(values, merged)]

    def _sparse_update(self, k, rsp):
        """The server's optimizer on a row-sparse-reduced key: every rank
        applies the same rows to its whole replica through the lazy
        update; the state stays whole (a flat slice would cut rows)."""
        idx = self._key_index.setdefault(k, len(self._key_index))
        weight = self._data[k]
        if _is_rsp(weight):
            # an optimizer set after pure-reduce pushes: a dense weight
            weight = self._data[k] = weight.todense()
        if k not in self._sparse_opt_states:
            self._sparse_opt_states[k] = \
                self._optimizer.create_state_multi_precision(idx, weight)
        self._optimizer.update_multi_precision(idx, weight, rsp,
                                               self._sparse_opt_states[k])

    # -- compression ----------------------------------------------------------
    def _compressed_allreduce(self, k, local: NDArray) -> NDArray:
        comp = self._compression
        packed, meta = comp.compress_packed(k, local)
        self.last_compressed["packed_bytes"] += payload_nbytes(packed)
        self.last_compressed["dense_bytes"] += payload_nbytes(local)
        if self._nproc == 1:
            return NDArray._wrap(comp.dequantize(packed, meta))
        telemetry.record_comm_bytes(payload_nbytes(packed), "compressed")
        all_packed = self._collectives().allgather(packed)
        total = None
        for r in range(self._nproc):
            deq = comp.dequantize(all_packed[r], meta)
            total = deq if total is None else total + deq
        return NDArray._wrap(total)

    def init(self, key, value):
        keys = key if isinstance(key, (list, tuple)) else [key]
        vals = value if isinstance(value, (list, tuple)) else [value]
        for k, v in zip(keys, vals):
            self._data[k] = v.copy()
            if self._uncoordinated:
                self._ps_client.init(k, v.asnumpy())  # the first init wins

    def _batched_allreduce(self, kv):
        """Every key of one push in one sum collective a dtype; under AMP
        float gradients wider than the compute dtype travel in it."""
        from .. import profiler
        from ..amp import policy as _amp_policy
        if self._nproc == 1:
            return kv
        wire_dt = (_amp_policy.compute_dtype() if _amp_policy.enabled()
                   else None)

        def wire(dt: torch.dtype) -> torch.dtype:
            if wire_dt is not None and dt.is_floating_point and \
                    dt.itemsize > wire_dt.itemsize:
                return wire_dt
            return dt
        by_dtype: Dict[torch.dtype, list] = {}
        for i, (k, v) in enumerate(kv):
            by_dtype.setdefault(wire(v._data.dtype), []).append(i)
        out = list(kv)
        for dt, idxs in by_dtype.items():
            flats = [kv[i][1]._data.reshape(-1).to(dt) for i in idxs]
            cat = torch.cat(flats) if len(flats) > 1 else flats[0]
            t0 = profiler.op_timer()
            red = self._collectives().allreduce(cat)
            profiler.op_record("kvstore_fused_allreduce", t0)
            telemetry.record_comm_bytes(payload_nbytes(cat), "dense")
            off = 0
            for i in idxs:
                k, v = kv[i]
                n = v._data.numel()
                out[i] = (k, NDArray._wrap(red[off:off + n].reshape(v.shape)
                                           .to(v._data.dtype)))
                off += n
        return out

    def push(self, key, value, priority=0):
        tok = telemetry.begin_step()
        b0 = telemetry.counter("comm.bytes").value
        try:
            with tracing.span("comm.push") as sp:
                self._push(key, value, priority)
                sp.annotate(payload_nbytes=telemetry.counter(
                    "comm.bytes").value - b0)
        finally:
            telemetry.end_step(tok, "kvstore")

    def _push(self, key, value, priority=0):
        from ..ndarray.sparse import reduce_list
        keys = key if isinstance(key, (list, tuple)) else [key]
        if len(keys) == 1:
            value = [value]
        kv = []
        for k, v in zip(keys, value):
            local = v
            if isinstance(v, (list, tuple)):
                if all(_is_rsp(x) for x in v):
                    local = reduce_list(list(v))
                else:
                    local = NDArray._wrap(sum(
                        (_dense(x)._data for x in v[1:]),
                        _dense(v[0])._data))
            kv.append((k, local))

        if self._uncoordinated:
            # one-sided: each gradient goes to the server and is applied
            # on arrival.  The server's optimizer is required: without it
            # a pull would return the running sum of gradients.
            if self._optimizer is None:
                raise MXNetError(
                    "uncoordinated dist_async needs the server-side "
                    "optimizer (update_on_kvstore=True); do not disable "
                    "update_on_kvstore in this mode")
            if self._compression is not None:
                raise MXNetError(
                    "gradient compression is not supported on the "
                    "uncoordinated dist_async path")
            for k, v in kv:
                telemetry.record_comm_bytes(payload_nbytes(v), "ps")
                if _is_rsp(v):
                    # only (indices, values) travel
                    _count_rows("embedding.rows_pushed", v.nnz,
                                payload_nbytes(v), _dense_bytes(v))
                    self._ps_client.push_sparse(
                        k, v.indices.cpu().numpy(), _host(v.data),
                        tuple(v.shape))
                else:
                    self._ps_client.push(k, _host(v._data))
            return

        # row-sparse on the plain sync path sums sparsely; the async and
        # compressed paths ride dense buffers, where a sparse value is
        # made dense (the storage-fallback log).  Split by entry, not by
        # key, so a push carrying a dense and a sparse gradient of one
        # key loses neither.
        sparse_ok = self._compression is None and not self._async
        sparse_pos = [i for i, (_, v) in enumerate(kv)
                      if sparse_ok and _is_rsp(v)]
        sparse_kv = [kv[i] for i in sparse_pos]
        taken = set(sparse_pos)
        kv = [(k, _dense(v)) for i, (k, v) in enumerate(kv)
              if i not in taken]
        if sparse_kv:
            from ..ndarray.sparse import _log_storage_fallback
            reduced = self._sparse_allreduce_batch(
                [v for _, v in sparse_kv])
            densified_batch = []
            for (k, _), r in zip(sparse_kv, reduced):
                if self._optimizer is not None and k in self._data:
                    if k in self._opt_states:
                        # the key's state is already sliced by dense
                        # pushes: a second, whole state would fork the
                        # trajectory, so this gradient joins the slices
                        _log_storage_fallback(
                            f"sparse push on dense-stated key {k!r} "
                            "joins the ZeRO-sliced update")
                        densified_batch.append((k, r.todense()))
                    else:
                        self._sparse_update(k, r)
                elif self._updater is not None and k in self._data:
                    self._updater(_key_int(k), r, self._data[k])
                elif self._optimizer is not None or \
                        self._updater is not None:
                    # a push before init under an optimizer: adopt it
                    # dense, so the next push updates a real weight
                    self._data[k] = r.todense()
                else:
                    self._data[k] = r     # pure reduce: stays sparse
            if densified_batch:
                self._sharded_update_batch(densified_batch)
        if not kv:
            return

        if self._async and self._optimizer is not None and \
                all(k in self._data for k, _ in kv):
            self._async_apply(kv)       # no collective here
            return

        if self._compression is not None:
            self.last_compressed = {"packed_bytes": 0, "dense_bytes": 0}
            reduced_kv = [(k, self._compressed_allreduce(k, v))
                          for k, v in kv]
        else:
            reduced_kv = self._batched_allreduce(kv)

        if self._optimizer is not None:
            batch = [(k, r) for k, r in reduced_kv if k in self._data]
            rest = [(k, r) for k, r in reduced_kv if k not in self._data]
            # keys whose state is whole from sparse pushes keep that one
            # state for dense gradients too
            full = [(k, r) for k, r in batch if k in self._sparse_opt_states]
            batch = [(k, r) for k, r in batch
                     if k not in self._sparse_opt_states]
            for k, r in full:
                idx = self._key_index.setdefault(k, len(self._key_index))
                self._optimizer.update_multi_precision(
                    idx, self._data[k], r, self._sparse_opt_states[k])
            self._sharded_update_batch(batch)
            for k, r in rest:
                self._data[k] = r
        else:
            for k, r in reduced_kv:
                if self._updater is not None and k in self._data:
                    self._updater(_key_int(k), r, self._data[k])
                else:
                    self._data[k] = r

    @torch.no_grad()
    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys = key if isinstance(key, (list, tuple)) else [key]
        outs = out if isinstance(out, (list, tuple)) else [out]
        for k, o in zip(keys, outs):
            if self._uncoordinated:
                t = torch.from_numpy(onp.array(self._ps_client.pull(k)))
                dev = self._data[k]._data.device if k in self._data \
                    else t.device
                val = self._data[k] = NDArray._wrap(t.to(dev))
            else:
                val = self._data[k]
            for t in (o if isinstance(o, (list, tuple)) else [o]):
                if t is None:
                    continue
                if _is_rsp(t):
                    val.copyto(t)
                else:
                    t._data.copy_(_dense(val)._data)
        return out

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """The rows ``row_ids`` of a key: in uncoordinated mode only
        those rows travel (the server's ``pull_rows``); in the collective
        modes the local replica is sliced."""
        from ..ndarray.sparse import RowSparseNDArray
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        rows = _row_ids(row_ids)
        if self._uncoordinated:
            if key not in self._data:
                raise MXNetError(f"row_sparse_pull: unknown key {key!r} "
                                 "(init it first)")
            n = self._data[key].shape[0]
            if len(rows) and (rows[0] < 0 or rows[-1] >= n):
                raise MXNetError(
                    f"row_sparse_pull: row ids out of range for key "
                    f"{key!r} with {n} rows")
            vals = torch.from_numpy(onp.array(
                self._ps_client.pull_rows(key, rows)))
            dev = self._data[key]._data.device
            rsp = RowSparseNDArray(vals.to(dev), torch.as_tensor(
                rows, device=dev), tuple(self._data[key].shape))
        else:
            full = _dense(self._data[key])._data
            if len(rows) and (rows[0] < 0 or rows[-1] >= full.shape[0]):
                raise MXNetError(
                    f"row_sparse_pull: row_ids out of range for key "
                    f"{key!r} with {full.shape[0]} rows")
            idx = torch.as_tensor(rows, device=full.device)
            rsp = RowSparseNDArray(full.index_select(0, idx), idx,
                                   tuple(full.shape))
        _count_rows("embedding.rows_pulled", len(rows), payload_nbytes(rsp),
                    _dense_bytes(rsp))
        if out is not None:
            rsp.copyto(out)
            return out
        return rsp

    def pushpull(self, key, value, out=None, priority=0):
        tok = telemetry.begin_step()
        b0 = telemetry.counter("comm.bytes").value
        try:
            with tracing.span("comm.pushpull") as sp:
                self._push(key, value, priority)
                if out is not None:
                    self.pull(key, out, priority)
                sp.annotate(payload_nbytes=telemetry.counter(
                    "comm.bytes").value - b0)
                return out
        finally:
            telemetry.end_step(tok, "kvstore")

    def broadcast(self, key, value, out, priority=0):
        """Rank 0's value to every rank."""
        v = value if isinstance(value, NDArray) else value[0]
        if self._uncoordinated:
            if self._nproc > 1:
                v = NDArray._wrap(self._collectives().broadcast(v._data))
            self._data[key] = v
            # rank 0 overwrites (a re-broadcast, e.g. a checkpoint load,
            # must replace the server's copy); the others only register
            # the key, or a straggler's set would undo applied pushes
            if self._rank == 0:
                self._ps_client.set(key, v.asnumpy())
            else:
                self._ps_client.init(key, v.asnumpy())
            if out is not None:
                self.pull(key, out, priority)
            return
        if self._nproc > 1:
            self._data[key] = NDArray._wrap(
                self._collectives().broadcast(v._data))
        else:
            self.init(key, value)
        if out is not None:
            self.pull(key, out, priority)

    def barrier(self):
        if self._nproc > 1:
            dist.barrier()

    def send_command_to_servers(self, head, body=""):
        """The command on this process's server (not a collective: call
        it on every rank to reach every one); in uncoordinated mode it
        travels to the parameter server's process."""
        if self._uncoordinated:
            self._ps_client.command(str(head), str(body))
            return
        from .base import _run_server_command
        _run_server_command(head, body)

    def set_optimizer(self, optimizer):
        """``update_on_kvstore``: the optimizer runs inside the store on
        this rank's slices; in uncoordinated mode a copy goes to the
        server, with each parameter's lr/wd multipliers only."""
        from .. import optimizer as opt_mod
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(optimizer)
        self._optimizer = optimizer
        self._updater = opt_mod.get_updater(optimizer)
        if self._uncoordinated:
            import copy as _copy
            from .ps_server import ParamMults
            clean = _copy.copy(optimizer)
            clean.param_dict = {
                k: ParamMults(getattr(p, "lr_mult", 1.0),
                              getattr(p, "wd_mult", 1.0))
                for k, p in getattr(optimizer, "param_dict", {}).items()}
            self._ps_client.set_optimizer(clean)

    def set_gradient_compression(self, compression_params):
        from .gradient_compression import GradientCompression
        self._compression = GradientCompression(**compression_params)

    _ZERO_MAGIC = b"MXTPU-ZERO1\0"

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """The ZeRO slices' states (or the updater's) as the reference's
        npz: a magic, then ``mxnet_tpu-zero-states-v1`` — no pickle."""
        if self._optimizer is None and self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        import io
        import json
        with open(fname, "wb") as f:
            if self._opt_states:
                arrays, keys = {}, []
                for j, (k, st) in enumerate(self._opt_states.items()):
                    tup = st if isinstance(st, tuple) else (st,)
                    ent = {"key": k if isinstance(k, str) else int(k),
                           "str": isinstance(k, str), "slots": len(tup),
                           "dtypes": []}
                    for i, s in enumerate(tup):
                        d, name = numpy_bits(getattr(s, "_data", s))
                        ent["dtypes"].append(name)
                        arrays[f"s{j}::{i}"] = d
                    keys.append(ent)
                header = {"format": "mxnet_tpu-zero-states-v1",
                          "keys": keys}
                arrays["__header__"] = onp.frombuffer(
                    json.dumps(header).encode("utf-8"), dtype=onp.uint8)
                buf = io.BytesIO()
                onp.savez(buf, **arrays)
                f.write(self._ZERO_MAGIC)
                f.write(buf.getvalue())
            else:
                f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Restore :meth:`save_optimizer_states` (of either package);
        only the npz formats load (``allow_pickle=False``)."""
        if self._optimizer is None and self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        import io
        import json
        with open(fname, "rb") as f:
            blob = f.read()
        dev = next((v._data.device for v in self._data.values()
                    if isinstance(v, NDArray)), torch.device("cpu"))
        if not blob.startswith(self._ZERO_MAGIC):
            self._updater.set_states(blob, device=dev)
            return
        try:
            z = onp.load(io.BytesIO(blob[len(self._ZERO_MAGIC):]),
                         allow_pickle=False)
        except Exception as e:
            raise MXNetError(
                f"{fname}: ZeRO optimizer states are not in the "
                "mxnet_tpu-zero-states npz format (pickled states are "
                f"refused: loading a pickle can run arbitrary code): "
                f"{e}") from e
        with z:
            header = json.loads(bytes(z["__header__"]).decode("utf-8"))
            if header.get("format") != "mxnet_tpu-zero-states-v1":
                raise MXNetError(f"{fname}: unknown zero-states format "
                                 f"{header.get('format')!r}")
            out = {}
            for j, ent in enumerate(header["keys"]):
                k = str(ent["key"]) if ent.get("str") else int(ent["key"])
                dts = ent.get("dtypes") or []
                out[k] = tuple(
                    NDArray._wrap(tensor_from_bits(
                        z[f"s{j}::{i}"], dts[i] if i < len(dts) else None,
                        dev))
                    for i in range(int(ent["slots"])))
            self._opt_states = out


def _host(t: torch.Tensor):
    """A tensor for the parameter server's wire: a host numpy array, or,
    for a dtype numpy lacks (bfloat16), the host tensor, which the wire
    writes as the reference writes its numpy bfloat16."""
    t = t.detach().cpu()
    try:
        return t.numpy()
    except TypeError:
        return t
