"""``ShardedEmbedding``: one logical table, row-sharded over parameter
servers (counterpart of ``mxnet_tpu/embedding/sharded.py``).

Rows are routed by global id, ``mod`` (row r on shard ``r % S`` at local
row ``r // S``: spreads hot ids) or ``range`` (contiguous blocks: keeps
clustered ids together); both are pure functions of ``(rows, shards)``,
so any process routes any id without a directory, and a checkpoint
taken at one shard count restores at another.

A step's dataflow: ids → dedup → the hot-row cache (``hot_rows``) →
each shard's ``pull_rows`` (only the touched rows travel; ``device=``
moves the gathered block onto the caller's card in one copy) → dense
compute → the coalesced row-sparse gradient push (``push_sparse``; with
a ``GradientCompression`` attached the values travel as 2-bit codes,
``push_sparse_packed``, with a residual kept a row) → the shard's lazy
sparse optimizer.  Every payload is measured by
``kvstore.base.payload_nbytes`` and accounted by
``telemetry.record_embedding_wire`` (the sparse bytes also in
``comm.sparse.bytes``) beside the dense equivalent, the whole table.
The initial table (``_default_init``: a splitmix hash of (row, column,
seed)) is the reference's, bit for bit, at any shard count.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as onp

import torch

from .. import checkpoint as _ckpt
from .. import telemetry
from ..base import MXNetError, getenv
from ..kvstore.base import payload_nbytes
from ..ndarray.sparse import coalesce_rows

__all__ = ["ShardedEmbedding", "num_shards_env"]


def num_shards_env(default: int = 1) -> int:
    """Shard-count default: ``MXNET_EMB_SHARDS`` (>=1), read when a
    table is constructed without an explicit ``num_shards``."""
    try:
        return max(1, int(getenv("MXNET_EMB_SHARDS", str(default))
                          or default))
    except ValueError:
        return max(1, int(default))


# -- partitioning -----------------------------------------------------------

class _Partition:
    """Row-id -> (shard, local row) routing, a pure function of
    (kind, num_rows, num_shards)."""

    def __init__(self, kind: str, num_rows: int, num_shards: int):
        if kind not in ("mod", "range"):
            raise MXNetError(
                f"embedding partition must be 'mod' or 'range', "
                f"got {kind!r}")
        if num_shards < 1 or num_rows < 1:
            raise MXNetError("embedding needs num_rows>=1, num_shards>=1")
        self.kind = kind
        self.num_rows = int(num_rows)
        self.num_shards = int(num_shards)
        if kind == "range":
            base, rem = divmod(self.num_rows, self.num_shards)
            sizes = [base + (1 if s < rem else 0)
                     for s in range(self.num_shards)]
            self._starts = onp.cumsum([0] + sizes)[:-1]
            self._sizes = onp.asarray(sizes, onp.int64)

    def shard_of(self, rows: onp.ndarray) -> onp.ndarray:
        rows = onp.asarray(rows, onp.int64)
        if self.kind == "mod":
            return rows % self.num_shards
        return onp.searchsorted(self._starts, rows, side="right") - 1

    def local_of(self, rows: onp.ndarray) -> onp.ndarray:
        rows = onp.asarray(rows, onp.int64)
        if self.kind == "mod":
            return rows // self.num_shards
        return rows - self._starts[self.shard_of(rows)]

    def local_count(self, shard: int) -> int:
        if self.kind == "mod":
            n, s, S = self.num_rows, shard, self.num_shards
            return (n - s + S - 1) // S
        return int(self._sizes[shard])

    def global_of(self, shard: int, local: onp.ndarray) -> onp.ndarray:
        local = onp.asarray(local, onp.int64)
        if self.kind == "mod":
            return local * self.num_shards + shard
        return local + int(self._starts[shard])

    def spec(self) -> dict:
        return {"kind": self.kind, "num_rows": self.num_rows,
                "num_shards": self.num_shards}


def _default_init(global_rows: onp.ndarray, dim: int, seed: int,
                  dtype) -> onp.ndarray:
    """Deterministic per-ROW init (a splitmix-style integer hash of
    (row id, column, seed) mapped to uniform(-0.01, 0.01)): the fresh
    table is bitwise identical at ANY shard count, so 1-shard and
    2-shard tests/benches start from the same weights."""
    r = onp.asarray(global_rows, onp.uint64).reshape(-1, 1)
    c = onp.arange(dim, dtype=onp.uint64).reshape(1, -1)
    seed_mix = onp.uint64((int(seed) * 0x94D049BB133111EB)
                          & 0xFFFFFFFFFFFFFFFF)
    with onp.errstate(over="ignore"):    # uint64 wraparound is the hash
        x = (r * onp.uint64(0x9E3779B97F4A7C15)
             + c * onp.uint64(0xBF58476D1CE4E5B9)
             + seed_mix)
    x ^= x >> onp.uint64(30)
    x *= onp.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> onp.uint64(27)
    u = (x >> onp.uint64(11)).astype(onp.float64) / float(1 << 53)
    return ((u - 0.5) * 0.02).astype(dtype)


def _pack_2bit_np(q: onp.ndarray) -> Tuple[onp.ndarray, int]:
    """{-t, 0, +t} values -> 2-bit codes {0: zero, 1: +t, 2: -t}, 4 per
    byte — the numpy twin of ``gradient_compression._pack_2bit`` (the
    wire format is identical; ``ps_server._unpack_2bit_np`` reverses
    it).  Returns (packed uint8, n codes)."""
    flat = q.reshape(-1)
    codes = onp.where(flat > 0, 1, onp.where(flat < 0, 2, 0)
                      ).astype(onp.uint8)
    n = codes.size
    pad = (-n) % 4
    if pad:
        codes = onp.concatenate([codes, onp.zeros(pad, onp.uint8)])
    codes = codes.reshape(-1, 4)
    packed = (codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4)
              | (codes[:, 3] << 6))
    return packed, n


class ShardedEmbedding:
    """One logical ``(num_rows, dim)`` embedding table row-sharded
    across parameter-server shards.

    ``shards`` may be an explicit list of PS clients (anything with the
    ``PSClient`` surface: init/set/pull/pull_rows/push_sparse/
    push_sparse_packed/set_optimizer); when omitted, ``num_shards``
    in-process :class:`~mxnet_tpu_torch.kvstore.ps_server.ParamServer`
    threads are spun up and owned by this table (the threads-as-ranks
    harness tests and CI use) — ``close()`` shuts them down.

    ``hot_rows`` > 0 enables the worker-side deduplicated hot-row
    cache: recently pulled rows are kept locally and served without
    touching the wire; cold rows are evicted LRU back to the host/PS
    authority (``embedding.rows_spilled``), and a push invalidates the
    touched rows (the optimizer runs server-side, so the local copy is
    stale the moment the push lands).
    """

    def __init__(self, name: str, num_rows: int, dim: int,
                 num_shards: Optional[int] = None,
                 shards: Optional[Sequence[Any]] = None,
                 dtype: str = "float32", partition: str = "mod",
                 initializer=None, seed: int = 0,
                 compression=None, hot_rows: int = 0,
                 defer_init: bool = False):
        self.name = str(name)
        self.dim = int(dim)
        self.dtype = onp.dtype(dtype)
        self._key = f"emb/{self.name}"
        self._compression = compression
        self._owned_servers: List[Any] = []
        self._lock = threading.Lock()
        if shards is not None:
            num_shards = len(shards)
            self._shards = list(shards)
        else:
            num_shards = num_shards_env() if num_shards is None \
                else int(num_shards)
            self._shards = self._spawn_local_shards(num_shards)
        self.part = _Partition(partition, num_rows, num_shards)
        self.num_rows = self.part.num_rows
        self.num_shards = self.part.num_shards
        self._init_fn = initializer or (
            lambda rows: _default_init(rows, self.dim, seed, self.dtype))
        # per-shard residual for compressed pushes (error feedback must
        # be per table ROW — a push's row set varies, so the dense
        # compression path's per-key residual cannot carry it).  Host
        # memory, lazily allocated on the first compressed push.
        self._residuals: Dict[int, onp.ndarray] = {}
        # worker-side hot-row cache: global row id -> vector
        self._hot_capacity = int(hot_rows)
        self._hot: "OrderedDict[int, onp.ndarray]" = OrderedDict()
        if not defer_init:
            self.initialize()

    # -- setup --------------------------------------------------------------

    def _spawn_local_shards(self, num_shards: int) -> List[Any]:
        from ..kvstore.ps_server import ParamServer, PSClient
        clients = []
        for s in range(num_shards):
            srv = ParamServer("127.0.0.1", 0)
            cli = PSClient(srv.address)
            cli.hello(0)
            self._owned_servers.append(srv)
            clients.append(cli)
        return clients

    def initialize(self) -> None:
        """Materialize every shard's local subtable on its server
        (first-init-wins semantics, same as dense kvstore init)."""
        for s, cli in enumerate(self._shards):
            local_n = self.part.local_count(s)
            rows = self.part.global_of(
                s, onp.arange(local_n, dtype=onp.int64))
            cli.init(self._key, self._init_fn(rows))

    def set_optimizer(self, optimizer) -> None:
        """Ship the optimizer to every shard server (server-side lazy
        sparse updates — ``update_on_kvstore`` semantics)."""
        for cli in self._shards:
            cli.set_optimizer(optimizer)

    @property
    def table_nbytes(self) -> int:
        """Total parameter bytes of the logical table — what a DENSE
        push/pull would move, and the per-push dense-equivalent the
        ``embedding.dense_equiv_bytes`` counter accumulates."""
        return self.num_rows * self.dim * self.dtype.itemsize

    # -- sparse pull --------------------------------------------------------

    def pull_rows(self, row_ids, device=None):
        """Gather rows for ``row_ids`` (duplicates fine) as a dense
        ``(len(row_ids), dim)`` host block, or, given ``device``, as a
        tensor there (one copy of the block).  Only deduplicated rows
        not already hot travel on the wire."""
        if device is not None:
            out = torch.from_numpy(self.pull_rows(row_ids))
            return out.to(device) if torch.device(device).type != "cpu" \
                else out
        if isinstance(row_ids, torch.Tensor):
            row_ids = row_ids.cpu().numpy()
        ids = onp.asarray(row_ids, onp.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_rows):
            raise MXNetError(
                f"embedding {self.name!r}: row id out of range "
                f"[0, {self.num_rows})")
        uniq, inv = onp.unique(ids, return_inverse=True)
        gathered = onp.empty((uniq.size, self.dim), self.dtype)
        with self._lock:
            miss_mask = onp.ones(uniq.size, bool)
            if self._hot_capacity:
                for i, r in enumerate(uniq):
                    vec = self._hot.get(int(r))
                    if vec is not None:
                        gathered[i] = vec
                        miss_mask[i] = False
                        self._hot.move_to_end(int(r))
                telemetry.counter("embedding.cache_hits").inc(
                    int(uniq.size - miss_mask.sum()))
                telemetry.counter("embedding.cache_misses").inc(
                    int(miss_mask.sum()))
            need = uniq[miss_mask]
            if need.size:
                pulled = self._wire_pull(need)
                gathered[miss_mask] = pulled
                if self._hot_capacity:
                    self._hot_admit(need, pulled)
        return gathered[inv]

    def _wire_pull(self, uniq: onp.ndarray) -> onp.ndarray:
        out = onp.empty((uniq.size, self.dim), self.dtype)
        shard_ids = self.part.shard_of(uniq)
        wire_bytes = 0
        for s, cli in enumerate(self._shards):
            mask = shard_ids == s
            if not mask.any():
                continue
            local = self.part.local_of(uniq[mask])
            vals = onp.asarray(cli.pull_rows(self._key, local))
            out[mask] = vals.astype(self.dtype, copy=False)
            wire_bytes += payload_nbytes(vals) + local.size * 8
        telemetry.record_embedding_wire(
            rows_pulled=int(uniq.size), sparse_bytes=wire_bytes,
            dense_equiv_bytes=self.table_nbytes)
        return out

    def _hot_admit(self, rows: onp.ndarray, vals: onp.ndarray) -> None:
        """LRU admission (call with the lock held): newly pulled rows
        become hot; over capacity the COLDEST spill back to the host/PS
        authority (they are clean — pushes invalidate — so a spill is
        a drop, never a writeback)."""
        for r, v in zip(rows, vals):
            self._hot[int(r)] = v
            self._hot.move_to_end(int(r))
        evicted = 0
        while len(self._hot) > self._hot_capacity:
            self._hot.popitem(last=False)
            evicted += 1
        if evicted:
            telemetry.counter("embedding.cache_evictions").inc(evicted)
            telemetry.counter("embedding.rows_spilled").inc(evicted)

    # -- sparse push --------------------------------------------------------

    def push_grad(self, row_ids, grads) -> None:
        """Row-sparse gradient push: duplicate ids are coalesced
        client-side (sort + segment-sum — the wire then carries each
        row once), routed per shard, and applied by the shard server's
        lazy sparse optimizer (or accumulated when none is set).  With
        a ``GradientCompression`` attached the values block travels as
        2-bit codes with per-row residual error feedback."""
        if isinstance(row_ids, torch.Tensor):
            row_ids = row_ids.cpu().numpy()
        if isinstance(grads, torch.Tensor):
            grads = grads.detach().cpu().numpy()
        ids = onp.asarray(row_ids, onp.int64).reshape(-1)
        grads = onp.asarray(grads, self.dtype).reshape(ids.size, self.dim)
        if ids.size == 0:
            return
        if ids.min() < 0 or ids.max() >= self.num_rows:
            raise MXNetError(
                f"embedding {self.name!r}: row id out of range "
                f"[0, {self.num_rows})")
        uniq, summed = coalesce_rows(ids, grads)
        shard_ids = self.part.shard_of(uniq)
        wire_bytes = 0
        with self._lock:
            for s, cli in enumerate(self._shards):
                mask = shard_ids == s
                if not mask.any():
                    continue
                local = self.part.local_of(uniq[mask])
                vals = summed[mask]
                lshape = (self.part.local_count(s), self.dim)
                if self._compression is not None:
                    wire_bytes += self._push_compressed(
                        s, cli, local, vals, lshape)
                else:
                    cli.push_sparse(self._key, local, vals, lshape)
                    # the row-sparse payload: values and int32 indices
                    wire_bytes += payload_nbytes(vals) + local.size * 4
            if self._hot_capacity:
                # server-side optimizer makes local copies stale
                for r in uniq:
                    self._hot.pop(int(r), None)
        telemetry.record_embedding_wire(
            rows_pushed=int(uniq.size), sparse_bytes=wire_bytes,
            dense_equiv_bytes=self.table_nbytes)

    def _push_compressed(self, shard: int, cli, local: onp.ndarray,
                         vals: onp.ndarray, lshape) -> int:
        """2-bit quantize + pack the touched rows with per-row residual
        error feedback (the row-sparse twin of
        ``GradientCompression.compress_packed``), then
        ``push_sparse_packed``.  Returns wire bytes."""
        t = onp.asarray(self._compression.threshold, self.dtype)
        res = self._residuals.get(shard)
        if res is None:
            res = self._residuals[shard] = onp.zeros(lshape, self.dtype)
        acc = vals + res[local]
        q = onp.where(acc >= t, t,
                      onp.where(acc <= -t, -t,
                                onp.zeros((), self.dtype)))
        res[local] = acc - q
        packed, n = _pack_2bit_np(q)
        cli.push_sparse_packed(self._key, local, packed, n, lshape,
                               str(self.dtype), float(t))
        return payload_nbytes(packed) + local.size * 8

    # -- checkpointing ------------------------------------------------------

    def _shard_leaf(self, s: int, num_shards: Optional[int] = None) -> str:
        S = self.num_shards if num_shards is None else num_shards
        return f"{self.name}/shard-{s:05d}-of-{S:05d}"

    def save_checkpoint(self, directory: str, tag: str = "latest",
                        block: Optional[bool] = True):
        """Checkpoint every table shard as its OWN artifact through the
        checkpoint service: each shard's local subtable is one leaf →
        one manifest-listed, SHA-256-digested file, with the partition
        spec in the header so ANY shard count can restore it.  Returns
        the ``PendingSave`` handle."""
        tree = {}
        for s, cli in enumerate(self._shards):
            tree[self._shard_leaf(s)] = onp.asarray(cli.pull(self._key))
        header = {"embedding": {"name": self.name, "dim": self.dim,
                                "dtype": str(self.dtype),
                                **self.part.spec()}}
        return _ckpt.save(directory, tree, header=header, tag=tag,
                          block=block)

    def load_checkpoint(self, directory: str, tag: str = "latest") -> None:
        """Restore from a table checkpoint taken at ANY shard count:
        the saved shards (digest-verified by ``checkpoint.load``) are
        reassembled into the global table via the header's partition
        spec, re-partitioned onto THIS table's shards, and broadcast
        with ``set`` (overwrite semantics).  Residuals and the hot-row
        cache are cleared — they describe the pre-restore table."""
        got = _ckpt.load(directory, tag=tag)
        if got is None:
            raise MXNetError(
                f"embedding {self.name!r}: no checkpoint under "
                f"{directory}/{tag}")
        leaves, header = got
        spec = (header or {}).get("embedding")
        if not spec or spec.get("name") != self.name:
            raise MXNetError(
                f"embedding {self.name!r}: checkpoint header carries no "
                f"matching embedding spec (got {spec!r})")
        if (int(spec["num_rows"]), int(spec["dim"])) != \
                (self.num_rows, self.dim):
            raise MXNetError(
                f"embedding {self.name!r}: checkpoint table is "
                f"{spec['num_rows']}x{spec['dim']}, this table is "
                f"{self.num_rows}x{self.dim}")
        saved = _Partition(spec["kind"], int(spec["num_rows"]),
                           int(spec["num_shards"]))
        table = onp.empty((self.num_rows, self.dim),
                          onp.dtype(spec["dtype"]))
        for s in range(saved.num_shards):
            leaf = f"{self.name}/shard-{s:05d}-of-{saved.num_shards:05d}"
            if leaf not in leaves:
                raise MXNetError(
                    f"embedding {self.name!r}: checkpoint is missing "
                    f"shard leaf {leaf!r}")
            local = onp.asarray(leaves[leaf].numpy()
                                if isinstance(leaves[leaf], torch.Tensor)
                                else leaves[leaf])
            rows = saved.global_of(
                s, onp.arange(local.shape[0], dtype=onp.int64))
            table[rows] = local
        with self._lock:
            for s, cli in enumerate(self._shards):
                rows = self.part.global_of(
                    s, onp.arange(self.part.local_count(s),
                                  dtype=onp.int64))
                cli.set(self._key, table[rows].astype(self.dtype,
                                                      copy=False))
            self._residuals.clear()
            self._hot.clear()

    def dump(self) -> onp.ndarray:
        """Assemble the full global table on the host (tests/bench
        equality checks — NOT a step-path operation)."""
        table = onp.empty((self.num_rows, self.dim), self.dtype)
        for s, cli in enumerate(self._shards):
            rows = self.part.global_of(
                s, onp.arange(self.part.local_count(s), dtype=onp.int64))
            table[rows] = onp.asarray(cli.pull(self._key))
        return table

    # -- lifecycle ----------------------------------------------------------

    def hot_stats(self) -> dict:
        with self._lock:
            return {"capacity": self._hot_capacity,
                    "resident": len(self._hot)}

    def close(self) -> None:
        """Shut down owned in-process shard servers (no-op for
        externally provided clients)."""
        for srv in self._owned_servers:
            try:
                srv.stop()
            except Exception:
                pass
        self._owned_servers = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
