"""Host-side parameter server for uncoordinated ``dist_async``
(counterpart of ``mxnet_tpu/kvstore/ps_server.py``, wire for wire).

A push is applied on arrival, with no coupling between workers, so
ranks may push different numbers of times and never meet.  The server
is a thread of rank 0's process; each worker holds one socket
(:class:`PSClient`).  The optimizer runs on the server
(``update_on_kvstore``): a push carries a gradient, the server updates
its copy of the weight, a pull returns the weight.

The wire is the reference's fixed binary format, byte for byte, so each
package's client works against the other's server:

* a frame is ``<Q`` length, a flags byte (bit 0: an HMAC-SHA256 trailer
  follows), the payload, and the trailer iff flagged;
* the payload is ``PS2\\0``, an argument count and tagged arguments
  (none / str / int / int tuple / array / blob); an array is its numpy
  dtype name, its shape and its raw bytes — never pickled;
* the one opaque blob is ``set_optimizer``'s pickled optimizer, a
  trusted channel by design.  Across a trust boundary set
  ``MXNET_PS_HMAC_KEY``: every frame both ways is then signed and an
  unsigned or badly signed frame drops the peer before it is parsed.

The server keeps a lock a key, an optimizer instance a key (unpickled
from the latest blob; every instance shares one dict of per-index
update counts, and ``num_update`` follows the largest, so a schedule
sees the server's whole progress), liveness by ``hello`` (the distinct
connected ranks), row-sparse pushes (duplicate ids coalesced first:
``ndarray.sparse.coalesce_rows``) and packed 2-bit ones, and
``pull_rows``.  Values live in host numpy arrays and the optimizer runs
on CPU tensors: a server on the host is the design, not a fallback.  A
tensor of a type numpy lacks (bfloat16) travels as the reference's
numpy bfloat16 does and decodes into a torch tensor: the reference's
server takes it, the port's holds numpy values only and replies with an
error.
"""
from __future__ import annotations

import hashlib
import hmac as hmac_mod
import os
import pickle
import socket
import struct
import threading
from typing import Any, Dict, Optional

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["ParamServer", "PSClient", "ParamMults"]


def _host_nd(a: onp.ndarray):
    """An NDArray on the host over a copy of ``a`` (the server's values
    never go to a card)."""
    from ..ndarray.ndarray import NDArray
    return NDArray._wrap(torch.from_numpy(onp.array(a)))


class ParamMults:
    """Picklable stand-in for a Parameter in the server-shipped
    optimizer's param_dict: carries ONLY the per-parameter lr/wd
    multipliers (_get_lr/_get_wd read nothing else)."""

    __slots__ = ("lr_mult", "wd_mult")

    def __init__(self, lr_mult=1.0, wd_mult=1.0):
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult

    def __getstate__(self):
        return (self.lr_mult, self.wd_mult)

    def __setstate__(self, state):
        self.lr_mult, self.wd_mult = state


# -- transport v2: fixed binary framing ------------------------------------
#
# payload  := MAGIC(4) argc:u8 arg*
# arg      := NONE(0x00)
#           | STR(0x01)   len:u32 utf8
#           | INT(0x02)   i64
#           | INTS(0x03)  count:u32 i64*
#           | ARR(0x04)   dlen:u8 dtype-ascii ndim:u8 dims:i64* raw-bytes
#           | BLOB(0x05)  len:u32 raw       (opaque; see module doc)
#
# A frame on the socket is ``<Q`` total length, then a flags byte
# (bit 0: HMAC trailer present), the payload, and — iff flagged — a
# 32-byte HMAC-SHA256 trailer over the payload.  The length prefix
# covers flags+payload+trailer, so a key-presence mismatch between
# peers is REJECTED (MXNetError, peer dropped), never a stall waiting
# on bytes that are not coming.

_MAGIC = b"PS2\x00"
_T_NONE, _T_STR, _T_INT, _T_INTS, _T_ARR, _T_BLOB = range(6)


def _dtype_name(dt: onp.dtype) -> str:
    return dt.name          # 'float32', 'int64', 'bfloat16', ...


def _dtype_from_name(name: str):
    """The numpy dtype of a wire name; a type numpy lacks (bfloat16, the
    float8s) as the torch dtype, whose values then decode into a torch
    tensor."""
    try:
        return onp.dtype(name)
    except TypeError:
        dt = getattr(torch, name, None)
        if not isinstance(dt, torch.dtype):
            raise MXNetError(f"ps wire: unknown dtype {name!r}") from None
        return dt


def _encode_msg(args) -> bytes:
    parts = [_MAGIC, struct.pack("<B", len(args))]
    for a in args:
        if a is None:
            parts.append(struct.pack("<B", _T_NONE))
        elif isinstance(a, str):
            b = a.encode("utf-8")
            parts.append(struct.pack("<BI", _T_STR, len(b)))
            parts.append(b)
        elif isinstance(a, (int, onp.integer)):   # incl. bool
            parts.append(struct.pack("<Bq", _T_INT, int(a)))
        elif isinstance(a, bytes):
            parts.append(struct.pack("<BI", _T_BLOB, len(a)))
            parts.append(a)
        elif isinstance(a, (tuple, list)) and \
                all(isinstance(x, (int, onp.integer)) for x in a):
            parts.append(struct.pack("<BI", _T_INTS, len(a)))
            parts.append(struct.pack("<%dq" % len(a), *[int(x) for x in a]))
        elif isinstance(a, torch.Tensor):
            # a tensor travels as its numpy twin would; bfloat16 and the
            # float8s as their bits under their own names
            t = a.detach().cpu().contiguous()
            dname = str(t.dtype).replace("torch.", "").encode("ascii")
            parts.append(struct.pack("<BB", _T_ARR, len(dname)))
            parts.append(dname)
            parts.append(struct.pack("<B", t.dim()))
            if t.dim():
                parts.append(struct.pack("<%dq" % t.dim(), *t.shape))
            parts.append(t.view(torch.uint8).numpy().tobytes()
                         if t.numel() else b"")
        elif isinstance(a, onp.ndarray):
            arr = onp.asarray(a)     # tobytes() below emits C-order
                                     # (ascontiguousarray would promote
                                     # 0-dim arrays to 1-dim)
            dname = _dtype_name(arr.dtype).encode("ascii")
            parts.append(struct.pack("<BB", _T_ARR, len(dname)))
            parts.append(dname)
            parts.append(struct.pack("<B", arr.ndim))
            if arr.ndim:
                parts.append(struct.pack("<%dq" % arr.ndim, *arr.shape))
            parts.append(arr.tobytes())
        else:
            raise MXNetError(
                f"ps wire: unsupported argument type {type(a).__name__} "
                "(transport v2 carries only str/int/ints/ndarray/bytes)")
    return b"".join(parts)


def _decode_msg(payload: bytes):
    if payload[:4] != _MAGIC:
        raise MXNetError("ps wire: bad magic (not a v2 frame)")
    off = 4
    (argc,) = struct.unpack_from("<B", payload, off)
    off += 1
    out = []
    for _ in range(argc):
        (tag,) = struct.unpack_from("<B", payload, off)
        off += 1
        if tag == _T_NONE:
            out.append(None)
        elif tag == _T_STR:
            (n,) = struct.unpack_from("<I", payload, off)
            off += 4
            out.append(payload[off:off + n].decode("utf-8"))
            off += n
        elif tag == _T_INT:
            (v,) = struct.unpack_from("<q", payload, off)
            off += 8
            out.append(v)
        elif tag == _T_INTS:
            (n,) = struct.unpack_from("<I", payload, off)
            off += 4
            out.append(tuple(struct.unpack_from("<%dq" % n, payload, off)))
            off += 8 * n
        elif tag == _T_ARR:
            (dlen,) = struct.unpack_from("<B", payload, off)
            off += 1
            dt = _dtype_from_name(payload[off:off + dlen].decode("ascii"))
            off += dlen
            (ndim,) = struct.unpack_from("<B", payload, off)
            off += 1
            shape = struct.unpack_from("<%dq" % ndim, payload, off) \
                if ndim else ()
            off += 8 * ndim
            nbytes = int(onp.prod(shape, dtype=onp.int64)) * dt.itemsize \
                if ndim else dt.itemsize
            raw = payload[off:off + nbytes]
            if isinstance(dt, torch.dtype):
                arr = torch.frombuffer(bytearray(raw), dtype=torch.uint8) \
                    .view(dt).reshape(shape)
            else:
                arr = onp.frombuffer(raw, dtype=dt).reshape(shape).copy()
            out.append(arr)
            off += nbytes
        elif tag == _T_BLOB:
            (n,) = struct.unpack_from("<I", payload, off)
            off += 4
            out.append(payload[off:off + n])
            off += n
        else:
            raise MXNetError(f"ps wire: unknown tag {tag}")
    if off != len(payload):
        raise MXNetError("ps wire: trailing bytes in frame")
    return tuple(out)


def _unpack_2bit_np(packed: onp.ndarray, n: int, threshold: float,
                    dtype) -> onp.ndarray:
    """The numpy twin of ``gradient_compression._unpack_2bit``: 2-bit
    codes {0: zero, 1: +t, 2: -t}, 4 a byte, dequantized on the handler
    thread."""
    b = packed.reshape(-1, 1)
    codes = onp.concatenate(
        [(b >> 0) & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
        axis=1).reshape(-1)[:n]
    t = onp.asarray(threshold, dtype)
    return onp.where(codes == 1, t,
                     onp.where(codes == 2, -t,
                               onp.zeros((), dtype))).astype(dtype)


def _hmac_key() -> Optional[bytes]:
    k = os.environ.get("MXNET_PS_HMAC_KEY")
    return k.encode("utf-8") if k else None


def _send_msg(sock: socket.socket, args, key: Optional[bytes]) -> None:
    payload = _encode_msg(args)
    flags = 1 if key else 0
    trailer = hmac_mod.new(key, payload, hashlib.sha256).digest() \
        if key else b""
    body = struct.pack("<B", flags) + payload + trailer
    sock.sendall(struct.pack("<Q", len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket, key: Optional[bytes]):
    (n,) = struct.unpack("<Q", _recv_exact(sock, 8))
    if n < 1:
        raise MXNetError("ps wire: empty frame")
    body = _recv_exact(sock, n)
    flags = body[0]
    signed = bool(flags & 1)
    if signed != bool(key):
        raise MXNetError(
            "ps wire: HMAC configuration mismatch (one peer has "
            "MXNET_PS_HMAC_KEY set, the other does not)")
    if signed:
        if n < 33:
            raise MXNetError("ps wire: truncated HMAC frame")
        payload, digest = body[1:-32], body[-32:]
        want = hmac_mod.new(key, payload, hashlib.sha256).digest()
        if not hmac_mod.compare_digest(digest, want):
            raise MXNetError("ps wire: HMAC verification failed")
    else:
        payload = body[1:]
    try:
        return _decode_msg(payload)
    except MXNetError:
        raise
    except (struct.error, ValueError, UnicodeDecodeError,
            IndexError) as e:
        # malformed frame: surface as the class's error type so the
        # server drops the peer (and clients keep their MXNetError
        # contract) instead of an unhandled handler-thread death
        raise MXNetError(f"ps wire: malformed frame ({e})") from e


class ParamServer:
    """Threaded TCP parameter server applying pushes immediately.

    Concurrency: one handler thread per client connection; state is
    guarded by PER-KEY locks (plus a meta lock for registry/liveness),
    so pushes to different keys run in parallel.  Each key applies
    updates through its OWN optimizer instance hydrated from the latest
    ``set_optimizer`` blob — no shared mutable optimizer counters
    across handler threads."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address = "%s:%d" % self._sock.getsockname()
        self._hmac = _hmac_key()     # captured once at construction
        self._meta_lock = threading.Lock()
        self._key_locks: Dict[Any, threading.Lock] = {}
        self._store: Dict[Any, onp.ndarray] = {}
        self._states: Dict[Any, tuple] = {}
        self._push_counts: Dict[Any, int] = {}
        self._opt_blob: Optional[bytes] = None
        self._optimizers: Dict[Any, Any] = {}
        # reference-parity step accounting across per-key instances:
        # ONE _index_update_count dict shared by every instance (the
        # reference's single server optimizer keeps per-index counts in
        # one place), and num_update = max across keys, synced through
        # _global_num_update so lr_schedulers see GLOBAL steps
        self._shared_counts: Dict[Any, int] = {}
        self._global_num_update = 0
        # liveness: per-rank connection refcounts (parity: ps-lite
        # heartbeats behind kvstore.h:408 get_num_dead_node).  Process
        # death closes the socket and drops the rank; kernel TCP
        # keepalive (set per-connection below) eventually reaps
        # half-open connections after a host crash/partition
        self._rank_refs: Dict[int, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _key_lock(self, key) -> threading.Lock:
        with self._meta_lock:
            lock = self._key_locks.get(key)
            if lock is None:
                lock = self._key_locks[key] = threading.Lock()
            return lock

    def _key_optimizer(self, key):
        """This key's optimizer instance (hydrated lazily from the
        latest blob).  Call with the key's lock held."""
        while True:
            with self._meta_lock:
                blob = self._opt_blob
                opt = self._optimizers.get(key)
            if opt is not None or blob is None:
                return opt
            # pickle hydration: trusted-local channel (module
            # docstring); HMAC (when configured) authenticated the
            # frame that carried it.  Hydrate OUTSIDE the meta lock
            # (unpickle can be slow), then install only if the blob is
            # still current — a concurrent set_optimizer swap restarts
            # the loop so a stale-blob instance can never stick.
            opt = pickle.loads(blob)
            with self._meta_lock:
                if self._opt_blob is blob:
                    opt._index_update_count = self._shared_counts
                    opt.num_update = self._global_num_update
                    return self._optimizers.setdefault(key, opt)

    # -- server side -------------------------------------------------------
    def _serve(self):
        self._sock.settimeout(0.2)
        clients = []
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._client_loop, args=(conn,),
                                 daemon=True)
            t.start()
            clients.append(t)
        self._sock.close()

    def _client_loop(self, conn: socket.socket):
        try:
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPIDLE, 30)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPINTVL, 10)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_KEEPCNT, 3)
        except (OSError, AttributeError):
            pass  # keepalive is best-effort (platform-dependent)
        rank = [None]
        try:
            while not self._stop.is_set():
                try:
                    msg = _recv_msg(conn, self._hmac)
                except (ConnectionError, EOFError, OSError):
                    return
                except MXNetError:
                    return      # bad magic / failed HMAC: drop the peer
                if msg[0] == "hello":
                    rank[0] = int(msg[1])
                    with self._meta_lock:
                        self._rank_refs[rank[0]] = \
                            self._rank_refs.get(rank[0], 0) + 1
                    _send_msg(conn, ("ok",), self._hmac)
                    continue
                reply = self._handle(msg)
                _send_msg(conn, reply, self._hmac)
        finally:
            with self._meta_lock:
                if rank[0] is not None:
                    self._rank_refs[rank[0]] -= 1
                    if self._rank_refs[rank[0]] <= 0:
                        del self._rank_refs[rank[0]]
            conn.close()

    def _handle(self, msg):
        op = msg[0]
        try:
            if op == "init":
                _, key, val = msg
                with self._key_lock(key):
                    # first init wins (parity: server Init handler)
                    self._store.setdefault(key, onp.array(val))
                return ("ok",)
            if op == "set":
                # explicit overwrite (broadcast of new values, e.g.
                # loading a checkpoint mid-run — init's setdefault must
                # not leave the server copy stale)
                _, key, val = msg
                with self._key_lock(key):
                    self._store[key] = onp.array(val)
                return ("ok",)
            if op == "push":
                _, key, grad = msg
                with self._key_lock(key):
                    self._apply_push(key, onp.asarray(grad))
                return ("ok",)
            if op == "push_sparse":
                # row_sparse gradient: only (indices, values) traveled;
                # the optimizer's lazy kernel touches only those rows
                _, key, indices, values, shape = msg
                with self._key_lock(key):
                    self._apply_push_sparse(key, onp.asarray(indices),
                                            onp.asarray(values),
                                            tuple(shape))
                return ("ok",)
            if op == "push_sparse_packed":
                # gradient-compressed row_sparse push: the values block
                # traveled as 2-bit codes (4/byte) — dequantize to
                # {-t, 0, +t} server-side, then the normal sparse apply.
                # Residual error feedback lives CLIENT-side (same
                # protocol as the dense compressed path).
                _, key, indices, packed, n, shape, dtype, thr = msg
                values = _unpack_2bit_np(
                    onp.asarray(packed, onp.uint8), int(n),
                    float(onp.asarray(thr)), _dtype_from_name(dtype))
                shape = tuple(shape)
                values = values.reshape((-1,) + shape[1:])
                with self._key_lock(key):
                    self._apply_push_sparse(key, onp.asarray(indices),
                                            values, shape)
                return ("ok",)
            if op == "pull":
                _, key = msg
                with self._key_lock(key):
                    if key not in self._store:
                        return ("err", f"pull: unknown key {key!r}")
                    return ("ok", self._store[key])
            if op == "pull_rows":
                # sparse row pull: only the requested rows travel
                # (parity: kvstore_dist.h:559 sparse row pulls)
                _, key, rows = msg
                with self._key_lock(key):
                    if key not in self._store:
                        return ("err", f"pull_rows: unknown key {key!r}")
                    return ("ok", self._store[key][onp.asarray(rows)])
            if op == "set_optimizer":
                _, payload = msg
                blob = bytes(payload)
                # hyperparameter refresh must not reset step counts:
                # every instance shares _shared_counts (graft is just a
                # reference), and num_update continues from the global
                # max.  The whole swap happens atomically under the
                # meta lock so a concurrent push can never hydrate a
                # zero-count instance from a half-swapped state.
                with self._meta_lock:
                    self._opt_blob = blob
                    fresh = {}
                    for k in self._optimizers:
                        new = pickle.loads(blob)
                        new._index_update_count = self._shared_counts
                        new.num_update = self._global_num_update
                        fresh[k] = new
                    self._optimizers = fresh
                return ("ok",)
            if op == "push_count":
                _, key = msg
                with self._key_lock(key):
                    return ("ok", self._push_counts.get(key, 0))
            if op == "num_alive":
                with self._meta_lock:
                    return ("ok", tuple(sorted(self._rank_refs)))
            if op == "command":
                # remote server command (parity: kvstore.h:440
                # SetServerProfilerCommand / CommandHandle): runs in the
                # SERVER's process, so a worker can e.g. start/dump the
                # profiler of the rank hosting the server
                _, head, body = msg
                from .base import _run_server_command
                _run_server_command(head, body)
                return ("ok",)
            if op == "shutdown":
                self._stop.set()
                return ("ok",)
            return ("err", f"unknown op {op!r}")
        except Exception as e:  # surface server faults to the client
            return ("err", f"{type(e).__name__}: {e}")

    def _sync_steps_pre(self, opt):
        """Before an update: the instance sees the GLOBAL step, so an
        lr_scheduler keyed on num_update follows total server progress
        (reference: one optimizer, num_update = max over all keys)."""
        with self._meta_lock:
            opt.num_update = max(opt.num_update, self._global_num_update)

    def _sync_steps_post(self, opt):
        with self._meta_lock:
            self._global_num_update = max(self._global_num_update,
                                          opt.num_update)

    def _apply_push(self, key, grad: onp.ndarray):
        """Apply one gradient immediately (kvstore_dist_server.h:337
        DataHandleDefault async mode: no aggregation buffer, no wait
        for other workers).  Caller holds the key's lock."""
        self._push_counts[key] = self._push_counts.get(key, 0) + 1
        if key not in self._store:
            # push before init: adopt the gradient as the value
            # (reference server inits from the first blob it sees)
            self._store[key] = grad.copy()
            return
        optimizer = self._key_optimizer(key)
        if optimizer is None:
            # no optimizer: plain accumulation semantics
            self._store[key] = self._store[key] + grad
            return
        weight = _host_nd(self._store[key])
        g = _host_nd(grad)
        if key not in self._states:
            # multi-precision layout: same state shape as the sparse
            # handler, so mixed dense/sparse pushes on one key agree
            self._states[key] = \
                optimizer.create_state_multi_precision(key, weight)
        self._sync_steps_pre(optimizer)
        optimizer.update_multi_precision(key, weight, g,
                                         self._states[key])
        self._sync_steps_post(optimizer)
        self._store[key] = onp.asarray(weight.asnumpy())

    def _apply_push_sparse(self, key, indices, values, shape):
        """Apply a row_sparse gradient: optimizer sparse dispatch (lazy
        row updates) when an optimizer is set; accumulation of the live
        rows otherwise.  Duplicate ids within one push are coalesced
        (sort + segment-sum) FIRST — a batch that touches row r twice
        must apply one summed gradient, not two order-dependent
        optimizer updates (a momentum/adagrad state row is not
        associative under repeated dispatch).  Caller holds the key's
        lock."""
        from ..ndarray.sparse import RowSparseNDArray, coalesce_rows

        indices, values = coalesce_rows(indices, values)
        # validate against the STORED weight when it exists (a
        # mismatched client shape must not sneak rows past the check:
        # an index past the table would be dropped or wrap silently)
        n = (self._store[key].shape[0] if key in self._store
             else shape[0])
        if indices.size and (indices.min() < 0 or indices.max() >= n):
            # numpy indexing would wrap negative ids silently
            raise MXNetError(
                f"push_sparse: row indices out of range for key "
                f"{key!r} with {n} rows")
        # count only pushes that passed validation (push_count is the
        # applied-push probe)
        self._push_counts[key] = self._push_counts.get(key, 0) + 1
        rsp = RowSparseNDArray(torch.from_numpy(onp.array(values)),
                               torch.from_numpy(onp.array(indices)), shape)
        if key not in self._store:
            self._store[key] = onp.asarray(rsp.todense().asnumpy())
            return
        optimizer = self._key_optimizer(key)
        if optimizer is None:
            dense = self._store[key].copy()
            onp.add.at(dense, indices, onp.asarray(values))
            self._store[key] = dense
            return
        weight = _host_nd(self._store[key])
        if key not in self._states:
            # multi-precision layout to match the entry point below
            self._states[key] = \
                optimizer.create_state_multi_precision(key, weight)
        # update_multi_precision: the sparse-safe entry point (routes
        # overridden update() optimizers to _update_rsp / densify)
        self._sync_steps_pre(optimizer)
        optimizer.update_multi_precision(key, weight, rsp,
                                         self._states[key])
        self._sync_steps_post(optimizer)
        self._store[key] = onp.asarray(weight.asnumpy())

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)


class PSClient:
    """One worker's connection to the ParamServer (thread-safe)."""

    def __init__(self, address: str, timeout: float = 60.0,
                 retries: int = 50):
        self._address = address
        self._timeout = timeout
        self._hmac = _hmac_key()     # captured once at construction
        self._rank: Optional[int] = None
        self._sock = self._connect(retries)
        self._lock = threading.Lock()

    def _connect(self, retries: int = 50) -> socket.socket:
        host, port = self._address.rsplit(":", 1)
        last = None
        for _ in range(retries):  # the server thread may still be booting
            try:
                return socket.create_connection((host, int(port)),
                                                timeout=self._timeout)
            except OSError as e:
                last = e
                import time
                time.sleep(0.2)
        raise MXNetError(f"cannot reach param server at {self._address}: "
                         f"{last}")

    def _call(self, *msg):
        with self._lock:
            try:
                _send_msg(self._sock, msg, self._hmac)
                reply = _recv_msg(self._sock, self._hmac)
            except socket.timeout:
                # healthy-but-slow server: the request may still be in
                # flight — retrying would risk a silent DUPLICATE apply
                # of a non-idempotent push; surface instead
                raise MXNetError(
                    f"param server timed out after {self._timeout}s "
                    "(server alive but slow; request state unknown)")
            except (ConnectionError, OSError):
                # genuine drop (peer closed / keepalive reap): reconnect
                # once and retry — the async-PS contract tolerates an
                # at-most-once duplicate (apply-immediately SGD
                # semantics), and all reads are idempotent
                try:
                    self._sock.close()
                except OSError:
                    pass
                try:
                    self._sock = self._connect(retries=25)
                    if self._rank is not None and msg[0] != "hello":
                        _send_msg(self._sock, ("hello", self._rank),
                                  self._hmac)
                        _recv_msg(self._sock, self._hmac)  # re-register
                    _send_msg(self._sock, msg, self._hmac)
                    reply = _recv_msg(self._sock, self._hmac)
                except (ConnectionError, OSError) as e:
                    # keep the class's error contract (shutdown() and
                    # callers suppress/handle MXNetError)
                    raise MXNetError(
                        f"param server connection lost and retry "
                        f"failed: {e}") from e
        if reply[0] != "ok":
            raise MXNetError(f"param server error: {reply[1]}")
        return reply[1] if len(reply) > 1 else None

    def init(self, key, val: onp.ndarray):
        self._call("init", str(key), onp.asarray(val))

    def set(self, key, val: onp.ndarray):
        """Overwrite a key's value (broadcast/checkpoint-load path —
        unlike init, NOT first-write-wins)."""
        self._call("set", str(key), onp.asarray(val))

    def push(self, key, grad: onp.ndarray):
        self._call("push", str(key), onp.asarray(grad))

    def push_sparse(self, key, indices: onp.ndarray, values: onp.ndarray,
                    shape) -> None:
        self._call("push_sparse", str(key), onp.asarray(indices),
                   onp.asarray(values), tuple(shape))

    def push_sparse_packed(self, key, indices: onp.ndarray,
                           packed: onp.ndarray, n: int, shape,
                           dtype: str, threshold: float) -> None:
        """Gradient-compressed sparse push: ``packed`` holds ``n``
        2-bit codes (4/byte) over the touched rows' values; the server
        dequantizes to {-threshold, 0, +threshold} before the sparse
        apply.  Residual error feedback is the CALLER's job (the
        client-side ``GradientCompression`` keeps it)."""
        self._call("push_sparse_packed", str(key), onp.asarray(indices),
                   onp.asarray(packed, onp.uint8), int(n), tuple(shape),
                   str(dtype), onp.asarray(threshold, onp.float64))

    def pull(self, key) -> onp.ndarray:
        return self._call("pull", str(key))

    def pull_rows(self, key, rows: onp.ndarray) -> onp.ndarray:
        return self._call("pull_rows", str(key),
                          onp.asarray(rows, onp.int64))

    def set_optimizer(self, optimizer):
        self._call("set_optimizer",
                   pickle.dumps(optimizer, pickle.HIGHEST_PROTOCOL))

    def push_count(self, key) -> int:
        return self._call("push_count", str(key))

    def command(self, head: str, body: str = "") -> None:
        self._call("command", str(head), body)

    def alive_ranks(self) -> list:
        """Sorted distinct worker ranks currently connected."""
        return list(self._call("num_alive"))

    def num_alive(self) -> int:
        """Number of distinct worker ranks currently connected."""
        return len(self.alive_ranks())

    def hello(self, rank: int) -> None:
        """Register this connection's worker rank for liveness."""
        self._rank = int(rank)
        self._call("hello", self._rank)

    def shutdown(self):
        try:
            self._call("shutdown")
        except MXNetError:
            pass

    def close(self):
        self._sock.close()
