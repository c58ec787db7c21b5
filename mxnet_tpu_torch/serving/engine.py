"""InferenceEngine: the shape-bucketed serving forward, one CUDA graph per
bucket (counterpart of ``mxnet_tpu/serving/engine.py``).

One captured forward per **shape bucket** (an
:class:`~mxnet_tpu_torch.executable.Executable`: a CUDA graph on a card),
shared by every request whose padded shape lands in it.  The batch axis
(and optionally sequence axes, ``seq_axes``) is padded up to powers of
two or to explicit ``bucket_sizes``, so a steady request mix replays a
small, bounded set of graphs.

New buckets burn the ``MXNET_JIT_MAX_SIGS`` budget shared with the other
captured caches (``ops.registry.SigBudget``, or ``max_sigs``): over it
the engine latches, and a new shape runs eagerly while every captured
bucket keeps replaying; nothing is evicted.  A block with forward hooks
is never captured (hooks observe real activations), ``MXNET_SERVING=0``
forces the eager path process-wide, and a bucket whose capture failed is
latched eager (counted in ``serving.capture_failures`` and logged); all
three run the same forward under ``autograd.pause(train_mode=False)``.

Requests are single examples (no batch axis).  Results come back as
host numpy arrays: a batch makes one dispatch (``dispatch.count`` +1 on
a replay) and one device-to-host copy per output leaf; rows are sliced
on the host.  numpy has no bfloat16, so a bf16 output leaf is widened to
float32 on the host, which is exact (the reference returns ml_dtypes
bf16 arrays).

An exported block (``SymbolBlock.imports``, queue 1 item 13) and the
executable artifact store (``MXNET_ARTIFACT_DIR``, queue 1 item 12) are
not ported yet: both raise where the reference would take them.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from .. import autograd as ag
from .. import telemetry, tracing
from ..base import MXNetError, getenv, torch_dtype
from ..log import get_logger
from ..ndarray.ndarray import NDArray
from ..ops.registry import SigBudget

__all__ = ["InferenceEngine", "BadRequestError", "QueueFullError",
           "RequestTimeoutError", "ServingClosedError", "serving_enabled"]


class BadRequestError(MXNetError):
    """Request rejected at admission (shape, dtype, rank, token ids,
    budget): raised before the request enters the queue, so one
    malformed request can never poison a batch."""


class QueueFullError(MXNetError):
    """Request shed at admission: the bounded queue is at depth."""


class RequestTimeoutError(MXNetError):
    """Request expired before it finished (per-request deadline)."""


class ServingClosedError(MXNetError):
    """Request arrived after shutdown/drain began."""


def serving_enabled() -> bool:
    """``MXNET_SERVING=0`` turns the captured bucket path off (every
    batch runs eagerly).  Read at each dispatch, so it can be flipped
    live."""
    return (getenv("MXNET_SERVING", "1") or "1").lower() \
        not in ("0", "false", "off")


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _is_leaf(v) -> bool:
    return isinstance(v, (NDArray, torch.Tensor))


def _to_host(leaf) -> onp.ndarray:
    """One device-to-host copy of an output leaf; bf16 widened to f32 on
    the host (exact)."""
    t = leaf._data if isinstance(leaf, NDArray) else leaf
    h = t.detach().to("cpu")
    if h.dtype == torch.bfloat16:
        h = h.float()
    return h.numpy()


def _param_ptrs(params) -> Tuple:
    """What a captured bucket holds of the parameters: each one's
    address and dtype."""
    return tuple((p._data.data_ptr(), p._data.dtype)
                 if p._data is not None else (0, None) for p in params)


def _hybrid_blocks(block) -> list:
    """The hybridized ``HybridBlock``s of ``block``'s tree."""
    from ..gluon.block import HybridBlock
    out, seen, stack = [], set(), [block]
    while stack:
        b = stack.pop()
        if id(b) in seen:
            continue
        seen.add(id(b))
        if isinstance(b, HybridBlock) and b._active:
            out.append(b)
        stack.extend(getattr(b, "_children", {}).values())
    return out


class _Bucket:
    """One bucket's captured forward: an ``Executable`` over a static
    input of the bucket's shape and dtype (captured on construction, on
    zeros: a forward is harmless there), the output tree, the parameter
    addresses the graph holds, and the embedding id check it defers."""

    def __init__(self, block, params, shape, dtype, device, owner):
        from ..executable import Executable
        from ..imperative import cached_step as _cs
        from ..ops.tensor import IdCheck
        self.params = params
        self.ptrs = _param_ptrs(params)
        self.ids = IdCheck()
        self.tree = None
        call = torch.nn.Module.__call__

        def fn(x):
            # ids out of range are clamped inside the graph and their
            # range recorded; the engine checks it after the copy out
            self.ids.reset()
            with ag.pause(train_mode=False), self.ids, _cs.inside_record():
                out = call(block, x)
            leaves, self.tree = _cs._flatten(out)
            return leaves, self.ids.bounds()

        spec = torch.empty(shape, dtype=torch_dtype(dtype), device="meta")
        self.exe = Executable(fn, [spec], device,
                              *owner.capture_with(device), warm="zeros")


class InferenceEngine:
    """Shape-bucketed inference over a Block, one captured forward per
    bucket.

    Parameters
    ----------
    block : Block
        The model, on the device it serves from (its parameters').
    example_shape : tuple, optional
        Per-example input shape (no batch axis).  ``None`` entries mark
        variable axes (bucketed when listed in ``seq_axes``).  Learned
        from the first request when omitted.
    dtype : str, optional
        Expected input dtype (learned from the first request when
        omitted).
    bucket_sizes : sequence of int, optional
        Explicit batch-bucket sizes (sorted ascending); default: powers
        of two without bound.
    seq_axes : sequence of int
        Example axes (0-based, batch excluded) padded with zeros up to
        power-of-two buckets, for variable-length inputs; only for
        models whose rows ignore trailing positions (a causal LM).
    max_sigs : int, optional
        Captured-bucket budget; defaults to ``MXNET_JIT_MAX_SIGS``.
    """

    def __init__(self, block, example_shape: Optional[Sequence] = None,
                 dtype: Optional[str] = None,
                 bucket_sizes: Optional[Sequence[int]] = None,
                 seq_axes: Sequence[int] = (),
                 max_sigs: Optional[int] = None,
                 name: Optional[str] = None):
        if callable(getattr(block, "input_signatures", None)):
            raise MXNetError("serving an exported block (SymbolBlock."
                             "imports) is not ported yet (queue 1 item 13)")
        self._block = block
        self._name = name or type(block).__name__
        self._example_shape = (tuple(example_shape)
                               if example_shape is not None else None)
        self._dtype = str(dtype) if dtype is not None else None
        self._bucket_sizes = (sorted(int(b) for b in bucket_sizes)
                              if bucket_sizes else None)
        self._seq_axes = tuple(int(a) for a in seq_axes)
        self._budget = SigBudget(max_sigs)
        # (bucket key, AMP token) -> _Bucket | "eager" (a failed capture)
        self._compiled: Dict[Any, Any] = {}
        # The dispatch lock, held from a bucket's lookup (and capture)
        # through the staging, the replay and the copy out.  The buckets
        # share one pool (``executable.py``): a later replay may write
        # where an earlier graph keeps its outputs, and every replay of a
        # bucket writes the same static input.  So the batcher's thread,
        # a direct infer/infer_batch caller and warmup (a capture) never
        # overlap on one engine; the reference locks only its compile.
        self._lock = threading.RLock()
        self._owner = None
        self._init_done = False
        self._embedding = None

    # -- spec / admission ---------------------------------------------------

    @property
    def example_shape(self):
        return self._example_shape

    @property
    def dtype(self):
        return self._dtype

    def attach_embedding(self, lookup) -> None:
        """Attach an embedding lookup tier (anything with ``lookup(ids)
        -> (n, dim)``): integer requests are row ids, translated to
        dense features at admission, so the buckets see float batches."""
        self._embedding = lookup

    def _embed_request(self, arr: onp.ndarray) -> onp.ndarray:
        """ids ``(...,)`` -> features ``(..., dim)`` through the attached
        tier; malformed ids are admission rejects."""
        try:
            vecs = onp.asarray(self._embedding.lookup(arr.reshape(-1)))
        except Exception as e:
            telemetry.counter("serving.rejected.shape").inc()
            raise BadRequestError(
                f"embedding lookup rejected request ids: {e}") from None
        return vecs.reshape(tuple(arr.shape) + (vecs.shape[-1],))

    def validate(self, x) -> onp.ndarray:
        """Admission gate: one request as a host numpy example checked
        against the spec (rank, shape, dtype; lossless casts only; no
        zero-size axis).  Raises :class:`BadRequestError` and ticks
        ``serving.rejected.shape`` on any mismatch."""
        try:
            arr = onp.asarray(x.asnumpy() if isinstance(x, NDArray) else x)
        except Exception as e:
            telemetry.counter("serving.rejected.shape").inc()
            raise BadRequestError(f"request is not array-like: {e}") from None
        if self._embedding is not None and \
                onp.issubdtype(arr.dtype, onp.integer):
            arr = self._embed_request(arr)
        if self._dtype is None:
            if not (onp.issubdtype(arr.dtype, onp.floating)
                    or onp.issubdtype(arr.dtype, onp.integer)
                    or arr.dtype == onp.bool_):
                telemetry.counter("serving.rejected.shape").inc()
                raise BadRequestError(
                    f"request dtype {arr.dtype} is not numeric")
            self._dtype = str(arr.dtype)
        elif str(arr.dtype) != self._dtype:
            try:
                cast = arr.astype(self._dtype)
            except (TypeError, ValueError):
                cast = None
            if cast is None or not onp.array_equal(
                    cast.astype(arr.dtype, copy=False), arr):
                telemetry.counter("serving.rejected.shape").inc()
                raise BadRequestError(
                    f"request dtype {arr.dtype} does not match engine "
                    f"dtype {self._dtype}")
            arr = cast
        if arr.size == 0:
            # a zero-size example would give its whole batch a degenerate
            # bucket
            telemetry.counter("serving.rejected.shape").inc()
            raise BadRequestError(
                f"request shape {arr.shape} has a zero-size axis")
        if self._example_shape is None:
            self._example_shape = tuple(
                None if i in self._seq_axes else d
                for i, d in enumerate(arr.shape))
        spec = self._example_shape
        if arr.ndim != len(spec):
            telemetry.counter("serving.rejected.shape").inc()
            raise BadRequestError(
                f"request rank {arr.ndim} (shape {arr.shape}) does not "
                f"match example spec {spec}")
        for i, (have, want) in enumerate(zip(arr.shape, spec)):
            if want is not None and have != want:
                telemetry.counter("serving.rejected.shape").inc()
                raise BadRequestError(
                    f"request shape {arr.shape} does not match example "
                    f"spec {spec} (axis {i}: {have} != {want})")
        return arr

    def _bucket_batch(self, n: int) -> int:
        if n <= 0:
            raise BadRequestError(
                f"batch size must be positive, got {n}")
        if self._bucket_sizes is not None:
            for b in self._bucket_sizes:
                if b >= n:
                    return b
            raise BadRequestError(
                f"batch of {n} exceeds the largest bucket "
                f"{self._bucket_sizes[-1]}")
        return _next_pow2(n)

    def pad_example(self, arr: onp.ndarray) -> Tuple[onp.ndarray,
                                                     Tuple[int, ...]]:
        """Pad an admitted example's seq axes up to their buckets.
        Returns (padded example, original shape)."""
        orig = arr.shape
        if not self._seq_axes:
            return arr, orig
        pads = []
        for i, d in enumerate(arr.shape):
            want = _next_pow2(d) if i in self._seq_axes else d
            pads.append((0, want - d))
        if any(p[1] for p in pads):
            arr = onp.pad(arr, pads)
        return arr, orig

    def group_key(self, padded: onp.ndarray):
        """Coalescing key: requests sharing it are concatenable."""
        return (padded.shape, str(padded.dtype))

    # -- capture ------------------------------------------------------------

    def _bucket_tag(self, key) -> str:
        (shape, dtype) = key
        return "x".join(str(d) for d in shape) + ":" + dtype

    def _params(self) -> list:
        return list(self._block.collect_params().values())

    def _device(self) -> torch.device:
        """The device the block serves from: its parameters'."""
        for p in self._params():
            if p._data is not None:
                return p._data.device
            if p._deferred_init is not None:
                return p._deferred_init[1]
        from ..context import resolve_device
        return resolve_device(None)

    def _ensure_init(self, shape, dtype):
        """Finish deferred parameter init with one eager forward on
        zeros (as a hybridized block's first call does)."""
        if self._init_done:
            return
        params = self._params()
        if any(p._deferred_init is not None for p in params):
            x = torch.zeros(shape, dtype=torch_dtype(dtype),
                            device=self._device())
            with ag.pause(train_mode=False):
                self._block(NDArray._wrap(x))
        for p in params:
            p._check_initialized()
        self._init_done = True

    def _drop_stale(self) -> None:
        """Drop the graphs whose parameters were replaced since their
        capture (``cast``, ``reset_ctx``): a replay would read freed
        addresses.  The caller holds the lock."""
        graphs = [k for k, v in self._compiled.items() if v != "eager"]
        if not graphs:
            return
        now = _param_ptrs(self._compiled[graphs[0]].params)
        stale = [k for k in graphs if self._compiled[k].ptrs != now]
        for k in stale:
            del self._compiled[k]
        telemetry.counter("serving.bucket_drops").inc(len(stale))

    def _compile(self, key):
        """Capture one bucket's forward (a warm run on zeros, then the
        graph); None when the capture failed, which latches this bucket
        eager."""
        import os
        if os.environ.get("MXNET_ARTIFACT_DIR"):
            raise MXNetError("MXNET_ARTIFACT_DIR: the executable artifact "
                             "store is not ported yet (queue 1 item 12)")
        shape, dtype = key
        tag = self._bucket_tag(key)
        device = self._device()
        if self._owner is None:
            from ..executable import CaptureOwner
            self._owner = CaptureOwner()
        # A hybridized child would replay a graph of its own inside this
        # capture; suspended, the bucket is one flat graph, as the
        # reference traces one flat program (its engine.py:372-389).
        hybrid = _hybrid_blocks(self._block)
        t0 = _time.perf_counter()
        try:
            with tracing.span("compile.serving", bucket=tag):
                for b in hybrid:
                    b._active = False
                entry = _Bucket(self._block, self._params(), shape, dtype,
                                device, self._owner)
        except Exception:
            # the bucket serves eagerly from now on; the failure is
            # counted and logged with its traceback, never silent
            telemetry.counter("serving.capture_failures").inc()
            get_logger("mxnet_tpu_torch.serving").exception(
                "serving bucket %s of %s: capture failed, serving it "
                "eagerly", tag, self._name)
            return None
        finally:
            for b in hybrid:
                b._active = True
        telemetry.record_compile(_time.perf_counter() - t0, "serving")
        telemetry.counter(f"serving.bucket.{tag}.compiles").inc()
        return entry

    def warmup(self, specs: Sequence) -> List[str]:
        """Capture buckets ahead of traffic.  ``specs`` entries are batch
        sizes (int; example shape and dtype must be known) or full
        batched shapes (tuple), optionally ``(shape, dtype)``.  Returns
        the bucket tags captured (or already present)."""
        from .. import kernels
        n_kern = kernels.warm_cache()
        if n_kern:
            get_logger("mxnet_tpu_torch.serving").info(
                "warmup: %d tuned kernel config(s) preloaded", n_kern)
        tags = []
        for spec in specs:
            dtype = self._dtype
            if isinstance(spec, (int, onp.integer)):
                if self._example_shape is None or dtype is None or \
                        any(d is None for d in self._example_shape):
                    raise MXNetError(
                        "warmup(batch_size) needs a fully-specified "
                        "example_shape and dtype at engine construction")
                shape = (self._bucket_batch(int(spec)),
                         *self._example_shape)
            else:
                if isinstance(spec, tuple) and len(spec) == 2 and \
                        not isinstance(spec[0], (int, onp.integer)):
                    shape, dtype = tuple(spec[0]), str(spec[1])
                else:
                    shape = tuple(spec)
                shape = (self._bucket_batch(shape[0]), *shape[1:])
            if dtype is None:
                raise MXNetError("warmup spec needs a dtype")
            key = (shape, str(dtype))
            self._get_runner(key, warm=True)
            tags.append(self._bucket_tag(key))
        return tags

    def _get_runner(self, key, warm: bool = False):
        """The captured bucket for ``key``, capturing under the budget;
        None when this dispatch must run eagerly."""
        if not serving_enabled():
            return None
        if not warm and self._block.has_hooks():
            # hooks observe real activations: run eagerly so they fire
            return None
        # the AMP policy's token joins the key: the captured forward
        # holds the policy's casts, so a bucket captured under one policy
        # never serves under another
        from ..amp import policy as _amp_policy
        ckey = (key, _amp_policy.cache_token())
        with self._lock:
            self._drop_stale()
            entry = self._compiled.get(ckey)
            if entry is None:
                if not self._budget.admit(len(self._compiled)):
                    return None   # over budget: eager, no eviction
                shape, dtype = key
                self._ensure_init(shape, dtype)
                entry = self._compile(key) or "eager"
                self._compiled[ckey] = entry
        return entry if entry != "eager" else None

    # -- dispatch -----------------------------------------------------------

    def _run(self, key, n: int, bucket: int, batch):
        """One dispatch of a batch: host examples (a list, padded to the
        bucket here) or a padded tensor on the engine's device.  Returns
        ``(per-example host results, meta)``."""
        with self._lock:
            c_ms0 = telemetry.counter("compile.serving.ms").value
            entry = self._get_runner(key)
            compile_ms = round(
                telemetry.counter("compile.serving.ms").value - c_ms0, 3)
            # (the reference's profiler.op_record of each dispatch waits
            # for profiler.py, queue 1 item 10)
            if entry is not None:
                if isinstance(batch, list):
                    # rows straight into the pinned staging buffer, the
                    # padding rows zeroed there: no stacked host copy
                    from ..executable import Rows
                    batch = Rows(batch)
                leaves, bounds = entry.exe(batch)
                tree = entry.tree
                # one copy out per leaf, before any other replay of the
                # pool may overwrite the static outputs
                host = [_to_host(t) for t in leaves]
                bounds = bounds.to("cpu") if bounds is not None else None
                telemetry.counter("dispatch.count").inc()
                compiled = True
            else:
                from ..imperative import cached_step as _cs
                shape, dtype = key
                self._ensure_init(shape, dtype)
                if isinstance(batch, list):
                    x = onp.zeros(shape, batch[0].dtype)
                    x[:n] = batch
                    batch = torch.from_numpy(x)
                x = batch.to(self._device())
                with ag.pause(train_mode=False):
                    out = self._block(NDArray._wrap(x))
                leaves, tree = _cs._flatten(out, _is_leaf)
                host = [_to_host(t) for t in leaves]
                bounds = None
                compiled = False
        telemetry.counter(
            f"serving.bucket.{self._bucket_tag(key)}.dispatches").inc()
        if bounds is not None:
            # Inside the graph an id out of range was clamped (no read out
            # of bounds) and its range recorded.  The error fails this
            # batch only, at once: a hybridized block would raise it at
            # its next call, an unrelated later batch.  (The reference
            # gives NaN rows through jnp.take's fill.)
            from ..ops.tensor import IdCheck
            IdCheck.raise_if_bad(bounds, entry.ids.vocabs)
        from ..imperative import cached_step as _cs
        results = []
        for i in range(n):
            rows = [h[i] if h.ndim and h.shape[0] == bucket else h
                    for h in host]
            results.append(_cs._unflatten(tree, rows))
        meta = {"bucket": self._bucket_tag(key), "padded": bucket,
                "compiled": compiled, "compile_ms": compile_ms}
        return results, meta

    def _infer_committed(self, batch):
        """A pre-stacked batch already on the device (a tensor or an
        NDArray, batch axis leading) skips host staging: it is copied
        device to device into the bucket's static input, padded on the
        device.  Variable ``seq_axes`` must arrive padded (their length
        keys the bucket); the dtype must match the spec exactly (a
        device batch is never cast)."""
        arr = batch._data if isinstance(batch, NDArray) else batch
        if arr.dim() == 0:
            telemetry.counter("serving.rejected.shape").inc()
            raise BadRequestError("committed batch must carry a batch axis")
        from ..base import dtype_name
        dt = dtype_name(arr.dtype)
        if self._dtype is None:
            self._dtype = dt
        elif dt != self._dtype:
            telemetry.counter("serving.rejected.shape").inc()
            raise BadRequestError(
                f"committed batch dtype {dt} does not match engine "
                f"dtype {self._dtype}")
        if self._example_shape is None:
            self._example_shape = tuple(
                None if i in self._seq_axes else d
                for i, d in enumerate(arr.shape[1:]))
        spec = self._example_shape
        if arr.dim() - 1 != len(spec) or any(
                want is not None and have != want
                for have, want in zip(arr.shape[1:], spec)):
            telemetry.counter("serving.rejected.shape").inc()
            raise BadRequestError(
                f"committed batch shape {tuple(arr.shape)} does not match "
                f"example spec {spec}")
        n = int(arr.shape[0])
        bucket = self._bucket_batch(n)
        if bucket > n:
            arr = torch.cat([arr, arr.new_zeros((bucket - n,
                                                 *arr.shape[1:]))])
        key = (tuple(arr.shape), dt)
        telemetry.counter("serving.device_batches").inc()
        results, meta = self._run(key, n, bucket, arr)
        meta["device_committed"] = True
        return results, meta

    def infer_batch(self, examples):
        """Run one coalesced batch of admitted (validated, seq-padded)
        examples.  Returns ``(results, meta)``: per-example host numpy
        results in the block's output structure, and the dispatch's
        bucket tag, padded size, whether it replayed a graph, and the
        capture ms it paid.  ``examples`` may also be one pre-stacked
        batch on the device (:meth:`_infer_committed`)."""
        if isinstance(examples, (NDArray, torch.Tensor)):
            return self._infer_committed(examples)
        if not len(examples):
            return [], {"bucket": None, "padded": 0, "compiled": False,
                        "compile_ms": 0.0}
        n = len(examples)
        rows = [onp.asarray(e) for e in examples]
        first = rows[0]
        if any(r.shape != first.shape or r.dtype != first.dtype
               for r in rows):
            # not one group: numpy's stacking decides (or raises)
            rows = list(onp.stack(rows))
            first = rows[0]
        bucket = self._bucket_batch(n)
        key = ((bucket, *first.shape), str(first.dtype))
        return self._run(key, n, bucket, rows)

    def infer(self, x, timeout_ms=None):
        """Single request: validate, pad, dispatch a batch of one
        (``timeout_ms`` is accepted for symmetry with the batcher; a
        direct call never queues)."""
        arr = self.validate(x)
        arr, _ = self.pad_example(arr)
        results, _ = self.infer_batch([arr])
        return results[0]

    # -- introspection ------------------------------------------------------

    def buckets(self) -> List[str]:
        """Tags of the buckets holding a captured graph (graphs whose
        parameters were replaced are dropped first)."""
        with self._lock:
            self._drop_stale()
            return sorted(self._bucket_tag(k)
                          for (k, _tok), v in self._compiled.items()
                          if v != "eager")

    def stats(self) -> Dict[str, Any]:
        out = {
            "buckets": len(self.buckets()),
            "latched": self._budget.latched,
            "budget_declines": self._budget.declines,
        }
        if self._embedding is not None and \
                hasattr(self._embedding, "stats"):
            out["embedding"] = self._embedding.stats()
        return out
