"""Device-feed pipeline: batches copied to the card ahead of the step
(counterpart of ``mxnet_tpu/data/device_pipeline.py``).

``DevicePrefetcher`` wraps any batch iterable — ``gluon.data.DataLoader``,
an ``io.DataIter``, a plain generator — and keeps ``MXNET_DEVICE_PREFETCH``
(default 2) batches in flight: a background thread pulls host batches and
copies each array leaf to the consumer's device, so the host-to-device
copy (and the host batchify behind it) overlaps the previous step's
compute instead of sitting in it.  The consumer's ``next()`` hands back a
batch already on the device; ``SPMDTrainer`` then copies it device to
device into its graph's inputs (``Executable._stage``), with no host
staging and no host wait.

On CUDA the producer owns, for each batch signature (the leaves' shapes
and dtypes), a ring of pinned host buffers allocated once, and a side
``torch.cuda.Stream``:

- it waits until the slot's previous copy has completed (the slot's
  event), copies the host leaves into the slot, allocates the device
  tensors and issues ``non_blocking`` copies on the side stream, and
  records one event per batch;
- the consumer makes its current stream wait on that event before it
  hands the batch over, and calls ``record_stream`` on every delivered
  tensor, so the caching allocator never gives a delivered block to the
  next copy while the step that reads it is still queued.

Dataflow::

    workers ─▶ host batches ─▶ [producer thread: pinned slot ─▶ H2D on
        the side stream, one event] ─▶ ring of ``depth`` batches ─▶
        consumer (wait_event, record_stream) ─▶ step

Ordering is exactly the source's (one producer thread, FIFO queue), so a
wrapped loader is bitwise-deterministic against the bare loader.
``MXNET_DEVICE_PREFETCH=0`` (or ``depth=0``) disables the pipeline:
``wrap`` returns the source unchanged.  An error in the source is raised
at the consumer; ``close()``, or a consumer that drops the iterator
mid-epoch, stops the thread.

Where batches land: ``cuda:0`` when no consumer is given (raising where
no card is visible, as ``gpu(0)`` does), else the consumer's device: an
``SPMDTrainer``'s, a ``gluon.Trainer``'s parameters', or an explicit
device or callable.  Only an explicit CPU device, or a consumer on the
CPU, runs the pipeline on the host: the same thread and ring of batches,
with no stream and no pinned buffers.

Telemetry: every copied batch accounts its payload into
``input.h2d_bytes``; every consumer ``next()`` records the time it
blocked into ``input.wait_ms``.  Both appear in the step records as
``h2d_bytes`` / ``input_wait_ms``.

Window staging (``window=n_steps``): the producer stacks ``n_steps``
consecutive batches on the host into one window whose leaves carry a
leading ``n_steps`` axis and copies it to the device as one item — the
input of ``SPMDTrainer.run_steps(..., per_step_data=True)``, which then
takes each step's batch device to device.  A trailing partial window is
dropped and counted in ``input.window_dropped``.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
import weakref
from typing import Any, Iterable, Optional

import numpy as onp
import torch

from .. import telemetry
from .. import tracing
from ..base import MXNetError, getenv

__all__ = ["DevicePrefetcher", "prefetch_depth", "wrap",
           "note_advice_depth", "advised_depth"]

_DONE = "__done__"
_ERROR = "__error__"

# remediation advice: a persistently input-bound run may be advised to
# deepen its ring; applied at the next epoch boundary, and only to a
# pipeline that is already on
_ADVICE_LOCK = threading.Lock()
_advised_depth = 0


def note_advice_depth(depth: int) -> None:
    """Record a prefetch-depth advice (monotonic max)."""
    global _advised_depth
    with _ADVICE_LOCK:
        _advised_depth = max(_advised_depth, int(depth))


def advised_depth() -> int:
    """The current advised depth (0 = no advice)."""
    return _advised_depth


def prefetch_depth(default: int = 2) -> int:
    """Batches kept in flight (``MXNET_DEVICE_PREFETCH``; 0 disables the
    pipeline — the bitwise-identical host path)."""
    v = getenv("MXNET_DEVICE_PREFETCH")
    if v is None or v == "":
        return default
    try:
        return max(0, int(v))
    except ValueError:
        raise MXNetError(
            f"invalid MXNET_DEVICE_PREFETCH={v!r}; expected an integer")


def _placement_of(consumer):
    """A per-leaf placement function ``leaf -> torch.device`` from a
    consumer: an ``SPMDTrainer`` (its device), a ``gluon.Trainer`` (its
    parameters' device), a ``torch.device`` / ``Context`` / device
    string, a callable ``leaf -> device``, or None (``cuda:0``)."""
    from ..context import Context, gpu, resolve_device
    if consumer is None:
        dev = gpu(0).torch_device
        return lambda leaf: dev
    if isinstance(consumer, Context):
        dev = consumer.torch_device
        return lambda leaf: dev
    if isinstance(consumer, (torch.device, str)):
        dev = resolve_device(consumer)
        return lambda leaf: dev
    if hasattr(consumer, "_stage_input") and hasattr(consumer, "device"):
        # parallel.SPMDTrainer: its one device
        dev = consumer.device
        return lambda leaf: dev
    if hasattr(consumer, "_input_placement"):
        # gluon.Trainer: the device its parameters live on
        dev = consumer._input_placement()
        return lambda leaf: dev
    if callable(consumer):
        return lambda leaf: resolve_device(consumer(leaf))
    raise MXNetError(
        f"cannot derive a batch device from {type(consumer).__name__}; "
        "pass a torch.device, a Context, a device string, a callable, or "
        "a trainer (SPMDTrainer / gluon.Trainer)")


def _host_tensor(x) -> torch.Tensor:
    """A host leaf (numpy or anything ``numpy.asarray`` takes) as a CPU
    tensor with the reference's dtype rules (float64 → float32, int64 →
    int32)."""
    from ..io.io import host_nd
    return host_nd(x)._data


def _leaf_tensor(x):
    """(tensor, from_host) for an array leaf, else (None, False)."""
    from ..ndarray import NDArray
    if isinstance(x, NDArray):
        return x._data.detach(), False
    if isinstance(x, torch.Tensor):
        return x.detach(), False
    if isinstance(x, onp.ndarray):
        return _host_tensor(x), True
    return None, False


class _Stager:
    """Moves a batch's leaves to their device.  On CUDA: a ring of pinned
    host buffers per batch signature (``slots`` of them, allocated once)
    and a side stream; each staged batch gets one event."""

    # signatures whose rings are kept (a last partial batch adds one)
    _MAX_SIGS = 4

    def __init__(self, slots: int):
        self._slots = max(1, int(slots))
        self._rings = {}       # (device, signature) → [slot, ...], cursor
        self._streams = {}     # device → side stream

    def _stream(self, dev):
        s = self._streams.get(dev)
        if s is None:
            s = self._streams[dev] = torch.cuda.Stream(dev)
        return s

    def _slot(self, dev, hosts):
        key = (dev, tuple((tuple(h.shape), h.dtype) for h in hosts))
        ring = self._rings.get(key)
        if ring is None:
            if len(self._rings) >= self._MAX_SIGS:
                old_key = next(iter(self._rings))
                for slot in self._rings.pop(old_key)[0]:
                    if slot[1] is not None:
                        slot[1].synchronize()
            ring = self._rings[key] = [
                [[[torch.empty(h.shape, dtype=h.dtype, pin_memory=True)
                   for h in hosts], None] for _ in range(self._slots)], 0]
        slots, cursor = ring
        ring[1] = (cursor + 1) % len(slots)
        slot = slots[cursor]
        if slot[1] is not None:
            slot[1].synchronize()      # the slot's last copy has landed
        return slot

    def stage(self, work):
        """``work``: [(tensor, device, from_host)], the leaves that move.
        Returns (device tensors, CUDA event or None)."""
        out = [None] * len(work)
        by_dev = {}
        for i, (t, dev, _) in enumerate(work):
            if dev.type == "cuda" and t.device.type == "cpu":
                by_dev.setdefault(dev, []).append(i)
            else:
                out[i] = t.to(dev)
        events = []
        for dev, idx in by_dev.items():
            hosts = [work[i][0] for i in idx]
            slot = self._slot(dev, hosts)
            for p, h in zip(slot[0], hosts):
                p.copy_(h)
            side = self._stream(dev)
            with torch.cuda.stream(side):
                for i, p in zip(idx, slot[0]):
                    d = torch.empty(p.shape, dtype=p.dtype, device=dev)
                    d.copy_(p, non_blocking=True)
                    out[i] = d
                ev = torch.cuda.Event()
                ev.record(side)
            slot[1] = ev
            events.append(ev)
        return out, events


def _place_tree(batch, place_fn, stager):
    """Move every array leaf of ``batch`` to ``place_fn``'s device,
    keeping the batch's structure (tuples, lists, dicts, DataBatch).
    Returns (placed batch, bytes copied, events, delivered tensors)."""
    from ..ndarray import NDArray
    work, slots = [], []

    def collect(x):
        if isinstance(x, tuple) and not isinstance(x, NDArray):
            return tuple(collect(e) for e in x)
        if isinstance(x, list):
            return [collect(e) for e in x]
        if isinstance(x, dict):
            return {k: collect(v) for k, v in x.items()}
        t, from_host = _leaf_tensor(x)
        if t is None:
            return x                  # DataBatch.pad ints, names, None
        dev = place_fn(t)
        if t.device == dev and not from_host:
            return x if isinstance(x, NDArray) else NDArray._wrap(t)
        slots.append(len(work))
        work.append((t, dev, from_host))
        return _Hole(len(work) - 1)

    def fill(x, moved):
        if isinstance(x, _Hole):
            return NDArray._wrap(moved[x.i])
        if isinstance(x, tuple) and not isinstance(x, NDArray):
            return tuple(fill(e, moved) for e in x)
        if isinstance(x, list):
            return [fill(e, moved) for e in x]
        if isinstance(x, dict):
            return {k: fill(v, moved) for k, v in x.items()}
        return x

    is_databatch = (type(batch).__name__ == "DataBatch"
                    and hasattr(batch, "data") and hasattr(batch, "label"))
    tree = (collect(batch.data), collect(batch.label)) if is_databatch \
        else collect(batch)
    nbytes = sum(t.nbytes for t, _, _ in work)
    moved, events = stager.stage(work) if work else ([], [])
    tree = fill(tree, moved)
    delivered = [m for m in moved if m.device.type == "cuda"]
    if is_databatch:
        from ..io.io import DataBatch
        tree = DataBatch(tree[0], tree[1], pad=batch.pad, index=batch.index,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label)
    return tree, nbytes, events, delivered


class _Hole:
    __slots__ = ("i",)

    def __init__(self, i):
        self.i = i


def _to_host(leaf) -> torch.Tensor:
    from ..ndarray import NDArray
    if isinstance(leaf, NDArray):
        return leaf._data.detach().cpu()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    return _host_tensor(leaf)


def _stack_window(batches):
    """Stack ``n_steps`` structurally identical batches into one window:
    every array leaf gains a leading ``n_steps`` axis (a host array);
    other payloads keep the first batch's value.  The window then
    moves as one item, one copy per leaf."""
    from ..ndarray import NDArray

    def stack(items):
        x0 = items[0]
        if isinstance(x0, tuple):
            return tuple(stack([it[i] for it in items])
                         for i in range(len(x0)))
        if isinstance(x0, list):
            return [stack([it[i] for it in items]) for i in range(len(x0))]
        if isinstance(x0, dict):
            return {k: stack([it[k] for it in items]) for k in x0}
        if isinstance(x0, (NDArray, torch.Tensor, onp.ndarray)):
            t = torch.stack([_to_host(it) for it in items])
            # a host array, as the reference's window (numpy has no bf16)
            return t if t.dtype == torch.bfloat16 else t.numpy()
        return x0

    if type(batches[0]).__name__ == "DataBatch" \
            and hasattr(batches[0], "data"):
        from ..io.io import DataBatch
        return DataBatch(stack([b.data for b in batches]),
                         stack([b.label for b in batches]),
                         pad=batches[0].pad, index=batches[0].index,
                         provide_data=batches[0].provide_data,
                         provide_label=batches[0].provide_label)
    return stack(batches)


def _window_iter(src, window: int):
    """Regroup a batch iterator into whole ``window``-step windows; a
    trailing partial window is dropped (``input.window_dropped``)."""
    buf = []
    try:
        for batch in src:
            buf.append(batch)
            if len(buf) == window:
                yield _stack_window(buf)
                buf = []
        if buf:
            telemetry.counter("input.window_dropped").inc(len(buf))
    finally:
        # closing this generator (pipeline shutdown) must reach the
        # source's own teardown (the DataLoader's shm drain)
        close = getattr(src, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass


def _shutdown(stop, q, thread, src_it):
    """Tear one epoch's pipeline down: the thread stopped, the ring
    drained and the source generator's own cleanup run.  From close(),
    from the finalizer of an abandoned iterator, and at exhaustion."""
    stop.set()
    while True:
        try:
            q.get_nowait()
        except _queue.Empty:
            break
    if thread is not None and thread.is_alive() \
            and thread is not threading.current_thread():
        thread.join(timeout=10)
    close = getattr(src_it, "close", None)
    if close is not None:
        try:
            close()
        except Exception:
            pass


def _produce(src, q, stop, place_fn, stager, skip=0):
    """Producer loop (a module function: the thread holds no reference
    to the pipeline object, so an abandoned pipeline can be collected
    and its finalizer can stop this thread).

    ``skip``: items to draw from the source and drop before staging any
    (a resumed run's replay: the source's sampler state advances as in
    the original run, with no copies)."""
    def put(item) -> bool:
        # bounded put that stays responsive to shutdown
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except _queue.Full:
                continue
        return False

    try:
        for _ in range(skip):
            if stop.is_set():
                return
            try:
                next(src)
            except StopIteration:
                put((_DONE, None))
                return
        if skip:
            telemetry.counter("input.replayed").inc(skip)
        while not stop.is_set():
            with tracing.span("input.produce") as sp:
                try:
                    batch = next(src)
                except StopIteration:
                    put((_DONE, None))
                    return
                with tracing.span("input.h2d") as h2d:
                    placed = _place_tree(batch, place_fn, stager)
                    h2d.annotate(h2d_nbytes=placed[1])
                sp.annotate(h2d_nbytes=placed[1])
            if placed[1]:
                telemetry.record_h2d_bytes(placed[1])
            if not put((None, placed)):
                return
    except BaseException as e:   # raised at the consumer's next()
        put((_ERROR, e))


class _EpochPipeline:
    """One epoch's producer thread and bounded ring.  Made at each
    ``__iter__`` so a prefetcher can be iterated epoch after epoch."""

    def __init__(self, src_it, place_fn, stager, depth: int, name: str,
                 skip: int = 0):
        self._q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_produce,
            args=(src_it, self._q, self._stop, place_fn, stager, skip),
            name=f"DevicePrefetch-{name}", daemon=True)
        # an interrupted consumer (break mid-epoch) drops its reference;
        # the finalizer stops the thread, drains the ring and closes the
        # source
        self._finalizer = weakref.finalize(
            self, _shutdown, self._stop, self._q, self._thread, src_it)
        self._thread.start()

    @property
    def thread(self):
        return self._thread

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        t1 = time.perf_counter()
        telemetry.record_input_wait(t1 - t0)
        tracing.record_span("input.wait", t0, t1)
        tag, payload = item
        if tag is None:
            placed, _, events, delivered = payload
            if events:
                cur = torch.cuda.current_stream(delivered[0].device)
                for ev in events:
                    cur.wait_event(ev)
                for t in delivered:
                    t.record_stream(torch.cuda.current_stream(t.device))
            return placed
        self.close()
        if tag == _ERROR:
            raise payload
        raise StopIteration

    def close(self):
        self._finalizer()


class DevicePrefetcher:
    """Wrap a batch iterable so batches arrive on the consumer's device,
    with ``depth`` batches copied ahead of the consumer.

    Parameters
    ----------
    source : iterable
        Any batch source: ``gluon.data.DataLoader``, ``io.DataIter``,
        generator, list.  Re-iterables re-iterate (one epoch per
        ``__iter__``); one-shot iterators are consumed once.
    sharding : optional
        Where batches land: a trainer (``SPMDTrainer`` / ``gluon.Trainer``),
        a ``torch.device`` / ``Context`` / device string, a callable
        ``leaf -> device``, or None for ``cuda:0`` (the name is the
        reference's; the port places on one device).
    depth : int, optional
        Batches kept in flight; default ``MXNET_DEVICE_PREFETCH`` (2).
        0 disables: iteration passes the source through untouched.
    window : int, optional
        Stage whole ``window``-step windows instead of single batches
        (the input of ``SPMDTrainer.run_steps(per_step_data=True)``); a
        trailing partial window is dropped (``input.window_dropped``).
        Windowing applies even at ``depth=0`` (stacked on the host, not
        moved).
    """

    def __init__(self, source: Iterable, sharding: Any = None,
                 depth: Optional[int] = None, name: Optional[str] = None,
                 window: Optional[int] = None):
        self._source = source
        self._window = 1 if window is None else max(1, int(window))
        self._depth = prefetch_depth() if depth is None else max(0, int(depth))
        self._place_fn = _placement_of(sharding) if self._depth > 0 \
            else None
        self._name = name or type(source).__name__
        self._live: Optional[_EpochPipeline] = None
        self._plain = None
        self._skip_next = 0
        self._stager = None

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def window(self) -> int:
        return self._window

    def __len__(self):
        n = len(self._source)
        return n // self._window if self._window > 1 else n

    def fast_forward(self, n: int) -> None:
        """Make the next epoch draw and drop its first ``n`` items before
        staging any (a resumed ``SPMDTrainer.fit``): the source's sampler
        advances as in the interrupted run, the skipped items are not
        copied.  With ``window > 1``, ``n`` counts windows."""
        self._skip_next = max(0, int(n))

    def _source_iter(self):
        it = iter(self._source)
        return _window_iter(it, self._window) if self._window > 1 else it

    def __iter__(self):
        skip, self._skip_next = self._skip_next, 0
        if self._depth <= 0:
            it = self._source_iter()
            for _ in range(skip):
                try:
                    next(it)
                except StopIteration:
                    break
            return it
        depth = max(self._depth, _advised_depth)
        self.close()   # a fresh epoch retires any abandoned pipeline
        if self._stager is None or self._stager._slots < depth + 1:
            # one slot more than the ring holds: the batch the consumer
            # took last may still be copying
            self._stager = _Stager(depth + 1)
        self._live = _EpochPipeline(self._source_iter(), self._place_fn,
                                    self._stager, depth, self._name,
                                    skip=skip)
        return self._live

    # -- io.DataIter protocol ----------------------------------------------
    def __next__(self):
        if self._depth <= 0:
            if self._plain is None:
                self._plain = self.__iter__()
            try:
                return next(self._plain)
            except StopIteration:
                self._plain = None
                raise
        if self._live is None:
            self.__iter__()
        return next(self._live)

    def next(self):
        return self.__next__()

    def reset(self):
        """Tear down the epoch in flight and reset the source, so the next
        iteration starts afresh."""
        self.close()
        self._plain = None
        reset = getattr(self._source, "reset", None)
        if reset is not None:
            reset()

    def close(self):
        """Stop the producer thread and drop the batches in flight."""
        if self._live is not None:
            self._live.close()
            self._live = None


def wrap(source: Iterable, consumer: Any = None,
         depth: Optional[int] = None, window: Optional[int] = None):
    """Wrap ``source`` in a :class:`DevicePrefetcher` that places batches
    for ``consumer`` (a trainer, a device, a callable, or None for
    ``cuda:0``).  With ``MXNET_DEVICE_PREFETCH=0`` (or ``depth=0``) and no
    window the source is returned unchanged.  ``window=n_steps`` stages
    whole windows for ``SPMDTrainer.run_steps(..., per_step_data=True)``;
    it applies even when prefetch is off (host-stacked windows)."""
    d = prefetch_depth() if depth is None else max(0, int(depth))
    w = 1 if window is None else max(1, int(window))
    if d <= 0 and w <= 1:
        return source
    return DevicePrefetcher(source, sharding=consumer, depth=d, window=w)
