"""DynamicBatcher: coalesce concurrent requests into bucketed dispatches
(counterpart of ``mxnet_tpu/serving/batcher.py``).

The robustness surface of serving sits here, in front of the engine:

- **admission validation**: every request is checked
  (``InferenceEngine.validate``) before it enters the queue, so one
  malformed request can never poison a coalesced batch;
- **bounded queue**: at ``queue_depth`` pending requests a new arrival
  is rejected with :class:`QueueFullError` (load is shed);
- **per-request deadlines**: a request whose deadline passes while
  queued, or inside the hold window, fails with
  :class:`RequestTimeoutError` instead of being dispatched late; the
  submitter's clock expires queued neighbours too;
- **graceful drain**: ``close(drain=True)`` stops admission, then
  delivers every admitted response; ``close(drain=False)`` fails them.

One dispatcher thread pops the queue, holds the batch up to
``max_delay_ms`` for it to fill toward ``max_batch_size``, groups
concatenable requests (same padded example shape and dtype) and hands
each group to the engine as ONE padded batch; results go back to the
per-request futures.  A failed dispatch fails its own batch only.
Every dispatch emits a telemetry step record (source
``serving.DynamicBatcher``) with occupancy, padding waste, per-request
latency and the reject / timeout deltas.

Each admitted request carries a request id (``slo.next_request_id``),
stamped into its ``serving.enqueue`` span, its cross-thread
``serving.request`` span (admission to reply, with the validate /
queue-wait / hold / dispatch / pad-share decomposition) and the
``request_ids`` of the ``serving.coalesce`` / ``serving.dispatch``
spans and the step record.  While tracing is on or objectives are
declared, each finished request enters the slowest-request ring and
feeds the burn-rate evaluation inline (``slo.observe_request``); an
escalated ``queue_saturation`` incident's advice (double
``max_batch_size``, halve ``max_delay_ms``) is applied to the live
batchers under ``MXNET_REMEDIATE=1`` and logged and counted either
way.

Tests drive the batcher without a thread: ``start=False`` + ``flush()``.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from .. import telemetry
from .. import tracing
from ..base import getenv_int
from . import slo
from .engine import (InferenceEngine, QueueFullError, RequestTimeoutError,
                     ServingClosedError)

__all__ = ["DynamicBatcher", "_Future", "_getenv_float"]


def _getenv_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        return default


class _Future:
    """Minimal thread-safe future."""

    __slots__ = ("_event", "_result", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._result = None
        self._exc = None

    def set_result(self, result):
        self._result = result
        self._event.set()

    def set_exception(self, exc):
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise RequestTimeoutError(
                f"no response within {timeout:.3f}s")
        if self._exc is not None:
            raise self._exc
        return self._result


class _Pending:
    __slots__ = ("example", "future", "deadline", "t_submit", "group",
                 "rid", "validate_ms", "t_taken", "span")

    def __init__(self, example, group, deadline, rid, validate_ms):
        self.example = example
        self.future = _Future()
        self.deadline = deadline
        self.t_submit = time.perf_counter()
        self.group = group
        self.rid = rid
        self.validate_ms = validate_ms
        self.t_taken = None      # stamped when popped into a batch
        self.span = None         # open serving.request span (tracing on)


class DynamicBatcher:
    """Coalesce concurrent single-example requests into padded batches.

    Knobs (constructor arg > env var > default):

    - ``max_batch_size`` / ``MXNET_SERVING_MAX_BATCH`` (32): most
      requests coalesced into one dispatch.
    - ``max_delay_ms`` / ``MXNET_SERVING_MAX_DELAY_MS`` (2.0): how long
      the dispatcher holds the first request of a batch waiting for the
      batch to fill.  0 dispatches whatever one queue sweep finds.
    - ``queue_depth`` / ``MXNET_SERVING_QUEUE_DEPTH`` (256): pending
      requests admitted before shedding load.
    - ``timeout_ms``: default per-request deadline (None = no deadline).
    """

    def __init__(self, engine: InferenceEngine,
                 max_batch_size: Optional[int] = None,
                 max_delay_ms: Optional[float] = None,
                 queue_depth: Optional[int] = None,
                 timeout_ms: Optional[float] = None,
                 start: bool = True):
        self.engine = engine
        self.max_batch_size = max(1, max_batch_size if max_batch_size
                                  is not None else
                                  getenv_int("MXNET_SERVING_MAX_BATCH", 32))
        self.max_delay_ms = max(0.0, max_delay_ms if max_delay_ms
                                is not None else
                                _getenv_float("MXNET_SERVING_MAX_DELAY_MS",
                                              2.0))
        self.queue_depth = max(1, queue_depth if queue_depth is not None
                               else getenv_int("MXNET_SERVING_QUEUE_DEPTH",
                                               256))
        self.timeout_ms = timeout_ms
        self._q: deque = deque()
        self._cv = threading.Condition()
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self._gauge = telemetry.gauge("serving.queue_depth")
        self._gauge.set(0)
        # last-emitted cumulative reject/timeout counts, so each step
        # record carries deltas a reader can sum; baselined at
        # construction or the first record would claim every reject the
        # process (an earlier batcher) ever counted
        self._emitted = {
            "rejects": telemetry.counter("serving.rejected.queue_full").value
            + telemetry.counter("serving.rejected.shape").value,
            "timeouts": telemetry.counter("serving.timeouts").value,
        }
        # the target of an escalated queue_saturation incident's
        # batcher-tuning advice (applied under MXNET_REMEDIATE=1)
        slo.note_batcher(self)
        if start:
            self.start()

    # -- lifecycle ----------------------------------------------------------

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, name="mxnet-serving-batcher", daemon=True)
            self._thread.start()
        return self

    def close(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Stop admission; with ``drain`` deliver every admitted
        response before returning, else fail pending futures with
        :class:`ServingClosedError`."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            if not drain:
                while self._q:
                    p = self._q.popleft()
                    tracing.end(p.span, error="ServingClosedError")
                    p.future.set_exception(
                        ServingClosedError("server shut down before "
                                           "this request was dispatched"))
            self._gauge.set(len(self._q))
            self._cv.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)
        # no thread (start=False) or a wedged one: drain inline
        if drain:
            self.flush()

    @property
    def closed(self) -> bool:
        return self._closed

    def pending(self) -> int:
        with self._cv:
            return len(self._q)

    # -- admission ----------------------------------------------------------

    def submit(self, x, timeout_ms: Optional[float] = None) -> _Future:
        """Admit one request; returns a future resolving to the
        per-example result.  Raises BadRequestError (shape/dtype),
        QueueFullError (depth), ServingClosedError (draining) — all
        BEFORE the request can touch a batch."""
        # validation happens outside the lock (numpy work), and before
        # admission: a request that raises here was never queued
        _t0 = time.perf_counter()
        example = self.engine.validate(x)
        example, _ = self.engine.pad_example(example)
        group = self.engine.group_key(example)
        validate_ms = round((time.perf_counter() - _t0) * 1e3, 3)
        ms = timeout_ms if timeout_ms is not None else self.timeout_ms
        deadline = (time.perf_counter() + ms / 1e3
                    if ms is not None else None)
        rid = slo.next_request_id()
        with self._cv:
            # expire overdue neighbours on the submitter's clock too —
            # a deadline that lapsed behind a long dispatch shouldn't
            # wait for the dispatcher to wake up to resolve
            self._expire(time.perf_counter())
            if self._closed:
                raise ServingClosedError("server is draining/closed")
            if len(self._q) >= self.queue_depth:
                telemetry.counter("serving.rejected.queue_full").inc()
                raise QueueFullError(
                    f"queue at depth {self.queue_depth}; load shed")
            p = _Pending(example, group, deadline, rid, validate_ms)
            # cross-thread request lifecycle span: begun here (after
            # admission — rejects never open one), ended at dispatch or
            # expiry with the full latency decomposition
            p.span = tracing.begin("serving.request", request_id=rid)
            self._q.append(p)
            depth = len(self._q)
            self._gauge.set(depth)
            self._cv.notify()
        tracing.record_span("serving.enqueue", _t0, time.perf_counter(),
                            queue_depth=depth, request_id=rid)
        return p.future

    # -- dispatch -----------------------------------------------------------

    def _fail_expired(self, pend, now: float) -> list:
        """Fail every request in ``pend`` whose deadline passed and
        return the survivors (order preserved)."""
        live = []
        for p in pend:
            if p.deadline is not None and now > p.deadline:
                telemetry.counter("serving.timeouts").inc()
                tracing.end(p.span, error="RequestTimeoutError")
                if slo.active():
                    lat = round((now - p.t_submit) * 1e3, 3)
                    slo.observe_request({
                        "id": p.rid, "ok": False,
                        "error": "RequestTimeoutError",
                        "latency_ms": lat, "queue_ms": lat,
                        "validate_ms": p.validate_ms,
                        "ts": round(time.time(), 3)})
                p.future.set_exception(RequestTimeoutError(
                    "request expired in queue before dispatch"))
            else:
                live.append(p)
        return live

    def _expire(self, now: float) -> None:
        """Expire queued requests whose deadline passed (caller holds
        the lock)."""
        live = self._fail_expired(self._q, now)
        if len(live) != len(self._q):
            self._q.clear()
            self._q.extend(live)
            self._gauge.set(len(self._q))

    def _nearest_deadline(self, batch) -> Optional[float]:
        """Earliest deadline across a held batch and the queue (caller
        holds the lock) — bounds hold-loop waits so expiry is prompt."""
        dl = [p.deadline for p in batch if p.deadline is not None]
        dl += [p.deadline for p in self._q if p.deadline is not None]
        return min(dl) if dl else None

    def _take_group(self) -> List[_Pending]:
        """Pop up to ``max_batch_size`` requests sharing the head
        request's group key (caller holds the lock)."""
        _t0 = time.perf_counter()
        self._expire(_t0)
        if not self._q:
            return []
        head = self._q[0].group
        batch, keep = [], deque()
        while self._q:
            p = self._q.popleft()
            if p.group == head and len(batch) < self.max_batch_size:
                p.t_taken = time.perf_counter()
                batch.append(p)
            else:
                keep.append(p)
        self._q.extend(keep)
        self._gauge.set(len(self._q))
        tracing.record_span("serving.coalesce", _t0, time.perf_counter(),
                            batch_size=len(batch),
                            request_ids=[p.rid for p in batch])
        return batch

    def _loop(self):
        tracing.register_thread("serving-dispatcher")
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    # expire on every idle wakeup too: with an empty
                    # queue nothing can lapse, but a request admitted
                    # and lapsed between wakeups must not wait for the
                    # next coalesce to resolve
                    self._cv.wait(0.1)
                    self._expire(time.perf_counter())
                if not self._q and self._closed:
                    return
                batch = self._take_group()
                if batch and len(batch) < self.max_batch_size \
                        and self.max_delay_ms > 0 and not self._closed:
                    # hold the batch open for stragglers — but keep
                    # expiring: a deadline that lapses inside the hold
                    # window (queued OR already held) resolves now, not
                    # after the window closes
                    t_end = time.perf_counter() + self.max_delay_ms / 1e3
                    while len(batch) < self.max_batch_size:
                        now = time.perf_counter()
                        self._expire(now)
                        batch = self._fail_expired(batch, now)
                        if not batch:
                            break
                        left = t_end - now
                        if left <= 0:
                            break
                        dl = self._nearest_deadline(batch)
                        if dl is not None:
                            left = min(left, max(dl - now, 1e-4))
                        self._cv.wait(left)
                        head = batch[0].group
                        keep = deque()
                        while self._q and len(batch) < self.max_batch_size:
                            p = self._q.popleft()
                            if p.group == head:
                                p.t_taken = time.perf_counter()
                                batch.append(p)
                            else:
                                keep.append(p)
                        self._q.extend(keep)
                        self._gauge.set(len(self._q))
                        if self._closed:
                            break
                    now = time.perf_counter()
                    batch = self._fail_expired(batch, now)
                    self._expire(now)
            if batch:
                self._dispatch(batch)

    def flush(self):
        """Synchronously dispatch everything currently queued (no delay
        window) — the deterministic path tests and drain use."""
        while True:
            with self._cv:
                batch = self._take_group()
            if not batch:
                return
            self._dispatch(batch)

    def _dispatch(self, batch: List[_Pending]) -> None:
        token = telemetry.begin_step()
        t_dispatch = time.perf_counter()
        rids = [p.rid for p in batch]
        _sp = tracing.span("serving.dispatch", batch_size=len(batch),
                           request_ids=rids)
        slo_on = False
        try:
            slo_on = slo.active()
            with _sp:
                results, meta = self.engine.infer_batch(
                    [p.example for p in batch])
                _sp.annotate(padded=meta["padded"], bucket=meta["bucket"],
                             compiled=meta["compiled"])
        except Exception as e:   # a failed dispatch fails ITS batch only
            now = time.perf_counter()
            for p in batch:
                tracing.end(p.span, error=type(e).__name__)
                if slo_on:
                    lat = round((now - p.t_submit) * 1e3, 3)
                    slo.observe_request({
                        "id": p.rid, "ok": False,
                        "error": type(e).__name__, "latency_ms": lat,
                        "queue_ms": round(
                            ((p.t_taken or t_dispatch) - p.t_submit)
                            * 1e3, 3),
                        "dispatch_ms": round((now - t_dispatch) * 1e3, 3),
                        "validate_ms": p.validate_ms,
                        "batch_size": len(batch),
                        "ts": round(time.time(), 3)})
                p.future.set_exception(e)
            telemetry.counter("serving.failed_batches").inc()
            telemetry.end_step(token, "serving.DynamicBatcher",
                               extra={"serving": {"error": str(e),
                                                  "batch_size": len(batch),
                                                  "request_ids": rids}})
            return
        now = time.perf_counter()
        dispatch_ms = round((now - t_dispatch) * 1e3, 3)
        pad_share = (round(1 - len(batch) / meta["padded"], 4)
                     if meta["padded"] else 0.0)
        compile_ms = float(meta.get("compile_ms") or 0.0)
        latencies = []
        ts_wall = round(time.time(), 3)
        for p, r in zip(batch, results):
            p.future.set_result(r)
            lat = round((now - p.t_submit) * 1e3, 3)
            latencies.append(lat)
            # per-request latency decomposition: queue wait
            # (submit→taken), hold window (taken→dispatch start),
            # dispatch, validate, pad-waste share — the enqueue→reply
            # lifecycle span carries it so /tracez and /requestz can
            # separate waiting from compute
            t_taken = p.t_taken if p.t_taken is not None else t_dispatch
            queue_ms = round((t_taken - p.t_submit) * 1e3, 3)
            hold_ms = round(max(0.0, t_dispatch - t_taken) * 1e3, 3)
            tracing.end(p.span,
                        queue_wait_ms=round(
                            (t_dispatch - p.t_submit) * 1e3, 3),
                        hold_ms=hold_ms, dispatch_ms=dispatch_ms,
                        validate_ms=p.validate_ms, pad_share=pad_share,
                        batch_size=len(batch))
            if slo_on:
                slo.observe_request({
                    "id": p.rid, "ok": True, "latency_ms": lat,
                    "validate_ms": p.validate_ms, "queue_ms": queue_ms,
                    "hold_ms": hold_ms, "dispatch_ms": dispatch_ms,
                    "pad_share": pad_share,
                    "compile_ms": round(compile_ms / len(batch), 3),
                    "bucket": meta["bucket"], "batch_size": len(batch),
                    "ts": ts_wall})
        telemetry.record_serving_batch(len(batch), meta["padded"],
                                       latencies,
                                       eager=not meta["compiled"])
        rejects = (telemetry.counter("serving.rejected.queue_full").value
                   + telemetry.counter("serving.rejected.shape").value)
        timeouts = telemetry.counter("serving.timeouts").value
        extra: Dict[str, Any] = {"serving": {
            "batch_size": len(batch),
            "padded_batch": meta["padded"],
            "bucket": meta["bucket"],
            "compiled": meta["compiled"],
            "padding_waste": pad_share,
            "queue_depth": self.pending(),
            "request_ms": latencies,
            "request_ids": rids,
            "rejects": rejects - self._emitted["rejects"],
            "timeouts": timeouts - self._emitted["timeouts"],
        }}
        self._emitted["rejects"] = rejects
        self._emitted["timeouts"] = timeouts
        telemetry.end_step(token, "serving.DynamicBatcher", extra=extra)
