"""Span flight recorder and stall watchdog (counterpart of
``mxnet_tpu/tracing.py``).

Telemetry answers "how much a step"; this module answers "where inside
the step".  One process-wide, thread-safe span runtime:

- ``span("name", **attrs)``: a nestable context manager.  Parentage is
  kept per thread, times come from ``time.perf_counter``, and completed
  spans land in a bounded ring (``MXNET_TRACE_BUFFER``, default 4096;
  the oldest are overwritten and counted as dropped).
- ``begin("name")`` / ``end(sp)``: a span that ends on another thread
  (the device-feed producer, a serving request).
- ``record_span(name, t0, t1, **attrs)``: an interval measured out of
  band (a consumer's queue wait).
- ``export(path)``: Chrome-trace JSON (``traceEvents`` of complete
  ``"X"`` events, the rank's metadata, open spans flagged);
  ``MXNET_TRACE_JSONL=<path>`` streams the same events one a line.
- the critical-path buckets (``bucket_totals_ms``): cumulative ms of
  completed spans by phase, whose deltas each step record carries.
- the stall watchdog (``MXNET_WATCHDOG_SEC``): a daemon thread that
  polls the open spans; a step or serving span open longer than
  ``MXNET_WATCHDOG_FACTOR`` (default 4) times the p95 of its own
  history gets one dump (every live span, the checkpoint barrier's
  state and every thread's Python stack) to the log, counted in
  ``watchdog.stall_dumps``.

With ``MXNET_TRACE`` unset or off and no JSONL or watchdog configured,
``span()`` returns one shared no-op object: no Span, no ring append, no
lock.  ``MXNET_TRACE=0`` turns everything off even when the other
switches are set.

Span names (the ``cat`` field is the first dotted part): ``step.*``
(step funnels), ``input.*`` (device feed, H2D, the consumer's wait),
``compile.*`` (captures), ``comm.*`` (kvstore), ``ckpt.*`` (checkpoint
service), ``serving.*`` (a request's admission, coalescing, dispatch).
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from . import telemetry

__all__ = ["Span", "span", "begin", "end", "record_span", "instant",
           "enabled",
           "enable", "disable", "export", "recent", "open_spans",
           "aggregate", "clear", "span_count", "dropped_count",
           "bucket_totals_ms", "start_watchdog", "stop_watchdog",
           "register_thread"]

_LOCK = threading.Lock()
_PID = os.getpid()
# monotonic epoch: all span ts are microseconds since module import, so
# Chrome/Perfetto timelines start near 0 regardless of host uptime
_EPOCH = time.perf_counter()
_EPOCH_WALL = time.time()

_ids = itertools.count(1)
_tls = threading.local()

# completed-span ring buffer (event dicts, Chrome-trace shaped)
_ring: List[dict] = []
_ring_pos = 0
_cap_cache: Optional[int] = None

# open (begun, not yet finished) spans: span_id -> Span
_open: Dict[int, "Span"] = {}

# rolling duration history (seconds) per watched span name, for the
# watchdog's p95 baseline; bounded like telemetry's reservoirs
_DUR_KEEP = 128
_durations: Dict[str, List[float]] = {}

# span ids already dumped by the watchdog (once per incident)
_dumped: set = set()

# threads registered for labelled stack dumps / export metadata
_thread_names: Dict[int, str] = {}

# counters live in the telemetry registry so profiler.counters(),
# /varz and telemetry_report all see them without a second registry
_C_SPANS = telemetry.counter("tracing.spans")
_C_DROPPED = telemetry.counter("tracing.spans_dropped")
_C_DUMPS = telemetry.counter("watchdog.stall_dumps")

_DEFAULT_BUFFER = 4096
_OFF_VALUES = ("", "0", "false", "off", "no")

# watchdog scope: step funnels, serving dispatches, and request
# lifecycle spans — the spans whose stall means "training/serving is
# wedged" (a serving.request left open past the threshold is a request
# stuck in the queue/hold path) rather than "slow moment"
_WATCH_PREFIXES = ("step.",)
_WATCH_NAMES = frozenset({"serving.dispatch", "serving.request"})

# critical-path buckets: cumulative ms of completed spans per phase
# class.  telemetry.end_step snapshots/deltas these into each step
# record's critical_path, and clustermon's straggler classifier reads
# the deltas.  Only LEAF-ish names are classified — step.allreduce
# contains the comm.* collectives and step.gluon contains everything,
# so counting containers would double-book the same wall time.
_BUCKET_KEYS = ("input_wait", "h2d", "compile", "collective",
                "optimizer", "checkpoint")
_bucket_ms: Dict[str, float] = {k: 0.0 for k in _BUCKET_KEYS}


def _bucket_of(name: str) -> Optional[str]:
    if name.startswith("comm."):
        return "collective"
    if name.startswith("compile."):
        return "compile"
    if name.startswith("ckpt."):
        return "checkpoint"
    if name == "step.update":
        return "optimizer"
    if name == "input.wait":
        return "input_wait"
    if name == "input.h2d":
        return "h2d"
    return None


def bucket_totals_ms() -> Dict[str, float]:
    """Cumulative per-bucket span ms since process start (fixed key
    set, all zeros while tracing is disabled).  Buckets measure span
    wall time on whatever thread ran them, so phases that overlap the
    step (producer-side H2D, background checkpoint serialize) can sum
    past host_ms — consumers treat them as attribution signals, not a
    partition."""
    with _LOCK:
        return dict(_bucket_ms)


# lazily bound clustermon module (rank stamping); never imported on the
# disabled path
_clustermon = None


def _rank_world():
    global _clustermon
    if _clustermon is None:
        from . import clustermon
        _clustermon = clustermon
    try:
        return _clustermon.rank_world()
    except Exception:
        return (0, 1)

_forced: Optional[bool] = None   # enable()/disable() override; None = env


def enable() -> None:
    """Force tracing on for this process (overrides env)."""
    global _forced
    _forced = True


def disable() -> None:
    """Force tracing off for this process (overrides env)."""
    global _forced
    _forced = False


def _env_default() -> None:
    """Drop any enable()/disable() override; env vars decide again."""
    global _forced
    _forced = None


def enabled() -> bool:
    """True when spans are being collected.  ``MXNET_TRACE`` wins when
    set (``0``/``false``/``off`` force-disables even with a JSONL sink
    or watchdog configured); otherwise a configured
    ``MXNET_TRACE_JSONL`` or watchdog implies collection."""
    if _forced is not None:
        return _forced
    env = os.environ
    v = env.get("MXNET_TRACE")
    if v is not None:
        on = v.strip().lower() not in _OFF_VALUES
    else:
        on = (_watchdog is not None or bool(env.get("MXNET_TRACE_JSONL"))
              or bool(env.get("MXNET_WATCHDOG_SEC")))
    if on and _watchdog is None and env.get("MXNET_WATCHDOG_SEC"):
        _start_watchdog_from_env()
    return on


def _capacity() -> int:
    global _cap_cache
    if _cap_cache is None:
        try:
            _cap_cache = max(16, int(os.environ.get("MXNET_TRACE_BUFFER",
                                                    _DEFAULT_BUFFER)))
        except ValueError:
            _cap_cache = _DEFAULT_BUFFER
    return _cap_cache


class _NullSpan:
    """Shared do-nothing span: the disabled fast path returns THIS
    singleton from every call — zero per-call allocation."""

    __slots__ = ()
    span_id = None
    parent_id = None
    name = "<disabled>"

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return False

    def annotate(self, **attrs):
        return self

    def finish(self):
        pass


_NULL = _NullSpan()


class Span:
    """One timed interval.  Use via ``with span(...)`` (nested, same
    thread) or ``begin()/end()`` (cross-thread); ``annotate`` attaches
    attributes that land in the Chrome event's ``args``."""

    __slots__ = ("name", "attrs", "t0", "t1", "tid", "span_id",
                 "parent_id", "_stacked")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.t1 = None
        self.tid = threading.get_ident()
        self.span_id = next(_ids)
        stack = getattr(_tls, "stack", None)
        self.parent_id = stack[-1].span_id if stack else None
        self._stacked = False
        with _LOCK:
            _open[self.span_id] = self
        self.t0 = time.perf_counter()

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append(self)
        self._stacked = True
        return self

    def __exit__(self, et, ev, tb):
        if et is not None:
            self.attrs.setdefault("error", et.__name__)
        self.finish()
        return False

    def annotate(self, **attrs):
        self.attrs.update(attrs)
        return self

    def finish(self):
        if self.t1 is not None:        # idempotent
            return
        self.t1 = time.perf_counter()
        if self._stacked:
            stack = getattr(_tls, "stack", None)
            if stack:
                if stack[-1] is self:
                    stack.pop()
                elif self in stack:    # mis-nested exit; tolerate
                    stack.remove(self)
            self._stacked = False
        args = {"span_id": self.span_id}
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        args.update(self.attrs)
        _store(self.name, self.t0, self.t1, self.tid, args,
               span_id=self.span_id)


def span(name: str, **attrs) -> Any:
    """Nestable context-manager span; the shared no-op singleton when
    tracing is disabled (no object churn on the hot path)."""
    if not enabled():
        return _NULL
    return Span(name, attrs)


def begin(name: str, **attrs) -> Any:
    """Open a span WITHOUT entering it on this thread's stack — for
    intervals that end on another thread (serving requests, producer
    handoffs).  Pair with ``end(sp)`` / ``sp.finish()``."""
    if not enabled():
        return _NULL
    return Span(name, attrs)


def end(sp, **attrs) -> None:
    """Finish a span from ``begin`` (None/_NULL tolerated)."""
    if sp is None or sp is _NULL:
        return
    if attrs:
        sp.attrs.update(attrs)
    sp.finish()


def record_span(name: str, t_start: float, t_end: float, **attrs) -> None:
    """Book an interval measured out-of-band (``time.perf_counter``
    values).  Parented to the calling thread's current open span, so a
    wait measured inside a step nests under it."""
    if not enabled():
        return
    stack = getattr(_tls, "stack", None)
    args: Dict[str, Any] = {"span_id": next(_ids)}
    if stack:
        args["parent_id"] = stack[-1].span_id
    args.update(attrs)
    _store(name, t_start, t_end, threading.get_ident(), args)


def instant(name: str, **attrs) -> None:
    """Zero-duration marker event — how out-of-band state transitions
    (e.g. a clustermon incident opening or closing) land on the trace
    timeline next to the steps they explain.  No-op when tracing is
    disabled."""
    t = time.perf_counter()
    record_span(name, t, t, **attrs)


def _store(name: str, t0: float, t1: float, tid: int, args: dict,
           span_id: Optional[int] = None) -> None:
    """Append one completed span to the ring (+ JSONL sink)."""
    global _ring_pos
    cat = name.split(".", 1)[0]
    # every span carries its emitting rank so merged multi-host traces
    # (and the JSONL stream) stay attributable without filename lore
    args.setdefault("rank", _rank_world()[0])
    ev = {"name": name, "ph": "X", "cat": cat,
          "ts": round((t0 - _EPOCH) * 1e6, 3),
          "dur": round(max(0.0, t1 - t0) * 1e6, 3),
          "pid": _PID, "tid": tid, "args": args}
    watched = name.startswith(_WATCH_PREFIXES) or name in _WATCH_NAMES
    bucket = _bucket_of(name)
    with _LOCK:
        if bucket is not None:
            _bucket_ms[bucket] += max(0.0, t1 - t0) * 1e3
        if span_id is not None:
            _open.pop(span_id, None)
            _dumped.discard(span_id)
        cap = _capacity()
        if len(_ring) < cap:
            _ring.append(ev)
        else:
            _ring[_ring_pos] = ev
            _ring_pos = (_ring_pos + 1) % cap
            _C_DROPPED.inc()
        _C_SPANS.inc()
        if watched:
            ring = _durations.setdefault(name, [])
            ring.append(max(0.0, t1 - t0))
            if len(ring) > _DUR_KEEP:
                del ring[0]
    _emit_jsonl(ev)


# -- JSONL auto-sink (MXNET_TRACE_JSONL) -------------------------------------

_JSONL_LOCK = threading.Lock()
_jsonl = {"path": None, "f": None, "broken": None}


def _emit_jsonl(ev: dict) -> None:
    path = os.environ.get("MXNET_TRACE_JSONL") or None
    with _JSONL_LOCK:
        if path != _jsonl["path"]:
            f = _jsonl["f"]
            if f is not None:
                try:
                    f.close()
                except Exception:
                    pass
            _jsonl.update(path=path, f=None, broken=None)
        if not path or _jsonl["broken"] == path:
            return
        if _jsonl["f"] is None:
            try:
                _jsonl["f"] = open(path, "a", buffering=1)
            except OSError:
                _jsonl["broken"] = path
                from .log import get_logger
                get_logger("mxnet_tpu_torch.tracing").exception(
                    "cannot open MXNET_TRACE_JSONL=%r; trace JSONL "
                    "disabled", path)
                return
        try:
            _jsonl["f"].write(json.dumps(ev) + "\n")
        except Exception:
            try:
                _jsonl["f"].close()
            except Exception:
                pass
            _jsonl.update(f=None, broken=path)


# -- views / export ----------------------------------------------------------

def _completed_events() -> List[dict]:
    """Ring contents, oldest → newest."""
    with _LOCK:
        return _ring[_ring_pos:] + _ring[:_ring_pos]


def recent(n: int = 100) -> List[dict]:
    """The most recent ≤ n completed spans (Chrome-event dicts)."""
    evs = _completed_events()
    return evs[-n:]


def open_spans() -> List[dict]:
    """Live (begun, unfinished) spans with their current age."""
    now = time.perf_counter()
    with _LOCK:
        spans = list(_open.values())
    out = []
    for sp in spans:
        out.append({"name": sp.name, "span_id": sp.span_id,
                    "parent_id": sp.parent_id, "tid": sp.tid,
                    "ts": round((sp.t0 - _EPOCH) * 1e6, 3),
                    "elapsed_ms": round((now - sp.t0) * 1e3, 3),
                    "args": dict(sp.attrs)})
    return out


def aggregate() -> Dict[str, dict]:
    """Per-name rollup of the ring buffer: {name: {count, total_ms,
    mean_ms, max_ms}} — what profiler.dumps() prints."""
    agg: Dict[str, dict] = {}
    for ev in _completed_events():
        a = agg.setdefault(ev["name"], {"count": 0, "total_ms": 0.0,
                                        "max_ms": 0.0})
        ms = ev["dur"] / 1e3
        a["count"] += 1
        a["total_ms"] += ms
        if ms > a["max_ms"]:
            a["max_ms"] = ms
    for a in agg.values():
        a["mean_ms"] = a["total_ms"] / a["count"]
    return agg


def export(path: str) -> str:
    """Write the ring buffer as Chrome-trace JSON (load in Perfetto /
    chrome://tracing).  Open spans are included as zero-finished "X"
    events flagged ``"open": true`` so a stalled run's export still
    shows what was in flight."""
    evs = _completed_events()
    rank, world = _rank_world()
    meta = [{"name": "process_name", "ph": "M", "pid": _PID, "tid": 0,
             "args": {"name": f"mxnet_tpu_torch rank {rank}/{world}"}},
            {"name": "rank_world", "ph": "M", "pid": _PID, "tid": 0,
             "args": {"rank": rank, "world": world}},
            {"name": "trace_epoch_unix", "ph": "M", "pid": _PID, "tid": 0,
             "args": {"ts": _EPOCH_WALL}}]
    with _LOCK:
        names = dict(_thread_names)
    for tid, nm in names.items():
        meta.append({"name": "thread_name", "ph": "M", "pid": _PID,
                     "tid": tid, "args": {"name": nm}})
    for o in open_spans():
        evs.append({"name": o["name"], "ph": "X", "cat":
                    o["name"].split(".", 1)[0], "ts": o["ts"],
                    "dur": round(o["elapsed_ms"] * 1e3, 3),
                    "pid": _PID, "tid": o["tid"],
                    "args": dict(o["args"], span_id=o["span_id"],
                                 open=True)})
    doc = {"traceEvents": meta + evs, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def span_count() -> int:
    return _C_SPANS.value


def dropped_count() -> int:
    return _C_DROPPED.value


def clear() -> None:
    """Empty the ring buffer and duration history (open spans and
    counters are left alone — counters reset via telemetry.reset)."""
    global _ring_pos, _cap_cache
    with _LOCK:
        _ring.clear()
        _ring_pos = 0
        _cap_cache = None        # re-read MXNET_TRACE_BUFFER
        _durations.clear()
        _dumped.clear()
        for k in _bucket_ms:
            _bucket_ms[k] = 0.0


# -- stall watchdog ----------------------------------------------------------

_watchdog: Optional["_Watchdog"] = None
_MIN_SAMPLES = 4                 # no p95 baseline below this


def register_thread(name: Optional[str] = None) -> None:
    """Label the calling thread in stack dumps and trace exports."""
    with _LOCK:
        _thread_names[threading.get_ident()] = \
            name or threading.current_thread().name


def _percentile(sorted_vals: List[float], q: float) -> float:
    k = max(0, min(len(sorted_vals) - 1,
                   round(q / 100 * (len(sorted_vals) - 1))))
    return sorted_vals[k]


def _sweep(interval: float, factor: float) -> List[int]:
    """One watchdog pass; returns span_ids dumped this pass.  Split out
    from the thread loop so tests can drive it deterministically."""
    now = time.perf_counter()
    with _LOCK:
        candidates = [sp for sp in _open.values()
                      if (sp.name.startswith(_WATCH_PREFIXES)
                          or sp.name in _WATCH_NAMES)
                      and sp.span_id not in _dumped]
        history = {sp.name: sorted(_durations.get(sp.name, ()))
                   for sp in candidates}
    fired = []
    for sp in candidates:
        if sp.t1 is not None:          # finished while we looked
            continue
        samples = history.get(sp.name) or []
        if len(samples) < _MIN_SAMPLES:
            continue
        p95 = _percentile(samples, 95)
        threshold = max(factor * p95, interval)
        elapsed = now - sp.t0
        if elapsed > threshold:
            with _LOCK:
                if sp.span_id in _dumped or sp.span_id not in _open:
                    continue
                _dumped.add(sp.span_id)
            _dump_stall(sp, elapsed, p95, factor)
            fired.append(sp.span_id)
    return fired


def _dump_stall(sp: "Span", elapsed: float, p95: float,
                factor: float) -> None:
    """One diagnostic dump per incident: every live span + every
    thread's Python stack."""
    from .log import get_logger
    rank, world = _rank_world()
    lines = [
        f"STALL: rank {rank}/{world}: span {sp.name!r} "
        f"(id {sp.span_id}) open for "
        f"{elapsed * 1e3:.1f} ms > {factor:g} x p95 {p95 * 1e3:.1f} ms",
        "live spans:"]
    ckpt_open = []
    for o in open_spans():
        lines.append(f"  {o['name']} id={o['span_id']} "
                     f"tid={o['tid']} age={o['elapsed_ms']:.1f} ms "
                     f"{o['args']}")
        if o["name"].startswith("ckpt."):
            ckpt_open.append(o)
    # checkpoint/barrier state: on a multi-host stall the interesting
    # question is whether this rank is wedged INSIDE the commit
    # barrier (open ckpt.barrier span = waiting on peers' markers) or
    # behind a slow background save
    try:
        from . import checkpoint
        pending = checkpoint.pending_targets()
        lines.append(f"checkpoint: {len(pending)} pending background "
                     f"save(s): {pending if pending else '[]'}")
        if ckpt_open:
            names = ", ".join(
                f"{o['name']}(age {o['elapsed_ms']:.1f} ms)"
                for o in ckpt_open)
            lines.append(f"checkpoint: open spans: {names}"
                         + ("  << stuck in commit barrier: waiting on "
                            "peer rank markers"
                            if any(o["name"] == "ckpt.barrier"
                                   for o in ckpt_open) else ""))
    except Exception:
        pass           # a stall dump must never fail on diagnostics
    lines.append("thread stacks:")
    with _LOCK:
        names = dict(_thread_names)
    frames = sys._current_frames()
    known = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in frames.items():
        label = names.get(tid) or known.get(tid) or "?"
        lines.append(f"  -- thread {label} (tid {tid}) --")
        for ln in traceback.format_stack(frame):
            lines.append("  " + ln.rstrip())
    _C_DUMPS.inc()
    get_logger("mxnet_tpu_torch.tracing").warning("%s", "\n".join(lines))


class _Watchdog(threading.Thread):
    def __init__(self, interval: float, factor: float):
        super().__init__(name="mxnet-tracing-watchdog", daemon=True)
        self.interval = max(0.01, float(interval))
        self.factor = max(1.0, float(factor))
        self._stop_evt = threading.Event()

    def run(self):
        while not self._stop_evt.wait(self.interval):
            try:
                _sweep(self.interval, self.factor)
            except Exception:
                from .log import get_logger
                get_logger("mxnet_tpu_torch.tracing").exception(
                    "watchdog sweep failed")

    def stop(self):
        self._stop_evt.set()


def start_watchdog(seconds: float = 30.0, factor: float = 4.0) -> None:
    """Start (or restart) the stall-watchdog thread: poll every
    ``seconds``; dump when an open step/dispatch span's age exceeds
    ``factor`` × the rolling p95 of its completed history (needs ≥ 4
    samples — the first compile-heavy steps never false-positive)."""
    global _watchdog
    stop_watchdog()
    _watchdog = _Watchdog(seconds, factor)
    _watchdog.start()


def stop_watchdog() -> None:
    global _watchdog
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None


def _start_watchdog_from_env() -> None:
    global _watchdog
    if _forked:
        return
    try:
        sec = float(os.environ["MXNET_WATCHDOG_SEC"])
    except (KeyError, ValueError):
        return
    if sec <= 0:
        return
    try:
        factor = float(os.environ.get("MXNET_WATCHDOG_FACTOR", 4.0))
    except ValueError:
        factor = 4.0
    _watchdog = _Watchdog(sec, factor)
    _watchdog.start()


# a forked child (a DataLoader worker) has none of its parent's threads:
# it forgets the watchdog and starts none of its own
_forked = False


def _after_fork_in_child() -> None:
    global _watchdog, _forked, _LOCK, _JSONL_LOCK
    _watchdog = None
    _forked = True
    # a lock another thread held at the fork stays held in the child
    _LOCK = threading.Lock()
    _JSONL_LOCK = threading.Lock()


os.register_at_fork(after_in_child=_after_fork_in_child)
