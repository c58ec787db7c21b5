"""Process-wide metrics registry and the per-step record stream
(counterpart of ``mxnet_tpu/telemetry.py``).

One registry of counters, gauges and histograms (count, total, min, max
and a bounded ring of the most recent samples) and one record a step,
emitted by every step funnel: ``gluon.Trainer.step``,
``parallel.SPMDTrainer.step``/``run_steps``, the local kvstore's
``push``/``pushpull`` and the serving batcher's dispatches.  The
registry is the one source: ``profiler.counters()``,
``profiler.dumps()``, the JSONL stream, the Prometheus text and the
TensorBoard scalars read the same metric objects.

Hot-path contract: with no sink attached and the environment switches
unset, ``begin_step`` returns None after a few dict lookups and every
funnel skips straight through; counters still accumulate (plain
attribute adds).  A record is built from values already on the host:
the AMP section reads the loss scaler's host state, which the captured
funnels fold one step late, and ``device_mem`` reads the caching
allocator's statistics; nothing in a record waits for the card.

Sinks (any object with ``emit(record)``; fan-out):

- ``JSONLSink``: one JSON object a step, appended to a file;
  attached while ``MXNET_TELEMETRY_JSONL=<path>`` is set.
- ``LogSink``: a log line every N records; attached while
  ``MXNET_TELEMETRY_LOG_EVERY=<N>`` is set.
- ``TensorBoardSink``: scalars through a SummaryWriter
  (``contrib/tensorboard.py``).
- ``clustermon.SpoolSink``: the rank's spool under a shared directory;
  attached while ``MXNET_CLUSTER_DIR=<dir>`` is set, which also starts
  rank 0's aggregator.  ``MXNET_METRICS_PORT=<port>`` starts the
  standalone ``/metrics`` exporter.

The switches are read again at every ``begin_step``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
           "metrics", "snapshot", "reset", "add_sink", "remove_sink",
           "clear_sinks", "sinks", "enabled", "begin_step", "end_step",
           "record_compile", "record_comm_bytes", "record_op_time",
           "record_serving_batch", "record_input_wait", "record_h2d_bytes",
           "step_count", "last_record",
           "JSONLSink", "LogSink", "TensorBoardSink",
           "device_memory_record"]

_LOCK = threading.Lock()

# samples a histogram keeps (the most recent), beside its aggregates
_RESERVOIR = 64


class Counter:
    """Add-only counter; ``value`` may be int or float."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def get(self):
        return self.value

    def reset(self):
        self.value = 0

    def describe(self):
        return self.value


class Gauge:
    """Last-value metric."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = None

    def set(self, v):
        self.value = v

    def inc(self, n=1):
        self.value = (self.value or 0) + n

    def dec(self, n=1):
        self.value = (self.value or 0) - n

    def get(self):
        return self.value

    def reset(self):
        self.value = None

    def describe(self):
        return self.value


class Histogram:
    """A distribution: count, total, min and max, and a ring of the most
    recent ``_RESERVOIR`` samples (O(1) in time and memory a sample)."""

    __slots__ = ("name", "count", "total", "min", "max", "_ring", "_pos")

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def observe(self, v: float):
        self.count += 1
        self.total += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if len(self._ring) < _RESERVOIR:
            self._ring.append(v)
        else:
            self._ring[self._pos] = v
            self._pos = (self._pos + 1) % _RESERVOIR

    @property
    def mean(self):
        return self.total / self.count if self.count else 0.0

    def samples(self) -> List[float]:
        """The most recent samples (at most ``_RESERVOIR``)."""
        return list(self._ring)

    def get(self):
        return self.describe()

    def reset(self):
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._ring: List[float] = []
        self._pos = 0

    def describe(self):
        return {"count": self.count, "total": self.total,
                "min": self.min, "max": self.max, "mean": self.mean}


_REGISTRY: Dict[str, Any] = {}


def _get_or_create(name: str, cls):
    m = _REGISTRY.get(name)
    if m is None:
        with _LOCK:
            m = _REGISTRY.get(name)
            if m is None:
                m = _REGISTRY[name] = cls(name)
    if not isinstance(m, cls):
        from .base import MXNetError
        raise MXNetError(
            f"telemetry metric {name!r} already registered as "
            f"{type(m).__name__}, not {cls.__name__}")
    return m


def counter(name: str) -> Counter:
    return _get_or_create(name, Counter)


def gauge(name: str) -> Gauge:
    return _get_or_create(name, Gauge)


def histogram(name: str) -> Histogram:
    return _get_or_create(name, Histogram)


def metrics(prefix: str = "") -> Dict[str, Any]:
    """The live metric objects whose names start with ``prefix``."""
    # the item list is taken under the lock: a scrape iterating while a
    # stepping thread registers a metric must not see the dict change
    with _LOCK:
        items = sorted(_REGISTRY.items())
    return {k: v for k, v in items if k.startswith(prefix)}


def snapshot(prefix: str = "") -> Dict[str, Any]:
    """Plain-data view of the registry (JSON-serializable)."""
    return {k: v.describe() for k, v in metrics(prefix).items()}


def reset(prefix: str = "") -> None:
    """Zero the values of the metrics whose names start with ``prefix``,
    in place: modules keep references to their metrics."""
    for v in metrics(prefix).values():
        v.reset()


# -- the metrics every step record is derived from (made at import, so
# that callers may keep references and a snapshot shows the keys) ---------

_C_COMPILES = counter("compile.count")        # captures, all sites
_C_COMPILE_MS = counter("compile.ms")         # their wall ms
_C_COMM_BYTES = counter("comm.bytes")         # collective payload bytes
_C_STEPS = counter("telemetry.steps")         # emitted step records
_C_DISPATCH = counter("dispatch.count")       # launches of a funnel
# whole-step capture (imperative/cached_step.py writes these)
_CACHED_STEP = ("hits", "compiles", "fallbacks", "graph_breaks")
_C_CACHED = tuple(counter(f"cachedstep.{k}") for k in _CACHED_STEP)
# serving (``serving/`` writes these)
_C_SRV_REQS = counter("serving.requests")
_C_SRV_BATCHES = counter("serving.batches")
_C_SRV_EAGER = counter("serving.eager_batches")
_C_SRV_REJ_FULL = counter("serving.rejected.queue_full")
_C_SRV_REJ_SHAPE = counter("serving.rejected.shape")
_C_SRV_TIMEOUTS = counter("serving.timeouts")
_G_SRV_QUEUE = gauge("serving.queue_depth")
_H_SRV_BATCH = histogram("serving.batch_size")
_H_SRV_WASTE = histogram("serving.padding_waste")
_H_SRV_REQ_MS = histogram("serving.request_ms")
# the decode plane (``serving/decode/`` writes these)
for _n in ("tokens", "prefill_tokens", "evictions", "spec_proposed",
           "spec_accepted", "steps"):
    counter(f"decode.{_n}")
for _n in ("slots_active", "pages_used", "spec_accept_rate"):
    gauge(f"decode.{_n}")
# the input pipeline (``data/device_pipeline.py`` and the funnels)
_C_INPUT_WAIT_MS = counter("input.wait_ms")    # consumer blocked on a batch
_C_H2D_BYTES = counter("input.h2d_bytes")      # host-to-device payload bytes
_C_STEP_H2D = counter("input.step_h2d")        # host copies inside a step
counter("input.window_dropped")
counter("input.replayed")
# the checkpoint service (``checkpoint.py``, ``checkpoint_gc.py``)
_C_CKPT_SAVES = counter("checkpoint.saves")
_C_CKPT_FAILURES = counter("checkpoint.failures")
_C_CKPT_BYTES = counter("checkpoint.bytes")
_C_CKPT_GC = counter("checkpoint.gc_removed")
_C_CKPT_VPASS = counter("checkpoint.verify_passes")
_C_CKPT_VFAIL = counter("checkpoint.verify_failures")
_C_CKPT_FAULTS = counter("checkpoint.faults_injected")
# ms this rank spent blocked in the commit barrier (the rank with about
# no wait is the one the others waited for)
_C_CKPT_BARRIER_MS = counter("checkpoint.barrier_wait_ms_total")
# the collective split and the optimizer state's residency; the split
# counters are the ones ``record_comm_bytes(kind=...)`` makes, so split
# bytes also add to comm.bytes
_C_RS_BYTES = counter("comm.reduce_scatter.bytes")
_C_AG_BYTES = counter("comm.all_gather.bytes")
_C_AR_BYTES = counter("comm.allreduce.bytes")
_G_OPT_STATE = gauge("opt_state.bytes_per_device")
# the same wire bytes by the mesh axis that carried them: a view, not
# added to comm.bytes (no mesh axis is ported: these stay 0)
MESH_AXES = ("dp", "tp", "pp", "sp", "ep")
_C_AXIS_BYTES = {ax: counter(f"comm.{ax}.bytes") for ax in MESH_AXES}
# Switch-MoE tokens past their expert's capacity (not ported: stays 0)
_C_MOE_DROPPED = counter("moe.dropped_tokens")
# the kernel layer (``kernels/registry.py``)
_C_KRN_HITS = counter("kernel.cache_hits")
_C_KRN_MISSES = counter("kernel.cache_misses")
_C_KRN_TUNE_MS = counter("kernel.tune_ms")
_C_KRN_TUNE_RUNS = counter("kernel.tune_measurements")
_C_KRN_FALLBACKS = counter("kernel.fallbacks")
_C_KRN_WARM = counter("kernel.warm_loaded")
# the executable-artifact store (not ported: these stay 0)
_C_ART_HITS = counter("artifact.hits")
_C_ART_MISSES = counter("artifact.misses")
_C_ART_SAVES = counter("artifact.saves")
_C_ART_BYTES = counter("artifact.bytes")
_C_ART_LOAD_MS = counter("artifact.load_ms")
_C_ART_DESER_FAIL = counter("artifact.deserialize_failures")
# the sharded embedding tables (not ported: these stay 0)
_C_EMB_PULL_ROWS = counter("embedding.rows_pulled")
_C_EMB_PUSH_ROWS = counter("embedding.rows_pushed")
_C_EMB_SPARSE_BYTES = counter("embedding.sparse_bytes")
_C_EMB_DENSE_BYTES = counter("embedding.dense_equiv_bytes")
_C_EMB_CACHE_HITS = counter("embedding.cache_hits")
_C_EMB_CACHE_MISSES = counter("embedding.cache_misses")
_C_EMB_CACHE_EVICTS = counter("embedding.cache_evictions")
_C_EMB_SPILLS = counter("embedding.rows_spilled")
# mixed precision (``amp/loss_scaler.py`` folds a captured step's scaler
# state into these one step late, from a copy already on the host)
_C_AMP_OVERFLOWS = counter("amp.overflow_steps")
_C_AMP_SKIPPED = counter("amp.skipped_updates")
_G_AMP_SCALE = gauge("amp.loss_scale")
counter("io.libsvm.discarded_rows")


def record_compile(seconds: float, kind: str) -> None:
    """Account one materialised executable at compile site ``kind``."""
    ms = seconds * 1e3
    _C_COMPILES.inc()
    _C_COMPILE_MS.inc(ms)
    counter(f"compile.{kind}.count").inc()
    counter(f"compile.{kind}.ms").inc(ms)


def record_opt_state_bytes(per_device: int) -> None:
    """Refresh the optimizer-state residency gauge (bytes on the busiest
    device)."""
    _G_OPT_STATE.set(int(per_device))


def record_comm_bytes(n: int, kind: str = "dense") -> None:
    """Account collective payload bytes, in ``comm.bytes`` and in
    ``comm.<kind>.bytes``."""
    _C_COMM_BYTES.inc(int(n))
    counter(f"comm.{kind}.bytes").inc(int(n))


def record_axis_comm_bytes(n: int, axis: str) -> None:
    """Attribute collective payload bytes to the mesh axis that carried
    them (``comm.<axis>.bytes``); not added to ``comm.bytes``."""
    c = _C_AXIS_BYTES.get(axis)
    if c is None:
        c = counter(f"comm.{axis}.bytes")
    c.inc(int(n))


def record_embedding_wire(rows_pulled: int = 0, rows_pushed: int = 0,
                          sparse_bytes: int = 0,
                          dense_equiv_bytes: int = 0) -> None:
    """Account one sharded-embedding wire exchange (sparse bytes also add
    to ``comm.sparse.bytes``)."""
    if rows_pulled:
        _C_EMB_PULL_ROWS.inc(int(rows_pulled))
    if rows_pushed:
        _C_EMB_PUSH_ROWS.inc(int(rows_pushed))
    if sparse_bytes:
        _C_EMB_SPARSE_BYTES.inc(int(sparse_bytes))
        record_comm_bytes(sparse_bytes, kind="sparse")
    if dense_equiv_bytes:
        _C_EMB_DENSE_BYTES.inc(int(dense_equiv_bytes))


def record_dispatch(n: int = 1) -> None:
    """Account ``n`` launches of a funnel's executable (a replayed graph
    or an eager run of one): a ``run_steps`` window of n steps is n."""
    _C_DISPATCH.inc(int(n))


def record_moe_dropped(n) -> None:
    """Account Switch-MoE tokens dropped by the per-expert capacity."""
    n = int(n)
    if n > 0:
        _C_MOE_DROPPED.inc(n)


def record_op_time(name: str, seconds: float) -> None:
    """One host sample of an op's time (the profiler's op table lives in
    the registry as ``op.<name>`` histograms)."""
    histogram("op." + name).observe(seconds)


def record_serving_batch(n_requests: int, padded_size: int,
                         latencies_ms, eager: bool = False) -> None:
    """Account one coalesced serving dispatch: ``n_requests`` real rows
    padded to ``padded_size``, with each request's submit-to-response
    latency."""
    _C_SRV_REQS.inc(int(n_requests))
    _C_SRV_BATCHES.inc()
    if eager:
        _C_SRV_EAGER.inc()
    _H_SRV_BATCH.observe(float(n_requests))
    if padded_size:
        _H_SRV_WASTE.observe((padded_size - n_requests) / padded_size)
    for ms in latencies_ms:
        _H_SRV_REQ_MS.observe(ms)


# the wait for step N's batch comes before begin_step(N) (the loop calls
# next() and then step()), so the consumer deposits it here and the next
# step record drains it; per thread, as the wait is measured on the
# consuming thread
_wait_tls = threading.local()


def record_input_wait(seconds: float) -> None:
    """Account the time a consumer blocked waiting for its next batch
    (``DevicePrefetcher.__next__``): about 0 while the pipeline keeps
    ahead of the step."""
    ms = seconds * 1e3
    _C_INPUT_WAIT_MS.inc(ms)
    if _SINKS:
        _wait_tls.ms = getattr(_wait_tls, "ms", 0.0) + ms


def record_h2d_bytes(n: int, step_path: bool = False) -> None:
    """Account one host-to-device batch copy of ``n`` bytes;
    ``step_path=True`` marks one made inside a step's call (the copy the
    device prefetcher exists to take off the step), counted once in
    ``input.step_h2d``."""
    _C_H2D_BYTES.inc(int(n))
    if step_path:
        _C_STEP_H2D.inc()


# -- sinks -------------------------------------------------------------------

_SINKS: List[Any] = []


def add_sink(sink) -> None:
    with _LOCK:
        if sink not in _SINKS:
            _SINKS.append(sink)


def remove_sink(sink) -> None:
    with _LOCK:
        if sink in _SINKS:
            _SINKS.remove(sink)
    # detaching a sink the environment made also forgets its cached
    # value, so that the switch, still set, attaches a new one
    for key, s in _env_sinks.items():
        if s is sink:
            _env_sinks[key] = None
            _env_cache[key] = None
    close = getattr(sink, "close", None)
    if close is not None:
        try:
            close()
        except Exception:
            pass


def clear_sinks() -> None:
    for s in list(_SINKS):
        remove_sink(s)


def sinks() -> List[Any]:
    return list(_SINKS)


class JSONLSink:
    """One JSON object a step record, appended to ``path`` (line
    buffered, so that a live run can be tailed)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def emit(self, record: dict) -> None:
        if self._f is None:
            self._f = open(self.path, "a", buffering=1)
        self._f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class LogSink:
    """A log line every ``every`` emitted step records."""

    def __init__(self, every: int = 50):
        self.every = max(1, int(every))
        self._n = 0

    def emit(self, record: dict) -> None:
        self._n += 1
        if self._n % self.every:
            return
        from .log import get_logger
        mem = record.get("device_mem") or []
        in_use = sum(d.get("bytes_in_use", 0) for d in mem)
        get_logger("mxnet_tpu_torch.telemetry").info(
            "step %d [%s] host %.2f ms, %d compiles (%.0f ms), "
            "%d comm bytes, mem %.1f MiB",
            record["step"], record.get("source", "?"),
            record.get("host_ms") or 0.0, record.get("compiles", 0),
            record.get("compile_ms", 0), record.get("collective_bytes", 0),
            in_use / 1048576)

    def close(self) -> None:
        pass


class TensorBoardSink:
    """Step-record scalars through a SummaryWriter: an object with
    ``add_scalar``, or a log directory for ``contrib.tensorboard``'s
    writer."""

    _SCALARS = ("host_ms", "device_ms", "compiles", "compile_ms",
                "collective_bytes")

    def __init__(self, logdir_or_writer):
        if hasattr(logdir_or_writer, "add_scalar"):
            self.writer = logdir_or_writer
        else:
            from .contrib.tensorboard import _summary_writer
            self.writer = _summary_writer(logdir_or_writer)

    def emit(self, record: dict) -> None:
        step = record["step"]
        for k in self._SCALARS:
            v = record.get(k)
            if v is not None:
                self.writer.add_scalar(f"telemetry/{k}", v,
                                       global_step=step)
        mem = record.get("device_mem") or []
        if mem:
            self.writer.add_scalar(
                "telemetry/device_bytes_in_use",
                sum(d.get("bytes_in_use", 0) for d in mem),
                global_step=step)
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()


# -- the environment's sinks -------------------------------------------------
# MXNET_TELEMETRY_JSONL, MXNET_TELEMETRY_LOG_EVERY, MXNET_CLUSTER_DIR and
# MXNET_METRICS_PORT are read again at every begin_step, so a long-lived
# process (or a test) can flip them; clustermon is imported only once
# one of its two switches is set.

_env_cache = {"jsonl": None, "log": None, "cluster": None, "mport": None}
_env_sinks = {"jsonl": None, "log": None, "cluster": None}


def _refresh_env_sinks() -> None:
    env = os.environ
    jsonl = env.get("MXNET_TELEMETRY_JSONL") or None
    if jsonl != _env_cache["jsonl"]:
        if _env_sinks["jsonl"] is not None:
            remove_sink(_env_sinks["jsonl"])   # also resets the cache entry
        _env_cache["jsonl"] = jsonl
        if jsonl:
            _env_sinks["jsonl"] = JSONLSink(jsonl)
            add_sink(_env_sinks["jsonl"])
    log_every = env.get("MXNET_TELEMETRY_LOG_EVERY") or None
    if log_every != _env_cache["log"]:
        if _env_sinks["log"] is not None:
            remove_sink(_env_sinks["log"])
        _env_cache["log"] = log_every
        if log_every:
            try:
                _env_sinks["log"] = LogSink(int(log_every))
                add_sink(_env_sinks["log"])
            except ValueError:
                from .log import get_logger
                get_logger("mxnet_tpu_torch.telemetry").warning(
                    "invalid MXNET_TELEMETRY_LOG_EVERY=%r (want an int)",
                    log_every)
    cluster = env.get("MXNET_CLUSTER_DIR") or None
    # the rotation knobs are the sink's constructor state: a change
    # attaches a new sink (None while off, so that the off path never
    # imports clustermon)
    ckey = None if cluster is None else (
        cluster, env.get("MXNET_CLUSTER_SPOOL_MAX_MB") or None,
        env.get("MXNET_CLUSTER_SPOOL_KEEP") or None)
    if ckey != _env_cache["cluster"]:
        if _env_sinks["cluster"] is not None:
            remove_sink(_env_sinks["cluster"])
        _env_cache["cluster"] = ckey
        from . import clustermon
        if cluster:
            try:
                _env_sinks["cluster"] = clustermon.SpoolSink(cluster)
                add_sink(_env_sinks["cluster"])
            except OSError:
                from .log import get_logger
                get_logger("mxnet_tpu_torch.telemetry").exception(
                    "cannot open cluster spool dir %r; disabling", cluster)
        clustermon._on_cluster_dir(cluster)
    mport = env.get("MXNET_METRICS_PORT") or None
    if mport != _env_cache["mport"]:
        _env_cache["mport"] = mport
        from . import clustermon
        clustermon._on_metrics_port(mport)


def enabled() -> bool:
    """True while a sink is (or should be) attached: the step-record
    stream runs only then; bare counters always do."""
    _refresh_env_sinks()
    return bool(_SINKS)


# serving/slo.py installs a zero-argument callable giving the record's
# ``serving_slo`` section while objectives are declared (None: no
# section); a hook keeps this module free of the serving package
_slo_provider = None


def set_slo_provider(fn) -> None:
    global _slo_provider
    _slo_provider = fn


# -- the per-step record stream ---------------------------------------------

_CKPT = (("saves", _C_CKPT_SAVES), ("failures", _C_CKPT_FAILURES),
         ("bytes", _C_CKPT_BYTES), ("gc_removed", _C_CKPT_GC),
         ("verify_passes", _C_CKPT_VPASS),
         ("verify_failures", _C_CKPT_VFAIL))
_KERNEL = (("cache_hits", _C_KRN_HITS), ("cache_misses", _C_KRN_MISSES),
           ("tune_ms", _C_KRN_TUNE_MS),
           ("tune_measurements", _C_KRN_TUNE_RUNS),
           ("fallbacks", _C_KRN_FALLBACKS))
_ARTIFACT = (("hits", _C_ART_HITS), ("misses", _C_ART_MISSES),
             ("saves", _C_ART_SAVES), ("bytes", _C_ART_BYTES),
             ("load_ms", _C_ART_LOAD_MS),
             ("deserialize_failures", _C_ART_DESER_FAIL))
_EMBEDDING = (("rows_pulled", _C_EMB_PULL_ROWS),
              ("rows_pushed", _C_EMB_PUSH_ROWS),
              ("sparse_bytes", _C_EMB_SPARSE_BYTES),
              ("dense_equiv_bytes", _C_EMB_DENSE_BYTES),
              ("cache_hits", _C_EMB_CACHE_HITS),
              ("cache_misses", _C_EMB_CACHE_MISSES),
              ("cache_evictions", _C_EMB_CACHE_EVICTS),
              ("rows_spilled", _C_EMB_SPILLS))
_SPLIT = (("reduce_scatter", _C_RS_BYTES), ("all_gather", _C_AG_BYTES),
          ("allreduce", _C_AR_BYTES))
# the record's millisecond fields, rounded to the microsecond
_MS_FIELDS = frozenset({"tune_ms", "load_ms"})


class _StepToken:
    """The counters' values at a funnel's entry, for the record's
    deltas."""

    __slots__ = ("t0", "compiles", "compile_ms", "comm_bytes", "dispatches",
                 "h2d_bytes", "cached", "ckpt", "barrier_ms", "kernel",
                 "artifact", "embedding", "split", "axis_bytes",
                 "amp_overflows", "amp_skipped", "moe_dropped", "buckets")

    def __init__(self):
        from . import tracing
        self.t0 = time.perf_counter()
        self.compiles = _C_COMPILES.value
        self.compile_ms = _C_COMPILE_MS.value
        self.comm_bytes = _C_COMM_BYTES.value
        self.dispatches = _C_DISPATCH.value
        self.h2d_bytes = _C_H2D_BYTES.value
        self.cached = tuple(c.value for c in _C_CACHED)
        self.ckpt = tuple(c.value for _, c in _CKPT)
        self.barrier_ms = _C_CKPT_BARRIER_MS.value
        self.kernel = tuple(c.value for _, c in _KERNEL)
        self.artifact = tuple(c.value for _, c in _ARTIFACT)
        self.embedding = tuple(c.value for _, c in _EMBEDDING)
        self.split = tuple(c.value for _, c in _SPLIT)
        self.axis_bytes = tuple(_C_AXIS_BYTES[ax].value for ax in MESH_AXES)
        self.amp_overflows = _C_AMP_OVERFLOWS.value
        self.amp_skipped = _C_AMP_SKIPPED.value
        self.moe_dropped = _C_MOE_DROPPED.value
        self.buckets = tracing.bucket_totals_ms()


def _deltas(pairs, base) -> Dict[str, Any]:
    out = {}
    for (k, c), v in zip(pairs, base):
        d = c.value - v
        out[k] = round(d, 3) if k in _MS_FIELDS else d
    return out


# nesting: gluon.Trainer.step pushes through the kvstore, and only the
# outermost funnel emits; per thread, so that two trainers stepping in
# two threads are not nested in each other
_tls = threading.local()
_last_record: Optional[dict] = None

# device time: profiler.stop() notes the finished trace here, and the
# next record carries its device ms over the records emitted while it ran
_trace_note = {"dir": None, "steps_at_start": 0}


def _note_trace_start() -> None:
    _trace_note["steps_at_start"] = _C_STEPS.value


def _note_trace_stop(trace_dir: Optional[str]) -> None:
    if trace_dir is not None:
        _trace_note["dir"] = trace_dir


def _consume_device_ms() -> Optional[float]:
    """Device ms a step from the last finished profiler cycle, over the
    step records emitted while it ran: None when no cycle finished since
    the last record, and None when its trace has no device events
    (``kineto.device_total_ms``)."""
    tdir = _trace_note["dir"]
    if tdir is None:
        return None
    _trace_note["dir"] = None
    from . import kineto
    total_ms = kineto.device_total_ms(tdir)
    if total_ms is None:
        return None
    n = max(1, _C_STEPS.value - _trace_note["steps_at_start"])
    return total_ms / n


def device_memory_record() -> List[dict]:
    """The caching allocator's figures for each initialised CUDA device:
    ``[{device, bytes_in_use, peak_bytes_in_use, bytes_limit}]``; ``[]``
    where no CUDA device is initialised."""
    import torch
    if not torch.cuda.is_initialized():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        try:
            st = torch.cuda.memory_stats(i)
            limit = torch.cuda.get_device_properties(i).total_memory
        except Exception:
            st, limit = {}, 0
        out.append({"device": f"cuda:{i}",
                    "bytes_in_use": int(st.get("allocated_bytes.all.current",
                                               0)),
                    "peak_bytes_in_use": int(st.get(
                        "allocated_bytes.all.peak", 0)),
                    "bytes_limit": int(limit)})
    return out


def begin_step():
    """Enter a step funnel: None (the no-op path) when no sink is
    attached, "nested" inside another funnel on this thread, else a
    token holding the counter baselines for this step's deltas."""
    depth = getattr(_tls, "depth", 0)
    if depth == 0 and not enabled():
        return None
    _tls.depth = depth + 1
    if depth:
        return "nested"
    return _StepToken()


def end_step(token, source: str, extra: Optional[dict] = None) -> None:
    """Leave a step funnel; the outermost one emits one record to every
    sink (``extra`` merges into it)."""
    global _last_record
    if token is None:
        return
    _tls.depth = getattr(_tls, "depth", 1) - 1
    if token == "nested":
        return
    host_ms = (time.perf_counter() - token.t0) * 1e3
    # before this record is counted: the cycle's steps are the records
    # emitted while it ran (the reference counts this one too, F19)
    device_ms = _consume_device_ms()
    _C_STEPS.inc()
    wait_ms = getattr(_wait_tls, "ms", 0.0)
    _wait_tls.ms = 0.0
    from . import clustermon, tracing
    from .amp import policy as _amp_policy
    rank, world = clustermon.rank_world()
    split = _deltas(_SPLIT, token.split)
    split["by_axis"] = {ax: _C_AXIS_BYTES[ax].value - v
                        for ax, v in zip(MESH_AXES, token.axis_bytes)}
    ckpt = _deltas(_CKPT, token.ckpt)
    ckpt["barrier_wait_ms"] = round(
        _C_CKPT_BARRIER_MS.value - token.barrier_ms, 3)
    record = {
        "step": _C_STEPS.value,
        "ts": round(time.time(), 3),
        "source": source,
        "rank": rank,
        "world": world,
        "host_ms": round(host_ms, 3),
        "device_ms": device_ms,
        "compiles": _C_COMPILES.value - token.compiles,
        "compile_ms": round(_C_COMPILE_MS.value - token.compile_ms, 3),
        "collective_bytes": _C_COMM_BYTES.value - token.comm_bytes,
        "collective_split": split,
        "opt_state_bytes": _G_OPT_STATE.value,
        "device_mem": device_memory_record(),
        "dispatches": _C_DISPATCH.value - token.dispatches,
        # the consumer's wait for this step's batch, and the host-to-device
        # bytes accounted while the step ran
        "input_wait_ms": round(wait_ms, 3),
        "h2d_bytes": _C_H2D_BYTES.value - token.h2d_bytes,
        "cached_step": {k: c.value - v for k, c, v in
                        zip(_CACHED_STEP, _C_CACHED, token.cached)},
        # saves published in this step's window (the writer thread
        # commits off the step path)
        "checkpoint": ckpt,
        "kernel": _deltas(_KERNEL, token.kernel),
        "artifact": _deltas(_ARTIFACT, token.artifact),
        "embedding": _deltas(_EMBEDDING, token.embedding),
    }
    # only while the AMP policy is on; the scale and the overflow counts
    # are the host's, folded one step late from the captured step's
    # device state (never read from the card here)
    if _amp_policy.enabled():
        record["amp"] = {
            "compute_dtype": _amp_policy.compute_dtype_str(),
            "loss_scale": _G_AMP_SCALE.value,
            "overflow_steps": _C_AMP_OVERFLOWS.value - token.amp_overflows,
            "skipped_updates": _C_AMP_SKIPPED.value - token.amp_skipped,
        }
    if _C_MOE_DROPPED.value > 0:
        record["moe"] = {
            "dropped_tokens": _C_MOE_DROPPED.value - token.moe_dropped}
    if _slo_provider is not None:
        try:
            slo_sec = _slo_provider()
        except Exception:
            slo_sec = None
        if slo_sec:
            record["serving_slo"] = slo_sec
    # where the step's wall time went, from the span buckets' deltas (all
    # zeros while tracing is off), the rest reported as compute
    buckets = tracing.bucket_totals_ms()
    cp = {k: round(max(0.0, buckets[k] - token.buckets.get(k, 0.0)), 3)
          for k in buckets}
    cp["compute"] = round(max(0.0, host_ms - sum(cp.values())), 3)
    record["critical_path"] = cp
    histogram("step.host_ms").observe(host_ms)
    if extra:
        record.update(extra)
    _last_record = record
    # the sinks are emitted to outside the lock: a sink may make metrics
    with _LOCK:
        sinks_now = list(_SINKS)
    for s in sinks_now:
        try:
            s.emit(record)
        except Exception:
            # a broken sink never takes down the step: it is detached
            from .log import get_logger
            get_logger("mxnet_tpu_torch.telemetry").exception(
                "telemetry sink %r failed; detaching", s)
            remove_sink(s)


def last_record() -> Optional[dict]:
    """The most recently emitted step record (None before any)."""
    return _last_record


def step_count() -> int:
    return _C_STEPS.value
