"""``mx.profiler`` over ``torch.profiler`` (counterpart of
``mxnet_tpu/profiler.py``).

``start``/``stop`` bracket one profiler cycle: ``torch.profiler``
(Kineto) with CUDA activity on the card (the host's ops beside them),
whose trace is exported into the cycle's directory
(``trace_dir()``, ``<filename stem>_trace``).  ``pause``/``resume``
close and reopen the session inside the same cycle: each stretch is one
file, ``<cycle>-<segment>.pt.trace.json``, and the cycle is read as all
of them (``kineto.py``).  ``device_op_table()`` is the card's kernels,
copies and memsets of the last cycle, ``{name: {count, total_us,
avg_us}}``, and the next telemetry step record carries the cycle's
device ms a step (``device_ms``).

A CUDA graph captured while a cycle runs (an ``Executable``'s first call
of a signature) is not profiled: the session is closed before the
capture and a new segment opened after it (``capture_guard``), so the
capture runs with no profiler on the card; the warm run before it and
the replays after it are traced.

The op table (``op.<name>`` histograms: ``op_record``, ``op_stats``,
``reset_stats``), ``counters()`` and the user ``Counter`` live in the
telemetry registry, as the reference's do: ``dumps()``, the JSONL
stream and the Prometheus text read the same objects.  ``counters()``
has the reference's sections; those whose producers the port lacks
(mesh axes, MoE, artifacts, embedding tables) read 0.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

from . import telemetry, tracing

__all__ = ["set_config", "start", "stop", "pause", "resume", "dump", "dumps",
           "Task", "Frame", "Event", "Counter", "Marker", "scope", "counters",
           "device_memory_info", "device_memory_summary", "op_stats",
           "reset_stats", "device_op_table", "trace_dir", "is_running",
           "imperative_enabled", "record_op", "op_timer", "op_record",
           "capture_guard"]

_config = {"profile_all": False, "profile_symbolic": False,
           "profile_imperative": False, "profile_memory": False,
           "profile_api": False, "filename": "profile.json",
           "aggregate_stats": False}
_running = False
_paused = False
_session = None          # the torch.profiler.profile of this stretch
_trace_dir: Optional[str] = None
_cycle: Optional[str] = None
_segment = 0


# -- the op table --------------------------------------------------------------

def imperative_enabled() -> bool:
    """True while per-op profiling is on (a cycle running, not paused,
    with ``profile_all`` or ``profile_imperative`` configured)."""
    return _running and not _paused and bool(
        _config.get("profile_all") or _config.get("profile_imperative"))


def record_op(name: str, seconds: float) -> None:
    """One execution of ``name`` into the op table (a bounded
    ``op.<name>`` histogram)."""
    telemetry.record_op_time(name, seconds)


def op_timer():
    """A start time while per-op profiling is on, else None; pair with
    :func:`op_record`."""
    return time.perf_counter() if imperative_enabled() else None


def op_record(name: str, t0) -> None:
    if t0 is not None:
        record_op(name, time.perf_counter() - t0)


def op_stats() -> Dict[str, Dict[str, float]]:
    """The op table: ``{op: {count, total, min, max, mean}}`` (seconds)."""
    return {k[len("op."):]: v.describe()
            for k, v in telemetry.metrics("op.").items()}


def reset_stats() -> None:
    """Clear the op table (values only)."""
    telemetry.reset("op.")


def _slo_declared() -> bool:
    """Whether serving objectives are declared, read through
    ``sys.modules`` so that a process that never imported serving does
    not import it here."""
    import sys
    m = sys.modules.get("mxnet_tpu_torch.serving.slo")
    if m is None:
        return False
    try:
        return bool(m.declared())
    except Exception:
        return False


def _c(name):
    return telemetry.counter(name).value


def counters() -> Dict[str, Dict[str, int]]:
    """The process's counters by section (the reference's sections, read
    from the telemetry registry: always live, no ``start()`` needed):
    ``eager_jit`` (the port's op funnel runs eagerly and caches nothing:
    0), ``fused_step``, ``cached_step``, ``optimizer``, ``dispatch``,
    ``compile`` (captures and their ms), ``comm`` (with ``by_axis``),
    ``moe``, ``serving`` (with ``slo``), ``decode``, ``input``,
    ``tracing``, ``checkpoint``, ``cluster``, ``kernel``, ``amp`` and
    ``embedding``."""
    from . import clustermon as _clustermon
    from .amp import policy as _amp_policy
    from .imperative import cached_step as _cached_step
    from .optimizer import fused_step as _fused_step
    from .optimizer import optimizer as _optimizer
    g = telemetry.gauge
    rank, world = _clustermon.rank_world()
    straggler = g("cluster.straggler_rank").value
    return {"eager_jit": {"hits": 0, "misses": 0, "latches": 0},
            # ZeRO's sharded update is not ported: its steps read 0
            "fused_step": {**_fused_step.stats(), "zero_steps": 0},
            "cached_step": _cached_step.stats(),
            "optimizer": {"dispatches": _optimizer.dispatch_count()},
            "dispatch": {"count": _c("dispatch.count")},
            "compile": {"count": _c("compile.count"),
                        "ms": _c("compile.ms")},
            "comm": {"bytes": _c("comm.bytes"),
                     "by_axis": {ax: _c(f"comm.{ax}.bytes")
                                 for ax in telemetry.MESH_AXES}},
            "moe": {"dropped_tokens": _c("moe.dropped_tokens")},
            "serving": {
                "requests": _c("serving.requests"),
                "batches": _c("serving.batches"),
                "eager_batches": _c("serving.eager_batches"),
                "compiles": _c("compile.serving.count"),
                "rejects": _c("serving.rejected.queue_full")
                + _c("serving.rejected.shape"),
                "timeouts": _c("serving.timeouts"),
                "slo": {"declared": _slo_declared(),
                        "evals": _c("serving_slo.evals"),
                        "samples": _c("serving_slo.requests"),
                        "breaches": _c("serving_slo.breaches"),
                        "errors": _c("serving_slo.errors"),
                        "incidents": _c("serving_slo.incidents")}},
            "decode": {
                "tokens": _c("decode.tokens"),
                "prefill_tokens": _c("decode.prefill_tokens"),
                "steps": _c("decode.steps"),
                "evictions": _c("decode.evictions"),
                "spec_proposed": _c("decode.spec_proposed"),
                "spec_accepted": _c("decode.spec_accepted"),
                "slots_active": g("decode.slots_active").value or 0,
                "pages_used": g("decode.pages_used").value or 0},
            "input": {"wait_ms": _c("input.wait_ms"),
                      "h2d_bytes": _c("input.h2d_bytes"),
                      "step_h2d": _c("input.step_h2d")},
            "tracing": {"spans": tracing.span_count(),
                        "dropped": tracing.dropped_count(),
                        "open": len(tracing.open_spans()),
                        "watchdog_dumps": _c("watchdog.stall_dumps")},
            "checkpoint": {
                "saves": _c("checkpoint.saves"),
                "failures": _c("checkpoint.failures"),
                "coalesced": _c("checkpoint.coalesced"),
                "bytes": _c("checkpoint.bytes"),
                "gc_removed": _c("checkpoint.gc_removed"),
                "verify_passes": _c("checkpoint.verify_passes"),
                "verify_failures": _c("checkpoint.verify_failures"),
                "faults_injected": _c("checkpoint.faults_injected")},
            "cluster": {
                "rank": rank, "world": world,
                "ranks": g("cluster.ranks").value or 0,
                "straggler_rank": straggler if straggler is not None
                else -1,
                "straggler_cause": g("cluster.straggler_cause").value
                or "none",
                "incidents": _c("cluster.straggler_incidents"),
                "incidents_total": {
                    c: _c("cluster.incidents_total." + c)
                    for c in (_clustermon.CAUSES
                              + _clustermon.SERVING_CAUSES
                              + ("unknown",))},
                "live_ranks": g("cluster.live_ranks").value or 0,
                "joined_steps": _c("cluster.joined_steps")},
            "kernel": {
                "cache_hits": _c("kernel.cache_hits"),
                "cache_misses": _c("kernel.cache_misses"),
                "tune_ms": _c("kernel.tune_ms"),
                "tune_measurements": _c("kernel.tune_measurements"),
                "fallbacks": _c("kernel.fallbacks")},
            "amp": {
                "enabled": _amp_policy.enabled(),
                "compute_dtype": (_amp_policy.compute_dtype_str()
                                  if _amp_policy.enabled() else "float32"),
                "loss_scale": g("amp.loss_scale").value,
                "overflow_steps": _c("amp.overflow_steps"),
                "skipped_updates": _c("amp.skipped_updates")},
            "embedding": {
                k: _c("embedding." + k) for k in (
                    "rows_pulled", "rows_pushed", "sparse_bytes",
                    "dense_equiv_bytes", "cache_hits", "cache_misses",
                    "cache_evictions", "rows_spilled")}}


# -- the profiler cycle ----------------------------------------------------------

def set_config(**kwargs):
    _config.update(kwargs)


def _cuda_on() -> bool:
    import torch
    return torch.cuda.is_available()


def _open_session() -> None:
    """Start a ``torch.profiler`` session for this stretch of the cycle:
    the card's activity and the host's ops."""
    global _session
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if _cuda_on():
        acts.append(ProfilerActivity.CUDA)
    sess = profile(activities=acts,
                   profile_memory=bool(_config.get("profile_memory")))
    sess.start()
    _session = sess


def _close_session() -> Optional[str]:
    """Stop this stretch's session and export its trace as the cycle's
    next segment; returns the file written."""
    global _session, _segment
    sess, _session = _session, None
    if sess is None:
        return None
    if _cuda_on():
        import torch
        torch.cuda.synchronize()        # the stretch's kernels have ended
    sess.stop()
    os.makedirs(_trace_dir, exist_ok=True)
    from .kineto import SUFFIX
    path = os.path.join(_trace_dir, f"{_cycle}-{_segment}{SUFFIX}")
    sess.export_chrome_trace(path)
    _segment += 1
    return path


def start(profile_process="worker"):
    """Begin a profiler cycle (one trace per ``start``/``stop``, kept
    across ``pause``/``resume``)."""
    global _running, _paused, _trace_dir, _cycle, _segment
    if _running:
        return
    _running, _paused = True, False
    _trace_dir = os.path.splitext(_config["filename"])[0] + "_trace"
    _cycle = f"{time.strftime('%Y%m%d_%H%M%S')}_{os.getpid()}_" \
             f"{time.perf_counter_ns() % 10**9}"
    _segment = 0
    telemetry._note_trace_start()
    _open_session()


def stop(profile_process="worker"):
    """End the cycle: its last stretch is exported, and the next
    telemetry record carries its device ms a step."""
    global _running, _paused
    if not _running:
        return
    _running, _paused = False, False
    _close_session()
    telemetry._note_trace_stop(_trace_dir)


def pause(profile_process="worker"):
    """Suspend the cycle without ending it: the stretch so far is kept
    as a segment of the same trace."""
    global _paused
    if _running and not _paused:
        _paused = True
        _close_session()


def resume(profile_process="worker"):
    """Resume a paused cycle into a new segment of the same trace."""
    global _paused
    if _running and _paused:
        _paused = False
        _open_session()


@contextlib.contextmanager
def capture_guard():
    """Around a CUDA graph capture: with a session open, close it (its
    stretch is kept) and open a new one after the capture, so that no
    profiler runs on the card while a graph is captured."""
    if _session is None:
        yield
        return
    _close_session()
    try:
        yield
    finally:
        if _running and not _paused:
            _open_session()


def is_running() -> bool:
    return _running


def trace_dir():
    """The directory of the current or last cycle's trace (None before
    any ``start``)."""
    return _trace_dir


def device_op_table():
    """The last cycle's device events by name, ``{name: {count,
    total_us, avg_us}}``; ``{}`` when no cycle wrote a trace."""
    if _trace_dir is None:
        return {}
    from . import kineto
    try:
        return kineto.device_op_table(_trace_dir)
    except Exception:
        return {}


def dump(finished=True, profile_process="worker"):
    """Write ``filename``: the op table's samples as Chrome events, the
    trace directory and the device-op table.  ``finished=False`` leaves
    the cycle running."""
    import json
    if finished:
        stop()
    with open(_config["filename"], "w") as f:
        json.dump({"traceEvents": _dump_agg_events(),
                   "trace_dir": _trace_dir,
                   "device_op_table": device_op_table()}, f)


def dumps(reset=False, device=True):
    """The op table, the user counters, the last cycle's device-op table
    and the flight recorder's spans by name, as printable text."""
    lines = ["Profile Statistics (host dispatch):",
             f"{'Name':<40}{'Count':>8}{'Total(ms)':>12}{'Mean(ms)':>12}"]
    for name, st in sorted(op_stats().items()):
        if not st["count"]:
            continue
        total = st["total"] * 1e3
        lines.append(f"{name:<40}{st['count']:>8}{total:>12.3f}"
                     f"{total / max(st['count'], 1):>12.3f}")
    user = telemetry.metrics("user_counter.")
    if user:
        lines.append("")
        lines.append("Counters:")
        for name, g in user.items():
            lines.append(f"{name[len('user_counter.'):]:<40}"
                         f"{g.value if g.value is not None else 0:>12}")
    if device:
        dev = device_op_table()
        if dev:
            from . import kineto
            lines.append("")
            lines.append(kineto.format_table(dev))
    spans = tracing.aggregate()
    if spans:
        lines.append("")
        lines.append("Trace spans (flight recorder ring):")
        lines.append(f"{'Name':<40}{'Count':>8}{'Total(ms)':>12}"
                     f"{'Mean(ms)':>12}{'Max(ms)':>12}")
        for name, st in sorted(spans.items(),
                               key=lambda kv: -kv[1]["total_ms"]):
            lines.append(f"{name:<40}{st['count']:>8}"
                         f"{st['total_ms']:>12.3f}{st['mean_ms']:>12.3f}"
                         f"{st['max_ms']:>12.3f}")
        dropped = tracing.dropped_count()
        if dropped:
            lines.append(f"(+{dropped} spans dropped to ring-buffer "
                         "overwrite; raise MXNET_TRACE_BUFFER)")
    if reset:
        reset_stats()
    return "\n".join(lines)


def _dump_agg_events():
    """Chrome events from the op table's rings (the most recent samples
    of each op)."""
    events = []
    for name, h in telemetry.metrics("op.").items():
        for t in h.samples():
            events.append({"name": name[len("op."):], "ph": "X",
                           "dur": t * 1e6})
    return events


class _Scope:
    """A profiling scope: its wall time into the op table, and a
    ``record_function`` range in the cycle's trace."""

    def __init__(self, name):
        self.name = name
        self._rf = None

    def start(self):
        self._t0 = time.perf_counter()
        if _session is not None:
            from torch.autograd.profiler import record_function
            self._rf = record_function(self.name)
            self._rf.__enter__()

    def stop(self):
        record_op(self.name, time.perf_counter() - self._t0)
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class Task(_Scope):
    def __init__(self, name, domain=None):
        super().__init__(name)


class Frame(_Scope):
    def __init__(self, name, domain=None):
        super().__init__(name)


class Event(_Scope):
    def __init__(self, name):
        super().__init__(name)


class Marker:
    def __init__(self, name, domain=None):
        self.name = name

    def mark(self, scope="process"):
        record_op(f"marker:{self.name}", 0.0)


class Counter:
    """A user counter over a telemetry gauge (``user_counter.<name>``):
    what it holds shows in ``dumps()`` and the registry."""

    def __init__(self, name, domain=None, value=None):
        self.name = name
        self._gauge = telemetry.gauge(f"user_counter.{name}")
        if value is not None or self._gauge.value is None:
            self._gauge.set(value or 0)

    @property
    def value(self):
        return self._gauge.value

    def set_value(self, value):
        self._gauge.set(value)

    def increment(self, delta=1):
        self._gauge.inc(delta)

    def decrement(self, delta=1):
        self._gauge.dec(delta)


def scope(name="<unk>:"):
    return _Scope(name)


# -- device memory --------------------------------------------------------------

def device_memory_info(device=None):
    """The caching allocator's figures for a CUDA device (default the
    current one): ``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit`` and the raw ``memory_stats``; ``{}`` on a host with
    no initialised CUDA device."""
    import torch
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return {}
    try:
        idx = torch.device(device if device is not None else "cuda").index
        idx = torch.cuda.current_device() if idx is None else idx
        st = dict(torch.cuda.memory_stats(idx))
        limit = torch.cuda.get_device_properties(idx).total_memory
    except Exception:
        return {}
    st.update(bytes_in_use=int(st.get("allocated_bytes.all.current", 0)),
              peak_bytes_in_use=int(st.get("allocated_bytes.all.peak", 0)),
              bytes_limit=int(limit))
    return st


def device_memory_summary():
    """One line a CUDA device: in use, peak and limit (MiB)."""
    import torch
    lines = ["Device memory:"]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        lines.append("  cpu: (no allocator stats on this backend)")
    for i in range(n):
        st = device_memory_info(f"cuda:{i}")
        if not st:
            lines.append(f"  cuda:{i}: (not initialised)")
            continue
        mib = 1024 * 1024
        lines.append(
            f"  cuda:{i}: in-use {st['bytes_in_use'] / mib:.1f} MiB, peak "
            f"{st['peak_bytes_in_use'] / mib:.1f} MiB, limit "
            f"{st['bytes_limit'] / mib:.1f} MiB")
    return "\n".join(lines)


# MXNET_PROFILER_AUTOSTART / MXNET_PROFILER_MODE, read at import as the
# reference reads them
if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    _mode = os.environ.get("MXNET_PROFILER_MODE", "")
    set_config(profile_all=(_mode != "symbolic"), profile_symbolic=True,
               aggregate_stats=True)
    start()
