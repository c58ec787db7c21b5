"""Cluster-scope observability: rank-aware aggregation, incidents and
Prometheus (counterpart of ``mxnet_tpu/clustermon.py``).

- **Spools**: with ``MXNET_CLUSTER_DIR`` set, every rank appends its
  step records (stamped ``rank``/``world`` and a ``rank_step`` ordinal)
  to ``<dir>/rank-<r>.jsonl``, one JSON object a line, flushed a
  record.  ``MXNET_CLUSTER_SPOOL_MAX_MB`` rotates a spool into numbered
  segments ``rank-<r>.jsonl.<k>``; the newest
  ``MXNET_CLUSTER_SPOOL_KEEP`` are kept and older ones compacted into
  ``rank-<r>.summary.jsonl``.
- **Aggregator** (the rank-0 process): a daemon thread tails every
  spool byte-exactly across rotations, joins records by ``rank_step``
  and keeps a cluster view: per-rank step-time skew, barrier-wait
  asymmetry and the critical-path decomposition.  A rank whose spool
  stops for ``MXNET_CLUSTER_RANK_TIMEOUT_S`` is demoted from the live
  set and readmitted when it resumes.
- **Straggler detector**: over ``MXNET_CLUSTER_WINDOW`` joined steps
  the slowest rank is named when its mean step time exceeds
  ``MXNET_STRAGGLER_FACTOR`` times its peers' median, with its cause
  (``input_bound`` / ``compile_stall`` / ``ckpt_interference`` /
  ``comm_skew``, or ``unknown``) from the signal with the largest
  excess.
- **Incidents**: each detection opens an incident in
  :class:`IncidentStore` (open, escalate, close; persisted in
  ``incidents.jsonl``), counted in the
  ``cluster.incidents_total{cause=...}`` family and served at
  ``GET /incidents``.  :func:`on_incident` hooks fire on the
  aggregator's thread.  An escalated ``input_bound`` incident
  publishes prefetch-depth advice (``advice.jsonl``) that the
  straggling rank's ``SpoolSink`` applies under ``MXNET_REMEDIATE=1``
  (``data.device_pipeline.note_advice_depth``), and logs and counts
  either way.  :func:`rank_health` gives the checkpoint barrier's
  timeout a healthy / degraded(cause) / missing view of each rank.
- **Prometheus**: :func:`prometheus_text` renders the telemetry
  registry in text exposition format, a ``rank`` label on every
  sample; ``GET /metrics`` on the serving server and the standalone
  ``MXNET_METRICS_PORT`` exporter serve it.

With ``MXNET_CLUSTER_DIR`` and ``MXNET_METRICS_PORT`` unset nothing here
runs: no spool, no thread.  A forked child (a DataLoader worker) has
none of its parent's threads and starts none from the environment.
The reference's ``tools/cluster_report.py`` reads the spools offline.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import telemetry

__all__ = ["rank_world", "set_thread_rank", "note_rank", "SpoolSink",
           "ClusterAggregator", "aggregator", "cluster_view",
           "join_by_step", "window_stats", "detect_straggler",
           "record_signals", "CAUSES", "SERVING_CAUSES",
           "IncidentStore", "incident_view", "on_incident",
           "remove_incident_hook", "incident_hooks",
           "register_incident_store", "unregister_incident_store",
           "rank_health",
           "prometheus_text", "parse_prometheus_text",
           "start_metrics_server", "stop_metrics_server",
           "metrics_server_address"]

_LOCK = threading.Lock()

_SPOOL_RE = re.compile(r"rank-(\d+)\.jsonl$")
_SEG_RE = re.compile(r"rank-(\d+)\.jsonl\.(\d+)$")
# sort key for the live (unnumbered) spool file: after every segment
_LIVE = float("inf")

INCIDENT_FILE = "incidents.jsonl"
ADVICE_FILE = "advice.jsonl"

# cluster-health metrics (created eagerly so profiler.counters() and a
# /metrics scrape always see the keys, zeros/none before the first
# aggregator pass)
_G_RANKS = telemetry.gauge("cluster.ranks")
_G_LIVE_RANKS = telemetry.gauge("cluster.live_ranks")
_G_SKEW = telemetry.gauge("cluster.step_ms_skew")
_G_BARRIER_SKEW = telemetry.gauge("cluster.barrier_wait_skew_ms")
_G_STRAGGLER = telemetry.gauge("cluster.straggler_rank")
_G_CAUSE = telemetry.gauge("cluster.straggler_cause")
# which mesh axis a comm_skew straggler is skewed on ("dp"/"tp"/...,
# "none" otherwise).  A detail gauge, NOT part of the cause string —
# the incidents_total{cause=...} family stays at bounded cardinality
_G_COMM_AXIS = telemetry.gauge("cluster.straggler_comm_axis")
_C_INCIDENTS = telemetry.counter("cluster.straggler_incidents")
_C_JOINED = telemetry.counter("cluster.joined_steps")
_C_ROTATIONS = telemetry.counter("cluster.spool_rotations")
_C_LOST_SEGMENTS = telemetry.counter("cluster.spool_lost_segments")
_C_ADVICE_PUB = telemetry.counter("cluster.advice_published")
_C_ADVICE_APPLIED = telemetry.counter("cluster.advice_applied")
_C_ADVICE_IGNORED = telemetry.counter("cluster.advice_ignored")

# per-cause incident counters; prometheus_text() folds the
# "cluster.incidents_total.<cause>" names into ONE
# mxnet_cluster_incidents_total{cause="<cause>"} counter family
_INCIDENTS_FAMILY = "cluster.incidents_total."
_C_INCIDENT_CAUSE = {
    c: telemetry.counter(_INCIDENTS_FAMILY + c)
    for c in ("input_bound", "compile_stall", "ckpt_interference",
              "comm_skew", "latency_slo", "error_budget",
              "queue_saturation", "ttft_slo", "unknown")}

# string-gauge values ever rendered, per metric — the stale-series fix:
# a scrape emits the CURRENT value at 1 and every previously-seen value
# at 0 so Prometheus alert rules don't latch onto a cleared cause
_STR_SEEN: Dict[str, set] = {}


def _logger():
    from .log import get_logger
    return get_logger("mxnet_tpu_torch.clustermon")


# -- rank/world resolution ---------------------------------------------------
# Precedence: per-thread override (threads-as-ranks harnesses) > the
# checkpoint chain (explicit env > DistKVStore's set_rank plumbing >
# the torch.distributed group).  The checkpoint resolution is cached keyed on
# the inputs it depends on, so per-span stamping never pays a backend
# call.

_tls = threading.local()
_rank_cache: Dict[str, Any] = {"key": None, "rw": (0, 1)}


def set_thread_rank(rank: Optional[int], world: int = 1) -> None:
    """Pin (rank, world) for the CALLING thread only — how a
    threads-as-ranks harness gives each worker thread its own spool.
    ``None`` clears the override."""
    if rank is None:
        _tls.rw = None
    else:
        _tls.rw = (int(rank), max(1, int(world)))


def note_rank(rank: int, world: int) -> None:
    """Invalidate the cached process-level resolution (called by the
    dist kvstore right after ``checkpoint.set_rank`` so the next record
    picks the plumbed identity up immediately)."""
    with _LOCK:
        _rank_cache["key"] = None


def rank_world() -> Tuple[int, int]:
    """(rank, world) for stamping records and spans."""
    rw = getattr(_tls, "rw", None)
    if rw is not None:
        return rw
    return _process_rank_world()


def _process_rank_world() -> Tuple[int, int]:
    """The checkpoint-chain resolution only (no thread-local override)
    — what decides which PROCESS hosts the aggregator."""
    from . import checkpoint
    key = (os.environ.get("MXNET_CKPT_RANK"),
           os.environ.get("MXNET_CKPT_WORLD"),
           checkpoint._rank_override)
    with _LOCK:
        if key == _rank_cache["key"]:
            return _rank_cache["rw"]
    try:
        rw = checkpoint.rank_world()
    except Exception:
        rw = (0, 1)     # invalid env raises at save() where it matters
    with _LOCK:
        _rank_cache["key"] = key
        _rank_cache["rw"] = rw
    return rw


# -- per-rank spools ---------------------------------------------------------

def _spool_max_bytes() -> int:
    """Rotation threshold from ``MXNET_CLUSTER_SPOOL_MAX_MB`` (float MB
    so tests can force rotation with sub-MB spools); 0/unset disables
    rotation — the pre-lifecycle single-file behavior."""
    v = os.environ.get("MXNET_CLUSTER_SPOOL_MAX_MB")
    try:
        return max(0, int(float(v) * 1024 * 1024)) if v else 0
    except ValueError:
        return 0


def _spool_keep() -> int:
    """Segments retained per rank (``MXNET_CLUSTER_SPOOL_KEEP``,
    default 4; 0 = retain all — the checkpoint_gc keep-N idiom).  Older
    segments are compacted into summary records, then removed."""
    v = os.environ.get("MXNET_CLUSTER_SPOOL_KEEP")
    try:
        return max(0, int(v)) if v else 4
    except ValueError:
        return 4


def _history_keep() -> int:
    """Closed incidents retained in the in-memory ring
    (``MXNET_CLUSTER_HISTORY``, default 256)."""
    v = os.environ.get("MXNET_CLUSTER_HISTORY")
    try:
        return max(1, int(v)) if v else 256
    except ValueError:
        return 256


def _rank_timeout_s() -> float:
    """Seconds of spool silence before a rank is demoted from the live
    join set (``MXNET_CLUSTER_RANK_TIMEOUT_S``; 0/unset = never)."""
    v = os.environ.get("MXNET_CLUSTER_RANK_TIMEOUT_S")
    try:
        return max(0.0, float(v)) if v else 0.0
    except ValueError:
        return 0.0


def _remediate_enabled() -> bool:
    return os.environ.get("MXNET_REMEDIATE") == "1"


class SpoolSink:
    """Telemetry sink appending each step record to the emitting rank's
    spool (``<dir>/rank-<r>.jsonl``).  A ``rank_step`` ordinal (this
    rank's Nth record) is stamped so the aggregator can join steps
    across ranks even when the process-global ``step`` counter
    interleaves (threads-as-ranks).

    Lifecycle: when a spool would exceed ``max_bytes``
    (``MXNET_CLUSTER_SPOOL_MAX_MB``) it rotates to the next numbered
    segment ``rank-<r>.jsonl.<k>`` — records never straddle the
    threshold mid-line, so every segment ends on a record boundary from
    the WRITER's side (the tailer still handles torn lines from crashed
    writers).  Only the newest ``keep`` segments are retained; older
    ones are folded into per-window summary records in
    ``rank-<r>.summary.jsonl`` before removal, so a week-long run stays
    bounded on disk but remains post-mortem-queryable.

    The sink is also the rank-side consumer of the aggregator's
    remediation advice (``advice.jsonl``): every few records it drains
    new advice lines addressed to a rank this process emits for, and
    applies them (``MXNET_REMEDIATE=1``) or logs+counts them as
    advisory."""

    def __init__(self, directory: str, max_bytes: Optional[int] = None,
                 keep: Optional[int] = None,
                 rotate_age_s: Optional[float] = None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.max_bytes = (_spool_max_bytes() if max_bytes is None
                          else max(0, int(max_bytes)))
        self.keep = _spool_keep() if keep is None else max(0, int(keep))
        self.rotate_age_s = rotate_age_s
        self._files: Dict[int, Any] = {}
        self._counts: Dict[int, int] = {}
        self._sizes: Dict[int, int] = {}
        self._opened: Dict[int, float] = {}
        self._seg_next: Dict[int, int] = {}
        self._advice_off = 0
        self._lock = threading.Lock()

    def _path(self, r: int) -> str:
        return os.path.join(self.directory, f"rank-{r}.jsonl")

    def emit(self, record: dict) -> None:
        r = int(record.get("rank", 0))
        with self._lock:
            n = self._counts.get(r, 0) + 1
            self._counts[r] = n
            line = json.dumps(dict(record, rank_step=n)) + "\n"
            now = time.monotonic()
            f = self._files.get(r)
            if f is not None and self._should_rotate(r, len(line), now):
                self._rotate(r)
                f = None
            if f is None:
                path = self._path(r)
                f = self._files[r] = open(path, "a", buffering=1)
                try:
                    self._sizes[r] = os.path.getsize(path)
                except OSError:
                    self._sizes[r] = 0
                self._opened[r] = now
            f.write(line)
            self._sizes[r] = self._sizes.get(r, 0) + len(line)
            if n % 4 == 0:
                self._consume_advice()

    # -- rotation / compaction -----------------------------------------------

    def _should_rotate(self, r: int, nbytes: int, now: float) -> bool:
        size = self._sizes.get(r, 0)
        if size <= 0:       # never rotate an empty spool
            return False
        if self.max_bytes and size + nbytes > self.max_bytes:
            return True
        return (self.rotate_age_s is not None
                and now - self._opened.get(r, now) >= self.rotate_age_s)

    def _rotate(self, r: int) -> None:
        f = self._files.pop(r, None)
        if f is not None:
            try:
                f.close()
            except Exception:
                pass
        path = self._path(r)
        k = self._seg_next.get(r)
        if k is None:       # resume numbering after a restart
            ks = [int(m.group(2)) for m in
                  (_SEG_RE.match(nm) for nm in os.listdir(self.directory))
                  if m and int(m.group(1)) == r]
            k = max(ks, default=0) + 1
        try:
            os.rename(path, f"{path}.{k}")
        except OSError:
            return          # keep appending to the live file
        self._seg_next[r] = k + 1
        self._sizes[r] = 0
        _C_ROTATIONS.inc()
        if self.keep:
            self._prune(r)

    def _prune(self, r: int) -> None:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return
        segs = []
        for nm in names:
            m = _SEG_RE.match(nm)
            if m and int(m.group(1)) == r:
                segs.append((int(m.group(2)), nm))
        segs.sort()
        while len(segs) > self.keep:
            k, nm = segs.pop(0)
            path = os.path.join(self.directory, nm)
            try:
                self._compact(r, path, k)
            except Exception:
                _logger().exception("spool compaction failed for %s", nm)
            try:
                os.remove(path)
            except OSError:
                pass

    def _compact(self, r: int, seg_path: str, k: int) -> None:
        """Fold a retired segment into per-window summary records —
        same window size the detector uses, so offline reports can
        reconcile compacted history with live totals."""
        recs = []
        with open(seg_path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    recs.append(json.loads(ln))
                except ValueError:
                    continue
        if not recs:
            return
        window = max(1, _cluster_window())
        out = os.path.join(self.directory, f"rank-{r}.summary.jsonl")
        with open(out, "a") as f:
            for i in range(0, len(recs), window):
                chunk = recs[i:i + window]
                host = [float(x.get("host_ms") or 0.0) for x in chunk]
                sigs = [record_signals(x) for x in chunk]
                f.write(json.dumps({
                    "summary": True, "rank": r, "segment": k,
                    "rank_step_first": int(chunk[0].get("rank_step")
                                           or 0),
                    "rank_step_last": int(chunk[-1].get("rank_step")
                                          or 0),
                    "steps": len(chunk),
                    "host_ms_mean": round(_mean(host), 3),
                    "host_ms_max": round(max(host, default=0.0), 3),
                    "host_ms_total": round(sum(host), 3),
                    "signals": {
                        kk: round(_mean([s[kk] for s in sigs]), 3)
                        for kk in ("input", "compile", "checkpoint",
                                   "comm")},
                    "ts_first": chunk[0].get("ts"),
                    "ts_last": chunk[-1].get("ts"),
                }) + "\n")

    # -- remediation advice (rank side) --------------------------------------

    def _consume_advice(self) -> None:
        """Drain new complete lines from ``advice.jsonl`` (published by
        the rank-0 aggregator) and act on advice addressed to a rank
        this process emits for.  Called from ``emit`` under the sink
        lock, every 4th record per rank — one stat() amortized over
        steps, never on the critical path of other ranks."""
        path = os.path.join(self.directory, ADVICE_FILE)
        try:
            if os.path.getsize(path) <= self._advice_off:
                return
            with open(path, "rb") as f:
                f.seek(self._advice_off)
                data = f.read()
        except OSError:
            return
        nl = data.rfind(b"\n")
        if nl < 0:
            return          # torn write; retry next time
        data = data[:nl + 1]
        self._advice_off += len(data)
        for ln in data.decode("utf-8", "replace").splitlines():
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if rec.get("action") != "prefetch_depth":
                continue
            try:
                target = int(rec.get("rank", -1))
                depth = int(rec.get("depth") or 0)
            except (TypeError, ValueError):
                continue
            if target not in self._counts or depth <= 0:
                continue    # addressed to a rank outside this process
            if _remediate_enabled():
                from .data.device_pipeline import note_advice_depth
                note_advice_depth(depth)
                _C_ADVICE_APPLIED.inc()
                _logger().warning(
                    "remediation applied for rank %d (incident %s): "
                    "DevicePrefetcher depth -> %d at the next epoch",
                    target, rec.get("incident_id"), depth)
            else:
                _C_ADVICE_IGNORED.inc()
                _logger().warning(
                    "remediation advice for rank %d (incident %s) "
                    "ignored: DevicePrefetcher depth -> %d; set "
                    "MXNET_REMEDIATE=1 to apply",
                    target, rec.get("incident_id"), depth)

    def close(self) -> None:
        with self._lock:
            for f in self._files.values():
                try:
                    f.close()
                except Exception:
                    pass
            self._files.clear()


# -- record signal extraction ------------------------------------------------

# straggler cause classes, in the order the decision rule names them
CAUSES = ("input_bound", "compile_stall", "ckpt_interference",
          "comm_skew")

# serving-side incident causes (serving/slo.py burn-rate alerting);
# same IncidentStore state machine and incidents_total counter family
SERVING_CAUSES = ("latency_slo", "error_budget", "queue_saturation",
                  "ttft_slo")

_SIG_OF_CAUSE = {"input_bound": "input", "compile_stall": "compile",
                 "ckpt_interference": "checkpoint", "comm_skew": "comm"}
_CAUSE_OF_SIG = {v: k for k, v in _SIG_OF_CAUSE.items()}


def record_signals(rec: dict) -> Dict[str, float]:
    """Per-record attribution signals (ms) for the straggler
    classifier.  Span-bucket deltas (``critical_path``, present when
    tracing is live) and record fields measure overlapping intervals —
    ``max`` of the two is taken per signal rather than their sum so a
    traced run never double-counts."""
    cp = rec.get("critical_path") or {}
    ck = rec.get("checkpoint") or {}
    return {
        "input": max(float(rec.get("input_wait_ms") or 0.0),
                     float(cp.get("input_wait") or 0.0)),
        "compile": max(float(rec.get("compile_ms") or 0.0),
                       float(cp.get("compile") or 0.0)),
        "checkpoint": max(float(ck.get("barrier_wait_ms") or 0.0),
                          float(cp.get("checkpoint") or 0.0)),
        "comm": float(cp.get("collective") or 0.0),
    }


def join_by_step(by_rank: Dict[int, List[dict]]) -> Dict[int, Dict[int,
                                                                   dict]]:
    """Join records across ranks: {step: {rank: record}}.  The join key
    is the per-rank ``rank_step`` ordinal the spool sink stamps (the
    i-th record a rank emitted IS its i-th step), falling back to
    position for spools that predate the field."""
    joined: Dict[int, Dict[int, dict]] = {}
    for r, recs in by_rank.items():
        for i, rec in enumerate(recs):
            step = int(rec.get("rank_step", i + 1))
            joined.setdefault(step, {})[r] = rec
    return joined


def _mean(vals: List[float]) -> float:
    return sum(vals) / len(vals) if vals else 0.0


def _median(vals: List[float]) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def window_stats(by_rank: Dict[int, List[dict]], window: int,
                 live_ranks: Optional[List[int]] = None
                 ) -> Dict[int, dict]:
    """Per-rank aggregates over the trailing ``window`` JOINED steps
    (only steps every rank has reported — a rank that is behind must
    not look fast because its slow steps haven't landed yet).  When
    ``live_ranks`` is given, completeness and the stats cover only
    those ranks — how the aggregator keeps joining after a dead rank
    is demoted; offline callers omit it and get every rank."""
    joined = join_by_step(by_rank)
    ranks = (sorted(live_ranks) if live_ranks is not None
             else sorted(by_rank))
    complete = sorted(s for s, per in joined.items()
                      if all(r in per for r in ranks))
    tail = complete[-window:] if window else complete
    stats: Dict[int, dict] = {}
    for r in ranks:
        recs = [joined[s][r] for s in tail]
        host = [float(x.get("host_ms") or 0.0) for x in recs]
        sigs = [record_signals(x) for x in recs]
        cps = [x.get("critical_path") or {} for x in recs]
        axs = [(x.get("collective_split") or {}).get("by_axis") or {}
               for x in recs]
        stats[r] = {
            "steps": len(recs),
            "host_ms_mean": _mean(host),
            "host_ms_max": max(host, default=0.0),
            "signals": {k: _mean([s[k] for s in sigs])
                        for k in ("input", "compile", "checkpoint",
                                  "comm")},
            "critical_path": {
                k: _mean([float(c.get(k) or 0.0) for c in cps])
                for k in ("input_wait", "h2d", "compile", "collective",
                          "optimizer", "checkpoint", "compute")},
            # mean modeled collective bytes per mesh axis
            # (collective_split.by_axis) — lets a comm_skew verdict
            # name WHICH axis (dp grad sync vs tp activation
            # all-reduce vs ep all_to_all) carries the skew
            "comm_axis_bytes": {
                ax: _mean([float(a.get(ax) or 0.0) for a in axs])
                for ax in telemetry.MESH_AXES},
            "barrier_wait_ms_mean": _mean(
                [float((x.get("checkpoint") or {})
                       .get("barrier_wait_ms") or 0.0) for x in recs]),
        }
    return stats


def detect_straggler(stats: Dict[int, dict],
                     factor: float) -> Optional[dict]:
    """Name the slowest rank in a window and classify its dominant
    cause.  Decision rule: the slowest rank is a straggler when its mean
    step time exceeds ``factor`` × the median of the OTHER ranks';
    its cause is the signal with the largest excess over the peer
    median, or ``unknown`` when no signal explains ≥10% of the step
    -time excess (unattributed compute — a thermally-throttled chip
    looks like this)."""
    live = {r: s for r, s in stats.items() if s["steps"]}
    if len(live) < 2:
        return None
    slowest = max(live, key=lambda r: live[r]["host_ms_mean"])
    peers = [live[r]["host_ms_mean"] for r in live if r != slowest]
    med = _median(peers)
    mean = live[slowest]["host_ms_mean"]
    if med <= 0.0 or mean <= factor * med:
        return None
    excess = {
        sig: live[slowest]["signals"][sig]
        - _median([live[r]["signals"][sig] for r in live if r != slowest])
        for sig in ("input", "compile", "checkpoint", "comm")}
    total_excess = mean - med
    top = max(excess, key=lambda k: excess[k])
    if excess[top] <= 0.0 or excess[top] < 0.1 * total_excess:
        cause = "unknown"
    else:
        cause = _CAUSE_OF_SIG[top]
    # mesh-axis attribution for comm_skew: the axis whose modeled
    # byte volume on the straggler most exceeds the peer median.  A
    # DETAIL field beside the cause — the cause string (and the
    # incidents_total counter family) stays "comm_skew" so Prometheus
    # cardinality is unchanged.
    comm_axis = None
    if cause == "comm_skew":
        ax_excess = {}
        for ax in telemetry.MESH_AXES:
            mine = live[slowest].get("comm_axis_bytes", {}).get(ax, 0.0)
            peer = _median([live[r].get("comm_axis_bytes", {})
                            .get(ax, 0.0) for r in live if r != slowest])
            ax_excess[ax] = mine - peer
        best = max(ax_excess, key=lambda a: ax_excess[a])
        if ax_excess[best] > 0.0:
            comm_axis = best
        elif live[slowest].get("comm_axis_bytes"):
            # symmetric volumes — fall back to the heaviest axis on
            # the straggler itself so operators still get a name
            vols = live[slowest]["comm_axis_bytes"]
            heaviest = max(vols, key=lambda a: vols[a])
            comm_axis = heaviest if vols[heaviest] > 0.0 else None
    return {"rank": slowest, "cause": cause, "comm_axis": comm_axis,
            "ratio": mean / med, "step_ms": mean, "peer_ms": med,
            "excess_ms": {_CAUSE_OF_SIG[k]: round(v, 3)
                          for k, v in excess.items()}}


# -- incident store ----------------------------------------------------------

# an open incident "escalates" — hooks see the transition and the
# built-in remediation publishes advice — only after the detector has
# confirmed it on this many recomputes, so one flapping window never
# drives action
ESCALATE_POLLS = 2


class IncidentStore:
    """Bounded incident history for the rank-0 aggregator.

    At most one incident is open at a time (the detector names at most
    one straggler); :meth:`observe` advances the state machine on every
    detector verdict and returns the lifecycle events
    (``open`` / ``escalate`` / ``close``) that transition produced, so
    the caller can bump counters and fire hooks exactly once per
    transition.  Every transition is also appended to
    ``<dir>/incidents.jsonl`` for post-mortems; closed incidents stay
    in a ring of ``MXNET_CLUSTER_HISTORY`` entries for ``/incidents``.

    Not internally locked — only ever touched under the aggregator's
    lock."""

    def __init__(self, directory: Optional[str] = None,
                 keep: Optional[int] = None):
        self.directory = directory
        self.keep = _history_keep() if keep is None else max(1, int(keep))
        self._next_id = 1
        self._open: Optional[dict] = None
        self._closed: List[dict] = []
        self._counts: Dict[str, int] = {}

    def observe(self, straggler: Optional[dict], step: int,
                now: float) -> List[dict]:
        """One detector verdict in; lifecycle events out.  ``step`` is
        the latest fully-joined step (the incident's timeline unit) and
        ``now`` a wall-clock timestamp."""
        events: List[dict] = []
        cur = self._open
        if straggler is None:
            if cur is not None:
                events.append(self._close(cur, step, now))
            return events
        rank, cause = int(straggler["rank"]), straggler["cause"]
        if cur is not None and (cur["rank"] != rank
                                or cur["cause"] != cause):
            events.append(self._close(cur, step, now))
            cur = None
        if cur is None:
            cur = self._open = {
                "id": self._next_id, "status": "open",
                "rank": rank, "cause": cause,
                "comm_axis": straggler.get("comm_axis"),
                "start_rank_step": int(step), "end_rank_step": None,
                "start_ts": round(now, 3), "end_ts": None,
                "duration_s": None,
                "peak_ratio": round(float(straggler["ratio"]), 3),
                "peak_step_ms": round(float(straggler["step_ms"]), 3),
                "polls": 1, "escalated": False,
            }
            self._next_id += 1
            self._counts[cause] = self._counts.get(cause, 0) + 1
            self._persist("open", cur)
            events.append({"event": "open", "incident": dict(cur)})
            return events
        cur["polls"] += 1
        if straggler.get("comm_axis"):
            cur["comm_axis"] = straggler["comm_axis"]
        cur["peak_ratio"] = round(max(cur["peak_ratio"],
                                      float(straggler["ratio"])), 3)
        cur["peak_step_ms"] = round(max(cur["peak_step_ms"],
                                        float(straggler["step_ms"])), 3)
        if not cur["escalated"] and cur["polls"] >= ESCALATE_POLLS:
            cur["escalated"] = True
            self._persist("escalate", cur)
            events.append({"event": "escalate", "incident": dict(cur)})
        return events

    def _close(self, inc: dict, step: int, now: float) -> dict:
        inc["status"] = "closed"
        inc["end_rank_step"] = int(step)
        inc["end_ts"] = round(now, 3)
        inc["duration_s"] = round(max(0.0, now - inc["start_ts"]), 3)
        self._open = None
        self._closed.append(inc)
        if len(self._closed) > self.keep:
            del self._closed[:len(self._closed) - self.keep]
        self._persist("close", inc)
        return {"event": "close", "incident": dict(inc)}

    def _persist(self, event: str, inc: dict) -> None:
        if not self.directory:
            return
        try:
            with open(os.path.join(self.directory, INCIDENT_FILE),
                      "a") as f:
                f.write(json.dumps(dict(inc, event=event)) + "\n")
        except OSError:
            pass            # history is best-effort; detection is not

    def snapshot(self, limit: int = 50) -> dict:
        return {"open": [dict(self._open)] if self._open else [],
                "recent": [dict(i) for i in self._closed[-limit:]],
                "counts": dict(self._counts)}


# -- remediation hook plane --------------------------------------------------

_HOOKS: List[Any] = []


def on_incident(fn) -> Any:
    """Register ``fn(event, incident)`` to fire on incident lifecycle
    transitions (``event`` is ``"open"`` / ``"escalate"`` /
    ``"close"``; ``incident`` is a copy of the record).  Hooks run on
    the rank-0 aggregator's poll thread — never the step path — at
    most once per transition; an exception is logged and swallowed.
    Returns ``fn`` so it can decorate."""
    with _LOCK:
        if fn not in _HOOKS:
            _HOOKS.append(fn)
    return fn


def remove_incident_hook(fn) -> None:
    with _LOCK:
        if fn in _HOOKS:
            _HOOKS.remove(fn)


def incident_hooks() -> List[Any]:
    """The registered on_incident hooks (a copy) — so out-of-aggregator
    incident producers (serving/slo.py) fire the same hook plane."""
    with _LOCK:
        return list(_HOOKS)


# extra incident stores merged into incident_view(): anything with a
# ``snapshot(limit)`` returning the IncidentStore shape (open / recent /
# counts).  serving/slo.py registers its engine here so GET /incidents
# shows serving incidents beside straggler incidents.
_EXTRA_STORES: List[Any] = []


def register_incident_store(store) -> Any:
    with _LOCK:
        if store not in _EXTRA_STORES:
            _EXTRA_STORES.append(store)
    return store


def unregister_incident_store(store) -> None:
    with _LOCK:
        if store in _EXTRA_STORES:
            _EXTRA_STORES.remove(store)


# -- the rank-0 aggregator ---------------------------------------------------

def _straggler_factor() -> float:
    v = os.environ.get("MXNET_STRAGGLER_FACTOR")
    try:
        return max(1.0, float(v)) if v else 1.5
    except ValueError:
        return 1.5


def _cluster_window() -> int:
    v = os.environ.get("MXNET_CLUSTER_WINDOW")
    try:
        return max(1, int(v)) if v else 20
    except ValueError:
        return 20


class ClusterAggregator:
    """Tails every ``rank-*.jsonl`` spool in ``directory``, joins
    records by step, and maintains the cluster view + gauges.  Owns an
    optional daemon thread (:meth:`start`); :meth:`poll` runs one pass
    synchronously so tests and the report tool stay deterministic."""

    def __init__(self, directory: str, window: Optional[int] = None,
                 factor: Optional[float] = None, poll_s: float = 0.5,
                 keep: int = 512,
                 rank_timeout_s: Optional[float] = None,
                 history: Optional[int] = None):
        self.directory = directory
        self.window = window if window is not None else _cluster_window()
        self.factor = factor if factor is not None else _straggler_factor()
        self.poll_s = max(0.05, float(poll_s))
        self.keep = max(self.window * 4, keep)
        self.rank_timeout_s = (_rank_timeout_s() if rank_timeout_s is None
                               else max(0.0, float(rank_timeout_s)))
        self.incidents = IncidentStore(directory, keep=history)
        self._by_rank: Dict[int, List[dict]] = {}
        # per-rank tail state: highest fully-read segment number, byte
        # offset + torn-line buffer into the file after it
        self._rstate: Dict[int, dict] = {}
        self._last_seen: Dict[int, float] = {}
        self._last_step: Dict[int, int] = {}
        self._health: Dict[int, dict] = {}
        self._missing: set = set()
        self._pending: List[dict] = []
        self._view: dict = {"ranks": {}, "straggler": None, "skew": None,
                            "window": self.window, "joined_steps": 0,
                            "live_ranks": [], "missing_ranks": [],
                            "health": {}}
        self._joined_seen = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    # -- spool tailing -------------------------------------------------------

    def _read_new(self) -> bool:
        """Drain complete new lines from every spool; True when any
        record arrived.  Offsets are byte-exact, a partial trailing
        line (a rank mid-write) is buffered until its newline lands,
        and the buffer is carried ACROSS segment boundaries so a
        rotation mid-read never loses the torn record.  Per rank the
        files form one logical stream: segments ``rank-<r>.jsonl.<k>``
        in ``k`` order, then the live ``rank-<r>.jsonl``."""
        grew = False
        try:
            names = os.listdir(self.directory)
        except OSError:
            return False
        per_rank: Dict[int, Dict[int, str]] = {}
        for name in names:
            m = _SPOOL_RE.match(name)
            if m:       # the live file reads after every segment
                per_rank.setdefault(int(m.group(1)), {})[_LIVE] = name
                continue
            m = _SEG_RE.match(name)
            if m:
                per_rank.setdefault(int(m.group(1)),
                                    {})[int(m.group(2))] = name
        now = time.monotonic()
        for rank in sorted(per_rank):
            st = self._rstate.get(rank)
            if st is None:
                st = self._rstate[rank] = {"seg_done": 0, "off": 0,
                                           "buf": b""}
                self._last_seen.setdefault(rank, now)
            todo = sorted(k for k in per_rank[rank]
                          if k > st["seg_done"])
            if not todo:
                continue
            if todo[0] != _LIVE and todo[0] > st["seg_done"] + 1:
                # older segments were pruned before we read them
                lost = todo[0] - st["seg_done"] - 1
                _C_LOST_SEGMENTS.inc(lost)
                _logger().warning(
                    "rank %d: %d spool segment(s) pruned before the "
                    "aggregator read them (raise "
                    "MXNET_CLUSTER_SPOOL_KEEP)", rank, lost)
                st["off"], st["buf"] = 0, b""
            recs = self._by_rank.setdefault(rank, [])
            added = False
            for j, k in enumerate(todo):
                path = os.path.join(self.directory, per_rank[rank][k])
                off = st["off"] if j == 0 else 0
                try:
                    with open(path, "rb") as f:
                        f.seek(off)
                        data = f.read()
                except OSError:
                    continue    # pruned mid-pass; next poll resyncs
                off += len(data)
                buf = st["buf"] + data
                *lines, buf = buf.split(b"\n")
                st["off"], st["buf"] = off, buf
                for ln in lines:
                    if not ln.strip():
                        continue
                    try:
                        recs.append(json.loads(ln))
                        added = True
                    except ValueError:
                        continue        # torn write; skip the line
                if k != _LIVE:
                    # segment fully consumed; the next file starts at 0
                    # with the torn tail (if any) carried forward
                    st["seg_done"], st["off"] = k, 0
            if added:
                grew = True
                self._last_seen[rank] = now
                if len(recs) > self.keep:
                    del recs[:len(recs) - self.keep]
                self._last_step[rank] = int(
                    recs[-1].get("rank_step", len(recs)))
        return grew

    # -- view / gauges -------------------------------------------------------

    def poll(self) -> dict:
        """One synchronous pass: tail spools, recompute the view,
        refresh gauges, log incident transitions, then fire
        ``on_incident`` hooks OUTSIDE the lock.  Returns the view."""
        with self._lock:
            grew = self._read_new()
            if grew or not self._view["ranks"] \
                    or self.rank_timeout_s > 0:
                self._recompute()
            view = dict(self._view)
            events, self._pending = self._pending, []
        for ev in events:
            self._dispatch(ev)
        return view

    def _recompute(self) -> None:
        now = time.monotonic()
        all_ranks = sorted(self._by_rank)
        timeout = self.rank_timeout_s
        live = [r for r in all_ranks if not timeout
                or now - self._last_seen.get(r, now) < timeout]
        missing = [r for r in all_ranks if r not in set(live)]
        for r in missing:
            if r not in self._missing:
                self._missing.add(r)
                _logger().warning(
                    "rank %d demoted from the live set: no spool "
                    "records for %.1fs (> MXNET_CLUSTER_RANK_TIMEOUT_S"
                    "=%.1fs); joining on survivors", r,
                    now - self._last_seen.get(r, now), timeout)
        for r in list(self._missing):
            if r in set(live):
                self._missing.discard(r)
                _logger().info("rank %d re-admitted to the live set: "
                               "spool resumed", r)
        stats = window_stats(self._by_rank, self.window,
                             live_ranks=live)
        straggler = detect_straggler(stats, self.factor)
        means = [s["host_ms_mean"] for s in stats.values() if s["steps"]]
        barrier = [s["barrier_wait_ms_mean"] for s in stats.values()
                   if s["steps"]]
        joined = join_by_step(self._by_rank)
        complete_steps = sorted(
            s for s, per in joined.items()
            if all(r in per for r in live)) if live else []
        complete = len(complete_steps)
        skew = None
        if len(means) >= 2:
            skew = {"step_ms": max(means) - min(means),
                    "step_ratio": max(means) / min(means)
                    if min(means) > 0 else None,
                    "barrier_wait_ms": max(barrier) - min(barrier)}
        # incident lifecycle: one verdict in, transitions out
        last_step = complete_steps[-1] if complete_steps else 0
        events = self.incidents.observe(straggler, last_step,
                                        time.time())
        open_inc = self.incidents._open
        health = {}
        for r in all_ranks:
            entry = {"status": "healthy", "cause": None,
                     "last_rank_step": self._last_step.get(r, 0),
                     "since_s": round(now - self._last_seen.get(r, now),
                                      3)}
            if r in self._missing:
                entry["status"] = "missing"
            elif open_inc is not None and open_inc["rank"] == r:
                entry["status"] = "degraded"
                entry["cause"] = open_inc["cause"]
            health[r] = entry
        self._health = health
        self._view = {"ranks": stats, "straggler": straggler,
                      "skew": skew, "window": self.window,
                      "joined_steps": complete,
                      "live_ranks": live, "missing_ranks": missing,
                      "health": health}
        # gauges: the scrapeable face of the view
        _G_RANKS.set(len(all_ranks))
        _G_LIVE_RANKS.set(len(live))
        new_joined = complete - self._joined_seen
        if new_joined > 0:
            _C_JOINED.inc(new_joined)
            self._joined_seen = complete
        if skew:
            _G_SKEW.set(round(skew["step_ms"], 3))
            _G_BARRIER_SKEW.set(round(skew["barrier_wait_ms"], 3))
        if straggler is None:
            _G_STRAGGLER.set(-1)
            _G_CAUSE.set("none")
            _G_COMM_AXIS.set("none")
        else:
            _G_STRAGGLER.set(int(straggler["rank"]))
            _G_CAUSE.set(straggler["cause"])
            _G_COMM_AXIS.set(straggler.get("comm_axis") or "none")
        for ev in events:
            inc = ev["incident"]
            if ev["event"] == "open":
                _C_INCIDENTS.inc()
                _C_INCIDENT_CAUSE.get(
                    inc["cause"], _C_INCIDENT_CAUSE["unknown"]).inc()
                _logger().warning(
                    "cluster incident %d opened: rank %d is %.2fx the "
                    "peer median (%.2f ms over the last %d joined "
                    "steps); dominant cause: %s%s",
                    inc["id"], inc["rank"], inc["peak_ratio"],
                    inc["peak_step_ms"], self.window, inc["cause"],
                    (" on mesh axis '%s'" % inc["comm_axis"])
                    if inc.get("comm_axis") else "")
            elif ev["event"] == "close":
                _logger().info(
                    "cluster incident %d closed: rank %d (%s) after "
                    "%.1fs, rank_step %d..%d, peak %.2fx",
                    inc["id"], inc["rank"], inc["cause"],
                    inc["duration_s"], inc["start_rank_step"],
                    inc["end_rank_step"], inc["peak_ratio"])
        self._pending.extend(events)

    # -- hook dispatch / built-in remediation --------------------------------

    def _dispatch(self, ev: dict) -> None:
        """Fire one lifecycle event: built-in remediation first, then
        registered hooks.  Runs on the poll thread with the aggregator
        lock RELEASED, so a slow hook can never stall tailing — and
        never the step path.  Rate limiting is structural: the store
        emits each transition exactly once."""
        inc = ev["incident"]
        if ev["event"] == "escalate" and inc["cause"] == "input_bound":
            self._publish_advice(inc)
        with _LOCK:
            hooks = list(_HOOKS)
        if not hooks:
            return
        from . import tracing
        tracing.instant(f"cluster.incident.{ev['event']}",
                        incident=inc["id"], rank=inc["rank"],
                        cause=inc["cause"])
        for fn in hooks:
            try:
                fn(ev["event"], dict(inc))
            except Exception:
                _logger().exception("on_incident hook %r failed", fn)

    def _publish_advice(self, inc: dict) -> None:
        """First concrete remediation: a persistently input-bound rank
        should deepen its device prefetch ring.  The aggregator only
        PUBLISHES the advice record; the straggling rank's own
        SpoolSink applies it (opt-in, ``MXNET_REMEDIATE=1``).  At most
        one advice per incident (escalate fires once)."""
        try:
            from .data.device_pipeline import prefetch_depth
            depth = max(4, 2 * prefetch_depth())
        except Exception:
            depth = 4
        rec = {"action": "prefetch_depth", "rank": inc["rank"],
               "depth": int(depth), "incident_id": inc["id"],
               "cause": inc["cause"], "ts": round(time.time(), 3)}
        try:
            with open(os.path.join(self.directory, ADVICE_FILE),
                      "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            return
        _C_ADVICE_PUB.inc()
        _logger().warning(
            "remediation advice published (incident %d): rank %d "
            "input_bound -> DevicePrefetcher depth %d%s",
            inc["id"], inc["rank"], depth,
            "" if _remediate_enabled()
            else " (advisory; MXNET_REMEDIATE unset)")

    def view(self) -> dict:
        with self._lock:
            return dict(self._view)

    def health(self) -> Dict[int, dict]:
        """Per-rank health: healthy / degraded(cause) / missing, with
        last-seen age and last spool step."""
        with self._lock:
            return {r: dict(v) for r, v in self._health.items()}

    # -- thread lifecycle ----------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="mxnet-clustermon",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.poll_s):
            try:
                self.poll()
            except Exception:
                _logger().exception("cluster aggregator poll failed")

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None:
            t.join(5.0)
        self._thread = None


_aggregator: Optional[ClusterAggregator] = None


def aggregator() -> Optional[ClusterAggregator]:
    """The live aggregator (rank 0 with MXNET_CLUSTER_DIR set), else
    None."""
    return _aggregator


def cluster_view() -> Optional[dict]:
    """The aggregator's current cluster view (None when not running)."""
    agg = _aggregator
    return agg.view() if agg is not None else None


def rank_health() -> Dict[int, dict]:
    """Per-rank health from the live aggregator — what the elastic
    restore barrier consults before deciding whether to keep waiting
    on a rank: ``{rank: {status: healthy|degraded|missing, cause,
    last_rank_step, since_s}}``.  Empty when no aggregator runs in
    this process (non-rank-0, or clustermon disabled)."""
    agg = _aggregator
    return agg.health() if agg is not None else {}


def incident_view(limit: int = 50) -> dict:
    """Open + recent closed incidents and per-cause counts — the JSON
    body ``GET /incidents`` serves on both scrape surfaces, merging the
    rank-0 aggregator's straggler store with any registered extra
    stores (serving SLO incidents).  Empty shape when neither runs in
    this process."""
    agg = _aggregator
    if agg is None:
        view = {"open": [], "recent": [], "counts": {}}
    else:
        with agg._lock:
            view = agg.incidents.snapshot(limit)
    with _LOCK:
        extras = list(_EXTRA_STORES)
    for store in extras:
        try:
            snap = store.snapshot(limit)
        except Exception:
            continue
        view["open"].extend(snap.get("open", ()))
        view["recent"].extend(snap.get("recent", ()))
        for cause, n in (snap.get("counts") or {}).items():
            view["counts"][cause] = view["counts"].get(cause, 0) + n
    if len(view["recent"]) > limit:
        view["recent"] = sorted(
            view["recent"],
            key=lambda i: i.get("end_ts") or i.get("start_ts") or 0
        )[-limit:]
    return view


def _on_cluster_dir(directory: Optional[str]) -> None:
    """telemetry's env-refresh hook: start/stop the aggregator as
    ``MXNET_CLUSTER_DIR`` appears/changes/vanishes.  Only the rank-0
    PROCESS runs one (the thread-local rank override is deliberately
    ignored: under threads-as-ranks any worker thread may trigger the
    env refresh, and the process as a whole is rank 0)."""
    global _aggregator
    if _forked:
        return
    if _aggregator is not None and \
            (directory is None or _aggregator.directory != directory):
        _aggregator.stop()
        _aggregator = None
    if directory and _aggregator is None and \
            _process_rank_world()[0] == 0:
        _aggregator = ClusterAggregator(directory)
        _aggregator.start()


# -- Prometheus text exposition ----------------------------------------------

_NAME_SANE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str) -> str:
    return "mxnet_" + _NAME_SANE.sub("_", name)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _labels(d: Dict[str, Any]) -> str:
    inner = ",".join(f'{k}="{_escape_label(v)}"'
                     for k, v in sorted(d.items()))
    return "{" + inner + "}"


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return repr(f) if f == f else "NaN"


def prometheus_text(extra_labels: Optional[Dict[str, str]] = None) -> str:
    """The whole telemetry registry in Prometheus text exposition
    format (v0.0.4).  Every sample carries a ``rank`` label (the
    per-rank metrics plane: one scrape config, rank as
    the aggregation dimension); counters render as ``counter``, gauges
    as ``gauge`` (string-valued gauges like ``cluster.straggler_cause``
    become a ``1``-valued sample with the string in a label), and
    histograms as ``summary`` — reservoir p50/p95 quantiles plus exact
    ``_sum``/``_count``.  The ``cluster.incidents_total.<cause>``
    counters fold into one ``mxnet_cluster_incidents_total`` family
    with a ``cause`` label; string gauges additionally re-emit every
    previously-seen value at 0 so a cleared cause doesn't latch in
    Prometheus."""
    r, _w = rank_world()
    base = dict(extra_labels or {})
    base["rank"] = str(r)
    out: List[str] = []
    typed: set = set()
    for name, m in telemetry.metrics().items():
        if isinstance(m, telemetry.Counter) and \
                name.startswith(_INCIDENTS_FAMILY):
            # one # TYPE line for the whole family; metrics() is sorted
            # by name so family members render adjacently
            pname = _metric_name(_INCIDENTS_FAMILY[:-1])
            if pname not in typed:
                typed.add(pname)
                out.append(f"# TYPE {pname} counter")
            cause = name[len(_INCIDENTS_FAMILY):]
            out.append(f"{pname}{_labels(dict(base, cause=cause))}"
                       f" {_fmt(m.value)}")
            continue
        pname = _metric_name(name)
        if isinstance(m, telemetry.Counter):
            out.append(f"# TYPE {pname} counter")
            out.append(f"{pname}{_labels(base)} {_fmt(m.value)}")
        elif isinstance(m, telemetry.Gauge):
            v = m.value
            if v is None:
                continue
            out.append(f"# TYPE {pname} gauge")
            if isinstance(v, str):
                key = "cause" if name.endswith("cause") else "value"
                with _LOCK:
                    seen = _STR_SEEN.setdefault(name, set())
                    seen.add(v)
                    vals = sorted(seen)
                for sv in vals:     # current at 1, stale series at 0
                    out.append(
                        f"{pname}{_labels(dict(base, **{key: sv}))}"
                        f" {1 if sv == v else 0}")
            else:
                out.append(f"{pname}{_labels(base)} {_fmt(v)}")
        elif isinstance(m, telemetry.Histogram):
            out.append(f"# TYPE {pname} summary")
            samples = sorted(m.samples())
            for q, qs in ((50, "0.5"), (95, "0.95")):
                if samples:
                    k = max(0, min(len(samples) - 1,
                                   round(q / 100 * (len(samples) - 1))))
                    out.append(f"{pname}{_labels(dict(base, quantile=qs))}"
                               f" {_fmt(samples[k])}")
            out.append(f"{pname}_sum{_labels(base)} {_fmt(m.total)}")
            out.append(f"{pname}_count{_labels(base)} {_fmt(m.count)}")
    return "\n".join(out) + "\n"


_TYPE_RE = re.compile(
    r"^# TYPE ([a-zA-Z_:][a-zA-Z0-9_:]*) "
    r"(counter|gauge|histogram|summary|untyped)$")
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\",?)*)\})?"
    r" (-?(?:[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)|NaN|[+-]Inf)"
    r"(?: -?[0-9]+)?$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _unescape_label(v: str) -> str:
    return (v.replace("\\\\", "\x00").replace("\\n", "\n")
            .replace('\\"', '"').replace("\x00", "\\"))


def parse_prometheus_text(text: str) -> Dict[str, List[Tuple[Dict[str,
                                                                  str],
                                                             float]]]:
    """Strict-ish exposition parser used by the tests and the CI
    scrape check: validates ``# TYPE`` lines and sample syntax, resolves
    label escapes, and requires every sample's base metric (modulo
    ``_sum``/``_count``/``_bucket`` suffixes) to have a preceding TYPE
    line.  Raises ``ValueError`` on any malformed line.  Returns
    {metric name: [(labels, value)]}."""
    types: Dict[str, str] = {}
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if line.startswith("# HELP "):
                continue
            m = _TYPE_RE.match(line)
            if m is None:
                raise ValueError(f"line {i}: bad comment/TYPE line "
                                 f"{line!r}")
            types[m.group(1)] = m.group(2)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {i}: bad sample line {line!r}")
        name, rawlabels, val = m.group(1), m.group(2), m.group(3)
        base = re.sub(r"_(sum|count|bucket)$", "", name)
        if name not in types and base not in types:
            raise ValueError(f"line {i}: sample {name!r} has no "
                             f"preceding # TYPE line")
        labels = {}
        if rawlabels:
            consumed = 0
            for lm in _LABEL_RE.finditer(rawlabels):
                labels[lm.group(1)] = _unescape_label(lm.group(2))
                consumed = lm.end()
            if rawlabels[consumed:].strip(", "):
                raise ValueError(f"line {i}: bad label syntax "
                                 f"{rawlabels!r}")
        out.setdefault(name, []).append((labels, float(val)))
    return out


# -- standalone /metrics exporter (training processes) -----------------------

_metrics_httpd = None
_metrics_thread = None
_metrics_addr: Optional[Tuple[str, int]] = None


def start_metrics_server(port: int = 0,
                         host: str = "0.0.0.0") -> Tuple[str, int]:
    """Serve ``GET /metrics`` (text exposition), ``GET /incidents``
    (incident history JSON), ``GET /slo`` + ``GET /requestz`` (serving
    SLO view and slowest-request ring, when the serving subsystem is in
    this process) + ``GET /healthz`` on a daemon thread — the scrape
    surface for training processes, which have no serving server.
    Returns the bound ``(host, port)`` (OS-assigned when ``port=0``).
    Idempotent: an exporter already running keeps its socket."""
    global _metrics_httpd, _metrics_thread, _metrics_addr
    with _LOCK:
        if _metrics_httpd is not None:
            return _metrics_addr
        from http.server import BaseHTTPRequestHandler, \
            ThreadingHTTPServer

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                route = self.path.split("?", 1)[0]
                if route == "/metrics":
                    body = prometheus_text().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif route == "/incidents":
                    body = json.dumps(incident_view()).encode()
                    ctype = "application/json"
                elif route == "/slo":
                    from .serving import slo as _slo
                    body = json.dumps(_slo.slo_view()).encode()
                    ctype = "application/json"
                elif route == "/requestz":
                    from .serving import slo as _slo
                    limit = None
                    if "?" in self.path:
                        from urllib.parse import parse_qs
                        q = parse_qs(self.path.split("?", 1)[1])
                        try:
                            limit = int(q.get("limit", [None])[0])
                        except (TypeError, ValueError):
                            pass
                    body = json.dumps(_slo.requestz(limit)).encode()
                    ctype = "application/json"
                elif self.path == "/healthz":
                    view = cluster_view()
                    body = json.dumps(
                        {"status": "ok", "rank": rank_world()[0],
                         "world": rank_world()[1],
                         "cluster": view}).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        _metrics_httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        _metrics_httpd.daemon_threads = True
        _metrics_thread = threading.Thread(
            target=_metrics_httpd.serve_forever,
            name="mxnet-metrics-exporter", daemon=True)
        _metrics_thread.start()
        _metrics_addr = _metrics_httpd.server_address[:2]
        return _metrics_addr


def stop_metrics_server() -> None:
    global _metrics_httpd, _metrics_thread, _metrics_addr
    with _LOCK:
        httpd, thread = _metrics_httpd, _metrics_thread
        _metrics_httpd = _metrics_thread = _metrics_addr = None
    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()
        if thread is not None:
            thread.join(5.0)


def metrics_server_address() -> Optional[Tuple[str, int]]:
    return _metrics_addr


def _on_metrics_port(port: Optional[str]) -> None:
    """telemetry's env-refresh hook for ``MXNET_METRICS_PORT``."""
    if _forked:
        return
    if not port:
        stop_metrics_server()
        return
    try:
        p = int(port)
    except ValueError:
        _logger().warning("invalid MXNET_METRICS_PORT=%r (want an int)",
                          port)
        return
    if _metrics_httpd is None:
        addr = start_metrics_server(p)
        _logger().info("metrics exporter serving /metrics on %s:%d",
                       *addr)


# a forked child (a DataLoader worker) has none of its parent's threads:
# it forgets the aggregator and the exporter and starts neither from the
# environment
_forked = False


def _after_fork_in_child() -> None:
    global _aggregator, _metrics_httpd, _metrics_thread, _metrics_addr
    global _forked, _LOCK
    _aggregator = None
    _metrics_httpd = _metrics_thread = _metrics_addr = None
    _forked = True
    _LOCK = threading.Lock()


os.register_at_fork(after_in_child=_after_fork_in_child)
