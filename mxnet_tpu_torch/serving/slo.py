"""Serving SLO plane: request identity, burn-rate alerting and
saturation attribution (counterpart of ``mxnet_tpu/serving/slo.py``).

- **Request identity**: :func:`next_request_id` mints the monotonic id
  the batcher and the decode scheduler stamp into every admitted
  request's spans; :func:`observe_request` takes each finished
  request's latency decomposition into a bounded ring of the N slowest
  (``MXNET_SERVING_SLOW_RING``, default 16), served at
  ``GET /requestz``.
- **Objectives**: :class:`ServingSLO` evaluates a pXX latency target
  and an availability budget (and a time-to-first-token target) over
  sliding windows with the multi-window burn-rate rule: alert when both
  the long window (``MXNET_SLO_WINDOW_S``) and the short one (long/12)
  burn budget faster than ``burn_threshold`` (14.4), clear when the
  long window falls under it.  Results land in ``serving_slo.*``
  metrics, the step record's ``serving_slo`` section (through
  ``telemetry.set_slo_provider``) and ``GET /slo``.
- **Incidents**: a burning objective drives a
  :class:`clustermon.IncidentStore` (open, escalate, close), with the
  causes ``latency_slo`` / ``error_budget`` / ``queue_saturation`` /
  ``ttft_slo``, shown at ``GET /incidents`` beside the straggler
  incidents.  The dominant per-request signal (queue wait, compute,
  padding, cold capture) names the cause; an escalated
  ``queue_saturation`` incident publishes batcher-tuning advice,
  applied to the live batchers under ``MXNET_REMEDIATE=1``.
- **No thread**: evaluation runs inline on the dispatch path,
  rate-limited to about a quarter of the short window; ``GET /slo``
  forces one.  With no objective declared (``MXNET_SLO_LATENCY_MS``
  unset, no :func:`declare`) and tracing off, nothing here runs beyond
  the id increment.

The reference's ``tools/slo_report.py`` replays the same burn rule over
JSONL records offline.
"""
from __future__ import annotations

import heapq
import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, List, Optional

from .. import telemetry
from .. import tracing

__all__ = ["ServingSLO", "declare", "undeclare", "declared", "get",
           "active", "next_request_id", "request_count",
           "observe_request", "slo_view", "requestz", "burning_cause",
           "clear_ring", "note_weights_published", "weights_age_s",
           "note_batcher", "SAT_SIGNALS"]

_LOCK = threading.RLock()


def _logger():
    from ..log import get_logger
    return get_logger("mxnet_tpu_torch.serving.slo")


def _getenv_float(name: str, default: Optional[float] = None
                  ) -> Optional[float]:
    v = os.environ.get(name)
    if not v:
        return default
    try:
        return float(v)
    except ValueError:
        return default


# -- request identity --------------------------------------------------------

_RID_LOCK = threading.Lock()
_rid = 0


def next_request_id() -> int:
    """Monotonic per-process request id — stamped by the batcher into
    every admitted request's spans so admission, coalescing and
    dispatch stay joinable."""
    global _rid
    with _RID_LOCK:
        _rid += 1
        return _rid


def request_count() -> int:
    """Ids minted so far (== requests admitted to the queue)."""
    return _rid


# -- slowest-request ring ----------------------------------------------------

def _ring_capacity() -> int:
    v = os.environ.get("MXNET_SERVING_SLOW_RING")
    try:
        return max(1, int(v)) if v else 16
    except ValueError:
        return 16


_RING_LOCK = threading.Lock()
_ring: List[tuple] = []       # min-heap of (latency_ms, seq, entry)
_ring_seq = 0


def _ring_add(entry: dict) -> None:
    global _ring_seq
    cap = _ring_capacity()
    with _RING_LOCK:
        _ring_seq += 1
        item = (float(entry.get("latency_ms") or 0.0), _ring_seq, entry)
        if len(_ring) < cap:
            heapq.heappush(_ring, item)
        elif item[0] > _ring[0][0]:
            heapq.heapreplace(_ring, item)
        while len(_ring) > cap:     # capacity shrank mid-run
            heapq.heappop(_ring)


def clear_ring() -> None:
    with _RING_LOCK:
        _ring.clear()


def requestz(limit: Optional[int] = None) -> dict:
    """The ``GET /requestz`` body: the N slowest requests served (their
    full latency decomposition), slowest first."""
    with _RING_LOCK:
        tracked = len(_ring)
        items = sorted(_ring, key=lambda it: (-it[0], it[1]))
    entries = [dict(it[2]) for it in items]
    if limit is not None:
        entries = entries[:max(0, int(limit))]
    return {"ring_capacity": _ring_capacity(), "tracked": tracked,
            "requests_seen": _rid, "slowest": entries}


# -- weights staleness (future parameter-streaming path) ---------------------

_weights_ts: Optional[float] = None


def note_weights_published(ts: Optional[float] = None) -> None:
    """Stamp a parameter-set publication.  The online-learning path
    will call this on every weight swap; until then the gauge simply
    reads 'age of the weights this server booted with' once someone
    stamps it."""
    global _weights_ts
    _weights_ts = time.time() if ts is None else float(ts)
    telemetry.gauge("serving.weights_age_s").set(0.0)


def weights_age_s() -> Optional[float]:
    """Seconds since the last published weight set (None when never
    stamped — the gauge stays unset and off /metrics)."""
    if _weights_ts is None:
        return None
    age = round(max(0.0, time.time() - _weights_ts), 3)
    telemetry.gauge("serving.weights_age_s").set(age)
    return age


# -- live-batcher registry (queue_saturation remediation target) -------------

_batchers: "weakref.WeakSet" = weakref.WeakSet()


def note_batcher(batcher) -> None:
    """Batchers self-register at construction so an escalated
    ``queue_saturation`` incident can tune the live instance under
    ``MXNET_REMEDIATE=1`` (weak refs: a drained batcher just ages
    out)."""
    _batchers.add(batcher)


# -- the SLO engine ----------------------------------------------------------

SAT_SIGNALS = ("queue_wait", "compute", "padding", "compile")


class ServingSLO:
    """Declared serving objectives evaluated over sliding windows.

    Not a thread: :meth:`observe` (the batcher's per-request feed)
    triggers a rate-limited inline evaluation; :meth:`evaluate` (the
    ``/slo`` endpoints) forces one.  Owns its own
    :class:`clustermon.IncidentStore` (persisted next to the cluster
    spools when ``MXNET_CLUSTER_DIR`` is set) and registers it with
    :func:`clustermon.incident_view` so ``GET /incidents`` shows
    serving incidents beside straggler incidents."""

    def __init__(self, latency_ms: float, percentile: float = 95.0,
                 availability: Optional[float] = None,
                 window_s: Optional[float] = None,
                 burn_threshold: Optional[float] = None,
                 min_samples: Optional[int] = None,
                 directory: Optional[str] = None,
                 ttft_ms: Optional[float] = None,
                 from_env: bool = False):
        from .. import clustermon
        self.latency_ms = float(latency_ms)
        # decode-plane time-to-first-token objective: only requests
        # that report a ttft_ms (generation requests) feed it; same
        # percentile budget as end-to-end latency
        self.ttft_ms = (float(ttft_ms)
                        if ttft_ms is not None and float(ttft_ms) > 0
                        else None)
        self.percentile = float(percentile) if percentile else 95.0
        self.availability = (float(availability)
                             if availability is not None else 0.999)
        self.window_s = float(window_s) if window_s else 60.0
        self.short_s = max(0.05, self.window_s / 12.0)
        self.burn_threshold = (float(burn_threshold)
                               if burn_threshold else 14.4)
        self.min_samples = (int(min_samples)
                            if min_samples is not None else 10)
        self.from_env = from_env
        self.directory = (directory if directory is not None
                          else (os.environ.get("MXNET_CLUSTER_DIR")
                                or None))
        # budget fractions: the share of requests ALLOWED to miss
        self._lat_budget = max(1e-6, 1.0 - self.percentile / 100.0)
        self._avail_budget = max(1e-6, 1.0 - self.availability)
        self._store = clustermon.IncidentStore(self.directory)
        self._lock = threading.RLock()
        self._samples: deque = deque()      # (t_mono, latency_ms, ok)
        self._signals: deque = deque()      # (t_mono, {signal: ms})
        self._ttft: deque = deque()         # (t_mono, ttft_ms)
        self._burning: Optional[dict] = None
        self._view: dict = {}
        self._last_eval = 0.0
        self._eval_interval = min(0.25, self.short_s / 4.0)
        self._c_req = telemetry.counter("serving_slo.requests")
        self._c_breach = telemetry.counter("serving_slo.breaches")
        self._c_err = telemetry.counter("serving_slo.errors")
        self._c_eval = telemetry.counter("serving_slo.evals")
        self._c_inc = telemetry.counter("serving_slo.incidents")
        telemetry.gauge("serving_slo.latency_target_ms").set(
            self.latency_ms)
        telemetry.gauge("serving_slo.burning").set(0)

    # -- sampling -----------------------------------------------------------

    def observe(self, entry: dict) -> None:
        """Feed one finished (or failed/expired) request.  ``entry``
        carries the batcher's latency decomposition: ``latency_ms``,
        ``ok``, and optional ``validate_ms`` / ``queue_ms`` /
        ``hold_ms`` / ``dispatch_ms`` / ``pad_share`` /
        ``compile_ms``."""
        now = time.monotonic()
        lat = float(entry.get("latency_ms") or 0.0)
        ok = bool(entry.get("ok", True))
        disp = float(entry.get("dispatch_ms") or 0.0)
        pad = float(entry.get("pad_share") or 0.0) * disp
        comp = float(entry.get("compile_ms") or 0.0)
        sig = {
            "queue_wait": (float(entry.get("queue_ms") or 0.0)
                           + float(entry.get("hold_ms") or 0.0)),
            "compute": max(0.0, disp - pad - comp),
            "padding": pad,
            "compile": comp,
        }
        ttft = entry.get("ttft_ms")
        with self._lock:
            self._samples.append((now, lat, ok))
            self._signals.append((now, sig))
            if ttft is not None and self.ttft_ms is not None:
                self._ttft.append((now, float(ttft)))
                if float(ttft) > self.ttft_ms:
                    telemetry.counter("serving_slo.ttft_breaches").inc()
            self._c_req.inc()
            if lat > self.latency_ms:
                self._c_breach.inc()
            if not ok:
                self._c_err.inc()
            if now - self._last_eval >= self._eval_interval:
                self._evaluate_locked(now)

    # -- evaluation ---------------------------------------------------------

    def evaluate(self) -> dict:
        """Force one evaluation pass (the ``/slo`` endpoints call this
        so a burn clears even after traffic stops)."""
        with self._lock:
            return self._evaluate_locked(time.monotonic())

    def view(self) -> dict:
        """The last evaluation's view (evaluating once if none ran
        yet)."""
        with self._lock:
            if not self._view:
                return self._evaluate_locked(time.monotonic())
            return dict(self._view)

    def snapshot(self, limit: int = 50) -> dict:
        """Incident-store snapshot — the clustermon extra-store
        protocol ``incident_view`` merges."""
        with self._lock:
            return self._store.snapshot(limit)

    def step_section(self) -> Optional[dict]:
        """The compact per-step-record ``serving_slo`` section
        (telemetry's provider hook)."""
        with self._lock:
            v = self._view
            if not v:
                return {"declared": True}
            lat = v.get("latency") or {}
            b = v.get("burning")
            return {"p95_ms": lat.get("p95_ms"),
                    "p99_ms": lat.get("p99_ms"),
                    "burn_long": lat.get("burn_long"),
                    "burn_short": lat.get("burn_short"),
                    "budget_remaining": lat.get("budget_remaining"),
                    "burning": b["cause"] if b else None}

    @staticmethod
    def _pct(sorted_vals: List[float], p: float) -> float:
        if not sorted_vals:
            return 0.0
        k = max(0, min(len(sorted_vals) - 1,
                       round(p / 100.0 * (len(sorted_vals) - 1))))
        return sorted_vals[k]

    def _prune(self, now: float) -> None:
        cut = now - self.window_s
        while self._samples and self._samples[0][0] < cut:
            self._samples.popleft()
        while self._signals and self._signals[0][0] < cut:
            self._signals.popleft()
        while self._ttft and self._ttft[0][0] < cut:
            self._ttft.popleft()

    def _saturation(self) -> Dict[str, float]:
        n = len(self._signals)
        out = {k: 0.0 for k in SAT_SIGNALS}
        if not n:
            return out
        for _, sig in self._signals:
            for k in SAT_SIGNALS:
                out[k] += sig.get(k, 0.0)
        return {k: round(v / n, 3) for k, v in out.items()}

    def _attribute(self, sat: Dict[str, float]) -> str:
        """Cause attribution, the straggler decision rule transplanted:
        the dominant per-request signal names the cause; a dominant
        queue-wait is ``queue_saturation``, anything else (compute /
        padding / cold compile / unattributed) burns as
        ``latency_slo``."""
        total = sum(sat.values())
        if total <= 0.0:
            return "latency_slo"
        top = max(sat, key=lambda k: sat[k])
        if sat[top] <= 0.0 or sat[top] < 0.1 * total:
            return "latency_slo"    # nothing explains the latency
        return "queue_saturation" if top == "queue_wait" \
            else "latency_slo"

    def _evaluate_locked(self, now: float) -> dict:
        from .. import clustermon
        self._last_eval = now
        self._c_eval.inc()
        self._prune(now)
        long_w = list(self._samples)
        cut_short = now - self.short_s
        short_w = [s for s in long_w if s[0] >= cut_short]
        n_long, n_short = len(long_w), len(short_w)
        lats = sorted(l for (_t, l, _ok) in long_w)
        p50 = round(self._pct(lats, 50), 3)
        p95 = round(self._pct(lats, 95), 3)
        p99 = round(self._pct(lats, 99), 3)

        def _frac(win, pred):
            return (sum(1 for s in win if pred(s)) / len(win)) \
                if win else 0.0

        lat_frac_long = _frac(long_w, lambda s: s[1] > self.latency_ms)
        lat_frac_short = _frac(short_w, lambda s: s[1] > self.latency_ms)
        err_frac_long = _frac(long_w, lambda s: not s[2])
        err_frac_short = _frac(short_w, lambda s: not s[2])
        lat_burn_long = lat_frac_long / self._lat_budget
        lat_burn_short = lat_frac_short / self._lat_budget
        av_burn_long = err_frac_long / self._avail_budget
        av_burn_short = err_frac_short / self._avail_budget
        # ttft objective (decode plane): its own sample stream — only
        # generation requests report a first-token time
        ttft_long = list(self._ttft)
        ttft_short = [s for s in ttft_long if s[0] >= cut_short]
        ttfts = sorted(v for (_t, v) in ttft_long)
        ttft_p50 = round(self._pct(ttfts, 50), 3)
        ttft_p95 = round(self._pct(ttfts, 95), 3)
        ttft_burn_long = ttft_burn_short = 0.0
        if self.ttft_ms is not None:
            ttft_burn_long = _frac(
                ttft_long,
                lambda s: s[1] > self.ttft_ms) / self._lat_budget
            ttft_burn_short = _frac(
                ttft_short,
                lambda s: s[1] > self.ttft_ms) / self._lat_budget
        sat = self._saturation()
        # multi-window multi-burn-rate rule with hysteresis: open when
        # BOTH windows exceed the threshold, close when the long window
        # drops under it (the cause is latched while burning so the
        # incident store never flaps close/open on a signal wobble)
        thr = self.burn_threshold
        enough = n_long >= self.min_samples and n_short >= 1
        enough_ttft = (self.ttft_ms is not None
                       and len(ttft_long) >= self.min_samples
                       and len(ttft_short) >= 1)
        if self._burning is None and (enough or enough_ttft):
            if enough and av_burn_long >= thr and av_burn_short >= thr:
                self._burning = {"objective": "availability",
                                 "cause": "error_budget",
                                 "since_ts": round(time.time(), 3)}
            elif enough and lat_burn_long >= thr \
                    and lat_burn_short >= thr:
                self._burning = {"objective": "latency",
                                 "cause": self._attribute(sat),
                                 "since_ts": round(time.time(), 3)}
            elif enough_ttft and ttft_burn_long >= thr \
                    and ttft_burn_short >= thr:
                self._burning = {"objective": "ttft",
                                 "cause": "ttft_slo",
                                 "since_ts": round(time.time(), 3)}
        elif self._burning is not None:
            long_burn = {"availability": av_burn_long,
                         "ttft": ttft_burn_long}.get(
                             self._burning["objective"], lat_burn_long)
            if long_burn < thr:
                self._burning = None
        if self._burning is None:
            verdict = None
            burn_rep = round(max(lat_burn_long, av_burn_long,
                                 ttft_burn_long), 3)
        else:
            burn_rep = round(
                {"availability": av_burn_long,
                 "ttft": ttft_burn_long}.get(
                     self._burning["objective"], lat_burn_long), 3)
            verdict = {"rank": clustermon.rank_world()[0],
                       "cause": self._burning["cause"],
                       "ratio": burn_rep, "step_ms": p95}
        events = self._store.observe(verdict, step=_rid,
                                     now=time.time())
        if events:
            self._handle_events(events)
        view = {
            "declared": True,
            "objectives": {
                "latency": {"target_ms": self.latency_ms,
                            "percentile": self.percentile,
                            "budget": round(self._lat_budget, 6)},
                "availability": {"target": self.availability,
                                 "budget": round(self._avail_budget,
                                                 6)},
            },
            "window": {"long_s": self.window_s,
                       "short_s": round(self.short_s, 3),
                       "burn_threshold": thr,
                       "min_samples": self.min_samples},
            "samples": {"long": n_long, "short": n_short},
            "latency": {
                "p50_ms": p50, "p95_ms": p95, "p99_ms": p99,
                "target_ms": self.latency_ms,
                "breach_fraction_long": round(lat_frac_long, 4),
                "breach_fraction_short": round(lat_frac_short, 4),
                "burn_long": round(lat_burn_long, 3),
                "burn_short": round(lat_burn_short, 3),
                "budget_remaining": round(
                    max(0.0, 1.0 - lat_burn_long), 3),
            },
            "availability": {
                "target": self.availability,
                "observed": round(1.0 - err_frac_long, 6),
                "errors": sum(1 for s in long_w if not s[2]),
                "requests": n_long,
                "burn_long": round(av_burn_long, 3),
                "burn_short": round(av_burn_short, 3),
                "budget_remaining": round(
                    max(0.0, 1.0 - av_burn_long), 3),
            },
            "saturation": sat,
            "ttft": ({
                "target_ms": self.ttft_ms,
                "p50_ms": ttft_p50, "p95_ms": ttft_p95,
                "samples": len(ttft_long),
                "burn_long": round(ttft_burn_long, 3),
                "burn_short": round(ttft_burn_short, 3),
                "budget_remaining": round(
                    max(0.0, 1.0 - ttft_burn_long), 3),
            } if self.ttft_ms is not None else None),
            "weights_age_s": weights_age_s(),
            "burning": (dict(self._burning, saturation=sat,
                             burn=burn_rep)
                        if self._burning else None),
            "incidents": {
                "open": self._store.snapshot(1)["open"],
                "counts": self._store.snapshot(1)["counts"],
            },
        }
        self._view = view
        g = telemetry.gauge
        g("serving_slo.latency_p50_ms").set(p50)
        g("serving_slo.latency_p95_ms").set(p95)
        g("serving_slo.latency_p99_ms").set(p99)
        g("serving_slo.latency_burn_long").set(round(lat_burn_long, 3))
        g("serving_slo.latency_burn_short").set(round(lat_burn_short,
                                                      3))
        g("serving_slo.latency_budget_remaining").set(
            round(max(0.0, 1.0 - lat_burn_long), 3))
        g("serving_slo.availability").set(round(1.0 - err_frac_long, 6))
        g("serving_slo.availability_burn_long").set(round(av_burn_long,
                                                          3))
        g("serving_slo.error_budget_remaining").set(
            round(max(0.0, 1.0 - av_burn_long), 3))
        if self.ttft_ms is not None:
            g("serving_slo.ttft_p50_ms").set(ttft_p50)
            g("serving_slo.ttft_p95_ms").set(ttft_p95)
            g("serving_slo.ttft_burn_long").set(
                round(ttft_burn_long, 3))
        g("serving_slo.burning").set(1 if self._burning else 0)
        g("serving_slo.burning_cause").set(
            self._burning["cause"] if self._burning else "none")
        return dict(view)

    # -- incident lifecycle -------------------------------------------------

    def _handle_events(self, events: List[dict]) -> None:
        """Bump the counter family, log, mark the trace timeline, fire
        the shared on_incident hooks, and publish queue-saturation
        advice — all inline (no aggregator thread on the serving
        side)."""
        from .. import clustermon
        for ev in events:
            inc = ev["incident"]
            if ev["event"] == "open":
                self._c_inc.inc()
                clustermon._C_INCIDENTS.inc()
                clustermon._C_INCIDENT_CAUSE.get(
                    inc["cause"],
                    clustermon._C_INCIDENT_CAUSE["unknown"]).inc()
                _logger().warning(
                    "serving SLO incident %d opened: %s burning at "
                    "%.1fx budget (p95 %.2f ms over the %gs window)",
                    inc["id"], inc["cause"], inc["peak_ratio"],
                    inc["peak_step_ms"], self.window_s)
            elif ev["event"] == "close":
                _logger().info(
                    "serving SLO incident %d closed: %s after %.1fs, "
                    "peak burn %.1fx",
                    inc["id"], inc["cause"], inc["duration_s"],
                    inc["peak_ratio"])
            if ev["event"] == "escalate" \
                    and inc["cause"] == "queue_saturation":
                self._publish_batcher_advice(inc)
            tracing.instant(f"cluster.incident.{ev['event']}",
                            incident=inc["id"], rank=inc["rank"],
                            cause=inc["cause"])
            for fn in clustermon.incident_hooks():
                try:
                    fn(ev["event"], dict(inc))
                except Exception:
                    _logger().exception("on_incident hook %r failed",
                                        fn)

    def _publish_batcher_advice(self, inc: dict) -> None:
        """Escalated queue saturation → batcher tuning through the
        advice plane: coalesce harder (double ``max_batch``) and stop
        holding for stragglers a saturated queue already provides
        (halve ``max_delay_ms``).  Published to ``advice.jsonl`` when a
        cluster dir exists; applied to live batchers only under
        ``MXNET_REMEDIATE=1`` (counted either way)."""
        from .. import clustermon
        live = [b for b in list(_batchers) if not b.closed]
        cur_mb = max([b.max_batch_size for b in live], default=32)
        cur_delay = max([b.max_delay_ms for b in live], default=2.0)
        rec = {"action": "batcher_tuning", "rank": inc["rank"],
               "max_batch": int(max(1, 2 * cur_mb)),
               "max_delay_ms": round(cur_delay / 2.0, 3),
               "incident_id": inc["id"], "cause": inc["cause"],
               "ts": round(time.time(), 3)}
        if self.directory:
            try:
                with open(os.path.join(self.directory,
                                       clustermon.ADVICE_FILE),
                          "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass
        telemetry.counter("cluster.advice_published").inc()
        if clustermon._remediate_enabled() and live:
            for b in live:
                b.max_batch_size = rec["max_batch"]
                b.max_delay_ms = max(0.0, rec["max_delay_ms"])
            telemetry.counter("cluster.advice_applied").inc()
            _logger().warning(
                "remediation applied (incident %d): batcher max_batch "
                "-> %d, max_delay_ms -> %.2f", inc["id"],
                rec["max_batch"], rec["max_delay_ms"])
        else:
            telemetry.counter("cluster.advice_ignored").inc()
            _logger().warning(
                "remediation advice published (incident %d): "
                "queue_saturation -> max_batch %d, max_delay_ms %.2f "
                "(advisory; MXNET_REMEDIATE unset)",
                inc["id"], rec["max_batch"], rec["max_delay_ms"])


# -- declaration plumbing ----------------------------------------------------
# Objectives come from either an explicit declare() call or the env
# knobs (MXNET_SLO_LATENCY_MS declares the plane; MXNET_SLO_WINDOW_S /
# MXNET_SLO_AVAILABILITY / MXNET_SLO_BURN_THRESHOLD shape it), re-read
# on every declared() check the way telemetry re-reads its sink env —
# a long-lived process can flip them without re-importing.  An explicit
# declare() owns the plane; env changes don't clobber it.

_slo: Optional[ServingSLO] = None
_env_cache: Dict[str, Any] = {"key": None}


def _declare_locked(**kw) -> ServingSLO:
    global _slo
    from .. import clustermon
    _slo = ServingSLO(**kw)
    clustermon.register_incident_store(_slo)
    telemetry.set_slo_provider(_slo.step_section)
    return _slo


def _undeclare_locked() -> None:
    global _slo
    if _slo is None:
        return
    from .. import clustermon
    clustermon.unregister_incident_store(_slo)
    telemetry.set_slo_provider(None)
    _slo = None


def _refresh_env() -> None:
    global _slo
    key = (os.environ.get("MXNET_SLO_LATENCY_MS") or None,
           os.environ.get("MXNET_SLO_WINDOW_S") or None,
           os.environ.get("MXNET_SLO_AVAILABILITY") or None,
           os.environ.get("MXNET_SLO_BURN_THRESHOLD") or None,
           os.environ.get("MXNET_SLO_TTFT_MS") or None)
    if key == _env_cache["key"]:
        return
    with _LOCK:
        if key == _env_cache["key"]:
            return
        _env_cache["key"] = key
        if _slo is not None and not _slo.from_env:
            return
        if _slo is not None:
            _undeclare_locked()
        lat = _getenv_float("MXNET_SLO_LATENCY_MS")
        if lat is not None and lat > 0:
            _declare_locked(
                latency_ms=lat,
                window_s=_getenv_float("MXNET_SLO_WINDOW_S"),
                availability=_getenv_float("MXNET_SLO_AVAILABILITY"),
                burn_threshold=_getenv_float(
                    "MXNET_SLO_BURN_THRESHOLD"),
                ttft_ms=_getenv_float("MXNET_SLO_TTFT_MS"),
                from_env=True)


def declare(latency_ms: float, percentile: float = 95.0,
            availability: Optional[float] = None,
            window_s: Optional[float] = None,
            burn_threshold: Optional[float] = None,
            min_samples: Optional[int] = None,
            directory: Optional[str] = None,
            ttft_ms: Optional[float] = None) -> ServingSLO:
    """Declare (or re-declare) the serving objectives explicitly.
    Replaces any live SLO engine, env-declared or not.  ``ttft_ms``
    adds the decode-plane time-to-first-token objective (also
    declarable via ``MXNET_SLO_TTFT_MS`` alongside
    ``MXNET_SLO_LATENCY_MS``)."""
    with _LOCK:
        _undeclare_locked()
        return _declare_locked(
            latency_ms=latency_ms, percentile=percentile,
            availability=availability, window_s=window_s,
            burn_threshold=burn_threshold, min_samples=min_samples,
            directory=directory, ttft_ms=ttft_ms, from_env=False)


def undeclare() -> None:
    """Drop the live SLO engine (tests / shutdown).  While the env
    knobs stay set, the next declared() check re-declares from them."""
    with _LOCK:
        _undeclare_locked()
        _env_cache["key"] = None


def declared() -> bool:
    _refresh_env()
    return _slo is not None


def get() -> Optional[ServingSLO]:
    _refresh_env()
    return _slo


def active() -> bool:
    """True when per-request accounting should run at all: objectives
    declared (SLO sampling) or tracing live (slow-request ring).  The
    batcher's disabled-path guard."""
    return declared() or tracing.enabled()


def observe_request(entry: dict) -> None:
    """Per-request feed from the batcher: slow-ring admission plus SLO
    sampling (each gated on its own switch)."""
    s = _slo
    if s is not None or tracing.enabled():
        _ring_add(entry)
    if s is not None:
        s.observe(entry)


def burning_cause() -> Optional[str]:
    """The currently-burning cause (None when healthy or
    undeclared)."""
    s = get()
    if s is None:
        return None
    b = s.view().get("burning")
    return b["cause"] if b else None


def slo_view() -> dict:
    """The ``GET /slo`` body (both ServingServer and the standalone
    exporter serve it).  Forces a fresh evaluation so a burn clears —
    and its incident closes — even when traffic has stopped."""
    _refresh_env()
    s = _slo
    ring = {"capacity": _ring_capacity(), "tracked": len(_ring)}
    if s is None:
        return {"declared": False, "objectives": None,
                "requests_seen": _rid, "weights_age_s": weights_age_s(),
                "ring": ring}
    view = s.evaluate()
    view["requests_seen"] = _rid
    view["ring"] = ring
    return view
