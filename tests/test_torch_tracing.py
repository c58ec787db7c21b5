"""The port's span recorder (``mxnet_tpu_torch/tracing.py``) against the
reference's, on the CPU: the critical-path bucket of every span name the
port records, the buckets' totals, ``aggregate``, the Chrome-trace
export's document shape (rank metadata, thread names, open spans
flagged), ``MXNET_TRACE_JSONL`` streaming, the switches' precedence, and
the stall watchdog: one dump per incident, the checkpoint-barrier
clause, the thread's lifecycle (joins with a 10 s timeout).

The same intervals go through both packages (``record_span`` with fixed
times), so durations and bucket totals compare exactly.
"""
import json
import logging
import pathlib
import re
import threading
import time

import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu import tracing as jtr

from mxnet_tpu_torch import telemetry, tracing

ROOT = pathlib.Path(__file__).resolve().parents[1]
NAME = re.compile(r'"((?:step|input|compile|comm|ckpt|serving|cluster)'
                  r'\.[a-z0-9_.]+)"')


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("MXNET_TRACE", "MXNET_TRACE_JSONL", "MXNET_WATCHDOG_SEC",
              "MXNET_TRACE_BUFFER"):
        monkeypatch.delenv(k, raising=False)
    for tr in (tracing, jtr):
        tr.stop_watchdog()
        tr._env_default()
        tr.clear()
    yield
    for tr in (tracing, jtr):
        tr.stop_watchdog()
        tr._env_default()
        tr.clear()


def _names(pkg_dir):
    out = set()
    for path in pkg_dir.rglob("*.py"):
        out |= set(NAME.findall(path.read_text()))
    return out


def test_every_recorded_span_name_is_bucketed_as_the_reference():
    port = _names(ROOT / "mxnet_tpu_torch")
    ref = _names(ROOT / "mxnet_tpu")
    assert {"step.spmd", "step.update", "comm.push", "input.wait",
            "input.h2d", "ckpt.barrier", "compile.spmd_step",
            "serving.dispatch"} <= port
    for name in sorted(port):
        assert tracing._bucket_of(name) == jtr._bucket_of(name), name
    # the port records no span name the reference lacks (bar metric
    # names the same pattern catches)
    spans = {n for n in port if not n.endswith((".count", ".ms"))}
    missing = sorted(n for n in spans - ref
                     if not n.startswith(("serving.bucket", "comm.local",
                                          "step.host_ms",
                                          "serving.capture_failures")))
    assert missing == [], missing


def _script(tr):
    """Spans at fixed times: a nested step with an update and a
    collective, a wait, an instant, a cross-thread span and one left
    open."""
    tr.enable()
    t = tr._EPOCH + 1.0
    tr.record_span("step.spmd", t, t + 0.010, step=1)
    tr.record_span("step.update", t + 0.001, t + 0.003)
    tr.record_span("comm.pushpull", t + 0.003, t + 0.006,
                   payload_nbytes=80)
    tr.record_span("input.wait", t - 0.002, t)
    tr.record_span("compile.spmd_step", t, t + 0.004)
    tr.record_span("ckpt.serialize", t, t + 0.0005)
    tr.record_span("input.h2d", t, t + 0.001)
    tr.instant("cluster.incident.open", incident=1)
    with tr.span("serving.dispatch", batch_size=2) as sp:
        sp.annotate(padded=2)
    done = threading.Event()

    def other(s):
        tr.end(s, ok=True)
        done.set()

    s = tr.begin("serving.request", id=7)
    th = threading.Thread(target=other, args=(s,))
    th.start()
    th.join(10)
    assert done.is_set()
    tr.register_thread("test-main")
    return tr.begin("step.gluon")


def test_buckets_and_aggregate_match_the_reference():
    b0 = {tr: tr.bucket_totals_ms() for tr in (tracing, jtr)}
    opened = [_script(tr) for tr in (tracing, jtr)]
    got = {k: v - b0[tracing][k]
           for k, v in tracing.bucket_totals_ms().items()}
    ref = {k: v - b0[jtr][k] for k, v in jtr.bucket_totals_ms().items()}
    assert got == ref
    assert got == pytest.approx({"input_wait": 2.0, "h2d": 1.0,
                                 "compile": 4.0, "collective": 3.0,
                                 "optimizer": 2.0, "checkpoint": 0.5})
    agg = {n: a["count"] for n, a in tracing.aggregate().items()}
    assert agg == {n: a["count"] for n, a in jtr.aggregate().items()}
    for tr, sp in zip((tracing, jtr), opened):
        tr.end(sp)
    tracing.clear()
    assert set(tracing.bucket_totals_ms().values()) == {0.0}


# the spans _script books at fixed times
FIXED = {"step.spmd", "step.update", "comm.pushpull", "input.wait",
         "compile.spmd_step", "ckpt.serialize", "input.h2d",
         "cluster.incident.open"}


def test_export_document_matches_the_references_shape(tmp_path):
    # spans another test of this process left open, and threads it
    # registered, are in both exports too: the comparison leaves them out
    before = {tr: {o["span_id"] for o in tr.open_spans()}
              for tr in (tracing, jtr)}
    opened = [_script(tr) for tr in (tracing, jtr)]
    docs = []
    for tr, name in ((tracing, "port"), (jtr, "ref")):
        path = tr.export(str(tmp_path / f"{name}.json"))
        docs.append(json.loads(pathlib.Path(path).read_text()))
    got, ref = docs
    assert set(got) == set(ref) == {"traceEvents", "displayTimeUnit"}

    def shape(doc, tr):
        evs = [e for e in doc["traceEvents"]
               if not (e["args"].get("open")
                       and e["args"].get("span_id") in before[tr])]
        meta = sorted({e["name"] for e in evs if e["ph"] == "M"})
        spans = sorted((e["name"], e["ph"], e["cat"], tuple(sorted(e)),
                        tuple(sorted(k for k in e["args"]
                                     if k not in ("span_id", "parent_id"))),
                        e["dur"] if e["name"] in FIXED else None)
                       for e in evs if e["ph"] != "M")
        return meta, spans, evs

    assert shape(got, tracing)[:2] == shape(ref, jtr)[:2]
    got_evs = shape(got, tracing)[2]
    rw = [e for e in got["traceEvents"] if e["name"] == "rank_world"]
    assert rw[0]["args"] == {"rank": 0, "world": 1}
    names = [e["args"]["name"] for e in got["traceEvents"]
             if e["name"] == "thread_name"]
    assert "test-main" in names
    open_ = [e for e in got_evs if e["args"].get("open")]
    assert [e["name"] for e in open_] == ["step.gluon"]
    for tr, sp in zip((tracing, jtr), opened):
        tr.end(sp)


def test_jsonl_stream_and_the_switches(tmp_path, monkeypatch):
    path = tmp_path / "trace.jsonl"
    monkeypatch.setenv("MXNET_TRACE_JSONL", str(path))
    assert tracing.enabled() and jtr.enabled()
    with tracing.span("step.spmd"):
        pass
    ev = json.loads(path.read_text().splitlines()[-1])
    assert ev["name"] == "step.spmd" and ev["args"]["rank"] == 0
    monkeypatch.setenv("MXNET_TRACE", "0")     # off wins over the rest
    assert not tracing.enabled() and not jtr.enabled()
    assert tracing.span("step.spmd") is tracing._NULL
    monkeypatch.delenv("MXNET_TRACE")
    monkeypatch.delenv("MXNET_TRACE_JSONL")
    assert not tracing.enabled()
    tracing.enable()
    assert tracing.enabled()
    tracing.disable()
    assert not tracing.enabled()


@pytest.mark.parametrize("tr", [tracing, jtr], ids=["port", "ref"])
def test_watchdog_dumps_once_per_incident(tr, caplog):
    """Four completed steps make the baseline; a step open 1 s against a
    p95 of 1 ms is dumped once (live spans, the checkpoint clause, the
    thread stacks), and not again while it stays open."""
    tel = telemetry if tr is tracing else jtel
    tr.enable()
    t = time.perf_counter()
    for i in range(4):
        tr.record_span("step.wd", t - 1.0 + i * 0.01,
                       t - 1.0 + i * 0.01 + 0.001)
    barrier = tr.begin("ckpt.barrier", commit="c1")
    sp = tr.begin("step.wd")
    sp.t0 -= 1.0
    d0 = tel.counter("watchdog.stall_dumps").value
    with caplog.at_level(logging.WARNING):
        fired = tr._sweep(0.01, 4.0)
        again = tr._sweep(0.01, 4.0)
    assert fired == [sp.span_id] and again == []
    assert tel.counter("watchdog.stall_dumps").value - d0 == 1
    text = "\n".join(r.getMessage() for r in caplog.records)
    assert "STALL: rank 0/1: span 'step.wd'" in text
    assert "stuck in commit barrier" in text
    assert "thread stacks:" in text
    tr.end(sp)
    tr.end(barrier)


def test_watchdog_thread_lifecycle(monkeypatch):
    monkeypatch.setenv("MXNET_WATCHDOG_SEC", "0.05")
    assert tracing.enabled()                    # the switch turns tracing on
    wd = tracing._watchdog
    assert wd is not None and wd.is_alive() and wd.interval == 0.05
    tracing.stop_watchdog()
    wd.join(10)
    assert not wd.is_alive() and tracing._watchdog is None
    tracing.start_watchdog(0.02, factor=2.0)
    wd = tracing._watchdog
    assert wd.factor == 2.0
    tracing.stop_watchdog()
    wd.join(10)
    assert not wd.is_alive()
    monkeypatch.setenv("MXNET_WATCHDOG_SEC", "0")
    assert tracing._watchdog is None


def test_spans_nest_and_carry_the_rank():
    tracing.enable()
    with tracing.span("step.outer") as outer:
        with tracing.span("step.update"):
            pass
    inner = [e for e in tracing.recent(5) if e["name"] == "step.update"][0]
    assert inner["args"]["parent_id"] == outer.span_id
    assert inner["args"]["rank"] == 0
    assert tracing.span_count() >= 2
