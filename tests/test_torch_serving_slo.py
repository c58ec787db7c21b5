"""Declared serving objectives in the port (``mxnet_tpu_torch/serving/
slo.py``) against the reference's, on the CPU: the same latency
sequences through both ``ServingSLO`` engines on a fake clock give the
same burn rates, views and open / escalate / close points; the batcher's
advice under ``MXNET_REMEDIATE``; the record's ``serving_slo`` section;
``/slo``, ``/metrics`` and ``/incidents`` on the serving server (each
HTTP call has a 10 s timeout).

Burn rates, percentiles and incident events are compared exactly: both
engines do the same float arithmetic in Python on the same inputs.
"""
import json
import urllib.request

import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import clustermon as jcm
from mxnet_tpu import telemetry as jtel
from mxnet_tpu import tracing as jtr
from mxnet_tpu.serving import slo as jslo

from mxnet_tpu_torch import clustermon, profiler, telemetry, tracing
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.serving import (DynamicBatcher, InferenceEngine,
                                     ServingServer, slo)

UNITS = 16


@pytest.fixture(autouse=True)
def _clean():
    for tel, s, tr in ((telemetry, slo, tracing), (jtel, jslo, jtr)):
        tel.clear_sinks()
        s.undeclare()
        s.clear_ring()
        tr._env_default()
        tr.clear()
    yield
    for tel, s, tr in ((telemetry, slo, tracing), (jtel, jslo, jtr)):
        s.undeclare()
        s.clear_ring()
        tel.clear_sinks()
        tel.enabled()
        tr._env_default()
        tr.clear()


class FakeTime:
    """``time`` for a module under test: a clock the test moves."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t

    def perf_counter(self):
        return self.t


def _entry(mod, lat, ok=True, queue=0.0, dispatch=None, ttft=None):
    if dispatch is None:
        dispatch = max(0.0, lat - queue)
    e = {"id": mod.next_request_id(), "ok": ok, "latency_ms": lat,
         "queue_ms": queue, "hold_ms": 0.0, "dispatch_ms": dispatch,
         "pad_share": 0.0, "compile_ms": 0.0}
    if ttft is not None:
        e["ttft_ms"] = ttft
    return e


def _view_numbers(v):
    """The parts of a view that depend on the samples, not on the
    wall clock or the process."""
    out = {k: v[k] for k in ("objectives", "window", "samples", "latency",
                             "availability", "saturation", "ttft")}
    b = v["burning"]
    out["burning"] = None if b is None else {
        k: b[k] for k in ("objective", "cause", "saturation", "burn")}
    out["open"] = [(i["cause"], i["start_rank_step"] is not None,
                    i["polls"], i["escalated"], i["peak_ratio"])
                   for i in v["incidents"]["open"]]
    out["counts"] = v["incidents"]["counts"]
    return out


# a traffic script: (seconds to advance, latency ms, ok, queue ms)
SCRIPT = ([(0.05, 5.0, True, 1.0)] * 30          # healthy
          + [(0.05, 80.0, True, 70.0)] * 150     # queue-bound burn
          + [(0.05, 90.0, True, 5.0)] * 20       # compute-ward, latched
          + [(0.5, 3.0, True, 0.5)] * 40         # recovery: closes
          + [(0.05, 4.0, False, 1.0)] * 150      # errors: error_budget
          + [(1.0, 2.0, True, 0.5)] * 30)        # recovery


def _run_script(mod, monkeypatch, script, **declare):
    clock = FakeTime()
    monkeypatch.setattr(mod, "time", clock)
    s = mod.declare(**declare)
    views, events = [], []
    hook = lambda ev, inc: events.append(  # noqa: E731
        (ev, inc["cause"], inc["start_rank_step"] is not None))
    cm = jcm if mod is jslo else clustermon
    cm.on_incident(hook)
    try:
        for dt, lat, ok, q in script:
            clock.t += dt
            s.observe(_entry(mod, lat, ok=ok, queue=q))
            views.append(_view_numbers(s.evaluate()))
    finally:
        cm.remove_incident_hook(hook)
    return views, events


def test_same_traffic_gives_the_same_burns_and_incidents(monkeypatch):
    kw = dict(latency_ms=20.0, percentile=95.0, window_s=6.0,
              min_samples=10)
    ref = _run_script(jslo, monkeypatch, SCRIPT, **kw)
    got = _run_script(slo, monkeypatch, SCRIPT, **kw)
    assert got[1] == ref[1]
    assert [e[:2] for e in got[1]] == [
        ("open", "queue_saturation"), ("escalate", "queue_saturation"),
        ("close", "queue_saturation"), ("open", "error_budget"),
        ("escalate", "error_budget"), ("close", "error_budget")]
    assert len(got[0]) == len(ref[0])
    for i, (g, r) in enumerate(zip(*[got[0], ref[0]])):
        assert g == r, i


def test_ttft_objective_matches_the_reference(monkeypatch):
    def run(mod):
        clock = FakeTime()
        monkeypatch.setattr(mod, "time", clock)
        s = mod.declare(latency_ms=1000.0, ttft_ms=50.0, window_s=6.0,
                        min_samples=5)
        out = []
        for i in range(40):
            clock.t += 0.05
            s.observe(_entry(mod, 10.0, ttft=20.0 if i < 10 else 90.0))
            out.append(_view_numbers(s.evaluate()))
        return out
    ref, got = run(jslo), run(slo)
    assert got == ref
    assert got[-1]["burning"]["cause"] == "ttft_slo"


def test_env_declaration_and_step_section(monkeypatch):
    monkeypatch.setenv("MXNET_SLO_LATENCY_MS", "25")
    monkeypatch.setenv("MXNET_SLO_WINDOW_S", "12")
    assert slo.declared() and jslo.declared()
    assert slo.get().window_s == jslo.get().window_s == 12.0
    assert slo.get().latency_ms == 25.0
    sec = slo.get().step_section()
    assert sec == {"declared": True}
    monkeypatch.delenv("MXNET_SLO_LATENCY_MS")
    assert not slo.declared() and not jslo.declared()
    assert set(slo.slo_view()) == set(jslo.slo_view())


def _make_net():
    net = nn.Sequential()
    net.add(nn.Dense(8, in_units=UNITS, activation="relu"))
    net.add(nn.Dense(4, in_units=8))
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(7))
    return net


def _engine(net):
    return InferenceEngine(net, example_shape=(UNITS,), dtype="float32")


def _x(seed=0):
    return onp.random.RandomState(seed).randn(UNITS).astype("float32")


def _burn_to_escalation(s):
    for _ in range(20):
        s.observe(_entry(slo, 100.0, queue=90.0))
    s.evaluate()
    s.evaluate()


@pytest.mark.parametrize("remediate", ["1", None])
def test_queue_saturation_advice_reaches_live_batchers(tmp_path,
                                                       monkeypatch,
                                                       remediate):
    """The escalated queue_saturation incident publishes the reference's
    advice record; under ``MXNET_REMEDIATE=1`` the live batcher takes
    it, else it is logged and counted as ignored."""
    if remediate:
        monkeypatch.setenv("MXNET_REMEDIATE", remediate)
    else:
        monkeypatch.delenv("MXNET_REMEDIATE", raising=False)
    b = DynamicBatcher(_engine(_make_net()), start=False, max_batch_size=8,
                       max_delay_ms=4.0)
    c0 = {k: telemetry.counter(f"cluster.advice_{k}").value
          for k in ("applied", "ignored", "published")}
    s = slo.declare(latency_ms=20, window_s=30.0, min_samples=5,
                    directory=str(tmp_path))
    _burn_to_escalation(s)
    recs = [json.loads(ln) for ln in
            (tmp_path / "advice.jsonl").read_text().splitlines()]
    assert [(r["action"], r["cause"], r["max_batch"], r["max_delay_ms"])
            for r in recs] == [("batcher_tuning", "queue_saturation", 16,
                                2.0)]
    moved = {k: telemetry.counter(f"cluster.advice_{k}").value - c0[k]
             for k in c0}
    if remediate:
        assert (b.max_batch_size, b.max_delay_ms) == (16, 2.0)
        assert moved == {"applied": 1, "ignored": 0, "published": 1}
    else:
        assert (b.max_batch_size, b.max_delay_ms) == (8, 4.0)
        assert moved == {"applied": 0, "ignored": 1, "published": 1}
    b.close(drain=False)


def test_batcher_feeds_the_objective_and_the_record_section():
    records = []

    class Sink:
        def emit(self, r):
            records.append(r)

    telemetry.add_sink(Sink())
    b = DynamicBatcher(_engine(_make_net()), start=False, max_delay_ms=0.0)
    b.submit(_x())
    b.flush()
    assert "serving_slo" not in records[-1]
    s = slo.declare(latency_ms=1000.0, window_s=30.0)
    b.submit(_x(1))
    b.flush()
    sec = records[-1]["serving_slo"]
    assert set(sec) == {"p95_ms", "p99_ms", "burn_long", "burn_short",
                        "budget_remaining", "burning"}
    assert sec["burning"] is None
    assert s.view()["samples"]["long"] == 1
    assert profiler.counters()["serving"]["slo"]["declared"] is True
    b.close(drain=False)


def test_server_routes_metrics_incidents_slo_and_health():
    net = _make_net()
    s = slo.declare(latency_ms=20, window_s=30.0, min_samples=5)
    with ServingServer(net, engine_args={"example_shape": (UNITS,),
                                         "dtype": "float32"},
                       batcher_args={"max_delay_ms": 0.0},
                       start=False) as srv:
        fut = srv.batcher.submit(_x())
        srv.batcher.flush()
        fut.result(10)
        for _ in range(20):
            s.observe(_entry(slo, 100.0, queue=90.0))
        s.evaluate()
        h = srv.healthz()
        assert (h["ready"], h["open_serving_incidents"],
                h["slo_burning"]) == (False, 1, "queue_saturation")
        host, port = srv.start_http()
        url = f"http://{host}:{port}"

        def get(path):
            with urllib.request.urlopen(url + path, timeout=10) as resp:
                return resp.read().decode()

        text = get("/metrics")
        fam = clustermon.parse_prometheus_text(text)
        varz = json.loads(get("/varz"))
        assert fam["mxnet_serving_requests"][0][1] == \
            varz["serving.requests"]
        assert fam["mxnet_serving_slo_burning"][0][1] == 1.0
        inc = json.loads(get("/incidents"))
        assert [i["cause"] for i in inc["open"]] == ["queue_saturation"]
        assert inc["counts"]["queue_saturation"] >= 1
        v = json.loads(get("/slo"))
        assert v["declared"] is True
        assert v["burning"]["cause"] == "queue_saturation"
        # the reference's parser reads the port's text
        assert jcm.parse_prometheus_text(text).keys() == fam.keys()
    assert jmx is not None
