"""Cluster-scope observability in the port (``mxnet_tpu_torch/
clustermon.py``) against the reference's, on the CPU: rank resolution,
the straggler rule on the same synthetic per-rank records, a
threads-as-ranks run through both packages' spools and aggregators with
one slowed rank (the same incidents and the same advice), spool rotation
read back byte for byte, the incident store, Prometheus text read by
each package's parser from the other's, the exporter, the checkpoint
barrier's rank-health hint, and a forked child that inherits no thread.

Every thread join, HTTP call and child wait has its own timeout.
"""
import json
import os
import threading
import urllib.request

import pytest

from mxnet_tpu import clustermon as jcm
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.data import device_pipeline as jdp

from mxnet_tpu_torch import checkpoint, clustermon, telemetry, tracing
from mxnet_tpu_torch.data import device_pipeline


@pytest.fixture(autouse=True)
def _clean():
    for cm, tel, dp in ((clustermon, telemetry, device_pipeline),
                        (jcm, jtel, jdp)):
        tel.clear_sinks()
        cm.set_thread_rank(None)
        cm._HOOKS.clear()
        cm._STR_SEEN.clear()
        dp._advised_depth = 0
    saved = checkpoint._rank_override
    yield
    for cm, tel, dp in ((clustermon, telemetry, device_pipeline),
                        (jcm, jtel, jdp)):
        tel.clear_sinks()
        cm.set_thread_rank(None)
        agg = cm.aggregator()
        if agg is not None:
            agg.stop()
        cm._aggregator = None
        cm.stop_metrics_server()
        cm._HOOKS.clear()
        cm._STR_SEEN.clear()
        dp._advised_depth = 0
        tel.reset("cluster.")
        tel.enabled()
    checkpoint._rank_override = saved
    clustermon.note_rank(0, 1)


def _rec(step, host_ms, input_wait=0.0, compile_ms=0.0, barrier=0.0,
         comm=0.0, rank=None):
    r = {"rank_step": step, "host_ms": host_ms, "input_wait_ms": input_wait,
         "compile_ms": compile_ms, "checkpoint": {"barrier_wait_ms": barrier},
         "critical_path": {"collective": comm}}
    if rank is not None:
        r["rank"] = rank
    return r


def _by_rank(n, slow_rank=None, **slow):
    return {r: [_rec(s, 100.0, **slow) if r == slow_rank else _rec(s, 10.0)
                for s in range(1, n + 1)] for r in (0, 1, 2)}


def test_rank_world_precedence(monkeypatch):
    for cm in (clustermon, jcm):
        assert cm.rank_world() == (0, 1)
    monkeypatch.setenv("MXNET_CKPT_RANK", "3")
    monkeypatch.setenv("MXNET_CKPT_WORLD", "4")
    assert clustermon.rank_world() == jcm.rank_world() == (3, 4)
    seen = {}

    def worker(r):
        clustermon.set_thread_rank(r, 8)
        seen[r] = clustermon.rank_world()

    ts = [threading.Thread(target=worker, args=(r,)) for r in (5, 6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(10)
    assert seen == {5: (5, 8), 6: (6, 8)}
    assert clustermon.rank_world() == (3, 4)


@pytest.mark.parametrize("slow", [
    {"input_wait": 85.0}, {"compile_ms": 85.0}, {"barrier": 85.0},
    {"comm": 85.0}, {}, None], ids=["input", "compile", "checkpoint",
                                     "comm", "unknown", "none"])
def test_window_stats_and_straggler_match_the_reference(slow):
    by_rank = _by_rank(12, None if slow is None else 1, **(slow or {}))
    by_rank[2] = by_rank[2][:10]         # a rank behind: only joined steps
    for window in (0, 4):
        got = clustermon.window_stats(by_rank, window)
        assert got == jcm.window_stats(by_rank, window)
        assert clustermon.detect_straggler(got, 1.5) == \
            jcm.detect_straggler(got, 1.5)
    verdict = clustermon.detect_straggler(
        clustermon.window_stats(by_rank, 8), 1.5)
    if slow is None:
        assert verdict is None
    else:
        assert verdict["rank"] == 1
    assert clustermon.join_by_step(by_rank) == jcm.join_by_step(by_rank)
    for recs in by_rank.values():
        for r in recs:
            assert clustermon.record_signals(r) == jcm.record_signals(r)


def _threads_as_ranks(cm, directory, phases):
    """Three threads, one a rank each, emit their records into one
    SpoolSink; the aggregator polls after each phase.  Returns the
    incident events, the advice records and the views' stragglers."""
    sink = cm.SpoolSink(directory)
    agg = cm.ClusterAggregator(directory, window=6, factor=1.5)
    events = []
    cm.on_incident(lambda ev, inc: events.append(
        (ev, inc["rank"], inc["cause"])))
    stragglers = []
    for n, slow_rank in phases:
        def worker(r):
            cm.set_thread_rank(r, 3)
            for _ in range(n):
                slow = r == slow_rank
                sink.emit({"rank": cm.rank_world()[0],
                           "world": cm.rank_world()[1],
                           "host_ms": 100.0 if slow else 10.0,
                           "input_wait_ms": 85.0 if slow else 0.0})
        ts = [threading.Thread(target=worker, args=(r,)) for r in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
            assert not t.is_alive()
        for _ in range(2):
            v = agg.poll()
        s = v["straggler"]
        stragglers.append(None if s is None else (s["rank"], s["cause"]))
    sink.close()
    path = os.path.join(directory, cm.ADVICE_FILE)
    advice = []
    if os.path.exists(path):
        with open(path) as f:
            advice = [{k: v for k, v in json.loads(ln).items() if k != "ts"}
                      for ln in f]
    return events, advice, stragglers, agg.health()


def test_threads_as_ranks_aggregator_matches_the_reference(tmp_path,
                                                          monkeypatch):
    """A slowed, input-bound rank 1: an incident opens, escalates (the
    prefetch-depth advice is published) and closes when the rank
    recovers, the same in both packages; under ``MXNET_REMEDIATE=1`` the
    port's spool sink hands the advice to the device pipeline."""
    monkeypatch.setenv("MXNET_REMEDIATE", "1")
    monkeypatch.delenv("MXNET_DEVICE_PREFETCH", raising=False)
    phases = [(8, 1), (8, 1), (12, None)]
    ref = _threads_as_ranks(jcm, str(tmp_path / "ref"), phases)
    applied0 = telemetry.counter("cluster.advice_applied").value
    got = _threads_as_ranks(clustermon, str(tmp_path / "port"), phases)
    assert got[:3] == ref[:3]
    assert got[0] == [("open", 1, "input_bound"),
                      ("escalate", 1, "input_bound"),
                      ("close", 1, "input_bound")]
    assert [(a["action"], a["rank"], a["depth"]) for a in got[1]] == [
        ("prefetch_depth", 1, 4)]
    # the rank-side sink drained the advice addressed to rank 1
    assert device_pipeline.advised_depth() == 4
    assert telemetry.counter("cluster.advice_applied").value - applied0 \
        == 1
    assert {r: h["status"] for r, h in got[3].items()} == \
        {r: h["status"] for r, h in ref[3].items()}
    lines = (tmp_path / "port" / "incidents.jsonl").read_text().splitlines()
    assert [json.loads(ln)["event"] for ln in lines] == \
        ["open", "escalate", "close"]


def test_spool_rotation_reads_back_byte_exact(tmp_path, monkeypatch):
    """Rotation, pruning and compaction write the same files, byte for
    byte, in both packages; the reference's aggregator reads the port's
    segments as one stream."""
    monkeypatch.setenv("MXNET_CLUSTER_WINDOW", "5")
    dirs = {}
    for name, cm in (("ref", jcm), ("port", clustermon)):
        d = tmp_path / name
        sink = cm.SpoolSink(str(d), max_bytes=200, keep=2)
        for s in range(1, 31):
            sink.emit({"step": s, "rank": 0, "ts": 1.5, "host_ms": 10.0 + s,
                       "critical_path": {"input_wait": 0.5}})
        sink.close()
        dirs[name] = d
    names = sorted(p.name for p in dirs["ref"].iterdir())
    assert names == sorted(p.name for p in dirs["port"].iterdir())
    assert any(n.startswith("rank-0.jsonl.") for n in names)
    assert "rank-0.summary.jsonl" in names
    for n in names:
        assert (dirs["port"] / n).read_bytes() == \
            (dirs["ref"] / n).read_bytes(), n
    got = jcm.ClusterAggregator(str(dirs["port"]), window=5)
    got.poll()
    ref = jcm.ClusterAggregator(str(dirs["ref"]), window=5)
    ref.poll()
    assert got._by_rank == ref._by_rank
    assert [r["rank_step"] for r in got._by_rank[0]][-1] == 30


def test_incident_store_matches_the_reference(tmp_path):
    verdicts = ([{"rank": 1, "cause": "input_bound", "ratio": 2.0 + i,
                  "step_ms": 50.0 + i} for i in range(3)]
                + [None]
                + [{"rank": 2, "cause": "comm_skew", "ratio": 3.0,
                    "step_ms": 40.0, "comm_axis": "dp"}] * 2
                + [{"rank": 2, "cause": "compile_stall", "ratio": 3.0,
                    "step_ms": 40.0}])
    out = []
    for cm in (jcm, clustermon):
        st = cm.IncidentStore(str(tmp_path / cm.__name__), keep=2)
        evs = []
        for i, v in enumerate(verdicts):
            evs += [(e["event"], {k: x for k, x in e["incident"].items()
                                  if not k.endswith(("_ts", "_s"))})
                    for e in st.observe(v, step=i + 1, now=100.0 + i)]
        snap = st.snapshot()
        out.append((evs, snap["counts"], len(snap["recent"])))
    assert out[0] == out[1]


def test_prometheus_text_reads_in_both_parsers():
    """The same metrics render to the same lines; each package's parser
    reads the other's whole text."""
    for tel in (telemetry, jtel):
        tel.counter("ptest.requests").value = 7
        tel.gauge("ptest.ratio").set(0.25)
        tel.gauge("ptest.straggler_cause").set("input_bound")
        h = tel.histogram("ptest.latency_ms")
        h.reset()
        for v in (1.0, 2.0, 3.0, 10.0):
            h.observe(v)
        tel.counter("cluster.incidents_total.input_bound").value = 2
    got, ref = clustermon.prometheus_text(), jcm.prometheus_text()

    def lines(text):
        return sorted(ln for ln in text.splitlines()
                      if "ptest" in ln or "incidents_total" in ln)

    assert lines(got) == lines(ref)
    assert "mxnet_ptest_latency_ms{quantile=\"0.95\",rank=\"0\"} 10.0" in got
    pg = jcm.parse_prometheus_text(got)
    pr = clustermon.parse_prometheus_text(ref)
    assert pg["mxnet_ptest_requests"] == [({"rank": "0"}, 7.0)]
    assert pr["mxnet_ptest_requests"] == [({"rank": "0"}, 7.0)]
    assert clustermon.parse_prometheus_text(got).keys() == pg.keys()
    with pytest.raises(ValueError):
        clustermon.parse_prometheus_text("mxnet_x 1\n")


def test_metrics_exporter_routes_and_env(monkeypatch):
    host, port = clustermon.start_metrics_server(0, host="127.0.0.1")
    assert clustermon.metrics_server_address() == (host, port)
    url = f"http://{host}:{port}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=10) as resp:
            return resp.read().decode()

    fam = clustermon.parse_prometheus_text(get("/metrics"))
    assert "mxnet_telemetry_steps" in fam
    assert json.loads(get("/incidents")) == {"open": [], "recent": [],
                                             "counts": {}}
    assert json.loads(get("/healthz"))["status"] == "ok"
    assert json.loads(get("/slo"))["declared"] is False
    clustermon.stop_metrics_server()
    assert clustermon.metrics_server_address() is None
    monkeypatch.setenv("MXNET_METRICS_PORT", "0")
    telemetry.enabled()
    assert clustermon.metrics_server_address() is not None
    monkeypatch.delenv("MXNET_METRICS_PORT")
    telemetry.enabled()
    assert clustermon.metrics_server_address() is None


def test_cluster_dir_env_spools_records_and_runs_the_aggregator(
        tmp_path, monkeypatch):
    d = str(tmp_path / "cluster")
    monkeypatch.setenv("MXNET_CLUSTER_DIR", d)
    for _ in range(3):
        telemetry.end_step(telemetry.begin_step(), "test")
    agg = clustermon.aggregator()
    assert agg is not None and agg.directory == d
    view = agg.poll()
    assert sorted(view["ranks"]) == [0] and view["joined_steps"] == 3
    with open(os.path.join(d, "rank-0.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    assert [r["rank_step"] for r in recs] == [1, 2, 3]
    assert profiler_cluster()["joined_steps"] >= 3
    monkeypatch.delenv("MXNET_CLUSTER_DIR")
    telemetry.enabled()
    assert clustermon.aggregator() is None


def profiler_cluster():
    from mxnet_tpu_torch import profiler
    return profiler.counters()["cluster"]


def test_rank_health_and_the_barrier_hint(tmp_path):
    assert clustermon.rank_health() == {}
    assert checkpoint._rank_health_hint({1}) == ""
    for r, n in ((0, 8), (1, 4)):
        with open(tmp_path / f"rank-{r}.jsonl", "w") as f:
            for s in range(1, n + 1):
                f.write(json.dumps(_rec(s, 10.0)) + "\n")
    agg = clustermon.ClusterAggregator(str(tmp_path), window=4,
                                       rank_timeout_s=0.05)
    clustermon._aggregator = agg
    agg.poll()
    import time
    time.sleep(0.1)
    agg.poll()
    hint = checkpoint._rank_health_hint({1})
    assert "rank 1: missing" in hint and "last spool step 4" in hint


def test_forked_child_inherits_no_thread(tmp_path, monkeypatch):
    """A forked child (a DataLoader worker) finds no aggregator, exporter
    or watchdog, and starts none from the environment it inherits."""
    monkeypatch.setenv("MXNET_CLUSTER_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_WATCHDOG_SEC", "30")
    monkeypatch.setenv("MXNET_TRACE", "1")
    telemetry.enabled()
    tracing.enabled()
    clustermon.start_metrics_server(0, host="127.0.0.1")
    assert clustermon.aggregator() is not None
    assert tracing._watchdog is not None
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            tracing.enabled()
            telemetry.enabled()
            res = [clustermon.aggregator() is None,
                   clustermon.metrics_server_address() is None,
                   tracing._watchdog is None,
                   [t.name for t in threading.enumerate()]]
        except BaseException as e:
            res = [repr(e)]
        with os.fdopen(w, "w") as f:
            f.write(json.dumps(res))
        os._exit(0)
    os.close(w)
    import select
    ready, _, _ = select.select([r], [], [], 30)
    assert ready, "the child did not answer in 30 s"
    with os.fdopen(r) as f:
        res = json.loads(f.read())
    os.waitpid(pid, 0)
    assert res[:3] == [True, True, True], res
    assert len(res[3]) == 1, res          # only the thread that forked
    tracing.stop_watchdog()
    monkeypatch.delenv("MXNET_WATCHDOG_SEC")
    monkeypatch.delenv("MXNET_TRACE")
    tracing._env_default()
