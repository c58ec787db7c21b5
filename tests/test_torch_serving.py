"""Batch serving in the port (``mxnet_tpu_torch/serving/``: engine,
batcher, server, slo) on the CPU: the reference's ``tests/test_serving.py``
matrix and the request-identity cases of ``tests/test_serving_slo.py``,
run on the port.  ``test_torch_serving_parity.py`` holds the served
rows against the reference's.

On the CPU a bucket's ``Executable`` runs its forward on the static
input (nothing is captured); ``chip_smoke.py``'s ``batch_serve`` and
``lm_serve`` phases check the CUDA graphs.

Rows: bitwise equal to the eager forward of the same padded batch; a
batch-1 eager forward differs from a row of a larger batch by about one
ulp (another GEMM blocking), so it is held at rtol 1e-6 / atol 1e-7.
The reference asserts bitwise equality there, and fails by that ulp on
this tree (ROADMAP queue 3).
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry, tracing
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import registry
from mxnet_tpu_torch.serving import (BadRequestError, DynamicBatcher,
                                     InferenceEngine, QueueFullError,
                                     RequestTimeoutError, ServingClosedError,
                                     ServingServer, slo)

UNITS = 16


@pytest.fixture(autouse=True)
def _clean():
    telemetry.clear_sinks()
    slo.clear_ring()
    tracing._env_default()
    tracing.clear()
    yield
    telemetry.clear_sinks()
    slo.clear_ring()
    tracing._env_default()
    tracing.clear()


def _make_net(hidden=32):
    net = nn.Sequential()
    net.add(nn.Dense(hidden, in_units=UNITS, activation="relu"))
    net.add(nn.Dense(4, in_units=hidden))
    net.initialize(device="cpu", generator=torch.Generator().manual_seed(7))
    return net


def _examples(n, seed=0):
    rng = onp.random.RandomState(seed)
    return [rng.randn(UNITS).astype("float32") for _ in range(n)]


def _forward(net, batch):
    with mt.autograd.pause():
        return net(mt.nd.array(onp.asarray(batch), ctx=mt.cpu())).asnumpy()


def _eager_rows(net, examples):
    """One batch-1 eager forward a request."""
    return [_forward(net, x[None])[0] for x in examples]


def _assert_rows(got, ref):
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        onp.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)


def _engine(net, **kw):
    kw.setdefault("example_shape", (UNITS,))
    kw.setdefault("dtype", "float32")
    return InferenceEngine(net, **kw)


def _padded(xs, bucket):
    return onp.stack(list(xs) + [onp.zeros(UNITS, "float32")]
                     * (bucket - len(xs)))


# -- batching correctness ---------------------------------------------------

def test_batched_rows_equal_the_eager_forward_of_their_padded_batch():
    """N coalesced requests get the rows of the eager forward of their
    padded batch bitwise (the padding rows never leak), and the batch-1
    forward's within one ulp."""
    net = _make_net()
    xs = _examples(5)
    batcher = DynamicBatcher(_engine(net), start=False)
    futs = [batcher.submit(x) for x in xs]
    batcher.flush()
    got = [f.result(0) for f in futs]
    same = _forward(net, _padded(xs, 8))
    for i, g in enumerate(got):
        assert g.dtype == onp.float32 and g.shape == (4,)
        onp.testing.assert_array_equal(g, same[i])
    _assert_rows(got, _eager_rows(net, xs))


def test_bucket_reuse_zero_compiles_one_dispatch_per_batch():
    """After warmup a steady stream into one bucket captures nothing
    and makes ONE dispatch a batch."""
    net = _make_net()
    eng = _engine(net)
    batcher = DynamicBatcher(eng, start=False)
    assert eng.warmup([4]) == [f"4x{UNITS}:float32"]
    comp = telemetry.counter("compile.count")
    disp = telemetry.counter("dispatch.count")
    bucket_disp = telemetry.counter(
        f"serving.bucket.4x{UNITS}:float32.dispatches")
    c0, b0 = comp.value, bucket_disp.value
    for round_i in range(3):
        futs = [batcher.submit(x) for x in _examples(4, seed=round_i)]
        d0 = disp.value
        batcher.flush()
        assert disp.value - d0 == 1
        assert all(f.done() for f in futs)
    assert comp.value - c0 == 0
    assert bucket_disp.value - b0 == 3
    assert eng.buckets() == [f"4x{UNITS}:float32"]


def test_warmup_padding_and_bucket_routing():
    net = _make_net()
    eng = _engine(net)
    tags = eng.warmup([2, 4])
    assert tags == [f"2x{UNITS}:float32", f"4x{UNITS}:float32"]
    assert eng.buckets() == tags
    assert eng.warmup([((4, UNITS), "float32")]) == tags[1:]
    xs = _examples(3, seed=9)
    c0 = telemetry.counter("compile.count").value
    results, meta = eng.infer_batch(xs)
    assert telemetry.counter("compile.count").value - c0 == 0
    assert meta == {"bucket": f"4x{UNITS}:float32", "padded": 4,
                    "compiled": True, "compile_ms": 0.0}
    _assert_rows(results, _eager_rows(net, xs))
    with pytest.raises(MXNetError, match="fully-specified"):
        InferenceEngine(net).warmup([2])


def test_threaded_server_concurrent_predicts():
    net = _make_net()
    xs = _examples(8, seed=3)
    ref = _eager_rows(net, xs)
    with ServingServer(net, engine_args={"example_shape": (UNITS,),
                                         "dtype": "float32"},
                       batcher_args={"max_batch_size": 8,
                                     "max_delay_ms": 5.0}) as srv:
        srv.warmup([1, 2, 4, 8])
        got = [None] * len(xs)

        def client(i):
            got[i] = srv.predict(xs[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    assert all(g is not None for g in got)
    _assert_rows(got, ref)


def test_concurrent_dispatches_never_mix_their_batches():
    """The batcher's thread and direct ``infer_batch`` callers share one
    engine, whose buckets stage every batch into the same static input:
    each caller still gets its own rows (the dispatch lock), with the
    interpreter switching threads as often as it can."""
    import sys
    net = _make_net()
    eng = _engine(net)
    eng.warmup([4])
    batches = [_examples(4, seed=40 + i) for i in range(12)]
    want = [_forward(net, b) for b in batches]
    batcher = DynamicBatcher(eng, max_batch_size=4, max_delay_ms=1.0)
    errors = []

    def direct(i):
        for _ in range(5):
            got, _ = eng.infer_batch(batches[i])
            if not onp.array_equal(onp.stack(got), want[i]):
                errors.append(i)

    def queued(i):
        futs = [batcher.submit(x) for x in batches[i]]
        got = [f.result(30.0) for f in futs]
        if not onp.allclose(onp.stack(got), want[i], rtol=1e-6, atol=1e-7):
            errors.append(i)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=direct if i % 2 else queued,
                                    args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60.0)
    finally:
        sys.setswitchinterval(switch)
        batcher.close()
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# -- admission / robustness matrix ------------------------------------------

def test_malformed_requests_rejected_at_admission():
    net = _make_net()
    batcher = DynamicBatcher(_engine(net), start=False)
    rej = telemetry.counter("serving.rejected.shape")
    r0 = rej.value
    with pytest.raises(BadRequestError):          # wrong trailing dim
        batcher.submit(onp.zeros(UNITS + 1, "float32"))
    with pytest.raises(BadRequestError):          # wrong rank
        batcher.submit(onp.zeros((UNITS, 2), "float32"))
    with pytest.raises(BadRequestError):          # lossy dtype
        batcher.submit(onp.random.RandomState(0).randn(UNITS) + 1e-12)
    with pytest.raises(BadRequestError):          # not array-like
        batcher.submit(object())
    assert rej.value - r0 == 4
    assert batcher.pending() == 0
    ok = batcher.submit(onp.arange(UNITS))        # lossless ints admitted
    xs = _examples(1, seed=5)
    fut = batcher.submit(xs[0])
    batcher.flush()
    _assert_rows([fut.result(0)], _eager_rows(net, xs))
    assert ok.done()
    eng = InferenceEngine(net, seq_axes=(0,))
    with pytest.raises(BadRequestError, match="zero-size"):
        eng.validate(onp.zeros((0,), "float32"))
    with pytest.raises(BadRequestError):
        eng._bucket_batch(0)


def test_queue_full_sheds_load():
    net = _make_net()
    batcher = DynamicBatcher(_engine(net), queue_depth=2, start=False)
    xs = _examples(3, seed=1)
    f1, f2 = batcher.submit(xs[0]), batcher.submit(xs[1])
    c0 = telemetry.counter("serving.rejected.queue_full").value
    with pytest.raises(QueueFullError):
        batcher.submit(xs[2])
    assert telemetry.counter("serving.rejected.queue_full").value - c0 == 1
    batcher.flush()
    _assert_rows([f1.result(0), f2.result(0)], _eager_rows(net, xs[:2]))


def test_request_timeout_expires_in_queue():
    net = _make_net()
    batcher = DynamicBatcher(_engine(net), start=False)
    xs = _examples(2, seed=2)
    f_late = batcher.submit(xs[0], timeout_ms=1.0)
    f_ok = batcher.submit(xs[1])
    t0 = telemetry.counter("serving.timeouts").value
    time.sleep(0.02)
    batcher.flush()
    with pytest.raises(RequestTimeoutError):
        f_late.result(0)
    assert telemetry.counter("serving.timeouts").value - t0 == 1
    _assert_rows([f_ok.result(0)], _eager_rows(net, xs[1:]))


def test_future_result_wait_timeout():
    batcher = DynamicBatcher(_engine(_make_net()), start=False)
    fut = batcher.submit(_examples(1)[0])
    with pytest.raises(RequestTimeoutError):
        fut.result(0.01)            # nothing dispatches without flush()


def test_graceful_drain_and_closed_rejection():
    net = _make_net()
    xs = _examples(3, seed=4)
    batcher = DynamicBatcher(_engine(net), start=False)
    futs = [batcher.submit(x) for x in xs]
    batcher.close(drain=True)       # delivers every admitted response
    _assert_rows([f.result(0) for f in futs], _eager_rows(net, xs))
    with pytest.raises(ServingClosedError):
        batcher.submit(xs[0])
    b2 = DynamicBatcher(_engine(net), start=False)
    f2 = b2.submit(xs[0])
    b2.close(drain=False)
    with pytest.raises(ServingClosedError):
        f2.result(0)


def test_failed_dispatch_fails_its_batch_only():
    """An error in one dispatch fails that batch's futures; the batcher
    serves the next batch (the step record carries the error)."""
    net = _make_net()
    eng = _engine(net)
    batcher = DynamicBatcher(eng, start=False)
    real = eng.infer_batch
    calls = []

    def flaky(examples):
        calls.append(len(examples))
        if len(calls) == 1:
            raise MXNetError("device lost")
        return real(examples)

    eng.infer_batch = flaky
    failed0 = telemetry.counter("serving.failed_batches").value
    bad = [batcher.submit(x) for x in _examples(2, seed=21)]
    batcher.flush()
    xs = _examples(3, seed=22)
    good = [batcher.submit(x) for x in xs]
    batcher.flush()
    for f in bad:
        with pytest.raises(MXNetError, match="device lost"):
            f.result(0)
    _assert_rows([f.result(0) for f in good], _eager_rows(net, xs))
    assert telemetry.counter("serving.failed_batches").value - failed0 == 1


# -- capture fallbacks ------------------------------------------------------

def test_forward_hooks_decline_capture():
    net = _make_net()
    xs = _examples(2, seed=6)
    fired = []
    net.register_forward_hook(lambda blk, inp, out: fired.append(1))
    assert net.has_hooks()
    eng = _engine(net)
    c0 = telemetry.counter("compile.serving.count").value
    results, meta = eng.infer_batch(xs)
    assert meta["compiled"] is False
    assert telemetry.counter("compile.serving.count").value - c0 == 0
    assert fired                                  # the hook saw the batch
    onp.testing.assert_array_equal(onp.stack(results), _forward(net, xs))


def test_mxnet_serving_disabled_env(monkeypatch):
    net = _make_net()
    eng = _engine(net)
    xs = _examples(2, seed=8)
    ref = _forward(net, xs)
    monkeypatch.setenv("MXNET_SERVING", "0")
    c0 = telemetry.counter("compile.serving.count").value
    results, meta = eng.infer_batch(xs)
    assert meta["compiled"] is False
    assert telemetry.counter("compile.serving.count").value - c0 == 0
    assert eng.buckets() == []
    onp.testing.assert_array_equal(onp.stack(results), ref)
    monkeypatch.delenv("MXNET_SERVING")
    results, meta = eng.infer_batch(xs)
    assert meta["compiled"] is True
    onp.testing.assert_array_equal(onp.stack(results), ref)


def test_engine_bucket_budget_latches_eager():
    net = _make_net()
    eng = _engine(net, max_sigs=2)
    eng.warmup([1, 2])
    assert len(eng.buckets()) == 2
    c0 = telemetry.counter("compile.serving.count").value
    _, meta = eng.infer_batch(_examples(3, seed=10))   # bucket 4
    assert meta["compiled"] is False
    assert telemetry.counter("compile.serving.count").value - c0 == 0
    st = eng.stats()
    assert st["latched"] and st["budget_declines"] >= 1
    assert len(eng.buckets()) == 2
    _, meta = eng.infer_batch(_examples(2, seed=11))   # bucket 2
    assert meta["compiled"] is True


def test_call_cached_shares_jit_sig_budget(monkeypatch):
    """Over the budget a hybridized block's new signature runs eagerly
    and the cache stops growing; the captured ones keep replaying."""
    monkeypatch.setattr(registry, "_MAX_JIT_SIGS", 2)
    net = nn.Dense(4, in_units=8)
    net.initialize(device="cpu")
    net.hybridize()
    w = net.weight._tensor().detach().numpy()
    b = net.bias._tensor().detach().numpy()
    rng = onp.random.RandomState(13)
    outs = {}
    for n in (2, 4, 8):
        x = rng.randn(n, 8).astype("float32")
        outs[n] = (x, net(mt.nd.array(x, ctx=mt.cpu())).asnumpy())
    assert len(net._cached_graphs) == 2
    assert net._sig_budget.latched and net._sig_budget.declines >= 1
    for n, (x, y) in outs.items():
        onp.testing.assert_allclose(y, x @ w.T + b, rtol=1e-5, atol=1e-5)
    c0 = telemetry.counter("compile.cached_op.count").value
    for n in (2, 4, 8):
        x, y = outs[n]
        onp.testing.assert_array_equal(
            net(mt.nd.array(x, ctx=mt.cpu())).asnumpy(), y)
    assert telemetry.counter("compile.cached_op.count").value - c0 == 0
    net.hybridize()
    assert net._sig_budget is None and not net._cached_graphs


def test_replaced_parameters_drop_the_buckets_graphs():
    """``cast`` replaces every parameter: a graph captured on the old
    ones is dropped, never replayed over freed addresses."""
    net = _make_net()
    eng = _engine(net, dtype="float64")
    eng.warmup([2])
    net.cast("float64")
    drops = telemetry.counter("serving.bucket_drops").value
    assert eng.buckets() == []
    assert telemetry.counter("serving.bucket_drops").value - drops == 1
    xs = [x.astype("float64") for x in _examples(2, seed=23)]
    results, meta = eng.infer_batch(xs)
    assert meta["compiled"] and results[0].dtype == onp.float64
    with torch.no_grad():           # (nd.array would narrow float64)
        ref = net(torch.from_numpy(onp.stack(xs))).numpy()
    onp.testing.assert_array_equal(onp.stack(results), ref)


# -- what was not ported before: exported blocks, the artifact store --------

def test_exported_blocks_and_the_artifact_store_say_not_ported(monkeypatch,
                                                               caplog):
    """Both are served now: an exported block's signatures set the
    engine's buckets, example shape and dtype (as the reference's), and
    ``MXNET_ARTIFACT_DIR`` is accepted with one log line while the engine
    captures and serves as without it (the port has no executable
    artifact to store)."""
    class Exported(nn.Sequential):
        def input_signatures(self):
            return [(((2, UNITS), "float32"),), (((8, UNITS), "float32"),)]

    eng = InferenceEngine(Exported())
    assert eng.example_shape == (UNITS,) and eng.dtype == "float32"
    assert eng._bucket_sizes == [2, 8]
    net = _make_net()
    eng = _engine(net)
    monkeypatch.setenv("MXNET_ARTIFACT_DIR", "/nonexistent")
    with caplog.at_level("WARNING", logger="mxnet_tpu_torch.serving"):
        assert eng.warmup([2]) and eng.warmup([4])
    assert sum("MXNET_ARTIFACT_DIR" in r.getMessage()
               for r in caplog.records) == 1
    xs = _examples(2, seed=5)
    results, meta = eng.infer_batch(xs)
    assert meta["compiled"]
    with torch.no_grad():
        ref = net(torch.from_numpy(onp.stack(xs))).numpy()
    onp.testing.assert_array_equal(onp.stack(results), ref)


# -- server surface ---------------------------------------------------------

def test_server_inprocess_predict_and_healthz():
    net = _make_net()
    xs = _examples(2, seed=15)
    srv = ServingServer(net,
                        engine_args={"example_shape": (UNITS,),
                                     "dtype": "float32"},
                        batcher_args={"max_delay_ms": 0.5,
                                      "max_batch_size": 4})
    try:
        srv.warmup([1, 2])
        _assert_rows([srv.predict(x) for x in xs], _eager_rows(net, xs))
        h = srv.healthz()
        assert h["status"] == "serving" and h["max_batch_size"] == 4
        assert h["buckets"] == [f"1x{UNITS}:float32", f"2x{UNITS}:float32"]
        assert h["ready"] and h["open_serving_incidents"] == 0
        assert srv.incidentz()["open"] == []
        assert "mxnet_serving_requests{" in srv.metricz()
        assert srv.varz()["serving.requests"] >= 2
        assert srv.sloz()["declared"] is False
    finally:
        srv.stop(drain=True)
    assert srv.healthz()["status"] == "draining"
    with pytest.raises(ServingClosedError):
        srv.predict(xs[0])


def test_http_endpoint_roundtrip():
    net = _make_net()
    x = _examples(1, seed=16)[0]
    with ServingServer(net, engine_args={"example_shape": (UNITS,),
                                         "dtype": "float32"}) as srv:
        host, port = srv.start_http()
        url = f"http://{host}:{port}"

        def get(path):
            with urllib.request.urlopen(url + path, timeout=10) as resp:
                return json.loads(resp.read())

        def post(path, body):
            req = urllib.request.Request(
                url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())

        assert get("/healthz")["status"] == "serving"
        out = onp.asarray(post("/predict", {"data": x.tolist()})["output"],
                          dtype="float32")
        onp.testing.assert_array_equal(out, srv.predict(x))
        for path, body, code in (
                ("/predict", {"data": [[1.0]]}, 400),
                ("/predict", {"nodata": 1}, 400),
                ("/predict", {"data": x.tolist(), "dtype": "nodtype"}, 400),
                ("/generate", {"prompt": [1]}, 503),    # no decoder
                ("/nothing", {}, 404)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(path, body)
            assert ei.value.code == code, path
        with urllib.request.urlopen(url + "/metrics", timeout=10) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            assert "# TYPE mxnet_serving_requests counter" in \
                resp.read().decode()
        assert set(get("/incidents")) == {"open", "recent", "counts"}
        assert get("/varz")["serving.batches"] >= 2
        tz = get("/tracez?limit=5")
        assert set(tz) == {"enabled", "spans", "dropped", "recent", "open"}
        assert get("/slo")["declared"] is False
        rz = get("/requestz?limit=2")
        assert rz["ring_capacity"] == 16 and rz["requests_seen"] >= 2


# -- the step record --------------------------------------------------------

class _Records:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_step_records_carry_the_serving_section():
    """Every dispatch emits one step record whose serving section
    reconciles with what was served: occupancy, padding waste, the
    reject and timeout deltas."""
    sink = _Records()
    telemetry.add_sink(sink)
    net = _make_net()
    batcher = DynamicBatcher(_engine(net), queue_depth=3, start=False)
    reqs0 = telemetry.counter("serving.requests").value
    futs = [batcher.submit(x) for x in _examples(3, seed=18)]
    with pytest.raises(QueueFullError):
        batcher.submit(_examples(1, seed=19)[0])
    batcher.flush()                     # batch of 3 -> bucket 4
    futs += [batcher.submit(x) for x in _examples(2, seed=20)]
    batcher.flush()                     # batch of 2 -> bucket 2
    assert all(f.done() for f in futs)
    recs = [r for r in sink.records if r["source"] ==
            "serving.DynamicBatcher"]
    assert len(recs) == 2
    s0, s1 = recs[0]["serving"], recs[1]["serving"]
    assert (s0["batch_size"], s0["padded_batch"]) == (3, 4)
    assert (s1["batch_size"], s1["padded_batch"]) == (2, 2)
    assert s0["padding_waste"] == 0.25 and s1["padding_waste"] == 0.0
    assert (s0["rejects"], s1["rejects"]) == (1, 0)
    assert s0["timeouts"] == s1["timeouts"] == 0
    assert s0["compiled"] and len(s0["request_ms"]) == 3
    assert s0["request_ids"] == sorted(s0["request_ids"])
    assert recs[0]["dispatches"] == 1 and recs[0]["compiles"] == 1
    assert telemetry.counter("serving.requests").value - reqs0 == 5
    hist = telemetry.snapshot("serving.batch_size")["serving.batch_size"]
    assert hist["count"] >= 2


# -- request identity and the slow ring (tests/test_serving_slo.py) ---------

def test_request_ids_monotonic():
    a = slo.next_request_id()
    b = slo.next_request_id()
    assert b == a + 1 and slo.request_count() >= b


def test_slow_ring_keeps_n_slowest(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_SLOW_RING", "3")
    for i in range(8):
        slo._ring_add({"id": i, "latency_ms": float(i)})
    rz = slo.requestz()
    assert rz["ring_capacity"] == 3 and rz["tracked"] == 3
    assert [e["id"] for e in rz["slowest"]] == [7, 6, 5]
    assert [e["id"] for e in slo.requestz(limit=1)["slowest"]] == [7]


def test_undeclared_view_and_declare_not_ported(monkeypatch):
    """The undeclared view's shape; objectives, ported since, declare by
    call and by ``MXNET_SLO_LATENCY_MS`` (``test_torch_serving_slo.py``
    holds them against the reference)."""
    v = slo.slo_view()
    assert v["declared"] is False and v["objectives"] is None
    assert set(v) == {"declared", "objectives", "requests_seen",
                      "weights_age_s", "ring"}
    assert slo.declared() is False and slo.burning_cause() is None
    s = slo.declare(latency_ms=20)
    assert slo.get() is s and slo.active() and slo.slo_view()["declared"]
    slo.undeclare()
    monkeypatch.setenv("MXNET_SLO_LATENCY_MS", "50")
    assert slo.get().latency_ms == 50.0 and slo.active()
    b = DynamicBatcher(_engine(_make_net()), start=False)
    assert slo.slo_view()["objectives"]["latency"]["target_ms"] == 50.0
    b.close(drain=False)
    monkeypatch.delenv("MXNET_SLO_LATENCY_MS")
    assert slo.declared() is False


def test_request_id_span_taxonomy():
    tracing.enable()
    net = _make_net()
    b = DynamicBatcher(_engine(net), start=False, max_delay_ms=0.0)
    futs = [b.submit(x) for x in _examples(3, seed=24)]
    b.flush()
    for f in futs:
        f.result(0)
    evs = {}
    for e in tracing.recent(4096):
        evs.setdefault(e["name"], []).append(e)
    enq_ids = [e["args"]["request_id"] for e in evs["serving.enqueue"]]
    assert len(enq_ids) == 3 and sorted(enq_ids) == enq_ids
    reqs = evs["serving.request"]
    assert {e["args"]["request_id"] for e in reqs} == set(enq_ids)
    for e in reqs:
        assert {"queue_wait_ms", "hold_ms", "dispatch_ms", "validate_ms",
                "pad_share", "batch_size"} <= set(e["args"])
    assert evs["serving.coalesce"][0]["args"]["request_ids"] == enq_ids
    assert evs["serving.dispatch"][0]["args"]["request_ids"] == enq_ids
    assert evs["compile.serving"][0]["args"]["bucket"] == \
        f"4x{UNITS}:float32"
    # tracing on: each request entered the slow ring
    assert {e["id"] for e in slo.requestz()["slowest"]} == set(enq_ids)
    b.close(drain=False)


def test_submit_expires_stale_neighbors_without_dispatcher():
    b = DynamicBatcher(_engine(_make_net()), start=False)
    fa = b.submit(_examples(1, seed=25)[0], timeout_ms=1.0)
    time.sleep(0.02)
    b.submit(_examples(1, seed=26)[0])
    assert fa.done()
    with pytest.raises(RequestTimeoutError):
        fa.result(0)
    assert b.pending() == 1
    b.close(drain=False)


def test_hold_window_expires_held_request_promptly():
    """A deadline that passes inside the hold window fails at its
    deadline (~30 ms), not at the end of the 500 ms hold, while the
    batch-mate without a deadline still dispatches."""
    b = DynamicBatcher(_engine(_make_net()), max_batch_size=4,
                       max_delay_ms=500.0, start=True)
    t0 = time.perf_counter()
    fa = b.submit(_examples(1, seed=27)[0])
    fb = b.submit(_examples(1, seed=28)[0], timeout_ms=30.0)
    with pytest.raises(RequestTimeoutError):
        fb.result(5.0)
    waited = time.perf_counter() - t0
    assert waited < 0.4, f"timeout resolved after {waited:.3f}s"
    assert fa.result(5.0) is not None
    b.close(drain=False)
    assert time.perf_counter() - t0 >= 0.03


def test_disabled_contract_no_threads_no_accounting(monkeypatch):
    for k in ("MXNET_SLO_LATENCY_MS", "MXNET_TRACE"):
        monkeypatch.delenv(k, raising=False)
    assert slo.active() is False
    net = _make_net()
    x = _examples(1, seed=29)[0]
    ref = _forward(net, x[None])
    n_threads = threading.active_count()
    b = DynamicBatcher(_engine(net), start=False, max_delay_ms=0.0)
    fut = b.submit(x)
    b.flush()
    onp.testing.assert_array_equal(fut.result(0), ref[0])
    assert threading.active_count() == n_threads
    assert slo.requestz()["tracked"] == 0
    assert tracing.recent() == []
    b.close(drain=False)
