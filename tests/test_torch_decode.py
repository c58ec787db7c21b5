"""The port's decode serving plane (mxnet_tpu_torch.serving.decode)
against the reference's (mxnet_tpu.serving.decode), on the CPU at the
reference tests' sizes (vocab 48, dim 32, 4 heads, 2 layers, page
size 8).

Both packages get the same weights (the port draws them from the same
numpy seed in the same order, and ``convert.decode_params_from_numpy``
carries the reference's across); the reference runs its Pallas kernels
in interpret mode.  Engine steps are held at 1e-5 on the KV pools and
token-identical on the outputs; the scheduler's generations must equal
the reference scheduler's.
"""
import json
import time
import urllib.error
import urllib.request

import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx  # noqa: F401
from mxnet_tpu.serving.decode import DecodeEngine as JaxEngine
from mxnet_tpu.serving.decode import DecodeModel as JaxModel
from mxnet_tpu.serving.decode import DecodeScheduler as JaxScheduler

from mxnet_tpu_torch import convert, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (BadRequestError, DecodeEngine,
                                     DecodeModel, DecodeScheduler,
                                     QueueFullError, RequestTimeoutError,
                                     ServingClosedError, ServingServer, slo)
from mxnet_tpu_torch.serving.decode import OutOfPagesError
from mxnet_tpu_torch.serving.decode.paged_kv import (PageAllocator,
                                                     PagedKVCache)

VOCAB = 48
GEOM = dict(max_slots=4, num_pages=32, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def jax_models():
    return (JaxModel(VOCAB, dim=32, n_heads=4, n_layers=2, seed=0),
            JaxModel(VOCAB, dim=16, n_heads=2, n_layers=1, seed=7))


@pytest.fixture(scope="module")
def models(jax_models):
    """The port's target and draft, their weights carried across from
    the reference's."""
    out = []
    for jm, kw in zip(jax_models, (dict(dim=32, n_heads=4, n_layers=2,
                                         seed=0),
                                    dict(dim=16, n_heads=2, n_layers=1,
                                         seed=7))):
        m = DecodeModel(VOCAB, device="cpu", **kw)
        m.params = convert.decode_params_from_numpy(
            jax.tree.map(onp.asarray, jm.params), "cpu")
        out.append(m)
    return tuple(out)


def _prompts(n, lo=3, hi=12, seed=1):
    rs = onp.random.RandomState(seed)
    return [[int(t) for t in rs.randint(0, VOCAB,
                                        size=rs.randint(lo, hi + 1))]
            for _ in range(n)]


def _run(sch):
    while sch._has_work():
        sch.step()


def _pools_close(jax_pool, torch_pool):
    onp.testing.assert_allclose(torch_pool.numpy(), onp.asarray(jax_pool),
                                rtol=1e-5, atol=1e-5)


# -- weights -----------------------------------------------------------------

def test_same_seed_gives_the_references_weights(jax_models):
    jm = jax_models[0]
    tm = DecodeModel(VOCAB, dim=32, n_heads=4, n_layers=2, seed=0,
                     device="cpu")
    carried = convert.decode_params_from_numpy(
        jax.tree.map(onp.asarray, jm.params), "cpu")
    assert torch.equal(tm.params["embed"], carried["embed"])
    assert torch.equal(tm.params["lnf"], carried["lnf"])
    for lt, lc in zip(tm.params["layers"], carried["layers"]):
        assert lt.keys() == lc.keys()
        assert all(torch.equal(lt[k], lc[k]) for k in lt)


# -- page allocator / paged KV cache ----------------------------------------

def test_page_allocator_recycle_and_exhaustion():
    al = PageAllocator(4)
    a = al.alloc(3)
    assert len(a) == 3 and al.available == 1 and al.used == 3
    with pytest.raises(OutOfPagesError):
        al.alloc(2)
    assert al.available == 1            # failed alloc is atomic
    al.free(a)
    assert al.available == 4
    b = al.alloc(4)
    assert sorted(b) == sorted(set(b))  # recycled, no duplicates
    al.free(b)


def test_paged_kv_slot_acquire_release():
    c = PagedKVCache(layers=2, num_pages=6, page_size=4, max_slots=2,
                     pages_per_slot=4, heads=2, head_dim=8, device="cpu")
    assert tuple(c.pool.shape) == (2, 2, 6, 4, 2, 8)
    assert c.pool.device.type == "cpu"
    assert c.slot_capacity == 4 * 4
    c.acquire(0, 9)                     # 9 tokens → 3 pages
    assert c.pages_used() == 3
    with pytest.raises(OutOfPagesError):
        c.acquire(1, 16)                # needs 4, only 3 free
    assert c.pages_used() == 3          # failed acquire is atomic
    with pytest.raises(MXNetError):
        c.acquire(1, 17)                # over per-slot capacity
    assert c.release(0) == 3 and c.pages_used() == 0
    assert not c.tables[0].any()
    c.acquire(1, 16)                    # recycled pages serve a new slot
    assert c.pages_used() == 4
    assert c.release(1) == 4 and c.release(1) == 0


# -- engine steps against the reference engine ------------------------------

def _prefill_both(je, te, slot_prompts):
    """Acquire and prefill every slot in both engines chunk by chunk;
    returns the first generated token per slot (asserted equal)."""
    first = {}
    for s, p in slot_prompts.items():
        je.acquire_slot(s, len(p) + 8)
        te.acquire_slot(s, len(p) + 8)
        for start in range(0, len(p), te.prefill_chunk):
            chunk = p[start:start + te.prefill_chunk]
            a = je.prefill_chunk_step(s, chunk, start)
            b = te.prefill_chunk_step(s, chunk, start)
            assert a == b
        first[s] = b
    return first


def test_prefill_and_decode_steps_match_reference(jax_models, models):
    je = JaxEngine(jax_models[0], **GEOM)
    te = DecodeEngine(models[0], **GEOM)
    prompts = {0: _prompts(1, 11, 11, seed=3)[0],     # two chunks
               2: _prompts(1, 5, 5, seed=4)[0]}
    first = _prefill_both(je, te, prompts)
    _pools_close(je.cache.pool, te.cache.pool)
    toks = onp.zeros(4, onp.int32)
    pos = onp.zeros(4, onp.int32)
    act = onp.zeros(4, bool)
    for s, p in prompts.items():
        toks[s], pos[s], act[s] = first[s], len(p), True
    for _ in range(2):
        a = je.decode_step(toks, pos, act)
        b = te.decode_step(toks, pos, act)
        onp.testing.assert_array_equal(b, a)
        _pools_close(je.cache.pool, te.cache.pool)
        toks, pos = onp.where(act, b, 0).astype(onp.int32), pos + act
    assert te.compiles == je.compiles == 2
    assert te.stats()["executables"] == je.stats()["executables"]


def test_spec_step_matches_reference(jax_models, models):
    je = JaxEngine(jax_models[0], draft_model=jax_models[1], spec_k=3,
                   **GEOM)
    te = DecodeEngine(models[0], draft_model=models[1], spec_k=3, **GEOM)
    prompts = {1: _prompts(1, 9, 9, seed=5)[0],
               3: _prompts(1, 4, 4, seed=6)[0]}
    first = _prefill_both(je, te, prompts)
    toks = onp.zeros(4, onp.int32)
    pos = onp.zeros(4, onp.int32)
    act = onp.zeros(4, bool)
    for s, p in prompts.items():
        toks[s], pos[s], act[s] = first[s], len(p), True
    ga, aa = je.spec_step(toks, pos, act)
    gb, ab = te.spec_step(toks, pos, act)
    onp.testing.assert_array_equal(gb[act], ga[act])
    onp.testing.assert_array_equal(ab[act], aa[act])
    _pools_close(je.cache.pool, te.cache.pool)
    _pools_close(je.draft_cache.pool, te.draft_cache.pool)
    assert te.stats()["executables"] == je.stats()["executables"] == [
        "draft", "draft_prefill_b8", "prefill_b8", "verify"]


# -- scheduler against the reference scheduler ------------------------------

REQUESTS = [(p, n) for p, n in zip(_prompts(5, lo=3, hi=20, seed=2),
                                   (10, 4, 10, 7, 1))]


def _generate(sch, requests, eos_request):
    futs = [sch.submit(p, max_new_tokens=n) for p, n in requests]
    _run(sch)
    plain = [f.result(0) for f in futs]
    p, n, eos = eos_request(plain)
    fut = sch.submit(p, max_new_tokens=n, eos=eos)
    _run(sch)
    return plain, fut.result(0)


def _eos_request(plain):
    """An eos that cuts the first request mid-stream."""
    return REQUESTS[0][0], REQUESTS[0][1], plain[0][3]


@pytest.fixture(scope="module")
def jax_generations(jax_models):
    sch = JaxScheduler(JaxEngine(jax_models[0], **GEOM), start=False)
    out = _generate(sch, REQUESTS, _eos_request)
    sch.close(drain=True)
    return out


def test_scheduler_matches_reference_scheduler(models, jax_generations):
    eng = DecodeEngine(models[0], **GEOM)
    sch = DecodeScheduler(eng, start=False)
    plain, with_eos = _generate(sch, REQUESTS, _eos_request)
    sch.close(drain=True)
    assert plain == jax_generations[0]
    assert with_eos == jax_generations[1]
    assert with_eos[-1] == plain[0][3] and len(with_eos) <= REQUESTS[0][1]
    assert [len(g) for g in plain] == [n for _, n in REQUESTS]
    assert eng.cache.pages_used() == 0


def test_scheduler_matches_dense_reference(models):
    prompts = _prompts(3, seed=9)
    sch = DecodeScheduler(DecodeEngine(models[0], **GEOM), start=False)
    futs = [sch.submit(p, max_new_tokens=6) for p in prompts]
    _run(sch)
    assert [f.result(0) for f in futs] == [
        models[0].greedy_reference(p, 6) for p in prompts]


def test_warm_admissions_never_recompile(models, jax_generations):
    """After a first wave, a second wave with staggered admissions
    (requests joining mid-flight) adds no exec key."""
    eng = DecodeEngine(models[0], **GEOM)
    sch = DecodeScheduler(eng, start=False)
    futs = [sch.submit(p, max_new_tokens=n) for p, n in REQUESTS]
    _run(sch)
    warm = eng.compiles
    assert warm > 0 and eng.cache.pages_used() == 0
    futs = [sch.submit(*REQUESTS[0])]
    sch.step()                          # admit + begin while others queue
    futs += [sch.submit(p, max_new_tokens=n) for p, n in REQUESTS[1:]]
    _run(sch)
    assert [f.result(0) for f in futs] == jax_generations[0]
    assert eng.compiles == warm
    assert eng.cache.pages_used() == 0
    sch.close(drain=True)


def test_speculative_scheduler_is_token_identical(models, jax_generations):
    """A draft of another architecture and seed proposes; every emitted
    token is still the target's, so the output equals the reference's
    plain generation."""
    eng = DecodeEngine(models[0], draft_model=models[1], spec_k=3,
                       **dict(GEOM, num_pages=64))
    sch = DecodeScheduler(eng, start=False)
    futs = [sch.submit(p, max_new_tokens=n) for p, n in REQUESTS]
    _run(sch)
    st = sch.stats()
    assert [f.result(0) for f in futs] == jax_generations[0]
    assert 0 < st["spec_proposed"] and st["spec_accepted"] <= \
        st["spec_proposed"]
    assert eng.cache.pages_used() == 0
    assert eng.draft_cache.pages_used() == 0


# -- lifecycle and admission -------------------------------------------------

def test_close_no_drain_fails_pending_and_frees_pages(models):
    eng = DecodeEngine(models[0], **GEOM)
    sch = DecodeScheduler(eng, start=False)
    futs = [sch.submit(p, max_new_tokens=8) for p in _prompts(6, seed=10)]
    sch.step()                          # some admitted, some queued
    assert eng.cache.pages_used() > 0
    sch.close(drain=False)
    for f in futs:
        with pytest.raises(ServingClosedError):
            f.result(0)
    assert eng.cache.pages_used() == 0
    with pytest.raises(ServingClosedError):
        sch.submit([1, 2])


def test_queued_deadline_expires(models):
    sch = DecodeScheduler(DecodeEngine(models[0], **GEOM), start=False)
    t0 = telemetry.counter("serving.timeouts").value
    fut = sch.submit([1, 2, 3], max_new_tokens=4, timeout_ms=1.0)
    time.sleep(0.02)
    sch.step()
    with pytest.raises(RequestTimeoutError):
        fut.result(0)
    assert telemetry.counter("serving.timeouts").value == t0 + 1
    sch.close(drain=False)


def test_submit_reject_matrix(models):
    eng = DecodeEngine(models[0], **GEOM)
    sch = DecodeScheduler(eng, queue_depth=1, start=False)
    r0 = telemetry.counter("serving.rejected.shape").value
    for bad in ([], [1, VOCAB], [-1, 2]):
        with pytest.raises(BadRequestError):
            sch.submit(bad)
    with pytest.raises(BadRequestError):
        sch.submit([1, 2], max_new_tokens=0)
    with pytest.raises(BadRequestError):  # budget exceeds slot capacity
        sch.submit([1, 2], max_new_tokens=eng.slot_capacity + 1)
    assert telemetry.counter("serving.rejected.shape").value == r0 + 5
    sch.submit([1, 2, 3], max_new_tokens=2)
    with pytest.raises(QueueFullError):
        sch.submit([1, 2, 3], max_new_tokens=2)
    sch.close(drain=False)


def test_step_records_reach_a_sink(models):
    records = []

    class Sink:
        def emit(self, record):
            records.append(record)

    sink = Sink()
    telemetry.add_sink(sink)
    try:
        sch = DecodeScheduler(DecodeEngine(models[0], **GEOM), start=False)
        sch.submit([1, 2, 3], max_new_tokens=3)
        _run(sch)
    finally:
        telemetry.remove_sink(sink)
    assert records and all(r["source"] == "serving.DecodeScheduler"
                           for r in records)
    assert sum(r["decode"]["tokens"] for r in records) == 3
    assert sum(r["compiles"] for r in records) == 2   # prefill_b8, decode


# -- server ----------------------------------------------------------------

def _server(decoder=None):
    """A server as the reference's decode tests build one
    (``tests/test_decode.py:342-350``): a small block for ``/predict``
    beside the decoder for ``/generate``."""
    from mxnet_tpu_torch.gluon import nn
    net = nn.Sequential()
    net.add(nn.Dense(4, in_units=8))
    net.initialize(device="cpu")
    return ServingServer(net, engine_args={"example_shape": (8,),
                                           "dtype": "float32"},
                         decoder=decoder)


def test_server_generate_inprocess(models):
    from mxnet_tpu_torch import tracing
    srv = _server()
    with pytest.raises(ServingClosedError):    # no decoder attached
        srv.generate([1, 2, 3])
    sch = DecodeScheduler(DecodeEngine(models[0], **GEOM), start=True)
    srv.attach_decoder(sch)
    p = _prompts(1, seed=13)[0]
    tracing.enable()                    # the slow ring records while on
    slo.clear_ring()
    try:
        assert srv.generate(p, max_new_tokens=5) == \
            models[0].greedy_reference(p, 5)
        entry, = slo.requestz()["slowest"]
    finally:
        tracing._env_default()
        slo.clear_ring()
    assert entry["ok"] and entry["kind"] == "generate"
    assert entry["ttft_ms"] <= entry["latency_ms"]
    assert srv.healthz()["status"] == "serving"
    srv.stop(drain=True)                # stops the batcher and the decoder
    assert sch.closed
    with pytest.raises(ServingClosedError):
        srv.generate(p)


def test_server_generate_http(models):
    srv = _server(decoder=DecodeScheduler(
        DecodeEngine(models[0], **GEOM), start=True))
    host, port = srv.start_http()
    base = f"http://{host}:{port}"

    def post(path, body):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    try:
        p = _prompts(1, seed=14)[0]
        assert post("/generate", {"prompt": p, "max_new_tokens": 4}) == \
            {"tokens": models[0].greedy_reference(p, 4)}
        # /predict now serves the block: a request of the wrong shape is
        # an admission reject
        for path, body, code in (("/generate", {"prompt": []}, 400),
                                 ("/generate", {"oops": 1}, 400),
                                 ("/predict", {"data": [1.0]}, 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(path, body)
            assert ei.value.code == code
        with urllib.request.urlopen(base + "/healthz", timeout=30) as resp:
            assert json.loads(resp.read())["ready"] is True
    finally:
        srv.stop(drain=True)
