"""The decode engine's executables (one per exec key) and its
static-shape cores, against the reference's, on the CPU at a small width
(vocab 48, dim 64, 4 heads, 2 layers, 4 slots, page size 8).

Weights come from one numpy seed in both packages (carried across by
``convert.decode_params_from_numpy``); KV pools and page tables are made
with numpy and handed to both.  The reference's cores run under
``jax.jit`` with their Pallas kernels in interpret mode; the port's on
CPU tensors take the kernels' plain versions, and its executables run
the cores on their static inputs with no capture (a CUDA graph needs the
card; ``chip_smoke.py`` holds the replays bitwise against these cores
there).  Tokens must match exactly and the pools' live pages at 1e-6
(fp32: the same sums in another order)."""
from functools import partial

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx  # noqa: F401
from mxnet_tpu.serving.decode import DecodeEngine as JaxEngine
from mxnet_tpu.serving.decode import DecodeModel as JaxModel
from mxnet_tpu.serving.decode import DecodeScheduler as JaxScheduler
from mxnet_tpu.serving.decode import engine as ref

from mxnet_tpu_torch import convert, kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.serving import (DecodeEngine, DecodeModel,
                                     DecodeScheduler, ServingServer)
from mxnet_tpu_torch.serving.decode import engine as port
from mxnet_tpu_torch.serving.decode.exec import Executable
from mxnet_tpu_torch.serving.decode.paged_kv import PagedKVCache

VOCAB, SLOTS, PS, PPS, NUM_PAGES = 48, 4, 8, 6, 24
GEOM = dict(max_slots=SLOTS, num_pages=NUM_PAGES, page_size=PS,
            pages_per_slot=PPS, prefill_chunk=16, prefill_floor=4)
TARGET = dict(dim=64, n_heads=4, n_layers=2, seed=0)
DRAFT = dict(dim=32, n_heads=2, n_layers=1, seed=7)
POOL_TOL = dict(rtol=1e-6, atol=1e-6)


def _pair(kw):
    jm = JaxModel(VOCAB, **kw)
    tm = DecodeModel(VOCAB, device="cpu", **kw)
    tm.params = convert.decode_params_from_numpy(
        jax.tree.map(onp.asarray, jm.params), "cpu")
    return jm, tm


@pytest.fixture(scope="module")
def target():
    return _pair(TARGET)


@pytest.fixture(scope="module")
def draft():
    return _pair(DRAFT)


def _pools(mdl, seed):
    """One random pool in the reference's layout and the port's buffer
    (the same live pages, then a zero drop page)."""
    shape = (mdl.n_layers, 2, NUM_PAGES, PS, mdl.n_heads, mdl.head_dim)
    live = onp.random.RandomState(seed).randn(*shape).astype(onp.float32)
    buf = torch.zeros(shape[:2] + (NUM_PAGES + 1,) + shape[3:])
    buf[:, :, :NUM_PAGES] = torch.from_numpy(live)
    return jnp.asarray(live), buf


def _assert_pools(jpool, buf):
    onp.testing.assert_allclose(buf[:, :, :NUM_PAGES].numpy(),
                                onp.asarray(jpool), **POOL_TOL)


def _slot_grid():
    """Tables for 4 slots: slots 0 and 2 live on distinct pages, slot 1
    masked with a zero row, slot 3 masked with a position far past its
    table (clamped before the gather)."""
    perm = onp.random.RandomState(3).permutation(NUM_PAGES)
    tables = onp.zeros((SLOTS, PPS), onp.int32)
    tables[0], tables[2] = perm[:PPS], perm[PPS:2 * PPS]
    tables[3] = perm[2 * PPS:3 * PPS]
    tokens = onp.asarray([5, 17, 40, 2], onp.int32)
    positions = onp.asarray([13, 0, 30, 10_000], onp.int32)
    active = onp.asarray([True, False, True, False])
    assert tables.max() < NUM_PAGES     # the drop page is named by no table
    return tokens, positions, tables, active


def _t(*arrays):
    return [torch.from_numpy(onp.ascontiguousarray(a)) for a in arrays]


def test_decode_core_matches_reference_with_masked_slots(target):
    jm, tm = target
    tokens, positions, tables, active = _slot_grid()
    jpool, buf = _pools(tm, seed=11)
    jpool, want = jax.jit(partial(ref._decode_core, jm))(
        jm.params, jpool, tokens, positions, tables, active)
    got = port._decode_core(tm, tm.params, buf, *_t(tokens, positions,
                                                      tables, active))
    onp.testing.assert_array_equal(got.numpy(), onp.asarray(want))
    _assert_pools(jpool, buf)


def test_verify_and_draft_cores_match_reference(target, draft):
    (jm, tm), (jd, td) = target, draft
    tokens, positions, tables, active = _slot_grid()
    positions[2] = 40                   # the window reaches the last page
    k = 3
    jdpool, dbuf = _pools(td, seed=12)
    jdpool, jprops = jax.jit(partial(ref._draft_core, jd, k=k))(
        jd.params, jdpool, tokens, positions, tables, active)
    window = torch.zeros((SLOTS, k + 1), dtype=torch.int32)
    port._draft_window(window, k, td, td.params, dbuf,
                       *_t(tokens, positions, tables, active))
    onp.testing.assert_array_equal(window[:, 1:].numpy(),
                                   onp.asarray(jprops))
    onp.testing.assert_array_equal(window[:, 0].numpy(), tokens)
    _assert_pools(jdpool, dbuf)
    jpool, buf = _pools(tm, seed=13)
    jpool, jgreedy, jacc = jax.jit(partial(ref._verify_core, jm))(
        jm.params, jpool, jnp.asarray(window.numpy()), positions, tables,
        active)
    greedy, acc = port._verify_core(tm, tm.params, buf, window,
                                    *_t(positions, tables, active))
    onp.testing.assert_array_equal(greedy.numpy(), onp.asarray(jgreedy))
    onp.testing.assert_array_equal(acc.numpy(), onp.asarray(jacc))
    _assert_pools(jpool, buf)


def test_prefill_core_device_scalars_serve_every_chunk_of_a_bucket(target):
    """One bucket (16) serves chunks at several (start, length) pairs
    through the SAME 0-d start/length tensors (as one executable's static
    inputs), the last with padded rows past the slot's table."""
    jm, tm = target
    table = onp.random.RandomState(5).permutation(NUM_PAGES)[:PPS] \
        .astype(onp.int32)
    prompt = onp.random.RandomState(6).randint(0, VOCAB, size=48)
    jpool, buf = _pools(tm, seed=14)
    ref_core = jax.jit(partial(ref._prefill_core, jm))
    start_t = torch.zeros((), dtype=torch.int32)
    len_t = torch.zeros((), dtype=torch.int32)
    tokens_t = torch.zeros((16,), dtype=torch.int32)
    table_t = torch.from_numpy(table)
    for start, n in ((0, 16), (16, 5), (21, 9), (30, 1), (40, 8)):
        padded = onp.zeros((16,), onp.int32)
        padded[:n] = prompt[start:start + n]
        jpool, want = ref_core(jm.params, jpool, padded, jnp.int32(start),
                               jnp.int32(n), table)
        tokens_t.copy_(torch.from_numpy(padded))
        start_t.fill_(start)
        len_t.fill_(n)
        got = port._prefill_core(tm, tm.params, buf, tokens_t, start_t,
                                 len_t, table_t)
        assert int(got) == int(want), (start, n)
        _assert_pools(jpool, buf)


@pytest.mark.parametrize("spec", ["plain", "draft_no_spec", "spec"])
def test_warmup_keys_match_reference(target, draft, spec):
    (jm, tm), (jd, td) = target, draft
    kw = {"plain": {},
          "draft_no_spec": {"spec_k": 0},
          "spec": {"spec_k": 2}}[spec]
    je = JaxEngine(jm, draft_model=None if spec == "plain" else jd,
                   **kw, **GEOM)
    te = DecodeEngine(tm, draft_model=None if spec == "plain" else td,
                      **kw, **GEOM)
    lengths = (1, 5, 9, 16, 30)
    keys = te.warmup(lengths)
    assert keys == je.warmup(lengths)
    assert te.stats()["executables"] == sorted(keys)
    assert te.compiles == len(keys) == je.compiles
    assert te.warmup(lengths) == keys and te.compiles == len(keys)


REQUESTS = [([int(t) for t in onp.random.RandomState(s).randint(
    0, VOCAB, size=n)], m) for s, n, m in ((21, 3, 6), (22, 20, 4),
                                          (23, 9, 8), (24, 33, 3))]


@pytest.fixture(scope="module")
def jax_generations(target):
    sch = JaxScheduler(JaxEngine(target[0], **GEOM), start=False)
    futs = [sch.submit(p, max_new_tokens=m) for p, m in REQUESTS]
    while sch._has_work():
        sch.step()
    sch.close(drain=True)
    return [f.result(0) for f in futs]


@pytest.mark.parametrize("spec", [False, True])
def test_cpu_engine_through_static_buffers_generates_reference_tokens(
        target, draft, jax_generations, spec):
    """After warmup, a scheduler over a CPU engine serves every request
    through the executables' static inputs (never reallocated), captures
    nothing more, and generates the reference scheduler's tokens."""
    eng = DecodeEngine(target[1], draft_model=draft[1] if spec else None,
                       spec_k=2, **GEOM)
    srv = ServingServer(decoder=DecodeScheduler(eng, start=False))
    keys = srv.warmup((1, 5, 9, 16))
    inputs = {k: [t.data_ptr() for t in eng._exec[k].inputs] for k in keys}
    sch = srv.decoder
    futs = [sch.submit(p, max_new_tokens=m) for p, m in REQUESTS]
    while sch._has_work():
        sch.step()
    assert [f.result(0) for f in futs] == jax_generations
    assert eng.compiles == len(keys) and sorted(keys) == \
        eng.stats()["executables"]
    assert inputs == {k: [t.data_ptr() for t in eng._exec[k].inputs]
                      for k in keys}
    assert eng.cache.pages_used() == 0
    srv.stop()


def test_executable_stages_inputs_in_one_aligned_buffer():
    args = (onp.arange(3, dtype=onp.int32), onp.asarray([1, 0, 1, 1, 0],
                                                       bool),
            onp.int32(7), onp.arange(8, dtype=onp.int32).reshape(2, 4))
    seen = []

    def fn(a, m, s, t):
        seen.append((a, m, s, t))
        return a.sum() + s + t[m[:2].long()].sum()

    ex = Executable(fn, args, torch.device("cpu"))
    assert ex.graph is None
    a, m, s, t = ex.inputs
    assert (a.dtype, m.dtype, s.dtype, t.dtype) == (
        torch.int32, torch.bool, torch.int32, torch.int32)
    assert (tuple(m.shape), tuple(s.shape), tuple(t.shape)) == \
        ((5,), (), (2, 4))
    base = a.data_ptr()
    assert all((x.data_ptr() - base) % 16 == 0 for x in ex.inputs)
    assert int(ex(*args)) == 3 + 7 + (4 + 5 + 6 + 7) + (0 + 1 + 2 + 3)
    assert all(x is y for x, y in zip(seen[0], ex.inputs))
    assert int(ex.eager()) == int(ex(*args))     # the staged inputs
    assert int(ex.eager(*args[:2], onp.int32(0), args[3])) == 3 + 22 + 6


def test_paged_cache_keeps_a_drop_page_past_the_pool():
    c = PagedKVCache(layers=2, num_pages=6, page_size=4, max_slots=2,
                     pages_per_slot=3, heads=2, head_dim=8, device="cpu")
    assert tuple(c.buffer.shape) == (2, 2, 7, 4, 2, 8)
    assert tuple(c.pool.shape) == (2, 2, 6, 4, 2, 8)
    assert c.pool.data_ptr() == c.buffer.data_ptr()
    assert c.pool[1, 0].is_contiguous()
    c.acquire(0, 12)
    c.acquire(1, 12)
    assert c.pages_used() == 6 and c.tables.max() < 6


def test_resolve_raises_when_it_would_tune_under_capture(monkeypatch):
    monkeypatch.delenv("MXNET_KERNEL_CACHE_DIR", raising=False)
    registry._topology()
    spec = kernels.get_kernel("rope")
    case = {"r": 8, "h": 8, "d": 64, "device": "cpu"}
    tune_args = spec.make_args(case)
    sig, dt = spec.signature(*tune_args[0])
    kernels.invalidate("rope")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(MXNetError, match="warm-up"):
        kernels.resolve("rope", sig, dt, tune_args=tune_args,
                        allow_tune=True)
    # no tune wanted: the default config, even while capturing
    assert kernels.resolve("rope", sig, dt, tune_args=tune_args,
                           allow_tune=False) == spec.default_config
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    assert not registry._capturing()
    kernels.invalidate("rope")
