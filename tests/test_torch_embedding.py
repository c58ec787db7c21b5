"""The sharded embedding tables (``mxnet_tpu_torch/embedding/``) against
the reference's (``mxnet_tpu/embedding/``) on the same seeds and the
same traffic, on the CPU: each package's tables on its own in-process
parameter servers.

Held bitwise: the fresh tables under ``mod`` and ``range`` at 1–3
shards, the pulled blocks, the tables after accumulating and 2-bit
compressed pushes (the servers run numpy), checkpoints restored across
the packages at another shard count, and the ``embedding.*`` counters
and ``comm.sparse.bytes``.  With a server-side optimizer (lazy SGD with
momentum) the tables are held at rtol 1e-6.  The serving lookup tier is
driven through ``InferenceEngine.attach_embedding``."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import embedding as jemb
from mxnet_tpu.kvstore.gradient_compression import GradientCompression \
    as JGC

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import embedding as emb
from mxnet_tpu_torch import telemetry as tel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.embedding.cache import cache_rows_env
from mxnet_tpu_torch.embedding.sharded import _Partition, _default_init
from mxnet_tpu_torch.kvstore.gradient_compression import GradientCompression

COUNTERS = ("embedding.rows_pulled", "embedding.rows_pushed",
            "embedding.sparse_bytes", "embedding.dense_equiv_bytes",
            "embedding.cache_hits", "embedding.cache_misses",
            "embedding.cache_evictions", "embedding.rows_spilled",
            "comm.sparse.bytes")


@pytest.fixture(autouse=True)
def _host():
    with mt.cpu():
        yield


def _counts(t):
    return {n: t.counter(n).value for n in COUNTERS}


@pytest.mark.parametrize("kind", ["mod", "range"])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_tables_and_routing_are_the_references(kind, shards):
    from mxnet_tpu.embedding.sharded import _Partition as JPart
    part, jpart = _Partition(kind, 11, shards), JPart(kind, 11, shards)
    rows = onp.arange(11)
    onp.testing.assert_array_equal(part.shard_of(rows), jpart.shard_of(rows))
    onp.testing.assert_array_equal(part.local_of(rows), jpart.local_of(rows))
    assert part.spec() == jpart.spec()
    with emb.ShardedEmbedding("t", 37, 6, num_shards=shards, seed=5,
                              partition=kind) as a, \
            jemb.ShardedEmbedding("t", 37, 6, num_shards=shards, seed=5,
                                  partition=kind) as b:
        assert a.dump().tobytes() == b.dump().tobytes()
    full = _default_init(onp.arange(16), 4, seed=3, dtype=onp.float32)
    assert _default_init(onp.array([5, 2, 11]), 4, seed=3,
                         dtype=onp.float32).tobytes() == \
        full[[5, 2, 11]].tobytes()


def test_partition_and_constructor_errors():
    with pytest.raises(MXNetError):
        _Partition("hash", 8, 2)
    with pytest.raises(MXNetError):
        _Partition("mod", 0, 2)
    with pytest.raises(MXNetError):
        emb.ShardedEmbedding("bad", 8, 4, num_shards=1, partition="hash")
    with emb.ShardedEmbedding("v", 8, 2, num_shards=1) as t:
        with pytest.raises(MXNetError, match="out of range"):
            t.pull_rows([8])
        with pytest.raises(MXNetError, match="out of range"):
            t.push_grad([-1], onp.ones((1, 2), "float32"))


def _traffic(pkg, mod, kind, compression=None, optimizer=None, hot=0):
    """Pull, push (duplicate ids), pull again; the pulled blocks, the
    table, and the counters' movement."""
    rng = onp.random.RandomState(9)
    ids = [rng.randint(0, 40, size=12) for _ in range(3)]
    grads = [rng.randn(12, 5).astype("float32") for _ in range(3)]
    t = pkg.telemetry
    before = _counts(t)
    with mod.ShardedEmbedding("tr", 40, 5, num_shards=2, seed=2,
                              partition=kind, compression=compression,
                              hot_rows=hot) as table:
        if optimizer is not None:
            table.set_optimizer(optimizer)
        pulled = []
        for i, g in zip(ids, grads):
            pulled.append(table.pull_rows(i))
            table.push_grad(i, g)
            pulled.append(table.pull_rows(i[:4]))
        dump = table.dump()
    after = _counts(t)
    return pulled, dump, {n: after[n] - before[n] for n in COUNTERS}


@pytest.mark.parametrize("kind", ["mod", "range"])
@pytest.mark.parametrize("mode", ["accumulate", "compressed", "hot"])
def test_pull_and_push_match_the_reference(kind, mode):
    comp = {"compressed": (GradientCompression(threshold=0.5),
                           JGC(threshold=0.5))}.get(mode, (None, None))
    hot = 6 if mode == "hot" else 0
    got = _traffic(mt, emb, kind, compression=comp[0], hot=hot)
    want = _traffic(mx, jemb, kind, compression=comp[1], hot=hot)
    for a, b in zip(got[0], want[0]):
        assert a.tobytes() == b.tobytes()
    assert got[1].tobytes() == want[1].tobytes()
    assert got[2] == want[2], (got[2], want[2])
    assert got[2]["embedding.rows_pushed"] > 0
    if mode == "hot":
        assert got[2]["embedding.cache_hits"] > 0
        assert got[2]["embedding.rows_spilled"] > 0


def test_server_side_lazy_optimizer_matches_the_reference():
    kw = {"learning_rate": 0.5, "momentum": 0.875}
    got = _traffic(mt, emb, "mod", optimizer=mt.optimizer.SGD(**kw))
    want = _traffic(mx, jemb, "mod", optimizer=mx.optimizer.SGD(**kw))
    onp.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
    assert got[2] == want[2]


def test_compressed_push_keeps_a_residual_a_row():
    with emb.ShardedEmbedding("cmp", 8, 4, num_shards=2,
                              compression=GradientCompression(
                                  threshold=0.5)) as t:
        ref = t.dump().copy()
        ids = onp.array([1, 6])
        grads = onp.full((2, 4), 0.7, onp.float32)
        t.push_grad(ids, grads)          # +0.5, residual 0.2
        step1 = ref[ids] + onp.float32(0.5)
        assert t.dump()[ids].tobytes() == step1.tobytes()
        t.push_grad(ids, grads)          # 0.9 -> +0.5, residual 0.4
        assert t.dump()[ids].tobytes() == \
            (step1 + onp.float32(0.5)).tobytes()
        others = [r for r in range(8) if r not in (1, 6)]
        assert t.dump()[others].tobytes() == ref[others].tobytes()


def test_pulled_rows_land_on_the_callers_device():
    with emb.ShardedEmbedding("dev", 16, 3, num_shards=2) as t:
        ids = torch.tensor([3, 9, 3])
        block = t.pull_rows(ids, device="cpu")
        assert isinstance(block, torch.Tensor) and block.shape == (3, 3)
        assert block.numpy().tobytes() == t.dump()[[3, 9, 3]].tobytes()
        # a torch gradient (the sparse Embedding's rows) pushes as numpy
        t.push_grad(torch.tensor([3]), torch.ones(1, 3))
        assert t.dump()[3].tolist() == (block[0] + 1).tolist()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoints_restore_across_packages_and_shard_counts(tmp_path,
                                                              direction):
    """A table saved at 2 shards restores bitwise at 3 in the other
    package (the partition spec travels in the checkpoint's header)."""
    src, dst = (jemb, emb) if direction == "ref_to_port" else (emb, jemb)
    with src.ShardedEmbedding("ck", 23, 4, num_shards=2, seed=1,
                              partition="range") as a:
        a.push_grad(onp.array([0, 22, 5]), onp.ones((3, 4), "float32"))
        table = a.dump()
        a.save_checkpoint(str(tmp_path), block=True)
    with dst.ShardedEmbedding("ck", 23, 4, num_shards=3, seed=4,
                              partition="mod") as b:
        assert b.dump().tobytes() != table.tobytes()
        b.load_checkpoint(str(tmp_path))
        assert b.dump().tobytes() == table.tobytes()
    with emb.ShardedEmbedding("other", 23, 4, num_shards=1) as c:
        with pytest.raises(MXNetError, match="no matching embedding"):
            c.load_checkpoint(str(tmp_path))
    with emb.ShardedEmbedding("ck", 24, 4, num_shards=1) as c:
        with pytest.raises(MXNetError, match="checkpoint table is"):
            c.load_checkpoint(str(tmp_path))


def test_lookup_cache_through_the_inference_engine():
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.serving import InferenceEngine
    from mxnet_tpu_torch.serving.engine import BadRequestError
    net = nn.Dense(2, in_units=4)
    net.initialize(device="cpu")
    hits = tel.counter("embedding.cache_hits").value
    with emb.ShardedEmbedding("eng", 12, 4, num_shards=2, seed=4) as t:
        cache = emb.EmbeddingLookupCache(t, capacity=8)
        eng = InferenceEngine(net, example_shape=(4,), dtype="float32")
        eng.attach_embedding(cache)
        table = t.dump()
        got = eng.infer(onp.array(7, onp.int64))
        want = net(mt.nd.array(table[7][None])).asnumpy()[0]
        onp.testing.assert_allclose(got, want, rtol=1e-6)
        eng.infer(onp.array(7, onp.int64))        # a repeated user
        st = eng.stats()["embedding"]
        assert st["hits"] >= 1 and st["misses"] >= 1
        assert tel.counter("embedding.cache_hits").value - hits >= 1
        onp.testing.assert_allclose(eng.infer(table[7]), want, rtol=1e-6)
        with pytest.raises(BadRequestError):
            eng.validate(onp.array(99, onp.int64))


def test_lookup_cache_matches_the_reference():
    outs, stats = [], []
    for mod in (emb, jemb):
        with mod.ShardedEmbedding("srv", 32, 3, num_shards=2) as t:
            cache = mod.EmbeddingLookupCache(t, capacity=2)
            seq = [cache.lookup(onp.array(i)) for i in
                   ([5, 5, 9], [5], [11], [], [11, 11])]
            cache.invalidate([5])
            seq.append(cache.lookup(onp.array([5])))
            outs.append(seq)
            stats.append(cache.stats())
    for a, b in zip(*outs):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    assert stats[0] == stats[1]


def test_env_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_EMB_SHARDS", "3")
    monkeypatch.setenv("MXNET_EMB_CACHE_ROWS", "17")
    assert emb.num_shards_env() == 3 and cache_rows_env() == 17
    monkeypatch.setenv("MXNET_EMB_SHARDS", "bogus")
    assert emb.num_shards_env() == 1
    with emb.ShardedEmbedding("envd", 10, 2) as t:
        assert t.num_shards == 1
