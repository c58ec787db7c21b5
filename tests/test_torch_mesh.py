"""Meshes and the meshed SPMDTrainer's dp and tp against the reference
(``mxnet_tpu/parallel/mesh.py``, ``mesh4d.py``, ``trainer.py``), on the
CPU.

The reference runs on the 8 emulated devices ``tests/conftest.py`` sets
up; the port on 8 spawned gloo ranks (``torch_dist_cases.RankPool``),
one pool for the file.  Both get the same numpy weights and batches.
Held, at fp32 rtol 1e-5 / atol 1e-6: the losses of 3 steps, every
parameter after them (gathered from the ranks) and the optimizer state
(gathered); the port's meshed run also against its own unmeshed
one-device run; the analytic collective bytes over dp and tp against the
reference's telemetry; ``make_mesh`` / ``MeshPlan``'s errors.  The cases
are the reference gate's (``__graft_entry__.dryrun_multichip``): dp2,
dp4×tp2 with the head sharded on tp, the transformer LM at dp2×tp2;
and dp2×tp4 with a column- then a row-parallel layer.  The sharded
cases load the reference's weights into the built trainer
(``convert.load_collected_params``: each rank keeps its shard).
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
from jax.sharding import PartitionSpec as JP
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JLM
from mxnet_tpu.parallel import MeshPlan as JPlan
from mxnet_tpu.parallel import SPMDTrainer as JTrainer
from mxnet_tpu.parallel import make_mesh as jmesh

import torch_dist_cases as cases
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.parallel import SPMDTrainer

WORLD = 8
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = cases.RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def dense_weights(seed=0):
    rng = onp.random.RandomState(seed)
    return {"0.weight": rng.randn(16, 8).astype("float32") * 0.3,
            "0.bias": rng.randn(16).astype("float32") * 0.1,
            "1.weight": rng.randn(4, 16).astype("float32") * 0.3,
            "1.bias": rng.randn(4).astype("float32") * 0.1}


def batches(n_rows, seed=1, steps=3):
    rng = onp.random.RandomState(seed)
    return [(rng.randn(n_rows, 8).astype("float32"),
             rng.randint(0, 4, n_rows).astype("float32"))
            for _ in range(steps)]


def jax_dense(weights, specs=None):
    net = jnn.HybridSequential()
    net.add(jnn.Dense(16, in_units=8, activation="relu"),
            jnn.Dense(4, in_units=16))
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(weights[k]))
        if specs and k in specs:
            p.shard(JP(*specs[k]))
    return net


def jax_train(tr, data):
    losses = [float(tr.step(d, l).asnumpy()) for d, l in data]
    params = {k: p.data().asnumpy() for k, p in tr._params.items()}
    states = {k: [onp.asarray(a) for a in tr._opt_state[k]]
              for k in tr._pkeys}
    return losses, params, states


def assert_same(got, want):
    g_loss, g_params, g_states = got[:3]
    w_loss, w_params, w_states = want[:3]
    onp.testing.assert_allclose(g_loss, w_loss, **TOL)
    assert sorted(g_params) == sorted(w_params)
    for k in w_params:
        onp.testing.assert_allclose(g_params[k], w_params[k], **TOL,
                                    err_msg=k)
        for a, b in zip(g_states[k], w_states[k]):
            onp.testing.assert_allclose(a, b, **TOL, err_msg=k)


def test_make_mesh_errors_match_the_reference(pool):
    got = pool.run("case_mesh_errors", WORLD)
    msgs, shape, member = got[0]
    want = []
    for fn in (lambda: jmesh({"dp": 2 * WORLD}),
               lambda: jmesh({"dp": WORLD, "tp": 2}),
               lambda: JPlan(dp=0), lambda: JPlan(tp=-1)):
        with pytest.raises(Exception) as e:
            fn()
        want.append(str(e.value))
    assert msgs == want
    assert shape == dict(jmesh({"dp": 2, "tp": -1}).shape)
    assert all(r[2] for r in got)       # every rank is on the mesh


DENSE_CASES = {
    "dp2": ({"dp": 2}, None),
    "dp4xtp2": ({"dp": 4, "tp": 2},
                {"1.weight": ("tp", None), "1.bias": ("tp",)}),
    "dp2xtp4_row": ({"dp": 2, "tp": 4},
                    {"0.weight": ("tp", None), "1.weight": (None, "tp")}),
}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_spmd_dense_matches_the_reference(pool, name):
    """SGD with momentum over a Dense net: dp alone, and dp×tp with the
    head sharded on tp (the reference gate's dp4×tp2 section)."""
    axes, specs = DENSE_CASES[name]
    w = dense_weights()
    data = batches(8)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jtel.reset("comm.")
    jtr = JTrainer(jax_dense(w, specs), jloss.SoftmaxCrossEntropyLoss(),
                   optimizer="sgd", optimizer_params=opt, mesh=jmesh(axes))
    want = jax_train(jtr, data)
    want_comm = {k: jtel.counter(f"comm.{k}.bytes").value
                 for k in ("dp", "tp", "reduce_scatter", "all_gather",
                           "allreduce")}
    # the sharded cases load the reference's weights into the built
    # trainer (convert.load_collected_params: each rank its shard)
    got = pool.run("case_spmd_dense", w, specs, axes, "sgd", opt, data, 0,
                   specs is not None)
    members = [r for r in got if r is not None]
    assert len(members) == axes["dp"] * axes.get("tp", 1)
    for r in members:
        assert_same(r, want)
        assert r[4] == want_comm
    # the port's own one-device run
    one = SPMDTrainer(cases.dense_net(w), gloss.SoftmaxCrossEntropyLoss(),
                      optimizer="sgd", optimizer_params=opt, device="cpu")
    onp.testing.assert_allclose(
        members[0][0], [float(one.step(d, l).asnumpy()) for d, l in data],
        **TOL)


LM = dict(vocab=32, units=16, layers=1, heads=2, max_len=16)


def lm_weights():
    """The reference LM's initial weights (Xavier, seeded), numpy."""
    mx.random.seed(0)
    lm = JLM(LM["vocab"], units=LM["units"], num_layers=LM["layers"],
             num_heads=LM["heads"], max_len=LM["max_len"], use_flash=False)
    lm.initialize(init=mx.initializer.Xavier())
    lm(mx.nd.array(onp.zeros((1, 8), onp.int32), dtype="int32"))
    return lm, {k: p.data().asnumpy() for k, p in
                lm.collect_params().items()}


def lm_loss(vocab):
    ce = jloss.SoftmaxCrossEntropyLoss()

    def f(logits, labels):
        return ce(logits.reshape((-1, vocab)), labels.reshape((-1,)))
    return f


def test_transformer_dp2xtp2_matches_the_reference(pool):
    """The reference gate's transformer section: the FFN and attention
    projections column / row sharded over tp, the batch over dp."""
    lm, w = lm_weights()
    specs = {}
    for k, p in lm.collect_params().items():
        if k.endswith("weight") and len(p.shape) == 2:
            if "ffn1" in k or "qkv" in k:
                specs[k] = ("tp", None)
            elif "ffn2" in k or "out_proj" in k:
                specs[k] = (None, "tp")
    for k, s in specs.items():
        lm.collect_params()[k].shard(JP(*s))
    toks = onp.random.RandomState(4).randint(0, 32, (4, 9)).astype("int32")
    data = [(toks[:, :8], toks[:, 1:].astype("float32"))] * 3
    opt = {"learning_rate": 0.1}
    jtr = JTrainer(lm, lm_loss(LM["vocab"]), optimizer="sgd",
                   optimizer_params=opt, mesh=jmesh({"dp": 2, "tp": 2}))
    want = jax_train(jtr, data)
    got = pool.run("case_spmd_lm", w, LM, specs, {"dp": 2, "tp": 2}, None,
                   "ring", data, opt)
    members = [r for r in got if r is not None]
    assert len(members) == 4
    for r in members:
        assert_same(r, want)


def test_parallel_names_match_the_reference():
    """``parallel.__all__`` is the reference's, and every name is the
    ported one: defined in the port's own module of the reference's
    name, none a stub that raises "not ported yet"."""
    import inspect
    import mxnet_tpu.parallel as jpar
    import mxnet_tpu_torch.parallel as par
    assert sorted(par.__all__) == sorted(jpar.__all__)
    for name in par.__all__:
        obj = getattr(par, name)
        assert callable(obj)
        want = getattr(jpar, name).__module__.replace("mxnet_tpu.",
                                                      "mxnet_tpu_torch.")
        assert obj.__module__ == want, (name, obj.__module__)
        assert "not ported yet" not in inspect.getsource(obj), name


def test_sharded_parameter_guards(pool):
    """A parameter the trainer holds as shards refuses reads while its
    full value is stale (after a step, or a ``set_full_value``) and
    reads again after ``gather_params``; ``set_data`` is refused while
    the trainer holds it (it would write a copy the trainer never
    reads), and ``set_full_value`` loads the whole value into the
    shards."""
    w = dense_weights()
    data = batches(8)
    got = [r for r in pool.run("case_shard_guards", w, data[:1])
           if r is not None]
    assert len(got) == 4
    for stale, set_stale, gathered, set_gathered, reset, regathered in got:
        assert stale.startswith("MXNetError") and "stale" in stale
        assert "held as shards" in set_stale
        assert "held as shards" in set_gathered
        assert reset.startswith("MXNetError") and "stale" in reset
        assert gathered.shape == w["1.weight"].shape
        assert not onp.array_equal(gathered, w["1.weight"])    # stepped
        onp.testing.assert_array_equal(regathered, w["1.weight"])
        onp.testing.assert_array_equal(gathered, got[0][2])
