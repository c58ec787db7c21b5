"""SPMDTrainer's parameter specs over every mesh axis, their checkpoints,
and Megatron's column→row pairing, against the reference on the CPU.

The reference shards a parameter by any ``PartitionSpec``
(``mxnet_tpu/parallel/trainer.py:153-216``); the port's rank holds its
box of the value, gathers it for the forward, and reduce-scatters the
gradient over an axis that splits the batch (dp) or keeps its slice over
any other (tp, ep).  The reference runs on the 8 emulated devices
``tests/conftest.py`` sets up, the port on 4 spawned gloo ranks
(``torch_dist_cases.RankPool``, one pool for the file), both on the same
numpy weights and batches.  Held at fp32 rtol 1e-5 / atol 1e-6: the
losses of 3 Adam steps, every parameter and optimizer state after them
(gathered), ``opt_state.bytes_per_device`` against the reference's, and
the master each rank holds (1/dp of the parameter under
``P("dp", None)``): ``P("dp", None)`` at ZeRO 0, 1 and 3
(``tests/test_zero_sharding.py:96-107``), ``P(("dp", "tp"), None)`` at
dp2×tp2, an expert-stacked weight ``P("ep")`` at dp2×ep2
(``tests/test_mesh4d.py:128``'s spec).  A save at dp4 restores at
dp2×tp2 under ZeRO 1 bitwise.  The paired column→row Dense matches the
reference and the unpaired net, and moves fewer bytes over tp by the
gathers of its hidden activation (``collectives.tally``).
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
from jax.sharding import PartitionSpec as JP
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.parameter import Parameter as JParameter
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import SPMDTrainer as JTrainer
from mxnet_tpu.parallel import make_mesh as jmesh

import torch_dist_cases as cases
from test_torch_mesh import TOL, assert_same, batches, dense_weights, \
    jax_dense, jax_train

WORLD = 4
ADAM = {"learning_rate": 0.05}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = cases.RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _ref(net, axes, zero, data):
    jtr = JTrainer(net, jloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                   optimizer_params=ADAM, mesh=jmesh(axes), zero_stage=zero)
    return jax_train(jtr, data), jtr.opt_state_bytes_per_device()


def _check(got, want, want_bytes, n, shapes):
    members = [r for r in got if r is not None]
    assert len(members) == n
    for r in members:
        assert_same(r, want)
        assert r[3] == want_bytes
        for k, shape in shapes.items():
            assert r[4][k] == shape, (k, r[4][k])


DENSE_CASES = {
    # tests/test_zero_sharding.py:96-107: a user's P("dp", None) under ZeRO
    "dp4_P(dp,None)_zero0": ({"dp": 4}, {"0.weight": ("dp", None)}, 0),
    "dp4_P(dp,None)_zero1": ({"dp": 4}, {"0.weight": ("dp", None)}, 1),
    "dp4_P(dp,None)_zero3": ({"dp": 4}, {"0.weight": ("dp", None)}, 3),
    "dp2xtp2_P((dp,tp),None)_zero0": ({"dp": 2, "tp": 2},
                                      {"0.weight": (("dp", "tp"), None)}, 0),
    "dp2xtp2_P((dp,tp),None)_zero1": ({"dp": 2, "tp": 2},
                                      {"0.weight": (("dp", "tp"), None),
                                       "1.weight": (None, "tp")}, 1),
}


@pytest.mark.parametrize("name", sorted(DENSE_CASES))
def test_dense_specs_over_dp_and_tuples_match_the_reference(pool, name):
    axes, specs, zero = DENSE_CASES[name]
    w = dense_weights(8)
    data = batches(8, seed=9)
    want, want_bytes = _ref(jax_dense(w, specs), axes, zero, data)
    got = pool.run("case_spec_train", "dense", w, specs, axes, ADAM, data,
                   zero)
    # the spec'd weight's master is this rank's 1/(dp·tp) of its rows
    n = axes["dp"] * axes.get("tp", 1)
    _check(got, want, want_bytes, n, {"0.weight": (16 // n, 8)})


E, H, F, C = (cases.EXPERT_DIMS[k] for k in ("experts", "hidden", "units",
                                             "classes"))


class _JExperts(JHybridBlock):
    def __init__(self):
        super().__init__()
        self.w = JParameter("w", shape=(E, H, F))

    def forward(self, x):
        return (x @ self.w.data().reshape((E * H, F))).relu()


def _expert_ref(specs):
    mx.random.seed(3)
    net = jnn.HybridSequential()
    net.add(_JExperts(), jnn.Dense(C, in_units=F))
    net.initialize(init=mx.initializer.Xavier())
    net(NDArray(onp.zeros((1, E * H), onp.float32)))
    w = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    for k, s in specs.items():
        net.collect_params()[k].shard(JP(*s))
    return net, w


@pytest.mark.parametrize("zero", [0, 1])
def test_expert_stacked_weight_over_ep_matches_the_reference(pool, zero):
    """``P("ep")`` on an (E, H, F) weight at dp2×ep2: the ep ranks see the
    same rows, so each keeps its slice of the gradient (a reduce-scatter
    there would double it)."""
    specs = {"0.w": ("ep",)}
    net, w = _expert_ref(specs)
    rng = onp.random.RandomState(10)
    data = [(rng.randn(8, E * H).astype("float32"),
             rng.randint(0, C, 8).astype("float32")) for _ in range(3)]
    axes = {"dp": 2, "ep": 2}
    want, want_bytes = _ref(net, axes, zero, data)
    got = pool.run("case_spec_train", "experts", w, specs, axes, ADAM, data,
                   zero)
    _check(got, want, want_bytes, 4, {"0.w": (E // 2, H, F)})


def test_a_save_at_dp4_restores_at_dp2xtp2_bitwise(pool, tmp_path):
    """P("dp", None) at dp4 saved by every rank's boxes, restored by a
    trainer at dp2×tp2 with P(("dp", "tp"), None), P(None, "tp") and
    ZeRO 1 chunks: parameters and Adam's state bitwise equal, gathered."""
    w = dense_weights(11)
    data = batches(8, seed=12, steps=2)
    got = pool.run("case_spec_resave", w, data, ADAM, str(tmp_path / "ck"))
    for saved_p, saved_s, back_p, back_s in got:
        assert sorted(saved_p) == sorted(back_p) == sorted(w)
        for k in w:
            onp.testing.assert_array_equal(back_p[k], saved_p[k])
            assert not onp.array_equal(saved_p[k], w[k])       # stepped
            for a, b in zip(back_s[k], saved_s[k]):
                onp.testing.assert_array_equal(a, b)
        onp.testing.assert_array_equal(saved_p["0.weight"],
                                       got[0][0]["0.weight"])


PAIR_CASES = {
    "sharded_column_bias": {"0.weight": ("tp", None), "0.bias": ("tp",),
                            "1.weight": (None, "tp")},
    "replicated_column_bias": {"0.weight": ("tp", None),
                               "1.weight": (None, "tp")},
}


@pytest.mark.parametrize("name", sorted(PAIR_CASES))
def test_megatron_pairing_matches_and_saves_the_gathers(pool, name):
    """Dense(16, relu) column parallel then Dense(4) row parallel at
    dp2×tp2, adjacent (paired) and with the row layer in a child
    Sequential (gathered): both match the reference (SGD), and the pair
    moves 2 × the rank's hidden slice (4 rows × 16/2 × 4 bytes) fewer
    over tp in a step: the column's gather forward, the row's backward.
    A replicated column bias is sliced to the pair's slice, and its
    gradient's slice gathered back (16/2 × 4 bytes)."""
    specs = PAIR_CASES[name]
    axes = {"dp": 2, "tp": 2}
    w = dense_weights(13)
    data = batches(8, seed=14)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = JTrainer(jax_dense(w, specs), jloss.SoftmaxCrossEntropyLoss(),
                   optimizer="sgd", optimizer_params=opt, mesh=jmesh(axes))
    want_l, want_p, _ = jax_train(jtr, data)
    paired = pool.run("case_pairing", w, specs, axes, data, opt, False)
    nested = pool.run("case_pairing", w, specs, axes, data, opt, True)
    for (l1, p1, b1), (l2, p2, b2) in zip(paired, nested):
        for losses, params in ((l1, p1), (l2, p2)):
            onp.testing.assert_allclose(losses, want_l, **TOL)
            for k in want_p:
                onp.testing.assert_allclose(params[k], want_p[k], **TOL,
                                            err_msg=k)
        bias = 0 if "0.bias" in specs else (16 // 2) * 4
        assert b2 - b1 == 2 * (8 // 2) * (16 // 2) * 4 - bias, (b1, b2)
