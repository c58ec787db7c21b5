"""ZeRO 1–3 against the reference (``SPMDTrainer(zero_stage=)``,
``gluon.Trainer(zero=)`` with ``optimizer/fused_step.py``'s sharded
update under the cached step), on the CPU.

The reference runs on the 8 emulated devices ``tests/conftest.py`` sets
up; the port on spawned gloo ranks (``torch_dist_cases.RankPool``): 4
for the SPMDTrainer stages at dp4, 2 for the Gluon loop at dp2, and a
group of 1 for the dp-1 cases.  Held at fp32 rtol 1e-5 / atol 1e-6: the
losses of 3 steps, the parameters and the optimizer state after them
(gathered), and ``opt_state.bytes_per_device`` against the reference's
per-device bytes.  At dp 1 every stage is bitwise equal to stage 0 and
to the unmeshed trainer, as ``SPMDTrainer(mesh=make_mesh({"dp": -1}))``
is built by ``bench.py``.
"""
import os

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon import Trainer as JGluonTrainer
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.optimizer import fused_step as jfused
from mxnet_tpu.parallel import SPMDTrainer as JTrainer
from mxnet_tpu.parallel import make_mesh as jmesh

import torch_dist_cases as cases
from test_torch_mesh import TOL, assert_same, batches, dense_weights, \
    jax_dense, jax_train


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = cases.RankPool(
                world, tmp_path_factory.mktemp(f"ranks{world}"))
        return made[world]
    yield get
    for p in made.values():
        p.close()


ADAM = {"learning_rate": 0.05}


@pytest.mark.parametrize("stage", [1, 2, 3])
def test_spmd_zero_dp4_matches_the_reference(pools, stage):
    w = dense_weights(2)
    data = batches(8, seed=3)
    jtr = JTrainer(jax_dense(w), jloss.SoftmaxCrossEntropyLoss(),
                   optimizer="adam", optimizer_params=ADAM,
                   mesh=jmesh({"dp": 4}), zero_stage=stage)
    want = jax_train(jtr, data)
    want_bytes = jtr.opt_state_bytes_per_device()
    # stage 3 loads the reference's weights into the built trainer
    # (convert.load_collected_params: each rank its dp chunk)
    got = pools(4).run("case_spmd_dense", w, None, {"dp": 4}, "adam", ADAM,
                       data, stage, stage == 3)
    for r in got:
        assert_same(r, want)
        assert r[3] == want_bytes
        assert r[4]["reduce_scatter"] > 0 and r[4]["all_gather"] > 0


def test_gluon_zero_dp2_under_the_cached_step_matches_the_reference(pools):
    """Trainer(zero=True) in the eager loop, the cached step on (its
    default): each rank updates its chunk of the flat, padded weights
    and Adam state and all-gathers them.  Turning ZeRO off before the
    fifth step breaks the captured step ("zero sharding toggled since
    capture") and the states go back to whole tensors, in both
    packages."""
    from mxnet_tpu.imperative import cached_step as jcached
    w = dense_weights(4)
    data = batches(6, seed=5, steps=5)
    net = jax_dense(w)
    tr = JGluonTrainer(net.collect_params(), "adam", dict(ADAM), zero=True)
    lf = jloss.SoftmaxCrossEntropyLoss()
    want_l = []
    for i, (d, l) in enumerate(data):
        if i == 4:
            tr._zero = False
        with mx.autograd.record():
            loss = lf(net(mx.nd.array(d)), mx.nd.array(l))
        loss.backward()
        tr.step(d.shape[0])
        want_l.append(float(loss.mean().asnumpy()))
    want_reason = jcached.trainer_state(tr)["last_reason"]
    updater = tr._updaters[0]
    jfused.unshard_states(updater)
    keys = sorted(net.collect_params().keys())
    want_p = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    want_s = {k: [s.asnumpy() for s in updater.states[i]]
              for i, k in enumerate(keys)}
    got = pools(2).run("case_gluon_zero", w, data, ADAM, True, 4)
    sizes = {k: v.size for k, v in w.items()}
    assert want_reason == "zero sharding toggled since capture"
    for losses, params, states, chunk_bytes, captured, reason in got:
        assert reason == want_reason
        onp.testing.assert_allclose(losses, want_l, **TOL)
        for k in keys:
            onp.testing.assert_allclose(params[k], want_p[k], **TOL)
            for a, b in zip(states[k], want_s[k]):
                onp.testing.assert_allclose(a, b, **TOL)
        # two f32 Adam slots, each this rank's half of the padded length
        assert chunk_bytes == sum(2 * 4 * ((n + 1) // 2)
                                  for n in sizes.values())
        # before the toggle: the first step runs eagerly and arms the
        # capture; the next three run as the one captured function
        assert captured == 3


def test_zero_at_dp1_is_stage_0_bitwise(pools):
    """A group of one (a plain run): every stage equals stage 0 and the
    unmeshed trainer bit for bit, as the reference's ZeRO does at a dp
    width of 1; bench.py's ``mesh=make_mesh({"dp": -1})`` builds and
    steps."""
    w = dense_weights(6)
    data = batches(8, seed=7)
    (out,) = pools(1).run("case_one_rank", w, data, ADAM)
    base = out["plain"]
    for stage in (0, 1, 2, 3):
        got = out[stage]
        assert got[0] == base[0]
        for k in base[1]:
            onp.testing.assert_array_equal(got[1][k], base[1][k])
            for a, b in zip(got[2][k], base[2][k]):
                onp.testing.assert_array_equal(a, b)
        assert got[3] == base[3]
