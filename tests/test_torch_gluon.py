"""The port's Gluon layers, loss, initializers and Adam op
(mxnet_tpu_torch.gluon, .initializer, .ops.optimizer_ops) against the
reference's (mxnet_tpu.gluon ...), on weights carried across from the
reference with ``convert.load_collected_params``.

Tolerance 1e-5 on f32 layer outputs (the same f32 arithmetic in another
library, sums in another order) and 1e-6 on the elementwise Adam op.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu.ops.optimizer_ops import adam_update as jax_adam

from mxnet_tpu_torch import convert, initializer
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import DeferredInitializationError
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
from mxnet_tpu_torch.ops import optimizer_ops


def _rand(*shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


def _jax_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _carry(jax_block, port_block, x):
    """Initialize both (the reference's deferred dims through a forward),
    carry the reference's weights across, run both on ``x``."""
    jax_block.initialize(init=mx.initializer.Xavier())
    want = jax_block(mx.nd.array(x)).asnumpy()
    port_block.initialize(device="cpu")
    convert.load_collected_params(port_block, _jax_params(jax_block),
                                  device="cpu")
    got = port_block(torch.from_numpy(x)).detach().numpy()
    return got, want


@pytest.mark.parametrize("flatten", [False, True])
def test_dense(flatten):
    x = _rand(2, 5, 8, seed=1)
    got, want = _carry(jax_nn.Dense(16, flatten=flatten),
                       nn.Dense(16, flatten=flatten), x)
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_layer_norm():
    x = _rand(2, 5, 8, seed=2) * 3 + 1
    jln, pln = jax_nn.LayerNorm(), nn.LayerNorm()
    jln.initialize()
    jln(mx.nd.array(x))
    jln.gamma.set_data(mx.nd.array(_rand(8, seed=3)))
    jln.beta.set_data(mx.nd.array(_rand(8, seed=4)))
    got, want = _carry(jln, pln, x)
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_embedding():
    ids = onp.random.RandomState(5).randint(0, 20, size=(3, 7))
    got, want = _carry(jax_nn.Embedding(20, 6), nn.Embedding(20, 6),
                       ids.astype(onp.int32))
    onp.testing.assert_array_equal(got, want)


def test_embedding_refuses_ids_out_of_range_and_float_ids():
    """The reference rounds float ids in bf16 and fills out-of-range rows
    with NaN; the port raises instead."""
    emb = nn.Embedding(20, 6)
    emb.initialize(device="cpu")
    with pytest.raises(MXNetError, match=r"\[0, 20\)"):
        emb(torch.tensor([[3, 20]], dtype=torch.int32))
    with pytest.raises(MXNetError, match="integer ids"):
        emb(torch.tensor([[3.0, 4.0]]))


@pytest.mark.parametrize("approximation", ["erf", "tanh"])
def test_gelu(approximation):
    x = _rand(4, 33, seed=6) * 3
    want = jax_nn.GELU(approximation)(mx.nd.array(x)).asnumpy()
    got = nn.GELU(approximation)(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_softmax_cross_entropy_loss():
    pred = _rand(2, 5, 10, seed=7) * 2
    label = onp.random.RandomState(8).randint(0, 10, size=(2, 5))
    want = jax_loss.SoftmaxCrossEntropyLoss()(
        mx.nd.array(pred), mx.nd.array(label.astype(onp.int32))).asnumpy()
    got = gloss.SoftmaxCrossEntropyLoss()(
        torch.from_numpy(pred), torch.from_numpy(label)).numpy()
    assert got.shape == (2,)
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _jax_lm():
    net = JaxLM(64, units=32, num_layers=2, num_heads=4, max_len=128,
                tie_weights=True)
    net.initialize(init=mx.initializer.Xavier())
    net(mx.nd.array(onp.zeros((1, 8), onp.int32)))
    return net


def test_transformer_lm_params_have_the_references_names_and_shapes():
    jnet = _jax_lm()
    pnet = TransformerLM(64, units=32, num_layers=2, num_heads=4,
                         max_len=128, tie_weights=True)
    pnet.initialize(init=initializer.Xavier(), device="cpu")
    pnet(torch.zeros((1, 8), dtype=torch.int32))
    want = {k: tuple(p.shape) for k, p in jnet.collect_params().items()}
    got = {k: tuple(p.shape) for k, p in pnet.collect_params().items()}
    assert list(got) == list(want) and got == want
    assert len(got) == 28 and "blocks.0.attn.qkv.weight" in got
    assert dict(pnet.named_parameters()).keys() == got.keys()


def test_convert_round_trips_and_checks_names_and_shapes():
    arrays = _jax_params(_jax_lm())
    pnet = TransformerLM(64, units=32, num_layers=2, num_heads=4,
                         max_len=128, tie_weights=True)
    convert.load_collected_params(pnet, arrays, device="cpu")
    back = convert.collected_params_to_numpy(pnet)
    assert back.keys() == arrays.keys()
    for k in arrays:
        onp.testing.assert_array_equal(back[k], arrays[k])
    short = dict(arrays)
    short.pop("pos_embed")
    with pytest.raises(MXNetError, match="missing"):
        convert.load_collected_params(pnet, short, device="cpu")
    bad = dict(arrays, pos_embed=onp.zeros((127, 32), onp.float32))
    with pytest.raises(MXNetError, match="pos_embed"):
        convert.load_collected_params(pnet, bad, device="cpu")


def test_deferred_init_and_initializers():
    d = nn.Dense(4)
    with pytest.raises(MXNetError, match="net.initialize"):
        d.weight.data()
    d.initialize(init=initializer.Xavier(), device="cpu",
                 generator=torch.Generator().manual_seed(3))
    with pytest.raises(DeferredInitializationError):
        d.weight.data()
    d(torch.zeros(2, 6))
    w = d.weight._tensor()
    bound = (3.0 / ((6 + 4) / 2.0)) ** 0.5
    assert w.shape == (4, 6) and float(w.detach().abs().max()) <= bound
    assert not d.bias._tensor().any()
    again = nn.Dense(4)
    again.initialize(init="xavier", device="cpu",
                     generator=torch.Generator().manual_seed(3))
    again(torch.zeros(2, 6))
    assert torch.equal(again.weight._tensor(), w)
    ln = nn.LayerNorm()
    ln.initialize(device="cpu")
    ln(torch.zeros(1, 5))
    assert torch.equal(ln.gamma._tensor(), torch.ones(5))
    with pytest.raises(MXNetError, match="unknown initializer"):
        initializer.create("nope")


def test_adam_update_op_matches_reference():
    w, g, m, v = (_rand(5, 7, seed=s) for s in range(4))
    v = onp.abs(v)
    kw = dict(lr=3e-4, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.01,
              rescale_grad=0.5, clip_gradient=0.8)
    want = jax_adam(*map(jnp.asarray, (w, g, m, v)), **kw)
    got = optimizer_ops.adam_update(*map(torch.from_numpy, (w, g, m, v)),
                                    **kw)
    for a, b in zip(got, want):
        onp.testing.assert_allclose(a.numpy(), onp.asarray(b), rtol=1e-6,
                                    atol=1e-7)


def test_adam_update_multi_is_the_same_arithmetic():
    """The trainer's multi-tensor form gives bitwise the per-tensor op's
    results, with a learning rate and weight decay per tensor."""
    shapes = [(5, 7), (3,), (2, 3, 4)]
    rng = onp.random.RandomState(9)
    w, g, m, v = ([torch.from_numpy(rng.randn(*s).astype("float32"))
                   for s in shapes] for _ in range(4))
    v = [x.abs() for x in v]
    lrs, wds = [3e-4, 1e-3, 2e-4], [0.0, 0.01, 0.1]
    kw = dict(beta1=0.9, beta2=0.999, epsilon=1e-8, rescale_grad=0.5,
              clip_gradient=0.8)
    got = optimizer_ops.adam_update_multi(w, g, m, v, lrs=lrs, wds=wds,
                                          **kw)
    for i in range(3):
        want = optimizer_ops.adam_update(w[i], g[i], m[i], v[i], lr=lrs[i],
                                         wd=wds[i], **kw)
        for out, ref in zip((got[0][i], got[1][i], got[2][i]), want):
            assert torch.equal(out, ref)
