"""``SPMDTrainer``'s step functions, the ones a CUDA graph holds, on the
CPU (where nothing is captured) against the reference's trainer:
``remat``, ``micro_batches`` (with ``batch_axis``), ``predict`` and
``data_transform``; and the trainer's own contracts: a returned loss is
a copy, one executable per signature, a replaced parameter makes the
trainer capture again, an lr schedule needs no new capture, and the
deferred embedding check raises.

Model: the small TransformerLM of ``test_torch_transformer_train.py``
(vocab 64, units 32, 2 layers, 4 heads, max_len 128, tied weights),
weights carried across by ``convert.load_collected_params``, batch
2 × 128 int32 ids, Adam lr 3e-4, fp32.

Tolerances and why:
* f32 losses and logits against the reference: rtol 1e-4 (f32 through
  two layers, sums in another order);
* f32 weights after 5 steps: within the flip bound ``5·2·3.17·lr`` of
  ``test_torch_transformer_train.py`` (Adam without bias correction
  moves a weight whose gradient is rounding noise by ~3.16·lr either
  way), and within 1e-5 but for a share below 1e-3;
* the port's ``remat`` against its own plain step: bitwise (the same
  operations recomputed);
* the time-major net: the reference's own tolerance, rtol 1e-5 / atol
  1e-6 (two micro-batch means against one batch mean).
"""
import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.base import MXNetError as JaxMXNetError
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.gluon.block import HybridBlock as JaxHybridBlock
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh

from mxnet_tpu_torch import convert, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import HybridBlock
from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
from mxnet_tpu_torch.ops import tensor as tensor_ops
from mxnet_tpu_torch.parallel import SPMDTrainer

VOCAB, LAYERS, LR = 64, 2, 3e-4
CFG = dict(units=32, num_layers=LAYERS, num_heads=4, max_len=128,
           tie_weights=True)
RNG = onp.random.RandomState(0)
DATA = RNG.randint(0, VOCAB, size=(2, 128)).astype(onp.int32)
LABEL = RNG.randint(0, VOCAB, size=(2, 128)).astype(onp.int32)
FLIP = 5 * 2 * 3.17 * LR


def shift(x):
    """A ``data_transform`` both packages can run: ids shifted by one."""
    return (x + 1) % VOCAB


def _mesh():
    return make_mesh({"dp": 1}, devices=jax.devices()[:1])


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _jax_net():
    net = JaxLM(VOCAB, **CFG)
    net.initialize(init=mx.initializer.Xavier())
    net(mx.nd.array(onp.zeros((1, 8), onp.int32)))
    return net


def _jax_trainer(net, **kw):
    return JaxTrainer(net, jax_loss.SoftmaxCrossEntropyLoss(),
                      optimizer="adam",
                      optimizer_params={"learning_rate": LR}, mesh=_mesh(),
                      **kw)


def _jax_train(**kw):
    """(initial weights, 3 step losses + 2 window losses, final weights)
    of the reference."""
    net = _jax_net()
    init = _params(net)
    tr = _jax_trainer(net, **kw)
    d, l = NDArray(DATA), NDArray(LABEL)
    losses = [float(tr.step(d, l).asnumpy()) for _ in range(3)]
    losses += [float(x) for x in tr.run_steps(d, l, 2).asnumpy()]
    return init, losses, _params(net)


def _port_net(init):
    net = TransformerLM(VOCAB, **CFG)
    convert.load_collected_params(net, init, device="cpu")
    return net


def _port_trainer(net, **kw):
    return SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                       optimizer="adam",
                       optimizer_params={"learning_rate": LR},
                       device="cpu", **kw)


def _port_train(init, **kw):
    net = _port_net(init)
    tr = _port_trainer(net, **kw)
    d, l = torch.from_numpy(DATA), torch.from_numpy(LABEL)
    losses = [float(tr.step(d, l)) for _ in range(3)]
    losses += [float(x) for x in tr.run_steps(d, l, 2)]
    return tr, losses, convert.collected_params_to_numpy(net)


def _assert_weights_close(final, want):
    units = CFG["units"]
    for k, w in want.items():
        err = onp.abs(final[k] - w)
        assert err.max() <= FLIP, (k, err.max())
        if k.endswith("attn.qkv.bias"):
            # the k third: its gradient is zero but for rounding
            err = onp.concatenate([err[:units], err[2 * units:]])
        assert (err > 1e-5).mean() < 1e-3, (k, (err > 1e-5).mean())


@pytest.fixture(scope="module")
def remat_ref():
    return _jax_train(remat=True)


@pytest.fixture(scope="module")
def micro_ref():
    net = _jax_net()
    init = _params(net)
    tr = _jax_trainer(net, micro_batches=2)
    d, l = NDArray(DATA), NDArray(LABEL)
    losses = [float(tr.step(d, l).asnumpy()) for _ in range(3)]
    losses += [float(x) for x in tr.run_steps(d, l, 2).asnumpy()]
    with pytest.raises(JaxMXNetError, match="divisible") as err:
        tr.step(NDArray(DATA[:1]), NDArray(LABEL[:1]))
    return init, losses, _params(net), str(err.value)


def test_remat_matches_reference(remat_ref):
    init, want, final_want = remat_ref
    tr, losses, final = _port_train(init, remat=True)
    assert tr.remat and tr.num_update == 5
    onp.testing.assert_allclose(losses, want, rtol=1e-4)
    assert losses[-1] < losses[0]
    _assert_weights_close(final, final_want)


def test_remat_is_the_plain_step_bitwise(remat_ref):
    init = remat_ref[0]
    _, plain, plain_final = _port_train(init)
    _, remat, remat_final = _port_train(init, remat=True)
    assert remat == plain
    for k, w in plain_final.items():
        assert onp.array_equal(remat_final[k], w), k


def test_micro_batches_match_reference(micro_ref):
    init, want, final_want, _ = micro_ref
    tr, losses, final = _port_train(init, micro_batches=2)
    assert tr.micro_batches == 2 and tr.num_update == 5
    onp.testing.assert_allclose(losses, want, rtol=1e-4)
    _assert_weights_close(final, final_want)


def test_micro_batches_not_divisible_raises_as_reference(micro_ref):
    tr = _port_trainer(_port_net(micro_ref[0]), micro_batches=2)
    with pytest.raises(MXNetError) as err:
        tr.step(DATA[:1], LABEL[:1])
    assert str(err.value) == micro_ref[3]
    assert tr.num_update == 0 and tr.compiles == 0
    with pytest.raises(MXNetError, match=">= 1"):
        _port_trainer(_port_net(micro_ref[0]), micro_batches=0)


class _JaxTimeMajor(JaxHybridBlock):
    def __init__(self):
        super().__init__()
        self.d = jax_nn.Dense(3, flatten=False)

    def forward(self, x):              # x: (T, B, F) time-major
        return self.d(x).mean(axis=0)


class _TimeMajor(HybridBlock):
    def __init__(self):
        super().__init__()
        self.d = nn.Dense(3, flatten=False)

    def forward(self, x):
        return self.d(x).mean(dim=0)


def test_micro_batches_split_the_batch_axis():
    """Time-major (T, B, F) data with (B,) labels and ``batch_axis=1``,
    as ``tests/test_parallel.py::test_micro_batch_respects_batch_axis``:
    2 micro-batches along axis 1 (axis 0 for the labels) train like one
    batch, and like the reference's."""
    rng = onp.random.RandomState(0)
    data = rng.randn(5, 8, 4).astype(onp.float32)      # T=5, B=8
    label = rng.randint(0, 3, size=(8,)).astype(onp.float32)
    jnet = _JaxTimeMajor()
    jnet.initialize(init=mx.initializer.Xavier())
    jnet(NDArray(onp.zeros((5, 1, 4), onp.float32)))
    init = _params(jnet)
    jt = JaxTrainer(jnet, jax_loss.SoftmaxCrossEntropyLoss(),
                    optimizer="adam", optimizer_params={"learning_rate": 0.1},
                    mesh=_mesh(), batch_axis=1, micro_batches=2)
    want = [float(jt.step(data, label).asnumpy()) for _ in range(3)]

    losses = {}
    for k in (1, 2):
        net = _TimeMajor()
        net.initialize(device="cpu")
        net(torch.zeros((5, 1, 4)))
        convert.load_collected_params(net, init, device="cpu")
        tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                         optimizer="adam",
                         optimizer_params={"learning_rate": 0.1},
                         batch_axis=1, micro_batches=k, device="cpu")
        losses[k] = [float(tr.step(data, label)) for _ in range(3)]
    onp.testing.assert_allclose(losses[2], losses[1], rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(losses[2], want, rtol=1e-5, atol=1e-6)


def test_predict_matches_reference():
    jnet = _jax_net()
    init = _params(jnet)
    want = _jax_trainer(jnet).predict(NDArray(DATA)).asnumpy()
    tr = _port_trainer(_port_net(init))
    got = tr.predict(DATA)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 128,
                                                               VOCAB)
    onp.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # eval mode, nothing trained, and the same as the eager forward
    assert tr.num_update == 0 and tr.compiles == 1
    assert torch.equal(got, tr._predict_eager(DATA))


def test_data_transform_runs_inside_step_and_predict():
    jnet = _jax_net()
    init = _params(jnet)
    jt = _jax_trainer(jnet, data_transform=shift)
    want = [float(jt.step(NDArray(DATA), NDArray(LABEL)).asnumpy())
            for _ in range(2)]
    want_logits = jt.predict(NDArray(DATA)).asnumpy()
    tr = _port_trainer(_port_net(init), data_transform=shift)
    got = [float(tr.step(DATA, LABEL)) for _ in range(2)]
    onp.testing.assert_allclose(got, want, rtol=1e-4)
    onp.testing.assert_allclose(tr.predict(DATA).numpy(), want_logits,
                                rtol=1e-4, atol=1e-4)
    # the shifted ids are not the raw ones
    plain = _port_trainer(_port_net(init))
    assert abs(float(plain.step(DATA, LABEL)) - got[0]) > 1e-3


def test_step_returns_losses_that_do_not_alias(remat_ref):
    tr = _port_trainer(_port_net(remat_ref[0]))
    losses = [tr.step(DATA, LABEL) for _ in range(3)]
    values = [float(x) for x in losses]
    assert len({x.data_ptr() for x in losses}) == 3
    assert values[0] > values[1] > values[2]
    window = tr.run_steps(DATA, LABEL, 2)
    assert [float(x) for x in losses] == values   # untouched by later calls
    assert float(window[1]) < float(window[0]) < values[2]


def test_one_executable_per_signature(remat_ref):
    before = telemetry.snapshot("compile.spmd_step").get(
        "compile.spmd_step.count", 0)
    tr = _port_trainer(_port_net(remat_ref[0]))
    tr.step(DATA, LABEL)
    tr.step(torch.from_numpy(DATA), torch.from_numpy(LABEL))
    tr.run_steps(DATA, LABEL, 2)
    tr.run_steps(DATA[None].repeat(2, 0), LABEL[None].repeat(2, 0), 2,
                 per_step_data=True)
    assert tr.compiles == 1                  # the same (shape, dtype)
    tr.step(DATA[:1], LABEL[:1])
    tr.predict(DATA)
    tr.predict(DATA)
    assert tr.compiles == 3 and len(tr._exec) == 3
    after = telemetry.snapshot("compile.spmd_step")[
        "compile.spmd_step.count"]
    assert after - before == 3


def test_replaced_parameter_makes_the_trainer_capture_again(remat_ref):
    net = _port_net(remat_ref[0])
    tr = _port_trainer(net)
    tr.step(DATA, LABEL)
    p = net.collect_params()["blocks.0.ffn1.weight"]
    in_place = p.data().clone()
    p.set_data(in_place)                     # copies: the same address
    tr.step(DATA, LABEL)
    assert tr.compiles == 1
    old = p.data()
    p._set(old.detach() * 0.5)               # a new tensor
    new = p.data()
    frozen = old.detach().clone()
    start = new.detach().clone()
    tr.step(DATA, LABEL)
    assert tr.compiles == 2
    assert torch.equal(old.detach(), frozen)          # no longer trained
    assert not torch.equal(new.detach(), start)       # trained instead


def test_lr_schedule_needs_no_new_capture(remat_ref):
    net = _port_net(remat_ref[0])
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                     optimizer_params={"learning_rate": LR,
                                       "lr_scheduler":
                                           lambda n: LR if n == 0 else 0.0},
                     device="cpu")
    tr.step(DATA, LABEL)
    before = convert.collected_params_to_numpy(net)
    tr.step(DATA, LABEL)                     # lr 0: Adam moves no weight
    after = convert.collected_params_to_numpy(net)
    assert tr.compiles == 1
    assert all(onp.array_equal(before[k], after[k]) for k in before)


def test_deferred_embedding_check_clamps_and_raises_the_eager_error():
    weight = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    ids = torch.tensor([[0, 5], [-1, 2]], dtype=torch.int32)
    with pytest.raises(MXNetError) as eager:
        tensor_ops.embedding(ids, weight)
    check = tensor_ops.IdCheck()
    with check:
        rows = tensor_ops.embedding(ids, weight)
        tensor_ops.embedding(ids[:, :1], weight)
    assert torch.equal(rows, weight[torch.tensor([[0, 3], [0, 2]])])
    assert check.vocabs == [4, 4]
    assert check.bounds().tolist() == [[-1, 5], [-1, 0]]
    with pytest.raises(MXNetError) as deferred:
        tensor_ops.IdCheck.raise_if_bad(check.bounds(), check.vocabs)
    assert str(deferred.value) == str(eager.value)
    tensor_ops.IdCheck.raise_if_bad(torch.tensor([[0, 3]]), [4])
    # outside the check the eager path runs again
    with pytest.raises(MXNetError, match="must lie in"):
        tensor_ops.embedding(ids, weight)


def test_trainer_raises_on_an_id_out_of_range(remat_ref):
    """On the CPU the step raises at once, through the deferred check its
    graph holds on the card, with the eager check's message; the trainer
    then steps on as before."""
    tr = _port_trainer(_port_net(remat_ref[0]))
    bad = DATA.copy()
    bad[1, 7] = VOCAB
    with pytest.raises(MXNetError,
                       match=rf"must lie in \[0, {VOCAB}\), got \[0, "
                             rf"{VOCAB}\]"):
        tr.step(bad, LABEL)
    with pytest.raises(MXNetError, match="must lie in"):
        tr.predict(bad)
    with pytest.raises(MXNetError, match="must lie in"):
        tr.run_steps(bad[None].repeat(2, 0), LABEL[None].repeat(2, 0), 2,
                     per_step_data=True)
    assert onp.isfinite(float(tr.step(DATA, LABEL)))
    assert tr.compiles == 2                  # step and predict


def test_seq_axis_is_not_ported(remat_ref):
    with pytest.raises(MXNetError, match="seq_axis not ported yet"):
        _port_trainer(_port_net(remat_ref[0]), seq_axis=1)
