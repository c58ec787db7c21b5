"""The training slice as a whole: the port's ``TransformerLM`` trained by
its ``SPMDTrainer`` (Adam, lr 3e-4) against the reference's, from the
same weights (carried across by name) and the same int32 token ids.

Model: vocab 64, units 32, 2 layers, 4 heads, max_len 128, tied
weights; batch 2 × 128 tokens.  The reference trains on a one-device
mesh with its Pallas flash kernels in interpret mode; the port on the
CPU takes the kernels' plain versions.

Tolerances and why:
* logits and f32 losses: 1e-4 (f32 through two layers, sums in another
  order);
* f32 weights after 5 steps: ``SPMDTrainer``'s Adam has no bias
  correction, so the first step moves each weight by about
  ``3.16·lr·sign(g)`` whatever |g| is; where |g| is at the level of
  rounding noise the two packages may pick opposite signs.  So each
  weight must agree within 1e-5 except a share below 1e-3 of them, and
  none may differ by more than the 5-step flip bound ``5·2·3.17·lr``.
  The k third of each ``qkv`` bias is left out of the share: adding a
  constant to every key of a row leaves its softmax unchanged, so its
  gradient is zero but for rounding and its sign is noise;
* bf16 losses: rtol 2e-2 (the two frameworks round to bf16 at other
  places).
"""
import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh

from mxnet_tpu_torch import convert, telemetry, tracing
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
from mxnet_tpu_torch.ops import attention as attn
from mxnet_tpu_torch.parallel import SPMDTrainer

VOCAB, LAYERS, LR = 64, 2, 3e-4
CFG = dict(units=32, num_layers=LAYERS, num_heads=4, max_len=128,
           tie_weights=True)
RNG = onp.random.RandomState(0)
DATA = RNG.randint(0, VOCAB, size=(2, 128)).astype(onp.int32)
LABEL = RNG.randint(0, VOCAB, size=(2, 128)).astype(onp.int32)


def _jax_net():
    net = JaxLM(VOCAB, **CFG)
    net.initialize(init=mx.initializer.Xavier())
    net(mx.nd.array(onp.zeros((1, 8), onp.int32)))
    return net


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _jax_run(dtype):
    """(initial weights, logits, 3 step losses + 2 window losses, final
    weights) of the reference."""
    net = _jax_net()
    init = _params(net)
    logits = net(mx.nd.array(DATA)).asnumpy()
    tr = JaxTrainer(net, jax_loss.SoftmaxCrossEntropyLoss(),
                    optimizer="adam",
                    optimizer_params={"learning_rate": LR},
                    mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                    dtype=dtype)
    d, l = NDArray(DATA), NDArray(LABEL)
    losses = [float(tr.step(d, l).asnumpy()) for _ in range(3)]
    losses += [float(x) for x in tr.run_steps(d, l, 2).asnumpy()]
    return init, logits, losses, _params(net)


def _port_net(init):
    net = TransformerLM(VOCAB, **CFG)
    convert.load_collected_params(net, init, device="cpu")
    return net


def _port_run(init, dtype):
    net = _port_net(init)
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                     optimizer_params={"learning_rate": LR}, dtype=dtype,
                     device="cpu")
    d, l = torch.from_numpy(DATA), torch.from_numpy(LABEL)
    losses = [float(tr.step(d, l)) for _ in range(3)]
    losses += [float(x) for x in tr.run_steps(d, l, 2)]
    return tr, losses, convert.collected_params_to_numpy(net)


@pytest.fixture(scope="module")
def fp32():
    init, logits, losses, final = _jax_run(None)
    return {"init": init, "logits": logits, "losses": losses,
            "final": final}


def test_logits_match(fp32):
    net = _port_net(fp32["init"])
    got = net(torch.from_numpy(DATA)).detach().numpy()
    assert got.shape == (2, 128, VOCAB)
    onp.testing.assert_allclose(got, fp32["logits"], rtol=1e-4, atol=1e-4)


def test_fp32_training_matches_reference(fp32):
    before = (attn.flash_fwd.plain_calls, attn.flash_bwd_dkdv.plain_calls,
              attn.flash_bwd_dq.plain_calls)
    tr, losses, final = _port_run(fp32["init"], None)
    after = (attn.flash_fwd.plain_calls, attn.flash_bwd_dkdv.plain_calls,
             attn.flash_bwd_dq.plain_calls)
    # every step runs each flash kernel (its plain version here) per layer
    assert [a - b for a, b in zip(after, before)] == [5 * LAYERS] * 3
    assert tr.num_update == 5 and tr.optimizer.num_update == 5
    onp.testing.assert_allclose(losses, fp32["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]
    flip = 5 * 2 * 3.17 * LR
    units = CFG["units"]
    for k, want in fp32["final"].items():
        err = onp.abs(final[k] - want)
        assert err.max() <= flip, (k, err.max())
        if k.endswith("attn.qkv.bias"):
            err = onp.concatenate([err[:units], err[2 * units:]])
        assert (err > 1e-5).mean() < 1e-3, (k, (err > 1e-5).mean())


def test_bf16_losses_match_reference():
    init, _, want, _ = _jax_run("bfloat16")
    _, got, final = _port_run(init, "bfloat16")
    onp.testing.assert_allclose(got, want, rtol=2e-2)
    # masters stay f32
    assert all(a.dtype == onp.float32 for a in final.values())


def test_step_emits_telemetry_and_spans(fp32):
    net = _port_net(fp32["init"])
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                     optimizer_params={"learning_rate": LR}, device="cpu")

    class Sink:
        records = []

        def emit(self, r):
            self.records.append(r)

    sink = Sink()
    telemetry.add_sink(sink)
    tracing.enable()
    try:
        tr.step(DATA, LABEL)
        tr.run_steps(DATA[None].repeat(2, 0), LABEL[None].repeat(2, 0), 2,
                     per_step_data=True)
    finally:
        tracing.disable()
        telemetry.remove_sink(sink)
    assert [r["source"] for r in sink.records] == ["SPMDTrainer"] * 2
    assert sink.records[1]["n_steps"] == 2
    names = [e["name"] for e in tracing.recent(10)]
    assert "step.spmd" in names and "step.spmd_window" in names
    with pytest.raises(MXNetError, match="leading axis"):
        tr.run_steps(DATA, LABEL, 3, per_step_data=True)


def test_run_steps_reads_the_schedule_once(fp32):
    net = _port_net(fp32["init"])
    seen = []

    def schedule(n):
        seen.append(n)
        return LR

    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                     optimizer_params={"learning_rate": LR,
                                       "lr_scheduler": schedule},
                     device="cpu")
    tr.step(DATA, LABEL)
    losses = tr.run_steps(DATA, LABEL, 3)
    assert tuple(losses.shape) == (3,)
    assert seen == [0, 1] and tr.num_update == 4


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"zero_stage": 1}])
def test_unported_trainer_options_raise(fp32, kw):
    net = _port_net(fp32["init"])
    with pytest.raises(MXNetError, match="not ported yet"):
        SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                    device="cpu", **kw)
