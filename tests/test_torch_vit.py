"""The slice's model and kernels through the numpy front end, against the
reference:

* the port's ``VisionTransformer`` / ``get_vit`` against the reference's,
  from the same weights carried across by name (``convert``) — a 2-layer
  ViT at 32² with patch 8 (16 patches + CLS = 17 tokens, non-causal):
  logits at fp32 rtol 1e-5 / atol 1e-5, then ``SPMDTrainer`` with Adam
  on the reference's own ViT task (``tests/test_transformer.py::
  test_vision_transformer_trains``), losses step by step at rtol 1e-4
  (fp32 through two layers, Adam's updates differ in the last bits);
* K1–K3's plain versions at the ViT-B/16 sequence, 197 tokens
  non-causal, against the reference's Pallas kernels (interpret mode):
  output and the three gradients at 1e-5;
* ``npx.rope`` (K5), ``npx.paged_attention`` (K4), ``npx.flash_attention``
  (K1) and ``npx.masked_softmax`` against the reference's registered
  ops, each call going once through the funnel (on the CPU a kernel's
  plain version, counted in ``plain_calls``).
"""
import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as jmx
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo.transformer import get_vit as jax_get_vit
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, telemetry
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon.model_zoo import get_vit
from mxnet_tpu_torch.ops import attention as attn
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.ops import rope as rope_mod
from mxnet_tpu_torch.parallel import SPMDTrainer

CPU = mx.cpu()
CFG = dict(image_size=32, patch_size=8, classes=4, units=32, num_layers=2,
           num_heads=4)
RNG = onp.random.RandomState(0)
IMAGES = RNG.rand(16, 3, 32, 32).astype("float32")


def _task():
    """The reference test's separable task, at 32²: class y brightens
    rows 8y..8y+7 of channel 0."""
    r = onp.random.RandomState(0)
    y = r.randint(0, 4, size=64).astype("float32")
    x = r.rand(64, 3, 32, 32).astype("float32") * 0.1
    for i, c in enumerate(y.astype(int)):
        x[i, 0, c * 8:c * 8 + 8, :] += 0.9
    return x, y


@pytest.fixture(scope="module")
def reference():
    jmx.random.seed(0)
    net = jax_get_vit(**CFG)
    net.initialize(init=jmx.initializer.Xavier())
    net(NDArray(onp.zeros((1, 3, 32, 32), "float32")))
    init = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    logits = net(NDArray(IMAGES)).asnumpy()
    x, y = _task()
    tr = JaxTrainer(net, jax_loss.SoftmaxCrossEntropyLoss(),
                    optimizer="adam",
                    optimizer_params={"learning_rate": 1e-3},
                    mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    losses = [float(tr.step(x[i:i + 16], y[i:i + 16]).asnumpy())
              for _ in range(2) for i in range(0, 64, 16)]
    return {"init": init, "logits": logits, "losses": losses}


def _port_vit(init, **kw):
    net = get_vit(**CFG, **kw)
    convert.load_collected_params(net, init, device="cpu")
    return net


def test_parameter_names_and_shapes_match(reference):
    net = _port_vit(reference["init"])
    got = {k: tuple(p.shape) for k, p in net.collect_params().items()}
    want = {k: v.shape for k, v in reference["init"].items()}
    assert got == want
    assert {"cls_token", "pos_embed"} <= set(got)
    back = convert.collected_params_to_numpy(net)
    for k, v in reference["init"].items():
        onp.testing.assert_array_equal(back[k], v)


def test_vit_logits_match(reference):
    net = _port_vit(reference["init"])
    with torch.no_grad():
        got = net(torch.from_numpy(IMAGES)).numpy()
    assert got.shape == (16, 4)
    onp.testing.assert_allclose(got, reference["logits"], rtol=1e-5,
                                atol=1e-5)
    dense = _port_vit(reference["init"], use_flash=False)
    with torch.no_grad():
        onp.testing.assert_allclose(dense(torch.from_numpy(IMAGES)).numpy(),
                                    got, rtol=1e-5, atol=1e-5)


def test_vision_transformer_trains_as_the_reference(reference):
    net = _port_vit(reference["init"])
    x, y = _task()
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                     optimizer_params={"learning_rate": 1e-3},
                     device="cpu")
    before = attn.flash_fwd.plain_calls
    losses = [float(tr.step(torch.from_numpy(x[i:i + 16]),
                            torch.from_numpy(y[i:i + 16])))
              for _ in range(2) for i in range(0, 64, 16)]
    assert attn.flash_fwd.plain_calls - before == 8 * CFG["num_layers"]
    onp.testing.assert_allclose(losses, reference["losses"], rtol=1e-4)
    assert losses[-1] < losses[0]


def test_vit_trains_through_the_numpy_loop():
    """The 2.0 user loop on the CPU: ``npx.set_np()``, ``mx.np`` batches,
    ``autograd.record()``, a loss in ``npx.log_softmax`` / ``npx.pick`` /
    ``np.mean``, ``gluon.Trainer.step``; the net's outputs keep the numpy
    flavor and the loss falls."""
    x, y = _task()
    mx.util.set_np()
    try:
        with CPU:
            mx.random.seed(0)
            net = get_vit(**CFG)
            net.initialize(init=mx.initializer.Xavier(), device="cpu")
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": 1e-3})
            losses = []
            for _ in range(2):
                for i in range(0, 64, 16):
                    data = mx.np.array(x[i:i + 16])
                    label = mx.np.array(y[i:i + 16])
                    with mx.autograd.record():
                        out = net(data)
                        assert type(out) is mx.np.ndarray
                        loss = -mx.np.mean(mx.npx.pick(
                            mx.npx.log_softmax(out), label))
                    assert type(loss) is mx.np.ndarray
                    loss.backward()
                    trainer.step(1)
                    losses.append(float(loss))
    finally:
        mx.util.reset_np()
    assert all(onp.isfinite(losses)) and losses[-1] < losses[0]


def _loop_losses(steps):
    """Losses of ``steps`` steps of the numpy loop from a seeded ViT."""
    from mxnet_tpu_torch.imperative import cached_step
    x, y = _task()
    mx.util.set_np()
    try:
        with CPU:
            mx.random.seed(0)
            net = get_vit(**CFG)
            net.initialize(init=mx.initializer.Xavier(), device="cpu")
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": 1e-3})
            data, label = mx.np.array(x[:16]), mx.np.array(y[:16])
            losses = []
            for i in range(steps):
                if i == 1:
                    # counted from the second step: the first is eager
                    # (and a step another test's trainer left armed to
                    # defer breaks there)
                    s0 = cached_step.stats()
                with mx.autograd.record():
                    loss = -mx.np.mean(mx.npx.pick(
                        mx.npx.log_softmax(net(data)), label))
                loss.backward()
                trainer.step(1)
                losses.append(float(loss))
            s1 = cached_step.stats()
    finally:
        mx.util.reset_np()
    return losses, {k: s1[k] - s0[k] for k in ("compiles", "hits",
                                                "graph_breaks")}


def test_numpy_loop_capture_matches_eager(monkeypatch):
    """The whole-step capture defers every op of the numpy loop (``mx.np``
    and ``npx`` calls are keyed at the funnel): one structure, no break,
    and its losses bitwise those of ``MXNET_CACHED_STEP=0``."""
    monkeypatch.setenv("MXNET_CACHED_STEP", "1")
    captured, stats = _loop_losses(6)
    assert stats == {"compiles": 1, "hits": 4, "graph_breaks": 0}
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    eager, stats0 = _loop_losses(6)
    assert stats0["compiles"] == 0
    assert captured == eager


# -- K1–K3 at the ViT-B/16 sequence (197 non-causal) --------------------------

def test_flash_at_197_noncausal_matches_reference():
    from mxnet_tpu.ops.attention import flash_attention as jax_flash
    r = onp.random.RandomState(1)
    q, k, v = (r.randn(1, 2, 197, 64).astype("float32") for _ in range(3))
    do = r.randn(1, 2, 197, 64).astype("float32")

    def jax_fn(a, b, c):
        return jax_flash(a, b, c, causal=False)
    out, vjp = jax.vjp(jax_fn, q, k, v)
    want = [onp.asarray(out)] + [onp.asarray(g) for g in vjp(do)]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got_out = attn.flash_attention(tq, tk, tv, causal=False)
    got_out.backward(torch.from_numpy(do))
    got = [got_out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(),
           tv.grad.numpy()]
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


# -- the kernels through their npx names --------------------------------------

def _counted(fn, counter):
    """(result, plain calls, funnel dispatches) of one call."""
    d = telemetry.counter("dispatch.count")
    p0, d0 = counter.plain_calls, d.value
    out = fn()
    return out, counter.plain_calls - p0, d.value - d0


def test_npx_rope_reaches_k5_through_the_funnel():
    r = onp.random.RandomState(2)
    x = r.randn(2, 6, 4, 16).astype("float32")
    pos = onp.tile(onp.arange(6, dtype="int32"), (2, 1))
    want = jmx.nd.rope(jmx.nd.array(x), jmx.nd.array(pos),
                       base=500.0).asnumpy()
    with CPU:
        out, plain, disp = _counted(lambda: mx.npx.rope(
            mx.np.array(x), mx.np.array(pos, dtype="int32"), base=500.0),
            rope_mod.rope)
    assert (plain, disp) == (1, 1)
    assert type(out) is mx.np.ndarray
    onp.testing.assert_allclose(out.asnumpy(), want, rtol=1e-5, atol=1e-5)
    direct = rope_mod.rope(torch.from_numpy(x), torch.from_numpy(pos),
                           base=500.0)
    assert torch.equal(out._data, direct)


def test_npx_paged_attention_reaches_k4_through_the_funnel():
    r = onp.random.RandomState(3)
    q = r.randn(3, 2, 16).astype("float32")
    kp = r.randn(8, 4, 2, 16).astype("float32")
    vp = r.randn(8, 4, 2, 16).astype("float32")
    tables = onp.array([[0, 1, 2], [3, 4, 5], [6, 7, 0]], "int32")
    lengths = onp.array([9, 3, 0], "int32")
    want = jmx.nd.paged_attention(*[jmx.nd.array(a) for a in (
        q, kp, vp, tables, lengths)]).asnumpy()
    with CPU:
        args = [mx.np.array(a, dtype=a.dtype) for a in (q, kp, vp, tables,
                                                         lengths)]
        out, plain, disp = _counted(lambda: mx.npx.paged_attention(*args),
                                    pa.paged_attention)
    assert (plain, disp) == (1, 1)
    onp.testing.assert_allclose(out.asnumpy(), want, rtol=1e-5, atol=1e-5)
    direct = pa.paged_attention(*[torch.from_numpy(a) for a in (
        q, kp, vp, tables, lengths)])
    assert torch.equal(out._data, direct)


def test_npx_flash_attention_and_masked_softmax():
    from mxnet_tpu.ops.attention import flash_attention as jax_flash
    r = onp.random.RandomState(4)
    q, k, v = (r.randn(1, 2, 33, 16).astype("float32") for _ in range(3))
    want = onp.asarray(jax_flash(q, k, v, causal=True))
    with CPU:
        out, plain, disp = _counted(lambda: mx.npx.flash_attention(
            mx.np.array(q), mx.np.array(k), mx.np.array(v), causal=True),
            attn.flash_fwd)
    assert (plain, disp) == (1, 1)
    onp.testing.assert_allclose(out.asnumpy(), want, rtol=1e-5, atol=1e-5)
    x = r.randn(3, 7).astype("float32")
    m = (r.rand(3, 7) < 0.6).astype("float32")
    for name in ("masked_softmax", "masked_log_softmax"):
        want = getattr(jmx.npx, name)(jmx.nd.array(x),
                                      jmx.nd.array(m)).asnumpy()
        with CPU:
            got = getattr(mx.npx, name)(mx.np.array(x),
                                        mx.np.array(m)).asnumpy()
        onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
