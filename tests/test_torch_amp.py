"""AMP in the port against the reference on the CPU: the execution
policy's categories, ``convert_model``, the dynamic loss scaler's
schedule and state, ``scale_loss`` with an overflow in the eager Gluon
loop, and ``SPMDTrainer`` under ``MXNET_AMP=1`` with a forced overflow.

Tolerances: dtypes and the scaler's schedule exactly; bf16 outputs at
bf16 tolerance (rtol 2e-2, atol 2e-2 of the largest value); the fp32
parts of the loop rtol 1e-5; ``SPMDTrainer``'s bf16 steps: losses rtol
2e-2, masters within 2e-2 of their norm (L2), the scale and the skipped
count exactly.  On the CPU nothing is captured."""
import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu import amp as jax_amp
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import amp, convert
from mxnet_tpu_torch.amp import policy
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import nn as nn_ops
from mxnet_tpu_torch.parallel import SPMDTrainer


@pytest.fixture(autouse=True)
def _amp_off_after(monkeypatch):
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    yield
    amp.reset()
    jax_amp.reset()


RNG = onp.random.RandomState(0)
X = RNG.randn(8, 10).astype(onp.float32)
Y = (onp.arange(8) % 4).astype(onp.float32)
W1 = (RNG.randn(16, 10) * 0.3).astype(onp.float32)
B1 = (RNG.randn(16) * 0.1).astype(onp.float32)
W2 = (RNG.randn(4, 16) * 0.3).astype(onp.float32)
B2 = (RNG.randn(4) * 0.1).astype(onp.float32)
INIT = {"0.weight": W1, "0.bias": B1, "1.weight": W2, "1.bias": B2}


def _mlp(pkg):
    if pkg is mx:
        net = jax_nn.HybridSequential()
        net.add(jax_nn.Dense(16, activation="relu", in_units=10),
                jax_nn.Dense(4, in_units=16))
        net.initialize()
        for k, p in net.collect_params().items():
            p.set_data(mx.nd.array(INIT[k]))
        return net
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=10),
            nn.Dense(4, in_units=16))
    convert.load_collected_params(net, INIT, device="cpu")
    return net


# -- the policy ------------------------------------------------------------------

def test_policy_state_matches_reference(monkeypatch):
    """``enabled``, ``compute_dtype_str``, ``cache_token``, ``category`` and
    ``compute_itemsize`` with the policy off, on through ``init``, and on
    through ``MXNET_AMP=1`` / ``MXNET_AMP_DTYPE``."""
    from mxnet_tpu.amp import policy as jpol

    def snap(pol):
        return (pol.enabled(), pol.cache_token(), pol.compute_itemsize(),
                [pol.category(n) for n in ("FullyConnected", "softmax",
                                           "elemwise_add", "relu")])

    assert snap(policy) == snap(jpol)
    amp.init("bfloat16")
    jax_amp.init("bfloat16")
    assert snap(policy) == snap(jpol)
    amp.reset()
    jax_amp.reset()
    monkeypatch.setenv("MXNET_AMP", "1")
    monkeypatch.setenv("MXNET_AMP_DTYPE", "float16")
    assert snap(policy) == snap(jpol)
    assert policy.compute_dtype() == torch.float16
    monkeypatch.setenv("MXNET_AMP_DTYPE", "fp8")
    with pytest.raises(mt.MXNetError, match="not ported yet"):
        policy.compute_dtype_str()


def test_categories_cast_like_the_reference():
    """Under ``amp.init("bfloat16")``: ``FullyConnected`` and ``dot`` see
    bf16 inputs (f32 in, bf16 out), ``softmax`` / ``log_softmax`` /
    ``mean`` compute in f32 (bf16 in, f32 out), ``elemwise_add`` casts to
    the widest input; off, nothing changes.  Values at bf16 tolerance."""
    rng = onp.random.RandomState(1)
    x = rng.randn(4, 6).astype(onp.float32)
    w = rng.randn(5, 6).astype(onp.float32)
    cases = [("FullyConnected", [x, w], {"num_hidden": 5}, "float32"),
             ("dot", [x, w.T.copy()], {}, "float32"),
             ("softmax", [x], {}, "bfloat16"),
             ("log_softmax", [x], {}, "bfloat16"),
             ("mean", [x], {}, "bfloat16")]
    for on in (False, True):
        if on:
            amp.init("bfloat16")
            jax_amp.init("bfloat16")
        for name, arrays, kw, dt in cases:
            ref = getattr(mx.nd, name)(
                *[mx.nd.array(a).astype(dt) for a in arrays], **kw)
            got = getattr(mt.nd, name)(
                *[mt.nd.array(a, ctx=mt.cpu(), dtype=dt) for a in arrays],
                **kw)
            assert str(got.dtype).replace("torch.", "") == \
                str(ref.dtype), (name, on)
            r = ref.astype("float32").asnumpy()
            onp.testing.assert_allclose(
                got.astype("float32").asnumpy(), r, rtol=2e-2,
                atol=2e-2 * float(abs(r).max()))
        a = mt.nd.array(x, ctx=mt.cpu(), dtype="bfloat16")
        b = mt.nd.array(x, ctx=mt.cpu())
        ra = mx.nd.array(x).astype("bfloat16")
        assert str(mt.nd.elemwise_add(a, b).dtype) == "float32" == \
            str(mx.nd.elemwise_add(ra, mx.nd.array(x)).dtype)


def test_gluon_layers_follow_the_policy():
    """The layers call the policed op functions: under the policy a Dense
    layer's output is bf16 (its f32 weights and input cast down inside
    the op), a LayerNorm's f32."""
    dense = nn.Dense(3, in_units=4)
    dense.initialize(device="cpu")
    ln = nn.LayerNorm(in_channels=3)
    ln.initialize(device="cpu")
    x = torch.randn(2, 4)
    assert dense(x).dtype == torch.float32
    amp.init("bfloat16")
    y = dense(x)
    assert y.dtype == torch.bfloat16
    assert ln(y).dtype == torch.float32
    assert nn_ops.fully_connected.amp_category == "target"


def test_convert_model_matches_reference():
    """``convert_model(net, "bfloat16")`` casts every f32 parameter: the
    same dtypes and values, and the converted net's forward at bf16
    tolerance."""
    ref = jax_amp.convert_model(_mlp(mx), "bfloat16")
    got = amp.convert_model(_mlp(mt), "bfloat16")
    for k, p in ref.collect_params().items():
        q = got.collect_params()[k]
        assert q.data().dtype == torch.bfloat16 and p.dtype.name == \
            "bfloat16"
        onp.testing.assert_array_equal(q.data().detach().float().numpy(),
                                       p.data().astype("float32").asnumpy())
    r = ref(mx.nd.array(X).astype("bfloat16")).astype("float32").asnumpy()
    g = got(torch.from_numpy(X).bfloat16()).detach().float().numpy()
    onp.testing.assert_allclose(g, r, rtol=2e-2, atol=2e-2 * abs(r).max())


# -- the loss scaler -------------------------------------------------------------

def test_loss_scaler_schedule_and_state_match_reference():
    """A scale window of 3: growth after 3 clean steps, halving on an
    overflow, the floor of 1.0; ``state`` / ``load_state``; the counters."""
    from mxnet_tpu_torch import telemetry
    flags = [False, False, False, True, False, True, True, True, True,
             True, True, False, False, False, False]
    ref = jax_amp.LossScaler(init_scale=8.0, scale_window=3)
    got = amp.LossScaler(init_scale=8.0, scale_window=3)
    skipped0 = telemetry.counter("amp.skipped_updates").value
    scales = []
    for f in flags:
        ref.update_scale(f)
        got.update_scale(f)
        assert got.loss_scale == ref.loss_scale
        assert got.state() == ref.state()
        scales.append(got.loss_scale)
    assert max(scales) == 16.0 and scales.count(1.0) == 6   # the floor
    assert telemetry.counter("amp.skipped_updates").value - skipped0 == \
        sum(flags)
    assert telemetry.gauge("amp.loss_scale").value == got.loss_scale
    st = {"loss_scale": 64.0, "unskipped": 2, "scale_factor": 4.0,
          "scale_window": 5}
    ref.load_state(st)
    got.load_state(st)
    for f in (False, False, False, True):
        ref.update_scale(f)
        got.update_scale(f)
        assert got.state() == ref.state()


def test_adopt_traced_folds_one_step_later():
    """``adopt_traced`` takes device tensors and folds the previous ones:
    the host state follows with one step of lag, and reading
    ``loss_scale`` folds at once; the skipped count reaches the
    counters."""
    from mxnet_tpu_torch import telemetry
    s = amp.LossScaler(init_scale=4.0)
    n0 = telemetry.counter("amp.overflow_steps").value
    s.adopt_traced(torch.tensor(2.0), torch.tensor(0.0), torch.tensor(1.0))
    assert s._loss_scale == 4.0                # not folded yet
    s.adopt_traced(torch.tensor(4.0), torch.tensor(1.0), torch.tensor(0.0))
    assert s._loss_scale == 2.0 and s._unskipped == 0
    assert s.loss_scale == 4.0 and s._unskipped == 1
    assert telemetry.counter("amp.overflow_steps").value - n0 == 1


def test_all_finite_is_one_device_bool():
    t = [torch.ones(3), torch.zeros(2, 2, dtype=torch.bfloat16)]
    assert amp.all_finite(t).dim() == 0 and bool(amp.all_finite(t))
    for bad in (float("inf"), float("nan"), -float("inf")):
        u = [x.clone() for x in t]
        u[1][0, 1] = bad
        assert not bool(amp.all_finite(u))
    big = [torch.full((4,), 3e38)]
    assert bool(amp.all_finite(big))           # finite, however large


def _scaled_loop(pkg, overflow_at):
    """Four recorded steps of the MLP with ``amp.init``, ``init_trainer``
    and ``scale_loss``; at ``overflow_at`` an inf is written into a
    gradient inside the ``scale_loss`` block."""
    net = _mlp(pkg)
    am = jax_amp if pkg is mx else amp
    am.init("bfloat16")
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9})
    am.init_trainer(tr)
    lf = (jax_loss if pkg is mx else gloss).SoftmaxCrossEntropyLoss()
    ctx = {} if pkg is mx else {"ctx": mt.cpu()}
    x, y = pkg.nd.array(X, **ctx), pkg.nd.array(Y, **ctx)
    rows = []
    for i in range(4):
        with pkg.autograd.record():
            loss = lf(net(x), y)
            with am.scale_loss(loss, tr) as scaled:
                scaled.backward()
                if i == overflow_at:
                    g = net.collect_params()["1.weight"].grad()
                    if pkg is mx:
                        g[0, 0] = float("inf")
                    else:
                        g._data[0, 0] = float("inf")
        grads = [float(abs(p.grad().asnumpy()).sum())
                 for p in net.collect_params().values()]
        before = {k: p.data().asnumpy() if pkg is mx else
                  p.data().detach().numpy().copy()
                  for k, p in net.collect_params().items()}
        tr.step(8)
        after = {k: p.data().asnumpy() if pkg is mx else
                 p.data().detach().numpy().copy()
                 for k, p in net.collect_params().items()}
        rows.append((float(loss.mean().asnumpy()),
                     tr._amp_loss_scaler.loss_scale,
                     tr._amp_loss_scaler._unskipped, grads,
                     all(onp.array_equal(before[k], after[k])
                         for k in before), after))
    am.reset()
    return rows


def test_scale_loss_overflow_zeroes_gradients_like_the_reference():
    """An inf in a gradient inside ``scale_loss`` (on the first step, when
    the momentum is still 0): the scale halves (2**16 → 2**15), the
    clean-step count resets, every gradient is zeroed and the step
    changes no weight; later steps count clean steps again.  Losses,
    scales and weights match the reference (bf16 tolerance)."""
    ref = _scaled_loop(mx, overflow_at=0)
    got = _scaled_loop(mt, overflow_at=0)
    assert [r[1:3] for r in got] == [r[1:3] for r in ref]
    assert got[0][1] == 2.0 ** 15 and got[0][2] == 0
    assert got[0][3] == [0.0] * 4 and got[0][4]     # zeroed, unchanged
    assert got[1][2] == 1
    for g, r in zip(got, ref):
        onp.testing.assert_allclose(g[0], r[0], rtol=2e-2)
        for k in r[5]:
            onp.testing.assert_allclose(g[5][k], r[5][k], rtol=2e-2,
                                        atol=2e-2 * abs(r[5][k]).max())


# -- SPMDTrainer under the policy ---------------------------------------------------

def _spmd_run(pkg, scale0=16.0, steps=4, overflow_at=2):
    net = _mlp(pkg)
    if pkg is mx:
        tr = JaxTrainer(net, jax_loss.SoftmaxCrossEntropyLoss(), "sgd",
                        {"learning_rate": 0.1, "momentum": 0.9},
                        mesh=make_mesh({"dp": 1},
                                       devices=jax.devices()[:1]))
    else:
        net(torch.zeros(1, 10))
        tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9},
                         device="cpu")
    tr._amp_scaler.loss_scale = scale0
    rows = []
    for i in range(steps):
        x = X.copy()
        if i == overflow_at:
            x[0, 0] = onp.inf
        loss = tr.step(NDArray(x), NDArray(Y)) if pkg is mx else \
            tr.step(x, Y)
        loss = float(loss.asnumpy()) if pkg is mx else float(loss)
        params = ({k: p.data().asnumpy()
                   for k, p in net.collect_params().items()}
                  if pkg is mx else convert.collected_params_to_numpy(net))
        rows.append((loss, tr._amp_scaler.loss_scale,
                     tr._amp_scaler._unskipped, params))
    return tr, rows


def test_spmd_trainer_under_amp_matches_reference(monkeypatch):
    """``MXNET_AMP=1``: the compute dtype comes from the policy (bf16),
    the initial scale is 1.0 (set to 16 here so that an overflow shows);
    four steps with an inf in the data at the third: the masters are
    unchanged by it, the scale halves to 8, the clean-step count resets,
    one update is skipped; losses and masters follow the reference."""
    from mxnet_tpu_torch import telemetry
    monkeypatch.setenv("MXNET_AMP", "1")
    jtr, ref = _spmd_run(mx)
    skipped0 = telemetry.counter("amp.skipped_updates").value
    ptr, got = _spmd_run(mt)
    assert ptr.amp_dtype == torch.bfloat16
    assert SPMDTrainer(_mlp(mt), gloss.SoftmaxCrossEntropyLoss(),
                       device="cpu")._amp_scaler.loss_scale == 1.0
    assert [r[1:3] for r in got] == [r[1:3] for r in ref]
    assert [r[1] for r in got] == [16.0, 16.0, 8.0, 8.0]
    assert telemetry.counter("amp.skipped_updates").value - skipped0 == 1
    for k in got[1][3]:
        assert onp.array_equal(got[2][3][k], got[1][3][k])   # skipped
    for i, (g, r) in enumerate(zip(got, ref)):
        if i != 2:                         # the overflowing loss is NaN
            onp.testing.assert_allclose(g[0], r[0], rtol=2e-2)
        for k in r[3]:
            err = onp.linalg.norm(g[3][k] - r[3][k])
            assert err <= 2e-2 * onp.linalg.norm(r[3][k]), (i, k)


def test_spmd_trainer_amp_state_lives_on_the_device(monkeypatch):
    """The scale and the clean-step count are tensors the step updates in
    place; a scale set on the host is written into them before the next
    step; ``run_steps`` counts the window's skipped steps."""
    monkeypatch.setenv("MXNET_AMP", "1")
    net = _mlp(mt)
    net(torch.zeros(1, 10))
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
                     {"learning_rate": 0.1}, device="cpu")
    scale, good, skipped = tr._amp_state
    tr.step(X, Y)
    assert float(scale) == 1.0 and float(good) == 1.0
    tr._amp_scaler.loss_scale = 32.0
    xs = onp.stack([X, X, X])
    xs[1, 0, 0] = onp.nan
    tr.run_steps(xs, onp.stack([Y] * 3), 3, per_step_data=True)
    assert tr._amp_state[0] is scale
    assert float(scale) == 16.0 and float(good) == 1.0
    assert float(skipped) == 1.0
    assert tr._amp_scaler.loss_scale == 16.0
