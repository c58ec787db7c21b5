"""The eager Gluon loop — ``autograd.record()``, ``backward``,
``gluon.Trainer.step`` — in the port against the reference's, on the same
weights (carried by ``convert.load_collected_params``) and the same
numpy batches on the CPU.  The reference's loop runs with
``MXNET_CACHED_STEP=0`` (its eager step, which its own contract makes
bitwise equal to the captured one).

Tolerances: ResNet-18 v1 thumbnail with SGD momentum, three steps on a
(2, 3, 32, 32) batch, fp32: losses rtol 1e-4, every weight, momentum and
running statistic within 3e-4 of its norm in L2 (BatchNorm's backward
amplifies rounding in a channel of small batch variance, as in
``test_torch_resnet.py``); the 2-layer transformer (dim 64) with Adam:
losses rtol 1e-5, weights and Adam's m and v rtol 1e-4 (atol 1e-6); the
small MLPs of the option tests rtol 1e-5 (atol 1e-6).  Within the port,
the kvstore choices and the update paths agree bitwise."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
from mxnet_tpu_torch.gluon.model_zoo import vision


@pytest.fixture(autouse=True)
def _eager_reference(monkeypatch):
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _ref_loop(net, loss_fn, x, y, opt, opt_params, steps=3, **trainer_kw):
    tr = mx.gluon.Trainer(net.collect_params(), opt, dict(opt_params),
                          **trainer_kw)
    losses = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x)), mx.nd.array(y))
        loss.backward()
        tr.step(x.shape[0])
        losses.append(float(loss.mean().asnumpy()))
    return tr, losses


def _port_loop(net, loss_fn, x, y, opt, opt_params, steps=3, **trainer_kw):
    tr = mt.gluon.Trainer(net.collect_params(), opt, dict(opt_params),
                          **trainer_kw)
    losses = []
    xs, ys = (mt.nd.array(a, ctx=mt.cpu(), dtype=a.dtype) for a in (x, y))
    for _ in range(steps):
        with mt.autograd.record():
            loss = loss_fn(net(xs), ys)
        loss.backward()
        tr.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return tr, losses


def _ref_states(tr):
    return {i: [s.asnumpy() for s in st]
            for i, st in tr._updaters[0].states.items()}


def _port_states(tr):
    return {i: [s._data.float().numpy() for s in st]
            for i, st in tr._updaters[0].states.items()}


def _l2_within(got, want, truth, tol):
    """Each of ``got`` no farther from ``want`` (in L2) than twice
    ``want``'s own distance from ``truth``, plus ``tol`` of its norm."""
    for k in want:
        g, w, t = (onp.asarray(d[k], onp.float64) for d in (got, want,
                                                             truth))
        err, own = onp.linalg.norm(g - w), onp.linalg.norm(w - t)
        assert err <= 2 * own + tol * onp.linalg.norm(w), (k, err, own)


def _l2_close(got, want, tol):
    for k in want:
        g, w = onp.asarray(got[k]), onp.asarray(want[k])
        err = onp.linalg.norm(g - w)
        assert err <= tol * max(onp.linalg.norm(w), 1e-12), (
            k, err / max(onp.linalg.norm(w), 1e-12))


# -- ResNet-18 with SGD momentum ----------------------------------------------

RESNET_X = onp.random.RandomState(0).standard_normal(
    (2, 3, 32, 32)).astype(onp.float32)
RESNET_Y = onp.array([3, 7], onp.float32)
RESNET_SGD = {"learning_rate": 0.005, "momentum": 0.9, "wd": 1e-4}


def _port_resnet(init, dtype="float32"):
    net = vision.get_resnet(1, 18, classes=10, thumbnail=True)
    convert.load_collected_params(net, init, device="cpu")
    if dtype != "float32":
        net.cast(dtype)
    x = RESNET_X.astype(dtype)
    ptr, losses = _port_loop(net, gloss.SoftmaxCrossEntropyLoss(), x,
                             RESNET_Y, "sgd", RESNET_SGD)
    states = {i: s[0].astype(onp.float64)
              for i, s in _port_states(ptr).items()}
    params = {k: p.data().detach().double().numpy()
              for k, p in net.collect_params().items()}
    return onp.asarray(losses), params, states


def test_resnet18_eager_loop_matches_reference():
    """Three recorded steps of ResNet-18 v1 thumbnail (10 classes) on two
    32x32 images, fp32: losses, every weight and running statistic (each
    BatchNorm's written eagerly in training mode) and every momentum.

    With two images a channel's batch statistics come from 32 elements in
    the last stage, and the reference's f32 gradients there lie ~1% (in
    L2) from the same net's f64 ones, where the port's lie 3e-6 away
    (measured on this input).  So: the first loss at rtol 1e-5 and the
    three at 1e-2; every tensor no farther from the reference's than
    twice the reference's own distance from the port's f64 run of the
    same steps, plus 1e-3 of its norm (in L2); and the port's f32 run
    within 3e-4 of that f64 run (L2; losses rtol 1e-4)."""
    mx.random.seed(1)
    jnet = jax_vision.get_resnet(1, 18, classes=10, thumbnail=True)
    jnet.initialize(init=mx.initializer.Xavier())
    jnet(mx.nd.array(onp.zeros((1, 3, 32, 32), onp.float32)))
    init = _params(jnet)
    jtr, want_l = _ref_loop(jnet, jax_loss.SoftmaxCrossEntropyLoss(),
                            RESNET_X, RESNET_Y, "sgd", RESNET_SGD)
    want_p, want_s = _params(jnet), {i: s[0] for i, s in
                                     _ref_states(jtr).items()}
    got_l, got_p, got_s = _port_resnet(init)
    f64_l, f64_p, f64_s = _port_resnet(init, "float64")
    onp.testing.assert_allclose(got_l[0], want_l[0], rtol=1e-5)
    onp.testing.assert_allclose(got_l, want_l, rtol=1e-2)
    onp.testing.assert_allclose(got_l, f64_l, rtol=1e-4)
    assert got_l[-1] < got_l[0]
    _l2_within(got_p, want_p, f64_p, 1e-3)
    _l2_close(got_p, f64_p, 3e-4)
    assert sorted(got_s) == sorted(want_s)
    _l2_within(got_s, want_s, f64_s, 1e-3)
    _l2_close(got_s, f64_s, 3e-4)
    moved = [k for k in want_p if k.endswith("running_mean")
             and not onp.array_equal(got_p[k], init[k])]
    assert len(moved) == 19                    # every BatchNorm's


# -- the transformer with Adam --------------------------------------------------

def test_transformer_eager_loop_matches_reference():
    """Three recorded steps of a 2-layer TransformerLM (dim 64, 4 heads,
    tied head; flash attention in both: the reference's Pallas kernels in
    interpret mode, the port's plain versions on the CPU) with Adam, whose
    eager update folds the bias correction into lr: losses (rtol 1e-5),
    each weight's movement from its start (L2, 1e-3 of its norm) and
    Adam's m and v (rtol 1e-4, atol 1e-6).  The qkv biases get 2e-2: the
    key part has no gradient (softmax over the keys ignores it), so its
    gradient is rounding noise that Adam's normalisation turns into steps
    of size lr; the reference's and the port's f32 runs each lie ~0.6%
    of that movement from an f64 run (measured)."""
    vocab, cfg = 50, dict(units=64, num_layers=2, num_heads=4, max_len=32,
                          tie_weights=True)
    rng = onp.random.RandomState(1)
    x = rng.randint(0, vocab, size=(2, 16)).astype(onp.int32)
    y = rng.randint(0, vocab, size=(2, 16)).astype(onp.int32)
    adam = {"learning_rate": 1e-3}
    jnet = JaxLM(vocab, **cfg)
    jnet.initialize(init=mx.initializer.Xavier())
    jnet(mx.nd.array(onp.zeros((1, 8), onp.int32)))
    init = _params(jnet)
    jtr, want_l = _ref_loop(jnet, jax_loss.SoftmaxCrossEntropyLoss(), x, y,
                            "adam", adam)
    pnet = TransformerLM(vocab, **cfg)
    convert.load_collected_params(pnet, init, device="cpu")
    ptr, got_l = _port_loop(pnet, gloss.SoftmaxCrossEntropyLoss(), x, y,
                            "adam", adam)
    onp.testing.assert_allclose(got_l, want_l, rtol=1e-5)
    assert got_l[-1] < got_l[0]
    got_p, want_p = convert.collected_params_to_numpy(pnet), _params(jnet)
    for k in want_p:
        moved = onp.linalg.norm(want_p[k] - init[k])
        tol = 2e-2 if k.endswith("attn.qkv.bias") else 1e-3
        assert onp.linalg.norm(got_p[k] - want_p[k]) <= tol * moved, k
    gs, ws = _port_states(ptr), _ref_states(jtr)
    for i in ws:
        for a, b in zip(gs[i], ws[i]):
            onp.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


# -- the options, on a small MLP -----------------------------------------------

RNG = onp.random.RandomState(2)
X = RNG.randn(8, 10).astype(onp.float32)
Y = (onp.arange(8) % 4).astype(onp.float32)
W1 = (RNG.randn(16, 10) * 0.3).astype(onp.float32)
B1 = (RNG.randn(16) * 0.1).astype(onp.float32)
W2 = (RNG.randn(4, 16) * 0.3).astype(onp.float32)
B2 = (RNG.randn(4) * 0.1).astype(onp.float32)
MLP_INIT = {"0.weight": W1, "0.bias": B1, "1.weight": W2, "1.bias": B2}


def _mlp(pkg, grad_req="write"):
    if pkg is mx:
        net = jax_nn.HybridSequential()
        net.add(jax_nn.Dense(16, activation="relu", in_units=10),
                jax_nn.Dense(4, in_units=16))
        net.initialize()
        if grad_req != "write":
            for p in net.collect_params().values():
                p.grad_req = grad_req
                p._init_grad()
        for k, p in net.collect_params().items():
            p.set_data(mx.nd.array(MLP_INIT[k]))
        return net
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=10),
            nn.Dense(4, in_units=16))
    for p in net.collect_params().values():
        p.grad_req = grad_req
    convert.load_collected_params(net, MLP_INIT, device="cpu")
    return net


def _mlp_run(pkg, opt="sgd", opt_params=None, steps=3, **kw):
    opt_params = opt_params or {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 0.01}
    net = _mlp(pkg)
    loop = _ref_loop if pkg is mx else _port_loop
    lf = (jax_loss if pkg is mx else gloss).SoftmaxCrossEntropyLoss()
    tr, losses = loop(net, lf, X, Y, opt, opt_params, steps=steps, **kw)
    params = _params(net) if pkg is mx else \
        convert.collected_params_to_numpy(net)
    return tr, losses, params, net


def _assert_runs_close(got, want):
    onp.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    for k in want[2]:
        onp.testing.assert_allclose(got[2][k], want[2][k], rtol=1e-5,
                                    atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kvstore", [None, "device", "local"])
def test_kvstore_choices_match_reference(kvstore):
    _assert_runs_close(_mlp_run(mt, kvstore=kvstore),
                       _mlp_run(mx, kvstore=kvstore))


@pytest.mark.parametrize("fused", ["1", "0"])
def test_kvstore_choices_are_identical_in_the_port(fused, monkeypatch):
    """None, "device" and "local" give the same bits: with the fused step
    on, the single-process reduction folds away; off, the store's
    pushpull of one value a key is an identity."""
    monkeypatch.setenv("MXNET_FUSED_STEP", fused)
    runs = [_mlp_run(mt, kvstore=kv) for kv in (None, "device", "local")]
    for other in runs[1:]:
        assert other[1] == runs[0][1]
        for k in runs[0][2]:
            assert onp.array_equal(other[2][k], runs[0][2][k])


@pytest.mark.parametrize("fused", ["1", "0"])
def test_update_on_kvstore(fused, monkeypatch):
    """The store runs the optimizer on its copy of each weight and the
    parameters pull the result (``update_on_kvstore=True``, and through
    ``MXNET_UPDATE_ON_KVSTORE=1``): the reference's numbers, and the bits
    of the local update."""
    monkeypatch.setenv("MXNET_FUSED_STEP", fused)
    local = _mlp_run(mt)
    on_store = _mlp_run(mt, update_on_kvstore=True)
    assert on_store[0]._update_on_kvstore
    _assert_runs_close(on_store, _mlp_run(mx, update_on_kvstore=True))
    for k in local[2]:
        assert onp.array_equal(on_store[2][k], local[2][k])
    monkeypatch.setenv("MXNET_UPDATE_ON_KVSTORE", "1")
    env = _mlp_run(mt)
    assert env[0]._update_on_kvstore
    for k in local[2]:
        assert onp.array_equal(env[2][k], local[2][k])


def test_aggregate_num_matches_reference(monkeypatch):
    """With the fused step off, ``aggregate_num=2`` updates two parameters
    a call (``Updater.update_multi``): the reference's numbers, and the
    per-parameter path's bits."""
    monkeypatch.setenv("MXNET_FUSED_STEP", "0")
    params = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
              "aggregate_num": 2}
    from mxnet_tpu_torch.optimizer import optimizer as popt
    n0 = popt.dispatch_count()
    agg = _mlp_run(mt, opt_params=params)
    assert popt.dispatch_count() - n0 == 3 * 2      # 2 calls a step
    _assert_runs_close(agg, _mlp_run(mx, opt_params=params))
    plain = _mlp_run(mt)
    for k in plain[2]:
        assert onp.array_equal(agg[2][k], plain[2][k])


@pytest.mark.parametrize("pkg", [mx, mt], ids=["reference", "port"])
def test_stale_gradient(pkg):
    """A parameter made trainable after it was initialized has no
    gradient buffer: ``step`` raises "parameter ... has no gradient"
    unless ``ignore_stale_grad``, which skips it; the others update."""
    net = _mlp(pkg)
    bias = net.collect_params()["1.bias"]
    bias.grad_req = "null"
    bias._grad = None
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    bias.grad_req = "write"
    lf = (jax_loss if pkg is mx else gloss).SoftmaxCrossEntropyLoss()
    ctx = {} if pkg is mx else {"ctx": mt.cpu()}
    x, y = pkg.nd.array(X, **ctx), pkg.nd.array(Y, **ctx)
    with pkg.autograd.record():
        loss = lf(net(x), y)
    loss.backward()
    with pytest.raises(Exception, match="has no gradient"):
        tr.step(8)
    before = bias.data().asnumpy() if pkg is mx else \
        bias.data().detach().numpy().copy()
    tr.step(8, ignore_stale_grad=True)
    after = bias.data().asnumpy() if pkg is mx else \
        bias.data().detach().numpy()
    assert onp.array_equal(before, after)


def test_grad_req_add_accumulates_like_the_reference():
    """``grad_req="add"``: two recorded backward passes add into the
    buffers; the gradients, then one step from them, and ``zero_grad``."""
    out = []
    for pkg in (mx, mt):
        net = _mlp(pkg, grad_req="add")
        lf = (jax_loss if pkg is mx else gloss).SoftmaxCrossEntropyLoss()
        ctx = {} if pkg is mx else {"ctx": mt.cpu()}
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        for half in (slice(0, 4), slice(4, 8)):
            with pkg.autograd.record():
                loss = lf(net(pkg.nd.array(X[half], **ctx)),
                          pkg.nd.array(Y[half], **ctx))
            loss.backward()
        grads = {k: p.grad().asnumpy()
                 for k, p in net.collect_params().items()}
        tr.step(8)
        weights = _params(net) if pkg is mx else \
            convert.collected_params_to_numpy(net)
        net.collect_params().zero_grad()
        zeros = [float(abs(p.grad().asnumpy()).sum())
                 for p in net.collect_params().values()]
        out.append((grads, weights, zeros))
    (rg, rw, rz), (pg, pw, pz) = out
    for k in rg:
        onp.testing.assert_allclose(pg[k], rg[k], rtol=1e-5, atol=1e-7)
        onp.testing.assert_allclose(pw[k], rw[k], rtol=1e-5, atol=1e-7)
    assert rz == pz == [0.0] * 4


def test_set_learning_rate_and_a_scheduler():
    """``set_learning_rate`` between steps, and a trainer whose optimizer
    has a multi-factor schedule (whose base lr the optimizer's
    ``learning_rate`` sets): ``trainer.learning_rate`` after each step
    and the weights match the reference."""
    import mxnet_tpu.lr_scheduler as jsched
    import mxnet_tpu_torch.lr_scheduler as psched
    for pkg, sched in ((mx, jsched), (mt, psched)):
        with pytest.raises(Exception, match="already been defined"):
            pkg.gluon.Trainer(
                _mlp(pkg).collect_params(), "sgd",
                {"lr_scheduler": sched.FactorScheduler(2)}
            ).set_learning_rate(0.1)
    runs = []
    for pkg, sched in ((mx, jsched), (mt, psched)):
        net = _mlp(pkg)
        lf = (jax_loss if pkg is mx else gloss).SoftmaxCrossEntropyLoss()
        ctx = {} if pkg is mx else {"ctx": mt.cpu()}
        x, y = pkg.nd.array(X, **ctx), pkg.nd.array(Y, **ctx)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.5})
        tr2 = pkg.gluon.Trainer(
            net.collect_params(), "adam",
            {"learning_rate": 0.02, "lr_scheduler":
             sched.MultiFactorScheduler(step=[2, 4], factor=0.5)})
        lrs = []
        for i in range(6):
            t = tr if i < 3 else tr2
            if i == 1:
                tr.set_learning_rate(0.05)
            with pkg.autograd.record():
                loss = lf(net(x), y)
            loss.backward()
            t.step(8)
            lrs.append(t.learning_rate)
        runs.append((lrs, _params(net) if pkg is mx else
                     convert.collected_params_to_numpy(net)))
    assert runs[1][0] == runs[0][0]
    for k in runs[0][1]:
        onp.testing.assert_allclose(runs[1][1][k], runs[0][1][k],
                                    rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
def test_states_cross_between_the_packages(direction, tmp_path):
    """Three Adam steps in both packages from the same weights; one
    package's ``save_states`` is loaded by the other's trainer (its own
    states replaced), then three more steps in both: losses and weights
    follow each other (rtol 1e-5)."""
    adam = {"learning_rate": 0.01}
    ref = _mlp_run(mx, "adam", adam)
    port = _mlp_run(mt, "adam", adam)
    f = str(tmp_path / "states")
    if direction == "reference->port":
        ref[0].save_states(f)
        port[0].load_states(f)
    else:
        port[0].save_states(f)
        ref[0].load_states(f)
    assert sorted(port[0]._updaters[0].states) == \
        sorted(ref[0]._updaters[0].states)
    runs = []
    for pkg, (tr, _, _, net) in ((mx, ref), (mt, port)):
        lf = (jax_loss if pkg is mx else gloss).SoftmaxCrossEntropyLoss()
        ctx = {} if pkg is mx else {"ctx": mt.cpu()}
        x, y = pkg.nd.array(X, **ctx), pkg.nd.array(Y, **ctx)
        losses = []
        for _ in range(3):
            with pkg.autograd.record():
                loss = lf(net(x), y)
            loss.backward()
            tr.step(8)
            losses.append(float(loss.mean().asnumpy()))
        runs.append((losses, _params(net) if pkg is mx else
                     convert.collected_params_to_numpy(net)))
    onp.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for k in runs[0][1]:
        onp.testing.assert_allclose(runs[1][1][k], runs[0][1][k],
                                    rtol=1e-5, atol=1e-6)


def test_trainer_refuses_what_is_not_ported():
    net = _mlp(mt)
    with pytest.raises(MXNetError, match="not ported yet"):
        mt.gluon.Trainer(net.collect_params(), "sgd", zero=1)
    with pytest.raises(MXNetError, match="not ported yet"):
        mt.gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_sync"
                         ).step(1)
    with pytest.raises(MXNetError, match="not ported yet"):
        mt.kvstore.create("horovod")


def test_step_emits_its_spans_and_one_record():
    """``step`` nests ``step.allreduce``/``step.update`` (or the fused
    update) under ``step.gluon`` and hands one telemetry record a step
    to a sink."""
    from mxnet_tpu_torch import telemetry, tracing
    records = []

    class Sink:
        def emit(self, r):
            records.append(r)

    sink = Sink()
    telemetry.add_sink(sink)
    tracing.enable()
    try:
        _mlp_run(mt, steps=2)
    finally:
        tracing.disable()
        telemetry.remove_sink(sink)
    names = [e["name"] for e in tracing.recent(50)]
    assert names.count("step.gluon") == 2
    assert "step.fused_update" in names
    assert [r["source"] for r in records] == ["gluon.Trainer"] * 2


# -- the bridge's pieces ---------------------------------------------------------

def test_record_train_mode_drives_the_layers():
    """``record()`` trains: BatchNorm normalises with the batch and writes
    its running statistics, Dropout drops; ``record(train_mode=False)``
    uses the running statistics, writes nothing and keeps every element,
    as in the reference (outputs rtol 1e-5)."""
    rng = onp.random.RandomState(5)
    x = (rng.randn(4, 3, 5, 5) * 2 + 1).astype(onp.float32)
    outs = []
    for pkg in (mx, mt):
        bn = (jax_nn if pkg is mx else nn).BatchNorm(in_channels=3)
        if pkg is mx:
            bn.initialize()
        else:
            bn.initialize(device="cpu")
        ctx = {} if pkg is mx else {"ctx": mt.cpu()}
        xs = pkg.nd.array(x, **ctx)
        row = []
        for train in (False, True):
            with pkg.autograd.record(train_mode=train):
                y = bn(xs)
            row.append((y.asnumpy(), bn.running_mean.data().asnumpy()
                        if pkg is mx else
                        bn.running_mean.data().detach().numpy().copy()))
        outs.append(row)
    for (ry, rm), (gy, gm) in zip(*outs):
        onp.testing.assert_allclose(gy, ry, rtol=1e-5, atol=1e-5)
        onp.testing.assert_allclose(gm, rm, rtol=1e-5, atol=1e-6)
    assert onp.all(outs[1][0][1] == 0) and onp.any(outs[1][1][1] != 0)
    drop = nn.Dropout(0.5)
    ones = mt.nd.array(onp.ones((64, 64), onp.float32), ctx=mt.cpu())
    with mt.autograd.record(train_mode=False):
        assert float(drop(ones).asnumpy().min()) == 1.0
    with mt.autograd.record():
        assert float(drop(ones).asnumpy().min()) == 0.0


class _Pair(nn.HybridSequential):
    """A block returning nested outputs."""

    def forward(self, x):
        y = super().forward(x)
        return y, [y * 2, (y.sum(),)]


def test_block_wraps_nested_outputs_and_leaves_tensors_alone():
    """NDArrays in: every tensor of a nested output comes back an NDArray,
    recorded (``backward`` through one of them reaches the weight);
    tensors in: tensors out."""
    net = _Pair()
    net.add(nn.Dense(3, in_units=4))
    net.initialize(device="cpu")
    x = onp.random.RandomState(6).randn(2, 4).astype(onp.float32)
    with mt.autograd.record():
        a, (b, (c,)) = net(mt.nd.array(x, ctx=mt.cpu()))
    assert all(isinstance(v, mt.nd.NDArray) for v in (a, b, c))
    c.backward()
    g = net[0].weight.grad().asnumpy()
    onp.testing.assert_allclose(g, onp.tile(x.sum(0), (3, 1)), rtol=1e-6)
    t, (u, (v,)) = net(torch.from_numpy(x))     # tensors in, tensors out
    assert all(type(o) is torch.Tensor for o in (t, u, v))


def test_cast_and_set_data_keep_the_variable():
    """``data()`` is the tensor the variable ``_data_nd()`` wraps, before
    and after ``set_data`` (in place) and ``cast`` (a new variable with a
    buffer of the new type); ``grad_req="null"`` has no buffer."""
    d = nn.Dense(2, in_units=3)
    d.initialize(device="cpu")
    w = d.weight
    assert w._data_nd()._data is w.data()
    before = w.data()
    w.set_data(onp.ones((2, 3), onp.float32))
    assert w.data() is before and w._data_nd()._data is before
    w.cast("float64")
    assert w._data_nd()._data is w.data()
    assert w.grad()._data.dtype == torch.float64
    x = mt.nd.array(onp.ones((1, 3)), ctx=mt.cpu(), dtype="float64")
    d.bias.cast("float64")
    with mt.autograd.record():
        y = d(x)
    y.backward()
    onp.testing.assert_array_equal(w.grad().asnumpy(), onp.ones((2, 3)))
    p = mt.gluon.Parameter("s", grad_req="null", shape=(2,))
    p.initialize(device="cpu")
    with pytest.raises(MXNetError, match="grad_req is 'null'"):
        p.grad()


def test_local_kvstore_matches_reference(tmp_path):
    """``init``, ``push`` of a list (its sum), ``pull``, ``pushpull``,
    ``broadcast``, an optimizer on the store and its saved states, in
    both packages (rtol 1e-6)."""
    rng = onp.random.RandomState(7)
    a, b, w = (rng.randn(3, 4).astype(onp.float32) for _ in range(3))
    outs = []
    for pkg in (mx, mt):
        ctx = {} if pkg is mx else {"ctx": mt.cpu()}

        def arr(v):
            return pkg.nd.array(v, **ctx)

        kv = pkg.kvstore.create("local")
        kv.init("k", arr(w))
        o = arr(onp.zeros((3, 4), onp.float32))
        kv.pull("k", out=o)
        row = [o.asnumpy()]
        kv.push("k", [arr(a), arr(b)])
        kv.pull("k", out=o)
        row.append(o.asnumpy())
        kv.pushpull("k", arr(a), out=o)
        row.append(o.asnumpy())
        kv.broadcast("b", arr(b), out=o)
        row.append(o.asnumpy())
        kv.set_optimizer(pkg.optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9))
        kv.init("0", arr(w))
        for g in (a, b):
            kv.push("0", arr(g))
        kv.pull("0", out=o)
        row.append(o.asnumpy())
        f = str(tmp_path / f"kv_{'ref' if pkg is mx else 'port'}")
        kv.save_optimizer_states(f)
        kv.load_optimizer_states(f)
        kv.push("0", arr(a))
        kv.pull("0", out=o)
        row.append(o.asnumpy())
        outs.append(row)
    for g, r in zip(outs[1], outs[0]):
        onp.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-7)
