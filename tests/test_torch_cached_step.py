"""The whole-step capture of the eager Gluon loop
(``mxnet_tpu_torch/imperative/cached_step.py``) against the reference's
(``mxnet_tpu/imperative/cached_step.py``) on the CPU: the same nets (the
reference's own 4-Dense net of width 4, a 2-layer transformer of width
32, a thumbnail ResNet with BatchNorm), the same weights and the same
numpy batches through both packages, and each case of the reference's
fallback matrix (``tests/test_cached_step.py``, ``tests/test_amp.py:
207-303``) held against the reference's own outcome: captured, declined
or broken, the trainer's state and ``last_reason``, and which steps ran
as one dispatch.

Numerics: within the port a captured step is bitwise the
``MXNET_CACHED_STEP=0`` step (weights and optimizer states); the port's
captured weights and states lie within 1e-6 of the reference's captured
ones (the reference's own bound, ``tests/test_cached_step.py:144-153``).
On the CPU an ``Executable`` runs its function on its static inputs (no
graph), so these tests check the capture's logic; ``chip_smoke.py``'s
``gluon_capture`` checks the graphs on the card.

One case is pinned as a reference behaviour the port does not copy:
``amp.scale_loss`` inside ``record()`` under the cached step raises in
the reference ("a deferred array escaped its captured step") and breaks
in the port, which then equals its eager step."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import amp as jax_amp
from mxnet_tpu.amp.loss_scaler import LossScaler as JaxScaler
from mxnet_tpu.base import MXNetError as JaxError
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu.imperative import cached_step as ref_cs
from mxnet_tpu.ops import registry as ref_registry

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import amp, convert
from mxnet_tpu_torch.amp.loss_scaler import LossScaler
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.imperative import cached_step as port_cs
from mxnet_tpu_torch.ops import registry as port_registry

CS = {mx: ref_cs, mt: port_cs}
X8 = onp.random.RandomState(1).randn(8, 4).astype(onp.float32)
X4 = onp.random.RandomState(2).randn(4, 4).astype(onp.float32)
STATE_KEYS = ("captures", "breaks", "disabled", "armed", "last_reason")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MXNET_CACHED_STEP", raising=False)
    yield
    amp.reset()
    jax_amp.reset()
    # a trainer armed on this thread must not defer the next test's step
    for cs in CS.values():
        cs._t().armed = None


def _dense_init(n_layers=4, units=4):
    """The reference's ``_make_net`` weights (seed 0), by name."""
    mx.random.seed(0)
    onp.random.seed(0)
    net = _dense(mx, n_layers, units)
    net.initialize()
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _dense(pkg, n_layers=4, units=4):
    net = pkg.gluon.nn.Sequential()
    for _ in range(n_layers):
        net.add(pkg.gluon.nn.Dense(units, in_units=units, activation="relu"))
    net.add(pkg.gluon.nn.Dense(1, in_units=units))
    return net


DENSE = _dense_init()


def _load(pkg, net, init):
    if pkg is mx:
        net.initialize()
        for k, p in net.collect_params().items():
            p.set_data(mx.nd.array(init[k]))
    else:
        convert.load_collected_params(net, init, device="cpu")
    return net


def _nd(pkg, a):
    if pkg is mx:
        return mx.nd.array(a, dtype=a.dtype)
    return mt.nd.array(a, ctx=mt.cpu(), dtype=a.dtype)


def _snapshot(net, trainer):
    """Copies of every weight and optimizer state (f32 in these tests)."""
    weights = {k: p.data().asnumpy().copy()
               for k, p in net.collect_params().items()}
    states = {i: [onp.asarray(s.asnumpy()).copy() for s in st]
              for i, st in trainer._updaters[0].states.items()}
    return weights, states


def _train(pkg, opt="sgd", opt_args=None, steps=6, net=None, init=DENSE,
           hybridize=False, loss_fn=None, batches=None, post_backward=None,
           trainer_kw=None, scaler=None):
    """``steps`` of record -> backward -> step; returns the run's
    per-step dispatch deltas, losses, trainer state and snapshot."""
    if net is None:
        net = _load(pkg, _dense(pkg), init)
    if hybridize:
        net.hybridize()
    kw = {"kvstore": None}
    kw.update(trainer_kw or {})
    tr = pkg.gluon.Trainer(net.collect_params(), opt,
                           dict(opt_args or {"learning_rate": 0.1}), **kw)
    if scaler is not None:
        tr._amp_loss_scaler = scaler
    xs = [_nd(pkg, b) for b in (batches or [X8] * steps)]
    counter = pkg.telemetry.counter("dispatch.count")
    deltas, losses = [], []
    for i, x in enumerate(xs):
        d0 = counter.value
        with pkg.autograd.record():
            y = net(x)
            loss = loss_fn(y, i) if loss_fn else (y * y).sum()
        loss.backward()
        if post_backward:
            post_backward(loss, i)
        tr.step(batch_size=x.shape[0])
        deltas.append(counter.value - d0)
        losses.append(float(loss.asnumpy().mean()))
    state = CS[pkg].trainer_state(tr)
    return {"deltas": deltas, "losses": losses, "state": state,
            "snap": _snapshot(net, tr), "net": net, "trainer": tr}


def _outcome(run):
    return {k: run["state"][k] for k in STATE_KEYS}


def _single(run):
    """Which steps ran as exactly one dispatch."""
    return [d == 1 for d in run["deltas"]]


def _assert_snap(a, b, tol=0.0):
    (wa, sa), (wb, sb) = a, b
    assert wa.keys() == wb.keys()
    for k in wa:
        onp.testing.assert_allclose(wa[k], wb[k], rtol=0, atol=tol,
                                    err_msg=k)
    assert sa.keys() == sb.keys()
    for k in sa:
        for x, y in zip(sa[k], sb[k]):
            onp.testing.assert_allclose(x, y, rtol=0, atol=tol)


def _eager(monkeypatch, **kw):
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    try:
        return _train(mt, **kw)
    finally:
        monkeypatch.delenv("MXNET_CACHED_STEP")


# -- the steady state and the numerics ----------------------------------------

@pytest.mark.parametrize("opt,opt_args", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 1e-3, "wd": 1e-4}),
])
def test_captured_step_matches_reference_and_eager(monkeypatch, opt,
                                                   opt_args):
    """After the eager warm-up every step is one dispatch in both
    packages (the reference's [9, 1, 1, 1, 1, 1] reads [8, 1, ...] in the
    port, whose eager funnel counts each Dense layer as one call); the
    port's weights and states equal its MXNET_CACHED_STEP=0 run bitwise
    and the reference's captured run within 1e-6."""
    port_cs.reset_stats()
    ref = _train(mx, opt, opt_args)
    got = _train(mt, opt, opt_args)
    assert _single(got) == _single(ref) == [False] + [True] * 5
    assert _outcome(got) == _outcome(ref)
    assert port_cs.stats()["compiles"] == 1
    assert port_cs.stats()["hits"] == 4
    eager = _eager(monkeypatch, opt=opt, opt_args=opt_args)
    assert not any(_single(eager))
    _assert_snap(got["snap"], eager["snap"])
    _assert_snap(got["snap"], ref["snap"], 1e-6)
    onp.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-6)


def test_hybridized_net_captures(monkeypatch):
    """A hybridized net inside record() is one eager record, which the
    captured step takes into its graph, as the reference's cached-op
    record rides its cached step."""
    ref = _train(mx, hybridize=True)
    got = _train(mt, hybridize=True)
    assert _single(got) == _single(ref)
    assert _outcome(got) == _outcome(ref)
    assert got["state"]["captures"] == 1
    _assert_snap(got["snap"], _eager(monkeypatch, hybridize=True)["snap"])
    _assert_snap(got["snap"], ref["snap"], 1e-6)


def test_transformer_captures_bitwise(monkeypatch):
    """A 2-layer TransformerLM of width 32 (embedding, flash attention,
    LayerNorm, the tied head) with SoftmaxCrossEntropyLoss and Adam: one
    capture, then one dispatch a step, bitwise the eager step; the
    losses follow the reference's eager loop (rtol 1e-5)."""
    from mxnet_tpu.gluon import loss as jax_loss
    from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
    vocab, cfg = 40, dict(units=32, num_layers=2, num_heads=2, max_len=16,
                          tie_weights=True)
    rng = onp.random.RandomState(3)
    ids = rng.randint(0, vocab, size=(2, 8)).astype(onp.int32)
    labels = rng.randint(0, vocab, size=(2, 8)).astype(onp.int32)
    jnet = JaxLM(vocab, **cfg)
    jnet.initialize(init=mx.initializer.Xavier())
    jnet(mx.nd.array(onp.zeros((1, 8), onp.int32)))
    init = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    jtr = mx.gluon.Trainer(jnet.collect_params(), "adam",
                           {"learning_rate": 1e-3})
    jloss, want = jax_loss.SoftmaxCrossEntropyLoss(), []
    for _ in range(4):
        with mx.autograd.record():
            loss = jloss(jnet(mx.nd.array(ids)), mx.nd.array(labels))
        loss.backward()
        jtr.step(2)
        want.append(float(loss.mean().asnumpy()))
    monkeypatch.delenv("MXNET_CACHED_STEP")

    def run():
        net = TransformerLM(vocab, **cfg)
        convert.load_collected_params(net, init, device="cpu")
        lf = gloss.SoftmaxCrossEntropyLoss()
        return _train(mt, "adam", {"learning_rate": 1e-3}, net=net,
                      batches=[ids] * 4, trainer_kw={"kvstore": "device"},
                      loss_fn=lambda y, i: lf(y, _nd(mt, labels)))

    got = run()
    assert _single(got) == [False, True, True, True]
    assert got["state"]["captures"] == 1 and got["state"]["breaks"] == 0
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    eager = run()
    _assert_snap(got["snap"], eager["snap"])
    onp.testing.assert_allclose(got["losses"], want,
                                rtol=1e-5)


# -- the fallback matrix ---------------------------------------------------------

def _loss_flip(y, i):
    return (y * y).sum() if i % 2 == 0 else (y * y).sum() * 2.0


def _read_loss(loss, i):
    loss.asnumpy()


def _matrix_case(name):
    """(kwargs of _train, whether the final weights are compared with the
    eager run) for each case of the reference's fallback matrix."""
    return {
        "disabled_env": ({}, True),
        "shape_change": ({"batches": [X8, X4] * 4}, True),
        "control_flow_divergence": ({"loss_fn": _loss_flip}, True),
        "host_sync": ({"post_backward": _read_loss}, True),
        "kvstore_declines": ({"trainer_kw": {"kvstore": "local",
                                             "update_on_kvstore": True},
                              "steps": 3}, False),
    }[name]


@pytest.mark.parametrize("name", ["disabled_env", "shape_change",
                                  "control_flow_divergence", "host_sync",
                                  "kvstore_declines"])
def test_fallback_matrix_matches_reference(monkeypatch, name):
    """Each case gives the reference's outcome (trainer state, last
    reason, which steps were one dispatch) and, where the step runs, the
    eager step's weights."""
    kw, compare = _matrix_case(name)
    if name == "disabled_env":
        monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    ref = _train(mx, **kw)
    got = _train(mt, **kw)
    assert _outcome(got) == _outcome(ref), (got["state"], ref["state"])
    assert _single(got) == _single(ref)
    if name == "host_sync":
        assert got["state"]["last_reason"] == "host sync on a deferred array"
        assert not any(_single(got))
    if name == "shape_change":
        assert got["state"]["captures"] == 2
        assert _single(got)[-4:] == [True] * 4
    if name == "kvstore_declines":
        assert got["state"]["last_reason"] == \
            "kvstore configuration not capturable"
    if compare:
        monkeypatch.setenv("MXNET_CACHED_STEP", "0")
        eager = _train(mt, **kw)
        _assert_snap(got["snap"], eager["snap"])
        _assert_snap(got["snap"], ref["snap"], 1e-6)


def test_forward_hook_bypasses_capture():
    """A forward hook sees every step: capture declines with the
    reference's reason and the hook runs each step."""
    runs = {}
    for pkg in (mx, mt):
        calls = []
        net = _load(pkg, _dense(pkg), DENSE)
        net[0].register_forward_hook(lambda blk, args, out: calls.append(1))
        runs[pkg] = _train(pkg, net=net, steps=3)
        assert len(calls) == 3
    assert _outcome(runs[mt]) == _outcome(runs[mx])
    assert runs[mt]["state"]["last_reason"] == "forward hook attached"
    assert not any(_single(runs[mt]))


def _branchy(pkg):
    """A plain Block whose forward takes a branch on a Python attribute:
    ``squash`` puts a tanh between its two Dense layers."""
    nn = pkg.gluon.nn

    class Branchy(pkg.gluon.Block):
        def __init__(self):
            super().__init__()
            self.a = nn.Dense(4, in_units=4, activation="relu")
            self.act = nn.Activation("tanh")
            self.out = nn.Dense(1, in_units=4)
            self.squash = False

        def forward(self, x):
            h = self.a(x)
            if self.squash:
                h = self.act(h)
            return self.out(h)
    return Branchy()


def test_plain_block_branch_breaks_like_the_reference(monkeypatch):
    """A plain Block's forward runs at every step, deferred or not: a
    branch it takes on an attribute changed after the capture (from step
    3 on) is a divergence from the tape, as in the reference, which
    records a plain Block op by op.  The step breaks with the reference's
    reason, the new path is captured, and the weights equal the
    MXNET_CACHED_STEP=0 run's bitwise and the reference's within 1e-6."""
    mx.random.seed(0)
    jnet = _branchy(mx)
    jnet.initialize()
    init = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}

    def run(pkg):
        net = _load(pkg, _branchy(pkg), init)

        def squash_from_step_3(loss, i):
            net.squash = i >= 2
        return _train(pkg, net=net, post_backward=squash_from_step_3)

    ref, got = run(mx), run(mt)
    assert _outcome(got) == _outcome(ref), (got["state"], ref["state"])
    assert got["state"]["last_reason"] == "op divergence from captured tape"
    assert got["state"]["breaks"] == 1 and got["state"]["captures"] == 2
    assert _single(got) == _single(ref) == [False, True, True, False, True,
                                            True]
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    eager = run(mt)
    _assert_snap(got["snap"], eager["snap"])
    _assert_snap(got["snap"], ref["snap"], 1e-6)


def test_finished_steps_leave_no_reference_cycles():
    """Captured, breaking and eager steps leave no cyclic garbage that
    holds a tensor: a step's outputs (and so its autograd graph) go when
    the loop lets them go.  A graph kept until the cyclic collector runs
    holds the weights' gradient accumulators on the stream they were
    made on, and a CUDA graph capture meeting one fails."""
    import gc
    mx.random.seed(0)
    jnet = _branchy(mx)
    jnet.initialize()
    net = _load(mt, _branchy(mt),
                {k: p.data().asnumpy()
                 for k, p in jnet.collect_params().items()})
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=None)
    x = _nd(mt, X8)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        for i in range(6):
            net.squash = i >= 3
            with mt.autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            tr.step(8)
        del loss
        gc.collect()
        held = [type(o).__name__ for o in gc.garbage
                if isinstance(o, (torch.Tensor, mt.nd.NDArray))]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert port_cs.trainer_state(tr)["breaks"] == 1
    assert held == []


class _Gate(mt.gluon.HybridBlock):
    """A Dense layer scaled by the mean of a second argument."""

    def __init__(self):
        super().__init__()
        self.dense = mt.gluon.nn.Dense(1, in_units=4)

    def forward(self, x, w):
        return self.dense(x) * w.mean()


def _gate_run(monkeypatch, env):
    """6 captured-loop steps of a _Gate called with a raw tensor of 2000
    elements whose middle element changes every step (its repr does
    not)."""
    monkeypatch.setenv("MXNET_CACHED_STEP", env)
    net = _Gate()
    mt.random.seed(0)       # both runs start from the same weights
    net.initialize(ctx=mt.cpu())
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=None)
    x = _nd(mt, X8)
    for i in range(6):
        w = torch.ones(2000)
        w[1000] = 1.0 + 100.0 * i
        with mt.autograd.record():
            loss = (net(x, w) ** 2).sum()
        loss.backward()
        tr.step(8)
    return net, port_cs.trainer_state(tr)


def test_tensor_argument_is_an_input_of_the_record(monkeypatch):
    """A raw tensor passed beside the NDArrays is an input of the
    block's record, staged at every step: the captured steps see each
    step's values (a key made from its repr would replay the first
    step's), and the weights equal the MXNET_CACHED_STEP=0 run's."""
    got, state = _gate_run(monkeypatch, "1")
    assert state["captures"] == 1 and state["breaks"] == 0
    eager, _ = _gate_run(monkeypatch, "0")
    for k, p in got.collect_params().items():
        onp.testing.assert_array_equal(
            p.data().asnumpy(), eager.collect_params()[k].data().asnumpy())


def test_record_is_observed_only_while_a_trainer_may_capture(monkeypatch):
    """An outermost record() is observed (its calls added to a tape)
    only while a live gluon Trainer has not latched capture off: an
    ``mx.nd`` loop with no Trainer holds no tape."""
    import weakref
    monkeypatch.setattr(port_cs, "_TRAINERS", weakref.WeakSet())
    x = _nd(mt, X8)
    x.attach_grad()

    def observed():
        with mt.autograd.record():
            (x * x).sum().backward()
            return port_cs._t().obs is not None

    assert not observed()
    net = _load(mt, _dense(mt), DENSE)
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=None)
    assert observed()
    port_cs._state_of(tr).disabled = True
    assert not observed()


def test_loss_read_after_step_needs_no_break():
    """The captured step fills the loss's placeholder: reading it after
    step() is no break."""
    ref = _train(mx, steps=5)
    got = _train(mt, steps=5)
    assert got["state"]["breaks"] == ref["state"]["breaks"] == 0
    assert all(onp.isfinite(got["losses"]))
    onp.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-6)


def test_break_storm_latches_off(monkeypatch):
    """A host sync every step latches capture off after 4 *
    MXNET_JIT_MAX_SIGS breaks, in both packages."""
    monkeypatch.setattr(ref_registry, "_MAX_JIT_SIGS", 1)
    monkeypatch.setattr(port_registry, "_MAX_JIT_SIGS", 1)
    ref = _train(mx, steps=8, post_backward=_read_loss)
    got = _train(mt, steps=8, post_backward=_read_loss)
    assert got["state"]["disabled"] and ref["state"]["disabled"]
    assert _outcome(got) == _outcome(ref)


def test_batchnorm_breaks_every_step_with_eager_running_stats(monkeypatch):
    """A thumbnail ResNet with BatchNorm in training mode: the running
    statistics' write needs real values, so every deferred step breaks
    with the reference's reason (hybridized or not) and the running
    statistics are the eager run's, bitwise."""
    # the first values drawn by the port (Xavier, seed 1): the
    # reference's net takes them by set_data, without an initialisation
    # of its own, whose deferred forward would compile op by op
    mt.random.seed(1)
    pnet = vision.get_resnet(1, 18, classes=10, thumbnail=True)
    pnet.initialize(init=mt.initializer.Xavier(), device="cpu")
    with torch.no_grad():
        pnet(torch.zeros((1, 3, 32, 32)))
    init = {k: p._data.detach().numpy().copy()
            for k, p in pnet.collect_params().items()}
    jnet = jax_vision.get_resnet(1, 18, classes=10, thumbnail=True)
    for k, p in jnet.collect_params().items():
        p.set_data(init[k])
    x = onp.random.RandomState(0).standard_normal(
        (2, 3, 32, 32)).astype(onp.float32)
    sgd = {"learning_rate": 0.005, "momentum": 0.9}

    def port_net():
        net = vision.get_resnet(1, 18, classes=10, thumbnail=True)
        return _load(mt, net, init)

    ref = _train(mx, "sgd", sgd, steps=3, net=jnet, batches=[x] * 3)
    got = _train(mt, "sgd", sgd, steps=3, net=port_net(), batches=[x] * 3)
    assert got["state"]["last_reason"] == ref["state"]["last_reason"] == \
        "host sync on a deferred array"
    assert got["state"]["breaks"] == ref["state"]["breaks"] == 2
    assert not any(_single(got))
    hyb = _train(mt, "sgd", sgd, steps=3, net=port_net(), batches=[x] * 3,
                 hybridize=True)
    assert _outcome(hyb) == _outcome(got)
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    eager = _train(mt, "sgd", sgd, steps=3, net=port_net(), batches=[x] * 3)
    _assert_snap(got["snap"], eager["snap"])
    _assert_snap(hyb["snap"], eager["snap"])


# -- AMP's implicit scaler inside the captured step --------------------------------

def _amp_net(pkg, units=8):
    net = pkg.gluon.nn.Sequential()
    net.add(pkg.gluon.nn.Dense(units, in_units=units, activation="relu"))
    net.add(pkg.gluon.nn.Dense(1, in_units=units))
    return net


AMP_INIT = {k: v for k, v in zip(
    ("0.weight", "0.bias", "1.weight", "1.bias"),
    (onp.random.RandomState(5).randn(8, 8).astype(onp.float32) * 0.3,
     onp.zeros(8, onp.float32),
     onp.random.RandomState(6).randn(1, 8).astype(onp.float32) * 0.3,
     onp.zeros(1, onp.float32)))}
X_AMP = onp.random.RandomState(1).randn(8, 8).astype(onp.float32)


def _amp_on(pkg):
    (jax_amp if pkg is mx else amp).init("bfloat16")


def test_amp_capture_and_bitwise_eager(monkeypatch):
    """Under amp.init("bfloat16") without scale_loss the step is captured
    in both packages (one dispatch a step); the implicit scaler starts at
    1.0; masters stay f32; the port equals its eager step bitwise."""
    runs = {}
    for pkg in (mx, mt):
        _amp_on(pkg)
        net = _load(pkg, _amp_net(pkg), AMP_INIT)
        runs[pkg] = _train(pkg, net=net, batches=[X_AMP] * 5)
        assert runs[pkg]["trainer"]._amp_loss_scaler.loss_scale == 1.0
    assert _single(runs[mt]) == _single(runs[mx]) == [False] + [True] * 4
    assert _outcome(runs[mt]) == _outcome(runs[mx])
    for p in runs[mt]["net"].collect_params().values():
        assert str(p.data().dtype) == "float32"
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    net = _load(mt, _amp_net(mt), AMP_INIT)
    eager = _train(mt, net=net, batches=[X_AMP] * 5)
    _assert_snap(runs[mt]["snap"], eager["snap"])
    onp.testing.assert_allclose(runs[mt]["losses"], runs[mx]["losses"],
                                rtol=2e-2)


def test_amp_overflow_skips_in_the_graph_without_recompile():
    """An inf in the batch: the same function skips the update (the old
    weights, bitwise), halves the scale and counts the overflow, with no
    new compile; a clean step then applies its update."""
    amp.init("bfloat16")
    jax_amp.init("bfloat16")
    out = {}
    bad = X_AMP.copy()
    bad[0, 0] = onp.inf
    for pkg, scaler in ((mx, JaxScaler(init_scale=256.0, scale_window=50)),
                        (mt, LossScaler(init_scale=256.0, scale_window=50))):
        net = _load(pkg, _amp_net(pkg), AMP_INIT)
        warm = _train(pkg, net=net, batches=[X_AMP] * 2, scaler=scaler)
        tr = warm["trainer"]
        s0 = CS[pkg].stats()
        w0 = _snapshot(net, tr)[0]
        ov0 = pkg.telemetry.counter("amp.overflow_steps").value
        counter = pkg.telemetry.counter("dispatch.count")
        deltas = []
        for x in (bad, X_AMP):
            d0 = counter.value
            with pkg.autograd.record():
                y = net(_nd(pkg, x))
                loss = (y * y).sum()
            loss.backward()
            tr.step(batch_size=8)
            deltas.append(counter.value - d0)
            if x is bad:
                scale_after_bad = tr._amp_loss_scaler.loss_scale
                w_bad = _snapshot(net, tr)[0]
        out[pkg] = (deltas, scale_after_bad, tr._amp_loss_scaler.loss_scale,
                    CS[pkg].stats()["compiles"] - s0["compiles"],
                    pkg.telemetry.counter("amp.overflow_steps").value - ov0)
        for k in w0:
            onp.testing.assert_array_equal(w_bad[k], w0[k])
        assert any(not onp.array_equal(w, w0[k])
                   for k, w in _snapshot(net, tr)[0].items())
    assert out[mt] == out[mx] == ([1, 1], 128.0, 128.0, 0, 1)


def test_amp_scale_grows_in_the_graph():
    """scale_window clean captured steps double the scale with one
    compile."""
    res = {}
    for pkg, scaler in ((mx, JaxScaler(init_scale=4.0, scale_window=2)),
                        (mt, LossScaler(init_scale=4.0, scale_window=2))):
        _amp_on(pkg)
        net = _load(pkg, _amp_net(pkg), AMP_INIT)
        s0 = CS[pkg].stats()
        run = _train(pkg, net=net, batches=[X_AMP] * 5,
                     opt_args={"learning_rate": 0.01}, scaler=scaler)
        res[pkg] = (run["trainer"]._amp_loss_scaler.loss_scale,
                    CS[pkg].stats()["compiles"] - s0["compiles"])
    assert res[mt] == res[mx] == (16.0, 1)


def test_amp_toggle_retires_the_executable():
    """Turning the policy on changes the numerics key: one eager
    re-observation, then a fresh capture; the f32 graph is never
    replayed under the policy."""
    res = {}
    for pkg in (mx, mt):
        net = _load(pkg, _amp_net(pkg), AMP_INIT)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=None)
        counter = pkg.telemetry.counter("dispatch.count")
        x = _nd(pkg, X_AMP)

        def one():
            d0 = counter.value
            with pkg.autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            tr.step(batch_size=8)
            return counter.value - d0 == 1

        seq = [one(), one()]
        s0 = CS[pkg].stats()
        _amp_on(pkg)
        seq += [one(), one(), one()]
        res[pkg] = (seq, CS[pkg].stats()["captures"] - s0["captures"],
                    CS[pkg].stats()["compiles"] - s0["compiles"])
    assert res[mt] == res[mx] == ([False, True, False, True, True], 1, 1)


@pytest.mark.parametrize("overflow_at", [None, 1])
def test_scale_loss_breaks_where_the_reference_raises(monkeypatch,
                                                      overflow_at):
    """The standard AMP loop (amp.scale_loss inside record()) under the
    cached step: the overflow check reads the gradients, a host sync.
    Pinned as a reference behaviour the port does not copy: the
    reference raises at the first deferred step, the port breaks there
    (counted, with the reason) and gives its eager step's weights and
    scale, also when a step overflows (its gradients zeroed, a new
    tensor each; the next step breaks at the scaling op, whose halved
    scale is a new key); the reference's own eager loop
    (MXNET_CACHED_STEP=0) equals the port's at 1e-6."""

    def loop(pkg, steps=4):
        net = _load(pkg, _amp_net(pkg), AMP_INIT)
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=None)
        a = jax_amp if pkg is mx else amp
        a.init_trainer(tr)
        for i in range(steps):
            xi = X_AMP.copy()
            if i == overflow_at:
                xi[0, 0] = onp.inf
            with pkg.autograd.record():
                loss = (net(_nd(pkg, xi)) ** 2).sum()
                with a.scale_loss(loss, tr) as scaled:
                    scaled.backward()
            tr.step(batch_size=8)
        return net, tr

    with pytest.raises(JaxError, match="escaped its captured step"):
        loop(mx)
    net, tr = loop(mt)
    st = port_cs.trainer_state(tr)
    assert st["last_reason"] == "host sync on a deferred array"
    assert st["breaks"] == 3
    got = _snapshot(net, tr)
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    net_e, tr_e = loop(mt)
    _assert_snap(got, _snapshot(net_e, tr_e))
    assert tr._amp_loss_scaler.state() == tr_e._amp_loss_scaler.state()
    jnet, jtr = loop(mx)
    assert tr._amp_loss_scaler.loss_scale == jtr._amp_loss_scaler.loss_scale
    onp.testing.assert_allclose(
        got[0]["0.weight"], jnet.collect_params()["0.weight"]
        .data().asnumpy(), rtol=0, atol=1e-6)


def test_step_records_carry_the_cached_step_deltas(monkeypatch):
    """The per-step telemetry record carries the dispatch count and the
    cached step's deltas: the capture in the second record, one dispatch
    and one hit in the last."""
    records = []

    class Sink:
        def emit(self, rec):
            records.append(rec)

    sink = Sink()
    mt.telemetry.add_sink(sink)
    try:
        _train(mt, steps=4)
    finally:
        mt.telemetry.remove_sink(sink)
    assert len(records) == 4
    for rec in records:
        assert set(rec["cached_step"]) == {"hits", "compiles", "fallbacks",
                                           "graph_breaks"}
    assert records[1]["cached_step"]["compiles"] == 1
    assert records[-1]["dispatches"] == 1
    assert records[-1]["cached_step"]["hits"] == 1
