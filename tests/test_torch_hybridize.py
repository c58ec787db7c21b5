"""``HybridBlock.hybridize`` in the port (``mxnet_tpu_torch/gluon/
block.py``) against the reference's (``mxnet_tpu/gluon/block.py:367-548``)
on the CPU: outside ``autograd.record()`` a hybridized block replays one
captured executable for each call signature.  The same weights and numpy
inputs go through both packages.

Checked: outputs bitwise equal to the port's eager forward and within
1e-6 of the reference's hybridized forward (f32); one capture for each
signature in both packages (the cache's size, and one
``compile.cached_op`` record each); the ``MXNET_JIT_MAX_SIGS`` budget
honoured (a signature past it runs eagerly and captures nothing, the
captured ones keep replaying); the first call finishing deferred
initialisation eagerly; BatchNorm's running statistics in training mode
written after each replay, as the eager forward writes them; a replaced
parameter dropping its signature's graph.  On the CPU an ``Executable``
runs its function on its static inputs (no graph): ``chip_smoke.py``'s
``gluon_capture`` phase checks the CUDA graphs."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as jax_vision

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert, telemetry
from mxnet_tpu_torch.gluon.model_zoo import vision

X = onp.random.RandomState(0).randn(8, 6).astype(onp.float32)
X2 = onp.random.RandomState(1).randn(3, 6).astype(onp.float32)
X3 = onp.random.RandomState(2).randn(5, 6).astype(onp.float32)


def _mlp(pkg, in_units=6):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=in_units),
            pkg.gluon.nn.Dense(4, in_units=16))
    return net


def _pair():
    """The reference's MLP (seed 0) and the port's on its weights."""
    mx.random.seed(0)
    jnet = _mlp(mx)
    jnet.initialize()
    init = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    pnet = _mlp(mt)
    convert.load_collected_params(pnet, init, device="cpu")
    return jnet, pnet


def _port(a):
    return mt.nd.array(a, ctx=mt.cpu())


def _compiles():
    return telemetry.counter("compile.cached_op.count").value


def test_hybridized_forward_matches_eager_and_reference():
    jnet, pnet = _pair()
    eager = [pnet(_port(x)).asnumpy() for x in (X, X2)]
    jnet.hybridize()
    pnet.hybridize()
    c0 = _compiles()
    for x, want in zip((X, X2, X, X2), eager * 2):
        got = pnet(_port(x)).asnumpy()
        onp.testing.assert_array_equal(got, want)
        onp.testing.assert_allclose(got, jnet(mx.nd.array(x)).asnumpy(),
                                    rtol=0, atol=1e-6)
    assert len(pnet._cached_graphs) == len(jnet._cached_graphs) == 2
    assert _compiles() - c0 == 2


def test_output_does_not_alias_the_next_call():
    """Each call's output is its own copy: a later call leaves it."""
    _, pnet = _pair()
    pnet.hybridize()
    first = pnet(_port(X))
    keep = first.asnumpy().copy()
    pnet(_port(X * 2))
    onp.testing.assert_array_equal(first.asnumpy(), keep)


def test_signature_budget_is_honoured(monkeypatch):
    """A budget of 2: a third shape runs eagerly (same values) and
    captures nothing, in both packages; the two captured signatures keep
    replaying.  The reference reads MXNET_JIT_MAX_SIGS at each
    ``SigBudget``; the port reads it once, at import, for every cache."""
    from mxnet_tpu_torch.ops import registry as port_registry
    monkeypatch.setenv("MXNET_JIT_MAX_SIGS", "2")
    monkeypatch.setattr(port_registry, "_MAX_JIT_SIGS", 2)
    jnet, pnet = _pair()
    jnet.hybridize()
    pnet.hybridize()
    for x in (X, X2, X3, X):
        got = pnet(_port(x)).asnumpy()
        onp.testing.assert_allclose(got, jnet(mx.nd.array(x)).asnumpy(),
                                    rtol=0, atol=1e-6)
    assert len(pnet._cached_graphs) == len(jnet._cached_graphs) == 2
    assert pnet._sig_budget.latched and jnet._sig_budget.latched


class _Gate(mt.gluon.HybridBlock):
    """A Dense layer scaled by the mean of a second argument."""

    def __init__(self):
        super().__init__()
        self.dense = mt.gluon.nn.Dense(4, in_units=6)

    def forward(self, x, w):
        return self.dense(x) * float(w.mean()) if isinstance(w, onp.ndarray) \
            else self.dense(x) * w.mean()


def test_array_arguments_are_inputs_of_the_signature():
    """A raw tensor beside the NDArray is an input, staged at every call:
    a tensor of 2000 elements whose middle element changes (its repr
    does not) gives each call's value, under one signature.  A numpy
    argument is keyed by identity: each new array is a signature of its
    own.  Every call equals the eager forward bitwise."""
    net = _Gate()
    net.initialize(ctx=mt.cpu())
    x = _port(X)

    def forward(w):
        return net(x, w).asnumpy()

    ws = []
    for i in range(3):
        w = torch.ones(2000)
        w[1000] = 1.0 + 100.0 * i
        ws.append(w)
    wants = [forward(w) for w in ws]
    nps = [w.numpy().copy() for w in ws]
    want_np = [forward(w) for w in nps]
    net.hybridize()
    for w, want in zip(ws, wants):
        onp.testing.assert_array_equal(forward(w), want)
    assert len(net._cached_graphs) == 1
    for w, want in zip(nps, want_np):
        onp.testing.assert_array_equal(forward(w), want)
    assert len(net._cached_graphs) == 1 + len(nps)


def test_plain_sequential_hybridizes_its_children():
    """``hybridize()`` on a plain Sequential reaches its HybridBlock
    children: outside record() each child replays its own graph, in both
    packages, and the output equals the eager one bitwise."""
    mx.random.seed(0)
    nets = {}
    for pkg in (mx, mt):
        net = pkg.gluon.nn.Sequential()
        net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=6),
                pkg.gluon.nn.Dense(4, in_units=16))
        nets[pkg] = net
    nets[mx].initialize()
    init = {k: p.data().asnumpy()
            for k, p in nets[mx].collect_params().items()}
    convert.load_collected_params(nets[mt], init, device="cpu")
    eager = nets[mt](_port(X)).asnumpy()
    for net in nets.values():
        net.hybridize()
    got = [nets[mt](_port(X)).asnumpy() for _ in range(2)]
    want = nets[mx](mx.nd.array(X)).asnumpy()
    for g in got:
        onp.testing.assert_array_equal(g, eager)
        onp.testing.assert_allclose(g, want, rtol=0, atol=1e-6)
    for k in range(2):
        assert len(nets[mt][k]._cached_graphs) == \
            len(nets[mx][k]._cached_graphs) == 1


def test_first_call_finishes_deferred_init():
    """in_units left to the first forward: that call runs eagerly and
    initialises; the next one is captured."""
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(16, activation="relu"), mt.gluon.nn.Dense(4))
    net.initialize(ctx=mt.cpu())
    net.hybridize()
    first = net(_port(X)).asnumpy()
    assert not net._cached_graphs
    assert net.collect_params()["0.weight"].shape == (16, 6)
    onp.testing.assert_array_equal(net(_port(X)).asnumpy(), first)
    assert len(net._cached_graphs) == 1


def test_inside_record_runs_eagerly_with_gradients():
    """Inside record() the hybridized block is one eager record: its
    gradients are the eager ones, and nothing is captured."""
    _, a = _pair()
    _, b = _pair()
    b.hybridize()
    grads = []
    for net in (a, b):
        with mt.autograd.record():
            loss = (net(_port(X)) ** 2).sum()
        loss.backward()
        grads.append({k: p.grad().asnumpy()
                      for k, p in net.collect_params().items()})
    assert not b._cached_graphs
    for k in grads[0]:
        onp.testing.assert_array_equal(grads[0][k], grads[1][k])


def test_replaced_parameter_drops_the_graph():
    """cast() replaces the parameters' tensors (here with f32 copies of
    new values): the signature's graph is captured again on them."""
    _, pnet = _pair()
    pnet.hybridize()
    pnet(_port(X))
    entry = next(iter(pnet._cached_graphs.values()))
    pnet.cast("float32")
    for p in pnet.collect_params().values():
        p.set_data(p.data().asnumpy() * 2)
    want = pnet[1](pnet[0](torch.from_numpy(X))).detach().numpy()
    got = pnet(_port(X)).asnumpy()
    assert next(iter(pnet._cached_graphs.values())) is not entry
    onp.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("training", [False, True])
def test_resnet_batchnorm_forward_matches_eager(training):
    """A thumbnail ResNet-18: the hybridized forward equals the eager one
    bitwise, in eval mode and in training mode (where BatchNorm's running
    statistics are written after the replay, as the eager forward writes
    them), and the reference's hybridized forward within 1e-5."""
    mx.random.seed(1)
    jnet = jax_vision.get_resnet(1, 18, classes=10, thumbnail=True)
    jnet.initialize(init=mx.initializer.Xavier())
    jnet(mx.nd.array(onp.zeros((1, 3, 32, 32), onp.float32)))
    init = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    x = onp.random.RandomState(0).standard_normal(
        (2, 3, 32, 32)).astype(onp.float32)

    def run(hybrid):
        net = vision.get_resnet(1, 18, classes=10, thumbnail=True)
        convert.load_collected_params(net, init, device="cpu")
        if hybrid:
            net.hybridize()
        scope = mt.autograd.train_mode() if training else \
            mt.autograd.predict_mode()
        with scope:
            outs = [net(_port(x)).asnumpy() for _ in range(2)]
        stats = {k: p.data().asnumpy() for k, p in
                 net.collect_params().items() if k.endswith("running_mean")}
        return outs, stats, net

    (e_out, e_stats, _), (h_out, h_stats, hnet) = run(False), run(True)
    assert len(hnet._cached_graphs) == 1
    for a, b in zip(e_out, h_out):
        onp.testing.assert_array_equal(a, b)
    for k in e_stats:
        onp.testing.assert_array_equal(e_stats[k], h_stats[k])
    if not training:
        jnet.hybridize()
        with mx.autograd.predict_mode():
            want = jnet(mx.nd.array(x)).asnumpy()
        onp.testing.assert_allclose(h_out[0], want, rtol=1e-5, atol=1e-5)
