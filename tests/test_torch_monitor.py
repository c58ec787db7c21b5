"""``mx.monitor.Monitor`` in the port (``mxnet_tpu_torch/monitor.py``)
against the reference's, on the CPU: the same two-layer net with the
same weights and batch gives the same (step, name) list and statistics
within 1e-6 relative (||x|| / sqrt(size) in float64 of float32 values
computed by two libraries); ``interval``, ``pattern``, ``monitor_all``,
``sort``, ``MXNET_MONITOR=0``, ``uninstall``, the registry's gauges;
and a monitored Gluon loop declines the whole-step capture as the
reference's does (its forward hooks see real activations).
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jax_nn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert, telemetry
from mxnet_tpu_torch.gluon import nn

RNG = onp.random.RandomState(0)
X = RNG.randn(4, 3).astype("float32")


def _nets():
    jnet = jax_nn.HybridSequential()
    jnet.add(jax_nn.Dense(5, in_units=3, activation="relu"),
             jax_nn.Dense(2, in_units=5))
    jnet.initialize()
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    net = nn.HybridSequential()
    net.add(nn.Dense(5, in_units=3, activation="relu"),
            nn.Dense(2, in_units=5))
    convert.load_collected_params(net, params, device="cpu")
    return jnet, net


def _run(pkg, net, steps=1, **kw):
    mon = pkg.monitor.Monitor(**kw).install(net)
    out = []
    for _ in range(steps):
        mon.tic()
        x = mx.nd.array(X) if pkg is mx else mt.nd.array(X, ctx=mt.cpu())
        with pkg.autograd.record():
            y = net(x)
        y.backward()
        out.append(mon.toc())
    mon.uninstall()
    return out


def _close(got, ref):
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in ref]
    onp.testing.assert_allclose([v for *_, v in got], [v for *_, v in ref],
                                rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("kw", [
    {}, {"pattern": r".*weight.*"}, {"monitor_all": True, "sort": True},
    {"interval": 2}], ids=["all", "pattern", "inputs_sorted", "interval"])
def test_monitor_stats_match_the_reference(kw):
    jnet, net = _nets()
    ref = _run(mx, jnet, steps=3, **kw)
    got = _run(mt, net, steps=3, **kw)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        _close(g, r)
    if kw.get("interval") == 2:
        assert got[1] == [] and got[0] and got[2]


def test_gauges_switch_and_uninstall(monkeypatch):
    _, net = _nets()
    got = _run(mt, net)[0]
    name, stat = got[0][1], got[0][2]
    assert telemetry.gauge(f"monitor.{name}").value == stat
    monkeypatch.setenv("MXNET_MONITOR", "0")
    assert _run(mt, net)[0] == []
    monkeypatch.delenv("MXNET_MONITOR")
    mon = mt.monitor.Monitor().install(net)
    mon.uninstall()
    mon.tic()
    net(mt.nd.array(X, ctx=mt.cpu()))
    # hooks gone: only the parameter sweep remains
    assert all("_output" not in n for _, n, _ in mon.toc())


def test_a_monitored_loop_declines_the_whole_step_capture(monkeypatch):
    """Forward hooks observe real activations, so a monitored net's step
    breaks out of the capture every step, as the reference's does; the
    loss still falls."""
    from mxnet_tpu.imperative import cached_step as jax_cached_step
    from mxnet_tpu_torch.imperative import cached_step
    monkeypatch.setenv("MXNET_CACHED_STEP", "1")
    jnet, net = _nets()
    states = []
    for pkg, n, cs in ((mx, jnet, jax_cached_step),
                       (mt, net, cached_step)):
        mon = pkg.monitor.Monitor(pattern=r".*output").install(n)
        tr = pkg.gluon.Trainer(n.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        lf = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        arr = (mx.nd.array if pkg is mx else
               lambda a: mt.nd.array(a, ctx=mt.cpu()))
        y = arr(onp.array([0, 1, 0, 1], "int32"))
        losses = []
        for _ in range(4):
            mon.tic()
            with pkg.autograd.record():
                loss = lf(n(arr(X)), y)
            loss.backward()
            tr.step(4)
            losses.append(float(loss.mean().asnumpy()))
            assert mon.toc()
        assert losses[-1] < losses[0]
        st = cs.trainer_state(tr)
        states.append((st["captures"], "forward hook" in (
            st["last_reason"] or "")))
        mon.uninstall()
    assert states[1] == states[0] == (0, True)
