"""The optimizer family, the lr schedulers, the fused whole-set step and
the optimizer-state blob, held against the reference on the same numpy
inputs on the CPU.

Tolerances: f32 updates rtol 1e-6 (atol 1e-7; the ops are the
reference's formulas, op for op; FTML's and Adamax's lr/(1 - β1ᵗ) are
rounded once more in the reference, where lr is an f32 scalar), bf16
weights at bf16 tolerance (rtol 2e-2, atol 1e-2), schedulers exactly,
the fused step against the per-parameter path bitwise, state blobs
bitwise.  SGLD's noise comes from two random streams that never match,
so it is held by its statistics."""
import os

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu.lr_scheduler as jax_sched
from mxnet_tpu import optimizer as jax_opt

import mxnet_tpu_torch as mt
import mxnet_tpu_torch.lr_scheduler as port_sched
from mxnet_tpu_torch import optimizer as port_opt
from mxnet_tpu_torch.optimizer import fused_step

SHAPES = [(4, 6), (6,)]
COMMON = {"wd": 0.01, "clip_gradient": 5.0, "rescale_grad": 0.5}

FAMILY = [
    ("sgd", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.05}),
    ("adam", {"learning_rate": 0.01}),
    ("adamw", {"learning_rate": 0.01, "eta": 0.8}),
    ("adagrad", {"learning_rate": 0.05}),
    ("adadelta", {}),
    ("adamax", {"learning_rate": 0.01}),
    ("nadam", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_weights": 2.0}),
    ("ftml", {"learning_rate": 0.01}),
    ("ftrl", {"learning_rate": 0.05}),
    ("lamb", {"learning_rate": 0.01, "lower_bound": 0.1,
              "upper_bound": 10.0}),
    ("lars", {"learning_rate": 0.05}),
    ("signum", {"learning_rate": 0.01}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    ("dcasgd", {"learning_rate": 0.05}),
    ("lans", {"learning_rate": 0.01}),
    ("groupadagrad", {"learning_rate": 0.05, "wd": 0.0}),
    ("test", {}),
]
FAMILY_IDS = [f"{n}-{i}" for i, (n, _) in enumerate(FAMILY)]


def _inputs(seed, steps=5):
    rng = onp.random.RandomState(seed)
    weights = [rng.randn(*s).astype(onp.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(onp.float32) for s in SHAPES]
             for _ in range(steps)]
    return weights, grads


def _kw(name, kw):
    out = dict(COMMON)
    out.update(kw)
    return out


def _ref_run(name, kw, weights, grads, dtype="float32"):
    """The reference's Updater over the steps: (weights, states) as f32
    numpy."""
    opt = jax_opt.create(name, **_kw(name, kw))
    upd = jax_opt.get_updater(opt)
    ws = [mx.nd.array(w).astype(dtype) for w in weights]
    for step in grads:
        for i, g in enumerate(step):
            upd(i, mx.nd.array(g).astype(dtype), ws[i])
    states = [[s.astype("float32").asnumpy() for s in upd.states[i]]
              for i in range(len(ws))]
    return [w.astype("float32").asnumpy() for w in ws], states


def _port_run(name, kw, weights, grads, dtype="float32"):
    opt = port_opt.create(name, **_kw(name, kw))
    upd = port_opt.get_updater(opt)
    ws = [mt.nd.array(w, ctx=mt.cpu(), dtype=dtype) for w in weights]
    for step in grads:
        for i, g in enumerate(step):
            upd(i, mt.nd.array(g, ctx=mt.cpu(), dtype=dtype), ws[i])
    states = [[s._data.float().numpy() for s in upd.states[i]]
              for i in range(len(ws))]
    return [w._data.float().numpy() for w in ws], states


def _assert_close(got, want, rtol, atol):
    gw, gs = got
    ww, ws = want
    for a, b in zip(gw, ww):
        onp.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    for sa, sb in zip(gs, ws):
        assert len(sa) == len(sb)
        for a, b in zip(sa, sb):
            onp.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,kw", FAMILY, ids=FAMILY_IDS)
def test_family_matches_reference_f32(name, kw):
    """Five updates of two parameters (wd 0.01, clip 5, rescale 0.5):
    weights and every state slot at rtol 1e-6."""
    weights, grads = _inputs(0)
    _assert_close(_port_run(name, kw, weights, grads),
                  _ref_run(name, kw, weights, grads), 1e-6, 1e-7)


@pytest.mark.parametrize("name,kw", FAMILY, ids=FAMILY_IDS)
def test_family_matches_reference_bf16(name, kw):
    """The same five updates on bf16 weights and gradients (the update
    runs in f32 under the low-precision guard and is cast back): bf16
    tolerance."""
    weights, grads = _inputs(1)
    _assert_close(_port_run(name, kw, weights, grads, "bfloat16"),
                  _ref_run(name, kw, weights, grads, "bfloat16"),
                  2e-2, 1e-2)


def test_sgld_by_its_statistics():
    """From w = 0 with zero gradients, one SGLD update is √lr·N(0, 1) in
    both packages: mean and standard deviation over 40,000 elements
    agree with each other and with √lr (2% of √lr)."""
    n, lr = 40_000, 0.04
    stats = []
    for pkg, arr in ((jax_opt, lambda a: mx.nd.array(a)),
                     (port_opt, lambda a: mt.nd.array(a, ctx=mt.cpu()))):
        upd = pkg.get_updater(pkg.create("sgld", learning_rate=lr))
        w = arr(onp.zeros(n, onp.float32))
        upd(0, arr(onp.zeros(n, onp.float32)), w)
        a = w.asnumpy()
        stats.append((float(a.mean()), float(a.std())))
    for mean, std in stats:
        assert abs(mean) < 0.02 * lr ** 0.5
        assert abs(std - lr ** 0.5) < 0.02 * lr ** 0.5
    assert abs(stats[0][1] - stats[1][1]) < 0.02 * lr ** 0.5


# -- schedulers ------------------------------------------------------------------

def _make_schedulers(pkg, mode):
    warm = {"warmup_steps": 20, "warmup_begin_lr": 0.01,
            "warmup_mode": mode}
    return [pkg.FactorScheduler(step=25, factor=0.7, stop_factor_lr=1e-3,
                                base_lr=0.3, **warm),
            pkg.MultiFactorScheduler(step=[50, 120, 200], factor=0.5,
                                     base_lr=0.3, **warm),
            pkg.PolyScheduler(max_update=250, base_lr=0.3, pwr=2,
                              final_lr=0.001, **warm),
            pkg.CosineScheduler(max_update=250, base_lr=0.3,
                                final_lr=0.001, **warm)]


@pytest.mark.parametrize("mode", ["linear", "constant"])
@pytest.mark.parametrize("which", range(4),
                         ids=["factor", "multifactor", "poly", "cosine"])
def test_schedulers_match_exactly(which, mode):
    """Every ``num_update`` of 0-300, through the warmup (linear, and the
    other mode, ``(n / warmup_steps) ** 2``) and past ``max_update``:
    the same float."""
    ref = _make_schedulers(jax_sched, mode)[which]
    got = _make_schedulers(port_sched, mode)[which]
    for n in range(301):
        assert got(n) == ref(n), n


def test_scheduler_drives_the_learning_rate_exactly():
    """An Adam with a cosine schedule, stepped 12 times through the
    Updater: its ``learning_rate`` after each update is the reference's,
    and the weights follow at rtol 1e-6."""
    weights, grads = _inputs(2, steps=12)
    out = []
    for pkg, sched, arr in (
            (jax_opt, jax_sched, lambda a: mx.nd.array(a)),
            (port_opt, port_sched, lambda a: mt.nd.array(a, ctx=mt.cpu()))):
        opt = pkg.create("adam", learning_rate=0.05,
                         lr_scheduler=sched.CosineScheduler(
                             max_update=10, base_lr=1.0, warmup_steps=3))
        upd = pkg.get_updater(opt)
        ws = [arr(w) for w in weights]
        lrs = []
        for step in grads:
            for i, g in enumerate(step):
                upd(i, arr(g), ws[i])
            lrs.append(opt.learning_rate)
        out.append((lrs, [w.asnumpy() for w in ws]))
    assert out[1][0] == out[0][0]
    for a, b in zip(out[1][1], out[0][1]):
        onp.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


# -- multipliers and Adam's bias correction ---------------------------------------

class _Mults:
    def __init__(self, lr_mult, wd_mult):
        self.lr_mult, self.wd_mult = lr_mult, wd_mult


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_lr_and_wd_multipliers(name):
    """``param_dict`` multipliers times ``set_lr_mult``/``set_wd_mult``
    ones, by parameter name: three updates at rtol 1e-6."""
    weights, grads = _inputs(3, steps=3)
    out = []
    for pkg, arr in ((jax_opt, lambda a: mx.nd.array(a)),
                     (port_opt, lambda a: mt.nd.array(a, ctx=mt.cpu()))):
        opt = pkg.create(name, learning_rate=0.05, wd=0.1, momentum=0.9) \
            if name == "sgd" else pkg.create(name, learning_rate=0.05,
                                             wd=0.1)
        opt.idx2name = {0: "w0", 1: "w1"}
        opt.param_dict = {"w0": _Mults(0.5, 2.0), "w1": _Mults(3.0, 0.0)}
        opt.set_lr_mult({"w0": 2.0})
        opt.set_wd_mult({"w1": 5.0})
        upd = pkg.get_updater(opt)
        ws = [arr(w) for w in weights]
        for step in grads:
            for i, g in enumerate(step):
                upd(i, arr(g), ws[i])
        out.append([w.asnumpy() for w in ws])
    for a, b in zip(*out):
        onp.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_adam_bias_correction_is_folded_into_lr():
    """The eager Adam's first step moves each weight by lr·g/(|g| + ε'),
    about lr: the bias correction √(1 - β2)/(1 - β1) is in the step
    (without it the step would be ~0.32·lr); later steps follow the
    reference at rtol 1e-6."""
    w0 = onp.zeros(1000, onp.float32)
    g = onp.random.RandomState(4).randn(1000).astype(onp.float32)
    opt = port_opt.create("adam", learning_rate=0.01)
    upd = port_opt.get_updater(opt)
    w = mt.nd.array(w0, ctx=mt.cpu())
    upd(0, mt.nd.array(g, ctx=mt.cpu()), w)
    onp.testing.assert_allclose(onp.abs(w.asnumpy()), 0.01, rtol=1e-3)
    ref = jax_opt.get_updater(jax_opt.create("adam", learning_rate=0.01))
    rw = mx.nd.array(w0)
    ref(0, mx.nd.array(g), rw)
    for t in range(3):
        gt = (g * (t + 2)).astype(onp.float32)
        upd(0, mt.nd.array(gt, ctx=mt.cpu()), w)
        ref(0, mx.nd.array(gt), rw)
    onp.testing.assert_allclose(w.asnumpy(), rw.asnumpy(), rtol=1e-6,
                                atol=1e-8)


# -- the fused step --------------------------------------------------------------

FUSABLE = ["sgd", "nag", "adam", "adamw", "adagrad", "adadelta", "rmsprop",
           "ftrl", "lars", "signum", "dcasgd", "groupadagrad"]


def _mixed_params(seed):
    """Two f32 parameters and a bf16 one, with different multipliers."""
    rng = onp.random.RandomState(seed)
    shapes = [(5, 7), (7,), (3, 4)]
    dtypes = ["float32", "float32", "bfloat16"]
    ws = [rng.randn(*s).astype(onp.float32) for s in shapes]
    gs = [[rng.randn(*s).astype(onp.float32) for s in shapes]
          for _ in range(3)]
    return ws, gs, dtypes


@pytest.mark.parametrize("name", FUSABLE)
def test_fused_step_equals_per_parameter_bitwise(name, monkeypatch):
    """Three fused steps against three per-parameter ones, with lr_mult /
    wd_mult per parameter and an f32 and a bf16 group: weights and
    states bit for bit; the per-parameter path is ``MXNET_FUSED_STEP=0``
    (the fused step declines)."""
    ws, gs, dtypes = _mixed_params(5)
    kw = {"learning_rate": 0.05, "wd": 0.0 if name == "groupadagrad"
          else 0.01, "clip_gradient": 2.0}
    if name == "sgd":
        kw["momentum"] = 0.9
    if name == "adadelta":
        kw.pop("learning_rate")
    runs = []
    for fused in (True, False):
        monkeypatch.setenv("MXNET_FUSED_STEP", "1" if fused else "0")
        opt = port_opt.create(name, **kw)
        opt.param_dict = {0: _Mults(1.0, 1.0), 1: _Mults(0.5, 2.0),
                          2: _Mults(2.0, 0.0)}
        opt.rescale_grad = 0.25
        upd = port_opt.get_updater(opt)
        w = [mt.nd.array(a, ctx=mt.cpu(), dtype=d)
             for a, d in zip(ws, dtypes)]
        for step in gs:
            g = [mt.nd.array(a, ctx=mt.cpu(), dtype=d)
                 for a, d in zip(step, dtypes)]
            ran = fused_step.step(upd, list(zip(range(3), w, g)))
            assert ran == fused
            if not ran:
                for i in range(3):
                    upd(i, g[i], w[i])
        runs.append(([x._data.clone() for x in w],
                     [[s._data.clone() for s in upd.states[i]]
                      for i in range(3)]))
    (w1, s1), (w2, s2) = runs
    for a, b in zip(w1, w2):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for x, y in zip(s1, s2):
        for a, b in zip(x, y):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["adamax", "nadam", "lamb", "lans",
                                  "ftml", "sgld", "test"])
def test_fused_step_declines_where_the_reference_does(name):
    """A custom ``update`` or attributes that move with the count: the
    fused step declines and changes nothing (states aside)."""
    ws, gs, _ = _mixed_params(6)
    upd = port_opt.get_updater(port_opt.create(name))
    w = [mt.nd.array(a, ctx=mt.cpu()) for a in ws]
    before = [x._data.clone() for x in w]
    before_stats = fused_step.stats()
    g = [mt.nd.array(a, ctx=mt.cpu()) for a in gs[0]]
    assert not fused_step.step(upd, list(zip(range(3), w, g)))
    assert all(torch.equal(a, x._data) for a, x in zip(before, w))
    assert fused_step.stats()["fallbacks"] == before_stats["fallbacks"] + 1
    assert upd.optimizer.num_update == 0


def test_fused_step_reads_the_environment(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_STEP", "off")
    assert not fused_step.enabled()
    monkeypatch.delenv("MXNET_FUSED_STEP")
    assert fused_step.enabled()


def test_aggregated_update_matches_per_parameter():
    """``update_multi`` (``aggregate_num``'s path) over three parameters
    with equal multipliers: one multi-tensor call, the same bits as three
    single updates."""
    ws, gs, _ = _mixed_params(7)
    ws = [ws[0], ws[0] * 2, ws[0] * 3]
    gs = [[s[0], s[0] + 1, s[0] - 1] for s in gs]
    outs = []
    for agg in (True, False):
        upd = port_opt.get_updater(port_opt.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=0.01))
        w = [mt.nd.array(a, ctx=mt.cpu()) for a in ws]
        for step in gs:
            g = [mt.nd.array(a, ctx=mt.cpu()) for a in step]
            if agg:
                n0 = port_opt.optimizer.dispatch_count()
                upd.update_multi([0, 1, 2], g, w)
                assert port_opt.optimizer.dispatch_count() == n0 + 1
            else:
                for i in range(3):
                    upd(i, g[i], w[i])
        outs.append([x._data for x in w])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# -- the state blob --------------------------------------------------------------

def _filled_port_updater():
    """A port Updater with Adam states for an f32 and a bf16 weight."""
    ws, gs, dtypes = _mixed_params(8)
    upd = port_opt.get_updater(port_opt.create("adam"))
    w = [mt.nd.array(a, ctx=mt.cpu(), dtype=d) for a, d in zip(ws, dtypes)]
    for step in gs:
        for i, (a, d) in enumerate(zip(step, dtypes)):
            upd(i, mt.nd.array(a, ctx=mt.cpu(), dtype=d), w[i])
    return upd


def _bits(a):
    a = onp.asarray(a)
    return a.view(onp.uint16) if a.dtype.name == "bfloat16" else a


def test_state_blob_crosses_from_port_to_reference():
    """The port's blob loads in the reference: every slot's dtype and
    bits (bf16 as its 16-bit pattern)."""
    port = _filled_port_updater()
    ref = jax_opt.get_updater(jax_opt.create("adam"))
    ref.set_states(port.get_states())
    assert sorted(ref.states) == sorted(port.states)
    for k, slots in port.states.items():
        for ours, theirs in zip(slots, ref.states[k]):
            t = ours._data
            if t.dtype == torch.bfloat16:
                assert theirs.dtype.name == "bfloat16"
                onp.testing.assert_array_equal(
                    _bits(theirs.asnumpy()),
                    t.view(torch.int16).numpy().view(onp.uint16))
            else:
                onp.testing.assert_array_equal(theirs.asnumpy(), t.numpy())


def test_state_blob_crosses_from_reference_to_port():
    """The reference's blob (an f32 and a bf16 weight's Adam states)
    loads in the port with the same dtypes and bits, and round-trips
    through the port's ``get_states`` unchanged."""
    ws, gs, dtypes = _mixed_params(9)
    ref = jax_opt.get_updater(jax_opt.create("adam"))
    w = [mx.nd.array(a).astype(d) for a, d in zip(ws, dtypes)]
    for step in gs:
        for i, (a, d) in enumerate(zip(step, dtypes)):
            ref(i, mx.nd.array(a).astype(d), w[i])
    blob = ref.get_states()
    port = port_opt.get_updater(port_opt.create("adam"))
    port.set_states(blob, device=torch.device("cpu"))
    for k, slots in ref.states.items():
        for theirs, ours in zip(slots, port.states[k]):
            t = ours._data
            if theirs.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16
                onp.testing.assert_array_equal(
                    t.view(torch.int16).numpy().view(onp.uint16),
                    _bits(theirs.asnumpy()))
            else:
                onp.testing.assert_array_equal(t.numpy(), theirs.asnumpy())
    again = port_opt.get_updater(port_opt.create("adam"))
    again.set_states(port.get_states(), device=torch.device("cpu"))
    for k in port.states:
        for a, b in zip(port.states[k], again.states[k]):
            assert a._data.dtype == b._data.dtype
            assert torch.equal(a._data, b._data)


def test_state_blob_refuses_pickles():
    import pickle
    upd = port_opt.get_updater(port_opt.create("sgd"))
    with pytest.raises(mt.MXNetError, match="npz"):
        upd.set_states(pickle.dumps({"a": 1}))


def test_registered_ops_reach_nd():
    """The family is registered under the reference's names: ``mx.nd``
    runs them, and they agree with the reference's ``mx.nd`` (rtol
    1e-6)."""
    rng = onp.random.RandomState(10)
    w, g, m = (rng.randn(3, 5).astype(onp.float32) for _ in range(3))
    for name, states, kw in (("nag_mom_update", [m], {"momentum": 0.9}),
                             ("signsgd_update", [], {}),
                             ("mp_sgd_update", [w], {}),
                             ("lamb_update_phase1", [m, m * m], {"t": 2})):
        if name != "lamb_update_phase1":
            kw = dict(kw, lr=0.1)
        ref = getattr(mx.nd, name)(*[mx.nd.array(a)
                                     for a in [w, g] + states], **kw)
        got = getattr(mt.nd, name)(*[mt.nd.array(a, ctx=mt.cpu())
                                     for a in [w, g] + states], **kw)
        ref = ref if isinstance(ref, (list, tuple)) else [ref]
        got = got if isinstance(got, (list, tuple)) else [got]
        for a, b in zip(got, ref):
            onp.testing.assert_allclose(a.asnumpy(), b.asnumpy(),
                                        rtol=1e-6, atol=1e-7)
    assert os.environ.get("MXNET_FUSED_STEP", "1") != "0"
