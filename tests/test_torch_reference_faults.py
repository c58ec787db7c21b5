"""Behaviours where the port once parted from the reference, each held
against ``mxnet_tpu`` on the same numpy inputs on the CPU:

* casts and unary ops on integers: float → integer casts saturate at the
  target's range with NaN → 0 (exact); ``sigmoid`` refuses integer
  input with ``TypeError``, the other unary ops promote integers to
  float32 (values at rtol 1e-6);
* an NDArray key takes rows along axis 0 after a cast to int32, bool
  keys too (exact); a row out of range raises ``IndexError`` in the port
  where the reference fills NaN (a choice, pinned here);
* Adam on bf16 weights and states runs in f32 and casts back, as the
  reference's ``_lowp_guard`` does (bitwise);
* ``Dense(units, activation, ...)`` takes the reference's argument order
  and applies the activation after the bias (1e-5 on f32 outputs);
* ``SPMDTrainer``'s default optimizer, ``"sgd"``, exists (F6; losses
  and weights at rtol 1e-5);
* the top level exposes the port's subpackages after a bare import;
* F7: an optimizer given an lr scheduler sets the scheduler's ``base_lr``
  to its own ``learning_rate`` (exact, host floats);
* F8: ``Optimizer.__init__`` takes the reference's arguments and
  ``**extra``, and ``set_learning_rate`` / ``set_lr_mult`` /
  ``set_wd_mult`` / ``_get_lr`` / ``_get_wd`` / ``_update_count`` behave
  as the reference's (exact).
"""
import pathlib
import subprocess
import sys
import textwrap

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.ops.optimizer_ops import adam_update as jax_adam
from mxnet_tpu.optimizer.optimizer import _lowp_guard

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import optimizer_ops
from mxnet_tpu_torch.parallel import SPMDTrainer


def _port(a, dtype=None):
    return mt.nd.array(a, ctx=mt.cpu(), dtype=dtype)


# -- casts and unary ops on integers ------------------------------------------

CAST_IN = onp.array([-2.25, -6.0, 3.7, 255.9, 300.7, -300.0, 3e9, -3e9,
                     onp.nan, onp.inf, -onp.inf, 0.5, -0.5, 127.5],
                    onp.float32)


@pytest.mark.parametrize("target", ["uint8", "int8", "int32"])
@pytest.mark.parametrize("source", ["float32", "bfloat16", "float16"])
def test_float_to_int_cast_saturates(source, target):
    ref = mx.nd.array(CAST_IN).astype(source).astype(target).asnumpy()
    got = _port(CAST_IN).astype(source).astype(target).asnumpy()
    assert got.dtype == ref.dtype
    onp.testing.assert_array_equal(got, ref)


def test_cast_table_values():
    """The values the reference gives for the cases that wrapped."""
    x = onp.array([-2.25, -6.0, 3.7, 255.9, 300.7, -300.0], onp.float32)
    assert _port(x).astype("uint8").asnumpy().tolist() == \
        [0, 0, 3, 255, 255, 0]
    y = onp.array([3e9, -3e9, onp.nan], onp.float32)
    assert _port(y).astype("int32").asnumpy().tolist() == \
        [2147483647, -2147483648, 0]


UNARY = ["negative", "abs", "square", "sqrt", "exp", "log", "relu",
         "sigmoid", "tanh"]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:                      # the type is compared
        return type(e)


@pytest.mark.parametrize("op", UNARY)
def test_unary_on_int32_follows_reference(op):
    a = onp.array([1, 2, -3, 0], onp.int32)
    ref = _outcome(lambda: getattr(mx.nd, op)(
        mx.nd.array(a, dtype="int32")).asnumpy())
    got = _outcome(lambda: getattr(mt.nd, op)(
        _port(a, dtype="int32")).asnumpy())
    if isinstance(ref, type):
        assert got is ref is TypeError
        return
    assert got.dtype == ref.dtype
    onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("act", ["sigmoid", "relu", "tanh", "softrelu",
                                 "softsign", "log_sigmoid", "mish"])
def test_activation_on_int32_follows_reference(act):
    a = onp.array([1, 2, -3], onp.int32)
    ref = _outcome(lambda: mx.nd.Activation(
        mx.nd.array(a, dtype="int32"), act_type=act).asnumpy())
    got = _outcome(lambda: mt.nd.Activation(
        _port(a, dtype="int32"), act_type=act).asnumpy())
    if isinstance(ref, type) or isinstance(got, type):
        assert got is ref is TypeError
        return
    assert got.dtype == ref.dtype
    onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("act", ["sigmoid", "relu", "tanh", "softrelu",
                                 "softsign", "log_sigmoid", "mish"])
def test_activation_matches_reference(act):
    a = onp.random.RandomState(8).randn(3, 7).astype(onp.float32) * 4
    ref = mx.nd.Activation(mx.nd.array(a), act_type=act).asnumpy()
    got = mt.nd.Activation(_port(a), act_type=act).asnumpy()
    onp.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


# -- indexing with an NDArray key -------------------------------------------

B = onp.arange(6, dtype=onp.float32).reshape(2, 3)


@pytest.mark.parametrize("key", [onp.array([True, False]),
                                 onp.array([-1, 0], onp.int32),
                                 onp.array([1.7, 0.2], onp.float32),
                                 onp.array([[1, 0], [0, 0]], onp.int32)],
                         ids=["bool", "negative", "float", "2d"])
def test_ndarray_key_takes_rows(key):
    dt = key.dtype.name
    ref = mx.nd.array(B)[mx.nd.array(key, dtype=dt)].asnumpy()
    got = _port(B)[_port(key, dtype=dt)].asnumpy()
    assert got.shape == ref.shape
    onp.testing.assert_array_equal(got, ref)


def test_bool_key_is_rows_not_a_mask():
    got = _port(B)[_port(onp.array([True, False]), dtype="bool")]
    assert got.asnumpy().tolist() == [[3.0, 4.0, 5.0], [0.0, 1.0, 2.0]]


@pytest.mark.parametrize("row", [2, -3])
def test_ndarray_key_out_of_range_raises(row):
    """The reference fills a row past the axis with NaN; the port raises
    (ROADMAP: behaviours the port does not copy)."""
    key = onp.array([row, 0], onp.int32)
    ref = mx.nd.array(B)[mx.nd.array(key, dtype="int32")].asnumpy()
    assert onp.isnan(ref[0]).all() and (ref[1] == B[0]).all()
    with pytest.raises(IndexError, match="out of range"):
        _port(B)[_port(key, dtype="int32")]


# -- Adam on bf16 under the low-precision guard -------------------------------

def _adam_inputs(n, seed=0):
    rng = onp.random.RandomState(seed)
    return [rng.randn(n).astype(onp.float32),
            rng.randn(n).astype(onp.float32),
            (rng.randn(n) * 0.1).astype(onp.float32),
            (rng.rand(n) * 0.01).astype(onp.float32)]


def _reference_guarded(arrays, dtype, lr, wd):
    """The reference's guarded Adam on ``arrays`` (numpy f32 holding
    ``dtype`` values) as f32 numpy."""
    out = _lowp_guard(jax_adam)(*(jnp.asarray(a, dtype) for a in arrays),
                               lr=lr, wd=wd)
    return [onp.asarray(o.astype(jnp.float32)) for o in out]


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_bf16_adam_matches_the_guarded_reference_bitwise(multi):
    """One step on 4096 bf16 elements (lr 0.01, wd 0.1): every weight,
    mean and variance equals the reference's, bit for bit (no element is
    left one ulp apart)."""
    arrays = [onp.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
              for a in _adam_inputs(4096)]
    want = _reference_guarded(arrays, jnp.bfloat16, 0.01, 0.1)
    t = [torch.tensor(a).bfloat16() for a in arrays]
    if multi:
        got = [x[0] for x in optimizer_ops.adam_update_multi(
            *([x] for x in t), lrs=[0.01], wds=[0.1])]
    else:
        got = optimizer_ops.adam_update(*t, lr=0.01, wd=0.1)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert int((g.float().numpy() != w).sum()) == 0


def test_f32_adam_is_untouched_by_the_guard():
    """All-f32 inputs (the transformer's f32 masters) compute exactly as
    the unguarded op, and keep their dtype."""
    t = [torch.from_numpy(a) for a in _adam_inputs(512, seed=1)]
    got = optimizer_ops.adam_update(*t, lr=0.01, wd=0.1)
    raw = optimizer_ops.adam_update.__wrapped__(*t, lr=0.01, wd=0.1)
    multi = optimizer_ops.adam_update_multi(*([x] for x in t), lrs=[0.01],
                                            wds=[0.1])
    for g, r, m in zip(got, raw, multi):
        assert g.dtype == torch.float32
        assert torch.equal(g, r) and torch.equal(m[0], r)


def test_mixed_groups_guard_only_the_low_precision_ones():
    """In one multi-tensor call an f32 parameter and a bf16 one each get
    what their own single-tensor update gives."""
    a32 = [torch.from_numpy(a) for a in _adam_inputs(256, seed=2)]
    a16 = [torch.from_numpy(a).bfloat16() for a in _adam_inputs(300, 3)]
    out = optimizer_ops.adam_update_multi(
        *([x, y] for x, y in zip(a32, a16)), lrs=[0.01, 0.02],
        wds=[0.1, 0.0])
    for j, (x, y) in enumerate(zip(
            optimizer_ops.adam_update(*a32, lr=0.01, wd=0.1),
            optimizer_ops.adam_update(*a16, lr=0.02, wd=0.0))):
        assert torch.equal(out[j][0], x) and torch.equal(out[j][1], y)


def test_spmd_trainer_bf16_dense_updates_like_the_reference():
    """Three ``SPMDTrainer`` steps on a ``Dense(64, dtype="bfloat16")``:
    each step's update, on the inputs the trainer handed its optimizer
    op, equals the reference's guarded Adam bit for bit, and the losses
    follow the reference trainer's at bf16 tolerance (rtol 2e-2: the
    two frameworks round the bf16 gradients at other places)."""
    from mxnet_tpu.gluon import loss as jax_loss
    from mxnet_tpu.ndarray import NDArray
    from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
    from mxnet_tpu.parallel import make_mesh

    rng = onp.random.RandomState(7)
    w = (rng.randn(64, 64) * 0.2).astype(onp.float32)
    b = (rng.randn(64) * 0.1).astype(onp.float32)
    x = rng.randn(16, 64).astype(onp.float32)
    y = rng.randint(0, 64, size=(16,)).astype(onp.int32)
    params = {"lr": 0.01, "wd": 0.1}

    jd = jax_nn.Dense(64, in_units=64, dtype="bfloat16")
    jd.initialize()
    jd.weight.set_data(mx.nd.array(w).astype("bfloat16"))
    jd.bias.set_data(mx.nd.array(b).astype("bfloat16"))
    jt = JaxTrainer(jd, jax_loss.SoftmaxCrossEntropyLoss(),
                    optimizer="adam",
                    optimizer_params={"learning_rate": params["lr"],
                                      "wd": params["wd"]},
                    mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    jx = mx.nd.array(x).astype("bfloat16")
    ref_losses = [float(jt.step(jx, NDArray(y)).asnumpy())
                  for _ in range(3)]

    td = nn.Dense(64, in_units=64, dtype="bfloat16")
    td.initialize(device="cpu")
    td.weight.set_data(torch.from_numpy(w).bfloat16())
    td.bias.set_data(torch.from_numpy(b).bfloat16())
    tr = SPMDTrainer(td, gloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                     optimizer_params={"learning_rate": params["lr"],
                                       "wd": params["wd"]}, device="cpu")
    seen = []
    update = tr._update

    def spy(weights, grads, *states, lrs, wds, **kw):
        inputs = [[a.detach().float().numpy().copy() for a in col]
                  for col in (weights, grads, *states)]
        out = update(weights, grads, *states, lrs=lrs, wds=wds, **kw)
        # lrs, wds: one 0-d f32 tensor each for the whole group (every
        # multiplier is 1)
        seen.append((inputs, float(lrs), float(wds),
                     [[a.float().numpy().copy() for a in col]
                      for col in out]))
        return out

    tr._update = spy
    tx = torch.from_numpy(x).bfloat16()
    losses = [float(tr.step(tx, torch.from_numpy(y))) for _ in range(3)]
    assert len(seen) == 3
    for inputs, lr, wd, outs in seen:
        for i in range(len(inputs[0])):
            want = _reference_guarded([col[i] for col in inputs],
                                      jnp.bfloat16, lr, wd)
            for got, ref in zip((o[i] for o in outs), want):
                assert int((got != ref).sum()) == 0
    assert td.weight.data().dtype == torch.bfloat16
    onp.testing.assert_allclose(losses, ref_losses, rtol=2e-2)


def test_spmd_trainer_default_optimizer_is_sgd_like_the_reference():
    """F6: ``SPMDTrainer(net, loss)`` takes the reference's default,
    ``optimizer="sgd"`` (lr 0.01, no momentum), where the port once
    raised "unknown optimizer 'sgd'".  Three steps of a ``Dense(8)`` in
    both packages from the same weights: losses and weights at rtol
    1e-5 (f32)."""
    from mxnet_tpu.gluon import loss as jax_loss
    from mxnet_tpu.ndarray import NDArray
    from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
    from mxnet_tpu.parallel import make_mesh

    rng = onp.random.RandomState(8)
    w = (rng.randn(8, 16) * 0.3).astype(onp.float32)
    x = rng.randn(6, 16).astype(onp.float32)
    y = rng.randint(0, 8, size=(6,)).astype(onp.float32)
    jd = jax_nn.Dense(8, in_units=16)
    jd.initialize()
    jd.weight.set_data(mx.nd.array(w))
    jt = JaxTrainer(jd, jax_loss.SoftmaxCrossEntropyLoss(),
                    mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    want = [float(jt.step(NDArray(x), NDArray(y)).asnumpy())
            for _ in range(3)]
    td = nn.Dense(8, in_units=16)
    td.initialize(device="cpu")
    td.weight.set_data(torch.from_numpy(w))
    tr = SPMDTrainer(td, gloss.SoftmaxCrossEntropyLoss(), device="cpu")
    assert tr.optimizer.op_name == "sgd_update"
    got = [float(tr.step(x, y)) for _ in range(3)]
    onp.testing.assert_allclose(got, want, rtol=1e-5)
    onp.testing.assert_allclose(td.weight.data().detach().numpy(),
                                jd.weight.data().asnumpy(), rtol=1e-5,
                                atol=1e-7)


# -- Dense's arguments ----------------------------------------------------------

@pytest.mark.parametrize("make", [lambda m: m.Dense(5, "relu"),
                                  lambda m: m.Dense(5, activation="tanh"),
                                  lambda m: m.Dense(5, "sigmoid", False),
                                  lambda m: m.Dense(5, "softrelu",
                                                    flatten=False)],
                         ids=["relu-positional", "tanh-keyword",
                              "no-bias-positional", "softrelu"])
def test_dense_activation_matches_reference(make):
    x = onp.random.RandomState(3).randn(4, 2, 6).astype(onp.float32)
    jd, td = make(jax_nn), make(nn)
    jd.initialize(init=mx.initializer.Xavier())
    want = jd(mx.nd.array(x)).asnumpy()
    td.initialize(device="cpu")
    convert.load_collected_params(
        td, {k: p.data().asnumpy() for k, p in jd.collect_params().items()},
        device="cpu")
    got = td(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert repr(td) == repr(jd)


def test_dense_relu_positional_is_a_relu_layer():
    d = nn.Dense(5, "relu", in_units=3)
    d.initialize(device="cpu")
    out = d(torch.randn(64, 3))
    assert float(out.detach().min()) == 0.0 and d.bias is not None


# -- the top level --------------------------------------------------------------

def test_bare_import_exposes_the_subpackages():
    script = textwrap.dedent("""
        import mxnet_tpu_torch as mx
        import torch
        d = mx.gluon.nn.Dense(3, "relu", in_units=2)
        d.initialize(device="cpu")
        assert d(torch.ones(1, 2)).shape == (1, 3)
        for name in ("gluon", "optimizer", "initializer", "parallel",
                     "serving", "tracing", "telemetry", "log"):
            assert hasattr(mx, name), name
        assert mx.optimizer.create("adam") is not None
        assert mx.parallel.SPMDTrainer and mx.serving.ServingServer
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script],
                         cwd=pathlib.Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


# -- F7: the optimizer sets its scheduler's base lr ----------------------------

def _schedulers(pkg):
    return [pkg.lr_scheduler.FactorScheduler(step=3, factor=0.5,
                                             base_lr=0.5),
            pkg.lr_scheduler.CosineScheduler(max_update=20, base_lr=0.5,
                                             warmup_steps=4,
                                             warmup_begin_lr=0.05)]


@pytest.mark.parametrize("which", [0, 1], ids=["factor", "cosine-warmup"])
@pytest.mark.parametrize("kw", [{"learning_rate": 0.1, "momentum": 0.9},
                                {"momentum": 0.9}, {}],
                         ids=["lr-given", "lr-default", "plain"])
def test_optimizer_sets_its_schedulers_base_lr(which, kw):
    """F7: ``create('sgd', lr_scheduler=s, ...)`` with a scheduler whose
    own ``base_lr`` is 0.5 trains at the optimizer's ``learning_rate``
    (0.1 given, SGD's default 0.01 otherwise) in the reference; the port
    kept 0.5.  The warmup's final lr stays the scheduler's own, in both.
    Every ``num_update`` of 0-30 gives the same lr, exactly."""
    import mxnet_tpu.lr_scheduler  # noqa: F401
    import mxnet_tpu_torch.lr_scheduler  # noqa: F401
    ref = mx.optimizer.create("sgd", lr_scheduler=_schedulers(mx)[which],
                              **kw)
    got = mt.optimizer.create("sgd", lr_scheduler=_schedulers(mt)[which],
                              **kw)
    assert got.lr_scheduler.base_lr == ref.lr_scheduler.base_lr
    assert got.lr_scheduler.warmup_final_lr == \
        ref.lr_scheduler.warmup_final_lr
    for n in range(31):
        ref.num_update = got.num_update = n
        assert got.learning_rate == ref.learning_rate, n


# -- F8: the reference's constructor and multipliers ---------------------------

@pytest.mark.parametrize("name,kw", [
    ("adam", {"multi_precision": True}),
    ("sgd", {"aggregate_num": 4, "momentum": 0.9}),
    ("adam", {"use_fused_step": False, "param_idx2name": {0: "w"}}),
    ("rmsprop", {"an_unknown_keyword": 3}),
    ("sgd", {"param_dict": {}, "clip_gradient": 1.0, "rescale_grad": 0.5}),
], ids=["multi_precision", "aggregate_num", "fused-idx2name", "extra",
        "param_dict"])
def test_optimizer_takes_the_reference_arguments(name, kw):
    """F8: these raised ``TypeError`` in the port; both packages accept
    them and keep the same attributes."""
    ref = mx.optimizer.create(name, **kw)
    got = mt.optimizer.create(name, **kw)
    for attr in ("rescale_grad", "lr", "wd", "clip_gradient",
                 "multi_precision", "aggregate_num", "idx2name",
                 "num_update"):
        assert getattr(got, attr) == getattr(ref, attr), attr


def test_aggregation_size_comes_from_the_environment(monkeypatch):
    """F8: ``aggregate_num`` 0 reads ``MXNET_OPTIMIZER_AGGREGATION_SIZE``
    in both packages."""
    monkeypatch.setenv("MXNET_OPTIMIZER_AGGREGATION_SIZE", "7")
    assert mt.optimizer.create("sgd").aggregate_num == \
        mx.optimizer.create("sgd").aggregate_num == 7


def test_learning_rate_setters_and_multipliers_match():
    """F8: ``set_learning_rate`` (and its refusal under a scheduler),
    ``set_lr_mult``/``set_wd_mult`` with the parameters' own multipliers
    from ``param_dict``, ``_get_lr``/``_get_wd`` and ``_update_count``."""
    import mxnet_tpu.lr_scheduler  # noqa: F401
    import mxnet_tpu_torch.lr_scheduler  # noqa: F401

    class P:                          # a parameter's multipliers
        lr_mult, wd_mult = 0.5, 3.0

    outs = []
    for pkg in (mx, mt):
        o = pkg.optimizer.create("sgd", learning_rate=0.2, wd=0.01,
                                 param_idx2name={0: "a", 1: "b", 2: "c"},
                                 param_dict={"a": P()})
        o.set_learning_rate(0.4)
        o.set_lr_mult({"b": 2.0})
        o.set_wd_mult({"b": 0.0, "c": 10.0})
        counts = [o._update_count(i) for i in (0, 1, 1, 2, 1)]
        row = [o.learning_rate, counts, o.num_update]
        row += [(o._get_lr(i), o._get_wd(i)) for i in range(4)]
        s = pkg.optimizer.create("sgd", lr_scheduler=pkg.lr_scheduler.
                                 FactorScheduler(step=2, base_lr=0.3))
        with pytest.raises(Exception, match="already been defined"):
            s.set_learning_rate(0.1)
        outs.append(row)
    assert outs[1] == outs[0]
