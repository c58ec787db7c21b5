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
  as the reference's (exact);
* F9: ``Block.zero_grad`` / ``apply`` / ``register_forward_hook`` /
  ``register_forward_pre_hook`` / ``reset_ctx`` are the reference's, not
  ``torch.nn.Module``'s (gradients and hook arguments exact);
* F10: ``Parameter.data`` / ``grad`` / ``list_data`` / ``list_ctx`` /
  ``reset_ctx`` / ``set_data`` take and return NDArrays (exact);
* F11: ``initialize`` takes ``ctx`` and honours a ``with mx.cpu():``
  scope, ``collect_params`` a regex, and ``ParameterDict`` has
  ``initialize`` / ``reset_ctx``;
* F12: ``mx.kv``, ``optimizer.Ftrl``, ``gluon.nn.Sequential`` and
  ``serving.OutOfPagesError`` / ``PagedKVCache`` exist (``Sequential``'s
  forward at 1e-6);
* F13: ``MXNET_ZERO`` requests ZeRO for the values the reference's
  ``zero_enabled`` takes, and only those;
* F14: ``ServingServer`` takes the reference's constructor (a block or
  an engine, ``engine_args``, ``batcher_args``, ``decoder``, ``start``);
  ``predict`` at rtol 1e-5, ``healthz`` equal;
* F15: ``serving.slo`` keeps the reference's ring of the slowest
  requests, fed only while tracing is on (``requestz`` equal);
* F16: ``serving.__all__`` holds the reference's names;
* F17: ``SPMDTrainer.step`` / ``run_steps`` / ``predict`` take the
  port's NDArrays (unwrapped, no host round trip) and account host
  batches in ``input.h2d_bytes`` / ``input.step_h2d`` as the reference's
  ``_stage_input`` does (losses at rtol 1e-5, counters exact);
* F18: ``step`` / ``run_steps`` / ``predict`` / ``fit`` return NDArrays,
  as the reference's do (values at rtol 1e-5);
* F19: the step record after a profiler cycle carries the cycle's
  device ms over the records emitted while the cycle ran; the
  reference also counts the record that carries it (3 steps in a cycle
  of 30 device ms give 7.5 ms there, 10 ms in the port; exact);
* batch serving's two choices: an id out of range fails its batch with
  ``MXNetError`` where the reference gives NaN rows, and a bf16 output
  comes back widened to float32 (exact) where the reference returns
  ml_dtypes bf16;
* the symbol and deployment path's: a reference export (StableHLO)
  raises ``MXNetError`` at the port's ``SymbolBlock.imports``;
  ``SPMDTrainer.warm_start`` loads nothing (0), with
  ``MXNET_ARTIFACT_DIR`` set too; ``cost_analysis`` fills ``flops`` and
  ``argument_size_in_bytes`` and lists the reference's other keys
  (XLA's cost model and buffer assignment) as ``unfilled``;
  ``mx.name.Prefix`` names a composed node once (the reference twice);
  ``Parameter.var()`` works (the reference's raises ``AttributeError``).

The recurrent family's behaviours the port copies from the reference,
each shown in both packages (values at fp32 1e-5):

* the Gluon ``RNN`` / ``LSTM`` / ``GRU`` layers take ``sequence_length``
  and do not use it;
* the ``RNN`` op's ``lstm_state_clip_min`` / ``_max`` clip only each
  layer's returned cell state, never the cell inside the recurrence
  (cuDNN's clip would), and nothing without ``_min``;
* the ``RNN`` op's dropout ``p > 0`` drops between layers outside
  training too;
* CTC: an unreachable alignment costs 1e30 (``-1e30`` stands for −∞),
  an empty label ``log 2`` less than its blank path's cost, and Gluon's
  ``CTCLoss`` given ``label_lengths`` without ``pred_lengths`` does not
  read them;
* ``LSTMBias`` on a parameter whose name ends in ``bias`` gives zeros
  (the name rule comes first).

And one it does not copy: ``mx.sym.trace`` of a net holding a Gluon RNN
layer raises ``MXNetError`` in the port (torch's RNN call maps to no op
of the reference), where the reference's trace records no node for the
layer and bakes its output into the symbol as a captured constant.
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
    assert td.weight._tensor().dtype == torch.bfloat16
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
    onp.testing.assert_allclose(td.weight._tensor().detach().numpy(),
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


# -- F9-F13: the Gluon surface under persistence ---------------------------------

MLP_X = onp.random.RandomState(5).randn(4, 6).astype(onp.float32)


def _mlp_pair(grad_req="write"):
    """The same two-layer MLP in both packages, on the CPU, with the
    reference's weights carried into the port."""
    ref = jax_nn.HybridSequential()
    ref.add(jax_nn.Dense(5, activation="relu"), jax_nn.Dense(3))
    ref.initialize(init=mx.initializer.Xavier())
    ref(mx.nd.array(MLP_X))
    got = nn.HybridSequential()
    got.add(nn.Dense(5, activation="relu", in_units=6), nn.Dense(3,
                                                               in_units=5))
    got.initialize(device="cpu")
    convert.load_collected_params(
        got, {k: p.data().asnumpy() for k, p in ref.collect_params().items()},
        device="cpu")
    for net in (ref, got):
        net.collect_params().setattr("grad_req", grad_req)
    return ref, got


def _backward(pkg, net, x=MLP_X):
    with pkg.autograd.record():
        y = net(pkg.nd.array(x, ctx=pkg.cpu()))
        loss = (y * y).sum()
    loss.backward()


def test_block_zero_grad_zeroes_the_gluon_buffers():
    """F9: ``net.zero_grad()`` was torch's and left the Gluon buffers;
    with ``grad_req="add"`` both packages accumulate two backwards and
    then read zeros everywhere."""
    ref, got = _mlp_pair("add")
    for pkg, net in ((mx, ref), (mt, got)):
        net.collect_params().zero_grad()
        _backward(pkg, net)
        _backward(pkg, net)
    for k, p in ref.collect_params().items():
        onp.testing.assert_allclose(got.collect_params()[k].grad().asnumpy(),
                                    p.grad().asnumpy(), rtol=1e-5, atol=1e-6)
        assert onp.abs(p.grad().asnumpy()).sum() > 0, k
    ref.zero_grad()
    got.zero_grad()
    for net in (ref, got):
        for k, p in net.collect_params().items():
            assert not onp.any(p.grad().asnumpy()), k


def test_block_apply_and_forward_hooks_follow_the_reference():
    """F9: ``apply`` visits children first then the block and returns it;
    forward hooks get the block, the arguments as passed (NDArrays) and
    the output, and ``detach()`` on the handle removes them."""
    ref, got = _mlp_pair()
    seen = {}
    for name, pkg, net in (("ref", mx, ref), ("got", mt, got)):
        order = []
        assert net.apply(lambda b: order.append(type(b).__name__)) is net
        calls = []
        pre = net[0].register_forward_pre_hook(
            lambda b, args: calls.append(("pre", type(args[0]).__name__)))
        post = net[0].register_forward_hook(
            lambda b, args, out: calls.append(
                ("post", type(out).__name__, out.asnumpy().copy())))
        out = net(pkg.nd.array(MLP_X, ctx=pkg.cpu()))
        pre.detach()
        post.detach()
        net(pkg.nd.array(MLP_X, ctx=pkg.cpu()))
        seen[name] = (order, calls, out.asnumpy())
    assert seen["got"][0] == seen["ref"][0] == \
        ["Dense", "Dense", "HybridSequential"]
    (_, calls_r, out_r), (_, calls_g, out_g) = seen["ref"], seen["got"]
    assert [c[:2] for c in calls_g] == [c[:2] for c in calls_r] == \
        [("pre", "NDArray"), ("post", "NDArray")]
    onp.testing.assert_allclose(calls_g[1][2], calls_r[1][2], rtol=1e-5,
                                atol=1e-6)
    onp.testing.assert_allclose(out_g, out_r, rtol=1e-5, atol=1e-6)


def test_block_reset_ctx_moves_every_parameter():
    """F9: ``reset_ctx`` was absent; it moves every parameter (here CPU
    to CPU, the value kept)."""
    _, got = _mlp_pair()
    before = convert.collected_params_to_numpy(got)
    got.reset_ctx(mt.cpu())
    got.collect_params().reset_ctx([mt.cpu()])
    after = convert.collected_params_to_numpy(got)
    assert all(onp.array_equal(before[k], after[k]) for k in before)
    assert {str(c) for p in got.collect_params().values()
            for c in p.list_ctx()} == {"cpu(0)"}


def test_parameter_data_and_grad_are_ndarrays():
    """F10: ``data()`` returned the ``torch.nn.Parameter`` and
    ``data(ctx)`` / ``grad(ctx)`` / ``list_ctx`` raised; both packages
    now return NDArrays with the same values."""
    ref, got = _mlp_pair()
    for pkg, net in ((mx, ref), (mt, got)):
        _backward(pkg, net)
    for k, rp in ref.collect_params().items():
        gp = got.collect_params()[k]
        for g, r in ((gp.data(), rp.data()), (gp.data(mt.cpu()), rp.data()),
                     (gp.list_data()[0], rp.list_data()[0]),
                     (gp.grad(mt.cpu()), rp.grad())):
            assert isinstance(g, mt.nd.NDArray)
            onp.testing.assert_allclose(g.asnumpy(), r.asnumpy(), rtol=1e-5,
                                        atol=1e-6)
        assert gp.list_ctx() == [mt.cpu()] and len(rp.list_ctx()) == 1
        assert gp.data()._data is gp._tensor()


def test_parameter_set_data_takes_an_ndarray_in_place():
    """F10: ``set_data(nd_array)`` raised ``TypeError``; it now copies
    the value into the parameter's tensor in place (what a captured step
    holds keeps its address), cast to the parameter's type, as the
    reference's value."""
    ref, got = _mlp_pair()
    new = onp.random.RandomState(9).randn(5, 6).astype(onp.float64)
    ref.collect_params()["0.weight"].set_data(mx.nd.array(new))
    p = got.collect_params()["0.weight"]
    held = p._tensor()
    p.set_data(mt.nd.array(new, ctx=mt.cpu(), dtype="float64"))
    assert p._tensor() is held and held.dtype == torch.float32
    onp.testing.assert_array_equal(
        p.data().asnumpy(), ref.collect_params()["0.weight"].data().asnumpy())
    with pytest.raises(mt.MXNetError, match="shape"):
        p.set_data(mt.nd.zeros((2, 2), ctx=mt.cpu()))


def test_initialize_takes_ctx_and_honours_the_scope(monkeypatch):
    """F11: ``initialize(ctx=mx.cpu())`` and ``device=mx.cpu()`` raised
    ``TypeError`` and a ``with mx.cpu():`` scope was ignored; all three,
    and a list of one context, now initialize on the host.  With no
    scope, no argument and no card, ``initialize()`` still raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nets = [nn.Dense(3, in_units=2) for _ in range(5)]
    nets[0].initialize(ctx=mt.cpu())
    nets[1].initialize(ctx=[mt.cpu()])
    nets[2].initialize(device=mt.cpu())
    with mt.cpu():
        nets[3].initialize()
    for net in nets[:4]:
        assert net.weight.list_ctx() == [mt.cpu()]
    with pytest.raises(mt.MXNetError, match="device='cpu'"):
        nets[4].initialize()
    params = nets[4].collect_params()
    params.initialize(ctx=mt.cpu())
    assert params["weight"].list_ctx() == [mt.cpu()]


def test_collect_params_selects_by_regex():
    """F11: ``collect_params(select)`` raised ``TypeError``; it keeps the
    names the regex finds, as the reference's."""
    ref, got = _mlp_pair()
    for select in (".*bias", "^1\\.", "weight$", "nothing"):
        assert list(got.collect_params(select)) == \
            list(ref.collect_params(select)), select


def test_reference_names_exist():
    """F12: ``mx.kv``, ``optimizer.Ftrl``, ``gluon.nn.Sequential`` and
    ``serving.OutOfPagesError`` / ``serving.PagedKVCache``."""
    assert mt.kv is mt.kvstore and mt.kv.create("local") is not None
    assert mt.optimizer.Ftrl is mt.optimizer.FTRL
    assert mx.optimizer.Ftrl is mx.optimizer.FTRL
    from mxnet_tpu_torch.serving.decode import paged_kv
    assert mt.serving.OutOfPagesError is paged_kv.OutOfPagesError
    assert mt.serving.PagedKVCache is paged_kv.PagedKVCache
    for name in ("Ftrl", ):
        assert name in mt.optimizer.__all__
    for name in ("OutOfPagesError", "PagedKVCache"):
        assert name in mt.serving.__all__ and name in mx.serving.__all__


def test_sequential_is_the_eager_container():
    """F12: ``nn.Sequential`` runs its children in order as the
    reference's does (1e-6 on the outputs), and is a plain Block."""
    ref, got = _mlp_pair()
    seq_r, seq_g = jax_nn.Sequential(), nn.Sequential()
    seq_r.add(*ref)
    seq_g.add(*got)
    assert not isinstance(seq_g, mt.gluon.HybridBlock)
    assert len(seq_g) == len(seq_r) == 2 and seq_g[1] is got[1]
    onp.testing.assert_allclose(
        seq_g(mt.nd.array(MLP_X, ctx=mt.cpu())).asnumpy(),
        seq_r(mx.nd.array(MLP_X)).asnumpy(), rtol=1e-6, atol=1e-6)
    assert list(seq_g.collect_params()) == list(seq_r.collect_params())


@pytest.mark.parametrize("value", ["1", "true", "on", "0", "no", "yes",
                                   "off", "false", ""])
def test_mxnet_zero_is_read_as_the_reference_reads_it(value, monkeypatch):
    """F13: the port took every value but 0/""/false/off as a request for
    ZeRO (``MXNET_ZERO=yes`` made ``step`` raise while ZeRO was not
    ported); both request it for 1, true and on only.  ZeRO is ported
    since: a requested one at a dp width of 1 (no process group) steps
    as the reference's does."""
    from mxnet_tpu.optimizer import fused_step as jax_fused
    from mxnet_tpu_torch.optimizer import fused_step as port_fused
    monkeypatch.setenv("MXNET_ZERO", value)
    assert port_fused.zero_enabled() == jax_fused.zero_enabled()
    _, got = _mlp_pair()
    tr = mt.gluon.Trainer(got.collect_params(), "sgd")
    assert tr._zero_active() == jax_fused.zero_enabled()
    _backward(mt, got)
    tr.step(4)


# -- F14-F16: batch serving's surface ----------------------------------------

SERVE_KW = dict(engine_args={"example_shape": (6,), "dtype": "float32"},
                batcher_args={"max_batch_size": 4, "max_delay_ms": 0.5})


def test_serving_server_takes_the_reference_constructor():
    """F14: ``ServingServer(block_or_engine, engine_args, batcher_args,
    decoder, start)`` serves ``predict`` (rows at rtol 1e-5) and its
    ``healthz`` has the reference's keys and values."""
    ref, got = _mlp_pair()
    servers = (mx.serving.ServingServer(ref, **SERVE_KW),
               mt.serving.ServingServer(got, **SERVE_KW))
    try:
        for srv in servers:
            assert srv.warmup([1, 4]) == ["1x6:float32", "4x6:float32"]
        for x in MLP_X:
            onp.testing.assert_allclose(servers[1].predict(x),
                                        onp.asarray(servers[0].predict(x)),
                                        rtol=1e-5, atol=1e-6)
        want, have = (srv.healthz() for srv in servers)
        assert have == want
    finally:
        for srv in servers:
            srv.stop()
    assert servers[1].healthz()["status"] == "draining"


def test_slow_request_ring_is_the_references():
    """F15: no port-only ``recent_requests``; ``observe_request`` feeds
    the ring of the N slowest requests only while tracing is on (no
    objective can be declared), and ``requestz`` reads it as the
    reference's does."""
    from mxnet_tpu import tracing as jax_tracing
    from mxnet_tpu.serving import slo as jax_slo
    from mxnet_tpu_torch import tracing
    from mxnet_tpu_torch.serving import slo
    assert not hasattr(slo, "recent_requests")
    entries = [{"id": i, "ok": True, "latency_ms": float((7 * i) % 5)}
               for i in range(6)]
    views = []
    for s, tr in ((jax_slo, jax_tracing), (slo, tracing)):
        s.clear_ring()
        try:
            tr.disable()
            s.observe_request(dict(entries[0]))
            assert s.requestz()["tracked"] == 0
            tr.enable()
            for e in entries:
                s.observe_request(dict(e))
            v = s.requestz(limit=3)
            views.append({k: v[k] for k in ("ring_capacity", "tracked",
                                            "slowest")})
        finally:
            tr._env_default()
            s.clear_ring()
    assert views[1] == views[0]
    assert [e["id"] for e in views[1]["slowest"]] == [2, 4, 1]


def test_serving_exports_the_references_names():
    """F16: ``serving.__all__`` holds every name of the reference's,
    ``InferenceEngine``, ``DynamicBatcher``, ``serving_enabled`` and
    ``decode`` among them."""
    assert set(mx.serving.__all__) <= set(mt.serving.__all__)
    for name in ("InferenceEngine", "DynamicBatcher", "serving_enabled",
                 "decode"):
        assert getattr(mt.serving, name) is not None


# -- batch serving: reference behaviours the port does not copy --------------

def _embedding_pair():
    ref = jax_nn.HybridSequential()
    ref.add(jax_nn.Embedding(10, 4), jax_nn.Dense(3, flatten=False))
    ref.initialize()
    ref(mx.nd.array(onp.zeros((1, 3), onp.int32)))
    got = nn.HybridSequential()
    got.add(nn.Embedding(10, 4), nn.Dense(3, flatten=False, in_units=4))
    got.initialize(device="cpu")
    convert.load_collected_params(
        got, {k: p.data().asnumpy() for k, p in ref.collect_params().items()},
        device="cpu")
    return ref, got


def test_out_of_range_id_fails_its_batch_only():
    """A served id out of range fails its own batch with MXNetError and
    the next batch serves (rows at 1e-6); the reference gives the
    position of that id a NaN row (``jnp.take``'s fill).  A choice,
    pinned here."""
    ref, got = _embedding_pair()
    ids = onp.asarray([[1, 2, 3], [4, 12, 5]], onp.int32)
    kw = dict(example_shape=(3,), dtype="int32")
    jb = mx.serving.DynamicBatcher(mx.serving.InferenceEngine(ref, **kw),
                                   start=False)
    pb = mt.serving.DynamicBatcher(mt.serving.InferenceEngine(got, **kw),
                                   start=False)
    jfuts = [jb.submit(x) for x in ids]
    jb.flush()
    nan_rows = onp.isnan(onp.asarray(jfuts[1].result(0))).all(axis=1)
    assert nan_rows.tolist() == [False, True, False]
    pfuts = [pb.submit(x) for x in ids]
    pb.flush()
    for f in pfuts:
        with pytest.raises(mt.MXNetError, match=r"\[0, 10\)"):
            f.result(0)
    nxt = pb.submit(ids[0])
    pb.flush()
    onp.testing.assert_allclose(nxt.result(0),
                                onp.asarray(jfuts[0].result(0)),
                                rtol=1e-6, atol=1e-6)


def test_bf16_outputs_are_widened_to_f32():
    """numpy has no bfloat16: the port returns a bf16 output as float32
    on the host, exactly the bf16 values; the reference returns
    ml_dtypes bf16 arrays (equal values at 2e-2)."""
    ref, got = _mlp_pair()
    for net in (ref, got):
        net.cast("bfloat16")
    rows = [mx.serving.InferenceEngine(ref, example_shape=(6,),
                                       dtype="bfloat16").infer(
        onp.asarray(mx.nd.array(x, dtype="bfloat16").asnumpy()))
        for x in MLP_X[:2]]
    assert str(rows[0].dtype) == "bfloat16"
    eng = mt.serving.InferenceEngine(got, example_shape=(6,),
                                     dtype="bfloat16")
    batch = torch.from_numpy(MLP_X[:2]).to(torch.bfloat16)
    results, meta = eng.infer_batch(batch)
    assert meta["device_committed"] and meta["compiled"]
    with torch.no_grad():
        want = got(batch).float().numpy()
    for r, w, j in zip(results, want, rows):
        assert r.dtype == onp.float32
        onp.testing.assert_array_equal(r, w)
        onp.testing.assert_allclose(r, onp.asarray(j, onp.float32),
                                    rtol=2e-2, atol=2e-2)


# -- F17 / F18: SPMDTrainer's batches and results are NDArrays --------------

def _dense_pair(seed=17):
    """A ``Dense(4, in_units=3)`` and its trainer in each package, from the
    same weights, with (data, label) numpy batches."""
    from mxnet_tpu.gluon import loss as jax_loss
    from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
    from mxnet_tpu.parallel import make_mesh
    rng = onp.random.RandomState(seed)
    w = (rng.randn(4, 3) * 0.5).astype(onp.float32)
    x = rng.randn(8, 3).astype(onp.float32)
    y = rng.randint(0, 4, size=(8,)).astype(onp.float32)
    jd = jax_nn.Dense(4, in_units=3)
    jd.initialize()
    jd.weight.set_data(mx.nd.array(w))
    jt = JaxTrainer(jd, jax_loss.SoftmaxCrossEntropyLoss(),
                    mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    td = nn.Dense(4, in_units=3)
    td.initialize(device="cpu")
    td.weight.set_data(torch.from_numpy(w))
    tr = SPMDTrainer(td, gloss.SoftmaxCrossEntropyLoss(), device="cpu")
    return jt, tr, x, y


def test_spmd_trainer_takes_ndarray_batches_like_the_reference():
    """F17: the port's ``SPMDTrainer`` once ran ``numpy.asarray`` on an
    NDArray batch (an object array of NDArray scalars, refused by torch).
    ``step``, ``run_steps`` (one batch, and a window with
    ``per_step_data``) and ``predict`` take NDArrays in both packages:
    losses and outputs at rtol 1e-5.  An NDArray already on the trainer's
    device is not counted as a host copy; a numpy batch is, as in the
    reference (``input.step_h2d`` one a staged array, ``input.h2d_bytes``
    its bytes: exact)."""
    from mxnet_tpu import telemetry as jax_tel
    from mxnet_tpu.ndarray import NDArray as JaxND
    jt, tr, x, y = _dense_pair()
    want = [float(jt.step(JaxND(x), JaxND(y)).asnumpy()) for _ in range(2)]
    got = [float(tr.step(_port(x), _port(y))) for _ in range(2)]
    onp.testing.assert_allclose(got, want, rtol=1e-5)
    want = jt.run_steps(JaxND(x), JaxND(y), 2).asnumpy()
    got = tr.run_steps(_port(x), _port(y), 2).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-5)
    xw, yw = onp.stack([x, x[::-1]]), onp.stack([y, y[::-1]])
    want = jt.run_steps(JaxND(xw), JaxND(yw), 2,
                        per_step_data=True).asnumpy()
    got = tr.run_steps(_port(xw), _port(yw), 2,
                       per_step_data=True).asnumpy()
    onp.testing.assert_allclose(got, want, rtol=1e-5)
    onp.testing.assert_allclose(tr.predict(_port(x)).asnumpy(),
                                onp.asarray(jt.predict(JaxND(x))._data),
                                rtol=1e-5, atol=1e-6)
    counters = {}
    for name, tel, trainer in (("ref", jax_tel, jt), ("port", mt.telemetry,
                                                      tr)):
        before = {k: tel.counter(k).value
                  for k in ("input.step_h2d", "input.h2d_bytes")}
        trainer.step(x, y)
        counters[name] = {k: tel.counter(k).value - v
                          for k, v in before.items()}
    assert counters["port"] == counters["ref"] == {
        "input.step_h2d": 2, "input.h2d_bytes": x.nbytes + y.nbytes}
    before = mt.telemetry.counter("input.step_h2d").value
    tr.step(_port(x), _port(y))          # already on the trainer's device
    assert mt.telemetry.counter("input.step_h2d").value == before


def test_spmd_trainer_returns_ndarrays_like_the_reference():
    """F18: ``step``, ``run_steps``, ``predict`` and ``fit`` return
    NDArrays, as the reference's do, where the port returned bare
    tensors: a reference loop's ``loss.asscalar()`` runs on both (rtol
    1e-5).  The result wraps the trainer's own copy: the next step does
    not overwrite it."""
    from mxnet_tpu.ndarray import NDArray as JaxND
    jt, tr, x, y = _dense_pair(18)
    first_ref = jt.step(x, y)
    first = tr.step(x, y)
    assert isinstance(first, mt.nd.NDArray)
    assert isinstance(first_ref, JaxND)
    kept = first.asscalar()
    onp.testing.assert_allclose(kept, first_ref.asscalar(), rtol=1e-5)
    tr.step(x, y)
    jt.step(x, y)
    assert first.asscalar() == kept
    losses = tr.run_steps(x, y, 3)
    assert isinstance(losses, mt.nd.NDArray) and losses.shape == (3,)
    onp.testing.assert_allclose(losses.asnumpy(),
                                jt.run_steps(x, y, 3).asnumpy(), rtol=1e-5)
    out = tr.predict(x)
    assert isinstance(out, mt.nd.NDArray) and out.shape == (8, 4)
    fitted = tr.fit([(x, y), (x[::-1], y[::-1])])
    fitted_ref = jt.fit([(x, y), (x[::-1], y[::-1])])
    assert all(isinstance(v, mt.nd.NDArray) for v in fitted)
    onp.testing.assert_allclose([v.asscalar() for v in fitted],
                                [v.asscalar() for v in fitted_ref],
                                rtol=1e-5)


# -- F19: device ms a step after a profiler cycle ------------------------------

def test_device_ms_averages_the_records_of_the_cycle(monkeypatch):
    """F19: three records emitted while a profiler cycle of 30 device ms
    ran, then the record that carries its device time: 10 ms a step.
    The reference divides by the carrying record too (7.5 ms); the
    device totals are faked in both, so the test runs on the CPU."""
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu import xplane
    from mxnet_tpu_torch import kineto, telemetry
    monkeypatch.setattr(kineto, "device_total_ms", lambda d: 30.0)
    monkeypatch.setattr(xplane, "device_total_ms", lambda d: 30.0)
    got = {}
    for name, tel in (("port", telemetry), ("ref", jtel)):
        records = []

        class Sink:
            def emit(self, r):
                records.append(r)

        sink = Sink()
        tel.add_sink(sink)
        try:
            tel._note_trace_start()
            for _ in range(3):
                tel.end_step(tel.begin_step(), "test")
            tel._note_trace_stop("trace-dir")
            tel.end_step(tel.begin_step(), "test")
        finally:
            tel.remove_sink(sink)
        got[name] = [r["device_ms"] for r in records]
    assert got["port"] == [None, None, None, 10.0]
    assert got["ref"] == [None, None, None, 7.5]


def test_fused_step_refreshes_the_opt_state_gauge():
    """F22: the reference's fused ``gluon.Trainer`` step refreshes
    ``opt_state.bytes_per_device`` (``optimizer/fused_step.py:697``); the
    port's did not, so a step record's ``opt_state_bytes`` was whatever
    an earlier trainer in the process had left (None in a fresh one)."""
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu_torch import telemetry
    rng = onp.random.RandomState(0)
    w = rng.randn(4, 3).astype("float32")
    x = rng.randn(5, 3).astype("float32")
    y = rng.randint(0, 4, 5).astype("float32")
    got = {}
    for name, pkg, tel, layers, lossmod in (
            ("reference", mx, jtel, jax_nn, None),
            ("port", mt, telemetry, nn, gloss)):
        tel.gauge("opt_state.bytes_per_device").set(None)
        net = layers.Dense(4, in_units=3, use_bias=False)
        if pkg is mt:
            net.initialize(device="cpu")
            net.weight.set_data(torch.tensor(w))
            data, label = _port(x), _port(y)
            lf = gloss.SoftmaxCrossEntropyLoss()
        else:
            from mxnet_tpu.gluon import loss as jax_loss
            net.initialize()
            net.weight.set_data(mx.nd.array(w))
            data, label = mx.nd.array(x), mx.nd.array(y)
            lf = jax_loss.SoftmaxCrossEntropyLoss()
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
        with pkg.autograd.record():
            loss = lf(net(data), label)
        loss.backward()
        tr.step(5)
        got[name] = tel.gauge("opt_state.bytes_per_device").value
    assert got["port"] == got["reference"] == w.nbytes


# -- the symbol and deployment path -------------------------------------------

def _ref_dense():
    net = jax_nn.HybridSequential()
    net.add(jax_nn.Dense(4, in_units=3))
    net.initialize()
    return net


def test_a_reference_export_raises_at_import(tmp_path):
    """The reference's export holds StableHLO, which torch cannot run:
    the port's ``SymbolBlock.imports`` says so instead of failing
    later."""
    from mxnet_tpu_torch.gluon import SymbolBlock
    net = _ref_dense()
    net.hybridize()
    net(mx.nd.array(onp.ones((2, 3), "float32")))
    sym_file, param_file = net.export(str(tmp_path / "ref"))
    with pytest.raises(mt.MXNetError, match="StableHLO"):
        SymbolBlock.imports(sym_file, ["data"], param_file, ctx=mt.cpu())


def test_warm_start_loads_nothing(monkeypatch, tmp_path):
    """The reference installs stored step executables; the port has none
    to store (a CUDA graph lives in its process): 0, with the store's
    directory set or not."""
    net = nn.Dense(4, in_units=3)
    net.initialize(device="cpu")
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), device="cpu")
    assert tr.warm_start() == 0
    monkeypatch.setenv("MXNET_ARTIFACT_DIR", str(tmp_path))
    assert tr.warm_start() == 0


def test_cost_analysis_keys_torch_cannot_fill():
    """Every key of the reference's ``cost_analysis`` is either filled by
    the port (``flops``, ``argument_size_in_bytes``) or listed, by its
    stem, in ``unfilled``."""
    from mxnet_tpu.gluon import loss as jax_loss
    from mxnet_tpu.parallel import SPMDTrainer as RefTrainer
    from mxnet_tpu.parallel.mesh import make_mesh
    x = onp.ones((2, 3), "float32")
    y = onp.array([1, 2], "float32")
    ref = RefTrainer(_ref_dense(), jax_loss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1},
                     mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]))
    ref.step(mx.nd.array(x), mx.nd.array(y))
    ref_keys = set(ref.cost_analysis(mx.nd.array(x), mx.nd.array(y)))
    net = nn.Dense(4, in_units=3)
    net.initialize(device="cpu")
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), device="cpu")
    got = tr.cost_analysis(x, y)
    filled = set(got) - {"unfilled"}
    assert filled == {"flops", "argument_size_in_bytes"} <= ref_keys
    assert got["flops"] == 2 * (2 * 2 * 3 * 4)      # x·W and dW; no dx
    for key in ref_keys - filled:
        assert any(key.startswith(stem) for stem in got["unfilled"]), key


def test_prefix_names_a_composed_node_once():
    """The reference's composer passes an auto name through the name
    manager twice, so under ``Prefix("p_")`` the node is
    ``p_p_fullyconnectedN`` beside its ``p_fullyconnectedN_weight``; the
    port's node and its variables share one prefix."""
    with mx.name.Prefix("p_"):
        ref = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2)
    with mt.name.Prefix("p_"):
        got = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2)
    assert ref.name.startswith("p_p_fullyconnected")
    assert ref.list_arguments()[1].startswith("p_fullyconnected")
    assert got.list_arguments()[1] == got.name + "_weight"
    assert got.name.startswith("p_fullyconnected")


def test_parameter_var_is_a_symbol_variable():
    """``Parameter.var()`` in the reference calls ``Symbol.var``, which
    does not exist; the port's gives ``mx.sym.var(name)``."""
    from mxnet_tpu.gluon.parameter import Parameter as RefParameter
    with pytest.raises(AttributeError):
        RefParameter("w").var()
    v = mt.gluon.Parameter("w").var()
    assert isinstance(v, mt.sym.Symbol) and v.list_arguments() == ["w"]


# -- the recurrent family: the reference's behaviours the port keeps -----------

def _rnn_layers(kind, **kw):
    from mxnet_tpu.gluon import rnn as ref_rnn
    from mxnet_tpu_torch.gluon import rnn as port_rnn
    mx.random.seed(0)
    ref = getattr(ref_rnn, kind)(5, input_size=3, **kw)
    ref.initialize(init=mx.initializer.Xavier())
    port = getattr(port_rnn, kind)(5, input_size=3, **kw)
    port.initialize(device="cpu")
    convert.load_collected_params(
        port, {k: p.data().asnumpy()
               for k, p in ref.collect_params().items()}, device="cpu")
    return ref, port


def test_rnn_layer_ignores_sequence_length():
    """``forward(x, states, sequence_length)``: every row runs all T
    steps, in both packages."""
    ref, port = _rnn_layers("LSTM", num_layers=2, bidirectional=True)
    x = onp.random.RandomState(0).randn(6, 2, 3).astype("f4")
    lens = onp.array([2, 6], "f4")
    outs = {}
    for name, pkg, net, ctx in (("ref", mx, ref, {}),
                                ("port", mt, port, {"ctx": mt.cpu()})):
        st = net.begin_state(batch_size=2)
        xs = pkg.nd.array(x, **ctx)
        with_len, _ = net(xs, st, pkg.nd.array(lens, **ctx))
        without, _ = net(xs, st)
        onp.testing.assert_array_equal(with_len.asnumpy(),
                                       without.asnumpy())
        assert abs(with_len.asnumpy()[2:, 0]).max() > 0
        outs[name] = with_len.asnumpy()
    onp.testing.assert_allclose(outs["port"], outs["ref"], rtol=1e-5,
                                atol=1e-6)


def _clip_case():
    from mxnet_tpu_torch.ops.rnn import rnn_param_size
    rng = onp.random.RandomState(1)
    n = rnn_param_size("lstm", 3, 4, 2)
    arrays = [rng.randn(6, 2, 3).astype("f4"),
              rng.uniform(-1, 1, n).astype("f4"),
              rng.randn(2, 2, 4).astype("f4"),
              rng.randn(2, 2, 4).astype("f4")]
    return arrays, dict(state_size=4, num_layers=2, mode="lstm",
                        state_outputs=True)


def test_rnn_op_clips_only_the_returned_cell_state():
    """With the clip, the output sequence and the returned h equal the
    unclipped run's; only the returned c is clipped; ``_max`` alone
    clips nothing."""
    from mxnet_tpu.ops.registry import invoke as ref_invoke
    from mxnet_tpu_torch.ops.registry import invoke as port_invoke
    arrays, kw = _clip_case()
    clip = dict(lstm_state_clip_min=-0.1, lstm_state_clip_max=0.1)
    for invoke, wrap in ((ref_invoke, mx.nd.array), (port_invoke, _port)):
        plain = [o.asnumpy() for o in invoke("RNN", [wrap(a) for a in arrays],
                                             **kw)]
        clipped = [o.asnumpy() for o in invoke(
            "RNN", [wrap(a) for a in arrays], **kw, **clip)]
        only_max = [o.asnumpy() for o in invoke(
            "RNN", [wrap(a) for a in arrays], **kw, lstm_state_clip_max=0.1)]
        onp.testing.assert_array_equal(clipped[0], plain[0])
        onp.testing.assert_array_equal(clipped[1], plain[1])
        onp.testing.assert_array_equal(clipped[2],
                                       onp.clip(plain[2], -0.1, 0.1))
        assert abs(plain[2]).max() > 0.1
        for a, b in zip(only_max, plain):
            onp.testing.assert_array_equal(a, b)


def test_rnn_op_dropout_applies_outside_training():
    """``p > 0`` drops between layers with no ``record()`` or training
    mode, in both packages (the Gluon layers pass ``p`` only in
    training)."""
    from mxnet_tpu.ops.registry import invoke as ref_invoke
    from mxnet_tpu_torch.ops.registry import invoke as port_invoke
    F_ = 32
    flat = onp.concatenate([onp.eye(F_, dtype="f4").ravel(),
                            onp.zeros(F_ * F_, "f4"),
                            onp.eye(F_, dtype="f4").ravel(),
                            onp.zeros(F_ * F_, "f4"), onp.zeros(4 * F_, "f4")])
    x = onp.random.RandomState(2).uniform(0.5, 1.5, (4, 8, F_)).astype("f4")
    h0 = onp.zeros((2, 8, F_), "f4")
    kw = dict(state_size=F_, num_layers=2, mode="rnn_relu", p=0.5)
    for invoke, wrap in ((ref_invoke, mx.nd.array), (port_invoke, _port)):
        assert not mt.autograd.is_training() and not mx.autograd.is_training()
        out = invoke("RNN", [wrap(a) for a in (x, flat, h0)], **kw)
        out = (out[0] if isinstance(out, list) else out).asnumpy()
        share = float((out == 0).mean())
        assert 0.4 < share < 0.6, share


def test_ctc_keeps_the_references_sentinels_and_gluon_arguments():
    """An unreachable alignment gives 1e30 and an empty label the blank
    path's cost less ``log 2`` in both packages; Gluon's ``CTCLoss``
    with ``label_lengths`` alone gives the loss of the padded labels in
    both (the lengths land in the op's unused ``data_lengths`` slot)."""
    from mxnet_tpu.gluon import loss as ref_loss
    from mxnet_tpu.ops.registry import get as ref_get
    from mxnet_tpu_torch.ops import nn as nn_ops
    rng = onp.random.RandomState(3)
    data = rng.randn(3, 2, 4).astype("f4")
    label = onp.array([[2, 2, 2], [-1, -1, -1]], "f4")
    ref = onp.asarray(ref_get("CTCLoss").fn(jnp.asarray(data),
                                            jnp.asarray(label)))
    got = nn_ops.ctc_loss(torch.from_numpy(data),
                          torch.from_numpy(label)).numpy()
    logp = torch.log_softmax(torch.from_numpy(data), -1)
    blank = -float(logp[:, 1, 0].sum())
    for out in (ref, got):
        assert out[0] == onp.float32(1e30)
        assert abs(out[1] - (blank - onp.log(2))) < 1e-5
    pred = rng.randn(2, 6, 5).astype("f4")                 # NTC
    lab = onp.array([[1, 2, 3], [4, 1, 2]], "f4")
    short = onp.array([1, 2], "f4")
    r = ref_loss.CTCLoss()(mx.nd.array(pred), mx.nd.array(lab),
                           label_lengths=mx.nd.array(short)).asnumpy()
    r_full = ref_loss.CTCLoss()(mx.nd.array(pred),
                                mx.nd.array(lab)).asnumpy()
    g = gloss.CTCLoss()(torch.from_numpy(pred), torch.from_numpy(lab),
                        label_lengths=torch.from_numpy(short)).numpy()
    onp.testing.assert_allclose(r, r_full, rtol=1e-6)
    onp.testing.assert_allclose(g, r, rtol=1e-5)


def test_lstm_bias_on_a_bias_name_gives_zeros():
    """``LSTMBias`` as a layer's ``i2h_bias_initializer``: the name rule
    for ``*bias`` runs first, so the bias is zeros in both packages
    (the forget-gate value shows under another name)."""
    from mxnet_tpu.gluon import rnn as ref_rnn
    from mxnet_tpu_torch.gluon import rnn as port_rnn
    ref = ref_rnn.LSTM(4, input_size=3,
                       i2h_bias_initializer=mx.initializer.LSTMBias(1.0))
    ref.initialize()
    port = port_rnn.LSTM(4, input_size=3,
                         i2h_bias_initializer=mt.initializer.LSTMBias(1.0))
    port.initialize(device="cpu")
    for net in (ref, port):
        onp.testing.assert_array_equal(net.l0_i2h_bias.data().asnumpy(),
                                       onp.zeros(16, "f4"))
    want = onp.zeros(16, "f4")
    want[4:8] = 1.0
    onp.testing.assert_array_equal(
        mt.initializer.LSTMBias(1.0).init_array(
            "forget", (16,), torch.float32, torch.Generator()).numpy(), want)


def test_trace_of_an_rnn_layer_raises_where_the_reference_bakes_it_in():
    from mxnet_tpu.gluon import nn as ref_nn
    from mxnet_tpu.gluon import rnn as ref_rnn
    from mxnet_tpu_torch.gluon import rnn as port_rnn
    x = onp.random.RandomState(4).randn(5, 2, 3).astype("f4")
    ref = ref_nn.HybridSequential()
    ref.add(ref_rnn.LSTM(4, input_size=3), ref_nn.Dense(2, flatten=False))
    ref.initialize()
    sym, args, _ = mx.sym.trace(ref, mx.nd.array(x))
    assert [a for a in sym.list_arguments() if "lstm" in a or "l0" in a] \
        == []
    port = nn.HybridSequential()
    port.add(port_rnn.LSTM(4, input_size=3), nn.Dense(2, flatten=False))
    port.initialize(device="cpu")
    with pytest.raises(mt.MXNetError, match="lstm"):
        mt.sym.trace(port, torch.from_numpy(x))
