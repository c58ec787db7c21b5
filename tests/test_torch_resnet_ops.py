"""The ops of the ResNet path against the reference on the same numpy
inputs, on the CPU, through the shared helper of ``test_torch_parity.py``
(forward and gradients; fp32 1e-5 forward / 1e-4 gradients, bf16 2e-2):

* ``Convolution``: 1-D, 2-D and 3-D; stride, pad, dilate, groups, bias;
* ``Pooling``: max, avg, sum and lp; global max and avg; ``full``
  (rounding up) and ``count_include_pad=False``; inputs hold distinct
  values exact in bf16, so that no window's max is tied;
* ``BatchNorm``: batch statistics (the statistics returned too) and
  moving ones, ``fix_gamma``, another axis; and the Gluon layer's
  running update at a 2×4×4 batch, where an unbiased variance would be
  off by 32/31 (a negative ``axis`` is left out: the reference then
  reduces over every axis, the channel one too, and the port does not
  copy that);
* ``flatten``, ``softmax``, ``softmax_cross_entropy`` and
  ``SoftmaxOutput``, and ``mx.nd`` reaching the registered ops;
* ``sgd_update`` and ``sgd_mom_update`` (and their ``_multi`` forms
  with lr and wd as 0-d tensors) against the reference ops, bf16 under
  the reference's low-precision guard: bitwise.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.ops import optimizer_ops as jax_opt
from mxnet_tpu.ops.registry import get as jax_op
from mxnet_tpu.optimizer.optimizer import _lowp_guard

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ops import nn as nn_ops
from mxnet_tpu_torch.ops import optimizer_ops
from mxnet_tpu_torch.ops import tensor as tensor_ops

from test_torch_parity import assert_parity, close

DTYPES = ["float32", "bfloat16"]


def _normal(seed, *shapes):
    rng = onp.random.RandomState(seed)
    return [rng.standard_normal(s).astype(onp.float32) for s in shapes]


def _distinct(seed, shape):
    """Distinct values exact in bf16 (multiples of 1/8 below 32 in
    magnitude), in a random order."""
    n = int(onp.prod(shape))
    assert n <= 512
    perm = onp.random.RandomState(seed).permutation(n)
    return ((perm - n / 2) / 8).astype(onp.float32).reshape(shape)


# -- Convolution ----------------------------------------------------------------

CONV_CASES = {
    "2d_pad1_bias": ((2, 4, 9, 9), (6, 4, 3, 3), True,
                     dict(kernel=(3, 3), pad=(1, 1))),
    "2d_stride2_nobias": ((2, 4, 9, 9), (6, 4, 3, 3), False,
                          dict(kernel=(3, 3), stride=(2, 2))),
    "2d_dilate2": ((1, 3, 11, 11), (4, 3, 3, 3), True,
                   dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2))),
    "2d_groups2": ((2, 4, 8, 8), (6, 2, 3, 3), True,
                   dict(kernel=(3, 3), pad=(1, 1), num_group=2)),
    "2d_1x1_stride2": ((2, 8, 7, 7), (4, 8, 1, 1), False,
                       dict(kernel=(1, 1), stride=(2, 2))),
    "2d_7x7_stem": ((1, 3, 16, 16), (4, 3, 7, 7), False,
                    dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3))),
    "1d": ((2, 4, 11), (5, 4, 3), True,
           dict(kernel=(3,), stride=(2,), pad=(1,))),
    "3d": ((1, 2, 5, 6, 6), (3, 2, 3, 3, 3), True,
           dict(kernel=(3, 3, 3), pad=(1, 1, 1))),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution(case, dtype):
    xs, ws, bias, params = CONV_CASES[case]
    arrays = _normal(7, xs, ws) + (_normal(8, (ws[0],)) if bias else [])
    ref_fn = jax_op("Convolution").fn

    def jax_fn(*a):
        return ref_fn(*a, **params)

    def torch_fn(*a):
        return nn_ops.convolution(*a, **params)

    assert_parity(jax_fn, torch_fn, arrays, dtype)


def test_convolution_channels_last_raises():
    x = torch.zeros((1, 4, 4, 2))
    with pytest.raises(MXNetError, match="not ported"):
        nn_ops.convolution(x, torch.zeros((3, 3, 3, 2)), kernel=(3, 3),
                           layout="NHWC")


# -- Pooling --------------------------------------------------------------------

POOL_CASES = {
    "max_3s2p1": ((2, 2, 10, 10), dict(kernel=(3, 3), stride=(2, 2),
                                       pad=(1, 1), pool_type="max")),
    "avg_3s2p1": ((2, 2, 10, 10), dict(kernel=(3, 3), stride=(2, 2),
                                       pad=(1, 1), pool_type="avg")),
    "avg_3s2p1_exclude_pad": ((2, 2, 10, 10), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        count_include_pad=False)),
    "max_full": ((2, 2, 10, 10), dict(kernel=(3, 3), stride=(2, 2),
                                      pool_type="max",
                                      pooling_convention="full")),
    "avg_full_exclude_pad": ((2, 2, 10, 10), dict(
        kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full", count_include_pad=False)),
    "avg_full_include_pad": ((2, 2, 11, 11), dict(
        kernel=(2, 2), stride=(2, 2), pool_type="avg",
        pooling_convention="full")),
    "sum_2x2": ((2, 2, 8, 8), dict(kernel=(2, 2), pool_type="sum")),
    "lp_2x2": ((2, 2, 8, 8), dict(kernel=(2, 2), pool_type="lp",
                                  p_value=2)),
    "global_avg": ((2, 4, 7, 7), dict(kernel=(1,), global_pool=True,
                                      pool_type="avg")),
    "global_max": ((2, 4, 7, 7), dict(kernel=(1,), global_pool=True,
                                      pool_type="max")),
    "max_1d": ((2, 3, 20), dict(kernel=(3,), stride=(2,), pad=(1,),
                                pool_type="max")),
    "avg_3d": ((1, 2, 6, 6, 6), dict(kernel=(2, 2, 2), pool_type="avg")),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling(case, dtype):
    shape, params = POOL_CASES[case]
    ref_fn = jax_op("Pooling").fn
    ref, got = assert_parity(lambda x: ref_fn(x, **params),
                             lambda x: nn_ops.pooling(x, **params),
                             [_distinct(5, shape)], dtype)
    if params.get("global_pool"):
        assert got[0].shape == shape[:2] + (1, 1)


def test_pooling_full_rounds_up_and_max_pads_with_minus_inf():
    """10 → 5 rows under ``full`` at k 3 s 2 (``valid``: 4); a max
    window over an all-negative edge keeps the negative value, not the
    padding's 0."""
    x = -1.0 - torch.rand((1, 1, 10, 10))
    full = nn_ops.pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                          pooling_convention="full")
    valid = nn_ops.pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    padded = nn_ops.pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            pool_type="max")
    assert full.shape[-1] == 5 and valid.shape[-1] == 4
    assert (full < -1).all() and (padded < -1).all()


# -- BatchNorm ------------------------------------------------------------------

BN_CASES = {
    "batch_stats": ((2, 4, 4, 4), 1, dict(use_batch_stats=True,
                                          fix_gamma=False)),
    "batch_stats_fix_gamma": ((2, 4, 4, 4), 1, dict(use_batch_stats=True,
                                                    fix_gamma=True)),
    "moving_stats": ((2, 4, 4, 4), 1, dict(use_batch_stats=False,
                                           fix_gamma=False)),
    "global_stats_win": ((2, 4, 4, 4), 1, dict(use_batch_stats=True,
                                               use_global_stats=True,
                                               fix_gamma=False)),
    "2d_input": ((16, 5), 1, dict(use_batch_stats=True, fix_gamma=False)),
    "last_axis": ((3, 4, 6), 2, dict(use_batch_stats=True,
                                     fix_gamma=False)),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm(case, dtype):
    """``(out, mean, var)`` and the gradients through ``out`` (the
    statistics carry none in the port)."""
    shape, axis, params = BN_CASES[case]
    c = shape[axis]
    x, gamma, beta, mean = _normal(11, shape, (c,), (c,), (c,))
    var = 0.5 + onp.random.RandomState(12).rand(c).astype(onp.float32)
    params = dict(params, eps=1e-5, axis=axis)
    ref_fn = jax_op("BatchNorm").fn
    ref, got = assert_parity(
        lambda *a: ref_fn(*a, **params),
        lambda *a: nn_ops.batch_norm(*a, **params),
        [x, 1.0 + 0.1 * gamma, beta, mean, var], dtype,
        diff_inputs=[0, 1, 2], diff_outputs=[0])
    if params["use_batch_stats"] and not params.get("use_global_stats"):
        red = tuple(i for i in range(x.ndim) if i != axis % x.ndim)
        onp.testing.assert_allclose(got[2], x.var(axis=red),
                                    rtol=1e-5 if dtype == "float32"
                                    else 1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_batch_norm_layer_running_update(dtype):
    """One forward of the Gluon layer under ``autograd.record()`` in both
    packages on a (2, 4, 4, 4) batch: the output, and the running mean
    and variance written in place (``0.9·old + 0.1·batch``, the batch's
    population variance)."""
    x = _normal(13, (2, 4, 4, 4))[0] * 2 + 1
    ref_net = jax_nn.BatchNorm(in_channels=4)
    ref_net.initialize()
    with mx.autograd.record():
        ref_out = ref_net(mx.nd.array(x).astype(dtype))
    net = nn.BatchNorm(in_channels=4)
    net.initialize(device="cpu")
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    with mt.autograd.record():
        out = net(xt)
    tol = 1e-5 if dtype == "float32" else 2e-2
    close(out, ref_out.astype("float32").asnumpy(), tol, "out")
    for name in ("running_mean", "running_var"):
        want = getattr(ref_net, name).data().asnumpy()
        close(getattr(net, name).data(), want, tol, name)
    unbiased = 0.9 + 0.1 * x.var(axis=(0, 2, 3), ddof=1)
    if dtype == "float32":
        assert not onp.allclose(net.running_var.data().numpy(), unbiased,
                                rtol=1e-3)
    # outside record(): eval mode, the running statistics normalise and
    # nothing is written
    before = net.running_mean.data().clone()
    net(xt)
    assert torch.equal(net.running_mean.data(), before)


# -- the small ops ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_flatten_softmax_family(dtype):
    x, = _normal(17, (4, 3, 2, 5))
    assert_parity(jax_op("flatten").fn, tensor_ops.flatten, [x], dtype)
    logits, = _normal(18, (6, 10))
    for axis in (-1, 0):
        assert_parity(lambda a: jax_op("softmax").fn(a, axis=axis),
                      lambda a: nn_ops.softmax(a, axis=axis), [logits],
                      dtype)
    assert_parity(lambda a: jax_op("softmax").fn(a, temperature=2.0),
                  lambda a: nn_ops.softmax(a, temperature=2.0), [logits],
                  dtype)
    label = onp.array([0, 3, 9, 1, 1, 5], onp.float32)
    assert_parity(jax_op("softmax_cross_entropy").fn,
                  nn_ops.softmax_cross_entropy, [logits, label], dtype,
                  diff_inputs=[0])
    assert_parity(jax_op("SoftmaxOutput").fn, nn_ops.softmax_output,
                  [logits, label], dtype, diff_inputs=[0])


def test_softmax_with_length():
    logits, = _normal(19, (3, 6))
    length = onp.array([2, 6, 4], onp.int32)
    assert_parity(
        lambda a, n: jax_op("softmax").fn(a, n, use_length=True),
        lambda a, n: nn_ops.softmax(a, n, use_length=True),
        [logits, length], "float32", diff_inputs=[0])


def test_mx_nd_reaches_the_registered_ops():
    x = mt.nd.array(_normal(21, (2, 3, 6, 6))[0], ctx=mt.cpu())
    w = mt.nd.array(_normal(22, (4, 3, 3, 3))[0], ctx=mt.cpu())
    y = mt.nd.Convolution(x, w, kernel=(3, 3), pad=(1, 1), no_bias=True)
    assert y.shape == (2, 4, 6, 6)
    p = mt.nd.Pooling(y, kernel=(2, 2), stride=(2, 2), pool_type="max")
    assert p.shape == (2, 4, 3, 3)
    g = mt.nd.array(onp.ones(4, onp.float32), ctx=mt.cpu())
    z = mt.nd.array(onp.zeros(4, onp.float32), ctx=mt.cpu())
    out, mean, var = mt.nd.BatchNorm(p, g, z, z, g, use_batch_stats=True,
                                     fix_gamma=False)
    assert out.shape == p.shape and mean.shape == (4,)
    assert mt.nd.Flatten(out).shape == (2, 36)
    s = mt.nd.softmax(mt.nd.Flatten(out))
    onp.testing.assert_allclose(s.asnumpy().sum(-1), 1.0, rtol=1e-6)
    for name in ("Convolution", "Pooling", "BatchNorm", "softmax",
                 "softmax_cross_entropy", "SoftmaxOutput", "flatten"):
        assert name in mt.ops.registry.list_ops()


# -- SGD ops ----------------------------------------------------------------------

SGD_KW = dict(lr=0.05, wd=1e-4, rescale_grad=0.5, clip_gradient=0.4)


def _sgd_arrays(dtype, seed=23):
    w, g, m = _normal(seed, (7, 5), (7, 5), (7, 5))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    return ([jnp.asarray(a, jdt) for a in (w, g, 0.1 * m)],
            [torch.from_numpy(a).to(tdt) for a in (w, g, 0.1 * m)])


def _bits(a):
    return onp.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgd_update(dtype):
    (jw, jg, _), (w, g, _) = _sgd_arrays(dtype)
    want = _lowp_guard(jax_opt.sgd_update)(jw, jg, **SGD_KW)
    got = optimizer_ops.sgd_update(w, g, **SGD_KW)
    assert got.dtype == w.dtype
    onp.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgd_mom_update(dtype):
    (jw, jg, jm), (w, g, m) = _sgd_arrays(dtype)
    want = _lowp_guard(jax_opt.sgd_mom_update)(jw, jg, jm, momentum=0.9,
                                               **SGD_KW)
    got = optimizer_ops.sgd_mom_update(w, g, m, momentum=0.9, **SGD_KW)
    assert [t.dtype for t in got] == [w.dtype, m.dtype]
    for a, b in zip(got, want):
        onp.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sgd_multi_forms(dtype):
    """Three parameters through one call with lr and wd as 0-d tensors
    (as the trainer passes them): each equals the reference op's step."""
    cases = [_sgd_arrays(dtype, seed) for seed in (31, 32, 33)]
    lr, wd = torch.tensor(0.05), torch.tensor(1e-4)
    kw = dict(rescale_grad=0.5, clip_gradient=0.4)
    (got_w,) = optimizer_ops.sgd_update_multi(
        [c[1][0] for c in cases], [c[1][1] for c in cases], lrs=lr, wds=wd,
        **kw)
    mom_w, mom_m = optimizer_ops.sgd_mom_update_multi(
        [c[1][0] for c in cases], [c[1][1] for c in cases],
        [c[1][2] for c in cases], lrs=lr, wds=wd, momentum=0.9, **kw)
    for c, w, mw, mm in zip(cases, got_w, mom_w, mom_m):
        jw, jg, jm = c[0]
        want = _lowp_guard(jax_opt.sgd_update)(jw, jg, **SGD_KW)
        onp.testing.assert_array_equal(_bits(w), _bits(want))
        want_w, want_m = _lowp_guard(jax_opt.sgd_mom_update)(
            jw, jg, jm, momentum=0.9, **SGD_KW)
        assert mw.dtype == c[1][0].dtype and mm.dtype == c[1][2].dtype
        onp.testing.assert_array_equal(_bits(mw), _bits(want_w))
        onp.testing.assert_array_equal(_bits(mm), _bits(want_m))


def test_sgd_optimizer_states_and_ops():
    sgd = mt.optimizer.create("sgd", learning_rate=0.05, momentum=0.9,
                              wd=1e-4, lazy_update=False)
    assert isinstance(sgd, mt.optimizer.SGD)
    assert sgd.op_name == "sgd_mom_update"
    (m,) = sgd.create_state(0, torch.ones(3))
    assert torch.equal(m, torch.zeros(3))
    assert sgd.static_params(0) == {"momentum": 0.9}
    plain = mt.optimizer.create("sgd")
    assert plain.op_name == "sgd_update" and plain.create_state(
        0, torch.ones(3)) == () and plain.lr == 0.01
