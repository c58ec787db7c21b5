"""The legacy op names (``mxnet_tpu_torch/ops/legacy.py``) against the
reference's, on the CPU: every name the port's legacy module registers,
through each package's registry on the same numpy inputs (made from a
seed), float results within 1e-5 of the reference's (relative to its
largest element), integer results and dtypes equal, the shapes equal.
The regression outputs' injected gradients and ``BlockGrad``'s blocked
one are compared through each package's autograd."""
import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as ref_reg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as port_reg

RNG = onp.random.RandomState(0)


def _f(*shape, lo=-2.0, hi=2.0):
    return RNG.uniform(lo, hi, shape).astype(onp.float32)


A, B = _f(3, 4), _f(3, 4)
POS = _f(3, 4, lo=0.1, hi=2.0)
IMG = _f(2, 3, 6, 6)
BITS = (RNG.uniform(size=(3, 4)) > 0.5).astype(onp.float32)
ROWS = onp.array([0.0, 2.0], onp.float32)
COORDS = onp.array([[0, 1, 2], [3, 0, 1]], onp.float32)
FLAT = onp.array([1, 5, 11], onp.float32)

# name -> (inputs, params)
CASES = {
    "_maximum_scalar": ([A], dict(scalar=0.25)),
    "_minimum_scalar": ([A], dict(scalar=0.25)),
    "_hypot_scalar": ([A], dict(scalar=1.5)),
    "_logical_and_scalar": ([BITS], dict(scalar=1.0)),
    "_logical_or_scalar": ([BITS], dict(scalar=0.0)),
    "_logical_xor_scalar": ([BITS], dict(scalar=1.0)),
    "_scatter_plus_scalar": ([A], dict(scalar=0.5)),
    "_scatter_minus_scalar": ([A], dict(scalar=0.5)),
    "_scatter_elemwise_div": ([A, POS], {}),
    "_maximum": ([A, B], {}),
    "_minimum": ([A, B], {}),
    "_hypot": ([A, B], {}),
    "_logical_and": ([BITS, 1 - BITS], {}),
    "_logical_or": ([BITS, 1 - BITS], {}),
    "_logical_xor": ([BITS, BITS], {}),
    "_split_v2": ([A], dict(num_outputs=2, axis=1)),
    "_copy": ([A], {}),
    "_grad_add": ([A, B], {}),
    "_identity_with_attr_like_rhs": ([A, B], {}),
    "reshape_like": ([A, _f(4, 3)], {}),
    "_zeros": ([], dict(shape=(2, 3))),
    "_zeros_without_dtype": ([], dict(shape=(4,))),
    "_ones": ([], dict(shape=(2, 3), dtype="int32")),
    "_full": ([], dict(shape=(2, 2), value=3.5)),
    "_eye": ([], dict(N=3, M=4, k=1)),
    "_arange": ([], dict(start=1, stop=7, step=2.0, repeat=2)),
    "_linspace": ([], dict(start=0.0, stop=1.0, num=5, endpoint=False)),
    "add_n": ([A, B, POS], {}),
    "ElementWiseSum": ([A, B], {}),
    "_sum_of_arrays": ([A, B], {}),
    "moments": ([IMG], dict(axes=(0, 2, 3))),
    "hard_sigmoid": ([A], dict(alpha=0.3, beta=0.4)),
    "argmax_channel": ([A], {}),
    "batch_take": ([A, onp.array([1, 0, 3], onp.float32)], {}),
    "_unravel_index": ([FLAT], dict(shape=(3, 4))),
    "unravel_index": ([FLAT], dict(shape=(2, 6))),
    "_ravel_multi_index": ([COORDS], dict(shape=(2, 4))),
    "ravel_multi_index": ([COORDS], dict(shape=(4, 4))),
    "_square_sum": ([A], dict(axis=1, keepdims=True)),
    "_sparse_retain": ([A, ROWS], {}),
    "_slice_assign": ([A, _f(2, 2)], dict(begin=(0, 1), end=(2, 3))),
    "_slice_assign_scalar": ([A], dict(scalar=7.0, begin=(1, 0),
                                       end=(3, 4), step=(1, 2))),
    "_scatter_set_nd": ([A, ROWS], {}),
    "im2col": ([IMG], dict(kernel=(3, 3), stride=(2, 1), dilate=(1, 2),
                           pad=(1, 1))),
    "col2im": ([_f(2, 27, 12)], dict(input_size=(6, 6), kernel=(3, 3),
                                     stride=(2, 1), dilate=(1, 2),
                                     pad=(1, 1))),
    "amp_cast": ([A], dict(dtype="float16")),
    "amp_multicast": ([A, B], dict(num_outputs=2)),
    "all_finite": ([A], {}),
    "multi_all_finite": ([A, B], dict(num_arrays=2)),
    "multi_sum_sq": ([A, B], dict(num_arrays=2)),
    "reset_arrays": ([A, B], dict(num_arrays=2)),
    "multi_lars": ([POS[0], POS[1], POS[2], _f(4, lo=0.0, hi=0.1)],
                   dict(eta=0.01, eps=1e-6, rescale_grad=0.5)),
    "SoftmaxActivation": ([IMG], dict(mode="instance")),
    "IdentityAttachKLSparseReg": ([A], {}),
    "_rnn_param_concat": ([A, B], dict(num_args=2)),
    "_histogram": ([A], dict(bin_cnt=5, range=(-2.0, 2.0))),
    "LinearRegressionOutput": ([A, B], {}),
    "linear_regression_output": ([A, B], dict(grad_scale=2.0)),
    "MAERegressionOutput": ([A, B], {}),
    "mae_regression_output": ([A, B], {}),
    "LogisticRegressionOutput": ([A, BITS], {}),
    "logistic_regression_output": ([A, BITS], {}),
    "Crop": ([IMG], dict(h_w=(3, 4), offset=(1, 2))),
    "UpSampling": ([IMG], dict(scale=2, sample_type="nearest")),
    "LRN": ([IMG], dict(nsize=3, alpha=1e-2, beta=0.75, knorm=2.0)),
    "MakeLoss": ([A], {}),
    "make_loss": ([A], dict(grad_scale=2.0)),
    "BlockGrad": ([A], {}),
    "stop_gradient": ([A], {}),
}

# further cases of names above (other parameters)
EXTRA = {
    "SoftmaxActivation/channel": ([IMG], dict(mode="channel")),
    "Crop/like": ([IMG, _f(2, 3, 4, 2)], dict(center_crop=True,
                                              num_args=2)),
    "UpSampling/bilinear": ([IMG], dict(scale=2, sample_type="bilinear")),
    "_histogram/edges": ([A, onp.array([-2.0, -0.5, 0.0, 0.7, 2.0],
                                       onp.float32)], {}),
    "_arange/stop": ([], dict(start=5)),
    "_linspace/endpoint": ([], dict(start=-1.0, stop=1.0, num=4)),
    "amp_multicast/narrow": ([A, A.astype(onp.float16)],
                             dict(num_outputs=2, cast_narrow=True)),
    "reshape_like/ranges": ([_f(2, 12), _f(3, 4)],
                            dict(lhs_begin=1, lhs_end=2, rhs_begin=0,
                                 rhs_end=2)),
}


def _legacy_names():
    return sorted(n for n, op in port_reg._REGISTRY.items()
                  if op.fn.__module__ == "mxnet_tpu_torch.ops.legacy"
                  or n in ("_logical_and", "_logical_or", "_logical_xor",
                           "_split_v2"))


def test_every_legacy_name_has_a_case():
    assert set(_legacy_names()) == set(CASES)
    assert set(CASES) <= set(ref_reg._REGISTRY)


def _port(name, inputs, params):
    with mt.cpu():
        nds = [mt.nd.array(a, dtype=str(a.dtype)) for a in inputs]
        out = port_reg.invoke(name, nds, **params)
    return out if isinstance(out, list) else [out]


def _reference(name, inputs, params):
    out = ref_reg.invoke(name, [mx.nd.array(a, dtype=str(a.dtype))
                                for a in inputs], **params)
    return out if isinstance(out, (list, tuple)) else [out]


def _check(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = g.asnumpy(), onp.asarray(r.asnumpy())
        assert g.shape == r.shape
        if onp.issubdtype(r.dtype, onp.floating):
            assert g.dtype == r.dtype, (g.dtype, r.dtype)
            onp.testing.assert_allclose(
                g, r, rtol=1e-5,
                atol=1e-5 * max(1.0, float(abs(r).max(initial=0.0))))
        else:
            assert onp.issubdtype(g.dtype, onp.integer) == \
                onp.issubdtype(r.dtype, onp.integer)
            onp.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("case", sorted(CASES) + sorted(EXTRA))
def test_legacy_op_matches_the_reference(case):
    inputs, params = CASES[case] if case in CASES else EXTRA[case]
    name = case.split("/")[0]
    _check(_port(name, inputs, params), _reference(name, inputs, params))


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput", "BlockGrad",
                                  "MakeLoss"])
def test_legacy_op_gradients(name):
    """The gradient each package's autograd gives ``data`` for a
    cotangent of 3s: the regression outputs inject their own, whatever
    the cotangent; BlockGrad passes none; MakeLoss passes it on."""
    inputs = [A, B] if "Regression" in name else [A]
    params = {"grad_scale": 0.5} if "Regression" in name else {}
    ct = onp.full((3, 4), 3.0, onp.float32)
    with mt.cpu():
        xs = [mt.nd.array(a) for a in inputs]
        xs[0].attach_grad()
        with mt.autograd.record():
            y = port_reg.invoke(name, xs, **params)
            loss = (y * mt.nd.array(ct)).sum() + (xs[0] * 0.0).sum()
        loss.backward()
        got = xs[0].grad.asnumpy()
    rs = [mx.nd.array(a) for a in inputs]
    rs[0].attach_grad()
    with mx.autograd.record():
        y = ref_reg.invoke(name, rs, **params)
        loss = (y * mx.nd.array(ct)).sum() + (rs[0] * 0.0).sum()
    loss.backward()
    ref = rs[0].grad.asnumpy()
    onp.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
