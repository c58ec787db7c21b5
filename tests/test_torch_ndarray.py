"""The port's imperative NDArray path (mxnet_tpu_torch.nd, the op
registry, Context) against the reference package's ``mx.nd``.

The same numpy inputs go through both packages; values are compared at
float32 tolerance 1e-6 (elementwise ops and small reductions), dtypes by
name.  Every port array is made on the CPU (``ctx=mx.cpu()`` or
``with mx.cpu():``): the port's default context is the GPU.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError, dtype_name

CPU = mx.cpu()
TOL = dict(rtol=1e-6, atol=1e-6)


def both(a, dtype=None):
    """The same numpy array as a port NDArray (CPU) and a reference one."""
    return mx.nd.array(a, ctx=CPU, dtype=dtype), jmx.nd.array(a, dtype=dtype)


def close(got, ref, **tol):
    assert dtype_name(got.dtype) == dtype_name(ref.dtype), (got.dtype,
                                                            ref.dtype)
    assert got.shape == ref.shape
    onp.testing.assert_allclose(got.asnumpy(), ref.asnumpy(), **(tol or TOL))


@pytest.mark.parametrize("source,dtype", [
    ([[1, 2], [3, 4]], None),                          # list → float32
    (onp.arange(6.0).reshape(2, 3), None),             # float64 → float32
    (onp.arange(6, dtype=onp.int32), None),            # numpy keeps int32
    (onp.arange(6, dtype=onp.int64), None),
    ([0.5, 1.5, -2.25], "float16"),
    ([1.7, -2.2, 3.9], "int32"),
    (3.5, None),                                       # a scalar
])
def test_array_dtypes_and_values(source, dtype):
    got, ref = both(source, dtype)
    close(got, ref)


def test_bfloat16_array_compares_in_float32_and_asnumpy_raises():
    a = onp.random.RandomState(0).randn(4, 5)
    got, ref = both(a, "bfloat16")
    assert got.dtype == torch.bfloat16 and dtype_name(ref.dtype) == "bfloat16"
    onp.testing.assert_array_equal(got.astype("float32").asnumpy(),
                                   ref.astype("float32").asnumpy())
    with pytest.raises(MXNetError, match="bfloat16"):
        got.asnumpy()


@pytest.mark.parametrize("name,args,kw", [
    ("zeros", ((2, 3),), {}), ("ones", (4,), {"dtype": "int32"}),
    ("full", ((2, 2), 7.5), {}), ("empty", ((3,),), {}),
    ("arange", (5,), {}), ("arange", (2, 11, 3), {"dtype": "int32"}),
    ("arange", (0, 3), {"repeat": 2}),
])
def test_constructors(name, args, kw):
    close(getattr(mx.nd, name)(*args, ctx=CPU, **kw),
          getattr(jmx.nd, name)(*args, **kw))


def test_context_scope_default_and_properties(monkeypatch):
    assert mx.current_context() == mx.gpu(0)
    assert repr(mx.gpu(1)) == "gpu(1)" and mx.Context("cuda", 0) == mx.gpu()
    with mx.cpu():
        assert mx.current_context() == mx.cpu()
        x = mx.nd.zeros((2,))
        assert x.context == mx.cpu() and x.ctx == mx.cpu(0)
    assert mx.num_gpus() == torch.cuda.device_count()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: mx.nd.array([1.0]), lambda: mx.nd.zeros((1,)),
                 lambda: mx.nd.arange(3)):
        with pytest.raises(MXNetError, match="mx.cpu"):
            make()
    with pytest.raises(MXNetError):
        mx.Context("tpu")


def test_transfer_and_host_reads():
    a = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    x = mx.nd.array(a, ctx=CPU)
    a[0, 0] = 100.0                       # the array copied its source
    host = x.asnumpy()
    host[0, 1] = -1.0                     # asnumpy copies too
    assert x.asnumpy()[0, 0] == 0.0 and x.asnumpy()[0, 1] == 1.0
    assert x.as_in_context(mx.cpu()) is x
    y = x.copyto(mx.cpu())
    assert y is not x and (y == x).asnumpy().all()
    z = mx.nd.zeros((2, 3), ctx=CPU, dtype="int32")
    assert x.copyto(z) is z and z.asnumpy().dtype == onp.int32
    assert x[1, 2].asscalar() == 5.0 and float(x.sum()) == 15.0
    assert x.size == 6 and x.ndim == 2 and len(x) == 2
    x.wait_to_read()
    mx.nd.waitall()
    with pytest.raises(MXNetError):
        x.asscalar()


OPS = ["__add__", "__sub__", "__mul__", "__truediv__", "__pow__", "__mod__",
       "__radd__", "__rsub__", "__rmul__", "__rtruediv__", "__rpow__",
       "__eq__", "__ne__", "__gt__", "__ge__", "__lt__", "__le__"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_operators_against_arrays_and_scalars(op, dtype):
    rng = onp.random.RandomState(1)
    a = rng.uniform(0.5, 3.0, (3, 4))
    b = rng.uniform(0.5, 3.0, (1, 4))     # broadcast along axis 0
    if dtype == "int32":
        a, b = onp.floor(a * 3) + 1, onp.floor(b * 3) + 1
    (xa, ja), (xb, jb) = both(a, dtype), both(b, dtype)
    tol = dict(rtol=2e-6, atol=2e-6)
    if not op.startswith("__r"):
        close(getattr(xa, op)(xb), getattr(ja, op)(jb), **tol)
    for scalar in (2, 1.5):
        close(getattr(xa, op)(scalar), getattr(ja, op)(scalar), **tol)


def test_unary_ops_methods_and_inplace_rebinds_the_handle():
    a = onp.random.RandomState(2).uniform(0.2, 2.0, (3, 5))
    x, j = both(a)
    for name in ("abs", "exp", "log", "sqrt", "square", "sigmoid", "tanh",
                 "relu"):
        close(getattr(x, name)(), getattr(j, name)(), rtol=2e-6, atol=2e-6)
    close(-x, -j)
    close(abs(-x), abs(-j))
    before = x
    for op in ("__iadd__", "__isub__", "__imul__", "__itruediv__"):
        x = getattr(x, op)(0.5)
        j = getattr(j, op)(0.5)
        assert x is before
        close(x, j)


@pytest.mark.parametrize("method,kw", [
    ("sum", {}), ("sum", {"axis": 1}), ("sum", {"axis": (0, 2),
                                                "keepdims": True}),
    ("mean", {"axis": -1}), ("max", {"axis": 0}), ("min", {}),
    ("max", {"axis": 1, "keepdims": True}),
])
def test_reductions(method, kw):
    a = onp.random.RandomState(3).randn(2, 3, 4)
    x, j = both(a)
    close(getattr(x, method)(**kw), getattr(j, method)(**kw), rtol=1e-5,
          atol=1e-6)


def test_integer_reductions_keep_their_dtype():
    x, j = both(onp.arange(12, dtype=onp.int32).reshape(3, 4))
    close(x.sum(axis=0), j.sum(axis=0))
    close(x.mean(), j.mean())
    close(mx.nd.sum(x, axis=1, exclude=True), jmx.nd.sum(j, axis=1,
                                                         exclude=True))


@pytest.mark.parametrize("shape,kw", [
    ((4, -1), {}), ((0, -1), {}), ((-2,), {}), ((-3, 5), {}),
    ((-4, 1, 2, 0, 5), {}), ((-1, 5), {"reverse": True}), ((12, 5), {}),
])
def test_reshape_special_codes(shape, kw):
    x, j = both(onp.arange(60.0).reshape(2, 6, 5))
    close(x.reshape(shape, **kw), j.reshape(shape, **kw))


def test_astype_and_indexing():
    a = onp.arange(24.0).reshape(2, 3, 4)
    x, j = both(a)
    close(x.astype("int32"), j.astype("int32"))
    close(x.astype("float16"), j.astype("float16"))
    assert x.astype("float32", copy=False) is x
    for key in (1, (0, 2), slice(0, 1), (slice(None), 1, slice(1, 3)),
                (Ellipsis, -1)):
        close(x[key], j[key])
    idx_x, idx_j = both(onp.array([2, 0, 2], onp.int32))
    close(x[1][idx_x], j[1][idx_j])
    x[0, 1] = 7.0
    j[0, 1] = 7.0
    x[1] = mx.nd.ones((3, 4), ctx=CPU)
    j[1] = jmx.nd.ones((3, 4))
    close(x, j)


def test_nd_op_functions_positional_scalars_out_and_lists():
    a = onp.random.RandomState(4).randn(3, 4)
    x, j = both(a)
    close(mx.nd.sum(x, 1), jmx.nd.sum(j, 1))                # → axis
    close(mx.nd.sum(x, 1, True), jmx.nd.sum(j, 1, True))    # → keepdims
    close(mx.nd._plus_scalar(x, 2.5), jmx.nd._plus_scalar(j, 2.5))
    close(mx.nd.broadcast_maximum(x, x * 0.5),
          jmx.nd.broadcast_maximum(j, j * 0.5))
    close(mx.nd.reshape(x, [2, -1]), jmx.nd.reshape(j, [2, -1]))
    close(mx.nd.cast(x, "float16"), jmx.nd.cast(j, "float16"))
    close(mx.nd.zeros_like(x), jmx.nd.zeros_like(j))
    out_x, out_j = mx.nd.zeros((3, 4), ctx=CPU), jmx.nd.zeros((3, 4))
    assert mx.nd.elemwise_mul(x, x, out=out_x) is out_x
    jmx.nd.elemwise_mul(j, j, out=out_j)
    close(out_x, out_j)
    assert mx.nd.elemwise_add.__name__ == "elemwise_add"


def test_registry_and_dispatch_funnel():
    from mxnet_tpu.ops import registry as jreg
    from mxnet_tpu_torch.ops import registry
    names = registry.list_ops()
    assert {"layer_norm_residual", "_npx_layer_norm_residual", "broadcast_add",
            "_rminus_scalar", "reshape", "cast"} <= set(names)
    assert set(names) <= set(jreg.list_ops())    # every name is the reference's
    assert len(names) >= 604         # of the reference's 695, with mx.np's ops
    assert registry.get("_npx_layer_norm_residual") is \
        registry.get("layer_norm_residual")
    with pytest.raises(MXNetError, match="no_such_op"):
        registry.invoke("no_such_op", [])
    with pytest.raises(MXNetError, match="already registered"):
        registry.register("elemwise_add")(lambda a, b: a)
    count = telemetry.counter("dispatch.count")
    x = mx.nd.ones((2,), ctx=CPU)
    before = count.value
    (x + x).sum()
    assert count.value == before + 2
