"""``mx.np`` — the NumPy-compatible array namespace (counterpart of
``mxnet_tpu/numpy/__init__.py``).

``ndarray`` is the same device tensor as ``mx.nd.NDArray`` with numpy's
method tail; an op with an ``ndarray`` input returns ``ndarray`` s.  Each
function of the namespace is a function of ``ops/np_impl.py`` (numpy's
semantics written in torch ops) lifted through the one op funnel,
``ops.registry.apply_torch`` (the reference's ``_lift`` over
``jax.numpy``): autograd, AMP, the whole-step capture and telemetry see
every call.  A call with no array argument (a window, ``tri``,
``indices``) runs on the current context's device.

Results carry the reference's dtypes: it runs JAX without x64, so
float64 / int64 / complex128 results come back as float32 / int32 /
complex64 (:func:`_canon`) unless ``util.set_np_default_dtype`` or
``util.set_large_tensor`` is on.
"""
from __future__ import annotations

import builtins as _b

import numpy as _onp
import torch

from ..base import MXNetError, np_dtype, torch_dtype  # noqa: F401
from ..context import current_context
from ..ndarray.ndarray import NDArray as _NDArray
from ..ops import np_impl as _impl
from ..ops import registry as _reg
from ..ops.registry import apply_torch as _apply_torch
from ..util import x64_enabled as _x64

pi = _onp.pi
e = _onp.e
inf = _onp.inf
nan = _onp.nan
newaxis = None
euler_gamma = _onp.euler_gamma

float32 = _onp.float32
float64 = _onp.float64
float16 = _onp.float16
int8 = _onp.int8
int32 = _onp.int32
int64 = _onp.int64
uint8 = _onp.uint8
bool_ = _onp.bool_
bfloat16 = torch.bfloat16


class ndarray(_NDArray):
    """``mx.np.ndarray``: an NDArray with numpy's flavor and method
    tail."""

    __slots__ = ()

    def as_nd_ndarray(self):
        return _NDArray._wrap(self._data)

    def as_np_ndarray(self):
        return self

    def std(self, axis=None, ddof=0, keepdims=False):
        return std(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def var(self, axis=None, ddof=0, keepdims=False):
        return var(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def ravel(self):
        return ravel(self)

    def round(self, decimals=0):
        return around(self, decimals=decimals)

    def cumsum(self, axis=None):
        return cumsum(self, axis=axis)

    def nonzero(self):
        return nonzero(self)

    def any(self, axis=None, keepdims=False):
        return _ns_any(self, axis=axis, keepdims=keepdims)

    def all(self, axis=None, keepdims=False):
        return _ns_all(self, axis=axis, keepdims=keepdims)

    def diagonal(self, offset=0, axis1=0, axis2=1):
        return diagonal(self, offset=offset, axis1=axis1, axis2=axis2)

    def trace(self, offset=0, axis1=0, axis2=1):
        return trace(self, offset=offset, axis1=axis1, axis2=axis2)

    def conj(self):
        return conj(self)

    def ptp(self, axis=None, keepdims=False):
        return ptp(self, axis=axis, keepdims=keepdims)

    def searchsorted(self, v, side="left"):
        return searchsorted(self, v, side=side)

    def compress(self, condition, axis=None):
        return compress(condition, self, axis=axis)

    def tobytes(self):
        return self.asnumpy().tobytes()

    @property
    def real(self):
        return real(self)

    @property
    def imag(self):
        return imag(self)

    def __repr__(self):
        return repr(self.asnumpy())


_reg._NP_CLS[0] = ndarray
_builtin_any = any


_canon = _impl.canon
_canon_out = _impl.canon_out


def _wrap(x):
    if isinstance(x, list):
        return [_wrap(o) for o in x]
    if isinstance(x, tuple):
        return tuple(_wrap(o) for o in x)
    if isinstance(x, _NDArray) and type(x) is _NDArray:
        x.__class__ = ndarray
    return x


def _device_of(args):
    for a in args:
        if isinstance(a, _NDArray):
            return a.context
        if isinstance(a, (list, tuple)):
            for x in a:
                if isinstance(x, _NDArray):
                    return x.context
    return None


def _static(v):
    """A hashable stand-in for a static argument (None: unhashable)."""
    try:
        return _reg._hashable(v)
    except TypeError:
        return _Unhashable


class _Unhashable:
    pass


def _kwargs(kwargs):
    out = dict(kwargs)
    if out.get("dtype") is not None and not isinstance(out["dtype"],
                                                       torch.dtype):
        out["dtype"] = torch_dtype(out["dtype"])
    return out


def _lift(tfn, name=None, device_kw=False):
    """``tfn`` (on tensors) as an ``mx.np`` function: ndarrays given
    positionally, or one level deep in a list or tuple, are the funnel's
    inputs (a host numpy array becomes one, on the arrays' device); the
    rest are static.  ``device_kw``: ``tfn`` takes ``device=`` and is
    called with the current context's device when no array is given."""
    fname = name or tfn.__name__

    def f(*args, **kwargs):
        ctx = _device_of(args) or current_context()
        nd_in, spec = [], []

        def as_input(a):
            if isinstance(a, _onp.ndarray):
                return ndarray(a, ctx=ctx)
            return a

        for a in args:
            a = as_input(a)
            if isinstance(a, _NDArray):
                spec.append(("nd", len(nd_in)))
                nd_in.append(a)
            elif isinstance(a, (list, tuple)) and _builtin_any(
                    isinstance(as_input(x), _NDArray) for x in a):
                inner = []
                for x in a:
                    x = as_input(x)
                    if isinstance(x, _NDArray):
                        inner.append(("nd", len(nd_in)))
                        nd_in.append(x)
                    else:
                        inner.append(("py", x))
                spec.append(("seq", type(a), tuple(inner)))
            else:
                spec.append(("py", a))
        kw = _kwargs(kwargs)
        kw_nd = {}
        for k, v in list(kw.items()):
            v = as_input(v)
            if isinstance(v, _NDArray):
                kw_nd[k] = len(nd_in)
                nd_in.append(v)
                del kw[k]

        def fn(*arrays):
            call_kw = dict(kw, **{k: arrays[i] for k, i in kw_nd.items()})
            call = []
            for s in spec:
                if s[0] == "nd":
                    call.append(arrays[s[1]])
                elif s[0] == "seq":
                    call.append(s[1](arrays[i[1]] if i[0] == "nd" else i[1]
                                     for i in s[2]))
                else:
                    call.append(s[1])
            return _canon_out(tfn(*call, **call_kw))

        if not nd_in:
            if not device_kw and args and isinstance(
                    args[0], (list, tuple, int, float, bool, complex,
                              _onp.generic)):
                # a Python value where an array goes: as numpy does
                return f(array(args[0], ctx=ctx), *args[1:], **kwargs)
            if device_kw:
                kw.setdefault("device", ctx.torch_device)
            out = _canon_out(tfn(*args, **kw))
            if isinstance(out, tuple):
                # the reference wraps the tuple as one array: stacked, and
                # float32 as an array made from a Python sequence
                out = torch.stack(out).to(torch.float32)
            return ndarray._wrap(out)
        key = (f"np.{fname}", _static(tuple(spec)), _static(tuple(sorted(
            kw.items()))), tuple(sorted(kw_nd)))
        if _Unhashable in (key[1], key[2]):
            key = None
        return _wrap(_apply_torch(fn, nd_in, key))

    f.__name__ = fname
    f.__qualname__ = fname
    f.__doc__ = (tfn.__doc__ or f"numpy-compatible {fname}") + \
        "\n\n(``mx.np``: lifted through the op funnel.)"
    return f


# -- creation --------------------------------------------------------------

def _dev(ctx=None, device=None):
    c = ctx or device
    return (c if c is not None else current_context()).torch_device


def _dt(dtype, default=None):
    if dtype is None:
        return default if default is not None else _impl.float_default()
    return _canon_dtype(torch_dtype(dtype))


_canon_dtype = _impl.canon_dtype


def array(obj, dtype=None, ctx=None, device=None):
    if dtype is None and _x64() and isinstance(obj, _onp.ndarray) and \
            obj.dtype in (_onp.float64, _onp.int64):
        dtype = obj.dtype
    elif dtype is not None:
        dtype = _canon_dtype(torch_dtype(dtype))
    return ndarray(obj, ctx=ctx or device, dtype=dtype)


def zeros(shape, dtype=None, order="C", ctx=None, device=None):
    return ndarray._wrap(torch.zeros(_shape(shape), dtype=_dt(dtype),
                                     device=_dev(ctx, device)))


def ones(shape, dtype=None, order="C", ctx=None, device=None):
    return ndarray._wrap(torch.ones(_shape(shape), dtype=_dt(dtype),
                                    device=_dev(ctx, device)))


def full(shape, fill_value, dtype=None, order="C", ctx=None, device=None):
    if isinstance(fill_value, _NDArray):
        return broadcast_to(fill_value.astype(dtype) if dtype is not None
                            else fill_value, _shape(shape))
    if dtype is None:
        dtype = _impl.as_t(fill_value).dtype
        dtype = _canon_dtype(dtype)
    return ndarray._wrap(torch.full(_shape(shape), fill_value,
                                    dtype=_dt(dtype),
                                    device=_dev(ctx, device)))


def empty(shape, dtype=None, order="C", ctx=None, device=None):
    return zeros(shape, dtype, ctx=ctx or device)


def eye(N, M=None, k=0, dtype=None, ctx=None, device=None):
    M = N if M is None else M
    t = torch.zeros(N, M, dtype=_dt(dtype), device=_dev(ctx, device))
    i = torch.arange(_b.max(0, _b.min(N, M - k) if k >= 0
                            else _b.min(N + k, M)),
                     device=t.device)
    if i.numel():
        r, c = (i, i + k) if k >= 0 else (i - k, i)
        t[r, c] = 1
    return ndarray._wrap(t)


def identity(n, dtype=None, ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def arange(start, stop=None, step=1, dtype=None, ctx=None, device=None):
    return ndarray._wrap(_canon(_impl.arange(
        start, stop, step, None if dtype is None else torch_dtype(dtype),
        device=_dev(ctx, device))))


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, ctx=None):
    out = _impl.linspace(start, stop, num, endpoint, retstep,
                         None if dtype is None else torch_dtype(dtype),
                         axis, device=_dev(ctx))
    if retstep:
        return ndarray._wrap(_canon(out[0])), float(out[1])
    return ndarray._wrap(_canon(out))


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, ctx=None):
    return ndarray._wrap(_canon(_impl.logspace(
        start, stop, num, endpoint, base,
        None if dtype is None else torch_dtype(dtype), axis,
        device=_dev(ctx))))


def meshgrid(*xi, **kwargs):
    indexing = kwargs.get("indexing", "xy")
    ts = [x._data if isinstance(x, _NDArray) else _impl.as_t(
        x, device=_dev()) for x in xi]
    outs = torch.meshgrid(*ts, indexing=indexing)
    return [ndarray._wrap(_canon(o)) for o in outs]


def _shape(shape):
    return (int(shape),) if isinstance(shape, (int, _onp.integer)) else \
        tuple(int(s) for s in shape)


def zeros_like(a, dtype=None):
    dt = None if dtype is None else _dt(dtype)
    return _lift(lambda x: torch.zeros_like(x, dtype=dt), "zeros_like")(a)


def ones_like(a, dtype=None):
    dt = None if dtype is None else _dt(dtype)
    return _lift(lambda x: torch.ones_like(x, dtype=dt), "ones_like")(a)


def full_like(a, fill_value, dtype=None):
    dt = None if dtype is None else _dt(dtype)
    return _lift(lambda x: torch.full_like(x, fill_value, dtype=dt),
                 "full_like")(a)


def copy(a):
    if isinstance(a, _NDArray):
        return ndarray._wrap(a._data.detach().clone())
    return ndarray(a)


# -- the bulk of the namespace: lifted functions of ``ops/np_impl.py`` --------

_UNARY_FUNCS = [
    "negative", "positive", "absolute", "fabs", "sign", "rint", "ceil",
    "floor", "trunc", "sqrt", "cbrt", "square", "reciprocal", "exp",
    "expm1", "exp2", "log", "log2", "log10", "log1p", "sin", "cos", "tan",
    "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
    "arccosh", "arctanh", "degrees", "radians", "deg2rad", "rad2deg",
    "invert", "logical_not", "isnan", "isinf", "isfinite", "isposinf",
    "isneginf", "sinc", "signbit", "i0", "nan_to_num", "real", "imag",
    "angle", "conj", "conjugate",
]
_BINARY_FUNCS = [
    "add", "subtract", "multiply", "divide", "true_divide", "floor_divide",
    "mod", "remainder", "fmod", "power", "float_power", "maximum", "minimum",
    "fmax", "fmin", "hypot", "arctan2", "logaddexp", "logaddexp2", "copysign",
    "nextafter", "ldexp", "heaviside", "bitwise_and", "bitwise_or",
    "bitwise_xor", "left_shift", "right_shift", "gcd", "lcm", "equal",
    "not_equal", "greater", "greater_equal", "less", "less_equal",
    "logical_and", "logical_or", "logical_xor",
]
# the reference's list; the creation-like ones take the current device
_DEVICE_FUNCS = ("tri", "hamming", "hanning", "blackman", "bartlett",
                 "kaiser", "indices", "triu_indices", "tril_indices",
                 "fromfunction", "geomspace")
_OTHER_FUNCS = [
    "sum", "prod", "mean", "std", "var", "min", "max", "amin", "amax", "ptp",
    "median", "average", "percentile", "quantile", "nansum", "nanprod",
    "nanmean", "nanstd", "nanvar", "nanmin", "nanmax", "nanmedian",
    "nanpercentile", "nanquantile", "cumsum", "cumprod", "nancumsum",
    "nancumprod", "argmax", "argmin", "nanargmax", "nanargmin", "argsort",
    "sort", "partition", "argpartition", "searchsorted", "count_nonzero",
    "nonzero", "flatnonzero", "argwhere", "where", "extract", "clip", "round",
    "around", "dot", "vdot", "inner", "outer", "matmul", "tensordot", "kron",
    "cross", "trace", "diagonal", "diag", "diagflat", "tril", "triu", "tri",
    "vander", "reshape", "ravel", "transpose", "swapaxes", "moveaxis",
    "rollaxis", "expand_dims", "squeeze", "broadcast_to", "broadcast_arrays",
    "atleast_1d", "atleast_2d", "atleast_3d", "concatenate", "stack",
    "vstack", "hstack", "dstack", "column_stack", "row_stack", "split",
    "array_split", "hsplit", "vsplit", "dsplit", "tile", "repeat", "flip",
    "fliplr", "flipud", "roll", "rot90", "append", "insert", "delete",
    "pad", "unique", "union1d", "intersect1d", "setdiff1d", "setxor1d",
    "isin", "take", "take_along_axis", "put_along_axis", "choose",
    "compress", "einsum", "interp", "convolve", "correlate", "histogram",
    "histogram2d", "histogramdd", "bincount", "digitize", "corrcoef", "cov",
    "gradient", "diff", "ediff1d", "trapezoid", "allclose", "isclose",
    "array_equal", "array_equiv", "triu_indices", "tril_indices",
    "triu_indices_from", "tril_indices_from", "indices", "unravel_index",
    "ravel_multi_index", "ix_", "select", "piecewise", "apply_along_axis",
    "apply_over_axes", "polyval", "polyfit", "poly", "roots", "polyadd",
    "polysub", "polymul", "polyder", "polyint", "hamming", "hanning",
    "blackman", "bartlett", "kaiser", "unwrap", "fromfunction", "geomspace",
    "any", "all",
]
# numpy names whose body has another name in ``np_impl``
_IMPL_NAME = {"min": "amin", "max": "amax", "round": "around",
              "row_stack": "vstack"}
_TABLE = dict(_impl.OTHER)
_TABLE.update(_impl.UNARY)
_TABLE.update(_impl.BINARY)

_ns = globals()
for _name in _UNARY_FUNCS + _BINARY_FUNCS + _OTHER_FUNCS:
    if _name in _ns:
        continue
    _ns[_name] = _lift(_TABLE[_IMPL_NAME.get(_name, _name)], _name,
                       device_kw=_name in _DEVICE_FUNCS)

abs = _ns["absolute"]  # noqa: A001
_ns_any = _ns["any"]
_ns_all = _ns["all"]
round_ = _ns["round"]
trapz = _ns["trapezoid"]
fix = _lift(_impl.UNARY["fix"], "fix")


def real_if_close(a, tol=100):
    """The real part when the imaginary part is negligible.  Real input
    passes through the funnel (an identity, gradients flow); complex
    input is a dtype decided on the host from the data, as in numpy and
    the reference (eager only)."""
    if not isinstance(a, _NDArray):
        a = array(a)
    if not a._data.dtype.is_complex:
        return _lift(lambda x: x, "real_if_close")(a)
    t = a._data
    eps = torch.finfo(t.real.dtype).eps
    if bool((t.imag.abs() < tol * eps).all()):
        return ndarray._wrap(t.real.clone())
    return ndarray._wrap(t.clone())


def shape(a):
    return a.shape


def ndim(a):
    return a.ndim


def size(a, axis=None):
    return a.size if axis is None else a.shape[axis]


def may_share_memory(a, b, max_work=None):
    return False


def in1d(ar1, ar2, assume_unique=False, invert=False):
    """Deprecated numpy alias of ``isin`` with a flattened output."""
    out = _ns["isin"](ar1, ar2, assume_unique=assume_unique, invert=invert)
    return out.reshape(-1)


def asarray(a, dtype=None):
    if isinstance(a, _NDArray):
        return _wrap(a if dtype is None else a.astype(dtype))
    return array(a, dtype=dtype)


ascontiguousarray = asarray


def _np_of(x):
    if isinstance(x, _NDArray):
        return _onp.dtype(np_dtype(x._data.dtype))
    if isinstance(x, torch.dtype):
        return _onp.dtype(np_dtype(x))
    return x


def _canon_np(dt):
    dt = _onp.dtype(dt)
    if _x64():
        return dt
    return {_onp.dtype("float64"): _onp.dtype("float32"),
            _onp.dtype("int64"): _onp.dtype("int32"),
            _onp.dtype("uint64"): _onp.dtype("uint32"),
            _onp.dtype("complex128"): _onp.dtype("complex64")}.get(dt, dt)


def result_type(*arrays_and_dtypes):
    """The dtype numpy's promotion gives, narrowed as the results are."""
    ts = [x._data if isinstance(x, _NDArray) else x
          for x in arrays_and_dtypes]
    if _b.all(isinstance(x, torch.Tensor) for x in ts):
        dt = ts[0].dtype
        for x in ts[1:]:
            dt = torch.promote_types(dt, x.dtype)
        return _canon_np(np_dtype(dt))
    return _canon_np(_onp.result_type(*[_np_of(x) for x in
                                        arrays_and_dtypes]))


def promote_types(type1, type2):
    return _canon_np(_onp.promote_types(_np_of(type1), _np_of(type2)))


def can_cast(from_, to, casting="safe"):
    return bool(_onp.can_cast(_np_of(from_), _np_of(to), casting))


from . import random  # noqa: E402
from . import linalg  # noqa: E402
from . import fft  # noqa: E402

from .._numpy_dispatch import set_module_funcs as _smf  # noqa: E402
_smf(_ns)
