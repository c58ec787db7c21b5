"""numpy's functions on ``torch.Tensor`` s: the bodies behind ``mx.np``
and the ``_npi_*`` ops (the reference lifts ``jax.numpy``; torch has no
numpy namespace, so each function is written here from torch ops on the
tensor's own device).

Every function takes tensors (and Python values for static arguments)
and returns a tensor, or a tuple of them.  Gradients flow through
whatever torch op computes the result.  Results keep torch's dtypes;
``mx.np`` narrows them to the reference's (``numpy._canon``).

Where torch's counterpart differs from numpy this module follows numpy:
sorts are stable, ``median`` / ``quantile`` interpolate (any size, on
any device), the windows are symmetric, ``vander`` counts powers down,
``histogram`` bins with ``bucketize`` (``torch.histogram`` runs on the
host only).  The functions whose output shape depends on the data
(``unique``, ``nonzero``, ``argwhere``, ``extract``, ``compress``,
``bincount`` without a length, the set functions) read a size back to
the host, as their reference counterparts do; they still compute on
the tensor's device.
"""
from __future__ import annotations

import builtins
import math

import torch
import torch.nn.functional as F

from ..util import x64_enabled

# -- helpers -----------------------------------------------------------------


def float_default() -> torch.dtype:
    return torch.float64 if x64_enabled() else torch.float32


def int_default() -> torch.dtype:
    return torch.int64 if x64_enabled() else torch.int32


def as_t(x, like=None, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor on ``like``'s device (or ``device``)."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    dev = like.device if isinstance(like, torch.Tensor) else device
    if dtype is None:
        if isinstance(x, bool):
            dtype = torch.bool
        elif isinstance(x, int):
            dtype = int_default()
        elif isinstance(x, float):
            dtype = float_default()
    return torch.as_tensor(x, dtype=dtype, device=dev)


def pair(a, b):
    """``a`` and ``b`` as tensors of their common dtype; a Python scalar
    takes the tensor's dtype where its kind allows (numpy's and JAX's
    weak scalars)."""
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = as_t(a)
    dt = torch.result_type(a, b)
    like = a if isinstance(a, torch.Tensor) else b
    return as_t(a, like, dt), as_t(b, like, dt)


def inexact(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a floating type (ints and bools to the default float)."""
    if t.dtype.is_floating_point or t.dtype.is_complex:
        return t
    return t.to(float_default())


def ax(t: torch.Tensor, axis):
    """numpy's ``axis`` as a tuple of non-negative dims (None: all)."""
    if axis is None:
        return tuple(range(t.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(a % max(t.dim(), 1) for a in axis)
    return (axis % max(t.dim(), 1),)


def _keep(out, t, axes, keepdims):
    if keepdims:
        for a in sorted(axes):
            out = out.unsqueeze(a)
    return out


def _flat_or(t, axis):
    """``(t, axis)``, with ``t`` flattened when ``axis`` is None."""
    if axis is None:
        return t.reshape(-1), 0
    return t, axis


_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.complex128: torch.complex64}


def canon(t):
    """``t`` in the dtype the reference gives: it runs JAX without x64,
    so, unless a 64-bit switch is on (``util``), 64-bit results narrow
    to 32 bits."""
    if isinstance(t, torch.Tensor) and not x64_enabled():
        dt = _NARROW.get(t.dtype)
        if dt is not None:
            return t.to(dt)
    return t


def canon_dtype(dt: torch.dtype) -> torch.dtype:
    return dt if x64_enabled() else _NARROW.get(dt, dt)


def canon_out(out):
    """:func:`canon` over a result, a tuple's nested tuples flattened."""
    if isinstance(out, (tuple, list)):
        flat = []
        for o in out:
            if isinstance(o, (tuple, list)):
                flat.extend(canon(x) for x in o)
            else:
                flat.append(canon(o))
        return tuple(flat)
    return canon(out)


# -- elementwise --------------------------------------------------------------

def _float_unary(fn):
    def f(x):
        return fn(inexact(x))
    return f


def _int_identity(fn):
    def f(x):
        if not (x.dtype.is_floating_point or x.dtype.is_complex):
            return x.clone()
        return fn(x)
    return f


def cbrt(x):
    x = inexact(x)
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def reciprocal(x):
    return torch.reciprocal(x) if x.dtype.is_floating_point else \
        torch.div(1, x, rounding_mode="trunc").to(x.dtype)


def invert(x):
    return torch.logical_not(x) if x.dtype == torch.bool else \
        torch.bitwise_not(x)


def imag(x):
    return torch.imag(x) if x.dtype.is_complex else torch.zeros_like(x)


def real(x):
    return torch.real(x) if x.dtype.is_complex else x


def angle(x, deg=False):
    out = torch.angle(x) if x.dtype.is_complex else torch.angle(inexact(x))
    return torch.rad2deg(out) if deg else out


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    if not x.dtype.is_floating_point:
        return x.clone()
    return torch.nan_to_num(x, nan=nan, posinf=posinf, neginf=neginf)


def isposinf(x):
    return torch.isposinf(x) if x.dtype.is_floating_point else \
        torch.zeros_like(x, dtype=torch.bool)


def isneginf(x):
    return torch.isneginf(x) if x.dtype.is_floating_point else \
        torch.zeros_like(x, dtype=torch.bool)


def around(x, decimals=0):
    if not x.dtype.is_floating_point:
        return x.clone()
    return torch.round(x, decimals=decimals)


def sinc(x):
    return torch.sinc(inexact(x))


def i0(x):
    return torch.special.i0(inexact(x))


UNARY = {
    "negative": torch.negative, "positive": lambda x: x.clone(),
    "absolute": torch.abs, "fabs": _float_unary(torch.abs),
    "sign": torch.sign, "rint": _int_identity(torch.round),
    "ceil": _int_identity(torch.ceil), "floor": _int_identity(torch.floor),
    "trunc": _int_identity(torch.trunc), "sqrt": _float_unary(torch.sqrt),
    "cbrt": cbrt, "square": torch.square, "reciprocal": reciprocal,
    "exp": _float_unary(torch.exp), "expm1": _float_unary(torch.expm1),
    "exp2": _float_unary(torch.exp2), "log": _float_unary(torch.log),
    "log2": _float_unary(torch.log2), "log10": _float_unary(torch.log10),
    "log1p": _float_unary(torch.log1p), "sin": _float_unary(torch.sin),
    "cos": _float_unary(torch.cos), "tan": _float_unary(torch.tan),
    "arcsin": _float_unary(torch.asin), "arccos": _float_unary(torch.acos),
    "arctan": _float_unary(torch.atan), "sinh": _float_unary(torch.sinh),
    "cosh": _float_unary(torch.cosh), "tanh": _float_unary(torch.tanh),
    "arcsinh": _float_unary(torch.asinh),
    "arccosh": _float_unary(torch.acosh),
    "arctanh": _float_unary(torch.atanh),
    "degrees": _float_unary(torch.rad2deg),
    "radians": _float_unary(torch.deg2rad),
    "deg2rad": _float_unary(torch.deg2rad),
    "rad2deg": _float_unary(torch.rad2deg), "invert": invert,
    "logical_not": torch.logical_not, "isnan": torch.isnan,
    "isinf": torch.isinf, "isfinite": torch.isfinite,
    "isposinf": isposinf, "isneginf": isneginf, "sinc": sinc,
    "signbit": lambda x: torch.signbit(x), "i0": i0,
    "nan_to_num": nan_to_num, "real": real, "imag": imag, "angle": angle,
    "conj": lambda x: torch.conj(x).resolve_conj() if x.dtype.is_complex
    else x.clone(),
}
UNARY["conjugate"] = UNARY["conj"]
UNARY["fix"] = UNARY["trunc"]


def _binary(fn, floats=False):
    def f(a, b):
        a, b = pair(a, b)
        if floats:
            a, b = inexact(a), inexact(b)
        return fn(a, b)
    return f


def true_divide(a, b):
    a, b = pair(a, b)
    return torch.true_divide(inexact(a), inexact(b))


def floor_divide(a, b):
    a, b = pair(a, b)
    if a.dtype.is_floating_point:
        return torch.floor(a / b)
    return torch.div(a, b, rounding_mode="floor")


def power(a, b):
    a, b = pair(a, b)
    return torch.pow(a, b)


def float_power(a, b):
    a, b = pair(a, b)
    dt = torch.complex128 if a.dtype.is_complex else torch.float64
    return torch.pow(a.to(dt), b.to(dt))


def ldexp(a, b):
    a = inexact(as_t(a, b if isinstance(b, torch.Tensor) else None))
    return a * torch.exp2(as_t(b, a).to(a.dtype))


def heaviside(a, b):
    a, b = pair(a, b)
    return torch.heaviside(a, b)


def nextafter(a, b):
    a, b = pair(a, b)
    a, b = inexact(a), inexact(b)
    return torch.nextafter(a, b)


def _bool_out(fn):
    def f(a, b):
        a, b = pair(a, b)
        return fn(a, b)
    return f


BINARY = {
    "add": _binary(torch.add), "subtract": _binary(torch.subtract),
    "multiply": _binary(torch.multiply), "divide": true_divide,
    "true_divide": true_divide, "floor_divide": floor_divide,
    "mod": _binary(torch.remainder), "remainder": _binary(torch.remainder),
    "fmod": _binary(torch.fmod), "power": power,
    "float_power": float_power, "maximum": _binary(torch.maximum),
    "minimum": _binary(torch.minimum), "fmax": _binary(torch.fmax),
    "fmin": _binary(torch.fmin), "hypot": _binary(torch.hypot, True),
    "arctan2": _binary(torch.atan2, True),
    "logaddexp": _binary(torch.logaddexp, True),
    "logaddexp2": _binary(torch.logaddexp2, True),
    "copysign": _binary(torch.copysign, True), "nextafter": nextafter,
    "ldexp": ldexp, "heaviside": heaviside,
    "bitwise_and": _binary(torch.bitwise_and),
    "bitwise_or": _binary(torch.bitwise_or),
    "bitwise_xor": _binary(torch.bitwise_xor),
    "left_shift": _binary(torch.bitwise_left_shift),
    "right_shift": _binary(torch.bitwise_right_shift),
    "gcd": _binary(torch.gcd), "lcm": _binary(torch.lcm),
    "equal": _bool_out(torch.eq), "not_equal": _bool_out(torch.ne),
    "greater": _bool_out(torch.gt), "greater_equal": _bool_out(torch.ge),
    "less": _bool_out(torch.lt), "less_equal": _bool_out(torch.le),
    "logical_and": _bool_out(torch.logical_and),
    "logical_or": _bool_out(torch.logical_or),
    "logical_xor": _bool_out(torch.logical_xor),
}


# -- reductions ---------------------------------------------------------------

def _acc_dtype(t, dtype):
    if dtype is not None:
        return dtype
    if t.dtype == torch.bool or (not t.dtype.is_floating_point
                                 and not t.dtype.is_complex
                                 and t.element_size() < 8):
        return torch.int64
    return None


def sum(a, axis=None, dtype=None, keepdims=False, initial=None):
    dims = ax(a, axis)
    dt = _acc_dtype(a, dtype)
    out = a.sum(dim=dims, keepdim=keepdims, dtype=dt) if dims else \
        a.to(dt) if dt is not None else a.clone()
    if initial is not None:
        out = out + initial
    return out


def prod(a, axis=None, dtype=None, keepdims=False, initial=None):
    dt = _acc_dtype(a, dtype)
    x = a if dt is None else a.to(dt)
    if axis is None:
        out = x.reshape(-1).prod()
        if keepdims:
            out = out.reshape((1,) * a.dim())
    else:
        out = x
        for d in sorted(ax(a, axis), reverse=True):
            out = out.prod(dim=d, keepdim=keepdims)
    if initial is not None:
        out = out * initial
    return out


def mean(a, axis=None, dtype=None, keepdims=False):
    x = a.to(dtype) if dtype is not None else inexact(a)
    dims = ax(a, axis)
    return x.mean(dim=dims, keepdim=keepdims) if dims else x.clone()


def var(a, axis=None, dtype=None, ddof=0, keepdims=False):
    x = a.to(dtype) if dtype is not None else inexact(a)
    dims = ax(a, axis)
    if not dims:
        return torch.zeros_like(x)
    m = x.mean(dim=dims, keepdim=True)
    d = x - m
    sq = (d * d.conj()).real if x.dtype.is_complex else d * d
    n = 1
    for i in dims:
        n *= x.shape[i]
    return sq.sum(dim=dims, keepdim=keepdims) / max(n - ddof, 0)


def std(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return torch.sqrt(var(a, axis, dtype, ddof, keepdims))


def amax(a, axis=None, keepdims=False, initial=None):
    dims = ax(a, axis)
    out = a.amax(dim=dims, keepdim=keepdims) if dims else a.clone()
    return out if initial is None else torch.clamp(out, min=initial)


def amin(a, axis=None, keepdims=False, initial=None):
    dims = ax(a, axis)
    out = a.amin(dim=dims, keepdim=keepdims) if dims else a.clone()
    return out if initial is None else torch.clamp(out, max=initial)


def ptp(a, axis=None, keepdims=False):
    return amax(a, axis, keepdims) - amin(a, axis, keepdims)


def any(a, axis=None, keepdims=False):
    dims = ax(a, axis)
    b = a.bool()
    for d in sorted(dims, reverse=True):
        b = b.any(dim=d, keepdim=keepdims)
    return b


def all(a, axis=None, keepdims=False):
    dims = ax(a, axis)
    b = a.bool()
    for d in sorted(dims, reverse=True):
        b = b.all(dim=d, keepdim=keepdims)
    return b


def count_nonzero(a, axis=None, keepdims=False):
    return sum(a != 0, axis=axis, keepdims=keepdims)


def argmax(a, axis=None, keepdims=False):
    if axis is None:
        out = a.reshape(-1).argmax()
        return out.reshape((1,) * a.dim()) if keepdims else out
    return a.argmax(dim=axis, keepdim=keepdims)


def argmin(a, axis=None, keepdims=False):
    if axis is None:
        out = a.reshape(-1).argmin()
        return out.reshape((1,) * a.dim()) if keepdims else out
    return a.argmin(dim=axis, keepdim=keepdims)


def nanargmax(a, axis=None, keepdims=False):
    x = torch.where(torch.isnan(a), torch.full_like(a, -math.inf), a) \
        if a.dtype.is_floating_point else a
    return argmax(x, axis, keepdims)


def nanargmin(a, axis=None, keepdims=False):
    x = torch.where(torch.isnan(a), torch.full_like(a, math.inf), a) \
        if a.dtype.is_floating_point else a
    return argmin(x, axis, keepdims)


def _nan_fill(a, value):
    if not a.dtype.is_floating_point:
        return a
    return torch.where(torch.isnan(a), torch.full_like(a, value), a)


def nansum(a, axis=None, dtype=None, keepdims=False):
    return sum(_nan_fill(a, 0.0), axis, dtype, keepdims)


def nanprod(a, axis=None, dtype=None, keepdims=False):
    return prod(_nan_fill(a, 1.0), axis, dtype, keepdims)


def nanmean(a, axis=None, dtype=None, keepdims=False):
    x = inexact(a) if dtype is None else a.to(dtype)
    ok = ~torch.isnan(x)
    return sum(_nan_fill(x, 0.0), axis, None, keepdims) / \
        sum(ok, axis, None, keepdims).to(x.dtype)


def nanvar(a, axis=None, dtype=None, ddof=0, keepdims=False):
    x = inexact(a) if dtype is None else a.to(dtype)
    ok = ~torch.isnan(x)
    n = sum(ok, axis, None, True).to(x.dtype)
    m = sum(_nan_fill(x, 0.0), axis, None, True) / n
    d = torch.where(ok, x - m, torch.zeros_like(x))
    out = sum(d * d, axis, None, True) / torch.clamp(n - ddof, min=0)
    return out if keepdims else out.reshape(
        [s for i, s in enumerate(out.shape) if i not in ax(a, axis)])


def nanstd(a, axis=None, dtype=None, ddof=0, keepdims=False):
    return torch.sqrt(nanvar(a, axis, dtype, ddof, keepdims))


def nanmax(a, axis=None, keepdims=False):
    out = amax(_nan_fill(a, -math.inf), axis, keepdims)
    if a.dtype.is_floating_point:
        allnan = all(torch.isnan(a), axis, keepdims)
        out = torch.where(allnan, torch.full_like(out, math.nan), out)
    return out


def nanmin(a, axis=None, keepdims=False):
    out = amin(_nan_fill(a, math.inf), axis, keepdims)
    if a.dtype.is_floating_point:
        allnan = all(torch.isnan(a), axis, keepdims)
        out = torch.where(allnan, torch.full_like(out, math.nan), out)
    return out


def cumsum(a, axis=None, dtype=None):
    a, axis = _flat_or(a, axis)
    return a.cumsum(dim=axis, dtype=_acc_dtype(a, dtype))


def cumprod(a, axis=None, dtype=None):
    a, axis = _flat_or(a, axis)
    return a.cumprod(dim=axis, dtype=_acc_dtype(a, dtype))


def nancumsum(a, axis=None, dtype=None):
    return cumsum(_nan_fill(a, 0.0), axis, dtype)


def nancumprod(a, axis=None, dtype=None):
    return cumprod(_nan_fill(a, 1.0), axis, dtype)


# -- order statistics ---------------------------------------------------------

def _quantile_sorted(s, q, method, n=None):
    """Quantiles ``q`` (a 0-d or 1-d float tensor in [0, 1]) of ``s``,
    sorted along its last dim, with ``n`` valid entries per row (default
    all).  Output: ``q.shape + s.shape[:-1]``."""
    length = s.shape[-1]
    if n is None:
        n = torch.full(s.shape[:-1], length, device=s.device,
                       dtype=torch.int64)
    qv = q.reshape(-1).to(torch.float64)
    pos = qv.reshape((-1,) + (1,) * (s.dim() - 1)) * \
        (n.to(torch.float64) - 1).unsqueeze(0)           # (Q, ...)
    lo = torch.floor(pos)
    hi = torch.ceil(pos)
    if method == "lower":
        idx_lo = idx_hi = lo
    elif method == "higher":
        idx_lo = idx_hi = hi
    elif method == "nearest":
        idx_lo = idx_hi = torch.round(pos)      # half to even, as numpy
    elif method == "midpoint":
        idx_lo, idx_hi = lo, hi
    elif method == "linear":
        idx_lo, idx_hi = lo, hi
    else:
        raise ValueError(f"quantile method {method!r} is not supported")
    last = (n - 1).clamp(min=0).unsqueeze(0)
    il = torch.minimum(idx_lo.long(), last).clamp(min=0)
    ih = torch.minimum(idx_hi.long(), last).clamp(min=0)
    se = s.unsqueeze(0).expand((qv.numel(),) + tuple(s.shape))
    vl = torch.gather(se, -1, il.unsqueeze(-1)).squeeze(-1)
    vh = torch.gather(se, -1, ih.unsqueeze(-1)).squeeze(-1)
    if method == "linear":
        w = (pos - lo).to(s.dtype)
        out = vl + (vh - vl) * w
    elif method == "midpoint":
        out = (vl + vh) / 2
    else:
        out = vl
    return out.reshape(tuple(q.shape) + tuple(s.shape[:-1]))


def _quantile(a, q, axis, method, keepdims, nan=False):
    x = inexact(a)
    q = as_t(q, x, dtype=torch.float64)
    if axis is None:
        xm = x.reshape(-1)
        dims = tuple(range(a.dim()))
    else:
        dims = ax(a, axis)
        rest = [d for d in range(a.dim()) if d not in dims]
        xm = x.permute(rest + list(dims)).reshape(
            [a.shape[d] for d in rest] + [-1])
    s = torch.sort(xm, dim=-1, stable=True)[0]     # NaN sorts last
    n = None
    if nan:
        n = (~torch.isnan(xm)).sum(-1)
    out = _quantile_sorted(s, q, method, n)
    if nan:
        out = torch.where(n.unsqueeze(0).reshape(
            (1,) * q.dim() + tuple(n.shape)) == 0,
            torch.full_like(out, math.nan), out)
    if keepdims:
        for d in sorted(dims):
            out = out.unsqueeze(q.dim() + d)
    return out


def quantile(a, q, axis=None, out=None, overwrite_input=False,
             method="linear", keepdims=False, interpolation=None):
    return _quantile(a, q, axis, interpolation or method, keepdims)


def percentile(a, q, axis=None, out=None, overwrite_input=False,
               method="linear", keepdims=False, interpolation=None):
    q = as_t(q, a, dtype=torch.float64) / 100.0
    return _quantile(a, q, axis, interpolation or method, keepdims)


def nanquantile(a, q, axis=None, out=None, overwrite_input=False,
                method="linear", keepdims=False, interpolation=None):
    return _quantile(a, q, axis, interpolation or method, keepdims, True)


def nanpercentile(a, q, axis=None, out=None, overwrite_input=False,
                  method="linear", keepdims=False, interpolation=None):
    q = as_t(q, a, dtype=torch.float64) / 100.0
    return _quantile(a, q, axis, interpolation or method, keepdims, True)


def median(a, axis=None, out=None, overwrite_input=False, keepdims=False):
    return _quantile(a, 0.5, axis, "linear", keepdims)


def nanmedian(a, axis=None, out=None, overwrite_input=False,
              keepdims=False):
    return _quantile(a, 0.5, axis, "linear", keepdims, True)


def average(a, axis=None, weights=None, returned=False, keepdims=False):
    x = inexact(a)
    if weights is None:
        avg = mean(x, axis, keepdims=keepdims)
        if returned:
            cnt = x.numel() // max(avg.numel(), 1)
            return avg, torch.full_like(avg, cnt)
        return avg
    w = as_t(weights, x).to(x.dtype)
    if w.shape != x.shape:
        shape = [1] * x.dim()
        shape[axis if axis is not None else 0] = -1
        w = w.reshape(shape)
        w = w.expand_as(x)
    sw = sum(w, axis, keepdims=keepdims)
    avg = sum(x * w, axis, keepdims=keepdims) / sw
    return (avg, sw) if returned else avg


def sort(a, axis=-1, kind=None, order=None):
    a, axis = _flat_or(a, axis)
    return torch.sort(a, dim=axis, stable=True)[0]


def argsort(a, axis=-1, kind=None, order=None):
    a, axis = _flat_or(a, axis)
    return torch.sort(a, dim=axis, stable=True)[1]


def partition(a, kth, axis=-1, kind="introselect", order=None):
    """A full sort is a valid partition around every ``kth``."""
    return sort(a, axis)


def argpartition(a, kth, axis=-1, kind="introselect", order=None):
    return argsort(a, axis)


def searchsorted(a, v, side="left", sorter=None):
    if sorter is not None:
        a = a[sorter]
    v = as_t(v, a, dtype=a.dtype)
    a, v = pair(a, v)
    return torch.searchsorted(a.contiguous(), v.contiguous(),
                              right=(side == "right"))


# -- data-dependent shapes ----------------------------------------------------

def nonzero(a):
    return tuple(torch.nonzero(torch.atleast_1d(a), as_tuple=True))


def flatnonzero(a):
    return torch.nonzero(a.reshape(-1), as_tuple=True)[0]


def argwhere(a):
    return torch.nonzero(a) if a.dim() else \
        torch.nonzero(a.reshape(1))[:, :0]


def extract(condition, arr):
    return arr.reshape(-1)[condition.reshape(-1).bool()]


def compress(condition, a, axis=None):
    cond = as_t(condition, a).bool().reshape(-1)
    a, axis = _flat_or(a, axis)
    idx = torch.nonzero(cond, as_tuple=True)[0]
    return a.index_select(axis, idx)


def where(condition, x=None, y=None):
    if x is None and y is None:
        return nonzero(condition)
    c = as_t(condition, x if isinstance(x, torch.Tensor) else y).bool()
    x, y = pair(as_t(x, c) if not isinstance(x, (int, float, bool))
                else x, y)
    return torch.where(c, x, y)


def unique(ar, return_index=False, return_inverse=False,
           return_counts=False, axis=None, equal_nan=True):
    x = ar.reshape(-1) if axis is None else ar
    u, inv, cnt = torch.unique(x, sorted=True, return_inverse=True,
                               return_counts=True, dim=axis)
    outs = [u]
    if return_index:
        n = x.shape[0 if axis is None else axis]
        pos = torch.arange(n, device=x.device)
        first = torch.full((u.shape[0 if axis is None else axis],), n,
                           device=x.device, dtype=pos.dtype)
        outs.append(first.scatter_reduce(0, inv, pos, "amin"))
    if return_inverse:
        outs.append(inv if axis is not None else inv.reshape(ar.shape))
    if return_counts:
        outs.append(cnt)
    return outs[0] if len(outs) == 1 else tuple(outs)


def isin(element, test_elements, assume_unique=False, invert=False):
    e = as_t(element)
    t = as_t(test_elements, e)
    e, t = pair(e, t)
    return torch.isin(e, t, invert=invert)


def in1d(ar1, ar2, assume_unique=False, invert=False):
    return isin(ar1, ar2, invert=invert).reshape(-1)


def union1d(ar1, ar2):
    a, b = pair(ar1, ar2)
    return torch.unique(torch.cat([a.reshape(-1), b.reshape(-1)]))


def intersect1d(ar1, ar2, assume_unique=False, return_indices=False):
    a, b = pair(ar1, ar2)
    ua, ub = torch.unique(a.reshape(-1)), torch.unique(b.reshape(-1))
    return ua[torch.isin(ua, ub)]


def setdiff1d(ar1, ar2, assume_unique=False):
    a, b = pair(ar1, ar2)
    ua = torch.unique(a.reshape(-1))
    return ua[~torch.isin(ua, b.reshape(-1))]


def setxor1d(ar1, ar2, assume_unique=False):
    a, b = pair(ar1, ar2)
    ua, ub = torch.unique(a.reshape(-1)), torch.unique(b.reshape(-1))
    return torch.unique(torch.cat([ua[~torch.isin(ua, ub)],
                                   ub[~torch.isin(ub, ua)]]))


def bincount(x, weights=None, minlength=0, length=None):
    x = x.reshape(-1).long()
    n = length if length is not None else None
    w = None if weights is None else as_t(weights, x).reshape(-1)
    if n is None:
        return torch.bincount(x, weights=w, minlength=minlength)
    ok = (x >= 0) & (x < n)
    xs = torch.where(ok, x, torch.zeros_like(x))
    if w is None:
        src = ok.to(torch.int64)
    else:
        src = torch.where(ok, w, torch.zeros_like(w))
    out = torch.zeros(n, device=x.device, dtype=src.dtype)
    return out.scatter_add(0, xs, src)


# -- products -----------------------------------------------------------------

def dot(a, b):
    a, b = pair(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1:
        return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


def vdot(a, b):
    a, b = pair(a, b)
    a = a.reshape(-1)
    return torch.dot(a.conj() if a.dtype.is_complex else a, b.reshape(-1))


def inner(a, b):
    a, b = pair(a, b)
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 1]))


def outer(a, b):
    a, b = pair(a, b)
    return torch.outer(a.reshape(-1), b.reshape(-1))


def matmul(a, b):
    a, b = pair(a, b)
    return torch.matmul(a, b)


def tensordot(a, b, axes=2):
    a, b = pair(a, b)
    if isinstance(axes, int):
        return torch.tensordot(a, b, dims=axes)
    xa, xb = axes
    xa = [xa] if isinstance(xa, int) else list(xa)
    xb = [xb] if isinstance(xb, int) else list(xb)
    return torch.tensordot(a, b, dims=(xa, xb))


def kron(a, b):
    a, b = pair(a, b)
    return torch.kron(a, b)


def cross(a, b, axisa=-1, axisb=-1, axisc=-1, axis=None):
    a, b = pair(a, b)
    if axis is not None:
        axisa = axisb = axisc = axis
    a = torch.movedim(a, axisa, -1)
    b = torch.movedim(b, axisb, -1)
    if a.shape[-1] == 2:
        a = F.pad(a, (0, 1))
    if b.shape[-1] == 2:
        b = F.pad(b, (0, 1))
    out = torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)
    return torch.movedim(out, -1, axisc)


def einsum(subscripts, *operands, optimize=None, **kw):
    ops = [as_t(o) for o in operands]
    if len(ops) > 1:
        dt = ops[0].dtype
        for o in ops[1:]:
            dt = torch.promote_types(dt, o.dtype)
        ops = [o.to(dt) for o in ops]
    return torch.einsum(subscripts, *ops)


def trace(a, offset=0, axis1=0, axis2=1, dtype=None):
    d = torch.diagonal(a, offset=offset, dim1=axis1, dim2=axis2)
    return d.sum(-1, dtype=_acc_dtype(a, dtype))


def diagonal(a, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, offset=offset, dim1=axis1, dim2=axis2)


def diag(v, k=0):
    return torch.diag(v, k) if v.dim() == 1 else \
        torch.diagonal(v, offset=k).clone()


def diagflat(v, k=0):
    return torch.diagflat(v.reshape(-1), offset=k)


def tril(m, k=0):
    return torch.tril(m, k)


def triu(m, k=0):
    return torch.triu(m, k)


def tri(N, M=None, k=0, dtype=None, device=None):
    M = N if M is None else M
    return torch.tril(torch.ones(N, M, device=device,
                                 dtype=dtype or float_default()), k)


def vander(x, N=None, increasing=False):
    n = x.shape[0] if N is None else N
    p = torch.arange(n, device=x.device)
    if not increasing:
        p = p.flip(0)
    return x.unsqueeze(-1) ** p.to(x.dtype if x.dtype.is_floating_point
                                   else torch.int64)


# -- shapes -------------------------------------------------------------------

def reshape(a, newshape=None, order="C", shape=None):
    shape = newshape if newshape is not None else shape
    if isinstance(shape, int):
        shape = (shape,)
    if order == "F":
        return a.permute(*reversed(range(a.dim()))).reshape(
            tuple(reversed(shape))).permute(
            *reversed(range(len(shape))))
    return a.reshape(tuple(shape))


def ravel(a, order="C"):
    return reshape(a, (-1,), order)


def transpose(a, axes=None):
    if axes is None:
        return a.permute(*reversed(range(a.dim())))
    return a.permute(*axes)


def swapaxes(a, axis1, axis2):
    return torch.swapaxes(a, axis1, axis2)


def moveaxis(a, source, destination):
    return torch.movedim(a, source, destination)


def rollaxis(a, axis, start=0):
    n = a.dim()
    axis %= n
    start = start + n if start < 0 else start
    if axis < start:
        start -= 1
    if axis == start:
        return a
    return torch.movedim(a, axis, start)


def expand_dims(a, axis):
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    n = a.dim() + len(axes)
    out = a
    for d in sorted(x % n for x in axes):
        out = out.unsqueeze(d)
    return out


def squeeze(a, axis=None):
    if axis is None:
        return a.squeeze()
    axes = axis if isinstance(axis, (list, tuple)) else (axis,)
    for d in sorted((x % a.dim() for x in axes), reverse=True):
        a = a.squeeze(d)
    return a


def broadcast_to(a, shape):
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.broadcast_to(a, shape)


def broadcast_arrays(*args):
    ts = [as_t(a) for a in args]
    return tuple(torch.broadcast_tensors(*ts))


def _atleast(fn):
    def f(*arys):
        outs = [fn(as_t(a)) for a in arys]
        return outs[0] if len(outs) == 1 else tuple(outs)
    return f


atleast_1d = _atleast(torch.atleast_1d)
atleast_2d = _atleast(torch.atleast_2d)


def _at3(t):
    if t.dim() == 0:
        return t.reshape(1, 1, 1)
    if t.dim() == 1:
        return t.reshape(1, -1, 1)
    if t.dim() == 2:
        return t.unsqueeze(-1)
    return t


atleast_3d = _atleast(_at3)


def _common(arrays):
    ts = [as_t(a) for a in arrays]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    dev = next((t.device for t in ts if t.dim()), ts[0].device)
    return [t.to(device=dev, dtype=dt) for t in ts]


def concatenate(arrays, axis=0, out=None, dtype=None):
    ts = _common(arrays)
    if axis is None:
        ts, axis = [t.reshape(-1) for t in ts], 0
    out = torch.cat(ts, dim=axis)
    return out if dtype is None else out.to(dtype)


def stack(arrays, axis=0, out=None, dtype=None):
    out = torch.stack(_common(arrays), dim=axis)
    return out if dtype is None else out.to(dtype)


def vstack(tup):
    return torch.cat([torch.atleast_2d(t) for t in _common(tup)], 0)


row_stack = vstack


def hstack(tup):
    ts = [torch.atleast_1d(t) for t in _common(tup)]
    return torch.cat(ts, 0 if ts[0].dim() == 1 else 1)


def dstack(tup):
    return torch.cat([_at3(t) for t in _common(tup)], 2)


def column_stack(tup):
    ts = [t.reshape(-1, 1) if t.dim() < 2 else t for t in _common(tup)]
    return torch.cat(ts, 1)


def array_split(a, indices_or_sections, axis=0):
    ios = indices_or_sections
    if isinstance(ios, torch.Tensor):
        ios = ios.tolist()
    return tuple(torch.tensor_split(a, ios if isinstance(ios, int)
                                    else list(ios), dim=axis))


def split(a, indices_or_sections, axis=0):
    if isinstance(indices_or_sections, int) and \
            a.shape[axis] % indices_or_sections:
        raise ValueError("array split does not result in an equal "
                         "division")
    return array_split(a, indices_or_sections, axis)


def hsplit(a, indices_or_sections):
    return split(a, indices_or_sections, 1 if a.dim() > 1 else 0)


def vsplit(a, indices_or_sections):
    return split(a, indices_or_sections, 0)


def dsplit(a, indices_or_sections):
    return split(a, indices_or_sections, 2)


def tile(a, reps):
    reps = (reps,) if isinstance(reps, int) else tuple(reps)
    return torch.tile(a, reps)


def repeat(a, repeats, axis=None):
    a, axis = _flat_or(a, axis)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.reshape(-1).long()
        if repeats.numel() == 1:
            repeats = int(repeats)
    return torch.repeat_interleave(a, repeats, dim=axis)


def flip(m, axis=None):
    return torch.flip(m, ax(m, axis))


def fliplr(m):
    return torch.flip(m, (1,))


def flipud(m):
    return torch.flip(m, (0,))


def roll(a, shift, axis=None):
    if axis is None:
        return torch.roll(a.reshape(-1), shift).reshape(a.shape)
    return torch.roll(a, shift, axis)


def rot90(m, k=1, axes=(0, 1)):
    return torch.rot90(m, k, list(axes))


def append(arr, values, axis=None):
    arr, values = pair(arr, values)
    if axis is None:
        return torch.cat([arr.reshape(-1), values.reshape(-1)])
    return torch.cat([arr, values], axis)


def _positions(obj, n, device):
    if isinstance(obj, slice):
        return torch.arange(n, device=device)[obj]
    t = as_t(obj, device=device)
    return t.reshape(-1).long() if isinstance(t, torch.Tensor) else t


def delete(arr, obj, axis=None):
    arr, axis = _flat_or(arr, axis)
    n = arr.shape[axis]
    pos = _positions(obj, n, arr.device).to(arr.device)
    pos = torch.where(pos < 0, pos + n, pos)
    keep = torch.ones(n, dtype=torch.bool, device=arr.device)
    keep[pos] = False
    return arr.index_select(axis, torch.nonzero(keep, as_tuple=True)[0])


def insert(arr, obj, values, axis=None):
    arr, axis = _flat_or(arr, axis)
    n = arr.shape[axis]
    scalar_obj = isinstance(obj, int) or (isinstance(obj, torch.Tensor)
                                         and obj.dim() == 0)
    pos = _positions(obj, n + 1, arr.device).to(arr.device)
    pos = torch.where(pos < 0, pos + n, pos)
    vals = as_t(values, arr).to(arr.dtype)
    moved = torch.movedim(arr, axis, 0)
    if scalar_obj:
        # numpy inserts all of ``values`` at one index
        if vals.dim() == 0:
            vals = vals.expand((1,) + moved.shape[1:])
        else:
            v = torch.movedim(vals, axis, 0) if vals.dim() == arr.dim() \
                else vals.unsqueeze(0)
            vals = torch.broadcast_to(v, (v.shape[0],) + moved.shape[1:])
        p = int(pos.reshape(-1)[0])
        out = torch.cat([moved[:p], vals, moved[p:]], 0)
    else:
        k = pos.numel()
        vals = torch.broadcast_to(vals, (k,) + moved.shape[1:]) \
            if vals.dim() <= moved.dim() - 1 or vals.shape[0] != k else vals
        # stable order: each inserted row goes before the original row
        order = torch.cat([torch.arange(n, device=arr.device) * 2 + 1,
                           pos.sort(stable=True)[0] * 2])
        src = torch.cat([moved, vals[torch.argsort(pos, stable=True)]], 0)
        out = src[torch.argsort(order, stable=True)]
    return torch.movedim(out, 0, axis)


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        j = i % period
        return torch.where(j >= n, period - j, j)
    if mode == "symmetric":
        period = 2 * n
        j = i % period
        return torch.where(j >= n, period - 1 - j, j)
    raise ValueError(f"pad mode {mode!r} is not supported")


def _pad_pairs(pad_width, ndim):
    if isinstance(pad_width, torch.Tensor):
        pad_width = pad_width.tolist()
    if isinstance(pad_width, int):
        return [(pad_width, pad_width)] * ndim
    pw = list(pad_width)
    if pw and isinstance(pw[0], int):
        if len(pw) == 1:
            return [(pw[0], pw[0])] * ndim
        return [tuple(pw)] * ndim
    if len(pw) == 1:
        return [tuple(pw[0])] * ndim
    return [tuple(p) for p in pw]


def pad(array, pad_width, mode="constant", constant_values=0, **kwargs):
    out = array
    pairs = _pad_pairs(pad_width, array.dim())
    cv = _pad_pairs(constant_values, array.dim()) \
        if not isinstance(constant_values, (int, float)) else None
    for d, (b, a) in enumerate(pairs):
        if b == 0 and a == 0:
            continue
        if mode == "constant":
            vb, va = (cv[d] if cv else (constant_values, constant_values))
            shp_b = list(out.shape)
            shp_b[d] = b
            shp_a = list(out.shape)
            shp_a[d] = a
            out = torch.cat([torch.full(shp_b, vb, dtype=out.dtype,
                                        device=out.device), out,
                             torch.full(shp_a, va, dtype=out.dtype,
                                        device=out.device)], d)
        else:
            idx = _pad_index(out.shape[d], b, a, mode, out.device)
            out = out.index_select(d, idx)
    return out


# -- indexing -----------------------------------------------------------------

def take(a, indices, axis=None, mode=None):
    idx = as_t(indices, a).long()
    a, axis = _flat_or(a, axis)
    n = a.shape[axis]
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = idx % n
    else:
        idx = torch.where(idx < 0, idx + n, idx)
    out = a.index_select(axis, idx.reshape(-1))
    shape = a.shape[:axis] + idx.shape + a.shape[axis + 1:]
    return out.reshape(shape)


def take_along_axis(arr, indices, axis):
    idx = indices.long()
    if axis is None:
        arr, axis = arr.reshape(-1), 0
    n = arr.shape[axis]
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.take_along_dim(arr, idx, dim=axis)


def put_along_axis(arr, indices, values, axis, inplace=True, mode=None):
    """``arr`` with ``values`` put along ``axis`` at ``indices``, as a new
    array (arrays are not written in place, as in the reference)."""
    idx = indices.long()
    vals = torch.broadcast_to(as_t(values, arr).to(arr.dtype), idx.shape)
    return arr.scatter(axis, idx, vals)


def choose(a, choices, out=None, mode="raise"):
    cs = torch.stack(torch.broadcast_tensors(*_common(choices)), 0)
    idx = a.long()
    if mode == "clip":
        idx = idx.clamp(0, cs.shape[0] - 1)
    elif mode == "wrap":
        idx = idx % cs.shape[0]
    idx = torch.broadcast_to(idx, cs.shape[1:])
    return torch.gather(cs, 0, idx.unsqueeze(0)).squeeze(0)


def select(condlist, choicelist, default=0):
    conds = [as_t(c).bool() for c in condlist]
    chs = _common(choicelist)
    out = as_t(default, chs[0]).to(chs[0].dtype)
    for c, v in zip(reversed(conds), reversed(chs)):
        out = torch.where(c, v, out)
    return out


def piecewise(x, condlist, funclist, *args, **kw):
    conds = [as_t(c, x).bool() for c in (
        condlist if isinstance(condlist, (list, tuple)) else [condlist])]
    if len(funclist) == len(conds) + 1:
        conds.append(~torch.stack(conds).any(0))
    out = torch.zeros_like(x)
    for c, f in zip(conds, funclist):
        v = f(x, *args, **kw) if callable(f) else f
        out = torch.where(c, as_t(v, x).to(x.dtype), out)
    return out


def indices(dimensions, dtype=None, sparse=False, device=None):
    dt = dtype or int_default()
    grids = torch.meshgrid(*[torch.arange(d, device=device, dtype=dt)
                             for d in dimensions], indexing="ij")
    return torch.stack(grids, 0) if len(grids) else \
        torch.zeros((0,), dtype=dt, device=device)


def unravel_index(indices, shape, order="C"):
    idx = as_t(indices).long()
    out = []
    for s in reversed(tuple(shape)):
        out.append(idx % s)
        idx = torch.div(idx, s, rounding_mode="floor")
    return tuple(reversed(out))


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    ts = [as_t(m).long() for m in multi_index]
    out = torch.zeros_like(ts[0])
    for t, d in zip(ts, dims):
        if mode == "clip":
            t = t.clamp(0, d - 1)
        elif mode == "wrap":
            t = t % d
        out = out * d + t
    return out


def ix_(*args):
    n = len(args)
    outs = []
    for i, a in enumerate(args):
        t = as_t(a).reshape(-1)
        if t.dtype == torch.bool:
            t = torch.nonzero(t, as_tuple=True)[0]
        shape = [1] * n
        shape[i] = -1
        outs.append(t.reshape(shape))
    return tuple(outs)


def triu_indices(n, k=0, m=None, device=None):
    ij = torch.triu_indices(n, n if m is None else m, k, device=device)
    return ij[0], ij[1]


def tril_indices(n, k=0, m=None, device=None):
    ij = torch.tril_indices(n, n if m is None else m, k, device=device)
    return ij[0], ij[1]


def triu_indices_from(arr, k=0):
    return triu_indices(arr.shape[-2], k, arr.shape[-1], arr.device)


def tril_indices_from(arr, k=0):
    return tril_indices(arr.shape[-2], k, arr.shape[-1], arr.device)


def diag_indices_from(arr):
    i = torch.arange(arr.shape[0], device=arr.device)
    return (i,) * arr.dim()


# -- numerics -----------------------------------------------------------------

def clip(a, a_min=None, a_max=None):
    lo = None if a_min is None else (a_min if not isinstance(
        a_min, torch.Tensor) else a_min.to(a.dtype))
    hi = None if a_max is None else (a_max if not isinstance(
        a_max, torch.Tensor) else a_max.to(a.dtype))
    return torch.clamp(a, lo, hi)


def interp(x, xp, fp, left=None, right=None, period=None):
    x = inexact(as_t(x))
    xp = as_t(xp, x).to(x.dtype)
    fp = as_t(fp, x)
    fp = fp.to(torch.promote_types(fp.dtype, x.dtype)) \
        if not fp.dtype.is_complex else fp
    if period is not None:
        x = x % period
        xp = xp % period
        order = torch.argsort(xp, stable=True)
        xp, fp = xp[order], fp[order]
        xp = torch.cat([xp[-1:] - period, xp, xp[:1] + period])
        fp = torch.cat([fp[-1:], fp, fp[:1]])
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i = i.clamp(1, xp.numel() - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    w = torch.where(dx == 0, torch.zeros_like(dx), (x - x0) / torch.where(
        dx == 0, torch.ones_like(dx), dx))
    out = f0 + w * (f1 - f0)
    if period is None:
        lv = fp[0] if left is None else torch.as_tensor(
            left, dtype=out.dtype, device=x.device)
        rv = fp[-1] if right is None else torch.as_tensor(
            right, dtype=out.dtype, device=x.device)
        out = torch.where(x < xp[0], lv, out)
        out = torch.where(x > xp[-1], rv, out)
    return out


def _conv_full(a, v):
    """Full discrete convolution of two 1-d tensors."""
    a, v = pair(a, v)
    dt = a.dtype
    work = dt if dt.is_floating_point else float_default()
    n, m = a.numel(), v.numel()
    out = F.conv1d(a.to(work).reshape(1, 1, n),
                   v.to(work).flip(0).reshape(1, 1, m),
                   padding=m - 1).reshape(-1)
    return out if dt.is_floating_point else torch.round(out).to(dt)


def convolve(a, v, mode="full"):
    if a.numel() < v.numel():
        a, v = v, a
    full = _conv_full(a, v)
    n, m = a.numel(), v.numel()
    if mode == "full":
        return full
    if mode == "same":
        start = (m - 1) // 2
        return full[start:start + n]
    if mode == "valid":
        return full[m - 1:n]
    raise ValueError(f"convolve mode {mode!r}")


def correlate(a, v, mode="valid"):
    v = v.conj() if isinstance(v, torch.Tensor) and v.dtype.is_complex \
        else v
    swap = a.numel() < v.numel()
    out = convolve(a, as_t(v, a).flip(0), mode) if not swap else \
        convolve(v.flip(0), a, mode)
    return out.flip(0) if swap else out


def _edges(a, bins, rng, device):
    if isinstance(bins, torch.Tensor) or isinstance(bins, (list, tuple)):
        return as_t(bins, device=device).to(float_default()
                                             if not isinstance(
                                                 bins, torch.Tensor)
                                             else bins.dtype)
    if rng is None:
        lo, hi = (a.min(), a.max()) if a.numel() else (
            torch.tensor(0.0), torch.tensor(1.0))
    else:
        lo, hi = (torch.as_tensor(r, dtype=a.dtype, device=device)
                  for r in rng)
    lo, hi = lo.to(a.dtype), hi.to(a.dtype)
    same = lo == hi
    lo = torch.where(same, lo - 0.5, lo)
    hi = torch.where(same, hi + 0.5, hi)
    t = torch.linspace(0, 1, int(bins) + 1, device=device, dtype=a.dtype)
    e = lo + (hi - lo) * t
    return torch.cat([e[:-1], hi.reshape(1)])       # the last edge exact


def _bin_index(x, edges):
    """numpy's bins: half-open, the last one closed; -1 outside."""
    n = edges.numel() - 1
    i = torch.bucketize(x, edges.to(x.dtype), right=True) - 1
    i = torch.where(x == edges[-1].to(x.dtype),
                    torch.full_like(i, n - 1), i)
    return torch.where((i < 0) | (i >= n), torch.full_like(i, -1), i)


def histogram(a, bins=10, range=None, density=None, weights=None):
    x = inexact(a).reshape(-1)
    edges = _edges(x, bins, range, x.device)
    n = edges.numel() - 1
    i = _bin_index(x, edges)
    ok = i >= 0
    w = torch.ones_like(x) if weights is None else \
        as_t(weights, x).reshape(-1).to(x.dtype)
    w = torch.where(ok, w, torch.zeros_like(w))
    counts = torch.zeros(n, dtype=w.dtype, device=x.device).scatter_add(
        0, i.clamp(min=0), w)
    if density:
        counts = counts / (counts.sum() * torch.diff(edges).to(w.dtype))
    return counts, edges


def histogramdd(sample, bins=10, range=None, density=None, weights=None):
    s = inexact(sample)
    if s.dim() == 1:
        s = s.reshape(-1, 1)
    d = s.shape[1]
    bl = bins if isinstance(bins, (list, tuple)) else [bins] * d
    rl = range if range is not None else [None] * d
    edges, flat = [], None
    ok = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    for j in builtins.range(d):
        e = _edges(s[:, j], bl[j], rl[j], s.device)
        i = _bin_index(s[:, j], e)
        ok = ok & (i >= 0)
        nb = e.numel() - 1
        flat = i.clamp(min=0) if flat is None else flat * nb + i.clamp(min=0)
        edges.append(e)
    # counts are integers without weights, as the reference's
    w = torch.ones(s.shape[0], dtype=torch.int64, device=s.device) \
        if weights is None else as_t(weights, s).reshape(-1).to(s.dtype)
    w = torch.where(ok, w, torch.zeros_like(w))
    sizes = [e.numel() - 1 for e in edges]
    total = 1
    for sz in sizes:
        total *= sz
    h = torch.zeros(total, dtype=w.dtype, device=s.device).scatter_add(
        0, flat, w).reshape(sizes)
    if density:
        vol = torch.ones_like(h)
        for j, e in enumerate(edges):
            shape = [1] * d
            shape[j] = -1
            vol = vol * torch.diff(e).to(h.dtype).reshape(shape)
        h = h / (h.sum() * vol)
    if len({e.numel() for e in edges}) == 1:
        # edges of one length come as one array, as the reference's
        return h, torch.stack(edges)
    return h, tuple(edges)




def histogram2d(x, y, bins=10, range=None, density=None, weights=None):
    h, edges = histogramdd(torch.stack([x, y], 1), bins, range, density,
                           weights)
    return h, edges[0], edges[1]


def digitize(x, bins, right=False):
    x, b = pair(x, bins)
    incr = bool(b.numel() < 2 or b[-1] >= b[0])
    if incr:
        return torch.searchsorted(b.contiguous(), x.contiguous(),
                                  right=not right)
    rb = b.flip(0).contiguous()
    return b.numel() - torch.searchsorted(rb, x.contiguous(), right=right)


def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
        aweights=None, dtype=None):
    x = inexact(m if dtype is None else m.to(dtype))
    if x.dim() == 1:
        x = x.reshape(1, -1)
    if not rowvar and x.shape[0] != 1:
        x = x.T
    if y is not None:
        yy = inexact(as_t(y, x)).to(x.dtype)
        if yy.dim() == 1:
            yy = yy.reshape(1, -1)
        if not rowvar and yy.shape[0] != 1:
            yy = yy.T
        x = torch.cat([x, yy], 0)
    corr = (0 if bias else 1) if ddof is None else ddof
    out = torch.cov(x, correction=corr,
                    fweights=None if fweights is None else fweights.long(),
                    aweights=aweights)
    return out.squeeze() if out.dim() and out.numel() == 1 else out


def corrcoef(x, y=None, rowvar=True, dtype=None):
    c = cov(x, y, rowvar, dtype=dtype)
    if c.dim() == 0:
        return c / c
    d = torch.sqrt(torch.diagonal(c).real)
    out = c / d[:, None] / d[None, :]
    return out.clamp(-1, 1) if not out.dtype.is_complex else out


def gradient(f, *varargs, axis=None, edge_order=1):
    x = inexact(f)
    dims = list(ax(x, axis))
    if not varargs:
        spacing = 1.0
    elif len(varargs) == 1 and not isinstance(varargs[0], torch.Tensor):
        spacing = float(varargs[0])
    else:
        spacing = [v if isinstance(v, torch.Tensor) else float(v)
                   for v in varargs]
    if isinstance(spacing, list) and all(isinstance(s, float)
                                         for s in spacing):
        spacing = spacing if len(spacing) > 1 else spacing[0]
    if isinstance(spacing, list):
        spacing = [s.to(x.dtype) if isinstance(s, torch.Tensor) else s
                   for s in spacing]
        spacing = [(s,) if isinstance(s, torch.Tensor) else s
                   for s in spacing]
    out = torch.gradient(x, spacing=spacing, dim=dims,
                         edge_order=edge_order)
    return out[0] if len(out) == 1 else tuple(out)


def diff(a, n=1, axis=-1, prepend=None, append=None):
    if n == 0:
        return a
    pre = None if prepend is None else torch.broadcast_to(
        as_t(prepend, a).to(a.dtype),
        a.shape[:axis % a.dim()] + (1,) + a.shape[axis % a.dim() + 1:]) \
        if not isinstance(prepend, torch.Tensor) or prepend.dim() == 0 \
        else prepend
    app = None if append is None else torch.broadcast_to(
        as_t(append, a).to(a.dtype),
        a.shape[:axis % a.dim()] + (1,) + a.shape[axis % a.dim() + 1:]) \
        if not isinstance(append, torch.Tensor) or append.dim() == 0 \
        else append
    if a.dtype == torch.bool:
        x = a
        for _ in builtins.range(n):
            x = torch.logical_xor(x.narrow(axis, 1, x.shape[axis] - 1),
                                  x.narrow(axis, 0, x.shape[axis] - 1))
        return x
    return torch.diff(a, n=n, dim=axis, prepend=pre, append=app)


def ediff1d(ary, to_end=None, to_begin=None):
    x = ary.reshape(-1)
    parts = []
    if to_begin is not None:
        parts.append(as_t(to_begin, x).to(x.dtype).reshape(-1))
    parts.append(x[1:] - x[:-1])
    if to_end is not None:
        parts.append(as_t(to_end, x).to(x.dtype).reshape(-1))
    return torch.cat(parts)


def trapezoid(y, x=None, dx=1.0, axis=-1):
    y = inexact(y)
    if x is None:
        return torch.trapezoid(y, dx=dx, dim=axis)
    return torch.trapezoid(y, as_t(x, y).to(y.dtype), dim=axis)


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    a, b = pair(a, b)
    if not a.dtype.is_floating_point and not a.dtype.is_complex:
        a, b = a.to(float_default()), b.to(float_default())
    return torch.isclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return isclose(a, b, rtol, atol, equal_nan).all()


def array_equal(a1, a2, equal_nan=False):
    a1, a2 = as_t(a1), as_t(a2)
    if a1.shape != a2.shape:
        return torch.tensor(False, device=a1.device)
    a1, a2 = pair(a1, a2)
    eq = a1 == a2
    if equal_nan and a1.dtype.is_floating_point:
        eq = eq | (torch.isnan(a1) & torch.isnan(a2))
    return eq.all()


def array_equiv(a1, a2):
    a1, a2 = pair(as_t(a1), as_t(a2))
    try:
        b1, b2 = torch.broadcast_tensors(a1, a2)
    except RuntimeError:
        return torch.tensor(False, device=a1.device)
    return (b1 == b2).all()


# -- polynomials --------------------------------------------------------------

def polyval(p, x):
    p, x = pair(p, x)
    out = torch.zeros_like(x) + p[0] if p.numel() else torch.zeros_like(x)
    for i in builtins.range(1, p.numel()):
        out = out * x + p[i]
    return out


def polyadd(a1, a2):
    a, b = pair(a1, a2)
    n = max(a.numel(), b.numel())
    return F.pad(a, (n - a.numel(), 0)) + F.pad(b, (n - b.numel(), 0))


def polysub(a1, a2):
    a, b = pair(a1, a2)
    n = max(a.numel(), b.numel())
    return F.pad(a, (n - a.numel(), 0)) - F.pad(b, (n - b.numel(), 0))


def polymul(a1, a2):
    return _conv_full(*pair(a1, a2))


def polyder(p, m=1):
    p = as_t(p)
    for _ in builtins.range(m):
        n = p.numel() - 1
        if n <= 0:
            return p[:0]
        coef = torch.arange(n, 0, -1, device=p.device).to(p.dtype)
        p = p[:-1] * coef
    return p


def polyint(p, m=1, k=None):
    p = inexact(as_t(p))
    ks = [0.0] * m if k is None else (
        list(k) if isinstance(k, (list, tuple)) else [k] * m)
    for i in builtins.range(m):
        n = p.numel()
        coef = torch.arange(n, 0, -1, device=p.device).to(p.dtype)
        p = torch.cat([p / coef, torch.as_tensor(
            [ks[i]], dtype=p.dtype, device=p.device)])
    return p


def poly(seq_of_zeros):
    z = as_t(seq_of_zeros)
    if z.dim() == 2 and z.shape[0] == z.shape[1] and z.shape[0] > 0:
        z = torch.linalg.eigvals(inexact(z))
    z = z.reshape(-1)
    work = z if z.dtype.is_complex else inexact(z)
    out = torch.ones(1, dtype=work.dtype, device=z.device)
    for i in builtins.range(work.numel()):
        nxt = torch.cat([out, torch.zeros(1, dtype=out.dtype,
                                          device=z.device)])
        nxt[1:] = nxt[1:] - work[i] * out
        out = nxt
    if out.dtype.is_complex and bool((out.imag == 0).all()):
        out = out.real
    return out


def roots(p):
    p = inexact(as_t(p)).reshape(-1)
    nz = torch.nonzero(p, as_tuple=True)[0]
    if nz.numel() == 0:
        return torch.zeros(0, dtype=torch.complex64 if p.dtype ==
                           torch.float32 else torch.complex128,
                           device=p.device)
    trailing = p.numel() - 1 - int(nz[-1])
    p = p[int(nz[0]):int(nz[-1]) + 1]
    n = p.numel() - 1
    cdt = torch.complex64 if p.dtype == torch.float32 else torch.complex128
    if n < 1:
        r = torch.zeros(0, dtype=cdt, device=p.device)
    else:
        comp = torch.diag(torch.ones(n - 1, dtype=p.dtype,
                                     device=p.device), -1)
        comp[0, :] = -p[1:] / p[0]
        r = torch.linalg.eigvals(comp).to(cdt)
    if trailing:
        r = torch.cat([r, torch.zeros(trailing, dtype=cdt,
                                      device=p.device)])
    return r


def polyfit(x, y, deg, rcond=None, full=False, w=None, cov=False):
    x, y = pair(inexact(as_t(x)), inexact(as_t(y)))
    v = vander(x, deg + 1)
    if w is not None:
        wt = as_t(w, x).to(x.dtype)
        v = v * wt[:, None]
        y = y * (wt if y.dim() == 1 else wt[:, None])
    scale = torch.sqrt((v * v).sum(0))
    q, r = torch.linalg.qr(v / scale)
    rhs = q.T @ (y if y.dim() == 2 else y[:, None])
    c = torch.linalg.solve_triangular(r, rhs, upper=True)
    c = c / scale[:, None]
    return c[:, 0] if y.dim() == 1 else c


# -- windows (symmetric, as numpy's) ------------------------------------------

def _window(M, fn, dtype, device):
    dt = dtype or float_default()
    if M < 1:
        return torch.zeros(0, dtype=dt, device=device)
    if M == 1:
        return torch.ones(1, dtype=dt, device=device)
    n = torch.arange(M, dtype=torch.float64, device=device)
    return fn(n, M).to(dt)


def hamming(M, dtype=None, device=None):
    return _window(M, lambda n, M: 0.54 - 0.46 * torch.cos(
        2 * math.pi * n / (M - 1)), dtype, device)


def hanning(M, dtype=None, device=None):
    return _window(M, lambda n, M: 0.5 - 0.5 * torch.cos(
        2 * math.pi * n / (M - 1)), dtype, device)


def blackman(M, dtype=None, device=None):
    return _window(M, lambda n, M: 0.42 - 0.5 * torch.cos(
        2 * math.pi * n / (M - 1)) + 0.08 * torch.cos(
        4 * math.pi * n / (M - 1)), dtype, device)


def bartlett(M, dtype=None, device=None):
    return _window(M, lambda n, M: 1 - torch.abs(
        2 * n / (M - 1) - 1), dtype, device)


def kaiser(M, beta, dtype=None, device=None):
    def f(n, M):
        alpha = (M - 1) / 2.0
        r = (n - alpha) / alpha
        b = torch.tensor(float(beta), dtype=torch.float64, device=n.device)
        return torch.special.i0(b * torch.sqrt(
            torch.clamp(1 - r * r, min=0))) / torch.special.i0(b)
    return _window(M, f, dtype, device)


# -- the rest -----------------------------------------------------------------

def unwrap(p, discont=None, axis=-1, period=2 * math.pi):
    p = inexact(p)
    dd = torch.diff(p, dim=axis)
    half = period / 2
    discont = half if discont is None else max(discont, half)
    ddmod = torch.remainder(dd + half, period) - half
    ddmod = torch.where((ddmod == -half) & (dd > 0),
                        torch.full_like(ddmod, half), ddmod)
    corr = torch.where(dd.abs() < discont, torch.zeros_like(dd),
                       ddmod - dd)
    csum = torch.cumsum(corr, dim=axis)
    first = p.narrow(axis, 0, 1)
    rest = p.narrow(axis, 1, p.shape[axis] - 1) + csum
    return torch.cat([first, rest], dim=axis)


def apply_along_axis(func1d, axis, arr, *args, **kwargs):
    moved = torch.movedim(arr, axis, -1)
    rows = moved.reshape(-1, moved.shape[-1])
    outs = [as_t(func1d(r, *args, **kwargs), arr) for r in rows]
    out = torch.stack(outs, 0)
    out = out.reshape(moved.shape[:-1] + out.shape[1:])
    if out.dim() > moved.dim() - 1:
        nd = out.dim() - (moved.dim() - 1)
        ax0 = axis % arr.dim()
        for i in builtins.range(nd):
            out = torch.movedim(out, moved.dim() - 1 + i, ax0 + i)
    return out


def apply_over_axes(func, a, axes):
    out = a
    for d in (axes if isinstance(axes, (list, tuple)) else [axes]):
        res = as_t(func(out, d), out)
        if res.dim() == out.dim() - 1:
            res = res.unsqueeze(d)
        out = res
    return out


def fromfunction(function, shape, dtype=None, device=None, **kwargs):
    dt = dtype or float_default()
    grids = torch.meshgrid(*[torch.arange(s, device=device, dtype=dt)
                             for s in shape], indexing="ij")
    return as_t(function(*grids, **kwargs), device=device)


def geomspace(start, stop, num=50, endpoint=True, dtype=None, axis=0,
              device=None):
    dt = dtype or float_default()
    ls = torch.linspace(math.log10(start), math.log10(stop),
                        num if endpoint else num + 1, dtype=torch.float64,
                        device=device)
    if not endpoint:
        ls = ls[:-1]
    out = torch.pow(10.0, ls)
    if num:
        out[0] = start
        if endpoint:
            out[-1] = stop
    out = out.to(dt)
    return out if axis == 0 else torch.movedim(out, 0, axis)


def linspace(start, stop, num=50, endpoint=True, retstep=False, dtype=None,
             axis=0, device=None):
    s = as_t(start, device=device, dtype=torch.float64)
    e = as_t(stop, device=device, dtype=torch.float64)
    div = (num - 1) if endpoint else num
    step = (e - s) / div if div > 0 else torch.full_like(s, math.nan)
    i = torch.arange(num, dtype=torch.float64, device=device).reshape(
        (-1,) + (1,) * s.dim())
    out = s + i * step if div > 0 else s + i * 0
    if endpoint and num > 1:
        out[-1] = e
    out = out.to(dtype or float_default())
    if axis != 0:
        out = torch.movedim(out, 0, axis)
    return (out, step) if retstep else out


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             axis=0, device=None):
    ls = linspace(start, stop, num, endpoint, dtype=torch.float64,
                  axis=axis, device=device)
    return torch.pow(torch.as_tensor(base, dtype=torch.float64), ls).to(
        dtype or float_default())


def arange(start, stop=None, step=1, dtype=None, device=None):
    if stop is None:
        start, stop = 0, start
    if dtype is None:
        dtype = float_default() if builtins.any(
            isinstance(v, float) for v in (start, stop, step)) \
            else int_default()
    return torch.arange(start, stop, step, dtype=dtype, device=device)


def fill_diagonal(a, val=0.0, wrap=False):
    out = a.clone()
    n = min(a.shape[-2], a.shape[-1]) if a.dim() >= 2 else a.shape[0]
    i = torch.arange(n, device=a.device)
    if a.dim() >= 2:
        out[..., i, i] = torch.as_tensor(val, dtype=a.dtype,
                                         device=a.device)
    else:
        out[i] = torch.as_tensor(val, dtype=a.dtype, device=a.device)
    return out


OTHER = {name: fn for name, fn in globals().items()
         if callable(fn) and not name.startswith("_")
         and getattr(fn, "__module__", None) == __name__
         and name not in ("float_default", "int_default", "as_t", "pair",
                          "inexact", "ax", "canon", "canon_dtype",
                          "canon_out")}


__all__ = sorted(set(OTHER) | set(UNARY) | set(BINARY))
