"""The ``mx.np`` / ``_npi_`` / ``_linalg_`` parity sweep: one table of
cases, each a call on a package (``mxnet_tpu_torch`` or the JAX
reference, whichever ``M`` is) and the numpy inputs it takes.

``tests/test_torch_numpy.py`` and ``tests/test_torch_npi.py`` run every
case through both packages on the CPU and compare values and dtypes;
``chip_smoke.py``'s phase ``numpy`` runs every case on CUDA tensors
against the same call on CPU tensors.  This module imports numpy only.

A case is ``Case(family, id, call, args, cmp, rtol, atol)``: ``call(M,
*arrays)`` where numpy arrays in ``args`` arrive as ``M.np.array`` s
(``array_kind="nd"``: ``M.nd.array``).  ``cmp`` says how outputs are
held:

* ``"close"``: values (allclose at rtol / atol) and dtypes;
* ``"sorted"``: the flattened values sorted, and dtypes (orders that
  numpy leaves open: ``partition``, ``roots``, ``eigvals``);
* ``"recon"``: ``post(outputs)`` — a reconstruction or a quantity that
  does not depend on the sign / order gauge of a factorization — and
  dtypes of the raw outputs;
* ``"stats"``: ``post(outputs)`` — moments of a sample — at ``atol``,
  no dtype (the samplers are held by distribution, never stream
  against stream).
"""
from __future__ import annotations

import zlib
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as onp


class Case(NamedTuple):
    family: str
    id: str
    call: Callable
    args: Tuple
    cmp: str = "close"
    rtol: float = 1e-5
    atol: float = 1e-6
    post: Optional[Callable] = None
    array_kind: str = "np"


_r = onp.random.RandomState(0)
A = _r.randn(4, 5).astype("float32")
B = _r.randn(4, 5).astype("float32")
V = _r.randn(7).astype("float32")
P = _r.uniform(0.1, 0.9, (3, 4)).astype("float32")
Q = _r.uniform(0.5, 2.0, (3, 4)).astype("float32")
I = _r.randint(1, 9, (3, 4)).astype("int32")
J = _r.randint(1, 5, (3, 4)).astype("int32")
BOOL = A > 0
BOOL2 = B > 0
_m = _r.randn(4, 4)
SPD = (_m @ _m.T + 4 * onp.eye(4)).astype("float32")
SQ = (_r.randn(4, 4) + 4 * onp.eye(4)).astype("float32")
TALL = (_r.randn(6, 3)).astype("float32")
VS = onp.sort(V)
NANS = onp.array([1.0, onp.nan, -2.0, onp.inf, 3.0, -onp.inf],
                 dtype="float32")
NANA = onp.where(_r.rand(4, 5) < 0.2, onp.nan, A).astype("float32")
T3 = _r.randn(2, 3, 4).astype("float32")
IV = onp.array([0, 1, 1, 3, 2, 1], dtype="int32")

CASES = []


def _add(family, id_, call, args, **kw):
    CASES.append(Case(family, id_, call, tuple(args), **kw))


def _np(name, *args, **kw):
    """A case calling ``M.np.<name>(*arrays, **fkw)``."""
    fkw = kw.pop("fkw", {})
    id_ = kw.pop("id", name)
    family = kw.pop("family", "np")
    _add(family, id_, lambda M, *a, _n=name, _k=fkw: getattr(M.np, _n)(
        *a, **_k), args, **kw)


# -- elementwise --------------------------------------------------------------

_UNARY_DOMAIN = {"arccosh": Q + 1.0, "invert": I, "logical_not": BOOL,
                 "nan_to_num": NANS, "isnan": NANS, "isinf": NANS,
                 "isfinite": NANS, "isposinf": NANS, "isneginf": NANS,
                 "signbit": A, "sign": A, "rint": A * 3, "ceil": A * 3,
                 "floor": A * 3, "trunc": A * 3, "negative": A,
                 "positive": A, "absolute": A, "fabs": A, "cbrt": A,
                 "square": A, "reciprocal": Q, "sinc": A, "degrees": A,
                 "radians": A, "deg2rad": A, "rad2deg": A, "real": A,
                 "imag": A, "angle": A, "conj": A, "conjugate": A,
                 "exp": A, "expm1": A, "exp2": A, "sin": A, "cos": A,
                 "tan": P, "arctan": A, "sinh": A, "cosh": A, "tanh": A,
                 "arcsinh": A, "i0": A}
UNARY = [
    "negative", "positive", "absolute", "fabs", "sign", "rint", "ceil",
    "floor", "trunc", "sqrt", "cbrt", "square", "reciprocal", "exp",
    "expm1", "exp2", "log", "log2", "log10", "log1p", "sin", "cos", "tan",
    "arcsin", "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh",
    "arccosh", "arctanh", "degrees", "radians", "deg2rad", "rad2deg",
    "invert", "logical_not", "isnan", "isinf", "isfinite", "isposinf",
    "isneginf", "sinc", "signbit", "i0", "nan_to_num", "real", "imag",
    "angle", "conj", "conjugate", "abs", "fix", "round_", "around",
]
for _name in UNARY:
    _np(_name, _UNARY_DOMAIN.get(_name, P), family="np_unary",
        rtol=1e-5 if _name not in ("i0", "sinc") else 1e-4, atol=1e-6)
for _name in ("sqrt", "absolute", "sign", "square", "exp", "negative",
              "cbrt", "log1p"):
    _np(_name, I, id=f"{_name}[int32]", family="np_unary", rtol=1e-5)

_BIN_DOMAIN = {
    "gcd": (I, J), "lcm": (I, J), "bitwise_and": (I, J),
    "bitwise_or": (I, J), "bitwise_xor": (I, J), "left_shift": (I, J),
    "right_shift": (I * 16, J), "logical_and": (BOOL, BOOL2),
    "logical_or": (BOOL, BOOL2), "logical_xor": (BOOL, BOOL2),
    "equal": (A, B), "not_equal": (A, B), "greater": (A, B),
    "greater_equal": (A, B), "less": (A, B), "less_equal": (A, B),
    "heaviside": (A, B), "copysign": (P, A[:3, :4]),
    "nextafter": (P, Q), "ldexp": (P, J),
}
BINARY = [
    "add", "subtract", "multiply", "divide", "true_divide", "floor_divide",
    "mod", "remainder", "fmod", "power", "float_power", "maximum", "minimum",
    "fmax", "fmin", "hypot", "arctan2", "logaddexp", "logaddexp2",
    "copysign", "nextafter", "ldexp", "heaviside", "bitwise_and",
    "bitwise_or", "bitwise_xor", "left_shift", "right_shift", "gcd", "lcm",
    "equal", "not_equal", "greater", "greater_equal", "less", "less_equal",
    "logical_and", "logical_or", "logical_xor",
]
for _name in BINARY:
    _np(_name, *_BIN_DOMAIN.get(_name, (P, Q)), family="np_binary",
        rtol=1e-5)
for _name in ("add", "subtract", "multiply", "true_divide", "floor_divide",
              "mod", "maximum", "power"):
    _np(_name, I, J, id=f"{_name}[int32]", family="np_binary")
_np("add", P, Q[:1], id="add[broadcast]", family="np_binary")
_add("np_binary", "add[scalar]", lambda M, a: M.np.add(a, 1.5), (P,))
_add("np_binary", "add[int,scalar]", lambda M, a: M.np.add(a, 2), (I,))
_add("np_binary", "multiply[int,float]", lambda M, a: M.np.multiply(a, 0.5),
     (I,))
_add("np_binary", "true_divide[int,scalar]",
     lambda M, a: M.np.true_divide(a, 2), (I,))
_add("np_binary", "power[scalar]", lambda M, a: M.np.power(a, 2.0), (P,))
_add("np_binary", "rsub[scalar]", lambda M, a: M.np.subtract(1.0, a), (P,))

# -- reductions and statistics ------------------------------------------------

for _name in ("sum", "prod", "mean", "std", "var", "min", "max", "amin",
              "amax", "ptp", "median", "average", "argmax", "argmin",
              "cumsum", "cumprod", "any", "all", "count_nonzero"):
    _np(_name, A if _name not in ("prod", "cumprod") else P,
        family="np_reduce", rtol=1e-5, atol=1e-5)
    _np(_name, A if _name not in ("prod", "cumprod") else P,
        fkw={"axis": 1}, id=f"{_name}[axis=1]", family="np_reduce",
        rtol=1e-5, atol=1e-5)
for _name in ("sum", "mean", "max", "argmax", "cumsum", "prod"):
    _np(_name, I, id=f"{_name}[int32]", family="np_reduce")
for _name in ("sum", "mean", "std", "var", "max", "min"):
    _np(_name, T3, fkw={"axis": (0, 2), "keepdims": True},
        id=f"{_name}[axes,keepdims]", family="np_reduce", rtol=1e-5,
        atol=1e-5)
_np("std", A, fkw={"ddof": 1}, id="std[ddof]", family="np_reduce")
_np("var", A, fkw={"axis": 0, "ddof": 1}, id="var[ddof]",
    family="np_reduce")
W5 = (onp.abs(B[0]) + 0.5).astype("float32")
_add("np_reduce", "average[weights]",
     lambda M, a: M.np.average(a, weights=onp.abs(B) + 0.5), (A,),
     rtol=1e-4, atol=1e-5)
_add("np_reduce", "average[w,axis]",
     lambda M, a: M.np.average(a, axis=1, weights=W5), (A,), rtol=1e-5,
     atol=1e-6)
for _name in ("nansum", "nanprod", "nanmean", "nanstd", "nanvar", "nanmin",
              "nanmax", "nanmedian", "nanargmax", "nanargmin", "nancumsum",
              "nancumprod"):
    _np(_name, NANA, family="np_nan", rtol=1e-5, atol=1e-5)
    _np(_name, NANA, fkw={"axis": 1}, id=f"{_name}[axis=1]",
        family="np_nan", rtol=1e-5, atol=1e-5)
for _q, _meth in ((30.0, "linear"), (50.0, "lower"), (75.0, "higher"),
                  (40.0, "nearest"), (60.0, "midpoint")):
    _np("percentile", A, _q, fkw={"method": _meth},
        id=f"percentile[{_meth}]", family="np_order")
    _np("quantile", A, _q / 100, fkw={"method": _meth, "axis": 1},
        id=f"quantile[{_meth},axis=1]", family="np_order")
_add("np_order", "percentile[q array]", lambda M, a, q: M.np.percentile(
    a, q, axis=0), (A, onp.array([10.0, 90.0], "float32")))
_np("nanpercentile", NANA, 40.0, family="np_nan")
_np("nanquantile", NANA, 0.4, fkw={"axis": 0}, family="np_nan")
_np("median", A, fkw={"axis": 0, "keepdims": True}, id="median[keepdims]",
    family="np_order")
for _name in ("sort", "argsort"):
    _np(_name, A, family="np_order")
    _np(_name, A, fkw={"axis": 0}, id=f"{_name}[axis=0]", family="np_order")
    _np(_name, onp.array([3, 1, 2, 1, 3, 1], "float32"),
        id=f"{_name}[ties]", family="np_order")
_add("np_order", "partition", lambda M, a: M.np.partition(a, 3)[..., 3],
     (A,))
_add("np_order", "argpartition",
     lambda M, a: M.np.take_along_axis(a, M.np.argpartition(a, 2), 1)[:, 2],
     (A,))
_np("searchsorted", VS, onp.array([-0.5, 0.0, 0.7], "float32"),
    family="np_order")
_np("searchsorted", VS, VS[2:4], fkw={"side": "right"},
    id="searchsorted[right]", family="np_order")
_np("digitize", V, onp.array([-1.0, 0.0, 1.0], "float32"),
    family="np_order")
_np("digitize", V, onp.array([-1.0, 0.0, 1.0], "float32"),
    fkw={"right": True}, id="digitize[right]", family="np_order")

# -- data-dependent shapes (eager) --------------------------------------------

_np("nonzero", BOOL, family="np_eager")
_np("flatnonzero", A > 0.5, family="np_eager")
_np("argwhere", A > 0.5, family="np_eager")
_np("where", A > 0.5, family="np_eager", id="where[1-arg]")
_np("extract", A > 0, A, family="np_eager")
_np("compress", onp.array([True, False, True, True]), A,
    fkw={"axis": 0}, family="np_eager")
_np("unique", onp.array([3, 1, 2, 3, 1, 5], "int32"), family="np_eager")
_np("unique", onp.array([3.0, 1.0, 2.0, 3.0, 1.0], "float32"),
    fkw={"return_index": True, "return_inverse": True,
         "return_counts": True}, id="unique[all]", family="np_eager")
_np("bincount", IV, family="np_eager")
_np("bincount", IV, onp.array([0.5, 1, 1, 2, 1, 1], "float32"),
    id="bincount[weights]", family="np_eager")
for _name in ("union1d", "intersect1d", "setdiff1d", "setxor1d"):
    _np(_name, onp.array([1, 2, 3, 5], "int32"),
        onp.array([2, 5, 7], "int32"), family="np_eager")
_np("isin", I, onp.array([2, 5, 7], "int32"), family="np_eager")
_np("in1d", onp.array([1.0, 5.0], "float32"),
    onp.array([1.0, 2.0], "float32"), family="np_eager")
_np("histogram", A, family="np_eager", rtol=1e-5, atol=1e-5)
_np("histogram", A, fkw={"bins": 4, "range": (-1.0, 1.0)},
    id="histogram[range]", family="np_eager", rtol=1e-5, atol=1e-5)
_np("histogram", A, fkw={"bins": 5, "density": True},
    id="histogram[density]", family="np_eager", rtol=1e-4, atol=1e-5)
_np("histogram2d", A[0], B[0], fkw={"bins": 3}, family="np_eager",
    rtol=1e-5, atol=1e-5)
_np("histogramdd", A[:, :2], fkw={"bins": 2}, family="np_eager",
    rtol=1e-5, atol=1e-5)

# -- products and linear algebra of the namespace -----------------------------

_np("dot", A, B.T, family="np_product", rtol=1e-5, atol=1e-5)
_np("dot", V, V, id="dot[1d]", family="np_product", rtol=1e-5, atol=1e-5)
_np("dot", T3, A[:4, :4][0], id="dot[nd,1d]", family="np_product",
    rtol=1e-5, atol=1e-5)
_np("vdot", A, B, family="np_product", rtol=1e-5, atol=1e-5)
_np("inner", A, B, family="np_product", rtol=1e-5, atol=1e-5)
_np("outer", V, V[:3], family="np_product", rtol=1e-5, atol=1e-5)
_np("matmul", A, B.T, family="np_product", rtol=1e-5, atol=1e-5)
_np("tensordot", T3, A[:3, :4], fkw={"axes": 2}, family="np_product",
    rtol=1e-5, atol=1e-5)
_np("tensordot", T3, T3, fkw={"axes": ([0, 1], [0, 1])},
    id="tensordot[axes pair]", family="np_product", rtol=1e-5, atol=1e-5)
_np("kron", A[:2, :2], B[:2, :3], family="np_product", rtol=1e-5)
_np("cross", A[:, :3], B[:, :3], family="np_product", rtol=1e-5,
    atol=1e-5)
_add("np_product", "einsum", lambda M, a, b: M.np.einsum("ij,ij->i", a, b),
     (A, B), rtol=1e-5, atol=1e-5)
_add("np_product", "einsum[matmul]",
     lambda M, a, b: M.np.einsum("ij,kj->ik", a, b), (A, B), rtol=1e-5,
     atol=1e-5)
_add("np_product", "einsum[ellipsis]",
     lambda M, a: M.np.einsum("...ij->...ji", a), (T3,))
_np("trace", A, family="np_product")
_np("trace", T3, fkw={"axis1": 1, "axis2": 2}, id="trace[axes]",
    family="np_product")
_np("diagonal", A, family="np_product")
_np("diagonal", A, fkw={"offset": 1}, id="diagonal[offset]",
    family="np_product")
_np("diag", V, family="np_product")
_np("diag", A, fkw={"k": -1}, id="diag[2d,k]", family="np_product")
_np("diagflat", A[:2, :2], family="np_product")
_np("tril", A, family="np_product")
_np("triu", A, fkw={"k": 1}, family="np_product")
_np("vander", V[:4], family="np_product", rtol=1e-5, atol=1e-6)
_np("vander", V[:4], fkw={"N": 3, "increasing": True},
    id="vander[increasing]", family="np_product", rtol=1e-5)
_np("cov", A, family="np_product", rtol=1e-5, atol=1e-6)
_np("cov", A, fkw={"rowvar": False, "bias": True}, id="cov[cols,bias]",
    family="np_product", rtol=1e-5, atol=1e-6)
_np("corrcoef", A, family="np_product", rtol=1e-5, atol=1e-6)
_np("convolve", V, V[:3], family="np_product", rtol=1e-5, atol=1e-6)
_np("convolve", V, V[:3], fkw={"mode": "same"}, id="convolve[same]",
    family="np_product", rtol=1e-5, atol=1e-6)
_np("convolve", V, V[:3], fkw={"mode": "valid"}, id="convolve[valid]",
    family="np_product", rtol=1e-5, atol=1e-6)
_np("correlate", V, V[:3], family="np_product", rtol=1e-5, atol=1e-6)
_np("correlate", V, V[:3], fkw={"mode": "full"}, id="correlate[full]",
    family="np_product", rtol=1e-5, atol=1e-6)

# -- shapes -------------------------------------------------------------------

for _name, _args, _fkw in (
        ("reshape", (A, (2, 10)), {}), ("ravel", (A,), {}),
        ("transpose", (T3,), {}), ("transpose", (T3, (1, 0, 2)), {}),
        ("swapaxes", (T3, 0, 2), {}), ("moveaxis", (T3, 0, -1), {}),
        ("rollaxis", (T3, 2), {}), ("expand_dims", (A, 0), {}),
        ("expand_dims", (A, (0, 3)), {}), ("squeeze", (A[:, None],), {}),
        ("squeeze", (A[:, None], 1), {}), ("broadcast_to", (V, (3, 7)), {}),
        ("atleast_1d", (A[0, 0],), {}), ("atleast_2d", (V,), {}),
        ("atleast_3d", (A,), {}), ("tile", (A, 2), {}),
        ("tile", (A, (2, 1)), {}), ("repeat", (A, 2), {}),
        ("repeat", (A, 2), {"axis": 1}), ("flip", (A,), {}),
        ("flip", (A, 1), {}), ("fliplr", (A,), {}), ("flipud", (A,), {}),
        ("roll", (A, 1), {}), ("roll", (A, -2), {"axis": 1}),
        ("rot90", (A,), {}), ("rot90", (A, 2), {}),
        ("append", (A, B), {}), ("append", (A, B), {"axis": 0}),
        ("pad", (V, 2), {}), ("pad", (A, ((1, 2), (0, 1))), {}),
        ("pad", (A, 2), {"mode": "edge"}),
        ("pad", (A, 2), {"mode": "reflect"}),
        ("pad", (A, 2), {"mode": "symmetric"}),
        ("pad", (A, 2), {"mode": "wrap"}),
        ("pad", (A, 1), {"constant_values": 3.0}),
        ("insert", (V, 2, 9.0), {}), ("insert", (A, 1, 5.0), {"axis": 1}),
        ("delete", (V, 2), {}),
        ("delete", (A, onp.array([0, 2], "int32"), 1), {}),
        ("array_split", (V, 3), {}), ("split", (A, 2), {}),
        ("split", (A, [1, 3], 1), {}), ("hsplit", (A[:, :4], 2), {}),
        ("vsplit", (A, 2), {}), ("dsplit", (T3[..., :4], 2), {}),
        ("diff", (V,), {}), ("diff", (A,), {"n": 2, "axis": 0}),
        ("ediff1d", (V,), {}), ("ediff1d", (V,), {"to_end": 1.0}),
        ("take", (A, onp.array([0, 2, -1], "int32")), {}),
        ("take", (A, onp.array([[0, 2], [1, 1]], "int32")), {"axis": 1}),
        ("take_along_axis", (A, onp.argsort(A, axis=1).astype("int32"), 1),
         {}),
        ("clip", (A, -0.5, 0.5), {}), ("clip", (I, 2, 6), {}),
        ("around", (A * 10, 1), {}), ("round", (A * 10,), {}),
):
    _np(_name, *_args, fkw=_fkw,
        id=f"{_name}{list(_fkw)}[{len(_args)}]", family="np_shape")
for _name in ("concatenate", "stack", "vstack", "hstack", "dstack",
              "column_stack"):
    _add("np_shape", _name, lambda M, a, b, _n=_name: getattr(M.np, _n)(
        [a, b]), (A, B))
_add("np_shape", "concatenate[axis=None]",
     lambda M, a, b: M.np.concatenate([a, b], axis=None), (A, B))
_add("np_shape", "stack[axis=1]", lambda M, a, b: M.np.stack([a, b], 1),
     (A, B))
_add("np_shape", "broadcast_arrays",
     lambda M, a, b: M.np.broadcast_arrays(a, b), (V, A[:2, :1]))
_add("np_shape", "put_along_axis", lambda M, a, i, v: M.np.put_along_axis(
    a, i, v, 1, inplace=False), (A, onp.array([[0], [1], [2], [3]], "int32"),
                  onp.full((4, 1), 9.0, "float32")))
_add("np_shape", "choose", lambda M, c, a, b: M.np.choose(c, [a, b]),
     ((A > 0).astype("int32"), A, B))
_add("np_shape", "select", lambda M, a: M.np.select([a > 0, a <= 0],
                                                    [a, -a]), (V,))
_add("np_shape", "where", lambda M, c, a, b: M.np.where(c, a, b),
     (A > 0, A, B))
_add("np_shape", "where[scalar]", lambda M, c, a: M.np.where(c, a, 0.0),
     (A > 0, A))
_add("np_shape", "piecewise", lambda M, x: M.np.piecewise(
    x, [x < 0, x >= 0], [lambda v: -v, lambda v: v * 2]), (V,))
_add("np_shape", "apply_along_axis", lambda M, a: M.np.apply_along_axis(
    lambda r: r * 2 + 1, 1, a), (A,))
_add("np_shape", "apply_over_axes", lambda M, a: M.np.apply_over_axes(
    lambda x, ax: x.sum(ax), a, [0, 2]), (T3,), rtol=1e-5, atol=1e-5)

# -- numerics -----------------------------------------------------------------

_np("interp", onp.array([0.5, 1.5, -1.0, 9.0], "float32"),
    onp.arange(4.0).astype("float32"),
    (onp.arange(4.0) * 2).astype("float32"), family="np_numeric")
_np("interp", onp.array([0.5, 1.5, -1.0, 9.0], "float32"),
    onp.arange(4.0).astype("float32"),
    (onp.arange(4.0) * 2).astype("float32"),
    fkw={"left": -5.0, "right": 5.0}, id="interp[left,right]",
    family="np_numeric")
_np("gradient", V, family="np_numeric", rtol=1e-5, atol=1e-6)
_np("gradient", A, family="np_numeric", id="gradient[2d]", rtol=1e-5,
    atol=1e-6)
_np("gradient", V, 2.0, family="np_numeric", id="gradient[dx]",
    rtol=1e-5, atol=1e-6)
_np("trapezoid", V, family="np_numeric", rtol=1e-5, atol=1e-6)
_np("trapz", A, fkw={"dx": 0.5, "axis": 0}, family="np_numeric",
    rtol=1e-5, atol=1e-6)
_np("unwrap", onp.array([0.0, 3.0, 6.0, 9.0, 2.0], "float32"),
    family="np_numeric", rtol=1e-5, atol=1e-5)
_np("isclose", A, A + 1e-8, family="np_numeric")
_np("allclose", A, A + 1e-3, family="np_numeric")
_np("array_equal", A, A, family="np_numeric")
_np("array_equal", A, B, id="array_equal[ne]", family="np_numeric")
_np("array_equiv", V, onp.tile(V, (2, 1)), family="np_numeric")
_np("polyval", onp.array([1.0, -2.0, 1.0], "float32"), V,
    family="np_poly", rtol=1e-5, atol=1e-5)
_np("polyadd", V[:3], V[:5], family="np_poly")
_np("polysub", V[:3], V[:5], family="np_poly")
_np("polymul", V[:3], V[:4], family="np_poly", rtol=1e-5, atol=1e-6)
_np("polyder", V[:5], family="np_poly", rtol=1e-5)
_np("polyder", V[:5], 2, id="polyder[m=2]", family="np_poly", rtol=1e-5)
_np("polyint", V[:4], family="np_poly", rtol=1e-5)
_np("poly", onp.array([1.0, 2.0, -3.0], "float32"), family="np_poly",
    rtol=1e-5)
_np("roots", onp.array([1.0, -3.0, 2.0], "float32"), family="np_poly",
    cmp="sorted", rtol=1e-4, atol=1e-4)
_np("polyfit", onp.arange(6.0).astype("float32"),
    (onp.arange(6.0) ** 2 * 0.5 - 1).astype("float32"), 2,
    family="np_poly", rtol=1e-3, atol=1e-3)

# -- creation and grids -------------------------------------------------------

for _name, _args, _fkw in (
        ("arange", (5,), {}), ("arange", (1.0, 3.0, 0.5), {}),
        ("arange", (2, 9, 3), {"dtype": "float32"}),
        ("linspace", (0.0, 1.0, 7), {}),
        ("linspace", (0.0, 1.0, 5), {"endpoint": False}),
        ("logspace", (0.0, 2.0, 5), {}), ("geomspace", (1.0, 8.0, 4), {}),
        ("zeros", ((2, 3),), {}), ("ones", ((2, 3),), {"dtype": "int32"}),
        ("full", ((2, 2), 7.0), {}), ("full", ((2, 2), 3), {}),
        ("empty", ((2, 2),), {}), ("eye", (3,), {}),
        ("eye", (3, 4), {"k": 1}), ("identity", (3,), {}),
        ("tri", (4,), {"k": -1}), ("indices", ((2, 3),), {}),
        ("hanning", (8,), {}), ("hamming", (8,), {}),
        ("blackman", (8,), {}), ("bartlett", (7,), {}),
        ("kaiser", (8, 5.0), {}),
        ("triu_indices", (4,), {}), ("tril_indices", (4, -1), {}),
        ("unravel_index", (onp.array([3, 7], "int32"), (2, 4)), {}),
        ("ravel_multi_index", ((onp.array([1, 0], "int32"),
                                onp.array([3, 2], "int32")), (2, 4)), {}),
):
    _np(_name, *_args, fkw=_fkw, id=f"{_name}{list(_fkw)}[{_args!r}]",
        family="np_create", rtol=1e-5, atol=1e-6)
_add("np_create", "fromfunction", lambda M: M.np.fromfunction(
    lambda i, j: i + j, (2, 3)), ())
_add("np_create", "meshgrid", lambda M, a, b: M.np.meshgrid(a, b),
     (V[:3], V[:2]))
_add("np_create", "ix_", lambda M, a, b: M.np.ix_(a, b),
     (onp.array([0, 2], "int32"), onp.array([1, 3], "int32")))
for _name in ("zeros_like", "ones_like", "copy", "asarray"):
    _np(_name, A, family="np_create")
_np("full_like", A, 2.5, family="np_create")
_np("triu_indices_from", SQ, family="np_create")
_np("tril_indices_from", SQ, fkw={"k": 1}, family="np_create")
_np("real_if_close", A, family="np_create")

# -- np.linalg (cuSOLVER / cuBLAS on a card) ----------------------------------


def _la(name, *args, **kw):
    fkw = kw.pop("fkw", {})
    id_ = kw.pop("id", f"linalg.{name}")
    _add("np_linalg", id_, lambda M, *a, _n=name, _k=fkw: getattr(
        M.np.linalg, _n)(*a, **_k), args, **kw)


_la("norm", A, rtol=1e-5)
_la("norm", A, fkw={"axis": 1}, id="linalg.norm[axis]", rtol=1e-5)
_la("norm", A, fkw={"ord": "fro"}, id="linalg.norm[fro]", rtol=1e-5)
_la("norm", V, fkw={"ord": 1}, id="linalg.norm[ord1]", rtol=1e-5)
_la("inv", SQ, rtol=1e-4, atol=1e-5)
_la("pinv", TALL, rtol=1e-3, atol=1e-4)
_la("det", SQ, rtol=1e-4)
_la("slogdet", SQ, rtol=1e-4, atol=1e-5)
_la("solve", SQ, A[:, :2], rtol=1e-4, atol=1e-5)
_la("solve", SQ, V[:4], id="linalg.solve[vec]", rtol=1e-4, atol=1e-5)
_la("cholesky", SPD, rtol=1e-4, atol=1e-5)
_la("matrix_rank", TALL)
_la("matrix_power", SQ, 3, rtol=1e-4, atol=1e-3)
_la("cond", SQ, rtol=1e-3)
_la("tensorinv", SQ.reshape(4, 2, 2), fkw={"ind": 1}, rtol=1e-4, atol=1e-5)
_la("tensorsolve", SQ, V[:4], rtol=1e-4, atol=1e-5)
_la("eigvalsh", SPD, rtol=1e-4, atol=1e-4)
_la("eigvals", SQ, cmp="sorted", rtol=1e-4, atol=1e-4)


def _svd_post(outs):
    u, s, vh = outs
    return [s, (u[:, :s.shape[0]] * s) @ vh[:s.shape[0]]]


def _qr_post(outs):
    q, r = outs
    return [q @ r, onp.abs(onp.diag(r))]


def _eigh_post(outs, a=SPD):
    w, v = outs
    return [w, (v * w) @ v.T]


def _eig_post(outs, a=SQ):
    w, v = outs
    return [onp.sort_complex(w), (a.astype(v.dtype) @ v) - v * w]


def _lstsq_post(outs):
    x, res, rank, sv = outs
    return [x, onp.asarray(rank), sv]


_la("svd", A, cmp="recon", post=_svd_post, rtol=1e-4, atol=1e-4)
_la("svd", A, fkw={"full_matrices": False}, id="linalg.svd[reduced]",
    cmp="recon", post=_svd_post, rtol=1e-4, atol=1e-4)
_la("qr", TALL, cmp="recon", post=_qr_post, rtol=1e-4, atol=1e-4)
_la("eigh", SPD, cmp="recon", post=_eigh_post, rtol=1e-4, atol=1e-3)
_la("eig", SQ, cmp="recon", post=_eig_post, rtol=1e-4, atol=1e-3)
_la("lstsq", TALL, V[:6], cmp="recon", post=_lstsq_post, rtol=1e-3,
    atol=1e-4)

# -- np.fft (cuFFT on a card) -------------------------------------------------

for _name, _args, _fkw in (
        ("fft", (V,), {}), ("ifft", (V,), {}), ("fft", (A,), {"axis": 0}),
        ("fft", (V,), {"n": 10}), ("fft2", (A,), {}), ("ifft2", (A,), {}),
        ("fftn", (T3,), {}), ("ifftn", (T3,), {}), ("rfft", (V,), {}),
        ("irfft", (V,), {}), ("hfft", (V[:4],), {}), ("ihfft", (V,), {}),
        ("fftshift", (A,), {}), ("ifftshift", (A,), {}),
        ("fftfreq", (8,), {}), ("rfftfreq", (7, 0.5), {})):
    _add("np_fft", f"fft.{_name}{list(_fkw)}",
         lambda M, *a, _n=_name, _k=_fkw: getattr(M.np.fft, _n)(*a, **_k),
         _args, rtol=1e-4, atol=1e-4)
_add("np_fft", "fft.ifft(fft)", lambda M, x: M.np.fft.ifft(M.np.fft.fft(x)),
     (V,), rtol=1e-5, atol=1e-5)

# -- the ndarray's own methods and operators ----------------------------------

for _id, _fn in (
        ("a+a", lambda M, a: a + a), ("a>0", lambda M, a: a > 0),
        ("a.sum()", lambda M, a: a.sum()), ("a.std()", lambda M, a: a.std()),
        ("a.var(1)", lambda M, a: a.var(axis=1)),
        ("a.ravel()", lambda M, a: a.ravel()),
        ("a.T", lambda M, a: a.T), ("a[1:3]", lambda M, a: a[1:3]),
        ("a.any()", lambda M, a: (a > 1).any()),
        ("a.all()", lambda M, a: (a > -5).all()),
        ("a.trace()", lambda M, a: a.trace()),
        ("a.diagonal()", lambda M, a: a.diagonal()),
        ("a.ptp()", lambda M, a: a.ptp()),
        ("a.round()", lambda M, a: (a * 10).round()),
        ("a.cumsum()", lambda M, a: a.cumsum()),
        ("a.conj()", lambda M, a: a.conj()),
        ("a.real", lambda M, a: a.real), ("a.imag", lambda M, a: a.imag),
        ("a*2.5", lambda M, a: a * 2.5), ("2-a", lambda M, a: 2 - a),
        ("a@b", lambda M, a: a @ a.T), ("-a", lambda M, a: -a),
        ("a.reshape", lambda M, a: a.reshape((5, 4))),
        ("a.astype", lambda M, a: a.astype("int32"))):
    _add("np_method", _id, _fn, (A,), rtol=1e-5, atol=1e-5)
for _id, _fn in (("i+1.5", lambda M, a: a + 1.5),
                 ("i/2", lambda M, a: a / 2),
                 ("i*2", lambda M, a: a * 2),
                 ("mean(i)", lambda M, a: M.np.mean(a))):
    _add("np_method", _id, _fn, (I,))

# -- np.random (by distribution) ----------------------------------------------

N_DRAWS = 20000


def _moments(outs):
    x = onp.asarray(outs[0], dtype="float64")
    return [onp.array([x.mean(), x.std()])]


def _rand(id_, call, atol, post=_moments):
    _add("np_random", id_, call, (), cmp="stats", atol=atol, post=post)


_N = (N_DRAWS,)
_rand("random.uniform", lambda M: M.np.random.uniform(2.0, 3.0, size=_N),
      0.02)
_rand("random.normal", lambda M: M.np.random.normal(1.0, 2.0, size=_N),
      0.06)
_rand("random.rand", lambda M: M.np.random.rand(N_DRAWS), 0.02)
_rand("random.randn", lambda M: M.np.random.randn(N_DRAWS), 0.04)
_rand("random.randint", lambda M: M.np.random.randint(0, 5, size=_N), 0.06)
_rand("random.gamma", lambda M: M.np.random.gamma(2.0, 1.5, size=_N), 0.1)
_rand("random.beta", lambda M: M.np.random.beta(2.0, 3.0, size=_N), 0.02)
_rand("random.exponential", lambda M: M.np.random.exponential(
    2.0, size=_N), 0.1)
_rand("random.poisson", lambda M: M.np.random.poisson(3.0, size=_N), 0.08)
_rand("random.logistic", lambda M: M.np.random.logistic(
    1.0, 0.5, size=_N), 0.05)
_rand("random.gumbel", lambda M: M.np.random.gumbel(0.0, 1.0, size=_N),
      0.06)
_rand("random.laplace", lambda M: M.np.random.laplace(0.0, 1.0, size=_N),
      0.06)
_rand("random.rayleigh", lambda M: M.np.random.rayleigh(1.0, size=_N),
      0.04)
_rand("random.pareto", lambda M: M.np.random.pareto(5.0, size=_N), 0.05)
_rand("random.power", lambda M: M.np.random.power(3.0, size=_N), 0.02)
_rand("random.weibull", lambda M: M.np.random.weibull(2.0, size=_N), 0.03)
_rand("random.chisquare", lambda M: M.np.random.chisquare(3.0, size=_N),
      0.15)
_rand("random.f", lambda M: M.np.random.f(5.0, 10.0, size=_N), 0.15)
_rand("random.lognormal", lambda M: M.np.random.lognormal(
    0.0, 0.5, size=_N), 0.05)
_rand("random.binomial", lambda M: M.np.random.binomial(10, 0.3, size=_N),
      0.08)
_rand("random.geometric", lambda M: M.np.random.geometric(0.4, size=_N),
      0.08)
_rand("random.t", lambda M: M.np.random.t(10.0, size=_N), 0.06)
_rand("random.negative_binomial", lambda M: M.np.random.negative_binomial(
    4, 0.5, size=_N), 0.25)
_rand("random.choice", lambda M: M.np.random.choice(5, size=_N), 0.06)
_rand("random.choice[p]", lambda M: M.np.random.choice(
    3, size=_N, p=M.np.array([0.2, 0.3, 0.5])), 0.06)
_rand("random.dirichlet", lambda M: M.np.random.dirichlet(
    M.np.array([1.0, 2.0, 3.0]), size=N_DRAWS // 4), 0.02,
    post=lambda outs: [onp.asarray(outs[0]).mean(0)])
_rand("random.multinomial", lambda M: M.np.random.multinomial(
    20, [0.2, 0.8], size=N_DRAWS // 4), 0.2,
    post=lambda outs: [onp.asarray(outs[0], "float64").mean(0)])
_rand("random.multivariate_normal", lambda M: M.np.random.multivariate_normal(
    M.np.array([1.0, -1.0]), M.np.array([[1.0, 0.5], [0.5, 2.0]]),
    size=N_DRAWS), 0.08, post=lambda outs: [
        onp.asarray(outs[0]).mean(0),
        onp.cov(onp.asarray(outs[0], "float64").T).ravel()])
_rand("random.permutation", lambda M: M.np.random.permutation(10), 1e-9,
      post=lambda outs: [onp.sort(onp.asarray(outs[0]))])


# -- running a case -----------------------------------------------------------


def host(out):
    """A case's outputs as a flat list of host numpy arrays."""
    if isinstance(out, (list, tuple)):
        res = []
        for o in out:
            res.extend(host(o))
        return res
    if hasattr(out, "asnumpy"):
        return [out.asnumpy()]
    return [onp.asarray(out)]


def seed_case(M, case):
    """A sampler case draws from a seed of its own: its moments repeat
    from run to run."""
    if case.cmp == "stats":
        M.random.seed(zlib.crc32(case.id.encode()) % (2 ** 31))


def run(M, case, array=None):
    """``case`` on package ``M``: its numpy inputs made arrays by
    ``array`` (default ``M.np.array`` / ``M.nd.array`` by the case's
    kind), the outputs read back to the host."""
    if array is None:
        array = M.np.array if case.array_kind == "np" else M.nd.array
    seed_case(M, case)
    args = [array(a) if isinstance(a, onp.ndarray) else a
            for a in case.args]
    return host(case.call(M, *args))


def compare(case, got, want):
    """Hold outputs ``got`` against ``want`` by the case's rule; raises
    AssertionError on a mismatch."""
    if case.cmp == "stats":
        g, w = case.post(got), case.post(want)
        for x, y in zip(g, w):
            onp.testing.assert_allclose(x, y, rtol=0, atol=case.atol,
                                        err_msg=case.id)
        return
    assert len(got) == len(want), (case.id, len(got), len(want))
    for x, y in zip(got, want):
        assert x.dtype == y.dtype, (case.id, x.dtype, y.dtype)
        assert x.shape == y.shape, (case.id, x.shape, y.shape)
    if case.cmp == "recon":
        got, want = case.post(got), case.post(want)
    elif case.cmp == "sorted":
        got = [onp.sort_complex(onp.ravel(x)) if x.dtype.kind == "c"
               else onp.sort(onp.ravel(x)) for x in got]
        want = [onp.sort_complex(onp.ravel(x)) if x.dtype.kind == "c"
                else onp.sort(onp.ravel(x)) for x in want]
    for x, y in zip(got, want):
        if x.dtype.kind in "biu" and y.dtype.kind in "biu":
            onp.testing.assert_array_equal(x, y, err_msg=case.id)
        else:
            onp.testing.assert_allclose(x, y, rtol=case.rtol,
                                        atol=case.atol, equal_nan=True,
                                        err_msg=case.id)


def check_against(ref, port, case):
    """``case`` through the reference package ``ref`` and, on the host,
    through ``port``; the outputs held by :func:`compare`."""
    want = run(ref, case)
    with port.cpu():
        got = run(port, case)
    compare(case, got, want)


def worst(case, got, want):
    """The largest absolute difference between two runs of ``case``
    (after its ``post``), for a report."""
    if case.cmp in ("stats", "recon"):
        got, want = case.post(got), case.post(want)
    m = 0.0
    for x, y in zip(got, want):
        x = onp.asarray(x)
        y = onp.asarray(y)
        if x.size and x.shape == y.shape:
            d = onp.abs(x.astype("complex128") - y.astype("complex128"))
            d = d[onp.isfinite(d)]
            if d.size:
                m = max(m, float(d.max()))
    return m


# -- the registered ops of the slice: ``_npi_*`` / ``_np_*`` / ``_npx_*``,
# ``_linalg_*`` / ``linalg_*``, ``_random_pdf_*``, the attention extras and
# the kernels' registered names ------------------------------------------

OP_NAMES = sorted("""
_linalg_det _linalg_extractdiag _linalg_extracttrian _linalg_gelqf
_linalg_gemm _linalg_gemm2 _linalg_inverse _linalg_makediag _linalg_maketrian
_linalg_potrf _linalg_potri _linalg_slogdet _linalg_sumlogdiag _linalg_syevd
_linalg_syrk _linalg_trmm _linalg_trsm _np_copy _np_dot _np_moveaxis
_np_reshape _npi_add _npi_add_scalar _npi_all _npi_any _npi_arange
_npi_arctan2_scalar _npi_argmax _npi_argmin _npi_around _npi_atleast_1d
_npi_atleast_2d _npi_atleast_3d _npi_average _npi_bernoulli _npi_bincount
_npi_bitwise_and _npi_bitwise_and_scalar _npi_bitwise_not _npi_bitwise_or
_npi_bitwise_or_scalar _npi_bitwise_xor _npi_bitwise_xor_scalar _npi_blackman
_npi_boolean_mask_assign_scalar _npi_boolean_mask_assign_tensor
_npi_broadcast_to _npi_choice _npi_cholesky _npi_column_stack _npi_concat
_npi_concatenate _npi_copysign _npi_copysign_scalar _npi_cross _npi_cumsum
_npi_deg2rad _npi_delete _npi_diag _npi_diag_indices_from _npi_diagflat
_npi_diagonal _npi_diff _npi_dirichlet _npi_dsplit _npi_dstack _npi_ediff1d
_npi_eig _npi_eigh _npi_eigvals _npi_eigvalsh _npi_einsum _npi_exponential
_npi_eye _npi_fill_diagonal _npi_flip _npi_fmax _npi_fmax_scalar _npi_fmin
_npi_fmin_scalar _npi_fmod _npi_fmod_scalar _npi_full _npi_full_like
_npi_gamma _npi_gumbel _npi_hamming _npi_hanning _npi_hsplit _npi_hstack
_npi_hypot _npi_identity _npi_indices _npi_insert_scalar _npi_insert_slice
_npi_insert_tensor _npi_interp _npi_isfinite _npi_isinf _npi_isnan
_npi_isneginf _npi_isposinf _npi_kron _npi_laplace _npi_lcm _npi_lcm_scalar
_npi_ldexp _npi_ldexp_scalar _npi_linspace _npi_log _npi_logical_not
_npi_logistic _npi_logspace _npi_lstsq _npi_matrix_rank
_npi_matrix_rank_none_tol _npi_max _npi_mean _npi_min _npi_mod
_npi_mod_scalar _npi_multinomial _npi_multiply _npi_multiply_scalar
_npi_nan_to_num _npi_norm _npi_normal _npi_normal_n _npi_ones _npi_pad
_npi_pareto _npi_percentile _npi_pinv _npi_pinv_scalar_rcond _npi_polyval
_npi_power _npi_power_scalar _npi_powerd _npi_prod _npi_qr _npi_rad2deg
_npi_rarctan2_scalar _npi_rayleigh _npi_rcopysign_scalar _npi_repeats
_npi_rfmod_scalar _npi_rldexp_scalar _npi_rmod_scalar _npi_roll
_npi_rollaxis _npi_rot90 _npi_rpower_scalar _npi_rsubtract_scalar
_npi_rtrue_divide_scalar _npi_share_memory _npi_solve _npi_squeeze
_npi_stack _npi_std _npi_subtract _npi_subtract_scalar _npi_sum _npi_svd
_npi_tensordot _npi_tensordot_int_axes _npi_tensorinv _npi_tensorsolve
_npi_trace _npi_transpose _npi_tri _npi_tril _npi_tril_indices _npi_triu
_npi_true_divide _npi_true_divide_scalar _npi_uniform _npi_uniform_n
_npi_unique _npi_var _npi_vstack _npi_weibull _npi_where _npi_where_lscalar
_npi_where_rscalar _npi_where_scalar2 _npi_zeros _npx_constraint_check
_npx_index_add _npx_index_update _npx_nonzero _npx_relu _npx_reshape
_npx_sigmoid _random_pdf_dirichlet _random_pdf_exponential _random_pdf_gamma
_random_pdf_generalized_negative_binomial _random_pdf_negative_binomial
_random_pdf_normal _random_pdf_poisson _random_pdf_uniform linalg_det
linalg_extractdiag linalg_extracttrian linalg_gelqf linalg_gemm linalg_gemm2
linalg_inverse linalg_makediag linalg_maketrian linalg_potrf linalg_potri
linalg_slogdet linalg_sumlogdiag linalg_syevd linalg_syrk linalg_trmm
linalg_trsm masked_softmax _npx_masked_softmax masked_log_softmax
_npx_masked_log_softmax _contrib_div_sqrt_dim div_sqrt_dim
_contrib_interleaved_matmul_selfatt_qk interleaved_matmul_selfatt_qk
_contrib_interleaved_matmul_selfatt_valatt interleaved_matmul_selfatt_valatt
_contrib_interleaved_matmul_encdec_qk interleaved_matmul_encdec_qk
_contrib_interleaved_matmul_encdec_valatt interleaved_matmul_encdec_valatt
rope _npx_rope paged_attention _npx_paged_attention
""".split())


def _is_reference(M):
    return M.__name__ == "mxnet_tpu"


def invoke(pkg, name, arrays, params):
    """``name`` through package ``pkg``'s funnel; the reference's
    samplers take their key as the first input."""
    arrays = list(arrays)
    if _is_reference(pkg) and name in SAMPLERS:
        arrays.insert(0, pkg.nd.NDArray(pkg.ops.random.next_key()))
    return pkg.ops.registry.invoke(name, arrays, **params)


def _op(id_, name, args, params=None, **kw):
    _add(kw.pop("family", "op"), id_,
         lambda M, *a, _n=name, _p=params or {}: invoke(M, _n, a, _p),
         args, array_kind="nd", **kw)


def _eigh_any(outs):
    w, v = outs
    return [w, (v * w) @ v.T]


SPEC_OPS = []      # (op name, spec) of the grad sweep's specs of the slice


def _from_specs():
    from grad_sweep_specs import SPECS
    for name in OP_NAMES:
        sp = SPECS.get(name)
        if sp is None:
            continue
        r = onp.random.RandomState(zlib.crc32(name.encode()) % (2 ** 31))
        arrays = tuple(b(r) for b in sp["arrays"] if b is not None)
        SPEC_OPS.append((name, sp, arrays))
        gauge = {"_npi_svd": _svd_post, "_npi_eigh": _eigh_any}.get(name)
        _op(name, name, arrays, sp["params"], family="op_spec",
            rtol=1e-5 if gauge is None else 1e-4,
            atol=1e-5 if gauge is None else 1e-4,
            cmp="close" if gauge is None else "recon", post=gauge)


_from_specs()

SPD3 = (lambda m: (m @ m.T + 3 * onp.eye(3)).astype("float32"))(
    _r.randn(3, 3))
_op("_linalg_gelqf", "_linalg_gelqf", (A[:3],), cmp="recon",
    post=lambda o: [o[0] @ o[1], o[1] @ o[1].T], rtol=1e-4, atol=1e-5)
_op("_linalg_syevd", "_linalg_syevd", (SPD3,), cmp="recon",
    post=lambda o: [o[1], o[0].T @ onp.diag(o[1]) @ o[0]], rtol=1e-4,
    atol=1e-4)
_op("_np_copy", "_np_copy", (A,))
for _n in ("_npi_all", "_npi_any"):
    _op(_n, _n, (A > 0,), {"axis": 1})
_op("_npi_argmax", "_npi_argmax", (A,), {"axis": 1})
_op("_npi_argmin", "_npi_argmin", (A,))
_op("_npi_around", "_npi_around", (A * 10,), {"decimals": 1})
for _n in ("_npi_bitwise_and", "_npi_bitwise_or", "_npi_bitwise_xor",
           "_npi_lcm"):
    _op(_n, _n, (I, J))
for _n in ("_npi_bitwise_and_scalar", "_npi_bitwise_or_scalar",
           "_npi_bitwise_xor_scalar", "_npi_lcm_scalar"):
    _op(_n, _n, (I,), {"scalar": 6})
_op("_npi_bitwise_not", "_npi_bitwise_not", (I,))
_op("_npi_logical_not", "_npi_logical_not", (A > 0,))
for _n in ("_npi_isfinite", "_npi_isinf", "_npi_isnan", "_npi_isneginf",
           "_npi_isposinf"):
    _op(_n, _n, (NANS,))
for _n in ("_npi_blackman", "_npi_hamming", "_npi_hanning"):
    _op(_n, _n, (), {"M": 8}, rtol=1e-5, atol=1e-6)
_op("_npi_arange", "_npi_arange", (), {"start": 1, "stop": 9, "step": 2})
_op("_npi_arange[float]", "_npi_arange", (),
    {"start": 0.5, "stop": 3.0, "step": 0.5})
_op("_npi_eye", "_npi_eye", (), {"N": 3, "M": 4, "k": 1})
_op("_npi_identity", "_npi_identity", (), {"n": 3})
_op("_npi_zeros", "_npi_zeros", (), {"shape": (2, 3)})
_op("_npi_ones", "_npi_ones", (), {"shape": (2, 3), "dtype": "int32"})
_op("_npi_full", "_npi_full", (), {"shape": (2, 2), "fill_value": 2.5})
_op("_npi_full_like", "_npi_full_like", (A,), {"fill_value": 2.5})
_op("_npi_indices", "_npi_indices", (), {"dimensions": (2, 3)})
_op("_npi_linspace", "_npi_linspace", (), {"start": 0.0, "stop": 1.0,
                                           "num": 5})
_op("_npi_logspace", "_npi_logspace", (), {"start": 0.0, "stop": 2.0,
                                           "num": 5}, rtol=1e-5)
_op("_npi_tri", "_npi_tri", (), {"N": 4, "k": -1})
_op("_npi_tril_indices", "_npi_tril_indices", (), {"n": 4, "k": 0})
_op("_npi_boolean_mask_assign_scalar", "_npi_boolean_mask_assign_scalar",
    (A, A > 0), {"value": 7.0})
_op("_npi_boolean_mask_assign_tensor", "_npi_boolean_mask_assign_tensor",
    (A, A > 0, B))
_op("_npi_bincount", "_npi_bincount", (IV,), {"minlength": 6})
_op("_npi_delete", "_npi_delete", (V,), {"obj": 2})
_op("_npi_delete[slice]", "_npi_delete", (A,),
    {"obj": 0, "start": 0, "stop": 4, "step": 2, "axis": 1})
_op("_npi_insert_scalar", "_npi_insert_scalar", (V,), {"obj": 2,
                                                      "val": 5.0})
_op("_npi_insert_slice", "_npi_insert_slice", (V,),
    {"start": 0, "stop": 4, "step": 2, "val": 5.0})
_op("_npi_insert_tensor", "_npi_insert_tensor",
    (V, onp.array([1, 3], "int32")), {"val": 5.0})
_op("_npi_diag_indices_from", "_npi_diag_indices_from", (SQ,))
_op("_npi_fill_diagonal", "_npi_fill_diagonal", (A,), {"val": 9.0})
_op("_npi_eig", "_npi_eig", (SQ,), cmp="recon",
    post=lambda o: _eig_post(o), rtol=1e-4, atol=1e-3)
_op("_npi_eigvals", "_npi_eigvals", (SQ,), cmp="sorted", rtol=1e-4,
    atol=1e-4)
_op("_npi_qr", "_npi_qr", (TALL,), cmp="recon", post=_qr_post, rtol=1e-4,
    atol=1e-4)
_op("_npi_lstsq", "_npi_lstsq", (TALL, V[:6]), cmp="recon",
    post=_lstsq_post, rtol=1e-3, atol=1e-4)
_op("_npi_matrix_rank", "_npi_matrix_rank", (TALL,))
_op("_npi_matrix_rank_none_tol", "_npi_matrix_rank_none_tol", (TALL,))
_op("_npi_percentile", "_npi_percentile", (A,), {"q": 30.0})
_op("_npi_percentile[axis]", "_npi_percentile", (A,),
    {"q": 75.0, "axis": 0, "interpolation": "midpoint"})
_op("_npi_share_memory", "_npi_share_memory", (A, B))
_op("_npi_unique", "_npi_unique", (onp.array([3, 1, 3, 2], "float32"),))
_op("_npi_arctan2", "_npi_arctan2", (A, B))     # ops/tensor.py's alias
_op("_npi_where_scalar2", "_npi_where_scalar2", (A > 0,),
    {"x": 1.0, "y": -1.0})
_op("_npx_constraint_check", "_npx_constraint_check", (A > -9,))
_op("_npx_index_update", "_npx_index_update",
    (A, onp.array([0, 2], "int32"), onp.ones((2, 5), "float32")))
_op("_npx_nonzero", "_npx_nonzero", (A > 0.5,))
_op("_random_pdf_dirichlet", "_random_pdf_dirichlet",
    (onp.array([[0.2, 0.3, 0.5], [0.1, 0.6, 0.3]], "float32"),
     onp.array([1.5, 2.0, 3.0], "float32")), rtol=1e-5, atol=1e-6)
_op("_random_pdf_uniform[log]", "_random_pdf_uniform",
    (P[:2], onp.zeros(2, "float32"), onp.ones(2, "float32")),
    {"is_log": True}, rtol=1e-5)

# the kernels' registered names (K5, K4) against the reference's
# head dim 64: K4 and K5 are built for head dims 64 and 128
ROPE_X = _r.randn(2, 6, 4, 64).astype("float32")
ROPE_POS = onp.tile(onp.arange(6, dtype="int32"), (2, 1))
_op("rope", "rope", (ROPE_X, ROPE_POS), rtol=1e-5, atol=1e-5)
_op("_npx_rope", "_npx_rope", (ROPE_X, ROPE_POS), {"base": 500.0},
    rtol=1e-5, atol=1e-5)
PA_Q = _r.randn(3, 2, 64).astype("float32")
PA_K = _r.randn(8, 4, 2, 64).astype("float32")
PA_V = _r.randn(8, 4, 2, 64).astype("float32")
PA_T = onp.array([[0, 1, 2], [3, 4, 5], [6, 7, 0]], "int32")
PA_L = onp.array([9, 3, 0], "int32")
_op("paged_attention", "paged_attention", (PA_Q, PA_K, PA_V, PA_T, PA_L),
    rtol=1e-5, atol=1e-5)
_op("_npx_paged_attention", "_npx_paged_attention",
    (PA_Q, PA_K, PA_V, PA_T, PA_L), {"sm_scale": 0.3}, rtol=1e-5,
    atol=1e-5)

# the samplers, by distribution
SAMPLERS = ("_npi_uniform", "_npi_uniform_n", "_npi_normal", "_npi_normal_n",
            "_npi_bernoulli", "_npi_exponential", "_npi_gamma",
            "_npi_dirichlet", "_npi_gumbel", "_npi_laplace", "_npi_logistic",
            "_npi_pareto", "_npi_powerd", "_npi_rayleigh", "_npi_weibull",
            "_npi_choice", "_npi_multinomial")
for _n, _p, _tol in (
        ("_npi_uniform", {"low": 2.0, "high": 3.0}, 0.02),
        ("_npi_uniform_n", {"low": 0.0, "high": 1.0}, 0.02),
        ("_npi_normal", {"loc": 1.0, "scale": 2.0}, 0.06),
        ("_npi_normal_n", {"loc": 0.0, "scale": 1.0}, 0.04),
        ("_npi_bernoulli", {"prob": 0.3}, 0.02),
        ("_npi_exponential", {"scale": 2.0}, 0.1),
        ("_npi_gamma", {"shape": 2.0, "scale": 1.5}, 0.1),
        ("_npi_gumbel", {"loc": 0.0, "scale": 1.0}, 0.06),
        ("_npi_laplace", {"loc": 0.0, "scale": 1.0}, 0.06),
        ("_npi_logistic", {"loc": 1.0, "scale": 0.5}, 0.05),
        ("_npi_pareto", {"a": 5.0}, 0.02),
        ("_npi_powerd", {"a": 3.0}, 0.02),
        ("_npi_rayleigh", {"scale": 1.0}, 0.04),
        ("_npi_weibull", {"a": 2.0}, 0.03),
        ("_npi_choice", {"a": 5, "replace": True}, 0.06)):
    _op(_n, _n, (), dict(_p, size=(N_DRAWS,)), family="op_random",
        cmp="stats", atol=_tol, post=_moments)
_op("_npi_dirichlet", "_npi_dirichlet", (), {"alpha": (1.0, 2.0, 3.0),
                                             "size": (N_DRAWS // 4,)},
    family="op_random", cmp="stats", atol=0.02,
    post=lambda o: [onp.asarray(o[0]).mean(0)])
_op("_npi_multinomial", "_npi_multinomial", (),
    {"n": 20, "pvals": (0.2, 0.8), "size": (N_DRAWS // 4,)},
    family="op_random", cmp="stats", atol=0.2,
    post=lambda o: [onp.asarray(o[0], "float64").mean(0)])
