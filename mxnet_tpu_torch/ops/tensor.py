"""Tensor ops (counterpart of part of ``mxnet_tpu/ops/tensor.py`` and
of the scalar ops of ``mxnet_tpu/ops/legacy.py``).  Plain PyTorch.

``dot``, ``pick``, ``embedding`` and ``sparse_embedding`` are functions
on tensors that the Gluon training path calls.  ``sparse_embedding``
(``Embedding(sparse_grad=True)``, the registered ``Embedding`` op with
``sparse_grad``) hands ``torch.autograd`` the weight's gradient as a
coalesced sparse COO tensor — the batch's unique ids, sorted, and their
rows of the output gradient summed in a fixed order
(``ndarray.sparse.segment_sum``) — so no dense (vocab, dim) gradient is
built; ``autograd.backward`` turns it into a ``RowSparseNDArray``.
The registered ops below are what ``mx.nd`` and the NDArray operators
reach through the registry: the binary ops
with their ``broadcast_*`` aliases, the ``*_scalar`` ops of the operator
sugar, the unary ops, the reductions, ``cast``, ``flatten``,
``reshape`` and ``zeros_like``/``ones_like``, and the rest of the
reference's list (``mxnet_tpu/ops/tensor.py``): ``clip``, ``norm``,
``argmax``/``argmin``, the cumulative ops, the products (``batch_dot``,
``matmul``, ``tensordot``, ...), the shape ops (``transpose``,
``concat``, ``stack``, ``split``, ``slice*``, ``tile``, ``repeat``,
``pad``, ``flip``, ``broadcast_*``, ...), indexing (``take``, ``pick``,
``one_hot``, ``where``, ``gather_nd``, ...), ordering (``sort``,
``argsort``, ``topk``) and the sequence ops.
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError, dtype_name, torch_dtype
from .registry import alias, register

__all__ = ["dot", "pick", "embedding", "sparse_embedding", "IdCheck",
           "cast", "flatten", "float_only", "concat"]


@register("dot")
def dot(a, b, *, transpose_a=False, transpose_b=False):
    """``jnp.dot(a, b)`` (``mxnet_tpu/ops/tensor.py:181-187``): a's last
    axis against b's only axis, or against b's second-to-last;
    ``transpose_a`` / ``transpose_b`` take ``aᵀ`` / ``bᵀ`` first (for
    more than two axes, a's first axis moved last and b's last moved
    first, as the reference does)."""
    if transpose_a:
        a = a.t() if a.dim() <= 2 else a.movedim(0, -1)
    if transpose_b:
        b = b.t() if b.dim() <= 2 else b.movedim(-1, 0)
    if b.dim() <= 2 or a.dim() == 0:
        return torch.matmul(a, b) if a.dim() and b.dim() else a * b
    return torch.tensordot(a, b, dims=([a.dim() - 1], [b.dim() - 2]))


def pick(a, index, *, axis=-1):
    """``a``'s entry at ``index`` along ``axis`` (that axis dropped);
    indices are clipped to the axis, as the reference's default mode
    does."""
    axis = axis % a.dim()
    idx = index.long().clamp(0, a.shape[axis] - 1).unsqueeze(axis)
    return torch.gather(a, axis, idx).squeeze(axis)


def _raise_out_of_range(lo, hi, vocab):
    raise MXNetError(f"Embedding ids must lie in [0, {vocab}), got "
                     f"[{lo}, {hi}]")


class IdCheck:
    """:func:`embedding`'s id range check, deferred for code that may not
    read the device back (a CUDA graph capture).

    Inside ``with check:`` on this thread, ``embedding`` clamps its ids
    into ``[0, vocab)`` before the gather, so an id out of range can
    never reach the card as an out-of-bounds read, and records each
    call's (min, max) id in a device tensor.  :meth:`bounds` stacks them
    ((calls, 2) int64); :meth:`raise_if_bad` reads them on the host
    afterwards and raises the eager check's :class:`MXNetError`.  The
    check is entered inside the function that calls the model, so that
    a recomputation on autograd's thread (remat) sees it too."""

    def __init__(self):
        self.vocabs = []
        self._rows = []

    def reset(self):
        self.vocabs, self._rows = [], []

    def __enter__(self):
        _IDS.__dict__.setdefault("stack", []).append(self)
        return self

    def __exit__(self, *exc):
        _IDS.stack.pop()
        return False

    def record(self, idx, vocab):
        self.vocabs.append(int(vocab))
        self._rows.append(torch.stack(torch.aminmax(idx)))

    def bounds(self):
        """The recorded (min, max) ids, (calls, 2) int64; None when no
        embedding ran."""
        return torch.stack(self._rows) if self._rows else None

    @staticmethod
    def raise_if_bad(bounds, vocabs):
        """Raise the eager check's error for the first vocabulary size in
        ``vocabs`` whose rows of ``bounds`` (on the host) leave ``[0,
        vocab)``: its lowest and highest id over all those rows."""
        rows = bounds.tolist()
        for vocab in dict.fromkeys(vocabs):
            mine = [r for r, v in zip(rows, vocabs) if v == vocab]
            lo, hi = min(r[0] for r in mine), max(r[1] for r in mine)
            if lo < 0 or hi >= vocab:
                _raise_out_of_range(lo, hi, vocab)


_IDS = threading.local()


def embedding(data, weight):
    """Rows of ``weight`` at integer ``data``.  An id outside
    ``[0, vocab)`` raises: the reference fills such a row with NaN
    (``jnp.take``'s fill mode), which the port does not copy.  The check
    reads the ids' range back to the host: one synchronisation per call
    on a CUDA tensor.  Inside an :class:`IdCheck` it is deferred instead
    (the ids are clamped and their range recorded on the device); inside
    a CUDA graph capture without one it raises."""
    if data.is_floating_point():
        raise MXNetError("Embedding takes integer ids; float ids round "
                         "in low precision — pass int32 or int64")
    idx = data.long()
    vocab = weight.shape[0]
    if idx.numel():
        stack = getattr(_IDS, "stack", None)
        if stack:
            check = stack[-1]
            check.record(idx, vocab)
            idx = idx.clamp(0, vocab - 1)
        elif idx.is_cuda and torch.cuda.is_current_stream_capturing():
            raise MXNetError("embedding inside a CUDA graph capture cannot "
                             "read its ids back: run it inside an "
                             "ops.tensor.IdCheck")
        else:
            lo, hi = (int(x) for x in torch.aminmax(idx))
            if lo < 0 or hi >= vocab:
                _raise_out_of_range(lo, hi, vocab)
    return weight[idx]


class _SparseEmbedding(torch.autograd.Function):
    """:func:`embedding` whose weight gradient is row-sparse
    (``mxnet_tpu/ops/tensor.py:570-600``): the cotangent's rows summed
    by id, as a coalesced sparse COO tensor of the weight's shape."""

    @staticmethod
    def forward(ctx, data, weight):
        ctx.save_for_backward(data)
        ctx.weight_shape = tuple(weight.shape)
        return embedding(data, weight)

    @staticmethod
    def backward(ctx, ct):
        if not ctx.needs_input_grad[1]:
            return None, None
        from ..ndarray.sparse import segment_sum
        (data,) = ctx.saved_tensors
        shape = ctx.weight_shape
        ids = data.reshape(-1).long().clamp(0, shape[0] - 1)
        rows, vals = segment_sum(ct.reshape(ids.numel(), *shape[1:]), ids)
        return None, torch.sparse_coo_tensor(
            rows[None], vals, shape, is_coalesced=True,
            check_invariants=False)


def sparse_embedding(data, weight):
    """:func:`embedding` with a row-sparse weight gradient."""
    if not (torch.is_grad_enabled() and weight.requires_grad):
        return embedding(data, weight)
    return _SparseEmbedding.apply(data, weight)


@register("Embedding")
def _embedding_op(data, weight, *, input_dim=None, output_dim=None,
                  dtype=None, sparse_grad=False):
    """``mx.nd.Embedding``: rows of ``weight`` at ``data``; with
    ``sparse_grad`` the weight's gradient is row-sparse."""
    return (sparse_embedding if sparse_grad else embedding)(data, weight)


# --------------------------------------------------------------------------
# registered ops (``mxnet_tpu/ops/tensor.py:27-138``, ``:219``, ``:495``)
# --------------------------------------------------------------------------

def _same_dtype(cmp):
    """Comparisons return the first input's dtype, as in the reference."""
    def op(a, b):
        return cmp(a, b).to(a.dtype)
    return op


for _name, _fn, _aliases in (
        ("elemwise_add", torch.add,
         ("broadcast_add", "_plus", "add", "broadcast_plus")),
        ("elemwise_sub", torch.sub,
         ("broadcast_sub", "_minus", "subtract", "broadcast_minus")),
        ("elemwise_mul", torch.mul, ("broadcast_mul", "_mul", "multiply")),
        ("elemwise_div", torch.div, ("broadcast_div", "_div", "divide")),
        ("broadcast_mod", torch.remainder, ("_mod", "mod")),
        ("broadcast_power", torch.pow, ("_power", "power")),
        ("broadcast_maximum", torch.maximum, ("maximum",)),
        ("broadcast_minimum", torch.minimum, ("minimum",)),
        ("broadcast_equal", _same_dtype(torch.eq), ("_equal",)),
        ("broadcast_not_equal", _same_dtype(torch.ne), ("_not_equal",)),
        ("broadcast_greater", _same_dtype(torch.gt), ("_greater",)),
        ("broadcast_greater_equal", _same_dtype(torch.ge),
         ("_greater_equal",)),
        ("broadcast_lesser", _same_dtype(torch.lt), ("_lesser",)),
        ("broadcast_lesser_equal", _same_dtype(torch.le),
         ("_lesser_equal",))):
    def _binary(a, b, _f=_fn):
        return _f(a, b)
    _binary.__name__ = _name
    register(_name, aliases=_aliases)(_binary)


def _scalar_like(a, scalar):
    """The scalar as a 0-d tensor of ``a``'s dtype (host-side, which torch
    accepts beside a CUDA tensor): the reference casts it to the array's
    dtype first, so an int array stays int and a bf16 one computes with
    the bf16-rounded scalar."""
    return torch.tensor(scalar, dtype=a.dtype)


for _name, _fn, _rev, _cmp in (
        ("_plus_scalar", torch.add, False, False),
        ("_minus_scalar", torch.sub, False, False),
        ("_rminus_scalar", torch.sub, True, False),
        ("_mul_scalar", torch.mul, False, False),
        ("_div_scalar", torch.div, False, False),
        ("_rdiv_scalar", torch.div, True, False),
        ("_mod_scalar", torch.remainder, False, False),
        ("_rmod_scalar", torch.remainder, True, False),
        ("_power_scalar", torch.pow, False, False),
        ("_rpower_scalar", torch.pow, True, False),
        ("_equal_scalar", torch.eq, False, True),
        ("_not_equal_scalar", torch.ne, False, True),
        ("_greater_scalar", torch.gt, False, True),
        ("_greater_equal_scalar", torch.ge, False, True),
        ("_lesser_scalar", torch.lt, False, True),
        ("_lesser_equal_scalar", torch.le, False, True)):
    def _scalar_op(a, *, scalar=0.0, _f=_fn, _rev=_rev, _cmp=_cmp):
        s = _scalar_like(a, scalar)
        out = _f(s, a) if _rev else _f(a, s)
        return out.to(a.dtype) if _cmp else out
    _scalar_op.__name__ = _name
    register(_name)(_scalar_op)


def float_only(name, fn):
    """``fn`` refusing integer and bool input, as the reference's
    ``logistic`` does ("logistic does not accept dtype int32"); the
    other float ops of the table promote integers to float32 in both
    packages."""
    def op(a):
        if not (a.is_floating_point() or a.is_complex()):
            raise TypeError(f"{name} does not accept dtype "
                            f"{dtype_name(a.dtype)}; accepted dtypes are "
                            f"floating and complex")
        return fn(a)
    op.__name__ = name
    return op


for _name, _fn in (("negative", torch.neg), ("abs", torch.abs),
                   ("square", torch.square), ("sqrt", torch.sqrt),
                   ("exp", torch.exp),
                   ("log", torch.log), ("relu", torch.relu),
                   ("sigmoid", float_only("sigmoid", torch.sigmoid)),
                   ("tanh", torch.tanh)):
    def _unary(a, _f=_fn):
        return _f(a)
    _unary.__name__ = _name
    register(_name)(_unary)


def _dims(a, axis, exclude):
    """The reduced dims: all for ``axis=None``; ``exclude`` reduces the
    others."""
    if axis is None:
        return tuple(range(a.dim()))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(int(x) % max(a.dim(), 1) for x in axes)
    if exclude:
        axes = tuple(i for i in range(a.dim()) if i not in axes)
    return axes


def _sum(a, dims, keepdims):
    # integer sums keep their width (bool and 8-bit ones widen to int32),
    # as in the reference; torch would widen every int to int64
    dtype = None
    if not a.is_floating_point():
        dtype = a.dtype if a.dtype in (torch.int32, torch.int64) \
            else torch.int32
    return torch.sum(a, dim=dims, keepdim=keepdims, dtype=dtype)


def _mean(a, dims, keepdims):
    if not a.is_floating_point():
        a = a.float()
    return torch.mean(a, dim=dims, keepdim=keepdims)


for _name, _fn, _aliases in (
        ("sum", _sum, ("sum_axis",)), ("mean", _mean, ()),
        ("max", lambda a, d, k: torch.amax(a, dim=d, keepdim=k),
         ("max_axis",)),
        ("min", lambda a, d, k: torch.amin(a, dim=d, keepdim=k),
         ("min_axis",))):
    def _reduce(a, *, axis=None, keepdims=False, exclude=False, _f=_fn):
        dims = _dims(a, axis, exclude)
        if not dims and a.dim():        # nothing to reduce
            return a.clone()
        return _f(a, dims, keepdims)
    _reduce.__name__ = _name
    register(_name, aliases=_aliases)(_reduce)


@register("cast", aliases=("Cast",))
def cast(a, *, dtype):
    """``a`` as ``dtype``.  Float to integer truncates toward zero and
    saturates at the target's range, NaN giving 0, as the reference's
    conversion does (``Tensor.to`` wraps: -2.25 would become 254 as
    uint8)."""
    dt = torch_dtype(dtype)
    if not a.is_floating_point() or dt.is_floating_point or dt == torch.bool:
        return a.to(dt)
    info = torch.iinfo(dt)
    # compared in a's own type: int32's max rounds up to 2**31 in f32, so
    # every value that reaches it is out of range
    hi, lo = a >= info.max, a <= info.min
    inside = torch.where(hi | lo | torch.isnan(a), 0, a).to(dt)
    return torch.where(hi, info.max, torch.where(lo, info.min, inside)
                       ).to(dt)


@register("flatten", aliases=("Flatten",))
def flatten(a):
    """Every axis after the first folded into one (``mxnet_tpu/ops/
    tensor.py:270``)."""
    return a.reshape(a.shape[0], -1)


@register("reshape", aliases=("Reshape",))
def _reshape(a, *, shape, reverse=False):
    """MXNet's special codes: 0 copies a dim, -1 infers one, -2 copies
    the rest, -3 merges two, -4 splits one into the next two."""
    shape = list(shape)
    a_shape = list(a.shape)
    if reverse:
        a_shape, shape = a_shape[::-1], shape[::-1]
    out, src_i, i = [], 0, 0
    while i < len(shape):
        s = shape[i]
        if s == 0:
            out.append(a_shape[src_i])
            src_i += 1
        elif s == -1:
            out.append(-1)
            src_i += 1
        elif s == -2:
            out.extend(a_shape[src_i:])
            src_i = len(a_shape)
        elif s == -3:
            out.append(a_shape[src_i] * a_shape[src_i + 1])
            src_i += 2
        elif s == -4:
            d1, d2 = shape[i + 1], shape[i + 2]
            cur = a_shape[src_i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            src_i += 1
            i += 2
        else:
            out.append(s)
            src_i += 1
        i += 1
    if reverse:
        out = out[::-1]
    return a.reshape(tuple(out))


@register("zeros_like")
def _zeros_like(a):
    return torch.zeros_like(a)


@register("ones_like")
def _ones_like(a):
    return torch.ones_like(a)


# --------------------------------------------------------------------------
# the rest of the reference's list (``mxnet_tpu/ops/tensor.py``)
# --------------------------------------------------------------------------

def _promote(fn):
    """``fn`` on integer or bool input promoted to float32, as jnp's
    float functions promote it."""
    def op(a):
        return fn(a if a.is_floating_point() or a.is_complex()
                  else a.float())
    return op


def _cbrt(a):
    return torch.sign(a) * a.abs().pow(1.0 / 3.0)


for _name, _fn in (
        ("sign", torch.sign), ("rint", torch.round), ("round", torch.round),
        ("ceil", torch.ceil), ("floor", torch.floor), ("trunc", torch.trunc),
        ("fix", torch.trunc), ("rsqrt", _promote(torch.rsqrt)),
        ("cbrt", _promote(_cbrt)),
        ("rcbrt", _promote(lambda a: 1.0 / _cbrt(a))),
        ("expm1", _promote(torch.expm1)), ("log10", _promote(torch.log10)),
        ("log2", _promote(torch.log2)), ("log1p", _promote(torch.log1p)),
        ("sin", _promote(torch.sin)), ("cos", _promote(torch.cos)),
        ("tan", _promote(torch.tan)), ("arcsin", _promote(torch.asin)),
        ("arccos", _promote(torch.acos)), ("arctan", _promote(torch.atan)),
        ("sinh", _promote(torch.sinh)), ("cosh", _promote(torch.cosh)),
        ("arcsinh", _promote(torch.asinh)),
        ("arccosh", _promote(torch.acosh)),
        ("arctanh", _promote(torch.atanh)),
        ("degrees", _promote(torch.rad2deg)),
        ("radians", _promote(torch.deg2rad)),
        ("erf", _promote(torch.erf)), ("erfinv", _promote(torch.erfinv)),
        ("gamma", _promote(lambda a: torch.exp(torch.lgamma(a)))),
        ("gammaln", _promote(torch.lgamma)),
        ("digamma", _promote(torch.digamma)),
        ("reciprocal", torch.reciprocal),
        ("logical_not", lambda a: torch.logical_not(a).to(a.dtype)),
        ("softsign", _promote(lambda a: a / (1 + a.abs()))),
        ("isnan", torch.isnan), ("isinf", torch.isinf),
        ("isfinite", torch.isfinite)):
    def _unary2(a, _f=_fn):
        return _f(a)
    _unary2.__name__ = _name
    register(_name, aliases=("lgamma",) if _name == "gammaln" else ())(
        _unary2)

alias("negative", "_np_negative")

for _name, _fn, _aliases in (
        ("broadcast_hypot", torch.hypot, ("hypot",)),
        ("broadcast_logical_and",
         lambda a, b: torch.logical_and(a, b).to(a.dtype), ("logical_and",)),
        ("broadcast_logical_or",
         lambda a, b: torch.logical_or(a, b).to(a.dtype), ("logical_or",)),
        ("broadcast_logical_xor",
         lambda a, b: torch.logical_xor(a, b).to(a.dtype), ("logical_xor",)),
        ("arctan2", torch.atan2, ("_npi_arctan2",))):
    def _binary2(a, b, _f=_fn):
        return _f(a, b)
    _binary2.__name__ = _name
    register(_name, aliases=_aliases)(_binary2)


@register("clip")
def _clip(a, *, a_min=None, a_max=None):
    """``a`` limited to ``[a_min, a_max]`` (either may be None)."""
    return torch.clamp(a, a_min, a_max)


@register("smooth_l1")
def _smooth_l1(a, *, scalar=1.0):
    """``0.5 (s x)²`` where ``|x| < 1/s²``, else ``|x| - 0.5/s²``."""
    s2 = scalar * scalar
    ax = a.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * a * a, ax - 0.5 / s2)


def _prod(a, dims, keepdims):
    out = a if a.is_floating_point() else a.to(
        a.dtype if a.dtype in (torch.int32, torch.int64) else torch.int32)
    for d in sorted(dims, reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return out


for _name, _fn in (
        ("prod", _prod),
        ("nansum", lambda a, d, k: torch.nansum(a, dim=d, keepdim=k)),
        ("nanprod", lambda a, d, k: _prod(torch.where(
            torch.isnan(a), torch.ones_like(a), a), d, k))):
    def _reduce2(a, *, axis=None, keepdims=False, exclude=False, _f=_fn):
        dims = _dims(a, axis, exclude)
        return _f(a, dims, keepdims)
    _reduce2.__name__ = _name
    register(_name)(_reduce2)


@register("norm")
def _norm(a, *, ord=2, axis=None, keepdims=False):
    """The 1-norm (``ord=1``) or the 2-norm over ``axis``."""
    dims = _dims(a, axis, False)
    if ord == 1:
        return torch.sum(a.abs(), dim=dims, keepdim=keepdims)
    return torch.sqrt(torch.sum(a.square(), dim=dims, keepdim=keepdims))


def _arg(fn):
    def op(a, *, axis=None, keepdims=False):
        if axis is None:
            out = fn(a.reshape(-1), dim=0)
            if keepdims:
                out = out.reshape((1,) * a.dim())
        else:
            out = fn(a, dim=int(axis), keepdim=keepdims)
        return out.to(torch.float32)    # the reference's float indices
    return op


register("argmax")(_arg(torch.argmax))
register("argmin")(_arg(torch.argmin))


def _cum(fn):
    def op(a, *, axis=None, dtype=None):
        x = a.reshape(-1) if axis is None else a
        if dtype is None and not a.is_floating_point():
            dtype = a.dtype if a.dtype in (torch.int32, torch.int64) \
                else torch.int32
        return fn(x, dim=0 if axis is None else int(axis),
                  dtype=None if dtype is None else torch_dtype(dtype))
    return op


register("cumsum", aliases=("_np_cumsum",))(_cum(torch.cumsum))
register("cumprod")(_cum(torch.cumprod))


@register("logsumexp")
def _logsumexp(a, *, axis=None, keepdims=False):
    return torch.logsumexp(a, dim=_dims(a, axis, False), keepdim=keepdims)


@register("batch_dot")
def _batch_dot(a, b, *, transpose_a=False, transpose_b=False):
    """Batched matrix products over the leading axes."""
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


register("matmul", aliases=("_npi_matmul",))(
    lambda a, b: torch.matmul(a, b))
register("tensordot")(
    lambda a, b, *, axes=2: torch.tensordot(
        a, b, dims=axes if isinstance(axes, int)
        else [list(x) if isinstance(x, (tuple, list)) else [x]
              for x in axes]))
register("kron")(lambda a, b: torch.kron(a, b))
register("outer")(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)))
register("vdot")(lambda a, b: torch.vdot(a.reshape(-1), b.reshape(-1)))
register("inner")(lambda a, b: torch.inner(a, b))


@register("khatri_rao")
def _khatri_rao(*mats):
    """The column-wise Kronecker product of matrices."""
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


@register("transpose")
def _transpose(a, *, axes=None):
    """``a``'s axes in the order ``axes`` (reversed when None or
    empty)."""
    if not axes:
        return a.permute(*reversed(range(a.dim())))
    return a.permute(*axes)


register("swapaxes", aliases=("SwapAxis",))(
    lambda a, *, dim1=0, dim2=0: a.transpose(dim1, dim2))
register("expand_dims")(lambda a, *, axis: a.unsqueeze(axis))


@register("squeeze")
def _squeeze(a, *, axis=None):
    if axis is None:
        return a.squeeze()
    return a.squeeze(axis if isinstance(axis, int) else tuple(axis))


@register("concat", aliases=("Concat",))
def concat(*args, dim=1):
    """The inputs joined along ``dim``."""
    return torch.cat(args, dim=dim)


@register("stack")
def _stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register("split", aliases=("SliceChannel", "split_v2"))
def _split(a, *, num_outputs=None, axis=1, squeeze_axis=False,
           indices=None):
    """``a`` cut along ``axis`` into ``num_outputs`` equal parts, or at
    ``indices``; a list of arrays."""
    n = a.shape[axis]
    if indices is not None:
        cuts = [0] + [int(i) for i in indices] + [n]
        parts = [a.narrow(axis, lo, max(hi - lo, 0))
                 for lo, hi in zip(cuts[:-1], cuts[1:])]
    else:
        if n % num_outputs:
            raise MXNetError(f"split: axis {axis} of size {n} does not "
                             f"divide into {num_outputs} parts")
        parts = list(torch.split(a, n // num_outputs, dim=axis))
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return parts


def _take_slice(a, axis, b, e, s):
    """``a[..., b:e:s, ...]`` on ``axis`` (a negative step too)."""
    start, stop, step = slice(b, e, s).indices(a.shape[axis])
    if step > 0:
        return a[(slice(None),) * axis + (slice(start, stop, step),)]
    idx = torch.arange(start, stop, step, device=a.device)
    return a.index_select(axis, idx)


@register("slice", aliases=("crop",))
def _slice(a, *, begin, end, step=None):
    """``a[b0:e0:s0, b1:e1:s1, ...]`` (None entries take the whole
    range)."""
    step = step or [None] * len(begin)
    out = a
    for ax, (b, e, st) in enumerate(zip(begin, end, step)):
        out = _take_slice(out, ax, b, e, st)
    return out


@register("slice_axis")
def _slice_axis(a, *, axis, begin, end):
    return _take_slice(a, axis % a.dim(), begin, end, None)


@register("slice_like")
def _slice_like(a, b, *, axes=()):
    out = a
    for ax in (axes or range(min(a.dim(), b.dim()))):
        out = out.narrow(ax, 0, b.shape[ax])
    return out


register("tile")(lambda a, *, reps: torch.tile(
    a, (reps,) if isinstance(reps, int) else tuple(reps)))


@register("repeat")
def _repeat(a, *, repeats, axis=None):
    """Each element repeated ``repeats`` times along ``axis`` (of the
    flattened array when None)."""
    return torch.repeat_interleave(a, repeats, dim=axis)


def _pad_index(n, before, after, mode, device):
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    period = 2 * (n - 1) if n > 1 else 1
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


@register("pad", aliases=("Pad",))
def _pad(a, *, mode="constant", pad_width=(), constant_value=0.0):
    """``a`` padded by ``pad_width`` (before and after for each axis in
    turn): with ``constant_value``, or by ``edge`` or ``reflect``."""
    pw = list(zip(pad_width[::2], pad_width[1::2]))
    if mode == "constant":
        flat = []
        for before, after in reversed(pw):
            flat += [int(before), int(after)]
        return torch.nn.functional.pad(a, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise MXNetError(f"pad: mode {mode!r} is not known")
    out = a
    for ax, (before, after) in enumerate(pw):
        if before or after:
            out = out.index_select(ax, _pad_index(
                out.shape[ax], int(before), int(after), mode, a.device))
    return out


register("flip", aliases=("reverse",))(
    lambda a, *, axis: torch.flip(a, (axis,) if isinstance(axis, int)
                                  else tuple(axis)))
register("roll")(lambda a, *, shift, axis=None: torch.roll(
    a, shift, axis))


@register("depth_to_space")
def _depth_to_space(a, *, block_size):
    n, c, h, w = a.shape
    b = block_size
    x = a.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def _space_to_depth(a, *, block_size):
    n, c, h, w = a.shape
    b = block_size
    x = a.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("diag")
def _diag(a, *, k=0):
    return torch.diag(a, k) if a.dim() <= 2 else torch.diagonal(
        a, offset=k, dim1=0, dim2=1)


@register("broadcast_to")
def _broadcast_to(a, *, shape):
    """``a`` broadcast to ``shape`` (0 keeps a's size there)."""
    shape = tuple(s if s != 0 else a.shape[i] for i, s in enumerate(shape))
    return a.expand(shape)


register("broadcast_like")(lambda a, b: a.expand(b.shape))


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(a, *, axis=(), size=()):
    axis = (axis,) if isinstance(axis, int) else axis
    size = (size,) if isinstance(size, int) else size
    shape = list(a.shape)
    for ax, n in zip(axis, size):
        shape[ax] = n
    return a.expand(tuple(shape))


@register("take")
def _take(a, indices, *, axis=0, mode="clip"):
    """Slices of ``a`` along ``axis`` at ``indices`` (clipped to the
    axis, or wrapped with ``mode="wrap"``)."""
    n = a.shape[axis]
    idx = indices.long()
    idx = idx.clamp(0, n - 1) if mode == "clip" else idx.remainder(n)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + tuple(indices.shape)
                       + a.shape[axis + 1:])


@register("pick")
def _pick_op(a, index, *, axis=-1, keepdims=False, mode="clip"):
    """``a``'s entry at ``index`` along ``axis`` (indices clipped)."""
    out = pick(a, index, axis=axis)
    return out.unsqueeze(axis % a.dim()) if keepdims else out


@register("gather_nd")
def _gather_nd(a, indices):
    return a[tuple(indices.long())]


@register("scatter_nd")
def _scatter_nd(data, indices, *, shape):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put_(tuple(indices.long()), data)


@register("one_hot")
def _one_hot(indices, *, depth, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """``on_value`` at each index's position on a new last axis of size
    ``depth``, ``off_value`` elsewhere (an index outside ``[0, depth)``
    gives a row of ``off_value``)."""
    hit = indices.long().unsqueeze(-1) == torch.arange(
        depth, device=indices.device)
    oh = hit.to(torch.float32)
    return (oh * (on_value - off_value) + off_value).to(torch_dtype(dtype))


@register("where")
def _where(cond, a, b):
    """``a`` where ``cond`` is non-zero, else ``b``."""
    return torch.where(cond.bool(), a, b)


@register("boolean_mask_nonzero")
def _nonzero(a):
    return torch.nonzero(a)


@register("take_along_axis")
def _take_along_axis(a, indices, *, axis):
    return torch.take_along_dim(a, indices.long(), dim=axis)


@register("sort")
def _sort(a, *, axis=-1, is_ascend=True):
    out = torch.sort(a, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort")
def _argsort(a, *, axis=-1, is_ascend=True, dtype="float32"):
    """The ascending order's indices (reversed for ``is_ascend=False``),
    as ``dtype``."""
    out = torch.argsort(a, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


@register("topk")
def _topk(a, *, k=1, axis=-1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    """The ``k`` largest (smallest with ``is_ascend``) entries along
    ``axis``, in order: their ``indices`` (as ``dtype``), their
    ``value``, ``both``, or a ``mask`` of a's shape and dtype marking
    them."""
    ax = -1 if axis is None else axis
    vals, idx = torch.topk(a, k, dim=ax, largest=not is_ascend, sorted=True)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return [vals, idx.to(torch_dtype(dtype))]
    if ret_typ == "mask":
        return torch.zeros_like(a).scatter_(ax, idx, 1)
    return idx.to(torch_dtype(dtype))


@register("full_like")
def _full_like(a, *, fill_value):
    return torch.full_like(a, fill_value)


@register("shape_array")
def _shape_array(a):
    """``a``'s shape as int32 (the reference asks for int64, which JAX
    without x64 gives as int32)."""
    return torch.tensor(a.shape, dtype=torch.int32, device=a.device)


@register("size_array")
def _size_array(a):
    return torch.tensor([a.numel()], dtype=torch.int32, device=a.device)


@register("SequenceMask", aliases=("sequence_mask",))
def _sequence_mask(data, sequence_length=None, *, use_sequence_length=False,
                   value=0.0, axis=0):
    """Steps at or past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[:, None] < sequence_length[None, :]
    if axis == 1:
        mask = mask.t()
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, torch.tensor(value, dtype=data.dtype,
                                                device=data.device))


@register("SequenceLast", aliases=("sequence_last",))
def _sequence_last(data, sequence_length=None, *, use_sequence_length=False,
                   axis=0):
    """Each sequence's last valid step."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = (sequence_length - 1).long()
    moved = data.movedim(axis, 0)
    idx = last.reshape((1, -1) + (1,) * (moved.dim() - 2))
    return torch.take_along_dim(moved, idx, dim=0)[0]


@register("SequenceReverse", aliases=("sequence_reverse",))
def _sequence_reverse(data, sequence_length=None, *,
                      use_sequence_length=False, axis=0):
    """Each sequence's valid steps reversed, the padding left in
    place."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    moved = data.movedim(axis, 0)
    steps = torch.arange(moved.shape[0], device=data.device)[:, None]
    lens = sequence_length.long()[None, :]
    src = torch.where(steps < lens, lens - 1 - steps, steps)
    out = torch.take_along_dim(
        moved, src.reshape(tuple(src.shape) + (1,) * (moved.dim() - 2)),
        dim=0)
    return out.movedim(0, axis)


@register("L2Normalization")
def _l2_normalization(data, *, eps=1e-10, mode="instance"):
    if mode == "instance":
        axes = tuple(range(1, data.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, data.dim()))
    return data / torch.sqrt(data.square().sum(dim=axes, keepdim=True) + eps)


@register("InstanceNorm")
def instance_norm(data, gamma, beta, *, eps=1e-3, axis=1):
    """Normalisation over every axis but the batch and ``axis``
    (``mxnet_tpu/ops/tensor.py:618-632``), population variance."""
    ax = axis % data.dim()
    excluded = {0, 1} if ax == 0 else {0, ax}
    axes = tuple(i for i in range(data.dim()) if i not in excluded)
    mean = data.mean(dim=axes, keepdim=True)
    var = (data - mean).square().mean(dim=axes, keepdim=True)
    xn = (data - mean) / torch.sqrt(var + eps)
    shape = [1] * data.dim()
    shape[ax] = -1
    return xn * gamma.reshape(shape) + beta.reshape(shape)


@register("allclose")
def _allclose(a, b, *, rtol=1e-5, atol=1e-8, equal_nan=False):
    return torch.tensor([float(torch.allclose(
        a, b, rtol=rtol, atol=atol, equal_nan=equal_nan))],
        dtype=torch.float32, device=a.device)


@register("histogram")
def _histogram(a, *, bin_cnt=10, range=None):
    """Counts in ``bin_cnt`` equal bins over ``range`` (default a's
    min and max) and the bins' edges."""
    lo, hi = range if range is not None else (float(a.min()),
                                               float(a.max()))
    x = a.reshape(-1).float()
    edges = torch.linspace(lo, hi, bin_cnt + 1, device=a.device)
    inside = (x >= lo) & (x <= hi)
    b = ((x - lo) / (hi - lo) * bin_cnt).floor().long().clamp(0, bin_cnt - 1)
    cnt = torch.zeros(bin_cnt, dtype=torch.int32, device=a.device)
    cnt.index_add_(0, b[inside], torch.ones_like(b[inside],
                                                 dtype=torch.int32))
    return [cnt, edges.to(a.dtype if a.is_floating_point()
                          else torch.float32)]
