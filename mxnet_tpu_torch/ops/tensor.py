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
``reshape`` and ``zeros_like``/``ones_like``.
"""
from __future__ import annotations

import threading

import torch

from ..base import MXNetError, dtype_name, torch_dtype
from .registry import register

__all__ = ["dot", "pick", "embedding", "sparse_embedding", "IdCheck",
           "cast", "flatten", "float_only"]


@register("dot")
def dot(a, b, *, transpose_b=False):
    """``a·b`` for a matrix ``b`` (contracting a's last axis, as
    ``jnp.dot`` does); ``transpose_b`` uses ``bᵀ``."""
    if b.dim() != 2:
        raise MXNetError(f"dot: the port takes a matrix b, got "
                         f"{tuple(b.shape)}")
    return torch.matmul(a, b.t() if transpose_b else b)


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
