"""The NumPy-intrinsic ops ``_npi_*`` / ``_np_*`` / ``_npx_*`` (counterpart
of ``mxnet_tpu/ops/npi.py``).

Each op is a registered function on tensors whose body is numpy's
function from ``np_impl``, so ``mx.nd._npi_*`` goes through the one op
funnel like every other op.  Results take the reference's dtypes
(``np_impl.canon``: 32-bit unless a 64-bit switch is on).  The ops whose
output shape depends on the data (``_npi_unique``, ``_npx_nonzero``,
``_npi_bincount`` without a length) run eagerly only, as the reference's
do.
"""
from __future__ import annotations

import inspect

import torch

from ..base import torch_dtype
from . import np_impl as I
from .random import _device
from .registry import register

__all__ = []


def _dt(dtype, default=None):
    if dtype is None:
        return default if default is not None else I.float_default()
    return I.canon_dtype(torch_dtype(dtype))


def _ax(axis):
    return tuple(axis) if isinstance(axis, list) else axis


def _reg(name, fn, aliases=()):
    """Register ``fn`` as ``name`` with its results narrowed to the
    reference's dtypes; ``mx.nd`` reads ``fn``'s signature."""
    def op(*args, **kwargs):
        return I.canon_out(fn(*args, **kwargs))
    op.__name__ = name
    op.__doc__ = fn.__doc__
    op.__signature__ = inspect.signature(fn)
    return register(name, aliases=aliases)(op)


# -- elementwise binary and their scalar forms (np_elemwise_broadcast_op.cc) --

def _ldexp(a, b):
    """``a * 2**b`` on floats, as the reference's mshadow ldexp (not
    numpy's integer exponent)."""
    a, b = I.pair(a, b)
    return I.inexact(a) * torch.exp2(I.inexact(b))


_BINARY = {
    "_npi_add": I.BINARY["add"], "_npi_subtract": I.BINARY["subtract"],
    "_npi_multiply": I.BINARY["multiply"],
    "_npi_true_divide": I.BINARY["true_divide"], "_npi_mod": I.BINARY["mod"],
    "_npi_power": I.BINARY["power"], "_npi_copysign": I.BINARY["copysign"],
    "_npi_lcm": I.BINARY["lcm"], "_npi_ldexp": _ldexp,
    "_npi_fmax": I.BINARY["fmax"], "_npi_fmin": I.BINARY["fmin"],
    "_npi_fmod": I.BINARY["fmod"],
    "_npi_bitwise_and": I.BINARY["bitwise_and"],
    "_npi_bitwise_or": I.BINARY["bitwise_or"],
    "_npi_bitwise_xor": I.BINARY["bitwise_xor"],
    "_npi_hypot": I.BINARY["hypot"],
}


def _bin_op(f):
    def op(a, b):
        return f(a, b)
    return op


for _name, _fn in _BINARY.items():
    _reg(_name, _bin_op(_fn))


def _as_dtype_of(s, a):
    return torch.as_tensor(s, dtype=a.dtype, device=a.device)


_SCALAR = {
    "_npi_add_scalar": (I.BINARY["add"], False),
    "_npi_subtract_scalar": (I.BINARY["subtract"], False),
    "_npi_rsubtract_scalar": (I.BINARY["subtract"], True),
    "_npi_multiply_scalar": (I.BINARY["multiply"], False),
    "_npi_true_divide_scalar": (I.BINARY["true_divide"], False),
    "_npi_rtrue_divide_scalar": (I.BINARY["true_divide"], True),
    "_npi_mod_scalar": (I.BINARY["mod"], False),
    "_npi_rmod_scalar": (I.BINARY["mod"], True),
    "_npi_power_scalar": (I.BINARY["power"], False),
    "_npi_rpower_scalar": (I.BINARY["power"], True),
    "_npi_copysign_scalar": (I.BINARY["copysign"], False),
    "_npi_rcopysign_scalar": (I.BINARY["copysign"], True),
    "_npi_arctan2_scalar": (I.BINARY["arctan2"], False),
    "_npi_rarctan2_scalar": (I.BINARY["arctan2"], True),
    "_npi_lcm_scalar": (lambda a, b: torch.lcm(a, _as_dtype_of(b, a)),
                        False),
    "_npi_ldexp_scalar": (lambda a, b: I.inexact(a) * torch.exp2(
        _as_dtype_of(b, I.inexact(a))), False),
    # reversed: the scalar is the mantissa, the array the exponent
    "_npi_rldexp_scalar": (lambda s_, a: s_ * torch.exp2(I.inexact(a)),
                           True),
    "_npi_fmax_scalar": (I.BINARY["fmax"], False),
    "_npi_fmin_scalar": (I.BINARY["fmin"], False),
    "_npi_fmod_scalar": (I.BINARY["fmod"], False),
    "_npi_rfmod_scalar": (I.BINARY["fmod"], True),
    "_npi_bitwise_and_scalar": (lambda a, b: torch.bitwise_and(
        a, _as_dtype_of(b, a)), False),
    "_npi_bitwise_or_scalar": (lambda a, b: torch.bitwise_or(
        a, _as_dtype_of(b, a)), False),
    "_npi_bitwise_xor_scalar": (lambda a, b: torch.bitwise_xor(
        a, _as_dtype_of(b, a)), False),
}


def _scalar_op(f, rev):
    def op(a, *, scalar=0.0):
        return f(scalar, a) if rev else f(a, scalar)
    return op


for _name, (_fn, _rev) in _SCALAR.items():
    _reg(_name, _scalar_op(_fn, _rev))


# -- unary (np_elemwise_unary_op_basic.cc) ------------------------------------

def _copy(a):
    return a.clone() if not a.dtype.is_floating_point else \
        a + torch.zeros((), dtype=a.dtype, device=a.device)


_UNARY = {
    "_npi_log": I.UNARY["log"], "_npi_logical_not": I.UNARY["logical_not"],
    "_npi_bitwise_not": I.UNARY["invert"],
    "_npi_deg2rad": I.UNARY["deg2rad"], "_npi_rad2deg": I.UNARY["rad2deg"],
    "_npi_isnan": I.UNARY["isnan"], "_npi_isinf": I.UNARY["isinf"],
    "_npi_isfinite": I.UNARY["isfinite"],
    "_npi_isneginf": I.UNARY["isneginf"],
    "_npi_isposinf": I.UNARY["isposinf"], "_np_copy": _copy,
    "_npx_relu": torch.relu, "_npx_sigmoid": torch.sigmoid,
}


def _un_op(f):
    def op(a):
        return f(a)
    return op


for _name, _fn in _UNARY.items():
    _reg(_name, _un_op(_fn))


def _npi_around(a, *, decimals=0):
    return I.around(a, decimals)


def _npi_nan_to_num(a, *, copy=True, nan=0.0, posinf=None, neginf=None):
    return I.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf)


_reg("_npi_around", _npi_around)
_reg("_npi_nan_to_num", _npi_nan_to_num)


# -- reductions (np_broadcast_reduce_op_*.cc) ---------------------------------

def _red(f):
    def op(a, *, axis=None, dtype=None, keepdims=False):
        out = f(a, axis=_ax(axis), keepdims=keepdims)
        return out.to(_dt(dtype)) if dtype is not None else out
    return op


for _name, _fn in {"_npi_sum": I.sum, "_npi_mean": I.mean,
                   "_npi_max": I.amax, "_npi_min": I.amin,
                   "_npi_prod": I.prod, "_npi_all": I.all,
                   "_npi_any": I.any}.items():
    _reg(_name, _red(_fn))


def _npi_std(a, *, axis=None, dtype=None, ddof=0, keepdims=False):
    out = I.std(a, _ax(axis), ddof=ddof, keepdims=keepdims)
    return out.to(_dt(dtype)) if dtype is not None else out


def _npi_var(a, *, axis=None, dtype=None, ddof=0, keepdims=False):
    out = I.var(a, _ax(axis), ddof=ddof, keepdims=keepdims)
    return out.to(_dt(dtype)) if dtype is not None else out


def _npi_argmax(a, *, axis=None, keepdims=False):
    return I.argmax(a, axis, keepdims)


def _npi_argmin(a, *, axis=None, keepdims=False):
    return I.argmin(a, axis, keepdims)


def _npi_average(a, *weights, axis=None, returned=False):
    w = weights[0] if weights else None
    return I.average(a, _ax(axis), w, returned)


def _npi_norm(a, *, ord=None, axis=None, keepdims=False, flag=None):
    return torch.linalg.norm(I.inexact(a), ord=ord, dim=_ax(axis),
                             keepdim=keepdims)


def _npi_cumsum(a, *, axis=None, dtype=None):
    return I.cumsum(a, axis, None if dtype is None else _dt(dtype))


def _npi_trace(a, *, offset=0, axis1=0, axis2=1):
    return I.trace(a, offset, axis1, axis2)


def _npi_diff(a, *, n=1, axis=-1):
    return I.diff(a, n, axis)


def _npi_ediff1d(a, *extras, to_end=None, to_begin=None):
    return I.ediff1d(a, to_end, to_begin)


for _f in (_npi_std, _npi_var, _npi_argmax, _npi_argmin, _npi_average,
           _npi_norm, _npi_cumsum, _npi_trace, _npi_diff, _npi_ediff1d):
    _reg(_f.__name__, _f)


# -- array manipulation (np_matrix_op.cc) -------------------------------------

def _npi_concatenate(*arrays, axis=0, dim=None):
    return I.concatenate(arrays, dim if dim is not None else axis)


def _npi_stack(*arrays, axis=0):
    return I.stack(arrays, axis)


def _npi_vstack(*arrays):
    return I.vstack(arrays)


def _npi_hstack(*arrays):
    return I.hstack(arrays)


def _npi_dstack(*arrays):
    return I.dstack(arrays)


def _npi_column_stack(*arrays):
    return I.column_stack(arrays)


def _npi_hsplit(a, *, indices_or_sections=1):
    return tuple(I.hsplit(a, indices_or_sections))


def _npi_dsplit(a, *, indices_or_sections=1):
    return tuple(I.dsplit(a, indices_or_sections))


def _npi_flip(a, *, axis=None):
    return I.flip(a, _ax(axis))


def _npi_roll(a, *, shift=1, axis=None):
    return I.roll(a, shift, _ax(axis))


def _npi_rot90(a, *, k=1, axes=(0, 1)):
    return I.rot90(a, k, tuple(axes))


def _np_moveaxis(a, *, source, destination):
    return I.moveaxis(a, _ax(source), _ax(destination))


def _npi_rollaxis(a, *, axis, start=0):
    return I.rollaxis(a, axis, start)


def _npi_squeeze(a, *, axis=None):
    return I.squeeze(a, _ax(axis))


def _npi_transpose(a, *, axes=None):
    if axes is not None and any(x is None for x in (
            axes if isinstance(axes, (list, tuple)) else [axes])):
        axes = None
    return I.transpose(a, axes)


def _np_reshape(a, *, newshape, order="C"):
    return I.reshape(a, tuple(newshape), order)


def _npx_reshape(a, *, newshape, reverse=False, order="C"):
    """``npx.reshape``: -2 copies the remaining input dims."""
    shape = []
    src = list(a.shape)
    for i, s in enumerate(tuple(newshape)):
        if s == -2:
            shape.extend(src[i:])
            break
        shape.append(s)
    return I.reshape(a, tuple(shape), order)


def _npi_broadcast_to(a, *, shape):
    return I.broadcast_to(a, tuple(shape))


def _npi_pad(a, *, pad_width, mode="constant", constant_values=0,
             reflect_type="even"):
    return I.pad(a, tuple(tuple(p) for p in pad_width), mode,
                 constant_values)


def _npi_delete(a, *, obj, axis=None, start=None, stop=None, step=None):
    if start is not None or stop is not None or step is not None:
        obj = slice(start, stop, step)
    return I.delete(a, obj, axis)


def _npi_insert_scalar(a, *values, obj=None, axis=None, val=None):
    return I.insert(a, obj, values[0] if values else val, axis)


def _npi_insert_slice(a, *values, start=None, stop=None, step=None,
                      axis=None, val=None):
    return I.insert(a, slice(start, stop, step),
                    values[0] if values else val, axis)


def _npi_insert_tensor(a, obj, *values, axis=None, val=None):
    return I.insert(a, obj, values[0] if values else val, axis)


def _npi_repeats(a, *, repeats, axis=None):
    return I.repeat(a, repeats, axis)


def _npi_unique(a, *, return_index=False, return_inverse=False,
                return_counts=False, axis=None):
    """Eager only: the output's shape depends on the data."""
    out = I.unique(a, return_index, return_inverse, return_counts, axis)
    return out if isinstance(out, tuple) else (out,)


def _npi_bincount(a, *weights, minlength=0):
    return I.bincount(a, weights[0] if weights else None, minlength)


def _npx_nonzero(a):
    """Eager only: an (N, ndim) index array."""
    return torch.nonzero(a)


def _npi_share_memory(a, b):
    same = a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    return torch.tensor(bool(same), device=a.device)


for _f in (_npi_concatenate, _npi_stack, _npi_vstack, _npi_hstack,
           _npi_dstack, _npi_column_stack, _npi_hsplit, _npi_dsplit,
           _npi_flip, _npi_roll, _npi_rot90, _np_moveaxis, _npi_rollaxis,
           _npi_squeeze, _npi_transpose, _np_reshape, _npx_reshape,
           _npi_broadcast_to, _npi_pad, _npi_delete, _npi_insert_scalar,
           _npi_insert_slice, _npi_insert_tensor, _npi_repeats, _npi_unique,
           _npi_bincount, _npx_nonzero, _npi_share_memory):
    _reg(_f.__name__, _f,
         aliases=("_npi_concat",) if _f is _npi_concatenate else ())


# -- creation (np_init_op.cc, np_window_op.cc) --------------------------------

def _sh(shape):
    return tuple(shape) if isinstance(shape, (list, tuple)) else (shape,)


def _npi_zeros(*, shape=(), dtype=None, ctx=None):
    return torch.zeros(_sh(shape), dtype=_dt(dtype), device=_device(ctx))


def _npi_ones(*, shape=(), dtype=None, ctx=None):
    return torch.ones(_sh(shape), dtype=_dt(dtype), device=_device(ctx))


def _npi_full(*, shape=(), fill_value=0.0, dtype=None, ctx=None):
    return torch.full(_sh(shape), fill_value, dtype=_dt(dtype),
                      device=_device(ctx))


def _npi_full_like(a, *, fill_value=0.0, dtype=None, ctx=None):
    return torch.full_like(a, fill_value, dtype=_dt(dtype, a.dtype))


def _npi_identity(*, shape=None, n=None, dtype=None, ctx=None):
    k = n if n is not None else (shape[0] if isinstance(
        shape, (list, tuple)) else shape)
    return torch.eye(k, dtype=_dt(dtype), device=_device(ctx))


def _npi_eye(*, N, M=None, k=0, dtype=None, ctx=None):
    M = N if M is None else M
    return torch.ones(N, M, dtype=_dt(dtype), device=_device(ctx)).tril(
        k).triu(k)


def _npi_indices(*, dimensions, dtype=None, ctx=None):
    return I.indices(tuple(dimensions), _dt(dtype, I.int_default()),
                     device=_device(ctx))


def _npi_arange(*, start=0, stop=None, step=1, dtype=None, ctx=None):
    return I.arange(start, stop, step, None if dtype is None else
                    _dt(dtype), device=_device(ctx))


def _npi_linspace(*, start, stop, num=50, endpoint=True, dtype=None,
                  ctx=None):
    return I.linspace(start, stop, num, endpoint, dtype=_dt(dtype),
                      device=_device(ctx))


def _npi_logspace(*, start, stop, num=50, endpoint=True, base=10.0,
                  dtype=None, ctx=None):
    return I.logspace(start, stop, num, endpoint, base, _dt(dtype),
                      device=_device(ctx))


def _atl(fn):
    def op(*arrays):
        out = fn(*arrays)
        return out if isinstance(out, tuple) else (out,)
    return op


def _npi_tri(*, N, M=None, k=0, dtype=None, ctx=None):
    return I.tri(N, M, k, _dt(dtype), device=_device(ctx))


def _npi_tril(a, *, k=0):
    return torch.tril(a, k)


def _npi_triu(a, *, k=0):
    return torch.triu(a, k)


def _npi_tril_indices(*, n, k=0, m=None):
    return I.tril_indices(n, k, m, device=_device(None))


def _npi_diag(a, *, k=0):
    return I.diag(a, k)


def _npi_diagflat(a, *, k=0):
    return I.diagflat(a, k)


def _npi_diagonal(a, *, offset=0, axis1=0, axis2=1):
    return torch.diagonal(a, offset, axis1, axis2)


def _npi_diag_indices_from(a):
    return I.diag_indices_from(a)


def _npi_fill_diagonal(a, *, val=0.0, wrap=False):
    return I.fill_diagonal(a, val, wrap)


def _npi_blackman(*, M, dtype=None, ctx=None):
    return I.blackman(M, _dt(dtype), device=_device(ctx))


def _npi_hamming(*, M, dtype=None, ctx=None):
    return I.hamming(M, _dt(dtype), device=_device(ctx))


def _npi_hanning(*, M, dtype=None, ctx=None):
    return I.hanning(M, _dt(dtype), device=_device(ctx))


for _f in (_npi_zeros, _npi_ones, _npi_full, _npi_full_like, _npi_identity,
           _npi_eye, _npi_indices, _npi_arange, _npi_linspace,
           _npi_logspace, _npi_tri, _npi_tril, _npi_triu,
           _npi_tril_indices, _npi_diag, _npi_diagflat, _npi_diagonal,
           _npi_diag_indices_from, _npi_fill_diagonal, _npi_blackman,
           _npi_hamming, _npi_hanning):
    _reg(_f.__name__, _f)
for _name, _fn in (("_npi_atleast_1d", I.atleast_1d),
                   ("_npi_atleast_2d", I.atleast_2d),
                   ("_npi_atleast_3d", I.atleast_3d)):
    _reg(_name, _atl(_fn))


# -- numeric specials (np_interp_op.cc, np_percentile_op.cc, ...) -------------

def _npi_interp(x, xp, fp, *, left=None, right=None, period=None):
    return I.interp(x, xp, fp, left, right, period)


def _npi_percentile(a, *q_arr, q=None, axis=None, interpolation="linear",
                    keepdims=False):
    qq = q_arr[0] if q_arr else q
    return I.percentile(a, qq, _ax(axis), method=interpolation,
                        keepdims=keepdims)


def _npi_polyval(p, x):
    return I.polyval(p, x)


def _npi_cross(a, b, *, axisa=-1, axisb=-1, axisc=-1, axis=None):
    return I.cross(a, b, axisa, axisb, axisc, axis)


def _npi_kron(a, b):
    return I.kron(a, b)


def _npi_einsum(*operands, subscripts, optimize=0):
    return I.einsum(subscripts, *operands)


def _npi_tensordot(a, b, *, a_axes_summed=None, b_axes_summed=None,
                   axes=None):
    if a_axes_summed is not None:
        axes = (tuple(a_axes_summed), tuple(b_axes_summed))
    return I.tensordot(a, b, axes if axes is not None else 2)


def _npi_tensordot_int_axes(a, b, *, axes=2):
    return I.tensordot(a, b, int(axes))


def _np_dot(a, b):
    return I.dot(a, b)


def _npi_where(cond, x, y):
    return I.where(cond, x, y)


def _npi_where_lscalar(cond, y, *, scalar=0.0):
    return torch.where(cond.bool(), torch.as_tensor(
        scalar, dtype=y.dtype, device=y.device), y)


def _npi_where_rscalar(cond, x, *, scalar=0.0):
    return torch.where(cond.bool(), x, torch.as_tensor(
        scalar, dtype=x.dtype, device=x.device))


def _npi_where_scalar2(cond, *, x=0.0, y=0.0):
    dt = I.float_default() if isinstance(x, float) or isinstance(
        y, float) else I.int_default()
    return torch.where(cond.bool(), torch.as_tensor(x, dtype=dt,
                                                    device=cond.device),
                       torch.as_tensor(y, dtype=dt, device=cond.device))


def _npi_boolean_mask_assign_scalar(data, mask, *, value=0.0):
    return torch.where(mask.bool(), torch.as_tensor(
        value, dtype=data.dtype, device=data.device), data)


def _npi_boolean_mask_assign_tensor(data, mask, value):
    return torch.where(mask.bool(), value.to(data.dtype), data)


def _index(ind):
    ind = ind.long()
    return (ind,) if ind.dim() == 1 else tuple(ind)


def _npx_index_add(a, ind, val):
    return a.index_put(_index(ind), val.to(a.dtype), accumulate=True)


def _npx_index_update(a, ind, val):
    return a.index_put(_index(ind), val.to(a.dtype))


def _npx_constraint_check(condition, *, msg="constraint violated"):
    """The all-reduced condition (the reference checks it on the host
    when eager)."""
    return condition.bool().all()


for _f in (_npi_interp, _npi_percentile, _npi_polyval, _npi_cross,
           _npi_kron, _npi_einsum, _npi_tensordot, _npi_tensordot_int_axes,
           _np_dot, _npi_where, _npi_where_lscalar, _npi_where_rscalar,
           _npi_where_scalar2, _npi_boolean_mask_assign_scalar,
           _npi_boolean_mask_assign_tensor, _npx_index_add,
           _npx_index_update, _npx_constraint_check):
    _reg(_f.__name__, _f)


# -- numpy linalg (src/operator/numpy/linalg/) --------------------------------

def _f32(a):
    return I.inexact(a)


def _npi_cholesky(a, *, lower=True):
    L = torch.linalg.cholesky(_f32(a))
    return L if lower else L.mT


def _npi_eig(a):
    return tuple(torch.linalg.eig(_f32(a)))


def _npi_eigh(a, *, UPLO="L"):
    return tuple(torch.linalg.eigh(_f32(a), UPLO=UPLO))


def _npi_eigvals(a):
    return torch.linalg.eigvals(_f32(a))


def _npi_eigvalsh(a, *, UPLO="L"):
    return torch.linalg.eigvalsh(_f32(a), UPLO=UPLO)


def _npi_svd(a):
    return tuple(torch.linalg.svd(_f32(a), full_matrices=False))


def _npi_qr(a):
    return tuple(torch.linalg.qr(_f32(a)))


def _npi_solve(a, b):
    return torch.linalg.solve(_f32(a), _f32(b))


def _npi_lstsq(a, b, *, rcond=None):
    from ..numpy.linalg import _lstsq
    return _lstsq(a, b, rcond)


def _npi_pinv(a, *rcond_arr, hermitian=False):
    rc = rcond_arr[0] if rcond_arr else None
    return torch.linalg.pinv(_f32(a), rtol=rc, hermitian=hermitian)


def _npi_pinv_scalar_rcond(a, *, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(_f32(a), rtol=rcond, hermitian=hermitian)


def _npi_tensorinv(a, *, ind=2):
    return torch.linalg.tensorinv(_f32(a), ind=ind)


def _npi_tensorsolve(a, b, *, a_axes=None):
    return torch.linalg.tensorsolve(_f32(a), _f32(b), dims=_ax(a_axes))


def _npi_matrix_rank(a, *tol_arr, hermitian=False, finfoEps=False):
    if tol_arr:
        return torch.linalg.matrix_rank(_f32(a), atol=tol_arr[0], rtol=0.0)
    return torch.linalg.matrix_rank(_f32(a))


def _npi_matrix_rank_none_tol(a, *, hermitian=False, finfoEps=False):
    return torch.linalg.matrix_rank(_f32(a))


for _f in (_npi_cholesky, _npi_eig, _npi_eigh, _npi_eigvals,
           _npi_eigvalsh, _npi_svd, _npi_qr, _npi_solve, _npi_lstsq,
           _npi_pinv, _npi_pinv_scalar_rcond, _npi_tensorinv,
           _npi_tensorsolve, _npi_matrix_rank, _npi_matrix_rank_none_tol):
    _reg(_f.__name__, _f)
