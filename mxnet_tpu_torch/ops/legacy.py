"""Legacy operator names (counterpart of ``mxnet_tpu/ops/legacy.py``).

The op names that symbol json written by MXNet 1.x uses, and that the
reference registers beside its public ops: the scalar variants the rest
of the ``_plus_scalar`` family lacked (``_maximum_scalar``,
``_hypot_scalar``, the logical ones), the underscore binary forms
(``_maximum``, ``_minimum``, ``_hypot``, ``_logical_*``), creation ops
(``_zeros``, ``_ones``, ``_full``, ``_eye``, ``_arange``,
``_linspace``), ``add_n`` / ``ElementWiseSum``, ``reshape_like``,
``moments``, ``argmax_channel``, ``im2col`` / ``col2im``, the AMP casts
and multi-tensor utilities, the regression outputs (identity or sigmoid
forward; a backward that injects ``grad_scale · (out - label)``, as
``regression_output-inl.h``), ``Crop``, ``SoftmaxActivation``, and the
old layer ops the reference keeps in ``ops/nn.py`` (``UpSampling``,
``LRN``, ``MakeLoss``, ``BlockGrad``).  Plain PyTorch.

A creation op places its output on ``ctx`` when given, else on the
device a symbol executor lowers its graph to (:func:`lowering_device`;
``meta`` for shape inference), else on the current context's device.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from ..base import torch_dtype
from .registry import alias, register
from .tensor import _scalar_like

__all__ = ["lowering_device"]

_TLS = threading.local()


@contextlib.contextmanager
def lowering_device(device):
    """Inside: creation ops with no ``ctx`` make their output on
    ``device`` (a symbol executor's device, or ``meta``)."""
    old = getattr(_TLS, "device", None)
    _TLS.device = torch.device(device)
    try:
        yield
    finally:
        _TLS.device = old


def _device(ctx):
    if ctx is not None:
        from ..context import Context
        if isinstance(ctx, Context):
            return ctx.torch_device
        return torch.device(ctx)
    dev = getattr(_TLS, "device", None)
    if dev is not None:
        return dev
    from ..context import current_context
    return current_context().torch_device


def _dt(dtype):
    return torch_dtype(dtype) if dtype is not None else torch.float32


def _shape(shape):
    return tuple(shape) if isinstance(shape, (list, tuple)) else (shape,)


# -- the scalar variants the tensor module's table lacks ---------------------

_LOGIC = (torch.logical_and, torch.logical_or, torch.logical_xor)

for _name, _fn in (("_maximum_scalar", torch.maximum),
                   ("_minimum_scalar", torch.minimum),
                   ("_hypot_scalar", torch.hypot),
                   ("_logical_and_scalar", torch.logical_and),
                   ("_logical_or_scalar", torch.logical_or),
                   ("_logical_xor_scalar", torch.logical_xor),
                   # the sparse-storage variants are dense here
                   ("_scatter_plus_scalar", torch.add),
                   ("_scatter_minus_scalar", torch.sub)):
    def _scalar_op(a, *, scalar=0.0, _f=_fn):
        out = _f(a, _scalar_like(a, scalar))
        return out.to(a.dtype) if _f in _LOGIC else out
    _scalar_op.__name__ = _name
    register(_name)(_scalar_op)


@register("_scatter_elemwise_div")
def _scatter_elemwise_div(a, b):
    return torch.div(a, b)


@register("_maximum")
def _maximum(a, b):
    return torch.maximum(a, b)


@register("_minimum")
def _minimum(a, b):
    return torch.minimum(a, b)


@register("_hypot")
def _hypot(a, b):
    return torch.hypot(a, b)


for _pub in ("logical_and", "logical_or", "logical_xor"):
    alias(_pub, "_" + _pub)
alias("split_v2", "_split_v2")


@register("_copy")
def _copy(a):
    return a.clone()


@register("_grad_add")
def _grad_add(a, b):
    return a + b


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    return lhs


@register("reshape_like")
def reshape_like(lhs, rhs, *, lhs_begin=None, lhs_end=None, rhs_begin=None,
                 rhs_end=None):
    if lhs_begin is None and rhs_begin is None:
        return lhs.reshape(rhs.shape)
    lb = lhs_begin or 0
    le = lhs_end if lhs_end is not None else lhs.dim()
    rb = rhs_begin or 0
    re_ = rhs_end if rhs_end is not None else rhs.dim()
    return lhs.reshape(tuple(lhs.shape[:lb]) + tuple(rhs.shape[rb:re_])
                       + tuple(lhs.shape[le:]))


# -- creation (init_op.cc) ---------------------------------------------------

@register("_zeros")
def _zeros(*, shape=(), dtype=None, ctx=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_device(ctx))


@register("_zeros_without_dtype")
def _zeros_without_dtype(*, shape=(), ctx=None, dtype=None):
    return torch.zeros(_shape(shape), dtype=_dt(dtype), device=_device(ctx))


@register("_ones")
def _ones(*, shape=(), dtype=None, ctx=None):
    return torch.ones(_shape(shape), dtype=_dt(dtype), device=_device(ctx))


@register("_full")
def _full(*, shape=(), value=0.0, dtype=None, ctx=None):
    return torch.full(_shape(shape), value, dtype=_dt(dtype),
                      device=_device(ctx))


@register("_eye")
def _eye(*, N, M=0, k=0, dtype=None, ctx=None):
    ones = torch.ones((N, M or N), dtype=_dt(dtype), device=_device(ctx))
    return ones.tril(k).triu(k)


@register("_arange")
def _arange(*, start=0, stop=None, step=1.0, repeat=1, dtype=None,
            ctx=None, infer_range=False):
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=_dt(dtype),
                       device=_device(ctx))
    return out.repeat_interleave(repeat) if repeat > 1 else out


@register("_linspace")
def _linspace(*, start, stop, num, endpoint=True, dtype=None, ctx=None):
    if endpoint:
        return torch.linspace(start, stop, num, dtype=_dt(dtype),
                              device=_device(ctx))
    return torch.linspace(start, stop, num + 1, dtype=_dt(dtype),
                          device=_device(ctx))[:num]


# -- tensor utilities ---------------------------------------------------------

@register("add_n", aliases=("ElementWiseSum", "_sum_of_arrays"))
def add_n(*arrays, num_args=None):
    out = arrays[0]
    for a in arrays[1:]:
        out = out + a
    return out


def _axes(axes):
    if axes is None:
        return None
    return tuple(axes) if isinstance(axes, (list, tuple)) else (axes,)


@register("moments")
def moments(data, *, axes=None, keepdims=False):
    dims = _axes(axes)
    var, mean = torch.var_mean(data, dim=dims, correction=0,
                               keepdim=keepdims)
    return mean, var


@register("hard_sigmoid")
def hard_sigmoid(data, *, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("argmax_channel")
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(data.dtype)


@register("batch_take")
def batch_take(a, indices):
    idx = indices.long()
    return torch.take_along_dim(a, idx[:, None], dim=1)[:, 0]


@register("_unravel_index", aliases=("unravel_index",))
def _unravel_index(indices, *, shape):
    rest = indices.long()
    coords = []
    for s in reversed(tuple(shape)):
        coords.append(rest % s)
        rest = torch.div(rest, s, rounding_mode="floor")
    return torch.stack(coords[::-1], dim=0).to(indices.dtype)


@register("_ravel_multi_index", aliases=("ravel_multi_index",))
def _ravel_multi_index(coords, *, shape):
    flat = torch.zeros(coords.shape[1:], dtype=coords.dtype,
                       device=coords.device)
    stride = 1
    for i in reversed(range(len(shape))):
        flat = flat + coords[i] * stride
        stride *= int(shape[i])
    return flat


@register("_square_sum")
def _square_sum(a, *, axis=None, keepdims=False):
    dims = _axes(axis)
    return torch.sum(torch.square(a), dim=dims, keepdim=keepdims)


@register("_sparse_retain")
def _sparse_retain(data, indices):
    """Dense analogue: the rows not in ``indices`` zeroed (the reference
    keeps only those rows of a row_sparse array, ``sparse_retain.cc``)."""
    mask = torch.zeros((data.shape[0],), dtype=torch.bool,
                       device=data.device)
    mask[indices.long()] = True
    return torch.where(mask.reshape((-1,) + (1,) * (data.dim() - 1)),
                       data, torch.zeros((), dtype=data.dtype,
                                         device=data.device))


def _slices(begin, end, step):
    return tuple(slice(b, e, s) for b, e, s in zip(
        begin, end, step or (None,) * len(begin)))


@register("_slice_assign")
def _slice_assign(data, value, *, begin, end, step=None):
    out = data.clone()
    out[_slices(begin, end, step)] = value
    return out


@register("_slice_assign_scalar")
def _slice_assign_scalar(data, *, scalar=0.0, begin=(), end=(), step=None):
    out = data.clone()
    out[_slices(begin, end, step)] = scalar
    return out


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, indices, *, shape=None):
    """``lhs`` as it is, as in the reference."""
    return lhs


# -- im2col / col2im (matrix_op.cc) ------------------------------------------

@register("im2col")
def im2col(data, *, kernel, stride=(1, 1), dilate=(1, 1), pad=(0, 0)):
    """(N, C·kh·kw, out_h·out_w), channel-major then kernel position."""
    return F.unfold(data, tuple(kernel), dilation=tuple(dilate),
                    padding=tuple(pad), stride=tuple(stride))


@register("col2im")
def col2im(col, *, input_size, kernel, stride=(1, 1), dilate=(1, 1),
           pad=(0, 0)):
    return F.fold(col, (int(input_size[-2]), int(input_size[-1])),
                  tuple(kernel), dilation=tuple(dilate), padding=tuple(pad),
                  stride=tuple(stride))


# -- AMP casts (amp_cast.cc) and multi-tensor utilities ----------------------

@register("amp_cast")
def amp_cast(data, *, dtype):
    return data.to(torch_dtype(dtype))


_WIDTH = {torch.float16: 16, torch.bfloat16: 16, torch.float32: 32,
          torch.float64: 64}


@register("amp_multicast")
def amp_multicast(*arrays, num_outputs=None, cast_narrow=False):
    """Every input cast to the widest (``cast_narrow``: narrowest) float
    type among them."""
    pick = (min if cast_narrow else max)(
        [a.dtype for a in arrays], key=lambda d: _WIDTH.get(d, 32))
    return tuple(a.to(pick) for a in arrays)


@register("all_finite")
def all_finite(data, *, init_output=True):
    return torch.isfinite(data).all().to(torch.float32).reshape(1)


@register("multi_all_finite")
def multi_all_finite(*arrays, num_arrays=None, init_output=True):
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a).all()
    return ok.to(torch.float32).reshape(1)


@register("multi_sum_sq")
def multi_sum_sq(*arrays, num_arrays=None):
    return tuple(torch.sum(torch.square(a)).reshape(1) for a in arrays)


@register("reset_arrays")
def reset_arrays(*arrays, num_arrays=None):
    return tuple(torch.zeros_like(a) for a in arrays)


@register("multi_lars")
def multi_lars(lrs, weights_sum_sq, grads_sum_sq, wds, *, eta=0.001,
               eps=1e-8, rescale_grad=1.0):
    """LARS local learning rates over stacked per-tensor norms
    (``contrib/multi_lars.cc``)."""
    w_norm = torch.sqrt(weights_sum_sq)
    g_norm = torch.sqrt(grads_sum_sq) * rescale_grad
    trust = torch.where((w_norm > 0) & (g_norm > 0),
                        eta * w_norm / (g_norm + wds * w_norm + eps),
                        torch.ones_like(w_norm))
    return lrs * trust


# -- the remaining legacy layer ops ------------------------------------------

@register("SoftmaxActivation")
def softmax_activation(data, *, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


@register("IdentityAttachKLSparseReg")
def identity_attach_kl_sparse_reg(data, *, sparseness_target=0.1,
                                  penalty=0.001, momentum=0.9):
    return data


@register("_rnn_param_concat")
def _rnn_param_concat(*arrays, dim=0, num_args=None):
    return torch.cat([a.reshape(-1) for a in arrays], dim=0)


@register("_histogram")
def _histogram(data, *bins_arr, bin_cnt=None, range=None):
    """``(counts, edges)``, both float32 as the reference's (``jnp.
    histogram``): explicit edges as a second input, or
    ``bin_cnt`` bins over ``range`` (default: the data's min and max);
    the last bin is closed, as ``numpy.histogram``'s."""
    x = data.reshape(-1)
    if bins_arr:
        edges = bins_arr[0]
    else:
        lo, hi = (range if range is not None
                  else (float(x.min()), float(x.max())))
        edges = torch.linspace(lo, hi, (bin_cnt or 10) + 1,
                               dtype=torch.float32, device=x.device)
    n = edges.shape[0] - 1
    xe = x.to(edges.dtype)
    idx = torch.searchsorted(edges, xe, right=True) - 1
    idx = torch.where(xe == edges[-1], n - 1, idx)
    inside = (xe >= edges[0]) & (xe <= edges[-1])
    counts = torch.bincount(idx[inside], minlength=n)[:n]
    return counts.to(torch.float32), edges


class _RegressionOutput(torch.autograd.Function):
    """Forward ``fwd(data)``; backward ``grad_scale / num_output ·
    bwd(out, label)`` into ``data`` whatever the incoming gradient, the
    label none (``regression_output-inl.h``)."""

    @staticmethod
    def forward(ctx, data, label, fwd, bwd, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.bwd, ctx.grad_scale = bwd, grad_scale
        return out

    @staticmethod
    def backward(ctx, _g):
        out, label = ctx.saved_tensors
        num_output = label.numel() // label.shape[0] if label.dim() else 1
        scale = ctx.grad_scale / num_output
        dd = ctx.bwd(out, label.reshape(out.shape)) * scale
        return dd.to(out.dtype), torch.zeros_like(label), None, None, None


def _regression_output(fwd, bwd):
    def op(data, label, *, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, fwd, bwd,
                                       float(grad_scale))
    return op


register("LinearRegressionOutput", aliases=("linear_regression_output",))(
    _regression_output(lambda d: d.clone(), lambda o, l: o - l))
register("MAERegressionOutput", aliases=("mae_regression_output",))(
    _regression_output(lambda d: d.clone(), lambda o, l: torch.sign(o - l)))
register("LogisticRegressionOutput",
         aliases=("logistic_regression_output",))(
    _regression_output(torch.sigmoid, lambda o, l: o - l))


@register("Crop")
def _crop(*inputs, num_args=None, offset=(0, 0), h_w=(0, 0),
          center_crop=False):
    """Crop input 0 (N, C, H, W) to the size of input 1 or to ``h_w``;
    ``center_crop`` centres the window, else ``offset`` = (y, x)
    (``src/operator/crop.cc``)."""
    data = inputs[0]
    if len(inputs) > 1:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = h_w
        if th <= 0 or tw <= 0:
            raise ValueError("Crop needs a crop_like input or h_w")
    h, w = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (h - th) // 2, (w - tw) // 2
    else:
        y0, x0 = offset
    if y0 + th > h or x0 + tw > w:
        raise ValueError(f"crop window ({y0}:{y0 + th}, {x0}:{x0 + tw}) "
                         f"exceeds input ({h}, {w})")
    return data[:, :, y0:y0 + th, x0:x0 + tw]


@register("UpSampling")
def _upsampling(x, *args, scale=2, sample_type="nearest", num_args=1,
                **_ignored):
    """``scale``× along H and W: nearest (each pixel repeated) or
    bilinear with half-pixel centres, as ``jax.image.resize``."""
    if sample_type == "nearest":
        return x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                   dim=3)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)


@register("LRN")
def _lrn(x, *, nsize, alpha=1e-4, beta=0.75, knorm=2.0):
    sq = torch.square(x)
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    acc = sum(padded[:, i:i + x.shape[1]] for i in range(nsize))
    return x / torch.pow(knorm + (alpha / nsize) * acc, beta)


@register("MakeLoss", aliases=("make_loss",))
def _make_loss(x, *, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    return x


@register("BlockGrad", aliases=("stop_gradient",))
def _block_grad(x):
    return x.detach()
