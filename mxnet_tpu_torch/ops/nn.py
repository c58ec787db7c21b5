"""Neural-network ops on the training paths (counterpart of the part of
``mxnet_tpu/ops/nn.py`` the transformer LM and ResNet call):
``FullyConnected``, ``Convolution``, ``Pooling``, ``BatchNorm``,
``Activation``, the GELU cases of ``LeakyReLU``, the softmax family and
``LayerNorm``.  The registered ones (``FullyConnected``,
``Convolution``, ``Pooling``, ``BatchNorm``, ``Activation``, ``softmax``,
``log_softmax``, ``softmax_cross_entropy``, ``SoftmaxOutput``,
``LayerNorm``) are what ``mx.nd`` reaches; those on the AMP lists cast
their inputs under the AMP policy (``ops/registry.register``).  Plain
PyTorch (cuDNN and cuBLAS behind it on the card): the reference left
these to XLA, not to Pallas.  The layout is NCHW (channels first); the channels-last layouts
the reference also takes are not ported yet and raise."""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..base import MXNetError, torch_dtype
from .registry import register
from .tensor import float_only

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "activation", "leaky_relu", "softmax", "log_softmax",
           "softmax_cross_entropy", "softmax_output", "layer_norm",
           "safe_accumulation_enabled"]


def safe_accumulation_enabled() -> bool:
    """The ``MXNET_SAFE_ACCUMULATION`` switch (off unless set to 1)."""
    return os.environ.get("MXNET_SAFE_ACCUMULATION", "0") == "1"


def _safe_acc(x):
    """Upcast bf16/fp16 to f32 under ``MXNET_SAFE_ACCUMULATION=1``;
    returns ``(x, the type to cast results back to or None)``."""
    if safe_accumulation_enabled() and \
            x.dtype in (torch.bfloat16, torch.float16):
        return x.float(), x.dtype
    return x, None


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(x, weight, bias=None, *, num_hidden=None, no_bias=False,
                    flatten=True):
    """``x·Wᵀ + b`` with ``W (units, in_units)``; ``flatten`` folds every
    axis after the first into the input features (``mxnet_tpu/ops/
    nn.py:55``).  ``num_hidden`` is read from ``W``."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    out = torch.matmul(x, weight.t())
    if bias is not None:
        out = out + bias
    return out


def _tup(v, n):
    if v is None:
        return (1,) * n
    if isinstance(v, int):
        return (v,) * n
    t = tuple(int(x) for x in v)
    return t if len(t) == n else t * n


def _channels_first(layout, op):
    if layout and layout.endswith("C"):
        raise MXNetError(f"{op}: layout {layout!r} is not ported yet; the "
                         f"port takes channels-first layouts (NCW, NCHW, "
                         f"NCDHW)")


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=("convolution",))
def convolution(x, weight, bias=None, *, kernel, stride=None, dilate=None,
                pad=None, num_filter=None, num_group=1, no_bias=False,
                layout=None, **_ignored):
    """N-d convolution of ``x (N, C, *spatial)`` with ``weight (O, C/g,
    *kernel)``: symmetric zero padding ``pad``, ``stride``, ``dilate``
    and ``num_group`` groups (``mxnet_tpu/ops/nn.py:67-104``)."""
    _channels_first(layout, "Convolution")
    n = len(kernel)
    return _CONV[n](x, weight, bias, stride=_tup(stride, n),
                    padding=_tup(pad, n) if pad is not None else 0,
                    dilation=_tup(dilate, n), groups=num_group)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _avg_pool(x, *args, **kw):
    """``avg_pool{1,2,3}d``; torch's host kernel for 3-D takes no bf16 or
    f16, so there it runs in f32 and casts back."""
    n = x.dim() - 2
    if n == 3 and x.device.type == "cpu" and x.element_size() < 4:
        return _AVG_POOL[n](x.float(), *args, **kw).to(x.dtype)
    return _AVG_POOL[n](x, *args, **kw)


def _pool_pads(x, k, s, p, convention):
    """Each spatial axis's (low, high) padding: ``valid`` pads ``p`` on
    both sides; ``full`` adds on the high side what a last window needs
    (the output size rounds up); ``same`` keeps ceil(size / stride)."""
    pads = []
    for i in range(len(k)):
        size = x.shape[2 + i]
        if convention == "full":
            inp = size + 2 * p[i]
            out = -(-(inp - k[i]) // s[i]) + 1
            pads.append((p[i], p[i] + max((out - 1) * s[i] + k[i] - inp, 0)))
        elif convention == "same":
            out = -(-size // s[i])
            need = max((out - 1) * s[i] + k[i] - size, 0)
            pads.append((need // 2, need - need // 2))
        else:
            pads.append((p[i], p[i]))
    return pads


def _padded(x, pads, value):
    flat = [q for lo_hi in reversed(pads) for q in lo_hi]
    return F.pad(x, flat, value=value) if any(flat) else x


@register("Pooling", aliases=("pooling",))
def pooling(x, *, kernel=(), pool_type="max", global_pool=False, stride=None,
            pad=None, pooling_convention="valid", count_include_pad=True,
            p_value=2, cudnn_off=False, layout=None, **_ignored):
    """Max, average, sum or Lp pooling over the spatial axes of ``x (N, C,
    *spatial)`` (``mxnet_tpu/ops/nn.py:180-250``).  Max pooling pads with
    -inf; the average divides by the window's size (``count_include_pad``)
    or by its count of unpadded elements; ``pooling_convention="full"``
    rounds the output size up; ``global_pool`` reduces every spatial axis
    and keeps it as size 1."""
    _channels_first(layout, "Pooling")
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError(f"unknown pool_type {pool_type}")
    if global_pool:
        axes = tuple(range(2, x.dim()))
        if pool_type == "max":
            return x.amax(dim=axes, keepdim=True)
        if pool_type == "sum":
            return x.sum(dim=axes, keepdim=True)
        if pool_type == "lp":
            return (x.abs() ** p_value).sum(dim=axes, keepdim=True) ** (
                1.0 / p_value)
        return x.mean(dim=axes, keepdim=True)
    n = x.dim() - 2
    k = _tup(kernel, n)
    s = _tup(stride, n) if stride is not None else k
    p = _tup(pad, n) if pad is not None else (0,) * n
    pads = _pool_pads(x, k, s, p, pooling_convention)
    symmetric = all(lo == hi and 2 * lo <= ki for (lo, hi), ki in zip(pads, k))
    if pool_type == "max":
        if symmetric:        # torch pads max pooling with -inf itself
            return _MAX_POOL[n](x, k, s, [lo for lo, _ in pads])
        return _MAX_POOL[n](_padded(x, pads, float("-inf")), k, s)
    src = x.abs() ** p_value if pool_type == "lp" else x
    if pool_type == "avg" and symmetric:
        return _avg_pool(src, k, s, [lo for lo, _ in pads],
                         count_include_pad=count_include_pad)
    # a sum over the zero-padded windows: the average over padded windows
    # of a padded input times the window's size
    summed = _avg_pool(_padded(src, pads, 0.0), k, s) * math.prod(k)
    if pool_type == "sum":
        return summed
    if pool_type == "lp":
        return summed ** (1.0 / p_value)
    if count_include_pad:
        return summed / math.prod(k)
    ones = _padded(torch.ones_like(x[:1, :1]), pads, 0.0)
    return summed / (_avg_pool(ones, k, s) * math.prod(k))


@register("BatchNorm", aliases=("batch_norm",))
def batch_norm(x, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               use_batch_stats=False, **_ignored):
    """Batch normalisation over every axis but ``axis``
    (``mxnet_tpu/ops/nn.py:376-396``).  Returns ``(out, mean, var)``:
    the statistics the normalisation used, so that the Gluon layer can
    fold them into its running averages.  Under ``use_batch_stats`` (and
    not ``use_global_stats``) they are the batch's, with the population
    variance, in ``x``'s type and without gradient; else the moving
    ones.  ``fix_gamma`` normalises with a scale of ones.

    The batch path is ``torch.native_batch_norm`` (the native CUDA
    kernels on the card: cuDNN's batch norm refuses a bf16 NCHW input,
    ``tools/resnet_bn_ab.py``), which returns the mean and
    1/sqrt(var + eps); where those come in f32 or wider (always on the
    card) the variance is taken from the latter, else (bf16 on the host)
    it is computed again from ``x``."""
    if axis % x.dim() != 1:
        out, mean, var = batch_norm(
            x.movedim(axis, 1), gamma, beta, moving_mean, moving_var,
            eps=eps, fix_gamma=fix_gamma, use_global_stats=use_global_stats,
            use_batch_stats=use_batch_stats)
        return out.movedim(1, axis), mean, var
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if use_batch_stats and not use_global_stats:
        out, mean, invstd = torch.native_batch_norm(
            x, g, beta, None, None, True, 0.0, eps)
        with torch.no_grad():
            if invstd.element_size() >= 4:
                var = invstd.pow(-2) - eps
            else:
                var, mean = torch.var_mean(
                    x, dim=[d for d in range(x.dim()) if d != 1],
                    correction=0)
        return out, mean.detach().to(x.dtype), var.to(x.dtype)
    out = F.batch_norm(x, moving_mean, moving_var, g, beta, training=False,
                       eps=eps)
    return out, moving_mean, moving_var


def _promoting(fn):
    """``fn`` on integer input promoted to float32, as jnp promotes it."""
    return lambda x: fn(x if x.is_floating_point() else x.float())


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": float_only("sigmoid", torch.sigmoid),
    "tanh": torch.tanh,
    "softrelu": _promoting(F.softplus),
    "softsign": _promoting(F.softsign),
    "log_sigmoid": _promoting(F.logsigmoid),
    "mish": _promoting(lambda x: x * torch.tanh(F.softplus(x))),
}


@register("Activation", aliases=("activation",))
def activation(x, *, act_type):
    """``act_type`` applied elementwise (``mxnet_tpu/ops/nn.py:278``);
    sigmoid refuses integer input, as the reference's does."""
    try:
        fn = _ACTIVATIONS[act_type]
    except KeyError:
        raise ValueError(f"unknown act_type {act_type}") from None
    return fn(x)


def leaky_relu(x, *, act_type):
    """The GELU cases of ``LeakyReLU``: ``gelu`` is the exact erf form,
    ``gelu_tanh`` the tanh approximation."""
    if act_type == "gelu":
        return F.gelu(x)
    if act_type == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"act_type {act_type!r} is not ported yet")


@register("log_softmax")
def log_softmax(x, *, axis=-1):
    """Log-softmax over ``axis``; in f32 under safe accumulation."""
    xa, low = _safe_acc(x)
    out = torch.log_softmax(xa, dim=axis)
    return out.to(low) if low is not None else out


@register("softmax")
def softmax(x, length=None, *, axis=-1, temperature=None, use_length=False,
            dtype=None):
    """Softmax over ``axis`` (``mxnet_tpu/ops/nn.py:321``), divided by
    ``temperature`` first; with ``use_length``, only the first
    ``length`` entries along ``axis`` take part and the rest are 0.  In
    f32 under safe accumulation, cast back to the input's type unless
    ``dtype`` names another."""
    x, low = _safe_acc(x)
    if dtype is None and low is not None:
        dtype = low
    if temperature and temperature != 1.0:
        x = x / temperature
    if use_length and length is not None:
        shape = [1] * x.dim()
        shape[axis] = -1
        steps = torch.arange(x.shape[axis], device=x.device).reshape(shape)
        mask = steps < length.unsqueeze(axis % x.dim())
        out = torch.softmax(x.masked_fill(~mask, float("-inf")), dim=axis)
        out = out.masked_fill(~mask, 0.0)
    else:
        out = torch.softmax(x, dim=axis)
    return out.to(torch_dtype(dtype)) if dtype is not None else out


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """``-Σ log softmax(data)[label]`` summed over the batch
    (``mxnet_tpu/ops/nn.py:358``); float labels are cast to integers."""
    logp = torch.log_softmax(data, dim=-1)
    return -logp.gather(-1, label.long().unsqueeze(-1)).sum()


@register("SoftmaxOutput", aliases=("softmax_output",))
def softmax_output(data, label, *, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """The softmax of ``data`` over axis 1 (``multi_output``) or the last
    (``mxnet_tpu/ops/nn.py:365``).  As in the reference the label takes
    no part in the forward, and the gradient is autograd's of the
    softmax."""
    return torch.softmax(data, dim=1 if multi_output else -1)


@register("LayerNorm", aliases=("layer_norm",))
def layer_norm(x, gamma, beta, *, axis=-1, eps=1e-5):
    """Normalise over ``axis`` with the population variance; the whole
    normalisation runs in f32 under safe accumulation, else in x's
    type, as in the reference."""
    xa, low = _safe_acc(x)
    mean = xa.mean(dim=axis, keepdim=True)
    var = (xa - mean).square().mean(dim=axis, keepdim=True)
    xn = (xa - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.dim()
    shape[axis] = -1
    out = xn * gamma.reshape(shape) + beta.reshape(shape)
    return out.to(low) if low is not None else out
