"""Neural-network ops on the training paths (counterpart of the part of
``mxnet_tpu/ops/nn.py`` the transformer LM and ResNet call):
``FullyConnected``, ``Convolution``, ``Pooling``, ``BatchNorm``,
``Activation``, the GELU cases of ``LeakyReLU``, the softmax family and
``LayerNorm``, and ``sync_batch_norm``, BatchNorm over a batch split
over ranks.  The registered ones (``FullyConnected``,
``Convolution``, ``Pooling``, ``BatchNorm``, ``Activation``, ``softmax``,
``log_softmax``, ``softmax_cross_entropy``, ``SoftmaxOutput``,
``LayerNorm``, ``CTCLoss``) are what ``mx.nd`` reaches; those on the AMP
lists cast their inputs under the AMP policy (``ops/registry.register``).  Plain
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
           "sync_batch_norm",
           "activation", "leaky_relu", "softmax", "log_softmax",
           "softmax_cross_entropy", "softmax_output", "layer_norm",
           "ctc_loss", "safe_accumulation_enabled"]


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
    out = [(x.shape[2 + i] + lo + hi - k[i]) // s[i] + 1
           for i, (lo, hi) in enumerate(pads)]
    if min(out) <= 0:
        # a window larger than the padded input: no output along that
        # axis, as the reference's reduce_window gives (torch raises)
        return x.new_empty(tuple(x.shape[:2]) + tuple(max(o, 0)
                                                      for o in out))
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


class _SyncBatchNorm(torch.autograd.Function):
    """The normalisation of ``sync_batch_norm`` on ``x`` of shape
    ``(shards, ...)``, the channels on dim ``c``; f32 inside (f64 for
    f64 input), ``x``'s type out.  Three calls of the reducer: the sums
    of x and of (x - mean)² in the forward, those of dy and dy·x̂ (one
    call) in the backward.  dγ and dβ are this process's sums (the trainer reduces a
    replicated parameter's gradient over the data axes itself); dx reads
    the global ones."""

    @staticmethod
    def forward(ctx, x, gamma, beta, reducer, c, eps):
        red = [d for d in range(1, x.dim()) if d != c]
        shape = [1] * x.dim()
        shape[c] = -1
        count = x.numel() // (x.shape[0] * x.shape[c]) * reducer.shards
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        mean = reducer.sum(xf.sum(red)) / count
        d = xf - mean.view(shape)
        var = reducer.sum((d * d).sum(red)) / count
        invstd = torch.rsqrt(var + eps)
        scale = invstd * gamma.to(acc)
        out = (d * scale.view(shape) + beta.to(acc).view(shape)).to(x.dtype)
        ctx.save_for_backward(x, gamma, mean, invstd)
        ctx.reducer, ctx.c, ctx.red, ctx.count = reducer, c, red, count
        ctx.beta_dtype = beta.dtype
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, gamma, mean, invstd = ctx.saved_tensors
        red, count = ctx.red, ctx.count
        shape = [1] * x.dim()
        shape[ctx.c] = -1
        acc = mean.dtype
        xhat = (x.to(acc) - mean.view(shape)) * invstd.view(shape)
        dyf = dy.to(acc)
        sdy = dyf.sum(red)
        sdyx = (dyf * xhat).sum(red)
        tot = ctx.reducer.sum(torch.stack([sdy, sdyx], dim=1))
        dx = (dyf - (tot[0] / count).view(shape)
              - xhat * (tot[1] / count).view(shape)) * \
            (invstd * gamma.to(acc)).view(shape)
        dgamma = (sdyx.sum(0).to(gamma.dtype)
                  if ctx.needs_input_grad[1] else None)
        dbeta = (sdy.sum(0).to(ctx.beta_dtype)
                 if ctx.needs_input_grad[2] else None)
        return dx.to(x.dtype), dgamma, dbeta, None, None, None


def sync_batch_norm(x, gamma, beta, reducer, *, eps=1e-3, fix_gamma=True,
                    axis=1):
    """Batch normalisation with the statistics of a batch split over
    ranks (``reducer``: ``parallel.collectives.BatchReducer`` over the
    axes that split it), or of ``reducer.shards`` shards stacked on
    ``x``'s leading axis (``FoldedReducer``): the reference's
    ``BatchNorm`` under a dp mesh, where GSPMD makes the batch reduction
    global (``mxnet_tpu/ops/nn.py:376-398``).  ``axis`` is the channel
    axis of one shard.  Returns ``(out, mean, var)`` as
    :func:`batch_norm` does under ``use_batch_stats``.

    Two passes, as ``jnp.mean`` and ``jnp.var``: the mean from the
    all-reduced f32 sums, then the population variance from the
    all-reduced f32 sums of (x - mean)².  The normalisation takes them in
    f32; the returned statistics are rounded to ``x``'s type, the type
    the forward sees them in.  The same torch ops on the CPU and on the
    card (torch's own sync-BN ops have no CPU kernel)."""
    lead = 1 if reducer.folded else 0
    xs = x if lead else x.unsqueeze(0)
    c = axis % (x.dim() - lead) + 1
    g = torch.ones_like(gamma) if fix_gamma else gamma
    out, mean, var = _SyncBatchNorm.apply(xs, g, beta, reducer, c, eps)
    if not lead:
        out = out.squeeze(0)
    return out, mean.to(x.dtype), var.to(x.dtype)


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


@register("LeakyReLU")
def leaky_relu(x, gamma=None, *, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """``LeakyReLU``'s activations (``mxnet_tpu/ops/nn.py:297-316``):
    ``leaky`` (``slope·x`` below 0), ``prelu`` (a learned slope per
    channel, ``gamma``, on axis 1), ``elu``, ``selu``, ``gelu`` (the
    exact erf form), ``gelu_tanh`` (the tanh approximation) and ``rrelu``
    (the mean slope, as in evaluation)."""
    if act_type == "leaky":
        return torch.where(x > 0, x, slope * x)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (x.dim() - 2)) \
            if x.dim() > 1 else gamma
        return torch.where(x > 0, x, g * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        alpha, lam = 1.6732632423543772, 1.0507009873554805
        return lam * torch.where(x > 0, x, alpha * torch.expm1(x))
    if act_type == "gelu":
        return F.gelu(x)
    if act_type == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if act_type == "rrelu":
        return torch.where(x > 0, x, 0.5 * (lower_bound + upper_bound) * x)
    raise ValueError(f"unknown act_type {act_type}")


@register("GroupNorm", aliases=("group_norm",))
def group_norm(x, gamma, beta, *, num_groups=1, eps=1e-5,
               output_mean_var=False):
    """Normalisation over each group of ``num_groups`` channel groups
    and the spatial axes (``mxnet_tpu/ops/nn.py:418-428``), population
    variance; ``gamma`` and ``beta`` per channel."""
    n, c = x.shape[:2]
    xg = x.reshape((n, num_groups, c // num_groups) + tuple(x.shape[2:]))
    red = tuple(range(2, xg.dim()))
    mean = xg.mean(dim=red, keepdim=True)
    var = (xg - mean).square().mean(dim=red, keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return xn * gamma.reshape(shape) + beta.reshape(shape)


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


@register("Dropout", aliases=("dropout",))
def dropout(x, *, p=0.5, mode="training", axes=()):
    """Each element of ``x`` zeroed with probability ``p`` and the
    survivors scaled by ``1/(1-p)`` (``mxnet_tpu/ops/nn.py:448-458``);
    the mask is shared along ``axes`` (size 1 there, broadcast).  Mode
    ``"training"`` drops only in training mode
    (``autograd.is_training()``), ``"always"`` always.  The mask comes
    from ``mx.random`` (``ops/random.py``: the device's generator, or the
    enclosing trace's draws), never from torch's global generator.  In a
    meshed step whose batch is split over ranks, the whole batch's mask
    is drawn and this rank keeps its part
    (``tensor_parallel.batch_shards``)."""
    from .. import autograd as ag
    from ..parallel import tensor_parallel as _tp
    from . import random as _rng
    if p <= 0 or (mode != "always" and not ag.is_training()):
        return x
    keep = 1.0 - p
    shape = [1 if i in {a % x.dim() for a in axes} else n
             for i, n in enumerate(x.shape)]
    shards = [(d, k, i) for d, k, i in _tp.batch_shards(x.dim())
              if shape[d] != 1]
    whole = list(shape)
    for d, k, _ in shards:
        whole[d] *= k
    mask = _rng.draw(lambda g: torch.rand(
        tuple(whole), generator=g, device=x.device) < keep, x.device)
    for d, _, i in shards:
        mask = mask.narrow(d, i * shape[d], shape[d])
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


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


class _LogAddExp(torch.autograd.Function):
    """``log(eᵃ + eᵇ)`` with the reference's derivative (``jnp.logaddexp``'s
    ``e^(a − out)``, ``e^(b − out)``): where both terms are the ``-1e30``
    that stands for −∞, ``out`` rounds to ``-1e30`` and each term's
    derivative is 1, not ½, as the reference's CTC gradients have it."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_CTC_NEG_INF = -1e30


@register("CTCLoss", aliases=("ctc_loss",))
def ctc_loss(data, label, data_lengths=None, label_lengths=None, *,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Connectionist temporal classification loss, one value a sequence
    (``mxnet_tpu/ops/nn.py:472-525``): ``data`` (T, N, C) activations
    (log-softmaxed here), ``label`` (N, L).  The blank is class 0
    (``"first"``) or C−1 (``"last"``); without ``use_label_lengths`` a
    label's length is its count of entries ≥ 0 (padding is < 0).

    The reference's recursion over the extended labels in log space, in
    torch on either device (a loop over T of a few (N, 2L+1) ops): its
    ``-1e30`` stands for −∞, so an unreachable alignment costs about
    1e30 (``F.ctc_loss`` gives ``inf``), an empty label reads the
    blank-only path twice (``−log 2`` below the true loss), and the
    gradients are those of its ``logaddexp`` (:class:`_LogAddExp`).
    ``F.ctc_loss`` agrees with it only where those cases are absent, so
    it is not the port's path; ``chip_smoke.py`` times it beside this
    one.  On the AMP fp32 list: the inputs are cast to f32 under the
    AMP policy."""
    T, N, C = data.shape
    logp = torch.log_softmax(data, -1)
    blank = 0 if blank_label == "first" else C - 1
    lab = label.to(torch.int64)
    L = lab.shape[1]
    S = 2 * L + 1
    dev = data.device
    ext = torch.full((N, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.to(torch.int64)
    else:
        lab_len = (lab >= 0).sum(1)
    ext_len = 2 * lab_len + 1
    if use_data_lengths and data_lengths is not None:
        data_len = data_lengths.to(torch.int64)
    else:
        data_len = torch.full((N,), T, dtype=torch.int64, device=dev)
    # a negative label wraps as the reference's take_along_axis does
    gidx = torch.where(ext < 0, ext + C, ext).clamp(0, C - 1)
    probs = logp.gather(2, gidx[None].expand(T, N, S))        # (T, N, S)
    neg = torch.full((N, S), _CTC_NEG_INF, dtype=logp.dtype, device=dev)
    cols = [probs[0, :, :1]]
    if S > 1:
        cols.append(torch.where(ext_len > 1, probs[0, :, 1],
                                neg[:, 1])[:, None])
        cols.append(neg[:, 2:])
    alpha = torch.cat(cols, 1)
    before = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], 1)
    can_skip = ((torch.arange(S, device=dev) % 2 == 1)[None, :]
                & (ext != before))
    lae = _LogAddExp.apply
    for t in range(1, T):
        s1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        s2 = torch.cat([neg[:, :2], alpha[:, :-2]], 1)[:, :S]
        a = lae(alpha, s1)
        a = torch.where(can_skip, lae(a, s2), a)
        alpha = torch.where((t < data_len)[:, None], a + probs[t], alpha)
    last = (ext_len - 1).clamp(0, S - 1)[:, None]
    prev = (ext_len - 2).clamp(0, S - 1)[:, None]
    return -lae(alpha.gather(1, last)[:, 0], alpha.gather(1, prev)[:, 0])
