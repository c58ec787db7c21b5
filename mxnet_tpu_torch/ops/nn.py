"""Neural-network ops on the training path (counterpart of the part of
``mxnet_tpu/ops/nn.py`` the transformer LM calls): ``FullyConnected``,
``Activation`` (registered, so ``mx.nd.Activation`` reaches it), the
GELU cases of ``LeakyReLU``, ``log_softmax`` and ``LayerNorm``.  Plain
PyTorch: the reference left these to XLA, not to Pallas."""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from .registry import register
from .tensor import float_only

__all__ = ["fully_connected", "activation", "leaky_relu", "log_softmax",
           "layer_norm", "safe_accumulation_enabled"]


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


def fully_connected(x, weight, bias=None, *, flatten=True):
    """``x·Wᵀ + b`` with ``W (units, in_units)``; ``flatten`` folds every
    axis after the first into the input features."""
    if flatten:
        x = x.reshape(x.shape[0], -1)
    out = torch.matmul(x, weight.t())
    if bias is not None:
        out = out + bias
    return out


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


def log_softmax(x, *, axis=-1):
    """Log-softmax over ``axis``; in f32 under safe accumulation."""
    xa, low = _safe_acc(x)
    out = torch.log_softmax(xa, dim=axis)
    return out.to(low) if low is not None else out


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
