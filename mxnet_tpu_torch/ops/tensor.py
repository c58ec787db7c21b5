"""Tensor ops on the training path (counterpart of the part of
``mxnet_tpu/ops/tensor.py`` the transformer LM calls): ``dot``,
``pick`` and ``Embedding``.  Plain PyTorch."""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["dot", "pick", "embedding"]


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


def embedding(data, weight):
    """Rows of ``weight`` at integer ``data``.  An id outside
    ``[0, vocab)`` raises: the reference fills such a row with NaN
    (``jnp.take``'s fill mode), which the port does not copy.  The check
    reads the ids' range back to the host: one synchronisation per call
    on a CUDA tensor."""
    if data.is_floating_point():
        raise MXNetError("Embedding takes integer ids; float ids round "
                         "in low precision — pass int32 or int64")
    idx = data.long()
    if idx.numel():
        lo, hi = (int(x) for x in torch.aminmax(idx))
        if lo < 0 or hi >= weight.shape[0]:
            raise MXNetError(f"Embedding ids must lie in [0, "
                             f"{weight.shape[0]}), got [{lo}, {hi}]")
    return weight[idx]
