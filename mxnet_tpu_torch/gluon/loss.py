"""Gluon losses on the training path (counterpart of part of
``mxnet_tpu/gluon/loss.py``): the ``Loss`` base and
``SoftmaxCrossEntropyLoss``."""
from __future__ import annotations

from ..ops import nn as nn_ops
from ..ops import tensor as tensor_ops
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


class Loss(HybridBlock):
    """Base loss: one value per sample along ``batch_axis``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _mean_nonbatch(self, loss):
        axes = tuple(i for i in range(loss.dim()) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss


class SoftmaxCrossEntropyLoss(Loss):
    """``-log softmax(pred)[label]`` (sparse labels) or ``-Σ label·log
    softmax(pred)``, averaged over every axis but the batch axis."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        logp = pred if self._from_logits else nn_ops.log_softmax(
            pred, axis=self._axis)
        if self._sparse_label:
            loss = -tensor_ops.pick(logp, label, axis=self._axis)
        else:
            loss = -(logp * label.reshape(logp.shape)).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
