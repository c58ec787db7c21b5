"""Gluon losses (counterpart of ``mxnet_tpu/gluon/loss.py``): the ``Loss``
base and ``L2Loss``, ``L1Loss``, ``SigmoidBinaryCrossEntropyLoss``,
``SoftmaxCrossEntropyLoss``, ``KLDivLoss``, ``CTCLoss``, ``HuberLoss``,
``HingeLoss``, ``SquaredHingeLoss``, ``LogisticLoss``, ``TripletLoss``,
``PoissonNLLLoss``, ``CosineEmbeddingLoss`` and ``SDMLLoss``, with the
reference's ``weight`` / ``sample_weight`` / ``batch_axis`` handling: a
label of another shape is reshaped to the prediction's, the weights
multiply the elementwise loss, and most losses average over every axis
but the batch axis."""
from __future__ import annotations

import math

import torch

from ..ops import nn as nn_ops
from ..ops import tensor as tensor_ops
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


def _reshape_like(x, y):
    return x.reshape(y.shape) if x.shape != y.shape else x


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


class L2Loss(Loss):
    """``weight/2 · (pred − label)²``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = (pred - label).square()
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._mean_nonbatch(loss)


class L1Loss(Loss):
    """``|pred − label|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = (pred - label).abs()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of logits (or of probabilities with
    ``from_sigmoid``), ``pos_weight`` scaling the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(label, pred)
        p, lab = pred, label
        if not self._from_sigmoid:
            soft = torch.log1p(torch.exp(-p.abs()))
            if pos_weight is not None:
                soft = soft * (lab * (pos_weight - 1) + 1)
            loss = p.clamp(min=0) - p * lab + soft
        else:
            eps = 1e-12
            pos = torch.log(p + eps) * lab
            if pos_weight is not None:
                pos = pos * pos_weight
            loss = -(pos + torch.log1p(-p + eps) * (1 - lab))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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
            loss = -(logp * _reshape_like(label, logp)).sum(dim=self._axis)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """``label · (log label − pred)`` with ``pred`` log-probabilities
    (``from_logits``; else ``pred`` is log-softmaxed first)."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = nn_ops.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label.clamp(min=1e-12)) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class CTCLoss(Loss):
    """Connectionist temporal classification over the ``CTCLoss`` op
    (blank ``"first"``): ``pred`` in ``layout`` (``NTC`` or ``TNC``),
    ``label`` in ``label_layout`` (``NT`` or ``TN``).  The optional arrays
    are passed on as the reference passes them, dropping the ``None``
    ones first: ``label_lengths`` without ``pred_lengths`` lands in the
    op's ``data_lengths`` slot, where it is not read."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        super().__init__(weight, 0, **kwargs)
        self._layout = layout
        self._label_layout = label_layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._label_layout == "TN":
            label = label.transpose(0, 1)
        arrays = [a for a in (pred, label, pred_lengths, label_lengths)
                  if a is not None]
        loss = nn_ops.ctc_loss(*arrays,
                               use_data_lengths=pred_lengths is not None,
                               use_label_lengths=label_lengths is not None,
                               blank_label="first")
        return _apply_weighting(loss, self._weight, sample_weight)


class HuberLoss(Loss):
    """``|e| − ρ/2`` where ``|e| > ρ``, else ``e²/(2ρ)``."""

    def __init__(self, rho=1.0, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        rho = self._rho
        e = (pred - label).abs()
        loss = torch.where(e > rho, e - 0.5 * rho, 0.5 / rho * e * e)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class HingeLoss(Loss):
    """``max(0, margin − pred·label)``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = (self._margin - pred * label).clamp(min=0.0)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class SquaredHingeLoss(Loss):
    """``max(0, margin − pred·label)²``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        loss = (self._margin - pred * label).clamp(min=0.0).square()
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class LogisticLoss(Loss):
    """``log(1 + exp(−pred·label))``, labels ±1 (``signed``) or 0/1
    (``binary``)."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(label, pred)
        if self._label_format != "signed":
            label = 2 * label - 1
        loss = torch.log1p(torch.exp(-pred * label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._mean_nonbatch(loss)


class TripletLoss(Loss):
    """``max(Σ (pred − pos)² − (pred − neg)² + margin, 0)`` over every
    axis but the first."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        axes = tuple(range(1, pred.dim()))
        d = ((pred - positive).square() - (pred - negative).square()).sum(
            dim=axes)
        loss = (d + self._margin).clamp(min=0.0)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood, ``exp(pred) − label·pred``
    (``from_logits``) or ``pred − label·log(pred + ε)``, with Stirling's
    term for labels > 1 under ``compute_full``; one mean over every
    element."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, label, sample_weight=None, epsilon=1e-08):
        label = _reshape_like(label, pred)
        if self._from_logits:
            loss = torch.exp(pred) - label * pred
        else:
            loss = pred - label * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = label * torch.log(label + 1e-12) - label + \
                0.5 * torch.log(2 * math.pi * (label + 1e-12))
            loss = loss + torch.where(label > 1, stirling,
                                      torch.zeros_like(stirling))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return loss.mean()


class CosineEmbeddingLoss(Loss):
    """``1 − cos`` for label 1, ``max(0, cos − margin)`` otherwise, the
    cosine over every axis but the first."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        a = input1.reshape(input1.shape[0], -1)
        b = input2.reshape(input2.shape[0], -1)
        cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1) + 1e-12)
        loss = torch.where(label.reshape(-1) == 1, 1.0 - cos,
                           (cos - self._margin).clamp(min=0.0))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Batchwise smoothed deep metric learning loss (Bonadiman et al.
    2019): the rows ``(x1[i], x2[i])`` are positives, every other row of
    the batch a smoothed negative; the KL divergence between the
    label-smoothed identity and the softmax over negative euclidean
    distances, averaged over both directions."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0,
                 batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._smooth = float(smoothing_parameter)

    def forward(self, x1, x2, sample_weight=None):
        smooth = self._smooth
        n = x1.shape[0]
        d = torch.sqrt(((x1[:, None, :] - x2[None, :, :]) ** 2).sum(-1)
                       + 1e-12)
        logits = -d
        eye = torch.eye(n, dtype=x1.dtype, device=x1.device)
        targets = eye * (1.0 - smooth) + (1.0 - eye) * (
            smooth / max(n - 1, 1))
        logp12 = torch.log_softmax(logits, 1)
        logp21 = torch.log_softmax(logits.t(), 1)
        kl = -(targets * logp12).sum(1) - (targets * logp21).sum(1)
        return _apply_weighting(kl / 2.0, self._weight, sample_weight)
