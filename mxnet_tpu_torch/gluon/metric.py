"""Evaluation metrics (counterpart of ``mxnet_tpu/gluon/metric.py``).
Metrics read their inputs on the host (NDArrays, tensors on any device,
numpy).

Parity: python/mxnet/gluon/metric.py (1,930 LoC, 20+ metrics): EvalMetric
base + registry, Accuracy, TopKAccuracy, F1, MCC, MAE, MSE, RMSE,
CrossEntropy, NegativeLogLikelihood, Perplexity, PearsonCorrelation,
CompositeEvalMetric, Loss, Custom.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as onp
import torch

from ..base import MXNetError

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Fbeta", "MCC", "PCC", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "Perplexity", "PearsonCorrelation",
           "BinaryAccuracy", "MeanPairwiseDistance", "MeanCosineSimilarity",
           "Loss", "CustomMetric", "create", "np"]

_METRIC_REGISTRY: Dict[str, type] = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """Parity: metric.create."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    name = metric.lower()
    aliases = {"acc": "accuracy", "ce": "crossentropy", "nll_loss":
               "negativeloglikelihood", "top_k_accuracy": "topkaccuracy",
               "pearsonr": "pearsoncorrelation"}
    name = aliases.get(name, name)
    if name not in _METRIC_REGISTRY:
        raise MXNetError(f"unknown metric {metric!r}")
    return _METRIC_REGISTRY[name](*args, **kwargs)


def _as_np(x):
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


class EvalMetric:
    """Base metric (parity: gluon/metric.py EvalMetric)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)

    def __str__(self):
        return f"EvalMetric: {dict([self.get_name_value()[0]])}"


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.extend(n if isinstance(n, list) else [n])
            values.extend(v if isinstance(v, list) else [v])
        return names, values


def _tolist(x):
    return x if isinstance(x, (list, tuple)) else [x]


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", **kwargs):
        super().__init__(name, **kwargs)
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label = _as_np(label)
            pred = _as_np(pred)
            if pred.ndim > label.ndim:
                pred = pred.argmax(axis=self.axis)
            pred = pred.astype(onp.int64).reshape(-1)
            label = label.astype(onp.int64).reshape(-1)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        super().__init__(f"{name}_{top_k}", **kwargs)
        self.top_k = top_k

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label = _as_np(label).astype(onp.int64)
            pred = _as_np(pred)
            topk = onp.argsort(-pred, axis=-1)[..., :self.top_k]
            hit = (topk == label.reshape(label.shape + (1,))).any(axis=-1)
            self.sum_metric += float(hit.sum())
            self.num_inst += int(hit.size)


class _BinaryStats:
    def __init__(self):
        self.tp = self.fp = self.tn = self.fn = 0

    def update(self, label, pred):
        pred_label = pred.argmax(axis=-1) if pred.ndim > 1 else (pred > 0.5)
        pred_label = pred_label.astype(onp.int64).reshape(-1)
        label = label.astype(onp.int64).reshape(-1)
        self.tp += int(((pred_label == 1) & (label == 1)).sum())
        self.fp += int(((pred_label == 1) & (label == 0)).sum())
        self.tn += int(((pred_label == 0) & (label == 0)).sum())
        self.fn += int(((pred_label == 0) & (label == 1)).sum())

    @property
    def precision(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    @property
    def recall(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    @property
    def f1(self):
        p, r = self.precision, self.recall
        return 2 * p * r / (p + r) if (p + r) else 0.0

    @property
    def mcc(self):
        d = math.sqrt((self.tp + self.fp) * (self.tp + self.fn)
                      * (self.tn + self.fp) * (self.tn + self.fn))
        return ((self.tp * self.tn) - (self.fp * self.fn)) / d if d else 0.0

    @property
    def total(self):
        return self.tp + self.fp + self.tn + self.fn


@register
class F1(EvalMetric):
    def __init__(self, name="f1", average="macro", **kwargs):
        self.average = average
        self._stats = _BinaryStats()
        super().__init__(name, **kwargs)

    def reset(self):
        self._stats = _BinaryStats()
        super().reset()

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            self._stats.update(_as_np(label), _as_np(pred))
        self.sum_metric = self._stats.f1
        self.num_inst = 1 if self._stats.total else 0


@register
class MCC(EvalMetric):
    def __init__(self, name="mcc", **kwargs):
        self._stats = _BinaryStats()
        super().__init__(name, **kwargs)

    def reset(self):
        self._stats = _BinaryStats()
        super().reset()

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            self._stats.update(_as_np(label), _as_np(pred))
        self.sum_metric = self._stats.mcc
        self.num_inst = 1 if self._stats.total else 0


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += float(onp.abs(label.reshape(pred.shape)
                                             - pred).mean()) * label.shape[0]
            self.num_inst += label.shape[0]


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label, pred = _as_np(label), _as_np(pred)
            self.sum_metric += float(((label.reshape(pred.shape) - pred) ** 2
                                      ).mean()) * label.shape[0]
            self.num_inst += label.shape[0]


@register
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(name, **kwargs)
        self.eps = eps

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label = _as_np(label).ravel().astype(onp.int64)
            pred = _as_np(pred)
            prob = pred[onp.arange(label.shape[0]), label]
            self.sum_metric += float(-onp.log(prob + self.eps).sum())
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kwargs):
        super().__init__(name, **kwargs)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label = _as_np(label).ravel().astype(onp.int64)
            pred = _as_np(pred).reshape(-1, _as_np(pred).shape[-1])
            prob = pred[onp.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                prob = prob[~ignore]
            self.sum_metric += float(-onp.log(onp.maximum(prob, 1e-12)).sum())
            self.num_inst += prob.shape[0]

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)
        self._labels: List[onp.ndarray] = []
        self._preds: List[onp.ndarray] = []

    def reset(self):
        self._labels, self._preds = [], []
        super().reset()

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            self._labels.append(_as_np(label).ravel())
            self._preds.append(_as_np(pred).ravel())
        self.num_inst = 1

    def get(self):
        if not self._labels:
            return (self.name, float("nan"))
        x = onp.concatenate(self._labels)
        y = onp.concatenate(self._preds)
        return (self.name, float(onp.corrcoef(x, y)[0, 1]))


@register
class Loss(EvalMetric):
    """Average of loss values (parity: metric.Loss)."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in _tolist(preds):
            pred = _as_np(pred)
            self.sum_metric += float(pred.sum())
            self.num_inst += pred.size


@register
class CustomMetric(EvalMetric):
    def __init__(self, feval: Callable, name="custom",
                 allow_extra_outputs=False, **kwargs):
        super().__init__(f"custom({name})", **kwargs)
        self._feval = feval

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                s, n = reval
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name="custom", allow_extra_outputs=False):
    """Parity: metric.np — wrap a numpy feval into a metric."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = getattr(numpy_feval, "__name__", name)
    return CustomMetric(feval, name=feval.__name__,
                        allow_extra_outputs=allow_extra_outputs)


@register
class Fbeta(F1):
    """F-beta of a binary classification (parity: metric.py:815 Fbeta):
    (1+β²)·P·R / (β²·P + R)."""

    def __init__(self, name="fbeta", beta=1.0, average="macro", **kwargs):
        self.beta = float(beta)
        super().__init__(name=name, average=average, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            self._stats.update(_as_np(label), _as_np(pred))
        p, r = self._stats.precision, self._stats.recall
        b2 = self.beta * self.beta
        d = b2 * p + r
        self.sum_metric = (1 + b2) * p * r / d if d else 0.0
        self.num_inst = 1 if self._stats.total else 0


@register
class BinaryAccuracy(EvalMetric):
    """Thresholded binary/multilabel accuracy (parity: metric.py:876)."""

    def __init__(self, name="binary_accuracy", threshold=0.5, **kwargs):
        self.threshold = threshold
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label = _as_np(label).astype(onp.int64).reshape(-1)
            pred = (_as_np(pred) > self.threshold).astype(
                onp.int64).reshape(-1)
            self.sum_metric += float((pred == label).sum())
            self.num_inst += int(pred.size)


@register
class MeanPairwiseDistance(EvalMetric):
    """Mean per-sample p-norm distance (parity: metric.py:1197)."""

    def __init__(self, name="mpd", p=2, **kwargs):
        self.p = p
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label = _as_np(label).reshape(_as_np(label).shape[0], -1)
            pred = _as_np(pred).reshape(pred.shape[0], -1)
            dis = ((onp.abs(label - pred) ** self.p).sum(axis=-1)
                   ) ** (1.0 / self.p)
            self.sum_metric += float(dis.sum())
            self.num_inst += label.shape[0]


@register
class MeanCosineSimilarity(EvalMetric):
    """Mean cosine similarity along the last axis (parity:
    metric.py:1263)."""

    def __init__(self, name="cos_sim", eps=1e-8, **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label = _as_np(label).astype(onp.float64)
            pred = _as_np(pred).astype(onp.float64)
            num = (label * pred).sum(axis=-1)
            den = onp.maximum(
                onp.linalg.norm(label, axis=-1)
                * onp.linalg.norm(pred, axis=-1), self.eps)
            sim = num / den
            self.sum_metric += float(sim.sum())
            self.num_inst += int(sim.size)


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation via the confusion matrix —
    reduces to MCC for 2 classes (parity: metric.py:1651)."""

    def __init__(self, name="pcc", **kwargs):
        self._cm = onp.zeros((2, 2), onp.float64)
        super().__init__(name, **kwargs)

    def reset(self):
        self._cm = onp.zeros((2, 2), onp.float64)
        super().reset()

    def _grow(self, n):
        if n > self._cm.shape[0]:
            cm = onp.zeros((n, n), onp.float64)
            k = self._cm.shape[0]
            cm[:k, :k] = self._cm
            self._cm = cm

    def update(self, labels, preds):
        for label, pred in zip(_tolist(labels), _tolist(preds)):
            label = _as_np(label).astype(onp.int64).reshape(-1)
            pred = _as_np(pred)
            pred_label = (pred.argmax(axis=-1) if pred.ndim > 1
                          else (pred > 0.5)).astype(onp.int64).reshape(-1)
            n = int(max(label.max(initial=0),
                        pred_label.max(initial=0))) + 1
            self._grow(n)
            onp.add.at(self._cm, (label, pred_label), 1)
        cm = self._cm
        t = cm.sum(axis=1)   # true occurrences
        p = cm.sum(axis=0)   # predicted occurrences
        n = cm.sum()
        cov_tp = (cm.diagonal().sum() * n - (t * p).sum())
        cov_tt = (n * n - (t * t).sum())
        cov_pp = (n * n - (p * p).sum())
        d = math.sqrt(cov_tt * cov_pp)
        self.sum_metric = cov_tp / d if d else 0.0
        self.num_inst = 1 if n else 0


# legacy framework-bridge metrics are Loss aliases (parity:
# metric.py Torch/Caffe — mean of a scalar loss output); registered so
# metric.create("torch"/"caffe") works like the reference
Torch = Loss
Caffe = Loss
_METRIC_REGISTRY["torch"] = Loss
_METRIC_REGISTRY["caffe"] = Loss
