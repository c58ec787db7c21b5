"""The optimizer base, SGD and Adam (counterpart of the part of
``mxnet_tpu/optimizer/optimizer.py`` that ``SPMDTrainer`` reads): the
hyper-parameters, the per-weight state and the name of the update op.
The update itself is the op in ``ops/optimizer_ops.py``; the eager
``Optimizer.update`` path (with Adam's bias correction folded into lr)
belongs to ``gluon.Trainer`` and is not ported yet."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..base import MXNetError

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]

_OPT_REGISTRY: Dict[str, type] = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs) -> "Optimizer":
    if isinstance(name, Optimizer):
        return name
    key = str(name).lower()
    if key not in _OPT_REGISTRY:
        raise MXNetError(f"unknown optimizer {name!r}")
    return _OPT_REGISTRY[key](**kwargs)


class Optimizer:
    """Base optimizer: learning rate (or schedule), weight decay,
    gradient rescale and clip, and the update count."""

    op_name: Optional[str] = None     # the update op in ops/optimizer_ops

    def __init__(self, rescale_grad=1.0, wd=0.0, clip_gradient=None,
                 learning_rate=None, lr_scheduler=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.num_update = 0

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def create_state(self, index, weight) -> Tuple[torch.Tensor, ...]:
        return ()

    def static_params(self, index) -> Dict[str, Any]:
        """The op's fixed attributes (everything but lr, wd and the
        tensors)."""
        return {}


@register
class SGD(Optimizer):
    """SGD, with momentum unless ``momentum`` is 0 (``mxnet_tpu/optimizer/
    optimizer.py:425-442``): the op is ``sgd_mom_update`` with one
    momentum state a weight, else ``sgd_update`` with none.
    ``lazy_update`` is accepted (it matters only for sparse gradients,
    which the port does not have)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=True,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
        self.op_name = "sgd_mom_update" if momentum != 0.0 else "sgd_update"

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (torch.zeros_like(weight, requires_grad=False),)

    def static_params(self, index):
        return {"momentum": self.momentum} if self.momentum != 0.0 else {}


@register
class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.op_name = "adam_update"

    def create_state(self, index, weight):
        return tuple(torch.zeros_like(weight, requires_grad=False)
                     for _ in range(2))

    def static_params(self, index):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}
