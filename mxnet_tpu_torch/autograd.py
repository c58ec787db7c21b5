"""Training-mode flags (the part of ``mxnet_tpu/autograd.py`` the
training path reads).  Gradients themselves come from
``torch.autograd``; the reference's ``record``/``backward`` tape is
not ported yet.

``is_training()`` tells layers such as ``Dropout`` whether they run in
training mode; ``train_mode``/``predict_mode`` set it for a scope and
``pause`` also turns PyTorch's gradient recording off."""
from __future__ import annotations

import threading

import torch

__all__ = ["is_training", "set_training", "train_mode", "predict_mode",
           "pause"]

_state = threading.local()


def is_training() -> bool:
    return getattr(_state, "training", False)


def set_training(flag: bool) -> bool:
    old = is_training()
    _state.training = bool(flag)
    return old


class _Scope:
    def __init__(self, training, grad=None):
        self._train, self._grad = training, grad

    def __enter__(self):
        self._old_train = set_training(self._train)
        if self._grad is not None:
            self._old_grad = torch.is_grad_enabled()
            torch.set_grad_enabled(self._grad)
        return self

    def __exit__(self, *exc):
        set_training(self._old_train)
        if self._grad is not None:
            torch.set_grad_enabled(self._old_grad)
        return False


def train_mode() -> _Scope:
    return _Scope(True)


def predict_mode() -> _Scope:
    return _Scope(False)


def pause(train_mode: bool = False) -> _Scope:
    """Stop recording gradients for the scope (``torch.no_grad``), in
    training mode or not."""
    return _Scope(train_mode, grad=False)
