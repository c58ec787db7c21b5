"""AMP's entry points (counterpart of ``mxnet_tpu/amp/amp.py``):
``init`` turns the execution policy on, ``init_trainer`` gives a
``gluon.Trainer`` a dynamic loss scaler, ``scale_loss`` scales a loss
for ``backward`` and, on leaving, checks the gradients (an overflow
halves the scale and zeroes the gradients, so the step that follows
changes nothing), ``convert_model`` casts a model's f32 parameters for
low-precision inference."""
from __future__ import annotations

import torch

from . import policy
from .loss_scaler import LossScaler

__all__ = ["init", "reset", "init_trainer", "scale_loss", "unscale",
           "convert_model", "convert_hybrid_block"]

_initialized = False


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Turn AMP on for the process: listed ops compute in
    ``target_dtype`` (``bfloat16`` or ``float16``) or in f32 by their
    category.  The op lists are the module's; custom lists are not
    taken.  A second call changes nothing."""
    global _initialized
    if _initialized:
        return
    policy.activate(target_dtype)
    _initialized = True


def reset():
    """Undo :func:`init` (the reference has no un-init; tests use it)."""
    global _initialized
    policy.deactivate()
    _initialized = False


def init_trainer(trainer):
    """Attach a dynamic :class:`LossScaler` to a ``gluon.Trainer``."""
    trainer._amp_loss_scaler = LossScaler()
    trainer._amp_original_scale = trainer._scale
    return trainer


class scale_loss:
    """``with amp.scale_loss(loss, trainer) as scaled: scaled.backward()``:
    the loss times the scale; the trainer's ``rescale_grad`` takes the
    scale back out at its next step."""

    def __init__(self, loss, trainer):
        self._trainer = trainer
        scaler = getattr(trainer, "_amp_loss_scaler", None)
        if scaler is None:
            init_trainer(trainer)
            scaler = trainer._amp_loss_scaler
        self._scaler = scaler
        scale = scaler.loss_scale
        trainer._scale = trainer._amp_original_scale / scale
        if isinstance(loss, (list, tuple)):
            self._scaled = [l * scale for l in loss]
        else:
            self._scaled = loss * scale

    def __enter__(self):
        return self._scaled

    def __exit__(self, *exc):
        scaler = self._scaler
        overflow = scaler.has_overflow(self._trainer._params)
        scaler.update_scale(overflow)
        if overflow:
            for p in self._trainer._params:
                if p._grad is not None:
                    p.zero_grad()
        return False


def unscale(trainer):
    """Divide every gradient buffer by the loss scale."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    scale = scaler.loss_scale
    for p in trainer._params:
        if p._grad is not None:
            p._grad._data = p._grad._data / scale


def convert_model(net, target_dtype="bfloat16", cast_params=True):
    """Cast the model's initialized f32 parameters to ``target_dtype``
    (auxiliary states too), for low-precision inference."""
    dt = getattr(torch, policy._canon(target_dtype))
    if cast_params:
        for p in net.collect_params().values():
            if p._data is not None and p.dtype == torch.float32:
                p.cast(dt)
    return net


def convert_hybrid_block(block, target_dtype="bfloat16", cast_params=False):
    """:func:`init` with ``target_dtype``, and the parameters cast when
    ``cast_params``."""
    init(target_dtype)
    if cast_params:
        convert_model(block, target_dtype)
    return block
