"""The dynamic loss scaler (counterpart of ``mxnet_tpu/amp/loss_scaler.py``):
the scale grows by ``scale_factor`` after ``scale_window`` clean steps in
a row and is divided by it (to no less than 1) on a step whose gradients
overflow, which is skipped.

Two callers:

- the eager loop (``amp.scale_loss``) calls :meth:`has_overflow` and
  :meth:`update_scale` on the host.  ``has_overflow`` reduces the whole
  gradient set to one device bool (:func:`all_finite`) and reads it
  once;
- ``SPMDTrainer`` keeps the scale and the clean-step count as device
  tensors of its captured step, which updates them itself, and hands
  them back through :meth:`adopt_traced`: their values are copied to
  the host behind the step's work and read one step later (or when
  someone reads ``loss_scale``), so the step never waits for the host.

Counters: ``amp.overflow_steps`` and ``amp.skipped_updates`` (telemetry
counters), ``amp.loss_scale`` (a gauge).
"""
from __future__ import annotations

import math

import torch

from .. import telemetry

__all__ = ["LossScaler", "all_finite"]


def all_finite(tensors) -> torch.Tensor:
    """One 0-d device bool: every element of every floating tensor is
    finite.  Each group of one dtype is reduced by one multi-tensor
    max-abs norm (NaN and inf propagate; a large finite value stays
    finite)."""
    groups = {}
    for t in tensors:
        if t.is_floating_point():
            groups.setdefault(t.dtype, []).append(t)
    flags = [torch.stack(torch._foreach_norm(g, math.inf)).isfinite().all()
             for g in groups.values()]
    if not flags:
        return torch.ones((), dtype=torch.bool)
    return flags[0] if len(flags) == 1 else torch.stack(flags).all()


class LossScaler:
    def __init__(self, init_scale=2 ** 16, scale_factor=2.0,
                 scale_window=2000):
        self._loss_scale = float(init_scale)
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._unskipped = 0
        # a step's (scale, unskipped, skipped) on their way to the host:
        # (host tensor, event or None)
        self._pending = None
        # moves when the host sets the state (a captured step must then
        # take the host's values)
        self._version = 0

    # -- a captured step's state ----------------------------------------
    def adopt_traced(self, scale, unskipped, skipped) -> None:
        """Take a step's new (scale, clean-step count, skipped steps), 0-d
        device tensors, without waiting for them: the previous step's
        values are folded into the host state first (one step of lag),
        and these start their copy to the host."""
        self._fold()
        vals = torch.stack([scale.float(), unskipped.float(),
                            skipped.float()]).detach()
        if vals.is_cuda:
            host = torch.empty(3, dtype=torch.float32, pin_memory=True)
            host.copy_(vals, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._pending = (host, done)
        else:
            self._pending = (vals.clone(), None)

    def _fold(self) -> None:
        p, self._pending = self._pending, None
        if p is None:
            return
        host, done = p
        if done is not None:
            done.synchronize()
        scale, unskipped, skipped = host.tolist()
        self._loss_scale = float(scale)
        self._unskipped = int(unskipped)
        self._note(int(skipped))

    def _note(self, skipped) -> None:
        n = int(skipped)
        if n:
            telemetry.counter("amp.overflow_steps").inc(n)
            telemetry.counter("amp.skipped_updates").inc(n)
        telemetry.gauge("amp.loss_scale").set(self._loss_scale)

    # -- the host's view -------------------------------------------------
    @property
    def loss_scale(self) -> float:
        self._fold()
        return self._loss_scale

    @loss_scale.setter
    def loss_scale(self, v) -> None:
        self._pending = None
        self._loss_scale = float(v)
        self._version += 1

    def state(self) -> dict:
        """The scaler's state as JSON-able values."""
        self._fold()
        return {"loss_scale": self._loss_scale,
                "unskipped": int(self._unskipped),
                "scale_factor": float(self._scale_factor),
                "scale_window": int(self._scale_window)}

    def load_state(self, d: dict) -> None:
        self._pending = None
        self._loss_scale = float(d["loss_scale"])
        self._unskipped = int(d.get("unskipped", 0))
        self._scale_factor = float(d.get("scale_factor",
                                         self._scale_factor))
        self._scale_window = int(d.get("scale_window", self._scale_window))
        self._version += 1

    # -- the eager loop --------------------------------------------------
    def has_overflow(self, params) -> bool:
        """True when a gradient holds an inf or a NaN: one device bool for
        the whole set, read once."""
        grads = [p._grad._data for p in params
                 if getattr(p, "_grad", None) is not None]
        return not bool(all_finite(grads))

    def update_scale(self, overflow: bool):
        self._fold()
        if overflow:
            self._loss_scale = max(self._loss_scale / self._scale_factor,
                                   1.0)
            self._unskipped = 0
        else:
            self._unskipped += 1
            if self._unskipped >= self._scale_window:
                self._loss_scale *= self._scale_factor
                self._unskipped = 0
        self._note(overflow)
