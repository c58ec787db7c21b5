"""SPMDTrainer on one device (counterpart of
``mxnet_tpu/parallel/trainer.py``).

One training step: forward, loss, gradients through
``torch.autograd``, and the optimizer's update op for every parameter.
The reference compiles that into one XLA executable; here it runs
eagerly on one card, with the same arithmetic:

* ``dtype="bfloat16"`` computes in bf16 while the master weights stay
  f32: each floating parameter is cast *inside* the differentiated
  graph, so gradients arrive in f32 on the masters; floating input data
  is cast too (integer token ids are not);
* the loss mean is taken in f32;
* each parameter's update is the optimizer's op with ``lr·lr_mult`` and
  ``wd·wd_mult``, ``rescale_grad`` 1 and the optimizer's clip, exactly
  as the reference's step does — for Adam that means no bias
  correction — applied to all parameters at once through the op's
  multi-tensor form;
* ``run_steps`` reads lr and wd once for the whole window and advances
  ``num_update`` by n, as the reference's fused window does.

Masters and optimizer state are updated in place (``copy_``), which the
reference expresses as buffer donation.  A mesh, ZeRO, micro-batches,
remat and the AMP policy's loss scaler are not ported yet and raise.
"""
from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import numpy as onp
import torch

from .. import autograd as ag
from .. import optimizer as opt_mod
from .. import telemetry, tracing
from ..base import MXNetError
from ..context import resolve_device
from ..ops import optimizer_ops

__all__ = ["SPMDTrainer"]

_LOW_PRECISION = ("bfloat16", "bf16", "float16")


@contextlib.contextmanager
def _params_as(params, tensors):
    """Let each parameter's ``data()`` return the given tensor inside the
    scope (the compute-dtype copies of a step)."""
    try:
        for p, t in zip(params, tensors):
            p._override = t
        yield
    finally:
        for p in params:
            p._override = None


class SPMDTrainer:
    def __init__(self, net, loss_fn: Callable, optimizer="sgd",
                 optimizer_params: Optional[dict] = None, mesh=None,
                 dtype: Optional[str] = None, remat: bool = False,
                 micro_batches: int = 1, zero_stage: Optional[int] = None,
                 zero: Optional[int] = None, device=None):
        unported = [name for name, on in (
            ("mesh", mesh is not None), ("remat", remat),
            ("micro_batches", micro_batches != 1),
            ("zero_stage", bool(zero_stage) or bool(zero)),
            ("the AMP policy (MXNET_AMP=1)",
             os.environ.get("MXNET_AMP") == "1")) if on]
        if unported:
            raise MXNetError(f"SPMDTrainer: {', '.join(unported)} not "
                             f"ported yet; the port trains on one device")
        self.device = resolve_device(device)
        self.net = net
        self.loss_fn = loss_fn
        self.amp_dtype = torch.bfloat16 if dtype in _LOW_PRECISION else None
        self.optimizer = opt_mod.create(optimizer,
                                        **(optimizer_params or {}))
        self._update = getattr(optimizer_ops,
                               f"{self.optimizer.op_name}_multi")
        self._params = net.collect_params()
        self._pkeys = list(self._params.keys())
        for k in self._pkeys:
            p = self._params[k]
            p._check_initialized()
            if p.data().device != self.device:
                raise MXNetError(f"parameter {k} is on {p.data().device}, "
                                 f"the trainer on {self.device}")
        self._opt_state = {
            k: tuple(self.optimizer.create_state(i, self._params[k].data()))
            for i, k in enumerate(self._pkeys)}
        self.num_update = 0

    # -- one step ----------------------------------------------------------
    def _stage(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return torch.as_tensor(onp.asarray(x), device=self.device)

    def _step(self, lr, wd, data, label) -> torch.Tensor:
        params = [self._params[k] for k in self._pkeys]
        masters = [p.data() for p in params]
        amp = self.amp_dtype
        compute = [w.to(amp) if amp is not None and w.is_floating_point()
                   else w for w in masters]
        if amp is not None and data.is_floating_point():
            data = data.to(amp)
        with _params_as(params, compute), ag.train_mode(), \
                torch.enable_grad():
            out = self.net(data)
            loss = self.loss_fn(out, label).float().mean()
        live = [i for i, p in enumerate(params) if p.grad_req != "null"]
        grads = torch.autograd.grad(loss, [masters[i] for i in live])
        self._apply_updates(lr, wd, params, masters, live, grads)
        return loss.detach()

    @torch.no_grad()
    def _apply_updates(self, lr, wd, params, masters, live, grads):
        """Every live parameter's update in one multi-tensor call of the
        optimizer's op; masters and state are overwritten in place."""
        opt = self.optimizer
        statics = dict(opt.static_params(0))
        statics.setdefault("rescale_grad", 1.0)
        statics.setdefault("clip_gradient",
                           float(opt.clip_gradient)
                           if opt.clip_gradient is not None else -1.0)
        weights = [masters[i] for i in live]
        states = [self._opt_state[self._pkeys[i]] for i in live]
        new_w, *new_states = self._update(
            weights, list(grads), *map(list, zip(*states)),
            lrs=[lr * params[i].lr_mult for i in live],
            wds=[wd * params[i].wd_mult for i in live], **statics)
        torch._foreach_copy_(weights, new_w)
        for j, new in enumerate(new_states):
            torch._foreach_copy_([st[j] for st in states], new)

    def _schedule(self, n_steps):
        """lr and wd at the window's entry point, then advance
        ``num_update`` by ``n_steps``."""
        lr = float(self.optimizer.learning_rate)
        wd = float(self.optimizer.wd)
        self.num_update += n_steps
        self.optimizer.num_update = self.num_update
        return lr, wd

    def step(self, data, label, batch_size: Optional[int] = None):
        """One training step; returns the f32 loss mean (a 0-d tensor on
        the device)."""
        d, l = self._stage(data), self._stage(label)
        tok = telemetry.begin_step()
        try:
            with tracing.span("step.spmd") as sp:
                lr, wd = self._schedule(1)
                sp.annotate(step=self.num_update)
                loss = self._step(lr, wd, d, l)
        finally:
            telemetry.end_step(tok, "SPMDTrainer")
        return loss

    def run_steps(self, data, label, n_steps: int,
                  per_step_data: bool = False):
        """``n_steps`` training steps at one lr/wd; returns their losses
        as an (n_steps,) tensor.  With ``per_step_data``, data and label
        carry a leading ``n_steps`` axis and step i trains on batch i."""
        d, l = self._stage(data), self._stage(label)
        n = int(n_steps)
        if per_step_data and (d.shape[0] != n or l.shape[0] != n):
            raise MXNetError(
                f"run_steps(per_step_data=True): leading axis must be "
                f"n_steps={n}, got data {tuple(d.shape)} label "
                f"{tuple(l.shape)}")
        tok = telemetry.begin_step()
        try:
            with tracing.span("step.spmd_window", n_steps=n,
                              step=self.num_update + 1):
                lr, wd = self._schedule(n)
                losses = [self._step(lr, wd, d[i] if per_step_data else d,
                                     l[i] if per_step_data else l)
                          for i in range(n)]
        finally:
            telemetry.end_step(tok, "SPMDTrainer", extra={"n_steps": n})
        return torch.stack(losses)
