"""Gluon Trainer (counterpart of ``mxnet_tpu/gluon/trainer.py``): the
optimizer step of the eager Gluon loop::

    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    trainer.step(batch_size)

``step`` sets ``rescale_grad`` to ``1 / batch_size`` (times the AMP loss
scale's inverse, ``_scale``), reduces the gradients through the kvstore,
and updates every parameter from its gradient buffer (``Parameter.grad``)
in place.  By default the whole step is captured
(``imperative/cached_step.py``, ``MXNET_CACHED_STEP``): after one eager
step, a matching ``record()`` -> ``backward()`` -> ``step()`` runs as one
function, a CUDA graph on a card, which ``step`` executes; a step the
capture cannot hold runs eagerly as described here.

The eager update takes the fused whole-set step (``optimizer.
fused_step``: one multi-tensor call per group of equal attributes) when
it accepts the optimizer, else ``aggregate_num`` parameters per call
(``Updater.update_multi``), else one parameter at a time.  With a
single-process store (``"device"``, ``"local"``) and the fused step on,
the reduction of one value per key is an identity and is folded away
(``_fold_device_allreduce``); with ``update_on_kvstore`` the store runs
the optimizer on its copy of each weight and the parameters pull the
result.

ZeRO (``zero=1``) and the distributed stores are not ported yet
(distribution, queue 1 item 11).
"""
from __future__ import annotations

import os
from typing import List

from .. import optimizer as opt_mod
from .. import telemetry, tracing
from ..imperative import cached_step
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _zero_requested(zero) -> bool:
    if zero is None:
        return os.environ.get("MXNET_ZERO", "0").lower() in (
            "1", "true", "on")
    return bool(zero)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None, zero=None):
        if isinstance(params, (dict, ParameterDict)):
            params = [params[key] for key in sorted(params.keys())]
        else:
            params = list(params)
        self._params: List[Parameter] = []
        for param in params:
            if not isinstance(param, Parameter):
                raise MXNetError(f"Trainer expects Parameter instances, "
                                 f"got {type(param)}")
            param._trainer = self
            self._params.append(param)
        if compression_params:
            raise MXNetError("gradient compression is not ported yet "
                             "(distribution, queue 1 item 11)")
        self._scale = 1.0
        self._init_optimizer(optimizer, optimizer_params or {})
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._zero = zero
        self._check_zero()
        cached_step.register_trainer(self)

    def _check_zero(self):
        if _zero_requested(self._zero):
            raise MXNetError("Trainer(zero=1) (ZeRO-1 sharding of the "
                             "update) is not ported yet (distribution, "
                             "queue 1 item 11)")

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: p for i, p in enumerate(self._params)}
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params:
                raise MXNetError("optimizer_params must be empty when "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = param_dict
        self._updaters = [opt_mod.get_updater(self._optimizer)]

    # -- kvstore (``mxnet_tpu/gluon/trainer.py:82-126``) ---------------------
    def _init_kvstore(self):
        config = self._kvstore_params
        kv = config["kvstore"]
        if kv is None or kv is False:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            from .. import kvstore as kv_mod
            self._kvstore = kv_mod.create(kv) if isinstance(kv, str) else kv
            uok = config["update_on_kvstore"]
            if uok is None:
                env = os.environ.get("MXNET_UPDATE_ON_KVSTORE")
                if env is not None:
                    try:
                        uok = bool(int(env))
                    except ValueError:
                        raise MXNetError(
                            f"invalid MXNET_UPDATE_ON_KVSTORE={env!r}; "
                            f"expected an integer") from None
                else:
                    uok = False        # single process: update locally
            if uok and not self._kvstore.has_capability("optimizer"):
                uok = False
            self._update_on_kvstore = uok
            for i, p in enumerate(self._params):
                if p._data is not None:
                    self._kvstore.init(str(i), p._data_nd())
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
        self._kv_initialized = True

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _set_rescale(self, batch_size):
        new_rescale = self._scale / batch_size
        if new_rescale != self._optimizer.rescale_grad:
            self._optimizer.rescale_grad = new_rescale

    # -- the step (``mxnet_tpu/gluon/trainer.py:214-267``) -------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients and update every parameter, with
        ``rescale_grad = _scale / batch_size``."""
        tok = telemetry.begin_step()
        try:
            with tracing.span("step.gluon",
                              step=self._optimizer.num_update + 1):
                self._check_zero()
                if not self._kv_initialized:
                    self._init_kvstore()
                self._set_rescale(batch_size)
                # the whole-step capture: a deferred record -> backward
                # -> step runs here as one function; otherwise the eager
                # step below is observed so that the next one can be
                if cached_step.trainer_step(self, ignore_stale_grad):
                    return
                if not self._fold_device_allreduce():
                    with tracing.span("step.allreduce"):
                        self._allreduce_grads()
                with tracing.span("step.update"):
                    self._update(ignore_stale_grad)
        finally:
            telemetry.end_step(tok, "gluon.Trainer")

    def _fold_device_allreduce(self):
        """True when the reduction folds into the update: a
        single-process store reduces each key over one pushed value, an
        identity, so the fused update reads ``param.grad()`` itself."""
        if self._kvstore is None or self._update_on_kvstore:
            return False
        from ..kvstore.kvstore import KVStore
        from ..optimizer import fused_step
        return type(self._kvstore) is KVStore and fused_step.enabled()

    def allreduce_grads(self):
        if not self._kv_initialized:
            self._init_kvstore()
        self._allreduce_grads()

    def _allreduce_grads(self):
        """One pushpull for every live parameter: the reduced gradient
        back into its buffer, or, updating on the store, the updated
        weight into the parameter."""
        if self._kvstore is None:
            return
        keys, grads, outs = [], [], []
        for i, param in enumerate(self._params):
            if param.grad_req != "null" and param._grad is not None:
                keys.append(str(i))
                grads.append(param.grad())
                outs.append(param._data_nd() if self._update_on_kvstore
                            else param.grad())
        if keys:
            self._kvstore.pushpull(keys, grads, out=outs)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update alone, after the caller reduced the gradients
        (``allreduce_grads``)."""
        tok = telemetry.begin_step()
        try:
            with tracing.span("step.gluon_update"):
                # only step() owns the whole-step capture: materialize
                # any deferral
                cached_step.break_if_deferring("Trainer.update")
                self._check_zero()
                if not self._kv_initialized:
                    self._init_kvstore()
                self._set_rescale(batch_size)
                with tracing.span("step.update"):
                    self._update(ignore_stale_grad)
        finally:
            telemetry.end_step(tok, "gluon.Trainer")

    def _update(self, ignore_stale_grad=False):
        if self._update_on_kvstore and self._kvstore is not None:
            return            # the store updated the weights in pushpull
        updater = self._updaters[0]
        live = []
        for i, param in enumerate(self._params):
            if param.grad_req == "null" or param._data is None:
                continue
            if param._grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(f"parameter {param.name} has no gradient")
            live.append((i, param))
        from ..optimizer import fused_step
        if fused_step.step(updater, [(i, p._data_nd(), p.grad())
                                     for i, p in live]):
            return
        agg = getattr(self._optimizer, "aggregate_num", 0)
        if agg and agg > 1:
            for c in range(0, len(live), agg):
                chunk = live[c:c + agg]
                updater.update_multi([i for i, _ in chunk],
                                     [p.grad() for _, p in chunk],
                                     [p._data_nd() for _, p in chunk])
        else:
            for i, param in live:
                updater(i, param.grad(), param._data_nd())

    # -- optimizer state (the reference's npz blob) --------------------------
    def _device(self):
        for p in self._params:
            if p._data is not None:
                return p._data.device
        return None

    def save_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read(), device=self._device())
