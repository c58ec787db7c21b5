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

``zero=1`` (default ``MXNET_ZERO``, read at each step) shards the
fused update over the dp width of ``parallel.default_mesh``
(``optimizer.fused_step``: ZeRO-1; every rank runs the same step on the
same batch and updates its chunk of the flattened weights and states);
with no process group of more than one rank the width is 1 and nothing
changes.  It splits no batch over the ranks, so a BatchNorm in the loop
takes the statistics of the batch it is given, the whole one, and needs
no cross-rank reducer.  The workers of a distributed store (below) each
train on their own batches and keep their BatchNorm statistics local,
as the reference's do.

With a distributed store (``"dist_sync"``, ``"dist_device_sync"``,
``"dist_async"``: ``kvstore/dist.py``) ``update_on_kvstore`` defaults
to true (``MXNET_UPDATE_ON_KVSTORE`` overrides it): one pushpull a step
carries every gradient and the store's optimizer (ZeRO-1 over the
ranks) returns the weights.  ``compression_params`` (``{"type":
"2bit", "threshold": t}``) go to the store.  ``"p3store_dist"`` takes
no server-side optimizer; its pushpulls are dispatched during the
backward by a grad-ready hook (``autograd.set_grad_ready_hook``), one a
``write`` parameter, and ``step`` pushes only the rest.  A parameter
with ``stype="row_sparse"`` reads its rows through
``_row_sparse_pull``.  A step through any store but a single-process
one is not captured.
"""
from __future__ import annotations

import os
from typing import List

import torch

from .. import optimizer as opt_mod
from .. import telemetry, tracing
from ..imperative import cached_step
from ..base import MXNetError
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


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
        self._compression_params = compression_params
        self._scale = 1.0
        self._init_optimizer(optimizer, optimizer_params or {})
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._distributed = False
        self._zero = zero
        cached_step.register_trainer(self)

    def _zero_active(self):
        """ZeRO-1 requested: ``zero`` when given, else ``MXNET_ZERO``
        (read at each step)."""
        if self._zero is None:
            from ..optimizer import fused_step
            return fused_step.zero_enabled()
        return bool(self._zero)

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
            self._distributed = "dist" in getattr(self._kvstore, "type", "")
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
                    # the distributed stores run the optimizer; a single
                    # process updates locally
                    uok = self._distributed and \
                        self._kvstore.has_capability("optimizer")
            if uok and not self._kvstore.has_capability("optimizer"):
                uok = False
            if getattr(self._kvstore, "type", "") == "p3store_dist":
                # P3 propagates gradients only: updates stay here
                if config["update_on_kvstore"]:
                    raise MXNetError(
                        "p3store_dist has no server-side optimizer "
                        "path; use update_on_kvstore=False")
                uok = False
            self._update_on_kvstore = uok
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            for i, p in enumerate(self._params):
                if p._data is not None:
                    self._kvstore.init(str(i), p._data_nd())
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            self._maybe_install_p3_hook()
        self._kv_initialized = True

    def _maybe_install_p3_hook(self):
        """With a P3 store, a grad-ready hook dispatches each ``write``
        parameter's sliced pushpull the moment its gradient is final,
        during the backward (``mxnet_tpu/gluon/trainer.py:137-186``);
        ``step`` then skips those parameters.  A parameter with
        ``grad_req="add"`` keeps its one push in ``step`` (a push a
        backward would reduce earlier micro-batches again)."""
        from ..kvstore.p3store import P3StoreDist
        if not isinstance(self._kvstore, P3StoreDist) or \
                self._update_on_kvstore:
            return
        import weakref

        from .. import autograd as ag
        self._p3_pushed = set()
        buf2idx = {id(p._grad): (i, p) for i, p in enumerate(self._params)
                   if p._grad is not None and p.grad_req == "write"}
        self_ref = weakref.ref(self)

        def _p3_hook(buf):
            trainer = self_ref()
            if trainer is None:
                ag.set_grad_ready_hook(None)      # the owner is gone
                return
            ent = buf2idx.get(id(buf))
            if ent is None:
                return
            i, p = ent
            if p._grad is not buf:
                return        # a new buffer: the id may be another's
            if p._trainer is not trainer:
                ag.set_grad_ready_hook(None)      # a newer trainer owns it
                return
            # priority -i: the layers the next forward needs first
            trainer._kvstore.pushpull(str(i), p.grad(), out=p.grad(),
                                      priority=-i)
            trainer._p3_pushed.add(i)

        ag.set_grad_ready_hook(_p3_hook)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)
        self._reship_server_optimizer()

    def _reship_server_optimizer(self):
        """The uncoordinated parameter server holds its own copy of the
        optimizer: send it again when a host-side setting changes."""
        if self._kv_initialized and self._update_on_kvstore and \
                getattr(self._kvstore, "_uncoordinated", False):
            self._kvstore.set_optimizer(self._optimizer)

    def _set_rescale(self, batch_size):
        new_rescale = self._scale / batch_size
        if new_rescale != self._optimizer.rescale_grad:
            self._optimizer.rescale_grad = new_rescale
            self._reship_server_optimizer()

    # -- the step (``mxnet_tpu/gluon/trainer.py:214-267``) -------------------
    def step(self, batch_size, ignore_stale_grad=False):
        """Reduce the gradients and update every parameter, with
        ``rescale_grad = _scale / batch_size``."""
        tok = telemetry.begin_step()
        try:
            with tracing.span("step.gluon",
                              step=self._optimizer.num_update + 1):
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
        if self._kvstore is None or self._update_on_kvstore or \
                self._compression_params:
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
        weight into the parameter.  P3 and the adapters take one key a
        call (P3 schedules its own slices; an adapter reads a list as
        one key's replicas), skipping what the grad-ready hook pushed."""
        if self._kvstore is None:
            return
        from ..kvstore.dist import DistKVStore
        from ..kvstore.kvstore import KVStore
        from ..kvstore.p3store import P3StoreDist
        if isinstance(self._kvstore, P3StoreDist) or \
                not isinstance(self._kvstore, (KVStore, DistKVStore)):
            pushed = getattr(self, "_p3_pushed", None)
            for i, param in enumerate(self._params):
                if param.grad_req == "null" or param._grad is None:
                    continue
                if pushed is not None and i in pushed:
                    continue
                out = (param._data_nd() if self._update_on_kvstore
                       else param.grad())
                self._kvstore.pushpull(str(i), param.grad(), out=out,
                                       priority=-i)
            if pushed is not None:
                pushed.clear()
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
                                     for i, p in live],
                           zero=self._zero_active()):
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

    # -- row-sparse parameters (``mxnet_tpu/gluon/trainer.py:378-410``) -----
    def _row_sparse_pull(self, param, row_ids):
        """Pull only ``row_ids`` rows of ``param`` from the store (which
        holds the weights: ``update_on_kvstore`` is required) and write
        them into the parameter's value; returns the
        ``RowSparseNDArray``."""
        if not self._kv_initialized:
            self._init_kvstore()
        if not self._update_on_kvstore:
            raise MXNetError(
                "sparse parameters need update_on_kvstore=True (the "
                "store must hold the authoritative weights to pull "
                "rows from)")
        if not hasattr(self._kvstore, "row_sparse_pull"):
            raise MXNetError(
                f"kvstore {getattr(self._kvstore, 'type', '?')!r} has "
                "no row_sparse_pull")
        try:
            i = self._params.index(param)
        except ValueError:
            raise MXNetError("parameter is not managed by this "
                             "trainer") from None
        rsp = self._kvstore.row_sparse_pull(str(i), row_ids=row_ids)
        if isinstance(rsp, list):
            rsp = rsp[0]
        t = param._data
        with torch.no_grad():
            t.index_copy_(0, rsp.indices.long().to(t.device),
                          rsp.data.to(t.device, t.dtype))
        return rsp

    # -- optimizer state (the reference's npz blob) --------------------------
    def _device(self):
        for p in self._params:
            if p._data is not None:
                return p._data.device
        return None

    def _input_placement(self):
        """The device input batches should be on so the step makes no
        further copy (``mxnet_tpu/gluon/trainer.py:188-200``): the
        parameters' device, else ``cuda:0`` (used by
        ``data.device_pipeline.wrap(loader, trainer)``)."""
        from ..context import gpu
        dev = self._device()
        return dev if dev is not None else gpu(0).torch_device

    def save_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        from ..optimizer import fused_step
        # weight-shaped states (collective under ZeRO)
        fused_step.unshard_states(self._updaters[0])
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname):
        if not self._kv_initialized:
            self._init_kvstore()
        with open(fname, "rb") as f:
            self._updaters[0].set_states(f.read(), device=self._device())
        # weight-shaped states now: a sharded step cuts them again
        getattr(self._updaters[0], "_zero_states", {}).clear()
