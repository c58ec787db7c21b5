"""The optimizer base, the whole family and the ``Updater`` (counterpart
of ``mxnet_tpu/optimizer/optimizer.py``).

An optimizer holds the hyper-parameters (learning rate or schedule,
weight decay, gradient rescale and clip, per-parameter multipliers), the
update counts, and the name of its update op in ``ops/optimizer_ops.py``.
Two kinds of caller use it:

- ``SPMDTrainer`` reads ``op_name``, ``static_params`` and
  ``create_state`` (on tensors) and runs the op's multi-tensor form
  itself, inside its captured step;
- the eager path — ``Updater`` (``gluon.Trainer``, the kvstore) — calls
  ``update`` / ``update_multi_precision`` / ``update_multi`` on
  NDArrays.  The new weight and states are written into the NDArrays'
  tensors in place (the reference rebinds its immutable buffers): a
  Gluon parameter keeps the tensor its layers read.  Adam folds its bias
  correction into lr here, as the reference does.

``multi_precision`` keeps an f32 master for float16 weights only, as
the reference does.  ``Updater.get_states`` / ``set_states`` read and
write the reference's ``mxnet_tpu-updater-states-v1`` npz blob (a JSON
header, no pickle, bf16 stored as its 16-bit pattern), so a blob saved
by either package loads in the other.
"""
from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as onp
import torch

from .. import telemetry as _telemetry
from ..base import MXNetError, numpy_bits, tensor_from_bits
from ..ops import optimizer_ops

__all__ = ["Optimizer", "Updater", "create", "register", "get_updater",
           "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta", "Adamax",
           "Nadam", "RMSProp", "FTML", "FTRL", "LAMB", "LARS", "Signum",
           "SGLD", "DCASGD", "LANS", "GroupAdaGrad", "Test",
           "dispatch_count"]

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


# one tick per update-op call of the eager path (a parameter's update, an
# aggregated group, or one group of the fused step)
_DISPATCHES = _telemetry.counter("optimizer.dispatches")
_ALL_DISPATCHES = _telemetry.counter("dispatch.count")


def _note_dispatch(n: int = 1) -> None:
    _DISPATCHES.inc(n)
    _ALL_DISPATCHES.inc(n)


def dispatch_count() -> int:
    """Update-op calls of the eager path in this process."""
    return _DISPATCHES.value


def _tensor(a) -> torch.Tensor:
    """The tensor of an NDArray, or the tensor itself."""
    return a if isinstance(a, torch.Tensor) else a._data


def _like(weight, t: torch.Tensor):
    """``t`` in the kind of ``weight``: a tensor, or an NDArray over it."""
    if isinstance(weight, torch.Tensor):
        return t
    from ..ndarray.ndarray import NDArray
    return NDArray._wrap(t)


@torch.no_grad()
def write_back(dests, news) -> None:
    """Copy each new value into its destination tensor in place, all in
    one multi-tensor copy.  A new value that is itself one of the
    destinations (DCASGD's state is the weight before the update) is
    copied aside first."""
    dests = [_tensor(d) for d in dests]
    ids = {id(d) for d in dests}
    news = [n.clone() if id(n) in ids else n for n in news]
    torch._foreach_copy_(dests, news)


def _clip_value(clip):
    return float(clip) if clip is not None else -1.0


class Optimizer:
    """Base optimizer: the reference's constructor, schedules and
    multipliers, state creation and the eager update."""

    op_name: Optional[str] = None     # the update op in ops/optimizer_ops
    uses_lr = True

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=None, lr_scheduler=None,
                 multi_precision=False, param_dict=None, aggregate_num=0,
                 use_fused_step=True, **extra):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate if learning_rate is not None else 0.01
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None and learning_rate is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        if aggregate_num == 0:
            aggregate_num = int(os.environ.get(
                "MXNET_OPTIMIZER_AGGREGATION_SIZE", "0"))
        self.aggregate_num = aggregate_num
        self.param_dict = param_dict or {}
        self.idx2name = param_idx2name or {}
        self.num_update = 0
        self._index_update_count: Dict[Any, int] = {}
        self._lr_mult: Dict[Any, float] = {}
        self._wd_mult: Dict[Any, float] = {}

    # -- schedules and multipliers ---------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already been "
                             "defined")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self._lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self._wd_mult = dict(args_wd_mult)

    def _get_lr(self, index) -> float:
        lr = self.learning_rate
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            lr *= getattr(self.param_dict[name], "lr_mult", 1.0)
        lr *= self._lr_mult.get(name, 1.0)
        return lr

    def _get_wd(self, index) -> float:
        wd = self.wd
        name = self.idx2name.get(index, index)
        if name in self.param_dict:
            wd *= getattr(self.param_dict[name], "wd_mult", 1.0)
        wd *= self._wd_mult.get(name, 1.0)
        return wd

    def _update_count(self, index):
        cnt = self._index_update_count.get(index, 0) + 1
        self._index_update_count[index] = cnt
        self.num_update = max(cnt, self.num_update)
        return cnt

    # -- state -------------------------------------------------------------
    def create_state(self, index, weight) -> tuple:
        """The state of one weight: tensors for a tensor (the trainer's),
        NDArrays for an NDArray."""
        return ()

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and _tensor(weight).dtype == torch.float16:
            master = _like(weight, _tensor(weight).detach().float())
            return (master,) + tuple(self.create_state(index, master))
        return self.create_state(index, weight)

    def _zeros_state(self, weight, n=1, dtype=None):
        t = _tensor(weight)
        return tuple(_like(weight, torch.zeros(
            t.shape, dtype=dtype or t.dtype, device=t.device))
            for _ in range(n))

    def static_params(self, index) -> Dict[str, Any]:
        """The op's fixed attributes (everything but lr, wd and the
        tensors)."""
        return {}

    # -- the fused step's hooks (optimizer/fused_step.py) -------------------
    def _fused_statics(self, index) -> Optional[Dict[str, Any]]:
        """The attributes the fused step's multi-tensor call takes as they
        are, or None where the fused step declines: a custom ``update``,
        or attributes that move with the update count (``t``,
        ``m_schedule``).  lr, wd and rescale_grad are not here: they go
        in per parameter (:meth:`_fused_dynamics`)."""
        if type(self).update is not Optimizer.update:
            return None
        statics = dict(self.static_params(index))
        if "t" in statics or "m_schedule" in statics:
            return None
        statics["clip_gradient"] = _clip_value(self.clip_gradient)
        return statics

    def _fused_dynamics(self, index) -> Dict[str, float]:
        """This step's lr, wd and rescale_grad for one parameter, called
        after its update count moved."""
        d = {"wd": self._get_wd(index),
             "rescale_grad": float(self.rescale_grad)}
        if self.uses_lr:
            d["lr"] = self._get_lr(index)
        return d

    # -- the eager update ----------------------------------------------------
    def _op_params(self, index):
        params = dict(self.static_params(index))
        params.setdefault("rescale_grad", float(self.rescale_grad))
        params.setdefault("clip_gradient", _clip_value(self.clip_gradient))
        return params

    @torch.no_grad()
    def _apply(self, weight, grad, state, params, lr, wd):
        """Run the op on the tensors (outside autograd: a Gluon weight is
        a variable) and write the results back."""
        kw = dict(params, wd=wd)
        if self.uses_lr:
            kw["lr"] = lr
        fn = getattr(optimizer_ops, self.op_name)
        out = fn(_tensor(weight), _tensor(grad),
                 *[_tensor(s) for s in state], **kw)
        _note_dispatch()
        outs = out if isinstance(out, tuple) else (out,)
        write_back([weight, *state], outs)

    def update(self, index, weight, grad, state):
        """One update of ``weight`` (and its ``state``) from ``grad``, in
        place."""
        params = self._op_params(index)   # before the count moves: t
        self._update_count(index)
        self._apply(weight, grad, state, params, self._get_lr(index),
                    self._get_wd(index))

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _tensor(weight).dtype == torch.float16:
            master, sub_state = state[0], state[1:]
            grad32 = _like(grad, _tensor(grad).float())
            self.update(index, master, grad32, sub_state)
            write_back([weight], [_tensor(master).to(torch.float16)])
        else:
            self.update(index, weight, grad, state)

    @torch.no_grad()
    def update_multi(self, indices, weights, grads, states):
        """An aggregated update of a group of parameters: one call of the
        op's multi-tensor form where the group shares its attributes, lr
        and wd (``aggregate_num``); else one update each."""
        multi = getattr(optimizer_ops, f"{self.op_name}_multi", None) \
            if self.op_name else None
        if type(self).update is not Optimizer.update or multi is None or (
                self.multi_precision
                and any(_tensor(w).dtype == torch.float16 for w in weights)):
            for i, w, g, s in zip(indices, weights, grads, states):
                self.update_multi_precision(i, w, g, s)
            return
        keys = {tuple(sorted(self.static_params(i).items()))
                for i in indices}
        lrwds = [(self._get_lr(i), self._get_wd(i)) for i in indices]
        if len(keys) != 1 or len(set(lrwds)) != 1:
            for i, w, g, s in zip(indices, weights, grads, states):
                self.update(i, w, g, s)
            return
        for i in indices:
            self._update_count(i)
        # after the counts moved, so a schedule sees the same num_update
        # as the per-parameter path
        lr, wd = self._get_lr(indices[0]), self._get_wd(indices[0])
        params = dict(keys.pop())
        params.setdefault("rescale_grad", float(self.rescale_grad))
        params.setdefault("clip_gradient", _clip_value(self.clip_gradient))
        n = len(weights)
        kw = dict(params, wds=[wd] * n)
        if self.uses_lr:
            kw["lrs"] = [lr] * n
        state_lists = [[_tensor(s[j]) for s in states]
                       for j in range(len(states[0]))]
        out = multi([_tensor(w) for w in weights],
                    [_tensor(g) for g in grads], *state_lists, **kw)
        _note_dispatch()
        dests = list(weights) + [s for st in state_lists for s in st]
        write_back(dests, [t for col in out for t in col])


# --------------------------------------------------------------------------
# the family (``mxnet_tpu/optimizer/optimizer.py:424-962``)
# --------------------------------------------------------------------------

@register
class SGD(Optimizer):
    """SGD, with momentum unless ``momentum`` is 0: the op is
    ``sgd_mom_update`` with one momentum state a weight, else
    ``sgd_update`` with none.  ``lazy_update`` is accepted (it matters
    only for sparse gradients, which the port does not have)."""

    def __init__(self, learning_rate=0.01, momentum=0.0, lazy_update=True,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update
        self.op_name = "sgd_mom_update" if momentum != 0.0 else "sgd_update"

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return self._zeros_state(weight, 1)

    def static_params(self, index):
        return {"momentum": self.momentum} if self.momentum != 0.0 else {}


@register
class NAG(Optimizer):
    def __init__(self, learning_rate=0.1, momentum=0.9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.op_name = "nag_mom_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 1)

    def static_params(self, index):
        return {"momentum": self.momentum}


@register
class Adam(Optimizer):
    """Adam; the eager update folds the bias correction into lr, ``lr ·
    √(1 - β2ᵗ) / (1 - β1ᵗ)`` with t this parameter's update count.
    ``SPMDTrainer`` runs the op without it, as the reference's does."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.op_name = "adam_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def static_params(self, index):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}

    def _fused_statics(self, index):
        # update() below is a pure override (the fold): fusable
        statics = dict(self.static_params(index))
        statics["clip_gradient"] = _clip_value(self.clip_gradient)
        return statics

    def _fused_dynamics(self, index):
        # the same fold in the same order as update(), after the count
        # moved: this step's t is the current count
        t = self._index_update_count.get(index, 1)
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        lr = self._get_lr(index) * (coef2 ** 0.5) / coef1
        return {"lr": lr, "wd": self._get_wd(index),
                "rescale_grad": float(self.rescale_grad)}

    def update(self, index, weight, grad, state):
        t = self._index_update_count.get(index, 0) + 1
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        lr = self._get_lr(index) * (coef2 ** 0.5) / coef1
        self._update_count(index)
        self._apply(weight, grad, state, self._op_params(index), lr,
                    self._get_wd(index))


@register
class AdamW(Adam):
    """Decoupled weight decay, ``w -= eta·(lr·m/(√v + ε) + wd·w)``; the
    eager update folds Adam's bias correction into lr as Adam does."""

    def __init__(self, learning_rate=0.001, eta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.eta = eta
        self.op_name = "adamw_update"

    def static_params(self, index):
        p = dict(super().static_params(index))
        p.pop("t", None)
        p["eta"] = self.eta
        return p


@register
class AdaGrad(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon=1e-7, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.epsilon = epsilon
        self.op_name = "adagrad_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 1)

    def static_params(self, index):
        return {"epsilon": self.epsilon}


@register
class AdaDelta(Optimizer):
    uses_lr = False

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon
        self.op_name = "adadelta_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def static_params(self, index):
        return {"rho": self.rho, "epsilon": self.epsilon}


@register
class Adamax(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.op_name = "adamax_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def static_params(self, index):
        t = self._index_update_count.get(index, 0) + 1
        return {"beta1": self.beta1, "beta2": self.beta2, "t": t}


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self._msched: Dict[Any, Tuple[int, float]] = {}
        self.op_name = "nadam_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def static_params(self, index):
        # the momentum schedule's product over the earlier steps, kept per
        # parameter; the same answer when asked twice at one step
        t = self._index_update_count.get(index, 0) + 1
        cached_t, cached_v = self._msched.get(index, (0, 1.0))
        if cached_t != t:
            if cached_t == t - 1:
                v, start = cached_v, max(t - 1, 1)
            else:
                v, start = 1.0, 1
            for i in range(start, t):
                v *= self.beta1 * (1.0 - 0.5 * 0.96
                                   ** (i * self.schedule_decay))
            self._msched[index] = (t, v)
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon, "t": t,
                "schedule_decay": self.schedule_decay,
                "m_schedule": self._msched[index][1]}


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.rho, self.momentum, self.epsilon = rho, momentum, epsilon
        self.centered = centered
        self.clip_weights = clip_weights
        self.op_name = "rmspropalex_update" if centered else \
            "rmsprop_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 3 if self.centered else 1)

    def static_params(self, index):
        p = {"gamma1": self.rho, "epsilon": self.epsilon,
             "clip_weights": float(self.clip_weights)
             if self.clip_weights is not None else -1.0}
        if self.centered:
            p["gamma2"] = self.momentum
        return p


@register
class FTML(Optimizer):
    def __init__(self, learning_rate=0.0025, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.op_name = "ftml_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 3)

    def static_params(self, index):
        t = self._index_update_count.get(index, 0) + 1
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon, "t": t}

    def update(self, index, weight, grad, state):
        # the op's clip is named clip_grad, and t is read after the count
        # moved, as in the reference
        self._update_count(index)
        params = dict(self.static_params(index))
        params["rescale_grad"] = float(self.rescale_grad)
        params["clip_grad"] = _clip_value(self.clip_gradient)
        self._apply(weight, grad, state, params, self._get_lr(index),
                    self._get_wd(index))


@register
class FTRL(Optimizer):
    def __init__(self, learning_rate=0.1, lamda1=0.01, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta
        self.op_name = "ftrl_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def static_params(self, index):
        return {"lamda1": self.lamda1, "beta": self.beta}


@register
class LAMB(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction
        self.op_name = "lamb_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def static_params(self, index):
        t = self._index_update_count.get(index, 0) + 1
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon, "t": t,
                "bias_correction": self.bias_correction,
                "lower_bound": float(self.lower_bound)
                if self.lower_bound is not None else -1.0,
                "upper_bound": float(self.upper_bound)
                if self.upper_bound is not None else -1.0}


@register
class LARS(Optimizer):
    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.eta, self.epsilon = momentum, eta, epsilon
        self.op_name = "lars_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 1)

    def static_params(self, index):
        return {"momentum": self.momentum, "eta": self.eta,
                "epsilon": self.epsilon}


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum, self.wd_lh = momentum, wd_lh
        self.op_name = "signum_update" if momentum != 0.0 else \
            "signsgd_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 1) if self.momentum != 0.0 else ()

    def static_params(self, index):
        if self.momentum != 0.0:
            return {"momentum": self.momentum, "wd_lh": self.wd_lh}
        return {}


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: the noise is drawn from
    PyTorch's default generator (``torch.manual_seed``), so it never
    matches the reference's stream; only its statistics do."""

    def __init__(self, learning_rate=0.1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.op_name = "sgld_update"

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = _tensor(weight)
        noise = torch.randn(w.shape, device=w.device).to(w.dtype)
        out = optimizer_ops.sgld_update(
            w, _tensor(grad), noise, lr=lr, wd=wd,
            rescale_grad=self.rescale_grad,
            clip_gradient=_clip_value(self.clip_gradient))
        _note_dispatch()
        write_back([weight], [out])


@register
class DCASGD(Optimizer):
    def __init__(self, learning_rate=0.01, lamda=0.04, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda = lamda
        self.op_name = "dcasgd_update"

    def create_state(self, index, weight):
        # the weight's value (a copy: the eager update writes in place)
        return (_like(weight, _tensor(weight).detach().clone()),)

    def static_params(self, index):
        return {"lamda": self.lamda}


@register
class Test(Optimizer):
    """``w += rescale_grad · grad``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def create_state(self, index, weight):
        return ()

    @torch.no_grad()
    def update(self, index, weight, grad, state):
        self._update_count(index)
        write_back([weight], [_tensor(weight)
                              + self.rescale_grad * _tensor(grad)])


@register
class LANS(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.op_name = "lans_update"

    def create_state(self, index, weight):
        return self._zeros_state(weight, 2)

    def static_params(self, index):
        t = self._index_update_count.get(index, 0) + 1
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon, "t": t,
                "lower_bound": float(self.lower_bound)
                if self.lower_bound is not None else -1.0,
                "upper_bound": float(self.upper_bound)
                if self.upper_bound is not None else -1.0}


@register
class GroupAdaGrad(Optimizer):
    """AdaGrad with one accumulator per row; no weight decay."""

    def __init__(self, learning_rate=0.01, epsilon=1e-5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        if self.wd:
            raise MXNetError("GroupAdaGrad does not support weight decay")
        self.epsilon = epsilon
        self.op_name = "group_adagrad_update"

    def create_state(self, index, weight):
        t = _tensor(weight)
        shape = (t.shape[0],) + (1,) * (t.dim() - 1)
        return (_like(weight, torch.zeros(shape, dtype=t.dtype,
                                          device=t.device)),)

    def static_params(self, index):
        return {"epsilon": self.epsilon}


# --------------------------------------------------------------------------
# Updater (``mxnet_tpu/optimizer/optimizer.py:797-916``)
# --------------------------------------------------------------------------

class Updater:
    """The per-parameter state dict of one optimizer, and the call that
    updates a parameter with it."""

    _STATES_FORMAT = "mxnet_tpu-updater-states-v1"

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def _ensure_state(self, index, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            self.states_synced[index] = True

    def __call__(self, index, grad, weight):
        self._ensure_state(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def update_multi(self, indices, grads, weights):
        for index, weight in zip(indices, weights):
            self._ensure_state(index, weight)
        self.optimizer.update_multi(indices, weights, grads,
                                    [self.states[i] for i in indices])

    def get_states(self, dump_optimizer=False) -> bytes:
        """The states as the reference's npz blob: a JSON header naming
        each key, its slots and their dtypes; no pickle.  The header also
        keeps the optimizer's update counts (``counts``: ``num_update``
        and each index's), which the reference's blob drops: a resumed
        optimizer then continues its bias correction and schedule where
        it stopped.  The reference's reader ignores the field."""
        arrays, keys = {}, []
        for j, (k, v) in enumerate(self.states.items()):
            tup = v if isinstance(v, tuple) else (v,)
            ent = {"key": k if isinstance(k, str) else int(k),
                   "str": isinstance(k, str), "slots": len(tup),
                   "tuple": isinstance(v, tuple), "dtypes": []}
            for i, s in enumerate(tup):
                d, name = numpy_bits(_tensor(s))
                ent["dtypes"].append(name)
                arrays[f"s{j}::{i}"] = d
            keys.append(ent)
        opt = self.optimizer
        header = {"format": self._STATES_FORMAT, "keys": keys,
                  "counts": {"num_update": int(opt.num_update),
                             "index": [[k, int(c)] for k, c in
                                       opt._index_update_count.items()]}}
        if dump_optimizer:
            header["optimizer"] = type(self.optimizer).__name__
        arrays["__header__"] = onp.frombuffer(
            json.dumps(header).encode("utf-8"), dtype=onp.uint8)
        buf = io.BytesIO()
        onp.savez(buf, **arrays)
        return buf.getvalue()

    def set_states(self, states: bytes, device=None):
        """Restore :meth:`get_states` bytes (of either package) onto
        ``device`` (default: the current context's).  Only the versioned
        npz format is read (``allow_pickle=False``)."""
        from ..context import current_context
        from ..ndarray.ndarray import NDArray
        try:
            z = onp.load(io.BytesIO(states), allow_pickle=False)
        except Exception as e:
            raise MXNetError(
                "optimizer states are not in the updater-states npz format "
                "(pickled states are refused: loading a pickle can run "
                f"arbitrary code): {e}") from e
        with z:
            if "__header__" not in z:
                raise MXNetError("optimizer states blob has no __header__ "
                                 "entry; not an updater-states payload")
            header = json.loads(bytes(z["__header__"]).decode("utf-8"))
            if header.get("format") != self._STATES_FORMAT:
                raise MXNetError(f"unknown updater-states format "
                                 f"{header.get('format')!r}")
            dev = device if device is not None else \
                current_context().torch_device
            out = {}
            for j, ent in enumerate(header["keys"]):
                k = str(ent["key"]) if ent.get("str") else int(ent["key"])
                dtypes = ent.get("dtypes") or []
                slots = [NDArray._wrap(tensor_from_bits(
                    z[f"s{j}::{i}"], dtypes[i] if i < len(dtypes) else None,
                    dev)) for i in range(int(ent["slots"]))]
                out[k] = tuple(slots) if ent.get("tuple", True) \
                    else slots[0]
        self.states = out
        self.states_synced = {k: True for k in self.states}
        counts = header.get("counts")
        if counts:                     # a blob the port wrote
            self.optimizer.num_update = int(counts["num_update"])
            self.optimizer._index_update_count = {
                k: int(c) for k, c in counts["index"]}


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)

