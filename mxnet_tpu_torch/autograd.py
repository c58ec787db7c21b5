"""Imperative autograd over ``torch.autograd`` (counterpart of
``mxnet_tpu/autograd.py``).

Two users share this module.  The captured trainer (``SPMDTrainer``)
works on tensors: it reads ``is_training()`` and scopes it with
``train_mode``/``predict_mode``/``pause`` (which also turns PyTorch's
gradient recording off), and takes gradients from ``torch.autograd``
itself.  The NDArray path — ``mx.nd`` and the eager Gluon loop, whose
Blocks take NDArrays and whose Parameters are variables with gradient
buffers (``gluon/parameter.py``), so that ``backward`` fills the buffers
``gluon.Trainer`` reads, and ``record(train_mode=…)`` drives the
layers' ``is_training()`` — keeps MXNet's semantics on top of
``torch.autograd``:

- ``record()`` turns recording on; ops dispatched through the registry
  build a graph only then (``ops/registry.py`` runs them under
  ``torch.no_grad()`` otherwise).  ``record(train_mode=…)`` also sets
  ``is_training``.
- ``attach_grad``/``mark_variables`` make an array a variable with a
  gradient buffer and a ``grad_req``: ``write`` overwrites the buffer
  on each ``backward``, ``add`` accumulates, ``null`` leaves it.
  Gradients are delivered explicitly (``torch.autograd.grad``), never
  through a tensor's ``.grad``, which torch only accumulates.  They are
  taken at the variable's leaf: a recorded in-place update (``x *= 2``
  inside ``record()``) rebinds the array to the op's result but the
  gradient is still that of the value it had when it was marked, as on
  the reference's tape; ``backward`` without ``retain_graph`` then makes
  the updated value the new leaf.
- A head's default gradient is ones of its shape; heads that were never
  recorded raise :class:`MXNetError`.
- ``grad`` returns gradients without touching the buffers;
  ``create_graph=True`` makes them differentiable again.
- ``Function`` is MXNet's custom differentiable function, with
  ``forward``/``backward`` on NDArrays, over ``torch.autograd.Function``.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["is_training", "set_training", "is_recording", "set_recording",
           "record", "train_mode", "predict_mode", "pause",
           "mark_variables", "backward", "grad", "Function"]

_state = threading.local()

# every live variable (attach_grad / mark_variables), by id; an entry
# goes when its NDArray is collected
_VARIABLES: "weakref.WeakValueDictionary[int, object]" = \
    weakref.WeakValueDictionary()

_GRAD_REQS = ("write", "add", "null")


def is_training() -> bool:
    return getattr(_state, "training", False)


def set_training(flag: bool) -> bool:
    old = is_training()
    _state.training = bool(flag)
    return old


def is_recording() -> bool:
    return getattr(_state, "recording", False)


def set_recording(flag: bool) -> bool:
    old = is_recording()
    _state.recording = bool(flag)
    return old


class _Scope:
    """Sets the training flag, and optionally the recording flag and
    PyTorch's gradient mode, for a ``with`` block; ``None`` leaves a
    flag as it is."""

    def __init__(self, training=None, grad=None, recording=None):
        self._train, self._grad, self._rec = training, grad, recording

    def __enter__(self):
        if self._train is not None:
            self._old_train = set_training(self._train)
        if self._rec is not None:
            self._old_rec = set_recording(self._rec)
        if self._grad is not None:
            self._old_grad = torch.is_grad_enabled()
            torch.set_grad_enabled(self._grad)
        return self

    def __exit__(self, *exc):
        if self._train is not None:
            set_training(self._old_train)
        if self._rec is not None:
            set_recording(self._old_rec)
        if self._grad is not None:
            torch.set_grad_enabled(self._old_grad)
        return False


def record(train_mode: bool = True) -> _Scope:
    """``with autograd.record():`` — record NDArray ops for ``backward``
    (and set training mode, unless ``train_mode=False``)."""
    return _Scope(train_mode, recording=True)


def train_mode() -> _Scope:
    return _Scope(True)


def predict_mode() -> _Scope:
    return _Scope(False)


def pause(train_mode: bool = False) -> _Scope:
    """Stop recording for the scope, in training mode or not; PyTorch's
    own gradient recording (``torch.no_grad``) stops too."""
    return _Scope(train_mode, grad=False, recording=False)


def mark_variables(variables, gradients, grad_reqs="write") -> None:
    """Make each array a variable whose gradient lands in the matching
    buffer, under its ``grad_req`` (``write``, ``add`` or ``null``)."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        if req not in _GRAD_REQS:
            raise MXNetError(f"grad_req must be one of {_GRAD_REQS}, got "
                             f"{req!r}")
        t = var._data
        if req != "null" and not t.requires_grad:
            if not t.is_floating_point():
                raise MXNetError(f"a variable needs a floating dtype, got "
                                 f"{t.dtype}")
            # a new tensor object over the same storage: other arrays
            # sharing the old one are not turned into variables
            t = t.detach().requires_grad_()
        var._data = var._leaf = t
        var._grad, var._grad_req = g, req
        _VARIABLES[id(var)] = var


def _heads(heads, head_grads):
    """(tensors, seeds) of the heads; raises unless one was recorded."""
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
        if head_grads is not None and not isinstance(head_grads,
                                                     (list, tuple)):
            head_grads = [head_grads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    outs, seeds = [], []
    for h, hg in zip(heads, head_grads):
        if h._data.requires_grad:
            outs.append(h._data)
            seeds.append(torch.ones_like(h._data) if hg is None
                         else hg._data)
    if not outs:
        raise MXNetError("backward: none of the heads is in a recorded "
                         "graph; run the computation inside "
                         "autograd.record()")
    return outs, seeds


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True, create_graph: bool = False) -> None:
    """Gradients of ``heads`` into every reachable variable's buffer,
    under its ``grad_req`` (parity: ``mxnet_tpu/autograd.py:212``)."""
    outs, seeds = _heads(heads, head_grads)
    variables = [v for v in list(_VARIABLES.values())
                 if v._grad_req != "null" and v._leaf.requires_grad]
    if not variables:
        return
    with _Scope(train_mode):
        grads = torch.autograd.grad(
            outs, [v._leaf for v in variables], seeds,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
    for v, g in zip(variables, grads):
        if g is None:                   # not reachable from the heads
            continue
        if not create_graph:
            g = g.detach()
        buf = v._grad
        buf._data = buf._data + g if v._grad_req == "add" else g
    if not retain_graph:                # the recorded graph is spent
        for v in variables:
            if v._data is not v._leaf:
                v._rebind(v._data)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    NDArrays; no buffer is touched (parity: ``mxnet_tpu/autograd.py:528``).
    The variables must have been marked (``attach_grad``) before the
    heads were recorded."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    outs, seeds = _heads(heads, head_grads)
    for v in variables:
        if v._leaf is None or not v._leaf.requires_grad:
            raise MXNetError("grad: a variable was not marked; call "
                             "attach_grad() on it before recording")
    with _Scope(train_mode):
        grads = torch.autograd.grad(
            outs, [v._leaf for v in variables], seeds,
            retain_graph=retain_graph, create_graph=create_graph,
            allow_unused=True)
    results = []
    for g in grads:
        if g is None:
            raise MXNetError("one of the variables is not differentiably "
                             "connected to the heads")
        results.append(NDArray._wrap(g if create_graph else g.detach()))
    return results[0] if single else results


class _FunctionBridge(torch.autograd.Function):
    """Puts a user :class:`Function` into the torch graph: its
    ``forward`` and ``backward`` run on NDArrays with recording off."""

    @staticmethod
    def forward(ctx, func, *tensors):
        from .ndarray.ndarray import NDArray
        with _Scope(recording=False):
            out = func.forward(*[NDArray._wrap(t) for t in tensors])
        func._multi = isinstance(out, (list, tuple))
        ctx.func = func
        return tuple(o._data for o in (out if func._multi else [out]))

    @staticmethod
    def backward(ctx, *cts):
        from .ndarray.ndarray import NDArray
        with _Scope(recording=False):
            gin = ctx.func.backward(*[NDArray._wrap(c) for c in cts])
        if not isinstance(gin, (list, tuple)):
            gin = [gin]
        return (None, *[None if g is None else g._data for g in gin])


class Function:
    """User-defined differentiable function (parity:
    ``mxnet_tpu/autograd.py:570``): subclass, implement
    ``forward(self, *inputs)`` and ``backward(self, *output_grads)`` on
    NDArrays, and call the instance on NDArrays."""

    def __init__(self):
        self.saved_tensors = ()
        self._multi = False

    def save_for_backward(self, *args):
        self.saved_tensors = args

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not (is_recording() and any(x._data.requires_grad
                                       for x in inputs)):
            with _Scope(recording=False):
                return self.forward(*inputs)
        with torch.enable_grad():
            outs = _FunctionBridge.apply(self, *[x._data for x in inputs])
        outs = [NDArray._wrap(t) for t in outs]
        return outs if self._multi else outs[0]
