"""Gluon Parameter (counterpart of ``mxnet_tpu/gluon/parameter.py``).

A ``Parameter`` describes one weight of a Block — shape (possibly with
unknown dims, filled in by the first forward: deferred init), type,
initializer, ``grad_req`` and lr/wd multipliers — and holds its value as
a ``torch.nn.Parameter`` once initialized: ``data()`` is that tensor,
which the layers read.

For the eager Gluon loop (``autograd.record()``, ``backward``,
``gluon.Trainer``) an initialized parameter with ``grad_req`` ``write``
or ``add`` is also an autograd variable of the NDArray path
(``autograd.mark_variables``): ``_data_nd()`` is an NDArray over the
same tensor, and ``grad()`` its gradient buffer, an NDArray that
``backward`` overwrites (``write``) or adds to (``add``).  ``cast`` and
``set_data`` keep the variable and its buffer in step with the value.
The captured trainer (``SPMDTrainer``) takes its gradients from
``torch.autograd`` itself and never reads the buffer.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from .. import autograd as ag
from .. import initializer as init_mod
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError",
           "torch_dtype"]


class DeferredInitializationError(MXNetError):
    """Parameter accessed before its shape is known."""


def torch_dtype(dtype) -> torch.dtype:
    """``"float32"``/``"bfloat16"``/a ``torch.dtype`` → ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    t = getattr(torch, str(dtype), None)
    if not isinstance(t, torch.dtype):
        raise MXNetError(f"unknown dtype {dtype!r}")
    return t


def _shape_known(shape) -> bool:
    return shape is not None and all(s > 0 for s in shape)


_GRAD_REQS = ("write", "add", "null")


class Parameter:
    """A weight, bias or state tensor of a Block.  ``grad_req`` is
    ``'write'``, ``'add'`` or ``'null'``; deferred init completes on the
    first forward that sees the missing dims.  ``aux_state`` marks an
    auxiliary state of the graph rather than an argument (BatchNorm's
    running statistics, written by the forward, never by an
    optimizer)."""

    def __init__(self, name: str = "weight", grad_req: str = "write",
                 shape=None, dtype="float32", lr_mult: float = 1.0,
                 wd_mult: float = 1.0, init=None, allow_deferred_init=False,
                 aux_state: bool = False):
        if grad_req not in _GRAD_REQS:
            raise MXNetError(f"grad_req must be one of {_GRAD_REQS}, got "
                             f"{grad_req!r}")
        self._name = name
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = torch_dtype(dtype)
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.grad_req = grad_req
        self._is_aux = bool(aux_state)
        self._data: Optional[torch.nn.Parameter] = None
        # the autograd variable over _data and its gradient buffer
        self._nd = None
        self._grad = None
        # the gluon.Trainer this parameter was last handed to
        self._trainer = None
        # (initializer, device, generator) kept until the shape is known
        self._deferred_init = None
        # a stand-in tensor that data() returns while set (the trainer's
        # low-precision copy inside a step)
        self._override: Optional[torch.Tensor] = None

    @property
    def name(self) -> str:
        return self._name

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        if self._shape is None:
            self._shape = tuple(new_shape)
            return
        if len(self._shape) != len(new_shape):
            raise MXNetError(f"shape rank mismatch for {self.name}: "
                             f"{self._shape} vs {tuple(new_shape)}")
        merged = []
        for s0, s1 in zip(self._shape, new_shape):
            if s0 <= 0:
                merged.append(s1)
            elif s1 <= 0 or s0 == s1:
                merged.append(s0)
            else:
                raise MXNetError(f"incompatible shape for {self.name}: "
                                 f"{self._shape} vs {tuple(new_shape)}")
        self._shape = tuple(merged)

    def __repr__(self):
        return f"Parameter {self.name} (shape={self.shape}, " \
               f"dtype={self.dtype})"

    # -- init --------------------------------------------------------------
    def initialize(self, init=None, device=None, default_init=None,
                   force_reinit=False, generator=None):
        """Draw the value now, or once the shape is known.  ``device``
        defaults to ``cuda`` (``"cpu"`` on request); ``generator`` is the
        host ``torch.Generator`` values are drawn from (a fresh one
        seeded with 0 when left out)."""
        if self._data is not None and not force_reinit:
            return
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        eff = self.init if init is None else init
        eff = eff or default_init or init_mod.Uniform()
        if not _shape_known(self.shape):
            if not self.allow_deferred_init:
                raise MXNetError(f"cannot initialize {self.name}: shape "
                                 f"{self.shape} unknown and deferred init "
                                 f"not allowed")
            self._deferred_init = (eff, dev, generator)
            return
        self._finish_init(eff, dev, generator)

    def _finish_init(self, initializer, device, generator):
        initializer = init_mod.create(initializer)
        value = initializer.init_array(self.name, self.shape, self.dtype,
                                       generator)
        self._set(value.to(device))
        self._deferred_init = None

    def _finish_deferred_init(self, inferred_shape=None):
        if inferred_shape is not None:
            self.shape = inferred_shape
        if self._deferred_init is None:
            raise DeferredInitializationError(
                f"parameter {self.name} was not initialized — call "
                f"net.initialize() first")
        self._finish_init(*self._deferred_init)

    def _set(self, value: torch.Tensor):
        self._data = torch.nn.Parameter(
            value.detach().clone(), requires_grad=self.grad_req != "null")
        self._init_grad()

    def _init_grad(self):
        """Make the value an autograd variable of the NDArray path with a
        zero gradient buffer (``grad_req`` null: neither)."""
        from ..ndarray.ndarray import NDArray
        self._nd = NDArray._wrap(self._data)
        if self.grad_req == "null":
            self._grad = None
            return
        self._grad = NDArray._wrap(torch.zeros_like(self._data.detach()))
        ag.mark_variables([self._nd], [self._grad], self.grad_req)

    # -- access ------------------------------------------------------------
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"parameter {self.name} deferred (shape {self.shape}): run "
                f"a forward pass first")
        raise MXNetError(f"parameter {self.name} has not been "
                         f"initialized; call net.initialize()")

    def data(self) -> torch.Tensor:
        if self._override is not None:
            return self._override
        self._check_initialized()
        return self._data

    def _data_nd(self):
        """The value as an NDArray (the autograd variable), over the
        tensor :meth:`data` returns."""
        self._check_initialized()
        return self._nd

    def list_data(self):
        return [self.data()]

    def grad(self):
        """The gradient buffer, an NDArray ``backward`` writes."""
        self._check_initialized()
        if self._grad is None:
            raise MXNetError(f"cannot get gradient for parameter "
                             f"{self.name}: grad_req is 'null'")
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient buffer to zeros (a new tensor, as the
        reference rebinds its buffer)."""
        if self._grad is not None:
            self._grad._data = torch.zeros_like(self._grad._data)

    def set_data(self, data):
        """Replace the value: the shape must agree with the declared one
        (unknown dims are filled in); the value is cast to the
        parameter's type and, when already initialized, copied in place
        on the parameter's device."""
        data = torch.as_tensor(data)
        self.shape = tuple(data.shape)
        if self._data is None:
            self._set(data.to(self.dtype))
            self._deferred_init = None
            return
        if tuple(data.shape) != tuple(self._data.shape):
            raise MXNetError(f"set_data: shape {tuple(data.shape)} != "
                             f"{tuple(self._data.shape)} of {self.name}")
        with torch.no_grad():
            self._data.copy_(data.to(self._data.device, self._data.dtype))

    def cast(self, dtype):
        """Change the parameter's type; an initialized value is replaced by
        a cast copy (a new tensor: a trainer's graphs captured on the old
        one are dropped at its next call), which becomes the variable,
        with a gradient buffer of the new type."""
        self.dtype = torch_dtype(dtype)
        if self._data is not None:
            self._set(self._data.detach().to(self.dtype))


class ParameterDict(OrderedDict):
    """Hierarchical name → Parameter, in registration order."""

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)
