"""Gluon Parameter (counterpart of ``mxnet_tpu/gluon/parameter.py``).

A ``Parameter`` describes one weight of a Block — shape (possibly with
unknown dims, filled in by the first forward: deferred init), type,
initializer, ``grad_req`` and lr/wd multipliers — and holds its value as
a ``torch.nn.Parameter`` once initialized.  As in the reference,
``data()``, ``list_data()`` and ``grad()`` are NDArrays and ``set_data``
takes one; ``_tensor()`` is the tensor itself, which the layers and the
trainers read (a captured step holds its address, so ``set_data`` copies
into it in place).

For the eager Gluon loop (``autograd.record()``, ``backward``,
``gluon.Trainer``) an initialized parameter with ``grad_req`` ``write``
or ``add`` is also an autograd variable of the NDArray path
(``autograd.mark_variables``): ``_data_nd()`` is an NDArray over the
same tensor, and ``grad()`` its gradient buffer, an NDArray that
``backward`` overwrites (``write``) or adds to (``add``).  ``cast`` and
``set_data`` keep the variable and its buffer in step with the value.
The captured trainer (``SPMDTrainer``) takes its gradients from
``torch.autograd`` itself and never reads the buffer.

``grad_stype="row_sparse"`` makes the buffer a ``RowSparseNDArray``
(``nn.Embedding(sparse_grad=True)`` sets it), which ``backward`` fills
with the batch's rows.  ``stype="row_sparse"`` guards the access
pattern of a table kept in a store: ``data()`` raises and
``row_sparse_data(row_ids)`` returns the rows asked for, pulled from
the kvstore of a trainer with a distributed store
(``Trainer._row_sparse_pull``), else read from the local value.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as onp
import torch

from .. import autograd as ag
from .. import initializer as init_mod
from ..base import MXNetError
from ..context import Context, resolve_device

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
                 differentiable=True, stype="default",
                 grad_stype="default", aux_state: bool = False):
        if grad_req not in _GRAD_REQS:
            raise MXNetError(f"grad_req must be one of {_GRAD_REQS}, got "
                             f"{grad_req!r}")
        if stype not in ("default", "row_sparse", "csr"):
            raise MXNetError(f"invalid parameter stype {stype!r}")
        if grad_stype not in ("default", "row_sparse", "csr"):
            raise MXNetError(f"invalid parameter grad_stype {grad_stype!r}")
        if not differentiable:
            grad_req = "null"
        self._stype = stype
        self._grad_stype = grad_stype
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
        # a stand-in tensor that _tensor() returns while set (the trainer's
        # low-precision copy inside a step)
        self._override: Optional[torch.Tensor] = None
        # the mesh PartitionSpec (``shard``), and whether a meshed
        # SPMDTrainer holds the value as shards: None (it does not),
        # "stale" (the full tensor is out of date) or "gathered"
        self._sharding = None
        self._shard_state: Optional[str] = None

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
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, *, device=None, generator=None):
        """Draw the value now, or once the shape is known, on ``ctx`` (a
        ``Context`` or a list of one) or ``device``; without either, on
        the ``with mx.cpu():`` / ``with mx.gpu(n):`` scope's device, else
        on ``cuda``.  ``generator`` is the host ``torch.Generator``
        values are drawn from (``mx.random``'s host generator when left
        out)."""
        if self._data is not None and not force_reinit:
            return
        dev = init_device(ctx, device)
        if generator is None:
            generator = _host_generator()
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
        if self._grad_stype == "row_sparse":
            # filled by ops with a sparse backward: starts with no row
            from ..ndarray.sparse import RowSparseNDArray
            t = self._data.detach()
            self._grad = RowSparseNDArray(
                t.new_zeros((0,) + tuple(t.shape[1:])),
                torch.zeros((0,), dtype=torch.int32, device=t.device),
                tuple(t.shape))
        else:
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

    def _tensor(self) -> torch.Tensor:
        """The value as the tensor the layers read: the
        ``torch.nn.Parameter`` (or, inside a trainer's step, its
        compute-dtype stand-in)."""
        if self._override is not None:
            return self._override
        self._check_initialized()
        if self._shard_state == "stale":
            self._refuse_stale()
        return self._data

    def data(self, ctx=None):
        """The value as an NDArray over :meth:`_tensor` (the autograd
        variable).  A parameter lives on one device, so ``ctx`` selects
        nothing, as in the reference.  A ``row_sparse`` parameter raises:
        read it through :meth:`row_sparse_data`."""
        if self._stype == "row_sparse":
            self._check_initialized()
            raise MXNetError(
                f"cannot return a copy of parameter '{self.name}' via "
                "data() because its storage type is 'row_sparse'; use "
                "row_sparse_data(row_id) instead")
        if self._override is not None:
            from ..ndarray.ndarray import NDArray
            return NDArray._wrap(self._override)
        return self._data_nd()

    def _data_nd(self):
        """The value as an NDArray (the autograd variable) over the
        parameter's tensor."""
        self._check_initialized()
        if self._shard_state == "stale":
            self._refuse_stale()
        return self._nd

    def _refuse_stale(self):
        raise MXNetError(
            f"parameter {self.name} is sharded over the mesh by an "
            f"SPMDTrainer and its full value is stale: call "
            f"trainer.gather_params() (collective: every rank) first")

    def var(self):
        """This parameter as a symbol variable of its name
        (``mx.sym.var(name)``)."""
        from ..symbol import var
        return var(self.name)

    def shard(self, partition_spec):
        """Annotate the parameter with a mesh ``PartitionSpec``
        (``mxnet_tpu_torch.parallel.PartitionSpec``), which a meshed
        ``SPMDTrainer`` reads: each rank then holds its shard of the
        value.  Returns the parameter."""
        self._sharding = partition_spec
        return self

    def list_data(self):
        return [self.data()]

    def row_sparse_data(self, row_id):
        """The rows ``row_id`` of a ``row_sparse`` parameter, as a
        ``RowSparseNDArray`` (duplicates dropped, sorted).  With a
        trainer whose kvstore is distributed, only those rows are pulled
        from the store (which holds the weights) and written into the
        local value; otherwise they are read from the local value."""
        from ..ndarray.sparse import RowSparseNDArray
        if self._stype != "row_sparse":
            raise MXNetError(
                f"cannot return parameter '{self.name}' via "
                f"row_sparse_data() because its storage type is "
                f"'{self._stype}'; use data() instead")
        self._check_initialized()
        rid = row_id.asnumpy() if hasattr(row_id, "asnumpy") else row_id
        rows = onp.unique(onp.asarray(rid, onp.int64).reshape(-1))
        n = self._data.shape[0]
        if len(rows) and (rows[0] < 0 or rows[-1] >= n):
            raise MXNetError(
                f"row_sparse_data: row ids out of range for parameter "
                f"'{self.name}' with {n} rows")
        tr = self._trainer
        if tr is not None:
            # the trainer's configuration, not its store: before the
            # first step the store is not made yet, and the local value
            # would be stale rows
            kvconf = tr._kvstore_params.get("kvstore")
            want_dist = tr._distributed or \
                (isinstance(kvconf, str) and kvconf.startswith("dist")) \
                or "dist" in getattr(kvconf, "type", "")
            if want_dist:
                return tr._row_sparse_pull(self, rows)
        idx = torch.as_tensor(rows, device=self._data.device)
        return RowSparseNDArray(self._data.detach().index_select(0, idx),
                                idx, tuple(self._data.shape))

    def list_row_sparse_data(self, row_id):
        return [self.row_sparse_data(row_id)]

    def _reduce(self):
        """The whole value whatever the stype (what saving reads)."""
        self._check_initialized()
        return self._nd

    def list_ctx(self):
        """The contexts holding the value: the one device's."""
        self._check_initialized()
        return [Context.of(self._data.device)]

    def grad(self, ctx=None):
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
        reference rebinds its buffer); a row-sparse buffer keeps no
        row."""
        from ..ndarray.sparse import RowSparseNDArray
        if isinstance(self._grad, RowSparseNDArray):
            self._grad.data = self._grad.data[:0]
            self._grad.indices = self._grad.indices[:0]
        elif self._grad is not None:
            self._grad._data = torch.zeros_like(self._grad._data)

    def set_data(self, data):
        """Replace the value with ``data`` (an NDArray, tensor or numpy
        array): the shape must agree with the declared one (unknown dims
        are filled in); the value is cast to the parameter's type and,
        when already initialized, copied in place (``copy_``) into the
        parameter's tensor on its device, so that what holds its address
        (a captured step) reads the new value."""
        from ..ndarray.ndarray import NDArray
        if isinstance(data, NDArray):
            data = data._data
        data = torch.as_tensor(data).detach()
        self.shape = tuple(data.shape)
        if self._data is None:
            self._set(data.to(self.dtype))
            self._deferred_init = None
            return
        if tuple(data.shape) != tuple(self._data.shape):
            raise MXNetError(f"set_data: shape {tuple(data.shape)} != "
                             f"{tuple(self._data.shape)} of {self.name}")
        if self._shard_state is not None:
            raise MXNetError(
                f"set_data: parameter {self.name} is held as shards by a "
                f"meshed SPMDTrainer: load its full value with "
                f"trainer.set_full_value(param, value) (or "
                f"convert.load_collected_params(..., trainer=))")
        with torch.no_grad():
            self._data.copy_(data.to(self._data.device, self._data.dtype))

    def reset_ctx(self, ctx):
        """Move the value to ``ctx`` (a ``Context`` or a list of one): a
        new tensor there, with a zero gradient buffer (a trainer's graphs
        captured on the old one are dropped at its next call)."""
        if self._data is not None:
            dev = init_device(ctx, None)
            if dev != self._data.device:
                self._set(self._data.detach().to(dev))

    def cast(self, dtype):
        """Change the parameter's type; an initialized value is replaced by
        a cast copy (a new tensor: a trainer's graphs captured on the old
        one are dropped at its next call), which becomes the variable,
        with a gradient buffer of the new type."""
        self.dtype = torch_dtype(dtype)
        if self._data is not None:
            self._set(self._data.detach().to(self.dtype))


def init_device(ctx=None, device=None) -> torch.device:
    """The device a parameter is made on: ``device`` (the port's keyword),
    else ``ctx`` (a ``Context``, a list of one, or a device name), else
    the innermost ``with ctx:`` scope's, else ``cuda`` (which raises
    without a visible card)."""
    from ..context import _stack
    if device is None:
        device = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
    if device is None and _stack():
        device = _stack()[-1]
    return resolve_device(device)


def _host_generator():
    """``mx.random``'s host generator, which initializers draw from."""
    from ..ops import random as _rng
    return _rng.generator("cpu")


class ParameterDict(OrderedDict):
    """Hierarchical name → Parameter, in registration order."""

    def initialize(self, init=None, ctx=None, force_reinit=False, *,
                   device=None, generator=None, **kwargs):
        """Initialize every parameter with ``init`` (over each one's own
        initializer, as the reference does), drawn from one
        ``generator`` (default ``mx.random``'s host generator) in
        order."""
        if generator is None:
            generator = _host_generator()
        for p in self.values():
            p.initialize(init=init, ctx=ctx, force_reinit=force_reinit,
                         device=device, generator=generator)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Every parameter through ``nd.save``, named without
        ``strip_prefix``."""
        from ..ndarray import save as nd_save
        nd_save(filename, {
            (k[len(strip_prefix):] if k.startswith(strip_prefix) else k):
                p._reduce() for k, p in self.items()})

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Load what :meth:`save` wrote, each value copied in place into
        the parameter named ``restore_prefix + name``."""
        from .block import _load_named
        loaded = _load_named(filename, self, ctx)
        for name, p in self.items():
            key = restore_prefix + name
            if key in loaded:
                p.set_data(loaded[key])
            elif not allow_missing:
                raise MXNetError(f"parameter {key} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - {restore_prefix + n for n in self}
            if extra:
                raise MXNetError(f"extra parameters in {filename}: {extra}")
