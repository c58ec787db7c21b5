"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A ``Block`` is a ``torch.nn.Module``: child Blocks assigned as
attributes register as its submodules, and ``Parameter`` attributes
register in the Block's own ordered table, so ``collect_params()``
returns the reference's hierarchical names
(``blocks.0.attn.qkv.weight``).  ``named_parameters()`` (and so
``parameters()``) yields the initialized tensors under those names.
``hybridize`` keeps the block eager: graph capture (CUDA graphs) is
later work.

A Block takes tensors or NDArrays.  Called with NDArrays (the eager
Gluon loop: ``with autograd.record(): loss = loss_fn(net(x), y)``), it
unwraps them, runs the forward with PyTorch's gradient recording on
exactly when ``autograd.is_recording()``, and wraps the tensors it
returns (in nested tuples and lists too) back into NDArrays, so that
``loss.backward()`` reaches the parameters' gradient buffers.  Called
with tensors, it is a plain ``torch.nn.Module`` call.

A forward that runs inside a function of the trainer's (one a CUDA graph
holds) may not write a parameter: BatchNorm's running statistics go to
the trace context's aux channel instead (:class:`_TraceContext`, read by
:func:`current_trace`), and the trainer writes them back once a step.
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Optional

import torch

from .. import autograd as ag
from .. import initializer as init_mod
from ..base import MXNetError
from .parameter import Parameter, ParameterDict, init_device

__all__ = ["Block", "HybridBlock", "current_trace"]


class _TraceContext:
    """The aux channel of one forward (counterpart of the reference's
    ``_TraceContext.aux_update``, ``mxnet_tpu/gluon/block.py:40-60``): a
    layer that would update an auxiliary state (BatchNorm's running
    statistics) hands ``param <- value`` here instead, and the owner of
    the forward applies the values after it.

    Inside ``with ctx:`` on this thread, :func:`current_trace` returns
    it.  The owner enters it inside the function that calls the model
    (as ``ops.tensor.IdCheck``), so that a recomputation on autograd's
    thread (remat) finds it too, and closes it once the forward has
    returned: what a recomputation hands in then is dropped,
    and the values stay those the forward recorded.  The values are
    detached: they carry no gradient."""

    def __init__(self):
        self.aux: "OrderedDict[Parameter, torch.Tensor]" = OrderedDict()
        self.closed = False

    def aux_update(self, param: Parameter, new_value: torch.Tensor):
        """Register ``param <- new_value`` (the last value for a
        parameter wins)."""
        if not self.closed:
            self.aux[param] = new_value.detach()

    def close(self):
        self.closed = True

    def __enter__(self):
        _TRACE.__dict__.setdefault("stack", []).append(self)
        return self

    def __exit__(self, *exc):
        _TRACE.stack.pop()
        return False


_TRACE = threading.local()


def current_trace() -> Optional[_TraceContext]:
    """The innermost trace context entered on this thread, or None."""
    stack = getattr(_TRACE, "stack", None)
    return stack[-1] if stack else None


def _has_nd(values) -> bool:
    from ..ndarray.ndarray import NDArray
    for v in values:
        if isinstance(v, NDArray) or (isinstance(v, (tuple, list))
                                      and _has_nd(v)):
            return True
    return False


def _unwrap(v):
    from ..ndarray.ndarray import NDArray
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, (tuple, list)):
        return type(v)(_unwrap(x) for x in v)
    return v


def _wrap(v):
    from ..ndarray.ndarray import NDArray
    if isinstance(v, torch.Tensor):
        return NDArray._wrap(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_wrap(x) for x in v)
    return v


class _HookHandle:
    """What ``register_forward_hook`` returns: ``detach()`` removes the
    hook."""

    def __init__(self, hooks, hook):
        self._hooks, self._hook = hooks, hook

    def detach(self):
        if self._hook in self._hooks:
            self._hooks.remove(self._hook)


class Block(torch.nn.Module):
    """Base class for layers and models.  The Gluon methods that share a
    name with ``torch.nn.Module``'s (``zero_grad``, ``apply``,
    ``register_forward_hook``, ``register_forward_pre_hook``) are the
    reference's (``mxnet_tpu/gluon/block.py:182-256``)."""

    def __init__(self):
        super().__init__()
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()
        # Gluon forward hooks: pre-hooks get (block, args), hooks
        # (block, args, out), as NDArrays (a child called with tensors
        # inside its parent's forward too, as in the reference)
        self._gluon_pre_hooks = []
        self._gluon_hooks = []

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            if value._name in ("weight", "bias", "param", "const"):
                value._name = name
        super().__setattr__(name, value)

    @property
    def _children(self):
        return OrderedDict((k, m) for k, m in self._modules.items()
                           if isinstance(m, Block))

    def register_child(self, block: "Block", name: Optional[str] = None):
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """Hierarchical name → Parameter: the Block's own parameters, then
        each child's under ``<child name>.``; with ``select``, only the
        names the regular expression matches (``re.search``)."""
        out = ParameterDict()
        self._collect_params_into(out, "")
        if select is not None:
            pat = re.compile(select)
            out = ParameterDict((k, v) for k, v in out.items()
                                if pat.search(k))
        return out

    def _collect_params_into(self, out: ParameterDict, prefix: str):
        for name, p in self._reg_params.items():
            out[prefix + name] = p
        for cname, child in self._children.items():
            child._collect_params_into(out, f"{prefix}{cname}.")

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        seen = set()
        for name, p in self.collect_params().items():
            t = p._data
            if t is None or (remove_duplicate and id(t) in seen):
                continue
            seen.add(id(t))
            yield (f"{prefix}.{name}" if prefix else name), t

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, *, device=None, generator=None):
        """Initialize every parameter: each one's own initializer, else
        ``init`` (default ``Uniform()``).  The device is ``ctx`` (a
        ``Context`` or a list of one) or the port's ``device=``; without
        either, the ``with mx.cpu():`` / ``with mx.gpu(n):`` scope's, else
        ``cuda`` (which raises without a card: the CPU is used only when
        asked for).  Values are drawn from ``generator`` (default: a host
        generator seeded with 0) in ``collect_params()`` order, deferred
        ones at their first forward."""
        dev = init_device(ctx, device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        default = init_mod.create(init)
        for p in self.collect_params().values():
            p.initialize(init=None, device=dev, default_init=default,
                         force_reinit=force_reinit, generator=generator)

    def zero_grad(self):
        """Zero every Gluon gradient buffer of the block and its
        children (``grad_req="add"`` included)."""
        self.collect_params().zero_grad()

    def reset_ctx(self, ctx):
        """Move every parameter to ``ctx``."""
        self.collect_params().reset_ctx(ctx)

    def apply(self, fn):
        """``fn`` on every child Block (recursively), then on this one;
        returns ``self``."""
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def register_forward_pre_hook(self, hook):
        """``hook(block, args)`` before each forward; returns a handle
        whose ``detach()`` removes it."""
        self._gluon_pre_hooks.append(hook)
        return _HookHandle(self._gluon_pre_hooks, hook)

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each forward; returns a handle
        whose ``detach()`` removes it."""
        self._gluon_hooks.append(hook)
        return _HookHandle(self._gluon_hooks, hook)

    # -- persistence (``mxnet_tpu/gluon/block.py:195-233``) -----------------
    def save_parameters(self, filename: str, deduplicate: bool = False):
        """Every parameter under its ``collect_params()`` name, through
        ``nd.save`` (its codec: ``MXNET_NDARRAY_SAVE_FORMAT``)."""
        from ..ndarray import save as nd_save
        nd_save(filename, {k: p.data()
                           for k, p in self.collect_params().items()})

    def load_parameters(self, filename: str, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load what ``save_parameters`` (of either package) or the
        reference's ``mx.model`` / ``export`` wrote (``arg:`` / ``aux:``
        prefixes are dropped).  Each value is cast to its parameter's
        type and copied in place into it (``Parameter.set_data``); a
        missing name raises unless ``allow_missing``, an extra one unless
        ``ignore_extra``."""
        params = self.collect_params()
        loaded = _load_named(filename, params, ctx)
        if any(k.startswith(("arg:", "aux:")) for k in loaded):
            loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                      else k: v for k, v in loaded.items()}
        for name, p in params.items():
            if name in loaded:
                p.set_data(loaded[name])
            elif not allow_missing:
                raise MXNetError(f"parameter {name} missing in {filename}")
        if not ignore_extra:
            extra = set(loaded) - set(params)
            if extra:
                raise MXNetError(f"file {filename} contains extra "
                                 f"parameters: {extra}")

    def save(self, prefix):
        self.save_parameters(prefix + ".params")

    def load(self, prefix):
        self.load_parameters(prefix + ".params")

    def hybridize(self, active=True, **kwargs):
        """Accepted for the reference's API; the block stays eager."""

    def cast(self, dtype):
        """Cast every parameter of the block and its children to ``dtype``
        (``mxnet_tpu/gluon/block.py:176``), auxiliary states included:
        ``net.cast("bfloat16")`` makes a bf16 net for inference."""
        for p in self._reg_params.values():
            p.cast(dtype)
        for child in self._children.values():
            child.cast(dtype)

    def __call__(self, *args, **kwargs):
        """Tensors in, tensors out; NDArrays in (``mxnet_tpu/gluon/
        block.py:258-269``), NDArrays out, the forward recorded for
        ``backward`` exactly when ``autograd.is_recording()``."""
        for hook in self._gluon_pre_hooks:
            hook(self, _wrap(args))
        if not (_has_nd(args) or _has_nd(kwargs.values())):
            out = super().__call__(*args, **kwargs)
        else:
            with torch.set_grad_enabled(ag.is_recording()):
                out = _wrap(super().__call__(
                    *_unwrap(args),
                    **{k: _unwrap(v) for k, v in kwargs.items()}))
        for hook in self._gluon_hooks:
            hook(self, _wrap(args), _wrap(out))
        return out

    def forward(self, *args, **kwargs):
        raise NotImplementedError


def _load_named(filename, params, ctx=None) -> dict:
    """``nd.load(filename)`` as a name → NDArray dict, placed on ``ctx``,
    else on the device of the parameters' values (else the current
    context)."""
    from ..context import Context, current_context
    from ..ndarray import load as nd_load
    if ctx is None:
        devs = [p._data.device for p in params.values()
                if p._data is not None]
        ctx = Context.of(devs[0]) if devs else current_context()
    with (ctx[0] if isinstance(ctx, (list, tuple)) else ctx):
        loaded = nd_load(filename)
    if not isinstance(loaded, dict):
        raise MXNetError(f"{filename} holds an unnamed array list, not a "
                         f"name->param dict; parameters need named "
                         f"entries")
    return loaded


class HybridBlock(Block):
    """A Block the reference can trace into one executable; here it runs
    eagerly."""
