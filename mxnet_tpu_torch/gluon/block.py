"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A ``Block`` is a ``torch.nn.Module``: child Blocks assigned as
attributes register as its submodules, and ``Parameter`` attributes
register in the Block's own ordered table, so ``collect_params()``
returns the reference's hierarchical names
(``blocks.0.attn.qkv.weight``).  ``named_parameters()`` (and so
``parameters()``) yields the initialized tensors under those names.
``HybridBlock.hybridize`` makes a block's forward outside ``record()``
replay one captured executable (a CUDA graph on a card) for each call
signature, as the reference's ``CachedOp`` does.

A Block takes tensors or NDArrays.  Called with NDArrays (the eager
Gluon loop: ``with autograd.record(): loss = loss_fn(net(x), y)``), it
unwraps them, runs the forward with PyTorch's gradient recording on
exactly when ``autograd.is_recording()``, and wraps the tensors it
returns (in nested tuples and lists too) back into NDArrays, so that
``loss.backward()`` reaches the parameters' gradient buffers.  Called
with tensors, it is a plain ``torch.nn.Module`` call.

For the whole-step capture (``imperative/cached_step.py``) the
outermost ``HybridBlock`` called with arrays is one record, which the
capture defers when a captured step matches: a HybridBlock's forward
has no control flow of its own, the contract the reference's cached op
rests on too.  A plain Block's forward is never one record: it runs at
every step, and each Block it calls with tensors is called as if given
NDArrays (a record of its own, or a hybridized block's graph), so that
a branch it takes on Python state shows as a divergence from the tape.

A forward that runs inside a function of the trainer's (one a CUDA graph
holds) may not write a parameter: BatchNorm's running statistics go to
the trace context's aux channel instead (:class:`_TraceContext`, read by
:func:`current_trace`), and the trainer writes them back once a step.
"""
from __future__ import annotations

import re
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional

import torch

from .. import autograd as ag
from .. import initializer as init_mod
from .. import telemetry, tracing
from ..base import MXNetError
from ..imperative import cached_step as _cs
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
    if isinstance(v, torch.Tensor) or type(v) is _cs._DeferredData:
        return NDArray._wrap(v)
    if isinstance(v, (tuple, list)):
        return type(v)(_wrap(x) for x in v)
    return v


def _is_array(v) -> bool:
    from ..ndarray.ndarray import NDArray
    return isinstance(v, (NDArray, torch.Tensor)) or \
        type(v) is _cs._DeferredData


def _tensor_of(v):
    """The tensor (or placeholder) of an array argument."""
    from ..ndarray.ndarray import NDArray
    return v._data if isinstance(v, NDArray) else v


def _split_args(args, kwargs):
    """(the call's arrays: NDArrays, tensors and placeholders, in order;
    the tree that :func:`_join_args` rebuilds the call from).  Arrays are
    inputs, staged at every call; the tree's other values are keyed
    exactly (``imperative.cached_step._tree_key``)."""
    return _cs._flatten((tuple(args), tuple(sorted(kwargs.items()))),
                        _is_array)


def _join_args(tree, values):
    args, kwargs = _cs._unflatten(tree, values)
    return args, dict(kwargs)


# forward hooks attached anywhere (``has_hooks`` walks a tree only then)
_HOOKS = [0]


class _HookHandle:
    """What ``register_forward_hook`` returns: ``detach()`` removes the
    hook."""

    def __init__(self, hooks, hook):
        self._hooks, self._hook = hooks, hook

    def detach(self):
        if self._hook in self._hooks:
            self._hooks.remove(self._hook)
            _HOOKS[0] -= 1


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
        _HOOKS[0] += 1
        return _HookHandle(self._gluon_pre_hooks, hook)

    def register_forward_hook(self, hook):
        """``hook(block, args, out)`` after each forward; returns a handle
        whose ``detach()`` removes it."""
        self._gluon_hooks.append(hook)
        _HOOKS[0] += 1
        return _HookHandle(self._gluon_hooks, hook)

    def has_hooks(self) -> bool:
        """True when a block of the tree carries a forward (pre-)hook
        (``mxnet_tpu/gluon/block.py:243-255``): the captured paths, which
        would hide real activations from it, decline then."""
        if not _HOOKS[0]:
            return False
        seen = set()
        stack = [self]
        while stack:
            b = stack.pop()
            if id(b) in seen:
                continue
            seen.add(id(b))
            if b._gluon_hooks or b._gluon_pre_hooks:
                return True
            stack.extend(b._children.values())
        return False

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
        """Hybridize every ``HybridBlock`` of the tree (a plain Block's
        own forward stays eager)."""
        for child in self._children.values():
            child.hybridize(active, **kwargs)

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
        ``backward`` exactly when ``autograd.is_recording()``.  A Block
        called with tensors inside a plain Block's forward called with
        NDArrays is called as if given NDArrays."""
        if self._gluon_pre_hooks or self._gluon_hooks:
            # hooks see real activations: a step with hooks attached can
            # neither be captured nor stay deferred
            _cs.notify_hooks()
        for hook in self._gluon_pre_hooks:
            hook(self, _wrap(args))
        if _has_nd(args) or _has_nd(kwargs.values()):
            out = self._call_nd(args, kwargs)
        elif _cs.in_plain_forward():
            out = _unwrap(self._call_nd(
                _wrap(args), {k: _wrap(v) for k, v in kwargs.items()}))
        else:
            out = super().__call__(*args, **kwargs)
        for hook in self._gluon_hooks:
            hook(self, _wrap(args), _wrap(out))
        return out

    def _call_nd(self, args, kwargs):
        """A plain Block's call with NDArrays: its forward on their
        tensors, each Block it calls a call of its own (a record of the
        whole-step capture, a hybridized block's graph), so that its own
        Python runs at every step (``cached_step.plain_forward``)."""
        with _cs.plain_forward(), \
                torch.set_grad_enabled(ag.is_recording()):
            out = super().__call__(*_unwrap(args),
                                   **{k: _unwrap(v)
                                      for k, v in kwargs.items()})
        return _wrap(out)

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
    """A Block whose forward can be captured (``mxnet_tpu/gluon/block.py:
    367-548``, the reference's ``CachedOp``).  After ``hybridize()``, a
    call with NDArrays outside ``autograd.record()`` replays one captured
    :class:`~mxnet_tpu_torch.executable.Executable` of the forward for
    each signature (training flag, the arrays' shapes, dtypes and
    devices, the other arguments' values): a CUDA graph on a
    card, over static inputs the call's arrays are copied into, with the
    outputs copied out.  A new signature is captured at its first call,
    within the ``MXNET_JIT_MAX_SIGS`` budget shared with the cached step
    (``ops.registry.SigBudget``); past it, new signatures run eagerly.
    Auxiliary-state writes (BatchNorm's running statistics in training
    mode) go through the forward's trace context and are applied after
    each call.  The first call finishes deferred initialisation eagerly.

    Inside ``record()`` the block runs eagerly, as one record, which the
    whole-step capture takes into the step's graph.  A block with forward
    hooks attached also runs eagerly (a graph would hide its activations
    from them).  A parameter replaced since a capture (``cast``,
    ``reset_ctx``) drops that signature's graph."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._active = False
        self._cached_graphs: Dict[Any, "_CachedForward"] = {}
        self._sig_budget = None
        self._owner = None       # the graphs' pool and stream, deferred ids

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  **kwargs):
        """Capture the forward from the next call on (``active``), or stop;
        drops every captured signature.  ``static_alloc`` and
        ``static_shape`` are the reference's; a CUDA graph is both."""
        self._active = bool(active)
        self._cached_graphs.clear()
        self._sig_budget = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def _call_nd(self, args, kwargs):
        if self._active and not ag.is_recording() and not self.has_hooks():
            return self._call_cached(args, kwargs)
        return self._call_record(args, kwargs)

    def _call_record(self, args, kwargs):
        """The torch forward on the arrays' tensors, as one record of the
        whole-step capture, keyed by the block and its other arguments."""
        from ..ndarray.ndarray import NDArray
        arrays, tree = _split_args(args, kwargs)
        nds = [a if isinstance(a, NDArray) else NDArray._wrap(a)
               for a in arrays]
        call = torch.nn.Module.__call__

        def fn(*tensors):
            a, kw = _join_args(tree, tensors)
            return call(self, *a, **kw)
        return _cs.call_block(self, fn, ("block", id(self),
                                         _cs._tree_key(tree)), nds)

    def _call_cached(self, args, kwargs):
        from ..ndarray.ndarray import NDArray
        arrays, tree = _split_args(args, kwargs)
        tensors = [_tensor_of(a) for a in arrays]
        _cs.check_inputs(tensors)
        tensors = [_cs.resolve(t) for t in tensors]
        # the signature: the flags, the arrays' specs, the other values
        sig = (ag.is_training(), ag.is_recording(), _cs._tree_key(tree),
               tuple(_cs._spec(t) for t in tensors))
        entry = self._cached_graphs.get(sig)
        if entry is not None and entry.ptrs != entry.current_ptrs():
            del self._cached_graphs[sig]       # a parameter was replaced
            entry = None
        fresh = entry is None
        if fresh:
            params = list(self.collect_params().values())
            if any(p._deferred_init is not None for p in params):
                # the first call finishes deferred initialisation eagerly
                return self._call_record(args, kwargs)
            if self._sig_budget is None:
                from ..ops.registry import SigBudget
                self._sig_budget = SigBudget()
            if not self._sig_budget.admit(len(self._cached_graphs)):
                return self._call_record(args, kwargs)
        if self._owner is None:
            from ..executable import CaptureOwner
            self._owner = CaptureOwner()
        self._owner.check_ids()
        from ..optimizer.optimizer import _note_dispatch
        if fresh:
            t0 = time.perf_counter()
            with tracing.span("compile.cached_op",
                              block=type(self).__name__):
                entry = _CachedForward(self, tree, params, tensors)
                out = entry.exe(*tensors)
            self._cached_graphs[sig] = entry
            telemetry.record_compile(time.perf_counter() - t0, "cached_op")
        else:
            out = entry.exe(*tensors)
        _note_dispatch()
        leaves, aux, bounds = out
        if entry.device.type == "cuda":
            leaves = [t.clone() for t in leaves]
        if aux:
            with torch.no_grad():
                torch._foreach_copy_([p._tensor() for p in entry.aux_params],
                                     list(aux))
        self._owner.defer_ids(bounds, entry.ids.vocabs, entry.device)
        return _cs._unflatten(entry.tree, [NDArray._wrap(t) for t in leaves])


class _CachedForward:
    """One signature of a hybridized block: its captured forward, the
    output tree and the auxiliary states it writes."""

    def __init__(self, block, tree, params, tensors):
        from ..executable import Executable
        from ..ops.tensor import IdCheck
        self.params = params
        self.ptrs = self.current_ptrs()
        self.device = tensors[0].device if tensors else \
            params[0]._data.device
        self.ids = IdCheck()
        self.tree = None
        self.aux_params = []
        training = ag.is_training()
        call = torch.nn.Module.__call__

        def fn(*inputs):
            a, kw = _join_args(tree, inputs)
            tc = _TraceContext()
            self.ids.reset()
            with ag.pause(train_mode=training), tc, self.ids, \
                    _cs.inside_record():
                out = call(block, *a, **kw)
            tc.close()
            leaves, self.tree = _cs._flatten(out)
            self.aux_params = list(tc.aux)
            return leaves, list(tc.aux.values()), self.ids.bounds()

        self.exe = Executable(fn, tensors, self.device,
                              *block._owner.capture_with(self.device),
                              warm="zeros")

    def current_ptrs(self):
        return tuple(p._data.data_ptr() if p._data is not None else 0
                     for p in self.params)
