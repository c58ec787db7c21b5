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
from ..ops import random as _rng
from ..ops import registry as _reg
from .parameter import Parameter, ParameterDict, init_device

__all__ = ["Block", "HybridBlock", "SymbolBlock", "current_trace"]

# the format string of the port's exports (the reference's is
# "mxnet_tpu-stablehlo-v2": StableHLO, which torch cannot run)
EXPORT_FORMAT = "mxnet_tpu_torch-export-v1"
_REFERENCE_EXPORT_FORMAT = "mxnet_tpu-stablehlo-v2"


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
    detached: they carry no gradient.

    It is also the randomness of the forward (the reference's
    ``_TraceContext.next_key``, ``mxnet_tpu/gluon/block.py:46-48``):
    while it is entered it is ``mx.random``'s trace hook on this thread,
    so a Dropout inside draws through :meth:`draw`.  The forward's draws
    come from the device's generator, in order, and are kept; a
    recomputation after :meth:`close` (remat's, in the backward) is
    handed the same draws again, in the same order, so that it rebuilds
    the activations the forward made."""

    def __init__(self):
        self.aux: "OrderedDict[Parameter, torch.Tensor]" = OrderedDict()
        self.closed = False
        self._drawn = []
        self._replayed = 0

    def aux_update(self, param: Parameter, new_value: torch.Tensor):
        """Register ``param <- new_value`` (the last value for a
        parameter wins)."""
        if not self.closed:
            self.aux[param] = new_value.detach()

    def close(self):
        self.closed = True

    def draw(self, make, device):
        """``mx.random``'s draw inside the forward: a new one from the
        device's generator while open, the forward's own again, in turn,
        once closed."""
        if self.closed:
            if self._replayed >= len(self._drawn):
                raise MXNetError("a recomputed forward drew more random "
                                 "numbers than the forward did")
            out = self._drawn[self._replayed]
            self._replayed += 1
            return out
        out = make(_rng.generator(device))
        self._drawn.append(out)
        return out

    def __enter__(self):
        _TRACE.__dict__.setdefault("stack", []).append(self)
        self._replayed = 0
        self._old_hook = _rng.set_trace_hook(self.draw)
        return self

    def __exit__(self, *exc):
        _TRACE.stack.pop()
        _rng.set_trace_hook(self._old_hook)
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


def _has_np(values) -> bool:
    """Whether an argument is an ``mx.np.ndarray`` (the block's outputs
    then take that flavor, as an op's do)."""
    cls = _reg._NP_CLS[0]
    return cls is not None and any(
        type(v) is cls or (isinstance(v, (tuple, list)) and _has_np(v))
        for v in values)


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
        asked for).  Values are drawn from ``generator`` (default:
        ``mx.random``'s host generator, so ``mx.random.seed`` sets them
        and the same seed repeats them) in ``collect_params()`` order,
        deferred ones at their first forward.  ``init=Load(...)`` sets
        each parameter it holds by its hierarchical name (the others
        take its ``default_init``)."""
        dev = init_device(ctx, device)
        if generator is None:
            generator = _rng.generator("cpu")
        params = self.collect_params()
        if isinstance(init, init_mod.Load):
            # Load matches the hierarchical names, as the reference's
            # Block.initialize does (a short name like "weight" is
            # ambiguous across layers)
            for path, p in params.items():
                per = (init_mod._FixedArray(init.param[path])
                       if path in init.param else init.default_init)
                if per is None:
                    raise MXNetError(
                        f"Cannot initialize {path}: not found in loaded "
                        f"params and no default initializer provided")
                p.initialize(init=per, device=dev, default_init=per,
                             force_reinit=force_reinit, generator=generator)
            return
        default = init_mod.create(init)
        for p in params.values():
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
        nd_save(filename, {k: p._reduce()
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

    def summary(self, *inputs):
        """Print one forward's table of layers (``mxnet_tpu/gluon/block.py:
        274-343``): each block's path and type, its output's shape, its
        parameters (a parameter shared with an earlier block counted as
        shared), and the totals.  The forward runs eagerly in inference
        mode, hybridized blocks too, with forward hooks attached for it."""
        rows, handles, seen_params, visited = [], [], set(), set()

        def make_hook(blk, path):
            def hook(_blk, _in, out):
                first = out[0] if isinstance(out, (tuple, list)) else out
                shape = tuple(getattr(first, "shape", ()) or ())
                n_params = shared = 0
                for p in blk._reg_params.values():
                    n = int(p._data.numel()) if p._data is not None else 0
                    if id(p) in seen_params:
                        shared += n
                    else:
                        seen_params.add(id(p))
                        n_params += n
                rows.append((path or type(blk).__name__,
                             type(blk).__name__, shape, n_params, shared))
            return hook

        def attach(blk, path):
            if id(blk) not in visited:
                visited.add(id(blk))
                handles.append(blk.register_forward_hook(
                    make_hook(blk, path)))
            for name, child in blk._children.items():
                attach(child, f"{path}.{name}" if path else name)

        attach(self, "")
        try:
            with ag.pause(train_mode=False):
                self(*inputs)
        finally:
            for h in handles:
                h.detach()
        w = 34
        header = (f"{'Layer (type)':<{w}}{'Output Shape':<20}"
                  f"{'Param #':<10}{'Shared #':<10}")
        sep = "-" * len(header)
        lines = [sep, header, "=" * len(header)]
        total = tot_shared = 0
        for path, cls, shape, n, sh in rows:
            lines.append(f"{path + ' (' + cls + ')':<{w}}{str(shape):<20}"
                         f"{n:<10}{sh:<10}")
            total += n
            tot_shared += sh
        lines += ["=" * len(header), f"Total params: {total}",
                  f"Shared params: {tot_shared}", sep]
        print("\n".join(lines))

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
            if _has_np(args):
                out = _reg.np_flavor(out)
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
        ``static_shape`` are the reference's; a CUDA graph is both.  A
        block holding ``grad_stype='row_sparse'`` parameters refuses to
        hybridize (its sparse gradients need the eager backward): it
        raises here, at configuration time."""
        if active:
            sparse = [name for name, p in self.collect_params().items()
                      if getattr(p, "_grad_stype", "default")
                      == "row_sparse"]
            if sparse:
                raise MXNetError(
                    f"cannot hybridize a block holding "
                    f"grad_stype='row_sparse' parameters {sparse}: "
                    "sparse gradients need the eager (non-hybridized) "
                    "backward; keep the embedding un-hybridized or use "
                    "sparse_grad=False")
        self._active = bool(active)
        self._cached_graphs.clear()
        self._sig_budget = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, **kwargs)

    def export(self, path: str, epoch: int = 0, params_format: str = "npz"):
        """Write ``{path}-symbol.json`` and ``{path}-{epoch:04d}.params``,
        which :meth:`SymbolBlock.imports` loads and runs in a process that
        never saw this block's class (``mxnet_tpu/gluon/block.py:549-645``).

        The json is the reference's envelope (``format``, ``params``,
        ``nodes`` with ``inputs`` / ``n_out`` / ``aux`` / ``payload``),
        with one node per inference-mode signature the hybridized block
        has run: its ``payload`` is a ``torch.export`` program (base64 of
        the ``.pt2`` bytes) of the forward, which takes the parameters'
        values (in ``params`` order) and then the inputs.  The hand
        kernels stay in it as the port's custom ops
        (``mxnet_tpu_torch::flash_attention``,
        ``mxnet_tpu_torch::layer_norm_residual``); an embedding's ids are
        clamped in the program and their range is an extra output,
        checked after the call (``vocabs``).  The parameters are in the
        ``.params`` file, written by ``nd.save`` as npz or, with
        ``params_format="mxnet"``, in MXNet's binary format with ``arg:``
        / ``aux:`` prefixes."""
        if not self._cached_graphs:
            raise MXNetError(
                "Please first call block.hybridize() and then run forward "
                "at least once before calling export")
        import base64
        import io
        import json
        from ..ndarray import save as nd_save
        pfile = f"{path}-{epoch:04d}.params"
        params = self.collect_params()
        if params_format == "mxnet":
            nd_save(pfile, {("aux:" if p._is_aux else "arg:") + k:
                            p._reduce() for k, p in params.items()},
                    format="mxnet")
        else:
            self.save_parameters(pfile)
        pkeys = list(params.keys())
        pvals = [params[k] for k in pkeys]
        nodes = []
        for sig, entry in self._cached_graphs.items():
            if sig[0] or sig[1]:
                # a training-mode graph would bake in dropout masks and
                # batch statistics: only inference graphs are exported
                continue
            dev = pvals[0]._data.device if pvals else torch.device("cpu")
            inputs = [torch.zeros(shape, dtype=dt, device=dev)
                      for shape, dt in entry.in_specs]
            call = _ExportCall(self, pvals, entry.in_tree)
            args = tuple(p._data.detach() for p in pvals) + tuple(inputs)
            with torch.no_grad():
                prog = torch.export.export(call, args, strict=False)
            # the .pt2 would keep the example inputs, the weights among
            # them: they are in the .params file
            prog._example_inputs = None
            buf = io.BytesIO()
            torch.export.save(prog, buf)
            nodes.append({
                "inputs": [{"shape": list(shape),
                            "dtype": str(dt).replace("torch.", "")}
                           for shape, dt in entry.in_specs],
                "n_out": call.info["n_out"],
                "aux": [],
                "vocabs": _EXPORT_SEEN.pop(id(call))["vocabs"],
                "device": str(dev),
                "payload": base64.b64encode(buf.getvalue()).decode(),
            })
        if not nodes:
            raise MXNetError(
                "export found no inference-mode signature; run a forward "
                "outside autograd.record() and training mode first")
        manifest = {"format": EXPORT_FORMAT, "params": pkeys,
                    "nodes": nodes}
        with open(f"{path}-symbol.json", "w") as f:
            json.dump(manifest, f)
        return f"{path}-symbol.json", pfile

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
        self.in_tree = tree
        self.in_specs = [(tuple(t.shape), t.dtype) for t in tensors]
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


def _set_value(p: Parameter, t: torch.Tensor):
    """A loaded value for a new parameter, in the value's own type."""
    p.dtype = t.dtype
    p.set_data(t)


_EXPORT_SEEN: Dict[int, dict] = {}


class _ExportCall(torch.nn.Module):
    """The function an export traces: the parameters' values (handed to
    the layers through ``Parameter._override``), then the inputs, in
    inference mode; the outputs' tensors, then the ids' range when an
    embedding ran.  The block is held outside the module's attributes, so
    that its weights are inputs of the program, not part of it."""

    def __init__(self, block, params, tree):
        super().__init__()
        self.__dict__["_block"] = block
        self._params = list(params)
        self._tree = tree
        _EXPORT_SEEN[id(self)] = {"n_out": None, "vocabs": []}

    @property
    def info(self):
        """What the traced forward saw (kept outside the module, whose
        attributes the export restores after tracing)."""
        return _EXPORT_SEEN[id(self)]

    def forward(self, *flat):
        from ..ops.tensor import IdCheck
        n = len(self._params)
        for p, v in zip(self._params, flat[:n]):
            p._override = v
        ids = IdCheck()
        try:
            a, kw = _join_args(self._tree, flat[n:])
            # inference mode without touching torch's grad mode: the
            # export runs under no_grad, so the program holds no
            # set-grad region
            with ag.predict_mode(), _TraceContext(), ids:
                out = torch.nn.Module.__call__(self._block, *a, **kw)
        finally:
            for p in self._params:
                p._override = None
        leaves, _ = _cs._flatten(out)
        self.info["n_out"] = len(leaves)
        self.info["vocabs"] = list(ids.vocabs)
        bounds = ids.bounds()
        return tuple(leaves) + ((bounds,) if bounds is not None else ())


class SymbolBlock(HybridBlock):
    """A Symbol graph run as a Gluon block (``mxnet_tpu/gluon/block.py:
    649-720``): the symbol's arguments that are not inputs become
    Parameters (auxiliary states with ``grad_req="null"``), initialised
    from ``params`` when given.  Its forward runs the graph's ops, so it
    takes gradients and hybridizes as any block.  :meth:`imports` loads
    a symbol json (either package's, or MXNet 1.x's) with its ``.params``,
    or an export of :meth:`HybridBlock.export`."""

    def __init__(self, outputs, inputs, params: Optional[dict] = None):
        super().__init__()
        from ..ndarray.ndarray import NDArray
        from ..symbol import Group, Symbol
        if isinstance(outputs, (list, tuple)):
            outputs = Group(list(outputs))
        if not isinstance(outputs, Symbol):
            raise MXNetError("SymbolBlock expects a Symbol")
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self.__dict__["_symbol"] = outputs
        self._input_names = [i if isinstance(i, str) else i.name
                             for i in inputs]
        aux_names = outputs.list_auxiliary_states()
        self._arg_names = outputs.list_arguments() + aux_names
        self.__dict__["_fn"] = outputs._lower(self._arg_names)
        params = params or {}
        params = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                  else k: v for k, v in params.items()}
        for name in self._arg_names:
            if name in self._input_names:
                continue
            p = Parameter(name=name, allow_deferred_init=True,
                          grad_req="null" if name in aux_names else "write",
                          aux_state=name in aux_names)
            if name in params:
                v = params[name]
                _set_value(p, v._data if isinstance(v, NDArray)
                           else torch.as_tensor(v))
            self._reg_params[name] = p

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A block from ``symbol_file`` (and ``param_file``), its values
        on ``ctx`` (default: the current context).  An export of the port
        gives an :class:`_ExportedBlock`; one of the reference (StableHLO)
        raises."""
        import json
        from ..context import current_context
        ctx = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        ctx = ctx if ctx is not None else current_context()
        with open(symbol_file) as f:
            raw = json.load(f)
        fmt = raw.get("format") if isinstance(raw, dict) else None
        if fmt == _REFERENCE_EXPORT_FORMAT:
            raise MXNetError(
                f"{symbol_file} is an export of the JAX package (format "
                f"{fmt!r}): its programs are StableHLO, which PyTorch "
                "cannot run; export the block again with this package, or "
                "load its symbol json and .params instead")
        if fmt == EXPORT_FORMAT:
            return _ExportedBlock(raw, param_file, ctx)
        from ..symbol import load as sym_load
        outputs = sym_load(symbol_file)
        params = {}
        if param_file:
            from ..ndarray import load as nd_load
            with ctx:
                params = nd_load(param_file)
        return SymbolBlock(outputs, input_names, params=params)

    def forward(self, *args):
        if len(args) != len(self._input_names):
            raise MXNetError(
                f"SymbolBlock expects {len(self._input_names)} inputs "
                f"{self._input_names}, got {len(args)}")
        feed = dict(zip(self._input_names, args))
        arrays = []
        for name in self._arg_names:
            if name in feed:
                arrays.append(feed[name])
                continue
            p = self._reg_params[name]
            if p._data is None and p._override is None:
                raise MXNetError(
                    f"SymbolBlock parameter {name!r} has no value; pass it "
                    "via params= or set_data() before forward")
            arrays.append(p._tensor())
        outs = self._fn(arrays)
        return outs[0] if len(outs) == 1 else outs


class _ExportedBlock(Block):
    """A block rebuilt from a :meth:`HybridBlock.export`
    (``mxnet_tpu/gluon/block.py:723-780``): the parameters from the
    ``.params`` file and one ``torch.export`` program per exported input
    signature, moved to ``ctx`` (``move_to_device_pass``) when exported
    on another device.  A call picks the program of its inputs' shapes
    and dtypes and raises for any other.  It runs where the defining
    class is absent; the port must be imported (its custom ops)."""

    def __init__(self, manifest, param_file=None, ctx=None):
        super().__init__()
        import base64
        import io
        from ..context import current_context
        ctx = ctx if ctx is not None else current_context()
        self._device = ctx.torch_device
        self._pkeys = list(manifest["params"])
        loaded = {}
        if param_file:
            from ..ndarray import load as nd_load
            with ctx:
                loaded = nd_load(param_file)
            loaded = {k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                      else k: v for k, v in loaded.items()}
        for name in self._pkeys:
            p = Parameter(name=name, allow_deferred_init=True,
                          grad_req="null")
            if name in loaded:
                _set_value(p, loaded[name]._data.to(self._device))
            self._reg_params[name] = p
        self._entries = []
        for node in manifest["nodes"]:
            prog = torch.export.load(io.BytesIO(
                base64.b64decode(node["payload"])))
            if torch.device(node.get("device", "cpu")) != self._device:
                from torch.export.passes import move_to_device_pass
                prog = move_to_device_pass(prog, self._device)
            sig = tuple((tuple(i["shape"]), i["dtype"])
                        for i in node["inputs"])
            self.__dict__.setdefault("_mods", []).append(prog.module())
            self._entries.append((sig, len(self._mods) - 1,
                                  int(node["n_out"]),
                                  list(node.get("vocabs") or [])))

    def input_signatures(self):
        """The exported input signatures, ``[((shape, dtype), ...), ...]``:
        the serving engine's shape buckets."""
        return [sig for sig, _, _, _ in self._entries]

    def run(self, *tensors):
        """The program of these tensors' signature on them: ``(outputs,
        id bounds or None, vocabs)``, nothing checked."""
        want = tuple((tuple(t.shape), str(t.dtype).replace("torch.", ""))
                     for t in tensors)
        entry = next((e for e in self._entries if e[0] == want), None)
        if entry is None:
            raise MXNetError(f"no exported signature matches inputs "
                             f"{want}; available: "
                             f"{[e[0] for e in self._entries]}")
        _, i, n_out, vocabs = entry
        flat = self._mods[i](
            *[self._reg_params[k]._tensor() for k in self._pkeys], *tensors)
        flat = list(flat) if isinstance(flat, (tuple, list)) else [flat]
        return flat[:n_out], (flat[n_out] if vocabs else None), vocabs

    def forward(self, *args):
        from ..ops.tensor import IdCheck
        with torch.no_grad():
            outs, bounds, vocabs = self.run(*[
                a.to(self._device) for a in args])
        if vocabs:
            IdCheck.raise_if_bad(bounds.cpu(), vocabs)
        return outs[0] if len(outs) == 1 else list(outs)
