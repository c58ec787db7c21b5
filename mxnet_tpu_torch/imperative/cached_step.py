"""Whole-step capture for the eager Gluon loop (counterpart of
``mxnet_tpu/imperative/cached_step.py``).

After one eager ``record() -> backward() -> Trainer.step()`` the step's
tape is exported into a *structure*, and the next step that matches it
is **deferred**: each recorded call returns placeholders
(:class:`_DeferredData`) instead of running, ``backward`` marks the
parameters' gradient buffers deferred, and ``Trainer.step`` runs ONE
function that replays the recorded forward, takes the gradients with
``torch.autograd.grad`` from the heads to the trainer's weights and
applies the fused optimizer update (``ops/optimizer_ops.py``'s
``<op>_multi`` groups, ``optimizer/fused_step.py``'s rule).  On a CUDA
device that function is one :class:`~mxnet_tpu_torch.executable.
Executable`: its first call is the step itself, run eagerly, and the
CUDA graph is captured after it; every later matching step replays the
graph.  ``dispatch.count`` ticks once for it.

The tape.  The reference records op calls on its own autograd tape; the
port records with torch's autograd, so this module builds the tape
itself while an eager step is observed.  A record is one call through
the op funnel (``ops/registry.py`` ``apply_torch``), keyed by (op name,
static params), or one outermost call of a ``HybridBlock`` with arrays
(the block's whole torch forward, keyed by the block and its other
arguments): the counterpart of the reference's cached-op record, which
rests on the same contract, a forward with no control flow of its own.
A plain ``Block`` is never one record: its forward runs at every step,
deferred or not, and each block it calls is a call of its own
(:func:`plain_forward`), so that a branch it takes on Python state is a
divergence from the tape, as in the reference, which records a plain
Block op by op.  Each input of a record is a source: a parameter of the
trainer, a frozen parameter, an external tensor (the batch) or output k
of an earlier record.  Parameters a block reads itself are read at
their fixed addresses inside the graph.

Keying and fallback, as in the reference:

- a structure is keyed by every record's identity, input sources,
  shapes and dtypes, the heads, the parameters' specs, the optimizer
  family and its statics, the training flags and the numerics token
  (``ops/registry.py`` ``_env_numerics_key``: the AMP policy), so a new
  input shape or another control flow captures under a new key; a
  trainer holds at most ``MXNET_JIT_MAX_SIGS`` of them;
- a host read of a placeholder (``asnumpy``, ``wait_to_read``,
  ``copyto``, any other use of its tensor) or a structure mismatch is a
  **graph break**: the pending records replay eagerly in tape order, a
  pending backward runs for real, and the step goes on as the eager
  step with the eager step's results.  ``4 * MXNET_JIT_MAX_SIGS`` breaks
  latch capture off for the trainer;
- a step the structure cannot hold is **declined** at arming, with a
  reason; a capture that fails marks its structure bad and the step
  runs eagerly (``fallbacks``);
- ``MXNET_CACHED_STEP=0`` turns capture off (read at each step).

Under the AMP policy the step carries the reference's implicit loss
scaler (:func:`_trainer_scaler`): the seeds are scaled, the gradients
unscaled and checked for overflow in the graph, an overflowing step
keeps the old weights and states (``torch.where``) and halves the
scale, all in the same graph.  The scale and the clean-step count are
device tensors the graph updates in place, handed to the scaler with
``adopt_traced`` as ``SPMDTrainer`` does.

Under ZeRO-1 (``Trainer(zero=1)`` / ``MXNET_ZERO``, over the dp width of
``parallel.default_mesh``; ``cached_step.py:948-1016, 1113-1250``) the
structure keys on the width, the optimizer states are this rank's flat
chunks (``fused_step.shard_states`` before the capture) and the update
in the graph is ``fused_step.make_sharded_update_fn``'s: the chunks
update and all-gather back.  A width that changed since the capture
("zero sharding toggled since capture") is a graph break.  The ranks
run the same step on the same batch: nothing is split over them, so a
BatchNorm in the captured step takes the whole batch's statistics as it
is.

Two reference behaviours differ on purpose.  A host read of a gradient
placeholder after the break (``amp.scale_loss``'s overflow check reads
the gradients inside ``record()``) gets the gradient the break's
backward wrote; the reference raises there ("a deferred array escaped
its captured step").  And an embedding's id range check inside a
captured step is deferred to the next step on CUDA, as in
``SPMDTrainer``.

Counters: ``cachedstep.{hits,compiles,fallbacks,graph_breaks}``
(telemetry) and :func:`stats`, which stands in for the reference's
``profiler.counters()['cached_step']``.
"""
from __future__ import annotations

import contextlib
import operator
import os
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as onp
import torch

from .. import telemetry, tracing

__all__ = ["enabled", "stats", "reset_stats", "trainer_state",
           "trainer_step", "resolve", "ensure_real", "break_if_deferring"]

# -- counters ----------------------------------------------------------------

_STAT_NAMES = ("captures", "compiles", "hits", "steps", "fallbacks",
               "graph_breaks")
_C = {k: telemetry.counter(f"cachedstep.{k}") for k in _STAT_NAMES}
_C_DISPATCH = telemetry.counter("dispatch.count")


def stats() -> Dict[str, int]:
    """Snapshot of the cached-step counters (``cachedstep.*`` in
    telemetry)."""
    return {k: c.value for k, c in _C.items()}


def reset_stats() -> None:
    telemetry.reset("cachedstep.")


def enabled() -> bool:
    """``MXNET_CACHED_STEP``: 0/false/off turns whole-step capture off
    (read at each step)."""
    return os.environ.get("MXNET_CACHED_STEP", "1").lower() \
        not in ("0", "false", "off")


# -- the fast gate -----------------------------------------------------------
# threads that observe or defer a step: the op funnel and Block.__call__
# check this one module int before paying anything more
_GATE = 0
_OBSERVING = 0
_ACTIVE = 0          # threads deferring

_tls = threading.local()


def _t():
    st = _tls
    if not hasattr(st, "ctx"):
        st.ctx = None       # the _Ctx this thread defers
        st.obs = None       # the _Obs of the eager step being observed
        st.armed = None     # the _State of the last trainer that armed
        st.depth = 0        # > 0 inside a recorded call (not a record)
        st.plain = 0        # > 0 inside a plain Block's forward
        st.aux = False      # a recorded block wrote an auxiliary state
    return st


def _gate():
    global _GATE
    _GATE = _OBSERVING + _ACTIVE


def reset_after_fork() -> None:
    """Forget every observed or deferred step in a forked child (a
    DataLoader worker): it inherited the forking thread's state, and
    none of its calls may enter a step's tape."""
    global _OBSERVING, _ACTIVE, _PLAIN
    _OBSERVING = _ACTIVE = _PLAIN = 0
    _tls.__dict__.clear()
    _gate()


def _set_obs(st, obs) -> None:
    global _OBSERVING
    _OBSERVING += (obs is not None) - (st.obs is not None)
    st.obs = obs
    _gate()


def _open_ctx(st, ctx) -> None:
    global _ACTIVE
    st.ctx = ctx
    _ACTIVE += 1
    _gate()


def _close_ctx(st, ctx) -> None:
    global _ACTIVE
    if st.ctx is ctx:
        st.ctx = None
        _ACTIVE = max(0, _ACTIVE - 1)
        _gate()


_PASS = object()            # intercept's "run the call as it is"


# -- the placeholder ---------------------------------------------------------

class _DeferredData:
    """Stands in for a tensor that a deferred step has not computed yet.
    ``shape``, ``dtype``, ``device``, ``dim()`` and ``numel()`` answer
    from the record; any other use of the tensor (an attribute, or a
    torch function given the placeholder) is a host read: a graph break
    that materializes the step, then the real tensor's.  ``value`` is
    filled when the step runs, so aliases held across it resolve."""

    __slots__ = ("shape", "dtype", "device", "kind", "pos", "idx", "value",
                 "owner", "__weakref__")

    def __init__(self, shape, dtype, device, kind, pos, idx, owner):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = device
        self.kind = kind            # "out" (a record's output) | "grad"
        self.pos = pos
        self.idx = idx
        self.value = None
        self.owner = owner          # the _Ctx that made it

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return int(onp.prod(self.shape, dtype=onp.int64))

    def __getattr__(self, name):
        return getattr(resolve(self), name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_resolve_all(args), **_resolve_all(kwargs or {}))

    def __repr__(self):
        return (f"<deferred {self.kind} {tuple(self.shape)} {self.dtype} "
                f"of record {self.pos}>")


def _delegate(name):
    def method(self, *args):
        return getattr(resolve(self), name)(*_resolve_all(args))
    method.__name__ = name
    return method


# Python's operators look their methods up on the type, past __getattr__
for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__pow__",
              "__rpow__", "__neg__", "__abs__", "__getitem__", "__setitem__",
              "__len__", "__iter__", "__bool__", "__float__", "__int__",
              "__eq__", "__ne__", "__lt__", "__le__", "__gt__", "__ge__"):
    setattr(_DeferredData, _name, _delegate(_name))
_DeferredData.__hash__ = object.__hash__


def _resolve_all(v):
    if type(v) is _DeferredData:
        return resolve(v)
    if isinstance(v, (list, tuple)):
        return type(v)(_resolve_all(x) for x in v)
    if isinstance(v, dict):
        return {k: _resolve_all(x) for k, x in v.items()}
    return v


def resolve(a):
    """The real tensor for ``a``: ``a`` itself unless it is a placeholder,
    whose read is a graph break that materializes the pending step."""
    if type(a) is not _DeferredData:
        return a
    if a.value is None:
        st = _t()
        if st.ctx is not None and a.owner is st.ctx:
            _break(st.ctx, "host sync on a deferred array")
    if a.value is None:
        from ..base import MXNetError
        raise MXNetError("internal: a deferred array escaped its "
                         "captured step without being materialized")
    return a.value


def ensure_real(nd) -> None:
    """Make ``nd._data`` real in place when it is a placeholder (the
    NDArray's host-read hook).  A gradient buffer the break restored and
    its backward rewrote keeps that tensor."""
    d = nd._data
    if type(d) is _DeferredData:
        v = resolve(d)
        if nd._data is d:
            nd._data = v


def _spec(t) -> Tuple:
    return (tuple(t.shape), t.dtype, t.device)


# -- the tape ----------------------------------------------------------------

def _is_tensor(v) -> bool:
    return isinstance(v, torch.Tensor)


def _flatten(value, is_leaf=_is_tensor):
    """(leaves, tree) of a value nested in tuples and lists: the leaves
    are what ``is_leaf`` picks (a block's output: its tensors), in order,
    and :func:`_unflatten` rebuilds the value from the tree and leaves.
    (No closure that calls itself: such a closure is a reference cycle,
    which would keep the leaves, and a step's autograd graph, alive
    until the cyclic collector ran.  A graph kept alive that long holds
    the weights' gradient accumulators on the stream they were made on,
    and a CUDA graph capture that meets one fails.)"""
    leaves = []
    return leaves, _flatten_into(value, is_leaf, leaves)


def _flatten_into(v, is_leaf, leaves):
    if is_leaf(v):
        leaves.append(v)
        return ("t",)
    if isinstance(v, (tuple, list)):
        return ("c", type(v), tuple(_flatten_into(x, is_leaf, leaves)
                                    for x in v))
    return ("v", v)


def _unflatten(tree, leaves):
    return _unflatten_from(tree, iter(leaves))


def _unflatten_from(tree, it):
    if tree[0] == "t":
        return next(it)
    if tree[0] == "c":
        return tree[1](_unflatten_from(x, it) for x in tree[2])
    return tree[1]


_PLAIN_VALUES = (type(None), bool, int, float, complex, str, bytes,
                 torch.dtype, torch.device)


def _tree_key(tree):
    """A hashable key for a tree of :func:`_flatten`: a plain value (a
    number, a string, a dtype) by its type and value, any other object by
    its identity.  Whoever keeps the key keeps the tree, and so the
    object, alive: its identity is not reused while the key is in use."""
    tag = tree[0]
    if tag == "t":
        return tree
    if tag == "c":
        return ("c", tree[1], tuple(_tree_key(x) for x in tree[2]))
    v = tree[1]
    if isinstance(v, _PLAIN_VALUES):
        return ("v", type(v), v)
    return ("o", id(v))


class _Rec:
    """One observed call: ``fn`` on tensors, its key, its inputs'
    sources (``("out", pos, k)`` or ``("leaf", tensor)``), its outputs'
    specs, and how to rebuild them (``multi`` for a list of a funnel op,
    ``tree`` for a block)."""

    __slots__ = ("fn", "key", "srcs", "in_specs", "out_specs", "multi",
                 "tree", "training", "aux", "block")

    def __init__(self, fn, key, srcs, in_specs, out_specs, multi, tree,
                 training, aux, block):
        self.fn, self.key, self.srcs = fn, key, srcs
        self.in_specs, self.out_specs = in_specs, out_specs
        self.multi, self.tree = multi, tree
        self.training, self.aux, self.block = training, aux, block


class _Obs:
    """What an eager step shows for arming: its tape, the heads and the
    flags, filled by the funnel, ``Block.__call__`` and ``backward``."""

    __slots__ = ("training", "poisoned", "reason", "tape", "outs",
                 "records", "heads", "bwd_train", "delivered")

    def __init__(self, training):
        self.training = bool(training)
        self.poisoned = False
        self.reason = None
        self.tape: List[_Rec] = []
        # id(output tensor) -> (weakref, pos, k)
        self.outs: Dict[int, Tuple] = {}
        self.records: Optional[List[_Rec]] = None
        self.heads: Optional[List] = None   # ((pos, k) | None, spec, hg)
        self.bwd_train = True
        self.delivered: List = []

    def poison(self, reason):
        if not self.poisoned:
            self.poisoned = True
            self.reason = reason

    def add(self, fn, key, ins, outs, multi, tree, training, aux, block):
        srcs = []
        for t in ins:
            e = self.outs.get(id(t))
            if e is not None and e[0]() is t:
                srcs.append(("out", e[1], e[2]))
            else:
                srcs.append(("leaf", t))
        pos = len(self.tape)
        for k, o in enumerate(outs):
            self.outs[id(o)] = (weakref.ref(o), pos, k)
        self.tape.append(_Rec(fn, key, tuple(srcs),
                              tuple(_spec(t) for t in ins),
                              tuple(_spec(o) for o in outs), multi, tree,
                              training, aux, block))


# -- per-trainer capture state ----------------------------------------------

class _Entry:
    __slots__ = ("structure", "execs", "ptrs", "dtypes")

    def __init__(self, structure):
        self.structure = structure
        self.execs: Dict[Any, Any] = {}  # grouping -> (Executable, IdCheck)
        self.ptrs = None        # the addresses the graphs were captured on
        self.dtypes = None      # each parameter's (weight, states) dtypes


class _State:
    """A trainer's capture state: structure key -> :class:`_Entry`, at
    most ``MXNET_JIT_MAX_SIGS`` of them; persistent breaks or key churn
    latch capture off for the trainer."""

    __slots__ = ("trainer", "cache", "bad", "current", "breaks", "disabled",
                 "last_reason", "last_error", "owner", "amp", "amp_version")

    def __init__(self, trainer):
        self.trainer = weakref.ref(trainer)
        self.cache: Dict[Any, _Entry] = {}
        self.bad: set = set()
        self.current: Optional[_Entry] = None
        self.breaks = 0
        self.disabled = False
        self.last_reason: Optional[str] = None
        self.last_error: Optional[str] = None   # a failed capture, its error
        from ..executable import CaptureOwner
        self.owner = CaptureOwner()  # graph pool, stream, deferred ids
        self.amp = None              # (scale, clean steps, skipped) tensors
        self.amp_version = None


def trainer_state(trainer) -> Dict[str, Any]:
    """Introspection (tests, debugging)."""
    state = getattr(trainer, "_cached_step_state", None)
    if state is None:
        return {"captures": 0, "breaks": 0, "disabled": False,
                "armed": False, "last_reason": None, "last_error": None}
    return {"captures": len(state.cache), "breaks": state.breaks,
            "disabled": state.disabled,
            "armed": state.current is not None,
            "last_reason": state.last_reason,
            "last_error": state.last_error}


# -- the structure (the exported tape) ---------------------------------------

class _Step:
    __slots__ = ("fn", "key", "multi", "tree", "sources", "training", "aux",
                 "block")

    def __init__(self, rec, sources):
        self.fn, self.key = rec.fn, rec.key
        self.multi, self.tree = rec.multi, rec.tree
        self.sources = sources      # per input: ("out", pos, k) |
        #                             ("param", k) | ("frozen", q) | ("ext", e)
        self.training, self.aux, self.block = rec.training, rec.aux, \
            rec.block

    def run(self, args):
        """The call on tensors; its outputs as a flat list."""
        out = self.fn(*args)
        if self.tree is not None:
            return _flatten(out)[0]
        return list(out) if self.multi else [out]

    def wrap(self, nds):
        """The call's result from its flat outputs (NDArrays)."""
        if self.tree is not None:
            return _unflatten(self.tree, nds)
        return nds if self.multi else nds[0]


class _Structure:
    __slots__ = ("steps", "out_specs", "ext_specs", "diff_idx", "frozen_idx",
                 "param_specs", "frozen_specs", "heads", "head_specs",
                 "head_seed_ext", "statics_key", "dyn_names", "op_name",
                 "opt_type", "training", "bwd_train", "amp", "zero_ndev",
                 "key")


class _Pending:
    """A deferred record: its step, its input values (placeholders of
    this context for "out" sources), and weak references to the NDArrays
    and placeholders it handed out."""

    __slots__ = ("pos", "step", "args", "nds", "phs")

    def __init__(self, pos, step, args, nds, phs):
        self.pos, self.step, self.args = pos, step, args
        self.nds, self.phs = nds, phs


class _Ctx:
    __slots__ = ("state", "structure", "pos", "recs", "ext_vals",
                 "param_arrays", "frozen_arrays", "backward_done",
                 "heads_nd", "head_grads_nd", "bwd_train_arg", "grad_marks")

    def __init__(self, state, structure, param_arrays, frozen_arrays):
        self.state = state
        self.structure = structure
        self.pos = 0
        self.recs: List[_Pending] = []
        self.ext_vals: List = [None] * len(structure.ext_specs)
        self.param_arrays = param_arrays
        self.frozen_arrays = frozen_arrays
        self.backward_done = False
        self.heads_nd = None
        self.head_grads_nd = None
        self.bwd_train_arg = True
        self.grad_marks: List = []               # (grad_nd, placeholder, orig)


# -- autograd-facing hooks ---------------------------------------------------

_TRAINERS = weakref.WeakSet()      # the gluon Trainers made so far


def register_trainer(trainer) -> None:
    """A gluon ``Trainer`` was made: outermost ``record()`` scopes are
    observed from now on."""
    _TRAINERS.add(trainer)


def _may_capture() -> bool:
    """A live trainer has not latched capture off: without one no step
    can be captured, and a loop is not observed (an ``mx.nd`` loop with
    no Trainer pays nothing for the capture)."""
    for trainer in _TRAINERS:
        state = getattr(trainer, "_cached_step_state", None)
        if state is None or not state.disabled:
            return True
    return False


def note_record_enter() -> None:
    """An OUTERMOST ``record()`` scope opened: start observing the step,
    and, when a structure is armed that this step may match, defer it."""
    st = _t()
    if st.ctx is not None:
        # the previous deferred step never reached trainer.step
        _break(st.ctx, "record() while a captured step was pending")
    if not enabled() or not _may_capture():
        _set_obs(st, None)
        return
    from .. import autograd
    training = autograd.is_training()
    _set_obs(st, _Obs(training))
    state = st.armed
    if state is None or state.disabled or state.current is None:
        return
    from ..optimizer import fused_step
    if not fused_step.enabled():
        return
    trainer = state.trainer()
    if trainer is None:
        st.armed = None
        return
    stt = state.current.structure
    if stt.training != bool(training):
        return                       # train/predict flip: observe eagerly
    from ..ops import registry as _reg
    if stt.key[-1] != _reg._env_numerics_key():
        state.current = None         # the numerics flipped: stale capture
        return
    try:
        params = trainer._params
        pa = [params[i]._data for i in stt.diff_idx]
        fa = [params[i]._data for i in stt.frozen_idx]
    except Exception:
        return
    if any(t is None or _spec(t) != s for t, s in zip(pa, stt.param_specs)) \
            or any(t is None or _spec(t) != s
                   for t, s in zip(fa, stt.frozen_specs)):
        return
    _open_ctx(st, _Ctx(state, stt, pa, fa))


def notify_hooks() -> None:
    """A Block with forward hooks ran: hooks see real activations, so the
    step can neither be captured nor stay deferred."""
    st = _t()
    if st.obs is not None:
        st.obs.poison("forward hook attached")
    if st.ctx is not None and not st.depth:
        _break(st.ctx, "forward hook attached")


def note_aux_write() -> None:
    """A layer wrote an auxiliary state in place (BatchNorm's running
    statistics): the record it ran in cannot be deferred, since the
    write needs the real values (the reference reads them back there)."""
    _t().aux = True


def note_backward(heads, head_grads, train_mode, retain_graph,
                  delivered) -> None:
    """The end of an eager ``backward``: the heads, their seeds and the
    variables that received a gradient complete the observation."""
    st = _t()
    obs = st.obs
    if obs is None:
        return
    if obs.records is not None:
        obs.poison("multiple backward calls in one step")
        return
    if retain_graph:
        obs.poison("retain_graph backward")
        return
    hs = []
    hgs = head_grads if head_grads is not None else [None] * len(heads)
    for h, hg in zip(heads, hgs):
        t = h._data
        if type(t) is _DeferredData or not t.requires_grad:
            obs.poison("head outside the recorded graph")
            return
        e = obs.outs.get(id(t))
        src = (e[1], e[2]) if e is not None and e[0]() is t else None
        spec = None
        if hg is not None:
            if type(hg._data) is _DeferredData:
                obs.poison("deferred head_grad")
                return
            spec = _spec(hg._data)
        hs.append((src, _spec(t), spec))
    obs.records = list(obs.tape)
    obs.heads = hs
    obs.bwd_train = bool(train_mode)
    obs.delivered = list(delivered)


def deferred_backward(heads, head_grads, retain_graph, train_mode,
                      create_graph) -> bool:
    """``autograd.backward`` while deferring: True when the backward was
    absorbed into the capture; False means the caller runs the real one
    (any pending records have been materialized first)."""
    st = _t()
    ctx = st.ctx
    if ctx is None:
        return False
    if ctx.backward_done:
        _break(ctx, "second backward in a captured step")
        return False
    if retain_graph or create_graph:
        _break(ctx, "backward flags unsupported by capture")
        return False
    stt = ctx.structure
    if ctx.pos != len(stt.steps):
        _break(ctx, "backward before the captured graph completed")
        return False
    if bool(train_mode) != stt.bwd_train:
        _break(ctx, "backward train_mode differs from capture")
        return False
    hgs = head_grads if head_grads is not None else [None] * len(heads)
    if len(heads) != len(stt.heads):
        _break(ctx, "different number of heads")
        return False
    for k, (h, hg) in enumerate(zip(heads, hgs)):
        d = h._data
        if type(d) is not _DeferredData or d.owner is not ctx \
                or (d.pos, d.idx) != stt.heads[k]:
            _break(ctx, "different heads than captured")
            return False
        eid = stt.head_seed_ext[k]
        if (hg is None) != (eid is None):
            _break(ctx, "head_grads pattern differs from capture")
            return False
        if hg is not None:
            a = hg._data
            if type(a) is _DeferredData:
                _break(ctx, "deferred head_grad")
                return False
            if _spec(a) != stt.ext_specs[eid]:
                _break(ctx, "head_grad shape differs from capture")
                return False
            prev = ctx.ext_vals[eid]
            if prev is not None and prev is not a:
                _break(ctx, "conflicting head_grad value")
                return False
            ctx.ext_vals[eid] = a
    trainer = ctx.state.trainer()
    if trainer is None:
        _break(ctx, "trainer collected")
        return False
    marks = []
    for k, i in enumerate(stt.diff_idx):
        p = trainer._params[i]
        gnd = p._grad
        if gnd is None or p.grad_req != "write":
            _break(ctx, "parameter grad config changed since capture")
            return False
        marks.append((gnd, gnd._data))
    ctx.grad_marks = []
    for k, (gnd, orig) in enumerate(marks):
        ph = _DeferredData(orig.shape, orig.dtype, orig.device, "grad", k, 0,
                           ctx)
        ctx.grad_marks.append((gnd, ph, orig))
        gnd._data = ph
    ctx.heads_nd = list(heads)
    ctx.head_grads_nd = list(hgs)
    ctx.bwd_train_arg = train_mode
    ctx.backward_done = True
    return True


# -- the funnel's and Block.__call__'s intercept -----------------------------

def funnel(fn, key, nd_inputs, run):
    """The op funnel while some thread observes or defers
    (``registry.apply_torch`` calls it behind ``_GATE``): defer a matching
    call, or run it and add it to the observed tape."""
    st = _t()
    if st.depth:
        return run(fn, nd_inputs)
    ctx = st.ctx
    if ctx is not None:
        res = _intercept(ctx, key, nd_inputs)
        if res is not _PASS:
            return res
    _settle(nd_inputs)
    obs = st.obs
    from .. import autograd
    if obs is None or obs.records is not None or \
            not autograd.is_recording():
        return run(fn, nd_inputs)
    out = run(fn, nd_inputs)
    outs = out if isinstance(out, list) else [out]
    obs.add(fn, key, [x._data for x in nd_inputs], [o._data for o in outs],
            isinstance(out, list), None, autograd.is_training(), False, None)
    return out


def _settle(nd_inputs) -> None:
    """An NDArray still holding a placeholder that a break or a step has
    filled (a plain Block's forward wraps placeholders anew) takes its
    value, so the call runs, and is observed, on the real tensor."""
    for x in nd_inputs:
        d = x._data
        if type(d) is _DeferredData and d.value is not None:
            x._data = d.value


def call_block(block, fn, key, nd_inputs):
    """An outermost ``HybridBlock`` call with NDArrays: ``fn`` runs the
    block's torch forward on the inputs' tensors.  Deferred, or run (and
    observed, while recording) as one record, like a funnel call; ticks
    ``dispatch.count`` once."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray
    st = _t()
    obs, outer = None, not st.depth
    if _GATE and outer:
        if st.ctx is not None:
            res = _intercept(st.ctx, key, nd_inputs)
            if res is not _PASS:
                return res
        if st.obs is not None and st.obs.records is None and \
                autograd.is_recording():
            obs = st.obs
        _settle(nd_inputs)
    if outer:
        st.aux = False
    st.depth += 1
    try:
        with torch.set_grad_enabled(autograd.is_recording()):
            out = fn(*[x._data for x in nd_inputs])
    finally:
        st.depth -= 1
    _C_DISPATCH.inc()
    leaves, tree = _flatten(out)
    if obs is not None:
        obs.add(fn, key, [x._data for x in nd_inputs], leaves, False, tree,
                autograd.is_training(), st.aux, block)
    return _unflatten(tree, [NDArray._wrap(t) for t in leaves])


_PLAIN = 0        # threads inside a plain Block's forward


@contextlib.contextmanager
def plain_forward():
    """The forward of a plain ``Block`` called with NDArrays: each Block
    it calls with tensors, outside any record, is a call of its own (a
    record, or a hybridized block's graph), as if given NDArrays.  The
    forward's own Python runs at every step, deferred or not, so a
    branch it takes is seen, as the reference sees each op of a plain
    Block's forward."""
    global _PLAIN
    st = _t()
    st.plain += 1
    _PLAIN += 1
    try:
        yield
    finally:
        st.plain -= 1
        _PLAIN -= 1


def in_plain_forward() -> bool:
    """True where a Block called with tensors is a call of its own: in a
    plain Block's forward and not inside a record."""
    if not _PLAIN:
        return False
    st = _t()
    return bool(st.plain) and not st.depth


@contextlib.contextmanager
def inside_record():
    """A forward the tape does not look into (a hybridized block's):
    the calls it makes are its own business, as inside a record."""
    st = _t()
    st.depth += 1
    try:
        yield
    finally:
        st.depth -= 1


def check_inputs(values) -> None:
    """A call that reads its inputs outside the tape (a hybridized
    forward) on these tensors: a placeholder among them is a graph
    break."""
    st = _t()
    if st.ctx is not None:
        for a in values:
            if type(a) is _DeferredData:
                _break(st.ctx, "op on deferred data outside record()")
                return


def _intercept(ctx, key, nd_inputs):
    from .. import autograd
    if not autograd.is_recording():
        # a paused call: fine on real data; a placeholder is a break
        for x in nd_inputs:
            if type(x._data) is _DeferredData:
                _break(ctx, "op on deferred data outside record()")
                break
        return _PASS
    try:
        return _validate_and_defer(ctx, key, nd_inputs)
    except _BreakSignal:
        return _PASS
    except Exception:
        # capture bookkeeping never takes a training step down
        _break(ctx, "internal capture error")
        return _PASS


class _BreakSignal(Exception):
    pass


def _mismatch(ctx, reason):
    _break(ctx, reason)
    raise _BreakSignal()


def _op_matches(ctx, stt, key, nd_inputs):
    """Check one call against ``stt`` at ``ctx.pos`` without changing the
    context: (reason or None, the external slots to bind)."""
    if ctx.pos >= len(stt.steps):
        return "more ops than captured", None
    sp = stt.steps[ctx.pos]
    if key is None or key != sp.key:
        return "op divergence from captured tape", None
    if len(nd_inputs) != len(sp.sources):
        return "op arity divergence", None
    fills = []
    for x, src in zip(nd_inputs, sp.sources):
        a = x._data
        tag = src[0]
        if type(a) is _DeferredData:
            if a.owner is not ctx or a.kind != "out" or tag != "out" \
                    or a.pos != src[1] or a.idx != src[2]:
                return "dataflow divergence from captured tape", None
        elif tag == "param":
            if a is not ctx.param_arrays[src[1]]:
                return "parameter input divergence", None
        elif tag == "frozen":
            if a is not ctx.frozen_arrays[src[1]]:
                return "frozen-parameter input divergence", None
        elif tag == "ext":
            eid = src[1]
            if _spec(a) != stt.ext_specs[eid]:
                return "input shape/dtype divergence", None
            if a.requires_grad:
                return "dataflow divergence from captured tape", None
            prev = ctx.ext_vals[eid] if eid < len(ctx.ext_vals) else None
            if prev is None:
                fills.append((eid, a))
            elif prev is not a:
                return "external input aliasing divergence", None
        else:
            return "dataflow divergence from captured tape", None
    return None, fills


def _steps_equal(a, b):
    return a.key == b.key and a.multi == b.multi and a.tree == b.tree \
        and a.sources == b.sources


def _find_candidate(ctx, key, nd_inputs):
    """On a mismatch, another cached structure whose prefix matches what
    was deferred so far and which takes this call (two batch shapes
    alternating step to step)."""
    if ctx.backward_done:
        return None, None
    cur = ctx.structure
    p = ctx.pos
    for ent in ctx.state.cache.values():
        stt = ent.structure
        if stt is cur:
            continue
        if (stt.training, stt.bwd_train, stt.op_name, stt.opt_type,
                stt.statics_key, stt.dyn_names, stt.key[-1], stt.amp,
                stt.diff_idx, stt.frozen_idx, stt.param_specs,
                stt.frozen_specs) != \
           (cur.training, cur.bwd_train, cur.op_name, cur.opt_type,
                cur.statics_key, cur.dyn_names, cur.key[-1], cur.amp,
                cur.diff_idx, cur.frozen_idx, cur.param_specs,
                cur.frozen_specs):
            continue
        if len(stt.steps) <= p:
            continue
        if any(not _steps_equal(stt.steps[i], cur.steps[i])
               or stt.out_specs[i] != cur.out_specs[i] for i in range(p)):
            continue
        if any(v is not None and (eid >= len(stt.ext_specs)
                                  or _spec(v) != stt.ext_specs[eid])
               for eid, v in enumerate(ctx.ext_vals)):
            continue
        reason, fills = _op_matches(ctx, stt, key, nd_inputs)
        if reason is None:
            return ent, fills
    return None, None


def _validate_and_defer(ctx, key, nd_inputs):
    reason, fills = _op_matches(ctx, ctx.structure, key, nd_inputs)
    if reason is not None:
        ent, alt_fills = _find_candidate(ctx, key, nd_inputs)
        if ent is None:
            _mismatch(ctx, reason)
        # move the deferral onto the entry that fits, and arm it for the
        # next step
        ctx.structure = ent.structure
        ctx.state.current = ent
        old = ctx.ext_vals
        ctx.ext_vals = [old[i] if i < len(old) else None
                        for i in range(len(ent.structure.ext_specs))]
        fills = alt_fills
    stt = ctx.structure
    pos = ctx.pos
    sp = stt.steps[pos]
    if sp.aux:
        # the block writes an auxiliary state from values this deferred
        # step has not computed
        _mismatch(ctx, "host sync on a deferred array")
    if sp.block is not None and sp.block.has_hooks():
        _mismatch(ctx, "forward hook attached")
    for eid, a in fills:
        ctx.ext_vals[eid] = a
    from ..ndarray.ndarray import NDArray
    phs, nds = [], []
    for k, (shape, dtype, device) in enumerate(stt.out_specs[pos]):
        ph = _DeferredData(shape, dtype, device, "out", pos, k, ctx)
        phs.append(ph)
        nds.append(NDArray._wrap(ph))
    ctx.recs.append(_Pending(pos, sp, [x._data for x in nd_inputs],
                             [weakref.ref(nd) for nd in nds],
                             [weakref.ref(ph) for ph in phs]))
    ctx.pos = pos + 1
    return sp.wrap(nds)


# -- the graph break ---------------------------------------------------------

def _break(ctx, reason: str) -> None:
    """Abort a deferred step: replay the pending records eagerly in tape
    order (filling every live placeholder), restore the gradient buffers
    and run a pending backward for real.  The step is then the eager
    step, and the observation sees it as one."""
    from .. import autograd
    st = _t()
    _close_ctx(st, ctx)
    _C["graph_breaks"].inc()
    state = ctx.state
    state.breaks += 1
    state.last_reason = reason
    from ..ops import registry as _reg
    if state.breaks >= 4 * _reg._MAX_JIT_SIGS:
        state.disabled = True
    for gnd, ph, orig in ctx.grad_marks:
        if gnd._data is ph:
            gnd._data = orig
    marks, ctx.grad_marks = ctx.grad_marks, []
    obs = st.obs
    recs, ctx.recs = ctx.recs, []
    env = {}
    for rec in recs:
        sp = rec.step
        args = [env[(a.pos, a.idx)] if type(a) is _DeferredData
                and a.owner is ctx else a for a in rec.args]
        st.depth += 1
        st.aux = False
        try:
            with torch.enable_grad(), autograd._Scope(sp.training):
                outs = sp.run(args)
        finally:
            st.depth -= 1
        for k, o in enumerate(outs):
            env[(rec.pos, k)] = o
            ph = rec.phs[k]()
            if ph is not None:
                ph.value = o
            nd = rec.nds[k]()
            if nd is not None and type(nd._data) is _DeferredData \
                    and nd._data.owner is ctx:
                nd._data = o
        _C_DISPATCH.inc()
        if obs is not None and obs.records is None:
            obs.add(sp.fn, sp.key, args, outs, sp.multi, sp.tree,
                    sp.training, st.aux, sp.block)
        st.aux = False
    if ctx.backward_done:
        ctx.backward_done = False
        autograd.backward(ctx.heads_nd, ctx.head_grads_nd,
                          train_mode=ctx.bwd_train_arg)
        for gnd, ph, _orig in marks:
            ph.value = gnd._data
    _retire(ctx)


def _retire(ctx) -> None:
    """Drop what a finished context holds: its placeholders point back
    at it, and the cycle would keep the step's values (after a break,
    its autograd graph) alive until the cyclic collector ran."""
    ctx.recs = []
    ctx.grad_marks = []
    ctx.heads_nd = ctx.head_grads_nd = None
    ctx.ext_vals = []


def break_if_deferring(reason: str) -> None:
    """Materialize this thread's pending deferred step, if any (e.g.
    ``Trainer.update``)."""
    st = _t()
    if st.ctx is not None:
        _break(st.ctx, reason)


# -- the trainer's side ------------------------------------------------------

def trainer_step(trainer, ignore_stale_grad=False) -> bool:
    """The ``Trainer.step`` hook: True when the whole step ran as the
    captured function (weights, states and gradients updated); False
    means the caller runs the eager step (any pending deferral has been
    materialized), which is then observed for the next one."""
    st = _t()
    if not enabled():
        if st.ctx is not None:
            _break(st.ctx, "MXNET_CACHED_STEP disabled")
        _set_obs(st, None)
        return False
    ctx = st.ctx
    done = False
    if ctx is not None:
        if ctx.state.trainer() is not trainer:
            _break(ctx, "step by a different trainer")
        else:
            done = _execute(trainer, ctx, ignore_stale_grad)
    if not done:
        _maybe_arm(trainer, ignore_stale_grad)
    return done


def _state_of(trainer) -> _State:
    state = getattr(trainer, "_cached_step_state", None)
    if state is None:
        state = trainer._cached_step_state = _State(trainer)
    return state


def _decline(state, reason) -> None:
    state.last_reason = reason
    _C["fallbacks"].inc()


def _maybe_arm(trainer, ignore_stale_grad) -> None:
    """Take this thread's observation of the eager step that is about to
    finish and arm a structure for the next step."""
    st = _t()
    obs = st.obs
    _set_obs(st, None)
    state = _state_of(trainer)
    st.armed = state
    state.current = None
    if state.disabled:
        return
    if obs is None or obs.records is None:
        return
    if obs.poisoned:
        return _decline(state, obs.reason)
    from ..optimizer import fused_step
    if not fused_step.enabled():
        return _decline(state, "fused step disabled")
    if trainer._kvstore is not None and not trainer._fold_device_allreduce():
        return _decline(state, "kvstore configuration not capturable")
    structure, why = _build_structure(obs, trainer, ignore_stale_grad)
    if structure is None:
        return _decline(state, why)
    if structure.key in state.bad:
        return _decline(state, "structure previously failed to capture")
    ent = state.cache.get(structure.key)
    if ent is None:
        from ..ops import registry as _reg
        if len(state.cache) >= _reg._MAX_JIT_SIGS:
            state.disabled = True
            return _decline(state, "structure signature churn (latched)")
        ent = state.cache[structure.key] = _Entry(structure)
        _C["captures"].inc()
    state.current = ent


def _multi_op(opt):
    from ..ops import optimizer_ops
    return getattr(optimizer_ops, f"{opt.op_name}_multi", None) \
        if opt.op_name else None


def _build_structure(obs, trainer, ignore_stale_grad):
    """The observed tape as a replayable :class:`_Structure`, or (None,
    reason) when the step cannot be captured."""
    from ..ops import registry as _reg
    from ..optimizer.optimizer import Updater

    recs = obs.records
    if not recs:
        return None, "empty tape"
    updater = trainer._updaters[0]
    if type(updater) is not Updater:
        return None, "custom updater"
    opt = updater.optimizer
    if _multi_op(opt) is None:
        return None, "optimizer has no in-trace update op"

    leaf_src: Dict[int, Tuple] = {}
    diff_idx: List[int] = []
    frozen_idx: List[int] = []
    param_specs: List[Tuple] = []
    frozen_specs: List[Tuple] = []
    delivered = {id(v) for v in obs.delivered}
    for i, p in enumerate(trainer._params):
        if p._data is None:
            if p.grad_req != "null" and not ignore_stale_grad:
                return None, "uninitialized parameter"
            continue
        t = p._data
        if p.grad_req == "null" or p._grad is None:
            if p.grad_req != "null" and not ignore_stale_grad:
                return None, "parameter missing its gradient buffer"
            if id(t) not in leaf_src:
                leaf_src[id(t)] = ("frozen", len(frozen_idx))
                frozen_idx.append(i)
                frozen_specs.append(_spec(t))
            continue
        if p.grad_req != "write":
            return None, "grad_req != 'write'"
        if getattr(p._grad, "stype", "default") == "row_sparse":
            return None, "row_sparse gradient"
        if id(t) in leaf_src:
            return None, "parameters share one graph node"
        if id(p._nd) not in delivered:
            return None, "trainable parameter not reachable from heads"
        leaf_src[id(t)] = ("param", len(diff_idx))
        diff_idx.append(i)
        param_specs.append(_spec(t))
    if not diff_idx:
        return None, "no trainable parameters"
    trained = {id(trainer._params[i]._nd) for i in diff_idx}
    if any(id(v) not in trained for v in obs.delivered):
        return None, "grad-attached non-trainer leaf"
    if opt.multi_precision and any(
            trainer._params[i]._data.dtype == torch.float16
            for i in diff_idx):
        return None, "fp16 multi_precision"
    statics = opt._fused_statics(diff_idx[0])
    if statics is None:
        return None, "optimizer statics not traceable"
    for i in diff_idx[1:]:
        if opt._fused_statics(i) != statics:
            return None, "non-uniform optimizer statics"
    statics_key = tuple(sorted(statics.items()))
    dyn_names = tuple(sorted(opt._fused_dynamics(diff_idx[0]).keys()))

    steps: List[_Step] = []
    out_specs: List[Tuple] = []
    ext_specs: List[Tuple] = []
    key_steps: List[Tuple] = []
    for pos, rec in enumerate(recs):
        if rec.key is None:
            return None, "op fn identity not stable across steps"
        srcs: List[Tuple] = []
        for src in rec.srcs:
            if src[0] == "out":
                srcs.append(src)
                continue
            t = src[1]
            s = leaf_src.get(id(t))
            if s is None:
                if t.requires_grad:
                    if t.grad_fn is None:
                        return None, "grad-attached non-trainer leaf"
                    return None, "input produced outside the captured tape"
                s = ("ext", len(ext_specs))
                leaf_src[id(t)] = s
                ext_specs.append(_spec(t))
            srcs.append(s)
        steps.append(_Step(rec, tuple(srcs)))
        out_specs.append(rec.out_specs)
        key_steps.append((rec.key, rec.multi,
                          None if rec.tree is None else _tree_key(rec.tree),
                          tuple(srcs),
                          rec.in_specs, rec.out_specs, rec.training,
                          rec.aux))

    heads: List[Tuple[int, int]] = []
    head_specs: List[Tuple] = []
    head_seed_ext: List[Optional[int]] = []
    for src, spec, hg_spec in obs.heads:
        if src is None:
            return None, "head is not an output of the captured tape"
        heads.append(src)
        head_specs.append(spec)
        if hg_spec is None:
            head_seed_ext.append(None)
        else:
            head_seed_ext.append(len(ext_specs))
            ext_specs.append(hg_spec)

    stt = _Structure()
    stt.steps = steps
    stt.out_specs = out_specs
    stt.ext_specs = tuple(ext_specs)
    stt.diff_idx = tuple(diff_idx)
    stt.frozen_idx = tuple(frozen_idx)
    stt.param_specs = tuple(param_specs)
    stt.frozen_specs = tuple(frozen_specs)
    stt.heads = heads
    stt.head_specs = head_specs
    stt.head_seed_ext = head_seed_ext
    stt.statics_key = statics_key
    stt.dyn_names = dyn_names
    stt.op_name = opt.op_name
    stt.opt_type = type(opt).__name__
    stt.training = obs.training
    stt.bwd_train = obs.bwd_train
    # AMP: the scaler's configuration is structure (the graph holds the
    # scale schedule's arithmetic); the numerics key, kept LAST, covers
    # the policy turning on or off and its dtype
    amp_cfg = None
    from ..amp import policy as _amp_policy
    if _amp_policy.enabled():
        scaler = _trainer_scaler(trainer)
        amp_cfg = (_amp_policy.compute_dtype_str(),
                   float(scaler._scale_factor), int(scaler._scale_window))
    stt.amp = amp_cfg
    stt.zero_ndev = _zero_ndev(trainer)
    stt.key = (tuple(key_steps),
               tuple(zip(heads, head_seed_ext)),
               stt.ext_specs,
               tuple(zip(diff_idx, param_specs)),
               tuple(zip(frozen_idx, frozen_specs)),
               (stt.opt_type, stt.op_name, statics_key, dyn_names, amp_cfg),
               stt.zero_ndev, obs.training, obs.bwd_train,
               _reg._env_numerics_key())
    return stt, None


def _zero_ndev(trainer) -> int:
    """The dp width a ZeRO-1 trainer's update shards over (1: none)."""
    from ..optimizer import fused_step
    active = getattr(trainer, "_zero_active", None)
    if active is None or not active():
        return 1
    return fused_step.zero_degree()


def _trainer_scaler(trainer):
    """The trainer's ``LossScaler``, made when AMP is on without
    ``amp.init_trainer``: bf16 shares f32's exponent range, so the
    implicit scaler starts at 1.0 (the overflow skip and the halving,
    floored at 1.0, stay live; the multiplies are exact); float16 starts
    at 2**16."""
    scaler = getattr(trainer, "_amp_loss_scaler", None)
    if scaler is None:
        from ..amp import policy as _amp_policy
        from ..amp.loss_scaler import LossScaler
        init = 2.0 ** 16 if _amp_policy.compute_dtype_str() == "float16" \
            else 1.0
        scaler = LossScaler(init_scale=init)
        trainer._amp_loss_scaler = scaler
        trainer._amp_original_scale = getattr(trainer, "_scale", 1.0)
    return scaler


# -- the one function --------------------------------------------------------

def _build_step_fn(stt, trainer, state, groups, ids, n_ext):
    """Forward replay, ``torch.autograd.grad`` from the heads to the
    weights and the fused update, as one function of the staged inputs
    (the external tensors, then one f32 vector for each dynamic name,
    one value a group).  Weights, frozen parameters, optimizer states and
    the AMP state are read (and the first three written) at their
    addresses."""
    from .. import autograd
    from ..amp.loss_scaler import advance_device, all_finite
    from ..optimizer.optimizer import _tensor, write_back
    params = trainer._params
    updater = trainer._updaters[0]
    opt = updater.optimizer
    update = _multi_op(opt)
    weights = [params[i]._data for i in stt.diff_idx]
    frozen = [params[i]._data for i in stt.frozen_idx]
    states = [[_tensor(s) for s in updater.states[i]] for i in stt.diff_idx]
    statics = dict(stt.statics_key)
    steps, heads = stt.steps, stt.heads
    seed_ext, head_specs = stt.head_seed_ext, stt.head_specs
    dyn_names = stt.dyn_names
    uses_lr = opt.uses_lr
    amp = state.amp if stt.amp is not None else None
    factor = stt.amp[1] if amp is not None else None
    window = stt.amp[2] if amp is not None else None
    # ZeRO-1: each rank updates its chunk of the flattened weights and
    # states (flat chunks already, shard_states), then all-gathers
    sharded = None
    if stt.zero_ndev > 1:
        from ..optimizer import fused_step
        sharded = fused_step.make_sharded_update_fn(
            stt.op_name, stt.statics_key, dyn_names,
            fused_step._zero_axis())

    def step_fn(*inputs):
        ext, dyn = inputs[:n_ext], dict(zip(dyn_names, inputs[n_ext:]))
        st = _t()
        st.depth += 1
        ids.reset()
        try:
            with torch.enable_grad(), ids:
                env, flat = {}, []
                for pos, sp in enumerate(steps):
                    args = []
                    for s in sp.sources:
                        tag = s[0]
                        if tag == "out":
                            args.append(env[(s[1], s[2])])
                        elif tag == "param":
                            args.append(weights[s[1]])
                        elif tag == "frozen":
                            args.append(frozen[s[1]])
                        else:
                            args.append(ext[s[1]])
                    with autograd._Scope(sp.training):
                        outs = sp.run(args)
                    for k, o in enumerate(outs):
                        env[(pos, k)] = o
                    flat.extend(outs)
                seeds = [torch.ones(shape, dtype=dtype, device=dev)
                         if eid is None else ext[eid]
                         for (shape, dtype, dev), eid in zip(head_specs,
                                                             seed_ext)]
                if amp is not None:
                    seeds = [s * amp[0].to(s.dtype) for s in seeds]
                grads = torch.autograd.grad([env[h] for h in heads],
                                            weights, seeds)
            bounds = ids.bounds()
        finally:
            st.depth -= 1
        with torch.no_grad():
            finite, inv, rescale = None, None, dyn["rescale_grad"]
            if amp is not None:
                # the unscale rides the update's rescale_grad (the scale
                # is a power of two, so g * inv * r is g * (r * inv)
                # exactly), and the scaled gradients' verdict is the
                # unscaled ones' (the scale is at least 1)
                inv = 1.0 / amp[0]
                rescale = rescale * inv
                finite = all_finite(grads)
            for gi, members in enumerate(groups):
                if sharded is not None:
                    dv = {"wd": dyn["wd"][gi], "rescale_grad": rescale[gi]}
                    if uses_lr:
                        dv["lr"] = dyn["lr"][gi]
                    new_w, new_s = sharded(
                        dv, [weights[n] for n in members],
                        [grads[n] for n in members],
                        [tuple(states[n]) for n in members])
                    dests = [weights[n] for n in members] + \
                        [s for n in members for s in states[n]]
                    news = list(new_w) + [t for st in new_s for t in st]
                else:
                    kw = dict(statics)
                    kw["wds"] = dyn["wd"][gi]
                    kw["rescale_grad"] = rescale[gi]
                    if uses_lr:
                        kw["lrs"] = dyn["lr"][gi]
                    n_state = len(states[members[0]])
                    state_lists = [[states[n][j] for n in members]
                                   for j in range(n_state)]
                    out = update([weights[n] for n in members],
                                 [grads[n] for n in members], *state_lists,
                                 **kw)
                    dests = [weights[n] for n in members] + \
                        [s for col in state_lists for s in col]
                    news = [t for col in out for t in col]
                if finite is None:
                    write_back(dests, news)
                    continue
                # an overflow keeps the old bits: each destination takes
                # where(finite, new, old) in place, one pass instead of a
                # select and a copy (a new value that is itself a
                # destination is copied aside first, as write_back does)
                dest_ids = {id(d) for d in dests}
                news = [n.clone() if id(n) in dest_ids else n for n in news]
                for d, n in zip(dests, news):
                    torch.where(finite, n, d, out=d)
            if amp is not None:
                advance_device(amp, finite, factor, window)
        return [o.detach() for o in flat], list(grads), inv, bounds

    return step_fn


def _groups(stt, dtypes, dyns):
    """The update's groups: parameters of equal (weight and state dtypes,
    dynamic values), in order; each takes one multi-tensor call with one
    device scalar for each dynamic value."""
    values = operator.itemgetter(*stt.dyn_names)
    groups: "OrderedDict[tuple, list]" = OrderedDict()
    for n, dt in enumerate(dtypes):
        v = values(dyns[n])
        groups.setdefault((dt, v if len(stt.dyn_names) > 1 else (v,)),
                          []).append(n)
    return list(groups.items())


def _amp_enter(state, scaler, device) -> None:
    """The host's scale into the device state when the host set it (or
    on first use); this call's skipped count to 0."""
    from ..amp.loss_scaler import device_state, enter_device
    if state.amp is None or state.amp[0].device != device:
        state.amp = device_state(device)
        state.amp_version = None
    state.amp_version = enter_device(state.amp, scaler, state.amp_version)


def _execute(trainer, ctx, ignore_stale_grad) -> bool:
    """Finish a deferred step: check it, capture on first use, run the
    one function, fill every live placeholder."""
    from ..optimizer import fused_step
    from ..optimizer.optimizer import Updater, _note_dispatch, _tensor
    stt = ctx.structure
    state = ctx.state
    if ctx.pos != len(stt.steps) or not ctx.backward_done:
        _break(ctx, "trainer.step before forward+backward completed")
        return False
    if not fused_step.enabled():
        _break(ctx, "fused step disabled mid-capture")
        return False
    if trainer._kvstore is not None and not trainer._fold_device_allreduce():
        _break(ctx, "kvstore configuration changed")
        return False
    updater = trainer._updaters[0]
    if type(updater) is not Updater or updater.optimizer.op_name != \
            stt.op_name or type(updater.optimizer).__name__ != stt.opt_type:
        _break(ctx, "optimizer changed since capture")
        return False
    opt = updater.optimizer
    statics = opt._fused_statics(stt.diff_idx[0])
    if statics is None or tuple(sorted(statics.items())) != stt.statics_key \
            or any(opt._fused_statics(i) != statics for i in stt.diff_idx[1:]):
        _break(ctx, "optimizer statics changed since capture")
        return False
    if tuple(sorted(opt._fused_dynamics(stt.diff_idx[0]).keys())) != \
            stt.dyn_names:
        _break(ctx, "optimizer dynamics changed since capture")
        return False
    from ..amp import policy as _amp_policy
    if (stt.amp is not None) != _amp_policy.enabled():
        _break(ctx, "amp policy toggled since capture")
        return False
    scaler = None
    if stt.amp is not None:
        scaler = _trainer_scaler(trainer)
        if stt.amp != (_amp_policy.compute_dtype_str(),
                       float(scaler._scale_factor),
                       int(scaler._scale_window)):
            _break(ctx, "amp scaler config changed since capture")
            return False
    if stt.zero_ndev != _zero_ndev(trainer):
        # the eager fused step (or its gather of the states) takes the
        # new layout
        _break(ctx, "zero sharding toggled since capture")
        return False
    if any(v is None for v in ctx.ext_vals):
        _break(ctx, "unresolved external input")
        return False
    params = trainer._params
    for k, i in enumerate(stt.diff_idx):
        if params[i]._data is not ctx.param_arrays[k]:
            _break(ctx, "weights changed between forward and step")
            return False
    for gnd, ph, _orig in ctx.grad_marks:
        if gnd._data is not ph:
            _break(ctx, "gradient buffer changed between backward and step")
            return False
    # the states, made as the eager Updater makes them
    for i in stt.diff_idx:
        updater._ensure_state(i, params[i]._data_nd())
    if stt.zero_ndev > 1:
        # as fused_step's sharded path: weight-shaped slots only, kept
        # as this rank's flat chunks
        meta = fused_step._zero_meta(updater)
        for i in stt.diff_idx:
            if i not in meta and any(
                    tuple(_tensor(s).shape) != tuple(params[i]._data.shape)
                    for s in updater.states[i]):
                _break(ctx, "optimizer state not weight-shaped "
                            "(sharded update)")
                return False
        fused_step.shard_states(updater, stt.diff_idx,
                                fused_step._zero_axis())
    elif getattr(updater, "_zero_states", None):
        fused_step.unshard_states(updater)
    tensors = [params[i]._data for i in stt.diff_idx] + \
        [_tensor(s) for i in stt.diff_idx for s in updater.states[i]] + \
        [params[i]._data for i in stt.frozen_idx]
    ent = state.current if state.current is not None and \
        state.current.structure is stt else state.cache.get(stt.key)
    if ent is None:
        _break(ctx, "capture entry evicted")
        return False
    ptrs = tuple(t.data_ptr() for t in tensors)
    if ent.ptrs != ptrs:
        # new tensors (the first step, or a weight or state replaced):
        # the graphs captured on the old ones go
        n_own = len(tensors) - len(stt.frozen_idx)
        if len({id(t) for t in tensors[:n_own]}) != n_own:
            _break(ctx, "shared donated buffer")
            return False
        ent.execs.clear()
        ent.ptrs = ptrs
        ent.dtypes = [(params[i]._data.dtype,
                       tuple(_tensor(s).dtype for s in updater.states[i]))
                      for i in stt.diff_idx]
    try:
        state.owner.check_ids()
    except Exception:
        _break(ctx, "embedding ids out of range")
        raise

    # the counts move first, so lr schedules and Adam's t match the eager
    # path (as in fused_step.step)
    saved = (dict(opt._index_update_count), opt.num_update)
    for i in stt.diff_idx:
        opt._update_count(i)
    dyns = [opt._fused_dynamics(i) for i in stt.diff_idx]
    groups = _groups(stt, ent.dtypes, dyns)
    pattern = tuple((k[0], tuple(m)) for k, m in groups)
    dyn_args = [onp.asarray([k[1][j] for k, _ in groups], onp.float32)
                for j in range(len(stt.dyn_names))]
    device = params[stt.diff_idx[0]]._data.device
    cuda = device.type == "cuda"
    if scaler is not None:
        _amp_enter(state, scaler, device)
    args = list(ctx.ext_vals) + dyn_args
    entry = ent.execs.get(pattern)
    fresh = entry is None
    if fresh:
        from ..executable import Executable
        from ..ops.tensor import IdCheck
        ids = IdCheck()
        fn = _build_step_fn(stt, trainer, state, [m for _, m in groups], ids,
                            len(ctx.ext_vals))
        t0 = time.perf_counter()
        try:
            with tracing.span("compile.cached_step", opt=stt.opt_type):
                exe = Executable(fn, args, device,
                                 *state.owner.capture_with(device),
                                 warm="first_call")
                out = exe(*args)
        except Exception as e:
            state.bad.add(stt.key)
            state.current = None
            state.last_error = f"{type(e).__name__}: {e}"
            _C["fallbacks"].inc()
            warm = getattr(e, "warm_outputs", None)
            if warm is None:
                # nothing was applied: the step runs eagerly
                opt._index_update_count, opt.num_update = saved
                _break(ctx, "capture failed to trace/compile")
                return False
            # the warm run applied the step; only the capture failed
            state.last_reason = "capture failed to trace/compile"
            out = warm
        else:
            ent.execs[pattern] = (exe, ids)
            telemetry.record_compile(time.perf_counter() - t0, "cached_step")
            _C["compiles"].inc()
    else:
        exe, ids = entry
        _C["hits"].inc()
        with tracing.span("step.cached_replay", opt=stt.opt_type):
            out = exe(*args)
    _note_dispatch()
    flat, grads, inv, bounds = out
    if scaler is not None:
        scaler.adopt_traced(*state.amp)
    # the static outputs are overwritten by the next replay: copy what
    # outlives the step.  The gradients leave unscaled (times 1/scale
    # under AMP, else times 1.0, exact), in one multi-tensor launch.
    grads = torch._foreach_mul(grads, 1.0 if inv is None else inv)
    own = (lambda t: t.clone()) if cuda else (lambda t: t)
    k = 0
    for rec in ctx.recs:
        for ph_ref, nd_ref in zip(rec.phs, rec.nds):
            ph = ph_ref()
            if ph is not None:
                ph.value = own(flat[k])
                nd = nd_ref()
                if nd is not None and nd._data is ph:
                    nd._data = ph.value
            k += 1
    for (gnd, ph, _orig), g in zip(ctx.grad_marks, grads):
        ph.value = gnd._data = g
    st = _t()
    _close_ctx(st, ctx)
    _set_obs(st, None)
    if fresh and getattr(exe, "graph", None) is None and cuda:
        state.current = None         # the capture failed: observe again
    else:
        state.current = ent
    _C["steps"].inc()
    state.owner.defer_ids(bounds, ids.vocabs, device)
    _retire(ctx)
    return True
