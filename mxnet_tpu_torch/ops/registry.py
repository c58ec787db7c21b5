"""Single operator registry (counterpart of ``mxnet_tpu/ops/registry.py``).

An op is a *name* plus a plain function ``fn(*tensors, **params)`` on
``torch.Tensor`` s: positional arguments are arrays, keyword-only ones
are static attributes.  ``mx.nd`` is generated from this registry
(``ndarray/register.py``), so only ops the port has appear there.

Every op call goes through one funnel, :func:`apply_torch` (the
reference's ``apply_jax``): it unwraps the NDArrays, runs the function
and wraps what comes out.  It ticks ``dispatch.count``, and runs the op
under ``torch.no_grad()`` unless ``autograd.record()`` is on, so only
recorded ops build a graph, as on the reference's tape.  PyTorch runs
eagerly, so the reference's eager jit cache and its capture and
deferred-compute scopes have no counterpart here.

The whole-step capture (``imperative/cached_step.py``) sits at the
funnel behind one module int (``_GATE``), as in the reference: while a
thread observes an eager step, each recorded call is added to the
step's tape; while it defers a captured step, a call that matches the
tape returns placeholders instead of running.  A call is keyed by
``key``: ``(op name, static params)`` for a registered op
(:func:`dispatch`), so that the closure ``dispatch`` builds anew at each
call still reads as the same op step after step; a call without a key
cannot be captured.  The signature budget (``MXNET_JIT_MAX_SIGS``,
:class:`SigBudget`) and the numerics key (:func:`_env_numerics_key`) are
shared by the cached step and ``HybridBlock.hybridize``.

An op registered under a name on the AMP lists (``amp/lists.py``) reads
the AMP policy at each call and casts its inputs by its category
(``amp.policy.apply``); the function ``register`` returns is that one,
so callers of the module-level function (the Gluon layers) get the same
casts as ``mx.nd``.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .. import telemetry
from ..amp import policy as _amp_policy
from ..base import MXNetError
from ..imperative import cached_step as _cached_step

_DISPATCH_CT = telemetry.counter("dispatch.count")

__all__ = ["Operator", "register", "alias", "get", "list_ops", "invoke",
           "dispatch", "apply_torch", "np_flavor", "SigBudget"]

_REGISTRY: Dict[str, "Operator"] = {}

# ``mx.np.ndarray`` once ``mx.np`` is imported: an op with an input of
# the numpy flavor gives outputs of that flavor, as in the reference
_NP_CLS = [None]


class Operator:
    """One registered op: name + plain ``fn(*tensors, **params)``."""

    __slots__ = ("name", "fn", "aliases", "doc")

    def __init__(self, name: str, fn: Callable, aliases: Sequence[str] = ()):
        self.name = name
        self.fn = fn
        self.aliases = tuple(aliases)
        self.doc = fn.__doc__

    def __repr__(self):
        return f"<Operator {self.name}>"


def register(name: str, aliases: Sequence[str] = ()):
    """Decorator registering ``fn(*tensors, **params)`` as an op; it
    returns ``fn`` under the AMP policy of ``name``'s category (``fn``
    itself for an unlisted name)."""

    def deco(fn: Callable):
        fn = _amp_policy.apply(name, fn)
        op = Operator(name, fn, aliases=aliases)
        for n in (name, *aliases):
            if n in _REGISTRY:
                raise MXNetError(f"op {n!r} already registered (by "
                                 f"{_REGISTRY[n].name!r})")
        _REGISTRY[name] = op
        for a in aliases:
            _REGISTRY[a] = op
        return fn

    return deco


def alias(existing: str, new: str) -> None:
    if new in _REGISTRY and _REGISTRY[new] is not _REGISTRY[existing]:
        raise MXNetError(f"op alias {new!r} already registered (by "
                         f"{_REGISTRY[new].name!r})")
    _REGISTRY[new] = _REGISTRY[existing]


def get(name: str) -> Operator:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise MXNetError(f"unknown operator {name!r}") from None


def list_ops() -> List[str]:
    return sorted(_REGISTRY)


def apply_torch(fn: Callable, nd_inputs: Sequence[Any], key=None):
    """Run ``fn`` on the NDArrays' tensors and wrap its output (a list
    for a tuple or list of tensors): the one funnel every op call goes
    through.  ``key`` names the call for the whole-step capture (None:
    not capturable)."""
    if _cached_step._GATE:
        out = _cached_step.funnel(fn, key, nd_inputs, _run)
    else:
        out = _run(fn, nd_inputs)
    cls = _NP_CLS[0]
    if cls is not None:
        for x in nd_inputs:
            if type(x) is cls:
                return np_flavor(out, cls)
    return out


def np_flavor(out, cls=None):
    """``out`` (an NDArray, or a list or tuple of them) with each plain
    NDArray turned into an ``mx.np.ndarray`` in place (the two share one
    layout)."""
    cls = cls or _NP_CLS[0]
    if isinstance(out, (list, tuple)):
        for o in out:
            np_flavor(o, cls)
    elif cls is not None and type(out) is cls.__base__:
        out.__class__ = cls
    return out


def _run(fn: Callable, nd_inputs: Sequence[Any]):
    from .. import autograd
    from ..ndarray.ndarray import NDArray

    with torch.set_grad_enabled(autograd.is_recording()):
        out = fn(*[x._data for x in nd_inputs])
    _DISPATCH_CT.inc()
    if isinstance(out, (tuple, list)):
        return [NDArray._wrap(o) for o in out]
    return NDArray._wrap(out)


def _params_key(params: dict):
    """A hashable key for static params, or None if one is unhashable."""
    try:
        return tuple(sorted((k, _hashable(v)) for k, v in params.items()))
    except TypeError:
        return None


def _hashable(v):
    """``v`` with its lists and dicts as tuples; raises TypeError when a
    part cannot be hashed.  (A module function: a closure calling
    itself would make a reference cycle at every op call.)"""
    if isinstance(v, list):
        v = tuple(_hashable(x) for x in v)
    elif isinstance(v, dict):
        v = tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    hash(v)
    return v


def dispatch(op: Operator, nd_inputs: Sequence[Any], params: dict):
    """Bind ``params`` and run ``op`` through :func:`apply_torch`, keyed
    by ``(op name, params)``."""
    fn = op.fn
    if params:
        def fn(*tensors, _fn=op.fn):
            return _fn(*tensors, **params)
        pkey = _params_key(params)
        key = None if pkey is None else (op.name, pkey)
    else:
        key = (op.name, ())
    return apply_torch(fn, nd_inputs, key)


def invoke(name: str, nd_inputs: Sequence[Any], **params):
    """Invoke a registered op by name on NDArray inputs; ``None`` entries
    (optional inputs left out) are dropped."""
    return dispatch(get(name), [x for x in nd_inputs if x is not None],
                    params)


# --------------------------------------------------------------------------
# the signature budget and the numerics key (``mxnet_tpu/ops/registry.py:
# 245-255, 378-405, 440-450``)
# --------------------------------------------------------------------------

def _read_max_jit_sigs(default: int = 8) -> int:
    """``MXNET_JIT_MAX_SIGS``: how many shape signatures a captured cache
    (a trainer's cached steps, a hybridized block's forwards) may hold
    before it latches."""
    try:
        return max(1, int(os.environ.get("MXNET_JIT_MAX_SIGS", default)))
    except ValueError:
        raise MXNetError("MXNET_JIT_MAX_SIGS must be an integer") from None


_MAX_JIT_SIGS = _read_max_jit_sigs()


class SigBudget:
    """The shared ``MXNET_JIT_MAX_SIGS`` budget (read once, at import)
    of a signature-keyed cache of captured executables: a hybridized
    block's forwards, a trainer's cached steps and the serving engine's
    shape buckets.

    ``admit(n_compiled)`` says whether a new signature may be captured
    when ``n_compiled`` already are.  Over budget the cache latches: a
    new signature runs eagerly, while every captured one keeps
    replaying (nothing is evicted); ``declines`` counts the refusals."""

    __slots__ = ("limit", "latched", "declines")

    def __init__(self, limit: Optional[int] = None):
        self.limit = int(limit) if limit is not None else _MAX_JIT_SIGS
        self.latched = False
        self.declines = 0

    def admit(self, n_compiled: int) -> bool:
        self.latched = n_compiled >= self.limit
        if self.latched:
            self.declines += 1
        return not self.latched


def _env_numerics_key():
    """The switches ops read as they run, for the key of every captured
    executable: a graph captured under other numerics (the AMP policy on
    or off, its dtype, ``MXNET_SAFE_ACCUMULATION``, the 64-bit switches
    of ``util`` that ``mx.np`` results follow) is never replayed."""
    from ..util import x64_enabled
    from .nn import safe_accumulation_enabled
    return (safe_accumulation_enabled(), _amp_policy.cache_token(),
            x64_enabled())
