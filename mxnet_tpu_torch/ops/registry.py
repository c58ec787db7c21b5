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
eagerly, so the reference's jit cache, signature budget, capture and
deferred-compute scopes have no counterpart here.

An op registered under a name on the AMP lists (``amp/lists.py``) reads
the AMP policy at each call and casts its inputs by its category
(``amp.policy.apply``); the function ``register`` returns is that one,
so callers of the module-level function (the Gluon layers) get the same
casts as ``mx.nd``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import torch

from .. import telemetry
from ..amp import policy as _amp_policy
from ..base import MXNetError

_DISPATCH_CT = telemetry.counter("dispatch.count")

__all__ = ["Operator", "register", "alias", "get", "list_ops", "invoke",
           "dispatch", "apply_torch"]

_REGISTRY: Dict[str, "Operator"] = {}


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


def apply_torch(fn: Callable, nd_inputs: Sequence[Any]):
    """Run ``fn`` on the NDArrays' tensors and wrap its output (a list
    for a tuple or list of tensors): the one funnel every op call goes
    through."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray

    with torch.set_grad_enabled(autograd.is_recording()):
        out = fn(*[x._data for x in nd_inputs])
    _DISPATCH_CT.inc()
    if isinstance(out, (tuple, list)):
        return [NDArray._wrap(o) for o in out]
    return NDArray._wrap(out)


def dispatch(op: Operator, nd_inputs: Sequence[Any], params: dict):
    """Bind ``params`` and run ``op`` through :func:`apply_torch`."""
    fn = op.fn
    if params:
        def fn(*tensors, _fn=op.fn):
            return _fn(*tensors, **params)
    return apply_torch(fn, nd_inputs)


def invoke(name: str, nd_inputs: Sequence[Any], **params):
    """Invoke a registered op by name on NDArray inputs; ``None`` entries
    (optional inputs left out) are dropped."""
    return dispatch(get(name), [x for x in nd_inputs if x is not None],
                    params)
