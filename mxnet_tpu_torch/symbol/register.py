"""``mx.sym.<op>`` generated from the op registry (counterpart of
``mxnet_tpu/symbol/register.py``): the same registry as ``mx.nd``; the
generated function builds a graph node instead of running the op.

A call with fewer Symbol inputs than the op's array arguments creates a
variable ``<node name>_<argument>`` for each one left out that has no
default (``fc`` → ``fc_weight``, ``fc_bias``); an optional ``bias``
(default None) is created unless ``no_bias``.  A keyed op (``Dropout``)
gets a PRNG-key variable ``<node name>_key`` as its last input.
"""
from __future__ import annotations

import inspect
from typing import Any, Dict

from ..ops import registry as _reg
from .symbol import KEYED_OPS, Symbol, Variable, _apply

__all__ = ["make_sym_func", "populate_namespace"]


def make_sym_func(name: str):
    op = _reg.get(name)
    try:
        sig = inspect.signature(op.fn)
        params = list(sig.parameters.values())
    except (TypeError, ValueError):
        params = []
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                  and p.name not in ("args", "kwargs")]
    keyword = [p for p in params if p.kind == p.KEYWORD_ONLY]
    keyed = op.name in KEYED_OPS

    def sym_func(*args, name=None, **kwargs):
        inputs = [a for a in args if isinstance(a, Symbol)]
        extras = [a for a in args
                  if not isinstance(a, Symbol) and a is not None]
        if extras:
            free = [p.name for p in keyword if p.name not in kwargs]
            for pname, val in zip(free, extras):
                kwargs[pname] = val
        for k, v in list(kwargs.items()):
            if isinstance(v, list):
                kwargs[k] = tuple(v)
        wanted = len(positional) + (1 if keyed else 0)
        named = False
        if inputs and len(inputs) < wanted:
            # the node's name, through the name manager once (the
            # reference's composer passes it through twice, so that
            # Prefix("p_") names the node p_p_<op>N)
            from .. import name as _name_mod
            node_name = _name_mod.current().get(
                name, op.name.lower().lstrip("_"))
            name, named = node_name, True
            defaults = {p.name: p.default for p in keyword}
            no_bias = kwargs.get("no_bias", defaults.get("no_bias", False))
            for p in positional[len(inputs):]:
                if p.default is inspect.Parameter.empty:
                    inputs.append(Variable(f"{node_name}_{p.name}"))
                elif p.default is None and p.name == "bias" and not no_bias:
                    inputs.append(Variable(f"{node_name}_{p.name}"))
            if keyed:
                inputs.append(Variable(f"{node_name}_key",
                                       attrs={"__prng_key__": "1"}))
        return _apply(op.name, inputs, name=name, _named=named, **kwargs)

    sym_func.__name__ = name
    sym_func.__doc__ = op.doc or f"Symbolic op {name}."
    return sym_func


def populate_namespace(ns: Dict[str, Any], names=None) -> None:
    for name in (names or _reg.list_ops()):
        if name.startswith("_random") or name.startswith("_sample"):
            continue
        if name not in ns:
            ns[name] = make_sym_func(name)
