"""Generate the ``mx.nd`` op functions from the registry (counterpart of
``mxnet_tpu/ndarray/register.py``): each wrapper splits positional
NDArray inputs from static params by the op function's signature."""
from __future__ import annotations

import inspect
from typing import Any, Dict

from ..ops import registry as _reg

__all__ = ["make_op_func", "populate_namespace"]


def _analyze(fn):
    """(number of array params, keyword-only param names)."""
    n_arr, kw_params = 0, []
    for p in inspect.signature(fn).parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n_arr += 1
        elif p.kind == p.KEYWORD_ONLY:
            kw_params.append(p.name)
    return n_arr, kw_params


def make_op_func(name: str):
    """The user-facing function of a registered op: NDArrays given
    positionally are the inputs, other positional values fill the
    keyword-only params in order, list params become tuples, and
    ``out=`` rebinds the given array(s) to the result."""
    op = _reg.get(name)
    n_arr, kw_params = _analyze(op.fn)

    def op_func(*args, out=None, name=None, **kwargs):
        from .ndarray import NDArray

        inputs, extra = [], []
        for i, a in enumerate(args):
            if isinstance(a, NDArray):
                inputs.append(a)
            elif a is None and i < n_arr:
                continue                # optional array input left out
            else:
                extra.append(a)
        for pname, val in zip([k for k in kw_params if k not in kwargs],
                              extra):
            kwargs[pname] = val
        for k, v in list(kwargs.items()):
            if isinstance(v, list):
                kwargs[k] = tuple(v)
        result = _reg.dispatch(op, inputs, kwargs)
        if out is not None:
            outs = result if isinstance(result, list) else [result]
            targets = out if isinstance(out, (list, tuple)) else [out]
            for t, r in zip(targets, outs):
                t._adopt(r)
            return out
        return result

    op_func.__name__ = name
    op_func.__doc__ = op.doc or f"Registered op {name}."
    return op_func


def populate_namespace(ns: Dict[str, Any], names=None) -> None:
    """Install the op functions into a module namespace dict."""
    for name in (names or _reg.list_ops()):
        if name not in ns:
            ns[name] = make_op_func(name)
