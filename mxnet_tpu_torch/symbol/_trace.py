"""The recorder behind ``symbol.trace`` (the reference records every
registry dispatch under its ``DCScope``, ``mxnet_tpu/ops/registry.py:
546-560``; every NDArray op there is a registry op).

The port's layers call plain functions on tensors, and a residual add
is a bare ``torch.add``, so the recorder looks at two levels, and only
while it is entered:

- the registered ops: each module-level function of ``ops.*`` that is
  a registered op's function (``nn_ops.convolution``,
  ``tensor_ops.dot``, ``attn_ops.multi_head_attention``, ...) is
  replaced, for the trace, by a wrapper that records one node under the
  op's name with the call's keyword parameters (the helpers in
  ``_HELPERS`` by the op they stand for); the torch calls inside it are
  not recorded;
- the tensor operations of a forward outside any registered op: a
  ``TorchFunctionMode`` records each torch call that ``_TORCH`` maps to
  one of the reference's ops (``x + h`` → ``elemwise_add``, ``x * 0.5``
  → ``_mul_scalar``, ``t[..., a:b]`` → ``slice_axis``, ``reshape``,
  ``relu``, ...).  A call it cannot map yields a marker: the trace
  raises only if the marker reaches an output.

A tensor is known by identity: the parameters and inputs are tagged
before the forward, each recorded op's outputs after it.  An input of an
op that is none of these (a tensor made outside the forward) becomes a
captured argument ``__dc_const_<n>``, as in the reference.  A registered
op that returns its first input as it is (Dropout in inference mode)
adds no node.  Node names are the op's lower-case name and the running
count, as the reference's (``convolution1``, ``batchnorm2``).
"""
from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.overrides import TorchFunctionMode

from ..base import MXNetError
from ..ops import registry as _reg

__all__ = ["Recorder"]


def _op_modules():
    from ..ops import (attention, layernorm_residual, legacy, nn, random,
                       tensor)
    return (nn, tensor, attention, layernorm_residual, legacy, random)


def _embedding_params(args, kwargs):
    w = args[1]
    return {"input_dim": int(w.shape[0]), "output_dim": int(w.shape[1]),
            "sparse_grad": False}


# module-level helpers that stand for a registered op:
# (module name, attribute) → (op name, params from the call's arguments)
_HELPERS = {("tensor", "embedding"): ("Embedding", _embedding_params)}

# the parameters a registered op's node always carries, from its
# arrays, where the layers leave them to the op (the reference's
# layers pass them)
_COMPLETE = {
    "FullyConnected": lambda args, kw: {
        "num_hidden": int(args[1].shape[0]),
        "no_bias": len(args) < 3 or args[2] is None},
    "Convolution": lambda args, kw: {
        "no_bias": len(args) < 3 or args[2] is None},
}


class _Unmapped:
    """The stand-in ref of a tensor made by a torch call the table does
    not map."""

    def __init__(self, what):
        self.what = what


def _is_t(x):
    return isinstance(x, torch.Tensor)


def _binary(tensor_op, scalar_op, rscalar_op=None):
    def rule(args, kwargs, reverse=False):
        a, b = args[0], args[1]
        if _is_t(a) and _is_t(b):
            return (tensor_op, [b, a] if reverse else [a, b], {})
        if _is_t(a) and isinstance(b, (int, float, bool)):
            name = rscalar_op if reverse and rscalar_op else scalar_op
            return (name, [a], {"scalar": float(b)})
        return None
    return rule


def _reflected(rule):
    return lambda args, kwargs: rule(args, kwargs, reverse=True)


def _same(name):
    return lambda args, kwargs: (name, [args[0]], {})


def _shape_arg(args, kwargs):
    shape = args[1:] if len(args) > 1 else kwargs.get("shape", ())
    if len(shape) == 1 and isinstance(shape[0], (tuple, list,
                                                 torch.Size)):
        shape = shape[0]
    return tuple(int(s) for s in shape)


def _reshape(args, kwargs):
    return ("reshape", [args[0]], {"shape": _shape_arg(args, kwargs)})


def _getitem(args, kwargs):
    """``t[..., a:b]`` / ``t[a:b]``: one axis sliced with unit step →
    ``slice_axis`` (a negative axis after an Ellipsis, as the reference's
    ``slice_axis(axis=-1)``)."""
    t, key = args
    key = key if isinstance(key, tuple) else (key,)
    if any(k is Ellipsis for k in key[1:]):
        return None
    lead = key and key[0] is Ellipsis
    parts = key[1:] if lead else key
    sliced = [(i, k) for i, k in enumerate(parts)
              if not (isinstance(k, slice) and k == slice(None))]
    if len(sliced) != 1 or not isinstance(sliced[0][1], slice):
        return None
    i, k = sliced[0]
    if k.step not in (None, 1):
        return None
    axis = i - len(parts) if lead else i
    n = t.shape[axis]
    begin = 0 if k.start is None else int(k.start)
    end = n if k.stop is None else min(int(k.stop), n)
    return ("slice_axis", [t], {"axis": axis, "begin": begin, "end": end})


def _permute(args, kwargs):
    dims = args[1:] if len(args) > 1 else kwargs.get("dims", ())
    if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
        dims = dims[0]
    return ("transpose", [args[0]], {"axes": tuple(int(d) for d in dims)})


def _flatten(args, kwargs):
    start = args[1] if len(args) > 1 else kwargs.get("start_dim", 0)
    end = args[2] if len(args) > 2 else kwargs.get("end_dim", -1)
    if start == 1 and end in (-1, args[0].dim() - 1):
        return ("Flatten", [args[0]], {})
    return None


def _cat(args, kwargs):
    tensors = list(args[0])
    dim = args[1] if len(args) > 1 else kwargs.get("dim", 0)
    return ("concat", tensors, {"dim": int(dim)})


def _reduction(name):
    def rule(args, kwargs):
        dim = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = kwargs.get("keepdim", args[2] if len(args) > 2 else False)
        params = {"keepdims": bool(keep)}
        if dim is not None:
            params["axis"] = tuple(dim) if isinstance(dim, (tuple, list)) \
                else int(dim)
        return (name, [args[0]], params)
    return rule


_T = torch.Tensor
_add = _binary("elemwise_add", "_plus_scalar")
_sub = _binary("elemwise_sub", "_minus_scalar", "_rminus_scalar")
_mul = _binary("elemwise_mul", "_mul_scalar")
_div = _binary("elemwise_div", "_div_scalar", "_rdiv_scalar")
_pow = _binary("broadcast_power", "_power_scalar", "_rpower_scalar")

# torch call → rule(args, kwargs) -> (op name, input tensors, params)
_TORCH: Dict[Any, Callable] = {
    torch.add: _add, _T.add: _add, _T.__add__: _add,
    _T.__radd__: _reflected(_add), operator.add: _add,
    torch.sub: _sub, _T.sub: _sub, _T.__sub__: _sub,
    _T.__rsub__: _reflected(_sub),
    torch.mul: _mul, _T.mul: _mul, _T.__mul__: _mul,
    _T.__rmul__: _reflected(_mul),
    torch.div: _div, _T.div: _div, _T.__truediv__: _div,
    _T.__rtruediv__: _reflected(_div),
    _T.__pow__: _pow, torch.pow: _pow, _T.__rpow__: _reflected(_pow),
    torch.neg: _same("negative"), _T.neg: _same("negative"),
    _T.__neg__: _same("negative"),
    torch.relu: _same("relu"), _T.relu: _same("relu"),
    torch.nn.functional.relu: _same("relu"),
    torch.sigmoid: _same("sigmoid"), _T.sigmoid: _same("sigmoid"),
    torch.tanh: _same("tanh"), _T.tanh: _same("tanh"),
    torch.exp: _same("exp"), _T.exp: _same("exp"),
    torch.log: _same("log"), _T.log: _same("log"),
    torch.sqrt: _same("sqrt"), _T.sqrt: _same("sqrt"),
    torch.square: _same("square"), _T.square: _same("square"),
    torch.abs: _same("abs"), _T.abs: _same("abs"),
    _T.reshape: _reshape, _T.view: _reshape, torch.reshape: _reshape,
    _T.__getitem__: _getitem,
    _T.permute: _permute, torch.permute: _permute,
    _T.flatten: _flatten, torch.flatten: _flatten,
    torch.cat: _cat, torch.concat: _cat,
    _T.sum: _reduction("sum"), torch.sum: _reduction("sum"),
    _T.mean: _reduction("mean"), torch.mean: _reduction("mean"),
}

# calls whose output stands for their first input (no node)
_PASS = {_T.contiguous, _T.clone, _T.detach, torch.clone}


class Recorder(TorchFunctionMode):
    """Entered for one traced forward (see the module's text)."""

    def __init__(self, node_cls):
        super().__init__()
        self._Node = node_cls
        self.refs: Dict[int, Tuple[Any, int]] = {}
        self._alive: List[torch.Tensor] = []
        self.captured: Dict[str, torch.Tensor] = {}
        self.n = 0
        self.depth = 0
        self._patched: List[Tuple[Any, str, Any]] = []

    # -- tensors and refs --------------------------------------------------
    def tag(self, t: torch.Tensor, name: str):
        self._set(t, (self._Node(None, name), 0))

    def _set(self, t, ref):
        self.refs[id(t)] = ref
        self._alive.append(t)

    def _ref(self, t) -> Tuple[Any, int]:
        ref = self.refs.get(id(t))
        if ref is None:
            self.n += 1
            name = f"__dc_const_{self.n}"
            ref = (self._Node(None, name), 0)
            self.captured[name] = t
            self._set(t, ref)
        return ref

    def output_ref(self, t):
        ref = self.refs.get(id(t)) if _is_t(t) else None
        if ref is None:
            raise MXNetError("symbol.trace: a block output was not made "
                             "by recorded ops; nothing was recorded for it")
        self._check(ref[0], set())
        return ref

    def _check(self, node, seen):
        if id(node) in seen:
            return
        seen.add(id(node))
        if isinstance(node, _Unmapped):
            raise MXNetError(f"symbol.trace: the forward calls {node.what}, "
                             f"which has no counterpart among the "
                             f"reference's ops")
        for src, _ in node.inputs:
            self._check(src, seen)

    def record(self, op_name, inputs, params, out):
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if not outs or not all(_is_t(o) for o in outs):
            return
        if len(outs) == 1 and inputs and outs[0] is inputs[0]:
            return                                  # the identity
        in_refs = [self._ref(x) for x in inputs]
        self.n += 1
        base = op_name.split(":")[-1].lower().lstrip("_") or "op"
        node = self._Node(op_name, f"{base}{self.n}", dict(params), in_refs,
                          num_outputs=len(outs))
        for i, o in enumerate(outs):
            self._set(o, (node, i))

    # -- the registered ops --------------------------------------------------
    def _wrap_op(self, fn, op_name, complete=None):
        rec = self

        def recorded(*args, **kwargs):
            if rec.depth:
                return fn(*args, **kwargs)
            rec.depth += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                rec.depth -= 1
            tensors = [a for a in args if a is not None]
            if any(not _is_t(a) for a in tensors):
                return out
            params = dict(kwargs)
            if complete is not None:
                params = {**complete(args, kwargs), **params}
            rec.record(op_name, tensors, params, out)
            return out
        return recorded

    def __enter__(self):
        fn_to_op = {op.fn: op for op in _reg._REGISTRY.values()}
        for mod in _op_modules():
            short = mod.__name__.rsplit(".", 1)[1]
            for attr, value in list(vars(mod).items()):
                helper = _HELPERS.get((short, attr))
                if helper is not None:
                    name, params = helper
                    wrapped = self._wrap_op(value, name, params)
                elif callable(value) and value in fn_to_op:
                    name = fn_to_op[value].name
                    wrapped = self._wrap_op(value, name,
                                            _COMPLETE.get(name))
                else:
                    continue
                self._patched.append((mod, attr, value))
                setattr(mod, attr, wrapped)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for mod, attr, value in reversed(self._patched):
                setattr(mod, attr, value)
            self._patched.clear()

    # -- the bare tensor operations ------------------------------------------
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.depth or not _is_t(out) and not (
                isinstance(out, (tuple, list)) and out
                and all(_is_t(o) for o in out)):
            return out
        if func in _PASS and _is_t(args[0]):
            self._set(out, self._ref(args[0]))
            return out
        if func in (_T.to, _T.float, _T.type_as) and _is_t(args[0]):
            if out.dtype == args[0].dtype:
                self._set(out, self._ref(args[0]))
            else:
                self.record("Cast", [args[0]],
                            {"dtype": str(out.dtype).replace("torch.", "")},
                            out)
            return out
        rule = _TORCH.get(func)
        made = rule(args, kwargs) if rule is not None else None
        if made is None:
            what = getattr(func, "__qualname__", None) or repr(func)
            node = _Unmapped(f"torch {what}")
            node.inputs = []
            outs = out if isinstance(out, (tuple, list)) else [out]
            for i, o in enumerate(outs):
                self._set(o, (node, i))
            return out
        op_name, inputs, params = made
        self.record(op_name, inputs, params, out)
        return out
