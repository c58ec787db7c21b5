"""Symbol: the declarative graph API (counterpart of
``mxnet_tpu/symbol/symbol.py``).

A Symbol is a small DAG of registry-op nodes over named variables, with
the reference's surface: composition and arithmetic, ``get_internals``,
``__getitem__``, ``list_arguments`` / ``list_outputs`` /
``list_auxiliary_states``, ``infer_shape`` (with partial shapes),
``infer_type``, ``eval``, ``bind`` / ``simple_bind`` (an
:class:`~mxnet_tpu_torch.symbol.executor.Executor`), json in the
reference's layout (``nodes`` / ``arg_nodes`` / ``heads``; the legacy
MXNet 1.x json with stringified attributes too) and :func:`trace`, which
records one Gluon forward as a Symbol.

Two places differ from the reference, which lowers the graph to JAX:

- shape and type inference run the graph's ops on ``torch.device("meta")``
  tensors (the reference's ``jax.eval_shape``): shapes and dtypes, no
  data, no device;
- :func:`trace` records a forward with a recorder active only inside it
  (``symbol/_trace.py``): the registered ops the layers call, and the
  bare tensor operations of a forward (a residual ``x + h``, a slice, a
  reshape) by a table from torch calls to the reference's op names.
  Outside a trace nothing of it runs.

A stochastic op (``Dropout``) takes a PRNG key input, as in the
reference: a variable ``<name>_key`` marked ``__prng_key__`` that bind
and ``eval`` supply and refresh at every forward unless the caller pins
it.  The key (two int64 words) seeds the draws of that op's call.
"""
from __future__ import annotations

import ast
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as onp
import torch

from .. import autograd as ag
from ..base import MXNetError, np_dtype, torch_dtype
from ..ops import registry as _reg

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "trace"]

# ops that take a PRNG key as their last input (the reference's
# Dropout signature ``fn(x, key, *, p, mode, axes)``)
KEYED_OPS = frozenset({"Dropout", "dropout"})


def _auto_name(op_name: str) -> str:
    from .. import name as _name_mod
    return _name_mod.current().get(None, op_name.lower().lstrip("_"))


class _Node:
    """One graph node: a free variable or an op application."""

    __slots__ = ("op_name", "name", "params", "inputs", "num_outputs",
                 "attrs")

    def __init__(self, op_name: Optional[str], name: str,
                 params: Optional[dict] = None,
                 inputs: Optional[List[Tuple["_Node", int]]] = None,
                 num_outputs: int = 1, attrs: Optional[dict] = None):
        self.op_name = op_name          # None: a variable ("null" op)
        self.name = name
        self.params = dict(params or {})
        from .. import attribute as _attr
        self.attrs = _attr.current().get(attrs)
        self.inputs = list(inputs or [])
        self.num_outputs = num_outputs

    @property
    def is_var(self) -> bool:
        return self.op_name is None


def new_key(device="cpu") -> torch.Tensor:
    """A fresh PRNG key from ``mx.random``'s host generator: two int64
    words."""
    from ..ops import random as _rng
    return torch.randint(0, 2 ** 31 - 1, (2,), dtype=torch.int64,
                         generator=_rng.generator("cpu")).to(device)


class _KeyedDraws:
    """``mx.random``'s trace hook while a keyed op runs: its draws come
    from a generator seeded by the key."""

    def __init__(self, key: torch.Tensor):
        self.key = key

    def __call__(self, make, device):
        words = [int(w) for w in self.key.detach().reshape(-1)[:2].cpu()]
        g = torch.Generator(device=torch.device(device))
        g.manual_seed(((words[0] & 0x7FFFFFFF) << 32)
                      ^ (words[1] & 0xFFFFFFFF))
        return make(g)


def _run_keyed(fn, ins, params):
    from ..ops import random as _rng
    old = _rng.set_trace_hook(_KeyedDraws(ins[-1]))
    try:
        return fn(*ins[:-1], **params)
    finally:
        _rng.set_trace_hook(old)


class Symbol:
    """A (possibly multi-output) reference into the graph."""

    def __init__(self, outputs: Sequence[Tuple[_Node, int]]):
        self._outputs: List[Tuple[_Node, int]] = list(outputs)

    @property
    def name(self) -> str:
        return self._outputs[0][0].name

    def __repr__(self):
        return f"<Symbol {self.name}>"

    def __iter__(self):
        return (Symbol([o]) for o in self._outputs)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            for node in _topo_nodes([o[0] for o in self._outputs]):
                if node.name == idx:
                    return Symbol([(node, 0)])
            raise MXNetError(f"no internal symbol named {idx!r}")
        if isinstance(idx, slice):
            return Group([Symbol([o]) for o in self._outputs[idx]])
        if idx < len(self._outputs):
            return Symbol([self._outputs[idx]])
        node, _ = self._outputs[0]
        if not node.is_var:
            return Symbol([(node, idx)])
        raise IndexError(idx)

    def __len__(self):
        return len(self._outputs)

    @property
    def num_outputs(self) -> int:
        return len(self._outputs)

    # -- introspection -------------------------------------------------------
    def list_arguments(self) -> List[str]:
        aux = set(self.list_auxiliary_states())
        return [n.name for n in self._var_nodes() if n.name not in aux]

    def list_outputs(self) -> List[str]:
        out = []
        for node, i in self._outputs:
            suffix = "" if node.num_outputs == 1 else str(i)
            out.append(node.name if node.is_var
                       else f"{node.name}_output{suffix}")
        return out

    def list_inputs(self) -> List[str]:
        return [n.name for n in self._var_nodes()]

    def list_auxiliary_states(self) -> List[str]:
        """Variables at an op's mutable-input positions (BatchNorm's
        moving mean and variance): no gradient."""
        aux, seen = [], set()
        for node in _topo_nodes([o[0] for o in self._outputs]):
            for pos in _AUX_INPUT_POS.get(node.op_name, ()):
                if pos < len(node.inputs):
                    src, _ = node.inputs[pos]
                    if src.is_var and src.name not in seen:
                        seen.add(src.name)
                        aux.append(src.name)
        return aux

    def _var_nodes(self) -> List[_Node]:
        return [n for n in _topo_nodes([o[0] for o in self._outputs])
                if n.is_var]

    def get_internals(self) -> "Symbol":
        nodes = _topo_nodes([o[0] for o in self._outputs])
        return Group([Symbol([(n, i)]) for n in nodes
                      for i in range(n.num_outputs)])

    def get_children(self) -> Optional["Symbol"]:
        node = self._outputs[0][0]
        if not node.inputs:
            return None
        return Group([Symbol([inp]) for inp in node.inputs])

    @property
    def attr_dict(self):
        return {n.name: {k: str(v) for k, v in n.params.items()}
                for n in _topo_nodes([o[0] for o in self._outputs])}

    def attr(self, key):
        return self._outputs[0][0].attrs.get(key)

    def list_attr(self):
        return dict(self._outputs[0][0].attrs)

    def list_prng_keys(self) -> List[str]:
        """The PRNG-key variables composition created (the reference's
        engine RNG resource)."""
        return [n.name for n in _topo_nodes([o[0] for o in self._outputs])
                if n.is_var and n.attrs.get("__prng_key__")]

    # -- composition ---------------------------------------------------------
    def __call__(self, **kwargs):
        """Substitute named variables with other symbols."""
        mapping = {}
        for name, sym in kwargs.items():
            if not isinstance(sym, Symbol):
                raise TypeError("compose expects Symbols")
            mapping[name] = sym._outputs[0]
        memo: Dict[int, _Node] = {}

        def edge(node, idx):
            if node.is_var and node.name in mapping:
                return mapping[node.name]
            return (rebuild(node), idx)

        def rebuild(node):
            if id(node) in memo:
                return memo[id(node)]
            new = _Node(node.op_name, node.name, node.params,
                        [edge(n, i) for n, i in node.inputs],
                        node.num_outputs)
            new.attrs = dict(node.attrs)
            memo[id(node)] = new
            return new

        return Symbol([edge(n, i) for n, i in self._outputs])

    # -- arithmetic ----------------------------------------------------------
    def _binop(self, other, op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _apply(op, [a, b])
        c = float(other)
        scalar_op = {"elemwise_add": "_plus_scalar",
                     "elemwise_sub": "_rminus_scalar" if reverse
                     else "_minus_scalar",
                     "elemwise_mul": "_mul_scalar",
                     "elemwise_div": "_rdiv_scalar" if reverse
                     else "_div_scalar",
                     "broadcast_power": "_rpower_scalar" if reverse
                     else "_power_scalar"}.get(op)
        if scalar_op and scalar_op in _reg._REGISTRY:
            return _apply(scalar_op, [self], scalar=c)
        return _apply(op, [self], _scalar=c, _reverse=reverse)

    def __add__(self, o): return self._binop(o, "elemwise_add")
    def __radd__(self, o): return self._binop(o, "elemwise_add", True)
    def __sub__(self, o): return self._binop(o, "elemwise_sub")
    def __rsub__(self, o): return self._binop(o, "elemwise_sub", True)
    def __mul__(self, o): return self._binop(o, "elemwise_mul")
    def __rmul__(self, o): return self._binop(o, "elemwise_mul", True)
    def __truediv__(self, o): return self._binop(o, "elemwise_div")
    def __rtruediv__(self, o): return self._binop(o, "elemwise_div", True)
    def __pow__(self, o): return self._binop(o, "broadcast_power")
    def __neg__(self): return _apply("negative", [self])

    def __eq__(self, o):
        return self._binop(o, "broadcast_equal") if isinstance(o, Symbol) \
            else NotImplemented
    __hash__ = object.__hash__

    # -- evaluation ----------------------------------------------------------
    def _lower(self, arg_names: List[str], is_train: bool = True):
        """``fn(list of tensors) -> list of output tensors``, the graph's
        ops in topological order.  ``is_train`` is the training flag the
        ops read (a Dropout not in mode ``"always"`` is the identity when
        it is off, as in the reference's inference graph)."""
        order = _topo_nodes([o[0] for o in self._outputs])
        pos = {name: i for i, name in enumerate(arg_names)}
        outputs = list(self._outputs)

        def fn(arrays):
            vals: Dict[int, Any] = {}
            with ag.train_mode() if is_train else ag.predict_mode():
                for node in order:
                    if node.is_var:
                        if node.name not in pos:
                            raise MXNetError(
                                f"missing argument {node.name!r}")
                        vals[id(node)] = [arrays[pos[node.name]]]
                        continue
                    ins = [vals[id(n)][i] for n, i in node.inputs]
                    op = _reg.get(node.op_name)
                    if node.op_name in KEYED_OPS and node.inputs and \
                            node.inputs[-1][0].attrs.get("__prng_key__"):
                        out = _run_keyed(op.fn, ins, node.params)
                    else:
                        out = op.fn(*ins, **node.params)
                    vals[id(node)] = list(out) if isinstance(
                        out, (tuple, list)) else [out]
            return [vals[id(n)][i] for n, i in outputs]

        return fn

    def infer_shape(self, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from argument shapes;
        parameter shapes left out are derived from the data's by each
        op's rule (partial inference).  The graph runs on ``meta``
        tensors."""
        args = self.list_arguments()
        auxs = self.list_auxiliary_states()
        names = args + auxs
        known = {n: tuple(kwargs[n]) for n in names if n in kwargs}
        if len(known) < len(names):
            known = self._infer_missing_arg_shapes(known)
        keyset = set(self.list_prng_keys())
        metas = []
        for name in names:
            if name in keyset:
                known.setdefault(name, (2,))
                metas.append(torch.empty((2,), dtype=torch.int64,
                                         device="meta"))
                continue
            if name not in known:
                raise MXNetError(f"infer_shape: cannot infer shape for "
                                 f"{name!r}; pass it explicitly")
            metas.append(torch.empty(known[name], device="meta"))
        outs = self._run_meta(names, metas)
        return ([tuple(known[n]) for n in args],
                [tuple(o.shape) for o in outs],
                [tuple(known[n]) for n in auxs])

    def _run_meta(self, names, metas):
        from ..ops.legacy import lowering_device
        fn = self._lower(names, is_train=False)
        with lowering_device("meta"), torch.no_grad():
            try:
                return fn(metas)
            except MXNetError:
                raise
            except Exception as e:
                raise MXNetError(f"infer_shape: {type(e).__name__}: "
                                 f"{e}") from e

    def infer_shape_partial(self, **kwargs):
        """The best effort: None for what cannot be inferred."""
        try:
            return self.infer_shape(**kwargs)
        except MXNetError:
            args = self.list_arguments()
            auxs = self.list_auxiliary_states()
            known = self._infer_missing_arg_shapes(
                {n: tuple(kwargs[n]) for n in args + auxs if n in kwargs})
            return ([known.get(n) for n in args], None,
                    [known.get(n) for n in auxs])

    def _infer_missing_arg_shapes(self, known):
        """A forward pass deriving parameter shapes from data shapes, by
        the rules each layer's deferred initialisation uses."""
        from ..ops.legacy import lowering_device
        known = dict(known)
        shapes: Dict[int, Any] = {}
        for node in _topo_nodes([o[0] for o in self._outputs]):
            if node.is_var:
                if node.name in known:
                    shapes[id(node)] = [known[node.name]]
                elif node.attrs.get("__prng_key__"):
                    shapes[id(node)] = [(2,)]
                continue
            in_shapes = []
            for pos, (src, i) in enumerate(node.inputs):
                lst = shapes.get(id(src))
                s = lst[i] if lst and i < len(lst) else (
                    lst[0] if lst else None)
                if s is None and src.is_var:
                    s = _param_shape_rule(node.op_name, pos,
                                          in_shapes[0] if in_shapes
                                          else None, node.params)
                    if s is not None:
                        known[src.name] = s
                        shapes[id(src)] = [s]
                in_shapes.append(s)
            if any(s is None for s in in_shapes):
                continue
            try:
                ins = [torch.empty(s, device="meta") for s in in_shapes]
                if node.op_name in KEYED_OPS and ins:
                    ins = ins[:-1]
                with lowering_device("meta"), torch.no_grad(), \
                        ag.predict_mode():
                    out = _reg.get(node.op_name).fn(*ins, **node.params)
                outs = list(out) if isinstance(out, (tuple, list)) \
                    else [out]
                shapes[id(node)] = [tuple(o.shape) for o in outs]
            except Exception:
                continue
        return known

    def infer_type(self, **kwargs):
        """``(arg dtypes, [float32], [])`` as the reference reports."""
        args = self.list_arguments()
        return ([np_dtype(kwargs.get(n)) if kwargs.get(n) is not None
                 else onp.dtype("float32") for n in args],
                [onp.dtype("float32")], [])

    def eval(self, ctx=None, **kwargs):
        """The outputs as NDArrays from NDArray (or array) arguments; PRNG
        keys left out are drawn."""
        from ..ndarray.ndarray import NDArray
        from ..ndarray import array as nd_array
        args = self.list_arguments() + self.list_auxiliary_states()
        keyset = set(self.list_prng_keys())
        arrays, device = [], None
        for name in args:
            if name in kwargs:
                v = kwargs[name]
                t = v._data if isinstance(v, NDArray) else \
                    nd_array(v, ctx=ctx)._data
                device = device or t.device
                arrays.append(t)
            elif name not in keyset:
                raise MXNetError(f"eval: missing argument {name!r}")
            else:
                arrays.append(None)
        device = device or (ctx.torch_device if ctx is not None
                            else torch.device("cpu"))
        arrays = [new_key(device) if a is None else a for a in arrays]
        with torch.no_grad():
            # the training graph, as the reference's eval lowers it
            outs = self._lower(args)(arrays)
        return [NDArray._wrap(o) for o in outs]

    # -- binding -------------------------------------------------------------
    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        from .executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req,
                        aux_states=aux_states)

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    **shapes):
        """Bind with zero-filled arguments, gradients and auxiliary states
        of the inferred shapes, on ``ctx`` (default: the current
        context)."""
        from ..context import current_context
        from ..ndarray.ndarray import NDArray
        dev = (ctx if ctx is not None else current_context()).torch_device
        type_dict = type_dict or {}
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        keyset = set(self.list_prng_keys())

        def zeros(n, s):
            return NDArray._wrap(torch.zeros(
                s, dtype=torch_dtype(type_dict.get(n, "float32")),
                device=dev))
        args = {n: zeros(n, s) for n, s in zip(arg_names, arg_shapes)
                if n not in keyset}
        grads = {n: zeros(n, s) for n, s in zip(arg_names, arg_shapes)
                 if n not in keyset} if grad_req != "null" else None
        aux = {n: zeros(n, s) for n, s in zip(aux_names, aux_shapes)}
        return self.bind(ctx, args, grads, grad_req, aux_states=aux)

    # -- serialization -------------------------------------------------------
    def tojson(self) -> str:
        nodes = _topo_nodes([o[0] for o in self._outputs])
        idx = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            spec = {"op": "null" if n.is_var else n.op_name,
                    "name": n.name,
                    "attrs": _json_attrs(n.params),
                    "inputs": [[idx[id(src)], i, 0] for src, i in n.inputs]}
            if n.attrs:
                spec["user_attrs"] = dict(n.attrs)
            out_nodes.append(spec)
        payload = {
            "nodes": out_nodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_var],
            "heads": [[idx[id(n)], i, 0] for n, i in self._outputs],
            "attrs": {"mxnet_version": ["int", 20000],
                      "format": "mxnet_tpu-symbol-v1"},
        }
        return json.dumps(payload, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())


def _json_attrs(params: dict) -> dict:
    out = {}
    for k, v in params.items():
        if isinstance(v, tuple):
            out[k] = list(v)
        elif isinstance(v, (int, float, bool, str, type(None), list)):
            out[k] = v
        else:
            out[k] = str(v)
    return out


def _from_json_attrs(attrs: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in attrs.items()}


def _topo_nodes(roots: List[_Node]) -> List[_Node]:
    seen, order = set(), []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for src, _ in node.inputs:
            visit(src)
        order.append(node)

    for r in roots:
        visit(r)
    return order


def _apply(op_name: str, inputs: List[Symbol], name: Optional[str] = None,
           _named: bool = False, **params) -> Symbol:
    """A node of ``op_name`` over ``inputs``; ``name`` goes through the
    current name manager unless ``_named`` (already through it)."""
    _reg.get(op_name)
    reverse = params.pop("_reverse", None)
    scalar = params.pop("_scalar", None)
    if scalar is not None:
        params["__scalar__"] = scalar
        params["__reverse__"] = bool(reverse)
        op_name = "_scalar_wrap:" + op_name
        _ensure_scalar_wrap(op_name)
    from .. import name as _name_mod
    node_name = name if _named else _name_mod.current().get(
        name, op_name.split(":")[-1].lower().lstrip("_"))
    node = _Node(op_name, node_name, params,
                 [(s._outputs[0][0], s._outputs[0][1]) for s in inputs])
    return Symbol([(node, 0)])


def _ensure_scalar_wrap(wrapped_name: str):
    if wrapped_name in _reg._REGISTRY:
        return
    base_fn = _reg.get(wrapped_name.split(":", 1)[1]).fn

    def fn(x, **params):
        c = params.pop("__scalar__")
        rev = params.pop("__reverse__", False)
        cv = torch.tensor(c, dtype=x.dtype)
        return base_fn(cv, x, **params) if rev else base_fn(x, cv, **params)

    _reg._REGISTRY[wrapped_name] = _reg.Operator(wrapped_name, fn)


# keyword arguments ``var()`` takes and stringifies into ``__dunder__``
# attributes (as the reference's ``symbol.var``)
_VAR_KNOWN_KWARGS = ("lr_mult", "wd_mult", "init", "stype",
                     "profiler_scope")


def Variable(name: str, shape=None, dtype=None, attrs=None,
             **kwargs) -> Symbol:
    merged = dict(attrs or {})
    for k, v in kwargs.items():
        if k in _VAR_KNOWN_KWARGS or (k.startswith("__")
                                      and k.endswith("__")):
            key = k if k.startswith("__") else f"__{k}__"
            merged[key] = v.dumps() if hasattr(v, "dumps") else (
                v if isinstance(v, str) else str(v))
        else:
            merged[k] = v
    for k, v in merged.items():
        if not isinstance(v, str):
            raise ValueError(f"Attribute {k}={v!r}: attributes need to be "
                             f"strings")
    return Symbol([(_Node(None, name, attrs=merged), 0)])


var = Variable


def trace(block, *inputs):
    """One Gluon forward of ``block`` on ``inputs`` as a Symbol:
    ``(sym, arg_params, aux_params)`` (the reference's deferred-compute
    trace).  The forward runs eagerly in inference mode under a
    recorder (``symbol/_trace.py``) that makes a node of every registered
    op a layer calls and of each bare tensor operation the reference
    would dispatch as an op.  Parameters become variables under their
    ``collect_params()`` names, the inputs ``data`` (``data0``, ... for
    several); a tensor that came from outside the forward is captured as
    an argument ``__dc_const_<n>``.  Auxiliary states (``grad_req ==
    "null"``: BatchNorm's running statistics) go to ``aux_params``."""
    from ..ndarray.ndarray import NDArray
    from . import _trace
    tensors = [x._data if isinstance(x, NDArray) else torch.as_tensor(x)
               for x in inputs]
    with torch.no_grad(), ag.pause(train_mode=False):
        block(*tensors)            # finishes deferred initialisation
    params = dict(block.collect_params().items())
    rec = _trace.Recorder(_Node)
    for k, p in params.items():
        if p._data is not None:
            rec.tag(p._data, k)
    for i, x in enumerate(tensors):
        rec.tag(x, "data" if len(tensors) == 1 else f"data{i}")
    with torch.no_grad(), ag.pause(train_mode=False), rec:
        out = block(*tensors)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    refs = [rec.output_ref(o) for o in outs]
    sym = Symbol(refs)
    used = {n.name for n in _topo_nodes([r[0] for r in refs]) if n.is_var}
    arg_params, aux_params = {}, {}
    for k, p in params.items():
        if k in used:
            dst = aux_params if p.grad_req == "null" else arg_params
            dst[k] = p.data()
    for k, t in rec.captured.items():
        if k in used:
            arg_params[k] = NDArray._wrap(t)
    return sym, arg_params, aux_params


def Group(symbols: Sequence[Symbol]) -> Symbol:
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


_KNOWN_FORMATS = ("mxnet_tpu-symbol-v1",)


def _parse_legacy_attr(v):
    """MXNet 1.x json keeps every attribute as a string ("(3, 3)",
    "True", "2"): back to Python values."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def load_json(json_str: str) -> Symbol:
    payload = json.loads(json_str)
    fmt = (payload.get("attrs") or {}).get("format")
    legacy = fmt is None
    if not legacy and fmt not in _KNOWN_FORMATS:
        raise MXNetError(
            f"unknown symbol json format {fmt!r}; this build reads "
            f"{_KNOWN_FORMATS} and legacy (reference) symbol json")
    nodes: List[_Node] = []
    for spec in payload["nodes"]:
        if spec["op"] == "null":
            node = _Node(None, spec["name"])
        else:
            raw = spec.get("attrs", spec.get("attr", spec.get("param", {})))
            if legacy:
                params = {k: _parse_legacy_attr(v) for k, v in raw.items()}
            else:
                params = _from_json_attrs(raw)
            if spec["op"].startswith("_scalar_wrap:"):
                _ensure_scalar_wrap(spec["op"])
            node = _Node(spec["op"], spec["name"], params)
        node.attrs = dict(spec.get("user_attrs", {}))
        node.inputs = [(nodes[i], oi) for i, oi, *_ in spec["inputs"]]
        nodes.append(node)
    for node in nodes:
        # an op node's output count: the most any edge reads
        for src, i in node.inputs:
            src.num_outputs = max(src.num_outputs, i + 1)
    heads = [(nodes[i], oi) for i, oi, *_ in payload["heads"]]
    return Symbol(heads)


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


# mutable-input positions per op (the reference's FMutateInputs)
_AUX_INPUT_POS = {"BatchNorm": (3, 4), "batch_norm": (3, 4),
                  "SyncBatchNorm": (3, 4)}


def _param_shape_rule(op_name, pos, data_shape, params):
    """A parameter input's shape from the op's data shape and static
    params (the deferred-init rules of the Gluon layers)."""
    if data_shape is None:
        return None
    p = params

    def _prod(xs):
        out = 1
        for x in xs:
            out *= x
        return out

    if op_name == "FullyConnected":
        nh = p.get("num_hidden")
        flatten = p.get("flatten", True)
        if pos == 1:
            return (nh, _prod(data_shape[1:]) if flatten
                    else data_shape[-1])
        if pos == 2:
            return (nh,)
    elif op_name == "Convolution":
        nf = p.get("num_filter")
        k = tuple(p.get("kernel", ()))
        g = p.get("num_group", 1)
        layout = p.get("layout") or "NCHW"
        c_last = layout.endswith("C")
        cin = data_shape[-1] if c_last else data_shape[1]
        if pos == 1:
            return ((nf,) + k + (cin // g,)) if c_last \
                else ((nf, cin // g) + k)
        if pos == 2:
            return (nf,)
    elif op_name == "Deconvolution":
        nf = p.get("num_filter")
        k = tuple(p.get("kernel", ()))
        g = p.get("num_group", 1)
        if pos == 1:
            return (data_shape[1], nf // g) + k
        if pos == 2:
            return (nf,)
    elif op_name in ("BatchNorm", "InstanceNorm"):
        return (data_shape[p.get("axis", 1)],)
    elif op_name == "LayerNorm":
        return (data_shape[p.get("axis", -1)],)
    elif op_name == "Embedding":
        if pos == 1:
            return (p.get("input_dim"), p.get("output_dim"))
    elif op_name in ("SoftmaxOutput", "softmax_output",
                     "LinearRegressionOutput", "LogisticRegressionOutput",
                     "MAERegressionOutput"):
        if pos == 1:
            return (data_shape[0],) if op_name.startswith("Softmax") \
                else tuple(data_shape)
    return None
