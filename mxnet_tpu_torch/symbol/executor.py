"""Executor: a bound Symbol (counterpart of
``mxnet_tpu/symbol/executor.py``).

``forward(is_train)`` / ``backward(out_grads)`` / ``outputs`` /
``grad_arrays`` with ``grad_req`` write, add or null; auxiliary states
(BatchNorm's moving statistics) are inputs that take no gradient and,
as in the reference, are not written by the forward; PRNG keys the
caller did not pin are drawn anew at every forward.

The reference jits one executable for the bound graph.  Here an
inference forward (``is_train=False``) replays one captured
:class:`~mxnet_tpu_torch.executable.Executable` per bound signature
(the arguments' shapes and dtypes): a CUDA graph on a card, whose
outputs are copied out; on the CPU it runs the graph's ops.  A graph
with PRNG keys runs eagerly (a key seeds a generator on the host).  A
training forward runs the ops eagerly under autograd, and ``backward``
takes ``torch.autograd.grad`` of the outputs with respect to the
arguments that are not keys.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..base import MXNetError

__all__ = ["Executor"]


class Executor:
    def __init__(self, symbol, ctx, args, args_grad, grad_req="write",
                 aux_states=None):
        from ..ndarray.ndarray import NDArray
        from .symbol import new_key

        self._symbol = symbol
        self._ctx = ctx
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(self._arg_names, args))
        args = {k: _nd(v) for k, v in dict(args or {}).items()}
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self._aux_names, aux_states))
        aux = {n: args.pop(n) for n in self._aux_names if n in args}
        aux.update({k: _nd(v) for k, v in (aux_states or {}).items()})
        missing = (set(self._arg_names) - set(args)) | \
            (set(self._aux_names) - set(aux))
        self._key_args = sorted(set(symbol.list_prng_keys())
                                & set(self._arg_names + self._aux_names))
        self._keyset = set(self._key_args)
        # keys pinned at bind stay; the others are drawn at every forward
        self._auto_keys = {n for n in self._key_args
                           if n not in args and n not in aux}
        present = list(args.values()) + list(aux.values())
        self._device = (ctx.torch_device if ctx is not None else
                        present[0]._data.device if present else
                        torch.device("cpu"))
        for n in self._key_args:
            dst = args if n in self._arg_names else aux
            dst.setdefault(n, NDArray._wrap(new_key(self._device)))
        missing -= self._keyset
        if missing:
            raise MXNetError(f"bind: missing arguments {sorted(missing)}")
        self._args: Dict[str, NDArray] = {n: args[n]
                                          for n in self._arg_names}
        self._aux: Dict[str, NDArray] = {n: aux[n] for n in self._aux_names}
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(self._arg_names, args_grad))
        self._args_grad = args_grad
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(self._arg_names, grad_req))
        self._grad_req = grad_req
        self._all_names = self._arg_names + self._aux_names
        self._fwd = symbol._lower(self._all_names, is_train=True)
        self._fwd_eval = symbol._lower(self._all_names, is_train=False)
        self._exes = {}           # bound signature → captured forward
        self._owner = None
        self._graph_outs = None
        self._leaves = None
        self.outputs: List[NDArray] = []

    # -- the reference's accessors -----------------------------------------
    @property
    def arg_dict(self):
        return dict(self._args)

    @property
    def grad_dict(self):
        return dict(self._args_grad or {})

    @property
    def arg_arrays(self):
        return [self._args[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        if self._args_grad is None:
            return [None] * len(self._arg_names)
        return [self._args_grad.get(n) for n in self._arg_names]

    @property
    def aux_dict(self):
        return dict(self._aux)

    @property
    def aux_arrays(self):
        return [self._aux[n] for n in self._aux_names]

    @property
    def compiles(self) -> int:
        """How many inference signatures were captured."""
        return len(self._exes)

    def copy_params_from(self, arg_params, aux_params=None):
        for n, v in arg_params.items():
            if n in self._args:
                self._args[n]._data.copy_(_nd(v)._data)
        for n, v in (aux_params or {}).items():
            if n in self._aux:
                self._aux[n]._data.copy_(_nd(v)._data)

    # -- running -------------------------------------------------------------
    def forward(self, is_train: bool = False, **kwargs):
        from ..ndarray.ndarray import NDArray
        from .symbol import new_key
        for n, v in kwargs.items():
            if n in self._aux:
                self._aux[n] = _nd(v)
            elif n in self._args:
                self._args[n] = _nd(v)
            else:
                raise MXNetError(f"forward: unknown argument {n!r}")
        for n in self._auto_keys - set(kwargs):
            tgt = self._args if n in self._args else self._aux
            tgt[n] = NDArray._wrap(new_key(self._device))
        arrays = [self._args[n]._data for n in self._arg_names] + \
            [self._aux[n]._data for n in self._aux_names]
        if is_train:
            leaves = []
            for i, n in enumerate(self._arg_names):
                t = arrays[i]
                if n not in self._keyset and t.is_floating_point():
                    t = t.detach().requires_grad_()
                    leaves.append((i, t))
                    arrays[i] = t
            with torch.enable_grad():
                outs = self._fwd(arrays)
            self._leaves = leaves
            self._graph_outs = outs
        else:
            outs = self._eval(arrays)
            self._leaves = self._graph_outs = None
        self.outputs = [NDArray._wrap(o.detach()) for o in outs]
        return self.outputs

    def _eval(self, arrays):
        if self._key_args:
            with torch.no_grad():
                return self._fwd_eval(arrays)
        from ..executable import CaptureOwner, Executable
        sig = tuple((tuple(a.shape), a.dtype, a.device) for a in arrays)
        exe = self._exes.get(sig)
        if exe is None:
            if self._owner is None:
                self._owner = CaptureOwner()
            fn = self._fwd_eval

            def run(*tensors):
                with torch.no_grad():
                    return fn(list(tensors))
            exe = Executable(run, arrays, self._device,
                             *self._owner.capture_with(self._device),
                             warm="zeros")
            self._exes[sig] = exe
        outs = exe(*arrays)
        return [o.clone() for o in outs] if self._device.type == "cuda" \
            else list(outs)

    def eager(self, is_train: bool = False):
        """The bound graph's ops run eagerly on the current arguments
        (no capture): what a replay stands for, for comparisons."""
        arrays = [self._args[n]._data for n in self._arg_names] + \
            [self._aux[n]._data for n in self._aux_names]
        with torch.no_grad():
            fn = self._fwd if is_train else self._fwd_eval
            return [o.clone() for o in fn(arrays)]

    def backward(self, out_grads=None):
        from ..ndarray.ndarray import NDArray
        if self._graph_outs is None:
            raise MXNetError("backward called before forward(is_train=True)")
        outs = self._graph_outs
        if out_grads is None:
            cots = [torch.ones_like(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            cots = [_nd(g)._data.to(o.device, o.dtype)
                    for g, o in zip(out_grads, outs)]
        pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
        leaves = [t for _, t in self._leaves]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  leaves, [c for _, c in pairs],
                                  allow_unused=True) if pairs and leaves \
            else [None] * len(leaves)
        grads = [None] * len(self._arg_names)
        for n_i, n in enumerate(self._arg_names):
            if n in self._keyset:
                grads[n_i] = torch.zeros_like(self._args[n]._data)
        for (i, t), g in zip(self._leaves, got):
            grads[i] = torch.zeros_like(t) if g is None else g
        if self._args_grad is not None:
            for name, g in zip(self._arg_names, grads):
                req = self._grad_req.get(name, "write")
                if (req == "null" or name not in self._args_grad
                        or name in self._keyset or g is None):
                    continue
                tgt = self._args_grad[name]._data
                with torch.no_grad():
                    if req == "add":
                        tgt.add_(g.to(tgt.dtype))
                    else:
                        tgt.copy_(g)
        return [NDArray._wrap(g) if g is not None else None for g in grads]


def _nd(v):
    from ..ndarray.ndarray import NDArray
    from ..ndarray import array as nd_array
    if isinstance(v, NDArray):
        return v
    if isinstance(v, torch.Tensor):
        return NDArray._wrap(v)
    return nd_array(v)
