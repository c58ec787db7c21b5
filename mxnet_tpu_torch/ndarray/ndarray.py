"""NDArray: the imperative tensor (counterpart of
``mxnet_tpu/ndarray/ndarray.py``), a handle over a ``torch.Tensor``.

Arithmetic, comparison and method-style ops go through the op registry
(``ops/registry.py``), so every op call passes the one funnel and is
recorded for ``autograd`` only inside ``autograd.record()``.  In-place
operators and ``out=`` rebind the handle to the op's result, as the
reference rebinds its immutable buffers: a variable's tensor is never
written in place (torch refuses that on a leaf that requires grad), and
a variable stays a variable across the rebind.

``wait_to_read`` synchronises the tensor's stream.  ``dtype`` is a numpy
dtype, except for bfloat16, which numpy lacks: there it is
``torch.bfloat16``, and ``asnumpy`` raises (cast to float32 first).
"""
from __future__ import annotations

import numbers
from typing import Optional

import numpy as onp
import torch

from .. import autograd as ag
from ..base import MXNetError, check_shape, dtype_name, np_dtype, torch_dtype
from ..context import Context, current_context
from ..ops import tensor as tensor_ops
from ..ops.registry import apply_torch, invoke

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "waitall"]


def _device(ctx: Optional[Context]) -> torch.device:
    return (ctx if ctx is not None else current_context()).torch_device


def _as_torch(data, ctx: Optional[Context], dtype) -> torch.Tensor:
    if isinstance(data, NDArray):
        data = data._data
    if isinstance(data, torch.Tensor):
        t = data.detach()
        return t.to(device=t.device if ctx is None else ctx.torch_device,
                    dtype=t.dtype if dtype is None else torch_dtype(dtype))
    was_numpy = isinstance(data, onp.ndarray)
    arr = onp.asarray(data, order="C")
    if dtype is not None:
        target = torch_dtype(dtype)
    elif not was_numpy or arr.dtype == onp.float64:
        # python lists/scalars default to float32 (MXNet's default), and
        # numpy float64 becomes float32 as in the reference without x64
        target = torch.float32
    elif arr.dtype == onp.int64:
        target = torch.int32           # the reference's 32-bit default
    else:
        target = torch_dtype(arr.dtype)
    # one rounding from the source type (float64 → bfloat16 directly);
    # copy=True so the array never aliases the caller's numpy buffer
    return torch.from_numpy(arr).to(device=_device(ctx), dtype=target,
                                    copy=True)


# NDArray ⊕ scalar → the registered *_scalar op (parity: the reference's
# scalar sugar, ``mxnet_tpu/ndarray/ndarray.py:304``)
_SCALAR_OPS = {
    ("elemwise_add", False): "_plus_scalar",
    ("elemwise_add", True): "_plus_scalar",
    ("elemwise_sub", False): "_minus_scalar",
    ("elemwise_sub", True): "_rminus_scalar",
    ("elemwise_mul", False): "_mul_scalar",
    ("elemwise_mul", True): "_mul_scalar",
    ("elemwise_div", False): "_div_scalar",
    ("elemwise_div", True): "_rdiv_scalar",
    ("broadcast_mod", False): "_mod_scalar",
    ("broadcast_mod", True): "_rmod_scalar",
    ("broadcast_power", False): "_power_scalar",
    ("broadcast_power", True): "_rpower_scalar",
    ("broadcast_equal", False): "_equal_scalar",
    ("broadcast_not_equal", False): "_not_equal_scalar",
    ("broadcast_greater", False): "_greater_scalar",
    ("broadcast_greater_equal", False): "_greater_equal_scalar",
    ("broadcast_lesser", False): "_lesser_scalar",
    ("broadcast_lesser_equal", False): "_lesser_equal_scalar",
}


class NDArray:
    """Multi-dimensional array on a device, with autograd hooks
    (parity: ``mx.nd.NDArray``)."""

    __slots__ = ("_data", "_grad", "_grad_req", "_leaf", "__weakref__")

    def __init__(self, data, ctx: Optional[Context] = None, dtype=None):
        self._data = _as_torch(data, ctx, dtype)
        self._grad, self._grad_req, self._leaf = None, "null", None

    @classmethod
    def _wrap(cls, tensor: torch.Tensor) -> "NDArray":
        """An NDArray over ``tensor`` as it is (no copy, graph kept)."""
        out = cls.__new__(cls)
        out._data = tensor
        out._grad, out._grad_req, out._leaf = None, "null", None
        return out

    def _is_variable(self) -> bool:
        return self._grad is not None and self._grad_req != "null"

    def _adopt(self, other: "NDArray") -> "NDArray":
        """In-place update: take ``other``'s tensor.  A variable stays
        one: a recorded update keeps its graph back to the variable's
        leaf (whose gradient ``backward`` delivers, as the reference's
        tape does), an unrecorded one makes a fresh leaf."""
        t = other._data
        if self._is_variable() and not t.requires_grad:
            return self._rebind(t)
        self._data = t
        return self

    def _rebind(self, t: torch.Tensor) -> "NDArray":
        """Replace the contents outside any graph; a variable becomes a
        fresh leaf."""
        t = t.detach()
        if self._is_variable():
            t = self._leaf = t.requires_grad_()
        self._data = t
        return self

    # -- basic properties --------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        if self._data.dtype == torch.bfloat16:
            return torch.bfloat16
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self) -> Context:
        return Context.of(self._data.device)

    ctx = context

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    def attach_grad(self, grad_req: str = "write"):
        """Allocate a zero gradient buffer and make this a variable."""
        buf = NDArray._wrap(torch.zeros_like(self._data.detach()))
        ag.mark_variables([self], [buf], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        ag.backward([self], [out_grad] if out_grad is not None else None,
                    retain_graph=retain_graph, train_mode=train_mode)

    def detach(self) -> "NDArray":
        return NDArray._wrap(self._data.detach())

    # -- sync / transfer ---------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def asnumpy(self) -> onp.ndarray:
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            raise MXNetError("asnumpy: numpy has no bfloat16; call "
                             ".astype('float32') first")
        a = t.cpu().numpy()
        return a.copy() if t.device.type == "cpu" else a

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self._data.detach().reshape(()).item()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size != 1:
            raise MXNetError("truth value of multi-element NDArray is "
                             "ambiguous")
        return bool(self.asscalar())

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def astype(self, dtype, copy=True) -> "NDArray":
        if not copy and self._data.dtype == torch_dtype(dtype):
            return self
        return invoke("cast", [self], dtype=dtype_name(dtype))

    def copy(self) -> "NDArray":
        return NDArray._wrap(self._data.detach().clone())

    def copyto(self, other):
        if isinstance(other, Context):
            return NDArray._wrap(self._data.detach().to(other.torch_device,
                                                        copy=True))
        if isinstance(other, NDArray):
            return other._rebind(self._data.to(
                other._data.device, other._data.dtype, copy=True))
        raise TypeError(f"copyto: unsupported target {type(other)}")

    def as_in_context(self, ctx: Context) -> "NDArray":
        if ctx == self.context:
            return self
        return NDArray._wrap(self._data.detach().to(ctx.torch_device))

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            idx = _take_rows_index(key, self.shape)
            return apply_torch(lambda d: d[idx], [self])
        key = _norm_index(key)
        return apply_torch(lambda d: d[key], [self])

    def __setitem__(self, key, value):
        key = _norm_index(key)
        if isinstance(value, NDArray):
            if ag.is_recording():
                self._adopt(apply_torch(lambda d, v: _set(d, key, v),
                                        [self, value]))
                return
            value = value._data.detach()
        self._rebind(_set(self._data.detach(), key, value))

    # -- arithmetic --------------------------------------------------------
    def _binop(self, other, name, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(name, [a, b])
        if isinstance(other, (numbers.Number, onp.number)):
            return invoke(_SCALAR_OPS[(name, bool(reverse))], [self],
                          scalar=other)
        return NotImplemented

    def __add__(self, o): return self._binop(o, "elemwise_add")
    def __radd__(self, o): return self._binop(o, "elemwise_add", True)
    def __sub__(self, o): return self._binop(o, "elemwise_sub")
    def __rsub__(self, o): return self._binop(o, "elemwise_sub", True)
    def __mul__(self, o): return self._binop(o, "elemwise_mul")
    def __rmul__(self, o): return self._binop(o, "elemwise_mul", True)
    def __truediv__(self, o): return self._binop(o, "elemwise_div")
    def __rtruediv__(self, o): return self._binop(o, "elemwise_div", True)
    def __mod__(self, o): return self._binop(o, "broadcast_mod")
    def __rmod__(self, o): return self._binop(o, "broadcast_mod", True)
    def __pow__(self, o): return self._binop(o, "broadcast_power")
    def __rpow__(self, o): return self._binop(o, "broadcast_power", True)

    def __iadd__(self, o): return self._adopt(self.__add__(o))
    def __isub__(self, o): return self._adopt(self.__sub__(o))
    def __imul__(self, o): return self._adopt(self.__mul__(o))
    def __itruediv__(self, o): return self._adopt(self.__truediv__(o))

    def __neg__(self): return invoke("negative", [self])
    def __abs__(self): return invoke("abs", [self])

    def __eq__(self, o): return self._binop(o, "broadcast_equal")
    def __ne__(self, o): return self._binop(o, "broadcast_not_equal")
    def __gt__(self, o): return self._binop(o, "broadcast_greater")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal")

    __hash__ = None  # mutable

    def __repr__(self):
        t = self._data.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return (f"\n{t.numpy()!r}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.context}>")

    # -- method-style ops --------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if "shape" in kwargs:
            shape = kwargs["shape"]
        elif len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = shape[0]
        return invoke("reshape", [self], shape=tuple(shape),
                      reverse=kwargs.get("reverse", False))

    def sum(self, axis=None, keepdims=False):
        return invoke("sum", [self], axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return invoke("mean", [self], axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return invoke("max", [self], axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return invoke("min", [self], axis=axis, keepdims=keepdims)

    def abs(self): return invoke("abs", [self])
    def exp(self): return invoke("exp", [self])
    def log(self): return invoke("log", [self])
    def sqrt(self): return invoke("sqrt", [self])
    def square(self): return invoke("square", [self])
    def sigmoid(self): return invoke("sigmoid", [self])
    def tanh(self): return invoke("tanh", [self])
    def relu(self): return invoke("relu", [self])


def _norm_index(key):
    """NDArray indices → their tensors (numeric ones as int64)."""
    if isinstance(key, NDArray):
        t = key._data.detach()
        return t if t.dtype == torch.bool else t.long()
    if isinstance(key, tuple):
        return tuple(_norm_index(k) for k in key)
    if isinstance(key, list):
        return torch.as_tensor(key)
    return key


def _take_rows_index(key, shape):
    """An NDArray key as the rows it takes along axis 0, as the reference
    does (``mxnet_tpu/ndarray/ndarray.py:293-295``): any key, bool ones
    too, is cast to int32, so ``[True, False]`` takes rows 1 and 0, and
    negative rows wrap.  A row outside ``[-n, n)`` raises IndexError
    where the reference fills it with NaN; the check reads the key's
    range back to the host."""
    if not shape:
        raise IndexError("an NDArray key needs an array of at least one "
                         "dimension")
    idx = tensor_ops.cast(key._data.detach(), dtype=torch.int32).long()
    n = shape[0]
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < -n or hi >= n:
            raise IndexError(f"index rows [{lo}, {hi}] out of range for "
                             f"axis 0 of size {n}")
    return idx


def _set(data, key, value):
    """``data`` with ``data[key] = value``, as a new tensor."""
    out = data.clone()
    out[key] = torch.as_tensor(value, dtype=data.dtype).to(data.device)
    return out


# --------------------------------------------------------------------------
# constructors (parity: ``mxnet_tpu/ndarray/ndarray.py:538-585``)
# --------------------------------------------------------------------------

def array(source_array, ctx=None, dtype=None) -> NDArray:
    return NDArray(source_array, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray._wrap(torch.zeros(check_shape(shape),
                                     dtype=torch_dtype(dtype),
                                     device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray._wrap(torch.ones(check_shape(shape),
                                    dtype=torch_dtype(dtype),
                                    device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray._wrap(torch.full(check_shape(shape), val,
                                    dtype=torch_dtype(dtype),
                                    device=_device(ctx)))


def empty(shape, ctx=None, dtype=None) -> NDArray:
    """Zeros, as in the reference (no uninitialised memory reaches a
    caller)."""
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=_device(ctx))
    if repeat > 1:
        t = t.repeat_interleave(repeat)
    return NDArray._wrap(t)


def waitall():
    """Wait for all work queued on every visible card."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
