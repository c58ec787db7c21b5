"""Utility switches (counterpart of ``mxnet_tpu/util.py``).

The numpy-shape and numpy-array modes (``set_np`` / ``reset_np``, the
``np_array`` / ``np_shape`` scopes and the ``use_np*`` decorators): numpy
shape semantics are native, so the switches only say which array type
the Gluon layers hand back.

The 64-bit switches (``set_np_default_dtype``, ``set_large_tensor``):
the reference rides JAX's x64 mode, under which every float64 / int64
result becomes float32 / int32 unless one of the two is on.  Torch has
64-bit types natively, so the port reproduces the reference's dtypes
instead: :func:`x64_enabled` says whether either switch is on, and
``mx.np`` narrows its results (``ops.np_impl.canon``) when neither is.
The switches change nothing else.
"""
from __future__ import annotations

import functools
import os
import threading

__all__ = ["is_np_array", "is_np_shape", "set_np", "reset_np", "np_array",
           "np_shape", "use_np", "use_np_shape", "use_np_array",
           "set_np_shape", "set_np_default_dtype", "is_np_default_dtype",
           "np_default_dtype", "use_np_default_dtype", "get_gpu_count",
           "get_gpu_memory", "get_cuda_compute_capability", "set_module",
           "np_ufunc_legal_option", "wrap_np_unary_func",
           "wrap_np_binary_func", "default_array", "numpy_fallback",
           "getenv", "setenv", "set_large_tensor",
           "is_large_tensor_enabled", "x64_enabled"]

_state = threading.local()


def _st():
    if not hasattr(_state, "np_array"):
        _state.np_array = False
        _state.np_shape = True  # numpy shape semantics are native here
    return _state


def is_np_array() -> bool:
    return _st().np_array


def is_np_shape() -> bool:
    return _st().np_shape


def set_np_shape(active: bool) -> bool:
    st = _st()
    old, st.np_shape = st.np_shape, bool(active)
    return old


def set_np(shape: bool = True, array: bool = True,
           dtype: bool = False) -> None:
    st = _st()
    st.np_shape = bool(shape)
    st.np_array = bool(array)
    set_np_default_dtype(bool(dtype))


def reset_np() -> None:
    set_np(shape=True, array=False, dtype=False)


class _NpScope:
    def __init__(self, shape=True, array=True):
        self._shape, self._array = shape, array

    def __enter__(self):
        st = _st()
        self._old = (st.np_shape, st.np_array)
        if self._shape is not None:
            st.np_shape = self._shape
        if self._array is not None:
            st.np_array = self._array
        return self

    def __exit__(self, *exc):
        st = _st()
        # restore only the flags this scope set
        if self._shape is not None:
            st.np_shape = self._old[0]
        if self._array is not None:
            st.np_array = self._old[1]
        return False


def np_array(active: bool = True) -> _NpScope:
    return _NpScope(shape=None, array=active)


def np_shape(active: bool = True) -> _NpScope:
    return _NpScope(shape=active, array=None)


def _scoped(shape, array):
    def deco(func):
        if isinstance(func, type):
            return func     # class decoration: numpy semantics are native

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            with _NpScope(shape=shape, array=array):
                return func(*args, **kwargs)
        return wrapper
    return deco


use_np = _scoped(True, True)
use_np.__doc__ = "Decorator: run ``func`` with numpy semantics on."
use_np_shape = _scoped(True, None)
use_np_array = _scoped(None, True)


def getenv(name):
    return os.environ.get(name)


def setenv(name, value):
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value


# -- the 64-bit switches ------------------------------------------------------
# Two independent owners, as in the reference: toggling one never cancels
# the other.

_X64_REASONS = {"large_tensor": os.environ.get(
    "MXNET_INT64_TENSOR_SIZE", "0") in ("1", "true", "True"),
    "np_dtype": False}


def x64_enabled() -> bool:
    """Whether 64-bit results are kept (either switch on)."""
    return _X64_REASONS["large_tensor"] or _X64_REASONS["np_dtype"]


def set_large_tensor(active: bool) -> bool:
    """Turn 64-bit tensor support on or off; returns the previous
    setting (also on at import with ``MXNET_INT64_TENSOR_SIZE=1``)."""
    prev = _X64_REASONS["large_tensor"]
    _X64_REASONS["large_tensor"] = bool(active)
    return prev


def is_large_tensor_enabled() -> bool:
    return _X64_REASONS["large_tensor"]


def set_np_default_dtype(is_np_default=True) -> bool:
    """float64-by-default numpy semantics; returns the previous
    setting."""
    prev = _X64_REASONS["np_dtype"]
    _X64_REASONS["np_dtype"] = bool(is_np_default)
    return prev


def is_np_default_dtype() -> bool:
    return _X64_REASONS["np_dtype"]


class _NpDtypeScope:
    def __init__(self, active):
        self._active = active

    def __enter__(self):
        self._prev = set_np_default_dtype(self._active)
        return self

    def __exit__(self, *exc):
        set_np_default_dtype(self._prev)
        return False


def np_default_dtype(active=True):
    """Scope form of :func:`set_np_default_dtype`."""
    return _NpDtypeScope(active)


def use_np_default_dtype(func):
    """Decorator form of :func:`set_np_default_dtype`."""
    if isinstance(func, type):
        return func

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        with _NpDtypeScope(True):
            return func(*args, **kwargs)
    return wrapper


# -- devices ------------------------------------------------------------------

def get_gpu_count() -> int:
    """The number of visible cards."""
    import torch
    return torch.cuda.device_count()


def get_gpu_memory(gpu_dev_id=0):
    """``(free, total)`` bytes of card ``gpu_dev_id`` (``(0, 0)`` without
    one)."""
    import torch
    if not torch.cuda.is_available() or \
            gpu_dev_id >= torch.cuda.device_count():
        return (0, 0)
    free, total = torch.cuda.mem_get_info(gpu_dev_id)
    return (int(free), int(total))


def get_cuda_compute_capability(ctx=None):
    """The compute capability of ``ctx``'s card as an int (90 for sm_90);
    a context that is not a card raises ValueError, as in the
    reference."""
    import torch
    from .context import Context, current_context
    ctx = current_context() if ctx is None else ctx
    if not isinstance(ctx, Context) or ctx.device_type != "gpu":
        raise ValueError(f"expecting a gpu context to get the cuda compute "
                         f"capability, got {ctx}")
    major, minor = torch.cuda.get_device_capability(ctx.device_id)
    return major * 10 + minor


def set_module(module):
    """Decorator setting ``__module__`` for the docs."""
    def deco(obj):
        if module is not None:
            obj.__module__ = module
        return obj
    return deco


def np_ufunc_legal_option(key, value):
    """Whether a ufunc keyword is supported."""
    if key == "where":
        return value is True
    if key == "casting":
        return value in ("no", "equiv", "safe", "same_kind", "unsafe")
    if key == "order":
        return isinstance(value, str) or value is None
    if key in ("dtype", "out", "subok"):
        return True
    return False


def _checked(func, arity):
    @functools.wraps(func)
    def wrapper(*args, out=None, **kwargs):
        for k, v in kwargs.items():
            if not np_ufunc_legal_option(k, v):
                raise TypeError(f"{func.__name__} does not support "
                                f"{k}={v!r}")
        res = func(*args[:arity])
        if out is not None:
            out[:] = res
            return out
        return res
    return wrapper


def wrap_np_unary_func(func):
    """Check the numpy-ufunc keywords, then call ``func(x)``."""
    return _checked(func, 1)


def wrap_np_binary_func(func):
    """Check the numpy-ufunc keywords, then call ``func(a, b)``."""
    return _checked(func, 2)


def default_array(source_array, ctx=None, dtype=None):
    """An array of the type the np-array mode asks for."""
    if is_np_array():
        from . import numpy as _np
        return _np.array(source_array, dtype=dtype, ctx=ctx)
    import numpy as _onp
    from .ndarray import NDArray
    return NDArray(_onp.asarray(source_array, dtype=dtype), ctx=ctx)


def numpy_fallback(func):
    """Wrap a host-numpy function: NDArray arguments are read to the
    host, numpy results come back as NDArrays (the reference's
    fallback)."""
    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        import numpy as _onp
        from .ndarray import NDArray

        def to_np(x):
            return x.asnumpy() if hasattr(x, "asnumpy") else x
        out = func(*[to_np(a) for a in args],
                   **{k: to_np(v) for k, v in kwargs.items()})
        if isinstance(out, _onp.ndarray):
            return NDArray(out)
        if isinstance(out, tuple):
            return tuple(NDArray(o) if isinstance(o, _onp.ndarray) else o
                         for o in out)
        return out
    return wrapper
