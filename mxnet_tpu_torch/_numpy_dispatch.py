"""The NumPy dispatch protocol on ``mx.np.ndarray`` (counterpart of
``mxnet_tpu/_numpy_dispatch.py``): ``numpy.mean(mx_array)`` and
``numpy.add(mx_array, 1)`` land on ``mx.np``'s own functions through
``__array_function__`` / ``__array_ufunc__``.

A name ``mx.np`` does not have, and a ufunc method or keyword form it
does not take (``reduce``, ``out=``, ``where=``), is evaluated by host
numpy on the arrays read back to the host, as the reference's
``numpy/fallback.py`` does: that is the protocol's fallback, and its
result is a host numpy value.
"""
from __future__ import annotations

_module_funcs = {}


def set_module_funcs(ns: dict) -> None:
    for k, v in ns.items():
        if callable(v) and not k.startswith("_"):
            _module_funcs[k] = v
    _install()


def _host(x):
    from .numpy import ndarray
    if isinstance(x, ndarray):
        return x.asnumpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _install():
    from .numpy import ndarray

    def __array_function__(self, func, types, args, kwargs):
        ours = _module_funcs.get(func.__name__)
        if ours is None:
            return func(*_host(list(args)), **kwargs)
        return ours(*args, **kwargs)

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        ours = _module_funcs.get(ufunc.__name__)
        if ours is not None and method == "__call__" and not kwargs:
            return ours(*inputs)
        out = kwargs.get("out")
        if out is not None:
            kwargs["out"] = tuple(_host(o) for o in (
                out if isinstance(out, tuple) else (out,)))
        return getattr(ufunc, method)(*_host(list(inputs)), **kwargs)

    ndarray.__array_function__ = __array_function__
    ndarray.__array_ufunc__ = __array_ufunc__
