"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``):
``Xavier``, ``MSRAPrelu``, ``Normal``, ``Uniform``, ``Orthogonal``,
``Zero``, ``One``, ``Constant``, ``Bilinear``, ``LSTMBias``, ``Load``,
``Mixed``, ``InitDesc`` and ``create``.

Values are drawn on the host from an explicit ``torch.Generator`` (the
caller's, or one seeded with 0) and then moved to the parameter's
device, so one seed gives the same weights on the CPU and on the card.
They are not the reference's numbers (JAX's PRNG differs); the tests
carry weights across with ``convert.load_collected_params``.
"""
from __future__ import annotations

import logging
import math
import re
from typing import Callable, Dict

import numpy as onp
import torch

from .base import MXNetError

__all__ = ["Initializer", "register", "create", "Load", "Zero", "One",
           "Constant", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Bilinear", "LSTMBias", "InitDesc", "Mixed"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(initializer, **kwargs) -> "Initializer":
    """``None`` → ``Uniform()``; an instance passes through; a name
    (``"xavier"``, ``"zeros"``, ...) builds one with ``kwargs``; a
    callable ``fn(name, arr)`` (``Mixed``) fills each weight in place."""
    if initializer is None:
        return Uniform()
    if isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, str):
        name = initializer.lower()
        if name not in _REGISTRY:
            raise MXNetError(f"unknown initializer {initializer!r}")
        return _REGISTRY[name](**kwargs)
    if callable(initializer):
        return _Wrapped(initializer)
    raise MXNetError(f"cannot create initializer from {initializer!r}")


class InitDesc(str):
    """A parameter's name with its ``attrs`` and the ``global_init``
    (the reference's descriptor)."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


def _host_generator():
    from .ops import random as _rng
    return _rng.generator("cpu")


class Initializer:
    """Base initializer.  ``init_array`` dispatches on the parameter's
    name as the reference does: ``gamma`` → ones, ``beta``/``bias`` →
    zeros, running (moving) means → zeros and variances → ones, anything
    else → ``_init_weight``.  ``init(name, arr)`` fills an NDArray in
    place, drawing from ``mx.random``'s host generator."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def init_array(self, name: str, shape, dtype,
                   generator: torch.Generator) -> torch.Tensor:
        name = str(name)
        if "gamma" in name:
            return torch.ones(shape, dtype=dtype)
        if name.endswith("beta") or name.endswith("bias"):
            return torch.zeros(shape, dtype=dtype)
        if "running_mean" in name or "moving_mean" in name:
            return torch.zeros(shape, dtype=dtype)
        if "running_var" in name or "moving_var" in name:
            return torch.ones(shape, dtype=dtype)
        return self._init_weight(name, tuple(shape), dtype, generator)

    def _init_weight(self, name, shape, dtype, generator):
        raise NotImplementedError

    def __call__(self, name, arr):
        from .ndarray.ndarray import NDArray
        if not isinstance(arr, NDArray):
            raise MXNetError("Initializer.__call__ expects (name, NDArray)")
        value = self.init_array(name, arr.shape, arr._data.dtype,
                                _host_generator())
        arr._rebind(value.to(arr._data.device))
        return arr

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


class _Wrapped(Initializer):
    """A callable ``fn(name, arr)`` that fills a zero NDArray in place."""

    def __init__(self, fn: Callable):
        super().__init__()
        self._fn = fn

    def _init_weight(self, name, shape, dtype, generator):
        from .ndarray.ndarray import NDArray
        arr = NDArray._wrap(torch.zeros(shape, dtype=dtype))
        self._fn(name, arr)
        return arr._data


@register
class Zero(Initializer):
    def _init_weight(self, name, shape, dtype, generator):
        return torch.zeros(shape, dtype=dtype)


_REGISTRY["zeros"] = Zero


@register
class One(Initializer):
    def _init_weight(self, name, shape, dtype, generator):
        return torch.ones(shape, dtype=dtype)


_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    """Every weight element ``value`` (PReLU's slopes)."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, shape, dtype, generator):
        return torch.full(shape, self.value, dtype=dtype)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, shape, dtype, generator):
        return torch.empty(shape, dtype=torch.float32).uniform_(
            -self.scale, self.scale, generator=generator).to(dtype)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, shape, dtype, generator):
        return (self.sigma * torch.randn(shape, generator=generator,
                                         dtype=torch.float32)).to(dtype)


@register
class Xavier(Initializer):
    """Uniform or Gaussian with scale ``sqrt(magnitude / factor)``, the
    factor from the fans (``avg``, ``in`` or ``out``)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, shape, dtype, generator):
        hw = math.prod(shape[2:])
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
        fan_out = shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        if self.rnd_type == "uniform":
            out = torch.empty(shape, dtype=torch.float32).uniform_(
                -scale, scale, generator=generator)
        else:
            out = scale * torch.randn(shape, generator=generator,
                                      dtype=torch.float32)
        return out.to(dtype)


@register
class Orthogonal(Initializer):
    """A (scaled) orthonormal basis from the SVD of a uniform [-1, 1] or
    normal matrix of (shape[0], prod(shape[1:]))."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, shape, dtype, generator):
        nout = shape[0]
        nin = math.prod(shape[1:]) if len(shape) > 1 else 1
        if self.rand_type == "uniform":
            tmp = torch.empty(nout, nin).uniform_(-1.0, 1.0,
                                                  generator=generator)
        else:
            tmp = torch.randn(nout, nin, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        return (self.scale * q).reshape(shape).to(dtype)


@register
class MSRAPrelu(Xavier):
    """Gaussian Xavier with magnitude ``2 / (1 + slope²)`` (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """A bilinear upsampling kernel in every (out, in) slice of a 4-d
    weight."""

    def _init_weight(self, name, shape, dtype, generator):
        n = math.prod(shape)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = onp.arange(n)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - onp.abs(x / f - c)) * (1 - onp.abs(y / f - c))
        return torch.from_numpy(w.astype(onp.float32).reshape(shape)).to(
            dtype)


@register
class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter (i, f, g, o) at
    ``forget_bias``.  Through ``init_array`` a name ending in ``bias``
    still takes zeros first, as in the reference."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, shape, dtype, generator):
        b = torch.zeros(shape, dtype=torch.float32)
        n = shape[0] // 4
        b[n:2 * n] = self.forget_bias
        return b.to(dtype)


def _as_tensor(src, dtype):
    data = src._data if hasattr(src, "_data") else src
    if isinstance(data, torch.Tensor):
        return data.detach().to("cpu", dtype)
    return torch.from_numpy(onp.array(data, dtype=onp.float32)).to(dtype)


class _FixedArray(Initializer):
    """One specific array (``Load``'s worker for a parameter it holds),
    whatever the parameter's name."""

    def __init__(self, value):
        super().__init__()
        self._value = value

    def init_array(self, name, shape, dtype, generator):
        if tuple(shape) != tuple(self._value.shape):
            raise MXNetError(
                f"Parameter {name} cannot be initialized from "
                f"loading: shape {tuple(shape)} vs loaded "
                f"{tuple(self._value.shape)}")
        return _as_tensor(self._value, dtype)


class Load(Initializer):
    """Parameters from a saved file or a name → array dict (``arg:`` /
    ``aux:`` prefixes dropped), bias, gamma and running-statistic names
    included; names it lacks go to ``default_init``.
    ``Block.initialize(init=Load(...))`` matches the hierarchical
    ``collect_params`` names."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        if isinstance(param, str):
            from .ndarray import load as _load
            param = _load(param)
        if not isinstance(param, dict):
            raise MXNetError("Load expects a file name or a dict")
        self.param = {}
        for name, arr in param.items():
            key = name[4:] if name.startswith(("arg:", "aux:")) else name
            self.param[key] = arr
        self.default_init = (create(default_init)
                             if default_init is not None else None)
        self.verbose = verbose

    def init_array(self, name, shape, dtype, generator):
        key = str(name)
        if key in self.param:
            src = self.param[key]
            if tuple(shape) != tuple(src.shape):
                raise MXNetError(
                    f"Parameter {key} cannot be initialized from "
                    f"loading: shape {tuple(shape)} vs loaded "
                    f"{tuple(src.shape)}")
            if self.verbose:
                logging.info("Initialized %s by loading", key)
            return _as_tensor(src, dtype)
        if self.default_init is None:
            raise MXNetError(
                f"Cannot initialize {key}: not found in loaded params "
                f"and no default initializer provided")
        return self.default_init.init_array(name, shape, dtype, generator)


class Mixed:
    """The first initializer whose pattern matches the name
    (``re.match``) fills the array."""

    def __init__(self, patterns, initializers):
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise MXNetError(f"parameter {name} did not match any pattern")
