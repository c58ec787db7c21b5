"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``):
``Xavier``, ``Normal``, ``Uniform``, ``Zero``, ``One`` and ``create``.

Values are drawn on the host from an explicit ``torch.Generator`` (the
caller's, or one seeded with 0) and then moved to the parameter's
device, so one seed gives the same weights on the CPU and on the card.
They are not the reference's numbers (JAX's PRNG differs); the tests
carry weights across with ``convert.load_collected_params``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .base import MXNetError

__all__ = ["Initializer", "register", "create", "Zero", "One", "Constant",
           "Uniform", "Normal", "Xavier"]

_REGISTRY: Dict[str, type] = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(initializer, **kwargs) -> "Initializer":
    """``None`` → ``Uniform()``; an instance passes through; a name
    (``"xavier"``, ``"zeros"``, ...) builds one with ``kwargs``."""
    if initializer is None:
        return Uniform()
    if isinstance(initializer, Initializer):
        return initializer
    if isinstance(initializer, str):
        name = initializer.lower()
        if name not in _REGISTRY:
            raise MXNetError(f"unknown initializer {initializer!r}")
        return _REGISTRY[name](**kwargs)
    raise MXNetError(f"cannot create initializer from {initializer!r}")


class Initializer:
    """Base initializer.  ``init_array`` dispatches on the parameter's
    name as the reference does: ``gamma`` → ones, ``beta``/``bias`` →
    zeros, anything else → ``_init_weight``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def init_array(self, name: str, shape, dtype,
                   generator: torch.Generator) -> torch.Tensor:
        name = str(name)
        if "gamma" in name:
            return torch.ones(shape, dtype=dtype)
        if name.endswith("beta") or name.endswith("bias"):
            return torch.zeros(shape, dtype=dtype)
        return self._init_weight(name, tuple(shape), dtype, generator)

    def _init_weight(self, name, shape, dtype, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


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
