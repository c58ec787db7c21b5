"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import Adam, Optimizer, create, register  # noqa: F401

__all__ = ["Optimizer", "Adam", "create", "register"]
