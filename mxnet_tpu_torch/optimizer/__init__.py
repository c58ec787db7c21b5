"""Optimizers (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import Adam, Optimizer, SGD, create, register  # noqa: F401

__all__ = ["Optimizer", "SGD", "Adam", "create", "register"]
