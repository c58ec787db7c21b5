"""Gluon layers (counterpart of ``mxnet_tpu/gluon/nn``)."""
from .basic_layers import (Dense, Dropout, Embedding, GELU,  # noqa: F401
                           HybridSequential, LayerNorm)

__all__ = ["HybridSequential", "Dense", "Dropout", "Embedding",
           "LayerNorm", "GELU"]
