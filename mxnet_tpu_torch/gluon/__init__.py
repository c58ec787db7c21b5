"""Gluon, the imperative model API (counterpart of ``mxnet_tpu/gluon``):
``Block``/``HybridBlock`` as ``torch.nn.Module``s that take tensors or
NDArrays, ``Parameter`` with its gradient buffer, ``Trainer``, the
layers, losses and the model zoo."""
from . import loss, model_zoo, nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)
from .trainer import Trainer  # noqa: F401

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "Trainer", "nn", "loss",
           "model_zoo"]
