"""Gluon, the imperative model API (counterpart of ``mxnet_tpu/gluon``):
``Block``/``HybridBlock`` as ``torch.nn.Module``s, ``Parameter``, the
layers, losses and the transformer LM of the training slice."""
from . import loss, model_zoo, nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (DeferredInitializationError,  # noqa: F401
                        Parameter, ParameterDict)

__all__ = ["Block", "HybridBlock", "Parameter", "ParameterDict",
           "DeferredInitializationError", "nn", "loss", "model_zoo"]
