"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the vision
zoo's ResNets and the transformer LM of the training slice."""
from . import vision  # noqa: F401
from .transformer import (MultiHeadAttention, TransformerBlock,  # noqa: F401
                          TransformerLM, get_transformer_lm)
from .vision import get_model  # noqa: F401

__all__ = ["vision", "get_model", "MultiHeadAttention", "TransformerBlock",
           "TransformerLM", "get_transformer_lm"]
