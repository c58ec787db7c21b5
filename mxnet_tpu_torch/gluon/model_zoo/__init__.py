"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the
transformer LM of the training slice."""
from .transformer import (MultiHeadAttention, TransformerBlock,  # noqa: F401
                          TransformerLM, get_transformer_lm)

__all__ = ["MultiHeadAttention", "TransformerBlock", "TransformerLM",
           "get_transformer_lm"]
