"""Model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``): the vision
zoo, and the transformer family — the LM and the ViT."""
from . import vision  # noqa: F401
from . import transformer  # noqa: F401
from .transformer import (MultiHeadAttention, TransformerBlock,  # noqa: F401
                          TransformerLM, get_transformer_lm,
                          VisionTransformer, get_vit)
from .vision import get_model  # noqa: F401

__all__ = ["vision", "get_model", "transformer", "MultiHeadAttention",
           "TransformerBlock", "TransformerLM", "get_transformer_lm",
           "VisionTransformer", "get_vit"]
