"""Decoder-only transformer LM (counterpart of
``mxnet_tpu/gluon/model_zoo/transformer.py``: ``MultiHeadAttention``,
``TransformerBlock``, ``TransformerLM``, ``get_transformer_lm``).

Attention runs through ``ops.attention.multi_head_attention``: with
``use_flash=True`` (the default) the flash-attention kernels K1 in the
forward and K2, K3 in the backward; with ``use_flash=False`` the dense
reference.  Sequence parallelism (the reference's ring / Ulysses
branches), ``generate`` and the ViT are not ported yet.
"""
from __future__ import annotations

from ... import initializer
from ...base import MXNetError
from ...ops import attention as attn_ops
from ...ops import tensor as tensor_ops
from .. import nn
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["MultiHeadAttention", "TransformerBlock", "TransformerLM",
           "get_transformer_lm"]


class MultiHeadAttention(HybridBlock):
    """Self-attention: one fused ``[q | k | v]`` projection (GQA-sized k
    and v), attention, and the output projection."""

    def __init__(self, units, num_heads, causal=False, use_flash=True,
                 num_kv_heads=None, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise MXNetError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {num_kv_heads}")
        self._units = units
        self._heads = num_heads
        self._kv_heads = num_kv_heads
        self._causal = causal
        self._flash = use_flash
        hkv = num_kv_heads if num_kv_heads is not None else num_heads
        self._kv_units = (units // num_heads) * hkv
        self.qkv = nn.Dense(units + 2 * self._kv_units, use_bias=True,
                            flatten=False)
        self.out_proj = nn.Dense(units, use_bias=True, flatten=False)

    def forward(self, x):
        qkv = self.qkv(x)
        u, kvu = self._units, self._kv_units
        q = qkv[..., :u]
        k = qkv[..., u:u + kvu]
        v = qkv[..., u + kvu:u + 2 * kvu]
        attn = attn_ops.multi_head_attention(
            q, k, v, num_heads=self._heads, causal=self._causal,
            use_flash=self._flash, num_kv_heads=self._kv_heads)
        return self.out_proj(attn)


class TransformerBlock(HybridBlock):
    """Pre-LN block: LN → attention → residual, LN → FFN (erf GELU) →
    residual."""

    def __init__(self, units, num_heads, ffn_ratio=4, causal=True,
                 dropout=0.0, use_flash=True, num_kv_heads=None, **kwargs):
        super().__init__(**kwargs)
        self.ln1 = nn.LayerNorm()
        self.attn = MultiHeadAttention(units, num_heads, causal=causal,
                                       use_flash=use_flash,
                                       num_kv_heads=num_kv_heads)
        self.ln2 = nn.LayerNorm()
        self.ffn1 = nn.Dense(ffn_ratio * units, flatten=False)
        self.act = nn.GELU()
        self.ffn2 = nn.Dense(units, flatten=False)
        self.drop = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        h = self.attn(self.ln1(x))
        if self.drop is not None:
            h = self.drop(h)
        x = x + h
        h = self.ffn2(self.act(self.ffn1(self.ln2(x))))
        if self.drop is not None:
            h = self.drop(h)
        return x + h


class TransformerLM(HybridBlock):
    """Decoder-only causal LM: (B, S) integer ids → logits (B, S, vocab).
    Learned positional embeddings; the output head optionally tied to
    the token embedding."""

    def __init__(self, vocab_size, units=256, num_layers=4, num_heads=4,
                 max_len=1024, ffn_ratio=4, dropout=0.0, tie_weights=False,
                 use_flash=True, num_kv_heads=None, **kwargs):
        super().__init__(**kwargs)
        self._max_len = max_len
        self.embed = nn.Embedding(vocab_size, units)
        self.pos_embed = Parameter(name="pos_embed", shape=(max_len, units),
                                   init=initializer.Normal(0.02))
        self.blocks = nn.HybridSequential()
        for _ in range(num_layers):
            self.blocks.add(TransformerBlock(
                units, num_heads, ffn_ratio=ffn_ratio, causal=True,
                dropout=dropout, use_flash=use_flash,
                num_kv_heads=num_kv_heads))
        self.ln_f = nn.LayerNorm()
        self._tied = tie_weights
        if not tie_weights:
            self.head = nn.Dense(vocab_size, use_bias=False, flatten=False)

    def forward(self, tokens):
        s_ = tokens.shape[-1]
        if s_ > self._max_len:
            raise MXNetError(f"sequence length {s_} exceeds max_len "
                             f"{self._max_len}")
        x = self.embed(tokens)
        x = x + self.pos_embed.data()[:s_].reshape(1, s_, -1)
        x = self.ln_f(self.blocks(x))
        if self._tied:
            w = self.embed.weight.data()
            return tensor_ops.dot(x.reshape(-1, x.shape[-1]), w,
                                  transpose_b=True).reshape(
                tuple(tokens.shape) + (w.shape[0],))
        return self.head(x)


def get_transformer_lm(vocab_size, units=256, num_layers=4, num_heads=4,
                       **kwargs) -> TransformerLM:
    """Factory (model-zoo style)."""
    return TransformerLM(vocab_size, units=units, num_layers=num_layers,
                         num_heads=num_heads, **kwargs)
