"""Decoder-only transformer LM (counterpart of
``mxnet_tpu/gluon/model_zoo/transformer.py``: ``MultiHeadAttention``,
``TransformerBlock``, ``TransformerLM``, ``get_transformer_lm``).

Attention runs through ``ops.attention.multi_head_attention``: with
``use_flash=True`` (the default) the flash-attention kernels K1 in the
forward and K2, K3 in the backward; with ``use_flash=False`` the dense
reference.

Sequence parallelism (``transformer.py:35-100``): given ``ring_mesh`` (a
mesh with an ``sp`` axis), attention runs context parallel over that
axis by ``sp_mode``: ``"ring"`` (K/V blocks rotate,
``parallel.ring_attention``), ``"ring_flash"`` (the same ring with K1–K3
as the block engine) or ``"ulysses"`` (two all-to-alls re-shard
sequence and heads, ``parallel.ulysses``; ``use_flash`` runs its local
attention on K1–K3).  Inside ``SPMDTrainer(seq_axis=1)`` the layer gets
this rank's sequence shard and runs the per-shard body; called on whole
sequences it shards them itself and gathers the output.
``TransformerBlock`` and ``TransformerLM`` pass ``ring_mesh`` and
``sp_mode`` to their attention layers, and the LM offsets its positions
by the rank's shard.

``VisionTransformer`` / ``get_vit`` (``transformer.py:326-377``): the
patch stem as a strided ``Conv2D``, the ``cls_token`` and ``pos_embed``
Parameters of the top-level block (named as the reference names them),
non-causal ``TransformerBlock`` s (K1–K3 at the ragged length of the
patches plus CLS: 197 at 224² and patch 16), the final LayerNorm and the
CLS head.  ``generate`` is not ported yet.
"""
from __future__ import annotations

import torch

from ... import initializer
from ...base import MXNetError
from ...ops import attention as attn_ops
from ...ops import tensor as tensor_ops
from ...parallel import tensor_parallel as _tp
from .. import nn
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["MultiHeadAttention", "TransformerBlock", "TransformerLM",
           "get_transformer_lm", "VisionTransformer", "get_vit"]


class MultiHeadAttention(HybridBlock):
    """Self-attention: one fused ``[q | k | v]`` projection (GQA-sized k
    and v), attention, and the output projection."""

    def __init__(self, units, num_heads, causal=False, use_flash=True,
                 num_kv_heads=None, ring_mesh=None, sp_mode="ring",
                 **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise MXNetError(f"units {units} not divisible by num_heads "
                             f"{num_heads}")
        if num_kv_heads is not None and num_heads % num_kv_heads:
            raise MXNetError(f"num_heads {num_heads} not divisible by "
                             f"num_kv_heads {num_kv_heads}")
        if sp_mode not in ("ring", "ring_flash", "ulysses"):
            raise MXNetError(
                f"sp_mode {sp_mode!r}: 'ring', 'ring_flash' or "
                f"'ulysses'")
        self._units = units
        self._heads = num_heads
        self._kv_heads = num_kv_heads
        self._causal = causal
        self._flash = use_flash
        self._ring_mesh = ring_mesh
        self._sp_mode = sp_mode
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
        if self._ring_mesh is not None:
            attn = self._ring_forward(q, k, v)
        else:
            attn = attn_ops.multi_head_attention(
                q, k, v, num_heads=self._heads, causal=self._causal,
                use_flash=self._flash, num_kv_heads=self._kv_heads)
        return self.out_proj(attn)

    def _ring_forward(self, q, k, v):
        """Context-parallel attention over ``ring_mesh``'s sp axis: the
        small (hkv-head) K/V enter the ring or the all-to-all."""
        from ... import parallel as par
        heads, mesh = self._heads, self._ring_mesh
        hkv = self._kv_heads if self._kv_heads is not None else heads
        kw = {}
        if self._sp_mode == "ulysses" and self._flash:
            kw["use_flash"] = True
        qh, kh, vh = (attn_ops.split_heads(q, heads),
                      attn_ops.split_heads(k, hkv),
                      attn_ops.split_heads(v, hkv))
        scope = _tp.active()
        if scope is not None and scope.seq_sharded:
            # the trainer sharded the sequence: the per-shard body
            body = {"ring": par.ring_attention,
                    "ring_flash": par.ring_flash_attention,
                    "ulysses": par.ulysses_attention}[self._sp_mode]
            out = body(qh, kh, vh, "sp", self._causal, mesh=mesh, **kw)
        else:
            whole = {"ring": par.ring_self_attention,
                     "ring_flash": par.ring_flash_self_attention,
                     "ulysses": par.ulysses_self_attention}[self._sp_mode]
            out = whole(qh, kh, vh, mesh, causal=self._causal, **kw)
        return attn_ops.merge_heads(out)


class TransformerBlock(HybridBlock):
    """Pre-LN block: LN → attention → residual, LN → FFN (erf GELU) →
    residual.  In a meshed step with ``ffn1`` column and ``ffn2`` row
    parallel over tp the FFN runs as Megatron's pair
    (``tensor_parallel.paired``): the hidden activation stays sharded."""

    def __init__(self, units, num_heads, ffn_ratio=4, causal=True,
                 dropout=0.0, use_flash=True, num_kv_heads=None,
                 ring_mesh=None, sp_mode="ring", **kwargs):
        super().__init__(**kwargs)
        self.ln1 = nn.LayerNorm()
        self.attn = MultiHeadAttention(units, num_heads, causal=causal,
                                       use_flash=use_flash,
                                       num_kv_heads=num_kv_heads,
                                       ring_mesh=ring_mesh, sp_mode=sp_mode)
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
        h = self.ln2(x)
        with _tp.paired(self.ffn1, self.ffn2):
            h = self.ffn2(self.act(self.ffn1(h)))
        if self.drop is not None:
            h = self.drop(h)
        return x + h


class TransformerLM(HybridBlock):
    """Decoder-only causal LM: (B, S) integer ids → logits (B, S, vocab).
    Learned positional embeddings; the output head optionally tied to
    the token embedding."""

    def __init__(self, vocab_size, units=256, num_layers=4, num_heads=4,
                 max_len=1024, ffn_ratio=4, dropout=0.0, tie_weights=False,
                 use_flash=True, num_kv_heads=None, ring_mesh=None,
                 sp_mode="ring", **kwargs):
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
                num_kv_heads=num_kv_heads, ring_mesh=ring_mesh,
                sp_mode=sp_mode))
        self.ln_f = nn.LayerNorm()
        self._tied = tie_weights
        if not tie_weights:
            self.head = nn.Dense(vocab_size, use_bias=False, flatten=False)

    def forward(self, tokens):
        s_ = tokens.shape[-1]
        # this rank's shard of a sequence sharded over sp
        off, total = _tp.seq_offset(s_)
        if total > self._max_len:
            raise MXNetError(f"sequence length {total} exceeds max_len "
                             f"{self._max_len}")
        x = self.embed(tokens)
        x = x + self.pos_embed._tensor()[off:off + s_].reshape(1, s_, -1)
        x = self.ln_f(self.blocks(x))
        if self._tied:
            w = self.embed.weight._tensor()
            return tensor_ops.dot(x.reshape(-1, x.shape[-1]), w,
                                  transpose_b=True).reshape(
                tuple(tokens.shape) + (w.shape[0],))
        return self.head(x)


def get_transformer_lm(vocab_size, units=256, num_layers=4, num_heads=4,
                       **kwargs) -> TransformerLM:
    """Factory (model-zoo style)."""
    return TransformerLM(vocab_size, units=units, num_layers=num_layers,
                         num_heads=num_heads, **kwargs)


class VisionTransformer(HybridBlock):
    """ViT classifier: (B, C, H, W) images → (B, classes) logits.  The
    patch embedding is a strided convolution; a learned CLS token leads
    the patch tokens, learned positions are added, and the encoder's
    non-causal blocks attend over all of them.  ``use_flash=False``
    takes the dense attention (the comparison the card's checks make)."""

    def __init__(self, image_size=224, patch_size=16, classes=1000,
                 units=384, num_layers=6, num_heads=6, ffn_ratio=4,
                 dropout=0.0, in_channels=3, use_flash=True, **kwargs):
        super().__init__(**kwargs)
        if image_size % patch_size:
            raise MXNetError("image_size must be divisible by patch_size")
        self._patch = patch_size
        self._np = (image_size // patch_size) ** 2
        self.patch_embed = nn.Conv2D(units, kernel_size=patch_size,
                                     strides=patch_size,
                                     in_channels=in_channels)
        self.cls_token = Parameter(name="cls_token", shape=(1, 1, units),
                                   init=initializer.Normal(0.02))
        self.pos_embed = Parameter(name="pos_embed",
                                   shape=(1, self._np + 1, units),
                                   init=initializer.Normal(0.02))
        self.blocks = nn.HybridSequential()
        for _ in range(num_layers):
            self.blocks.add(TransformerBlock(units, num_heads,
                                             ffn_ratio=ffn_ratio,
                                             causal=False, dropout=dropout,
                                             use_flash=use_flash))
        self.ln = nn.LayerNorm()
        self.head = nn.Dense(classes)

    def forward(self, x):
        p = self.patch_embed(x)                         # (B, E, H', W')
        b, e = p.shape[0], p.shape[1]
        tokens = p.reshape(b, e, -1).transpose(1, 2)    # (B, N, E)
        cls = self.cls_token._tensor().to(tokens.dtype).expand(b, 1, e)
        tokens = torch.cat([cls, tokens], dim=1)
        tokens = tokens + self.pos_embed._tensor().to(tokens.dtype)
        tokens = self.ln(self.blocks(tokens))
        return self.head(tokens[:, 0])


def get_vit(image_size=224, patch_size=16, classes=1000,
            **kwargs) -> VisionTransformer:
    """Factory (model-zoo style).  ViT-B/16 is ``get_vit(224, 16, 1000,
    units=768, num_layers=12, num_heads=12, ffn_ratio=4)``."""
    return VisionTransformer(image_size=image_size, patch_size=patch_size,
                             classes=classes, **kwargs)
