"""Ulysses sequence parallelism: all-to-all context parallelism
(counterpart of ``mxnet_tpu/parallel/ulysses.py``).

Each rank holds a sequence shard of Q/K/V (B, H, S/P, D).  One
``all_to_all_single`` on the axis's group re-shards them from sequence
to heads: afterwards every rank holds the whole sequence for H/P of the
heads and runs ordinary attention locally (the dense
``attention_reference``, or with ``use_flash`` the flash kernels K1–K3);
a second all-to-all restores the sequence sharding of the output.  Q, K
and V of one shape go through the first all-to-all together, so a layer
makes two calls.  The gradient of an all-to-all is the all-to-all back
(:func:`.collectives.all_to_all`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.attention import attention_reference
from . import collectives as comm
from .ring_attention import _axis_of, seq_shard_call

__all__ = ["ulysses_attention", "ulysses_self_attention"]


def _seq_to_heads(x, ax):
    """(T, B, H, S/P, D) → (T, B, H/P, S, D): the head axis split over
    the ranks, the sequence axis concatenated."""
    t, b, h, s_loc, d = x.shape
    p = ax.size
    x = x.reshape(t, b, p, h // p, s_loc, d).permute(2, 0, 1, 3, 4, 5)
    x = comm.all_to_all(x.contiguous(), ax)       # dim 0: source rank
    return x.permute(1, 2, 3, 0, 4, 5).reshape(t, b, h // p, p * s_loc, d)


def _heads_to_seq(x, ax):
    """(B, H/P, S, D) → (B, H, S/P, D)."""
    b, hp, s, d = x.shape
    p = ax.size
    x = x.reshape(b, hp, p, s // p, d).permute(2, 0, 1, 3, 4)
    x = comm.all_to_all(x.contiguous(), ax)       # dim 0: source rank
    return x.permute(1, 0, 2, 3, 4).reshape(b, p * hp, s // p, d)


def ulysses_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                      sm_scale: Optional[float] = None,
                      use_flash: bool = False, *, mesh=None):
    """Per-shard Ulysses body.

    q: (B, H, S_local, D); k, v: (B, Hkv, S_local, D): this rank's
    sequence shard.  Q heads must divide by the axis size.  GQA K/V whose
    head count divides the axis ride the all-to-all small and are
    repeated locally afterwards; a head count that does not divide is
    repeated first (full traffic)."""
    ax = _axis_of(mesh, axis_name)
    p = ax.size
    b, h, s_loc, d = q.shape
    if h % p:
        raise ValueError(
            f"ulysses: num_heads {h} not divisible by axis size {p}")
    hkv = k.shape[1]
    if hkv <= 0 or h % hkv:
        raise ValueError(f"ulysses: q heads ({h}) not divisible by kv "
                         f"heads ({hkv})")
    group = h // hkv
    if hkv % p:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
        group = 1
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if comm.live(ax) and k.shape == q.shape:
        qh, kh, vh = _seq_to_heads(torch.stack((q, k, v)), ax).unbind(0)
    elif comm.live(ax):
        qh = _seq_to_heads(q[None], ax)[0]
        kh, vh = _seq_to_heads(torch.stack((k, v)), ax).unbind(0)
    else:
        qh, kh, vh = q, k, v
    if group > 1:
        # rank i's kv heads [i·hkv/p, (i+1)·hkv/p) are the groups its q
        # heads [i·h/p, (i+1)·h/p) read, so a local repeat aligns them
        kh = torch.repeat_interleave(kh, group, dim=1)
        vh = torch.repeat_interleave(vh, group, dim=1)
    if use_flash:
        from ..ops.attention import flash_attention
        out = flash_attention(qh, kh, vh, causal=causal, sm_scale=scale)
    else:
        out = attention_reference(qh, kh, vh, causal=causal, sm_scale=scale)
    return _heads_to_seq(out, ax) if comm.live(ax) else out


def ulysses_self_attention(q, k, v, mesh, axis_name: str = "sp",
                           causal: bool = False,
                           sm_scale: Optional[float] = None,
                           use_flash: bool = False):
    """:func:`ulysses_attention` on whole (B, H, S, D) tensors
    (``ring_attention.seq_shard_call``)."""
    def body(qq, kk, vv):
        return ulysses_attention(qq, kk, vv, axis_name, causal, sm_scale,
                                 use_flash, mesh=mesh)
    return seq_shard_call(body, mesh, axis_name, q, k, v)
