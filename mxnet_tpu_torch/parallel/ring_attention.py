"""Ring attention: sequence / context parallelism over a mesh axis
(counterpart of ``mxnet_tpu/parallel/ring_attention.py``).

Each rank holds a sequence shard of Q, K and V.  The K/V shards rotate
around the axis's ring (:func:`.collectives.ppermute`: one
``batch_isend_irecv`` to the next rank and from the previous one, the
port's ``lax.ppermute``) while every rank folds the visiting block into
its own queries' accumulators.

Two bodies, as in the reference:

* :func:`ring_attention` keeps online-softmax accumulators (o, m, l) in
  f32; its ``torch.autograd.Function`` backward runs the ring again
  with the final log-sum-exp, as the reference's autodiff through
  ``lax.scan`` does.  Causal blocks above the diagonal are skipped: the
  rank knows its index and the ring step on the host, which the
  reference decides with ``lax.cond``.  Both bodies make every rotation
  on every rank, in one order, whichever blocks a rank skips (autograd
  left to itself would prune a rotation whose output a rank does not
  read, and its neighbours would wait for it).
* :func:`ring_flash_attention` runs each visiting block through the
  flash kernel K1 (``ops.attention.flash_fwd``: causal on the diagonal
  block, non-causal below it, nothing above), which returns the block's
  output and log-sum-exp, and merges the partial outputs in log-sum-exp
  space (:func:`_merge_lse`).  Its ``torch.autograd.Function`` backward
  runs the ring again with the final LSE and delta (rowsum(dO∘O) of the
  global output), K2 (``flash_bwd_dkdv``) and K3 (``flash_bwd_dq``) per
  block; dK and dV ride the rotating K/V buffers home.  A ring of one
  shard is flash attention itself: one K1 call, K2 and K3 in the
  backward, nothing merged or accumulated in f32.  On a CUDA tensor
  each block launches the kernels (or raises); CPU tensors take their
  plain versions (``flash_forward_reference`` /
  ``flash_backward_reference``'s parts).

A body is called on the local shards: inside ``SPMDTrainer(seq_axis=)``
with the sequence already sharded, or with ``mesh=``.  The
``*_self_attention`` wrappers take the whole (B, H, S, D) tensors (the
same on every rank, as a single-controller program has them), keep this
rank's sequence shard, run the body and gather the output
(:func:`seq_shard_call`: the reference's ``shard_map``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..base import MXNetError
from ..ops import attention as attn_ops
from . import collectives as comm

__all__ = ["ring_attention", "ring_self_attention", "ring_flash_attention",
           "ring_flash_self_attention", "seq_shard_call"]

_NEG_INF = attn_ops._NEG_INF


def _axis_of(mesh, axis_name):
    """The ring's axis: ``mesh``'s, else the mesh of the trainer step
    running this forward."""
    if mesh is None:
        from . import tensor_parallel as _tp
        scope = _tp.active()
        mesh = scope.mesh if scope is not None else None
    if mesh is None:
        raise MXNetError(
            f"the ring body runs on a sequence shard of a mesh axis: pass "
            f"mesh=, or call it inside SPMDTrainer(seq_axis=...)")
    if axis_name not in mesh.shape:
        raise MXNetError(f"mesh {mesh.shape} has no axis {axis_name!r}")
    return mesh.axis(axis_name)


def seq_shard_call(body, mesh, axis_name, q, k, v):
    """Run ``body(q, k, v)`` on this rank's shard of the S axis of (B, H,
    S, D) tensors and return the whole output, on every rank.  The
    slice's backward gathers the inputs' gradients and the gather's
    backward keeps this rank's slice, so each rank holds the whole
    gradient of a loss every rank computes alike."""
    ax = mesh.axis(axis_name)
    n = ax.size
    for t in (q, k, v):
        if t.shape[2] % n:
            raise MXNetError(f"sequence length {t.shape[2]} not divisible "
                             f"by the {axis_name} axis size {n}")
    ql, kl, vl = (comm.scatter_to(t, ax, 2) for t in (q, k, v))
    return comm.gather_from(body(ql, kl, vl), ax, 2)


def ring_attention(q, k, v, axis_name: str = "sp", causal: bool = False,
                   sm_scale: Optional[float] = None, *, mesh=None):
    """Per-shard ring attention body.

    q: (B, H, S_local, D); k, v: (B, Hkv, S_local, D): this rank's
    sequence shard.  GQA/MQA: with Hkv < H the small K/V blocks rotate
    and are repeated for the query groups only at each block update.
    Returns the local output shard (B, H, S_local, D)."""
    ax = _axis_of(mesh, axis_name)
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if hkv <= 0 or h % hkv:
        raise ValueError(f"q heads ({h}) not divisible by kv heads "
                         f"({hkv})")
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    return _Ring.apply(q, k, v, ax, bool(causal), scale)


def _block_mask(ax, t, sq, sk, causal, device):
    """``(contributes, mask)`` of ring step ``t``'s block: the causal
    mask over global positions (None when not causal); a causal block
    strictly above the diagonal contributes nothing."""
    n, my = ax.size, ax.index
    kv_idx = (my - t) % n
    if not causal:
        return True, None
    if kv_idx > my:
        return False, None
    qpos = my * sq + torch.arange(sq, device=device)[:, None]
    kpos = kv_idx * sk + torch.arange(sk, device=device)[None]
    return True, qpos >= kpos


class _Ring(torch.autograd.Function):
    """The plain ring: online-softmax accumulators in f32 in the forward;
    the backward runs the ring again with the final log-sum-exp (the
    gradient the reference's autodiff through ``lax.scan`` takes), dK
    and dV riding home with their shards.  Every rank makes every
    rotation, in the same order, whichever blocks it skips: its
    neighbours wait for them."""

    @staticmethod
    def forward(ctx, q, k, v, ax, causal, scale):
        n = ax.size
        b, h, sq, d = q.shape
        group = h // k.shape[1]
        q32 = q.float()
        o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, sq, 1), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, sq, 1), dtype=torch.float32, device=q.device)
        kc, vc = k.float(), v.float()
        for t in range(n):
            live, mask = _block_mask(ax, t, sq, k.shape[2], causal, q.device)
            if live:
                o, m, l = _online_block_update(
                    o, m, l, q32, _expand(kc, group), _expand(vc, group),
                    scale, mask)
            if t + 1 < n:
                kc, vc = comm.ppermute(kc, ax), comm.ppermute(vc, ax)
        l = torch.where(l == 0.0, 1.0, l)
        out = (o / l).to(q.dtype)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.ax, ctx.causal, ctx.scale = ax, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ax, n, scale = ctx.ax, ctx.ax.size, ctx.scale
        b, h, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        group = h // hkv
        q32, do32 = q.float(), do.float()
        delta = (do32 * out.float()).sum(dim=-1, keepdim=True)
        dq = torch.zeros_like(q32)
        kc, vc = k.float(), v.float()
        dkc = torch.zeros_like(kc)
        dvc = torch.zeros_like(vc)
        for t in range(n):
            live, mask = _block_mask(ax, t, sq, sk, ctx.causal, q.device)
            if live:
                ke, ve = _expand(kc, group), _expand(vc, group)
                p = torch.exp(torch.matmul(q32, ke.transpose(-1, -2))
                              * scale - lse)
                if mask is not None:
                    p = torch.where(mask, p, 0.0)
                ds = p * (torch.matmul(do32, ve.transpose(-1, -2)) - delta)
                dq = dq + torch.matmul(ds, ke) * scale
                dkc = dkc + _fold(torch.matmul(ds.transpose(-1, -2), q32)
                                  * scale, group)
                dvc = dvc + _fold(torch.matmul(p.transpose(-1, -2), do32),
                                  group)
            if n > 1:
                if t + 1 < n:
                    kc, vc = comm.ppermute(kc, ax), comm.ppermute(vc, ax)
                dkc, dvc = comm.ppermute(dkc, ax), comm.ppermute(dvc, ax)
        return (dq.to(q.dtype), dkc.to(k.dtype), dvc.to(v.dtype), None,
                None, None)


def _expand(x, group):
    return torch.repeat_interleave(x, group, 1) if group > 1 else x


def _fold(x, group):
    """The gradient of ``_expand``: the query groups' sum per kv head."""
    if group == 1:
        return x
    b, h, s, d = x.shape
    return x.reshape(b, h // group, group, s, d).sum(dim=2)


def _online_block_update(o, m, l, q, k, v, scale, mask=None):
    """One flash/ring accumulator update with a new K/V block (the
    reference's ``ops.attention.online_block_update``)."""
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    corr = torch.exp(m - m_cur)
    p = torch.exp(s - m_cur)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    o_new = o * corr + torch.matmul(p, v.float())
    return o_new, m_cur, l_new


# -- ring FLASH attention: K1 blocks, K2/K3 backward ----------------------------

def _merge_lse(o, lse, ob, lseb):
    """Combine two normalized partial attentions in log-sum-exp space."""
    new = torch.logaddexp(lse, lseb)
    w1 = torch.exp(lse - new)[..., None]
    w2 = torch.exp(lseb - new)[..., None]
    return o * w1 + ob.to(o.dtype) * w2, new


def _block_causal(n, my, t, causal):
    """Whether ring step ``t``'s block of rank ``my`` is causal (the
    diagonal), or None when it contributes nothing (a causal ring skips
    the shards above the diagonal)."""
    kv_idx = (my - t) % n
    if causal and kv_idx > my:
        return None
    return bool(causal and kv_idx == my)


class _MeshRing:
    """The ring over a mesh axis: this process is one rank of it, and a
    shift is a ``ppermute`` to the next rank."""

    def __init__(self, ax):
        self.ax, self.size, self.ranks = ax, ax.size, (ax.index,)

    def shift(self, xs):
        return [comm.ppermute(x, self.ax) for x in xs]


class _FoldedRing:
    """All ``n`` ranks of a ring held by one process (one device): a
    shift hands each rank's tensor to the next, a local index."""

    def __init__(self, n):
        self.size, self.ranks = n, tuple(range(n))

    def shift(self, xs):
        return xs[-1:] + xs[:-1]


def _ring_flash_forward(qs, ks, vs, ring, causal, scale, tile):
    """The ring-flash forward of each rank ``ring`` holds (lists in
    ``ring.ranks`` order): ``(outs, lses)``.  Each visiting block runs
    K1 and merges in log-sum-exp space; the first block's (o, lse) stay
    in their own dtype and are promoted to f32 only when a second block
    merges, so a ring of one shard is flash attention itself."""
    n, kw = ring.size, dict(sm_scale=scale, tile=tile)
    o, lse = [None] * len(qs), [None] * len(qs)
    kc, vc = list(ks), list(vs)
    for t in range(n):
        for i, my in enumerate(ring.ranks):
            blk = _block_causal(n, my, t, causal)
            if blk is None:
                continue
            ob, lb = attn_ops.flash_fwd(qs[i], kc[i], vc[i], causal=blk,
                                        **kw)
            if o[i] is None:             # merging into (0, -inf) is exact
                o[i], lse[i] = ob, lb
            else:
                o[i], lse[i] = _merge_lse(o[i].float(), lse[i], ob, lb)
        if t + 1 < n:
            kc, vc = ring.shift(kc), ring.shift(vc)
    return [x.to(q.dtype) for x, q in zip(o, qs)], lse


def _ring_flash_backward(qs, ks, vs, dos, outs, lses, ring, causal, scale,
                         tile):
    """The ring-flash backward of each rank ``ring`` holds: ``(dqs, dks,
    dvs)``.  Each block runs K2 and K3 with the global LSE and delta
    (rowsum(dO∘O) of the global output); dK and dV accumulate in f32
    buffers that ride home with their rotating shards (n hops in all).
    In a ring of one shard they are the one block's results."""
    n, kw = ring.size, dict(sm_scale=scale, tile=tile)
    deltas = [attn_ops._delta(do, out) for do, out in zip(dos, outs)]
    kc, vc = list(ks), list(vs)
    dq = [None] * len(qs)
    if n == 1:
        dkc, dvc = [None] * len(ks), [None] * len(vs)
    else:
        dkc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
               for k in ks]
        dvc = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
               for v in vs]
    for t in range(n):
        for i, my in enumerate(ring.ranks):
            blk = _block_causal(n, my, t, causal)
            if blk is None:
                continue
            args = (qs[i], kc[i], vc[i], dos[i], lses[i], deltas[i])
            dkb, dvb = attn_ops.flash_bwd_dkdv(*args, causal=blk, **kw)
            dqb = attn_ops.flash_bwd_dq(*args, causal=blk, **kw)
            dq[i] = dqb if dq[i] is None else dq[i].float() + dqb.float()
            dkc[i] = dkb if dkc[i] is None else dkc[i] + dkb.float()
            dvc[i] = dvb if dvc[i] is None else dvc[i] + dvb.float()
        if t + 1 < n:
            kc, vc = ring.shift(kc), ring.shift(vc)
        dkc, dvc = ring.shift(dkc), ring.shift(dvc)
    return ([x.to(q.dtype) for x, q in zip(dq, qs)],
            [x.to(k.dtype) for x, k in zip(dkc, ks)],
            [x.to(v.dtype) for x, v in zip(dvc, vs)])


class _RingFlash(torch.autograd.Function):
    """Ring flash attention on (BH, S_local, D) shards, this rank's."""

    @staticmethod
    def forward(ctx, q, k, v, ax, causal, scale, tile):
        (out,), (lse,) = _ring_flash_forward(
            [q], [k], [v], _MeshRing(ax), causal, scale, tile)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ax, ctx.causal, ctx.scale, ctx.tile = ax, causal, scale, tile
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        (dq,), (dk,), (dv,) = _ring_flash_backward(
            [q], [k], [v], [do.contiguous()], [out], [lse],
            _MeshRing(ctx.ax), ctx.causal, ctx.scale, ctx.tile)
        return dq, dk, dv, None, None, None, None


def ring_flash_fold(q, k, v, n, causal=False, sm_scale=None, tile=None,
                    do=None):
    """The ring-flash body of an ``n``-rank ring, every rank held on this
    one device (the rotation a local index): on (BH, S, D) tensors cut
    into ``n`` sequence shards, ``(out, lse)`` and, given the output
    gradient ``do``, ``(out, lse, dq, dk, dv)``, the shards concatenated.
    The same blocks, merges and accumulators as a ring of ``n``
    processes, with the same kernel launches; a device check of that
    path, which one card cannot run as ``n`` ranks.  ``tile`` defaults
    to the kernel registry's config for the shard's shape."""
    s = q.shape[1]
    if s % n or k.shape[1] != s:
        raise MXNetError(f"ring_flash_fold: q/k length {s}/{k.shape[1]} "
                         f"must be equal and divisible by {n}")
    scale = float(sm_scale if sm_scale is not None
                  else 1.0 / math.sqrt(q.shape[-1]))
    qs, ks, vs = ([x.contiguous() for x in t.chunk(n, dim=1)]
                  for t in (q, k, v))
    if tile is None:
        tile = 64
        if q.device.type != "cpu":
            tile = attn_ops._resolve_tile(qs[0], ks[0], vs[0], bool(causal),
                                          scale, None, None)
    ring = _FoldedRing(n)
    outs, lses = _ring_flash_forward(qs, ks, vs, ring, bool(causal), scale,
                                     tile)
    res = (torch.cat(outs, dim=1), torch.cat(lses, dim=1))
    if do is None:
        return res
    dos = [x.contiguous() for x in do.chunk(n, dim=1)]
    grads = _ring_flash_backward(qs, ks, vs, dos, outs, lses, ring,
                                 bool(causal), scale, tile)
    return res + tuple(torch.cat(g, dim=1) for g in grads)


def ring_flash_attention(q, k, v, axis_name: str = "sp",
                         causal: bool = False,
                         sm_scale: Optional[float] = None,
                         block_q: Optional[int] = None,
                         block_k: Optional[int] = None, *, mesh=None):
    """Per-shard ring attention with the flash kernels as the local block
    engine.  Same contract as :func:`ring_attention` for equal q/k shard
    lengths (GQA K/V are repeated to the query head count first); causal
    mode needs sq == sk per shard.  ``block_q``/``block_k`` pick the
    kernels' square tile on CUDA (equal, 32 or 64), as in
    ``ops.attention.flash_attention``; left out, the kernel registry's
    config for the shape."""
    ax = _axis_of(mesh, axis_name)
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if hkv <= 0 or h % hkv:
        raise ValueError(f"q heads ({h}) not divisible by kv heads "
                         f"({hkv})")
    if causal and sq != k.shape[2]:
        raise ValueError(
            f"ring_flash_attention(causal=True) needs equal per-shard "
            f"q/k lengths (got {sq} vs {k.shape[2]}); ring_attention "
            f"handles causal cross-attention over unequal shards")
    if hkv != h:
        k = torch.repeat_interleave(k, h // hkv, dim=1)
        v = torch.repeat_interleave(v, h // hkv, dim=1)
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    sk = k.shape[2]
    qf = q.reshape(b * h, sq, d).contiguous()
    kf = k.reshape(b * h, sk, d).contiguous()
    vf = v.reshape(b * h, sk, d).contiguous()
    tile = 64
    if q.device.type != "cpu":
        tile = attn_ops._resolve_tile(qf, kf, vf, bool(causal), scale,
                                      block_q, block_k)
    out = _RingFlash.apply(qf, kf, vf, ax, bool(causal), scale, tile)
    return out.reshape(b, h, sq, d)


def ring_flash_self_attention(q, k, v, mesh, axis_name: str = "sp",
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              block_q: Optional[int] = None,
                              block_k: Optional[int] = None):
    """:func:`ring_flash_attention` on whole (B, H, S, D) tensors
    (:func:`seq_shard_call`)."""
    def body(qq, kk, vv):
        return ring_flash_attention(qq, kk, vv, axis_name, causal, sm_scale,
                                    block_q, block_k, mesh=mesh)
    return seq_shard_call(body, mesh, axis_name, q, k, v)


def ring_self_attention(q, k, v, mesh, axis_name: str = "sp",
                        causal: bool = False,
                        sm_scale: Optional[float] = None):
    """:func:`ring_attention` on whole (B, H, S, D) tensors
    (:func:`seq_shard_call`)."""
    def body(qq, kk, vv):
        return ring_attention(qq, kk, vv, axis_name, causal, sm_scale,
                              mesh=mesh)
    return seq_shard_call(body, mesh, axis_name, q, k, v)
