"""Collectives over one mesh axis, with their gradients.

GSPMD inserts the reference's collectives where a sharding demands one;
the port calls them by hand, on the axis's process group
(:meth:`Mesh.axis`).  Each function takes an ``_Axis`` (or None) and is
an identity on an axis of size 1 or None: as XLA elides a collective
over one device, so does the port, and a mesh of size 1 runs exactly
the unmeshed arithmetic.

The differentiable ones are ``torch.autograd.Function`` pairs:

=================  =============================  ==========================
function           forward                        backward
=================  =============================  ==========================
``copy_to``        identity                       all-reduce (sum)
``reduce_from``    all-reduce (sum)               identity
``gather_from``    all-gather along ``dim``       this rank's slice
``scatter_to``     this rank's slice of ``dim``   all-gather along ``dim``
``gather_sum``     all-gather along ``dim``       reduce-scatter (sum)
``all_to_all``     all-to-all of dim-0 chunks     all-to-all back
``ppermute``       send to index+shift, receive   the reverse rotation
``all_reduce``     all-reduce (sum)               all-reduce (sum)
=================  =============================  ==========================

``copy_to``/``reduce_from``/``gather_from``/``scatter_to`` are the
tensor-parallel pairs, where every rank of the axis computes the same
thing outside the sharded matmul; ``gather_sum`` gathers a parameter
sharded over an axis whose ranks see different data (ZeRO-3 over dp),
so the gradient of each shard sums the ranks' contributions.

The batch statistics of a batch split over ranks (cross-rank BatchNorm,
``ops.nn.sync_batch_norm``) are summed by a reducer: :class:`BatchReducer`
all-reduces over every axis that splits the batch, :class:`FoldedReducer`
sums the shards one process holds stacked on a leading axis (every rank
of the mesh on one device).  The normalisation calls it itself, in its
forward and in its backward: ``reduce_from`` would be wrong there, its
identity backward assumes every rank receives the same upstream
gradient, and each dp rank's comes from its own part of the batch.

:func:`tally` counts the bytes each call moves per axis while it is
open (a trainer opens it around a signature's first run to learn the
collectives of its step).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch
import torch.distributed as dist

__all__ = ["live", "all_reduce_", "copy_to", "reduce_from", "gather_from",
           "scatter_to", "gather_sum", "all_to_all", "ppermute",
           "all_reduce", "reduce_scatter_flat", "all_gather_flat",
           "flat_chunk", "tally", "BatchReducer", "FoldedReducer"]

_tallies = []
_lock = threading.Lock()
# the names newer PyTorch gives the single-tensor forms
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def live(axis) -> bool:
    """True when ``axis`` has more than one rank."""
    return axis is not None and axis.size > 1


@contextlib.contextmanager
def tally():
    """Count ``{axis name: bytes}`` moved by the collectives called inside
    the block, on any thread (autograd may run a backward on its own)."""
    counts: Dict[str, int] = {}
    with _lock:
        _tallies.append(counts)
    try:
        yield counts
    finally:
        with _lock:
            _tallies.remove(counts)


def _count(axis, nbytes: int) -> None:
    if _tallies:
        with _lock:
            for counts in _tallies:
                counts[axis.name] = counts.get(axis.name, 0) + int(nbytes)


def all_reduce_(t: torch.Tensor, axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce over ``axis`` (no gradient)."""
    if live(axis):
        _count(axis, t.nbytes)
        dist.all_reduce(t, op=op, group=axis.group)
    return t


def _gather(x, axis, dim):
    x = x.contiguous()
    out = torch.empty((axis.size * x.numel(),), dtype=x.dtype,
                      device=x.device)
    _count(axis, x.nbytes)
    _all_gather(out, x.reshape(-1), group=axis.group)
    out = out.view((axis.size,) + tuple(x.shape))
    if dim == 0:
        return out.reshape((-1,) + tuple(x.shape[1:]))
    return torch.cat(out.unbind(0), dim=dim)


def _slice(x, axis, dim):
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.index * n, n).contiguous()


def flat_chunk(x, axis):
    """This rank's chunk of ``x`` flattened and zero-padded to a multiple
    of the axis size: the ZeRO layout of an optimizer state, shared by
    ``SPMDTrainer`` and the gluon Trainer's sharded update.  A view of
    ``x`` when nothing is padded (``x`` contiguous)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % axis.size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    n = flat.numel() // axis.size
    return flat.narrow(0, axis.index * n, n)


def all_gather_flat(x, axis):
    """``x`` (a flat chunk) all-gathered into one flat tensor, rank order
    (no gradient)."""
    if not live(axis):
        return x
    return _gather(x, axis, 0)


def reduce_scatter_flat(x, axis):
    """The sum over ``axis`` of flat ``x``, this rank's equal chunk of it
    (no gradient)."""
    if not live(axis):
        return x
    x = x.contiguous()
    out = torch.empty((x.numel() // axis.size,), dtype=x.dtype,
                      device=x.device)
    _count(axis, x.nbytes)
    _reduce_scatter(out, x, op=dist.ReduceOp.SUM, group=axis.group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.axis, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _slice(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis, ctx.dim), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0)
        mine = reduce_scatter_flat(g.reshape(-1), ctx.axis)
        mine = mine.view((g.shape[0] // ctx.axis.size,) + tuple(g.shape[1:]))
        return mine.movedim(0, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        x = x.contiguous()
        out = torch.empty_like(x)
        _count(axis, x.nbytes)
        dist.all_to_all_single(out, x, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        _count(ctx.axis, g.nbytes)
        dist.all_to_all_single(out, g, group=ctx.axis.group)
        return out, None


def _rotate(x, axis, shift):
    """Send ``x`` to the rank ``shift`` places on along the axis, and
    receive from the rank ``shift`` places back."""
    x = x.contiguous()
    out = torch.empty_like(x)
    n = axis.size
    dst = axis.ranks[(axis.index + shift) % n]
    src = axis.ranks[(axis.index - shift) % n]
    _count(axis, x.nbytes)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, dst, axis.group),
        dist.P2POp(dist.irecv, out, src, axis.group)])
    for r in reqs:
        r.wait()
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _rotate(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _rotate(g, ctx.axis, -ctx.shift), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


def copy_to(x, axis):
    return _CopyTo.apply(x, axis) if live(axis) else x


def reduce_from(x, axis):
    return _ReduceFrom.apply(x, axis) if live(axis) else x


def gather_from(x, axis, dim=-1):
    return _GatherFrom.apply(x, axis, dim % x.dim()) if live(axis) else x


def scatter_to(x, axis, dim=-1):
    return _ScatterTo.apply(x, axis, dim % x.dim()) if live(axis) else x


def gather_sum(x, axis, dim=0):
    return _GatherSum.apply(x, axis, dim % x.dim()) if live(axis) else x


def all_to_all(x, axis):
    """All-to-all of ``x``'s dim-0 chunks (dim 0 a multiple of the axis
    size): chunk j goes to index j, and chunk j of the result came from
    index j."""
    return _AllToAll.apply(x, axis) if live(axis) else x


def ppermute(x, axis, shift=1):
    return _Ppermute.apply(x, axis, shift) if live(axis) else x


def all_reduce(x, axis):
    """Differentiable all-reduce (sum): the backward sums the ranks'
    gradients too, for a value every rank's loss reads."""
    return _AllReduce.apply(x, axis) if live(axis) else x


class BatchReducer:
    """Sums of per-shard statistics over the ranks that split a batch:
    ``axes`` the live mesh axes the batch is split over.  ``sum(t)``
    takes ``t`` of shape ``(1, ...)`` (this rank's one shard) and returns
    the sum over every rank, of shape ``(...)``: one all-reduce per axis,
    no gradient (the caller differentiates by hand)."""

    folded = False

    def __init__(self, axes):
        self.axes = tuple(a for a in axes if live(a))
        self.shards = 1
        for a in self.axes:
            self.shards *= a.size

    def sum(self, t):
        t = t[0].contiguous().clone()
        for a in self.axes:
            all_reduce_(t, a)
        return t


class FoldedReducer:
    """The same sums for ``shards`` shards held in one process, stacked on
    a leading axis: ``sum(t)`` of ``t`` of shape ``(shards, ...)`` is its
    sum over that axis.  It runs the multi-rank body on one device."""

    folded = True

    def __init__(self, shards):
        self.shards = int(shards)

    def sum(self, t):
        return t.sum(dim=0)
