"""Mixture of experts with expert parallelism over a mesh axis
(counterpart of ``mxnet_tpu/parallel/moe.py``).

Switch-style top-1 routing in the Mesh-TensorFlow einsum formulation.
Shapes: tokens (N, H); gate (H, E); experts w1 (E, H, F), b1 (E, F),
w2 (E, F, H), b2 (E, H).

With ``mesh=`` (an ``ep`` axis of size P > 1) each rank holds a shard of
the tokens, (N/P, H) in rank order, and the experts
``[i·E/P, (i+1)·E/P)`` (the leading E axis of w1, b1, w2 and b2, as
:func:`moe_expert_sharding` places them); the gate is replicated.  The
routing is the single-device one over all N tokens: capacity and each
token's place in its expert's queue count the tokens of the lower ranks
first (an all-gather of the per-expert counts).  The token→expert
shuffle is an ``all_to_all_single`` of the (E, C, H) dispatch buffers
(each rank's rows for expert shard j go to rank j, which sums them: a
token holds one slot, so the sum places it); the combine sends every
rank the experts' outputs with a second all-to-all.  The load-balancing
loss and the dropped count are global (all-reduces over the axis).

Called with no mesh inside ``Mesh4DTrainer``'s step, it takes the step's
mesh: the tokens are split over dp and ep (dp outer), the routing is the
single-device one over every rank's tokens (the counts all-gathered over
both axes, the capacity of all N), and the shuffle runs over ep, where
the experts' shards are; each dp group's expert copies take its tokens.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import telemetry
from . import collectives as comm
from .mesh import NamedSharding, PartitionSpec

__all__ = ["switch_moe", "moe_expert_sharding"]


def switch_moe(x, gate_w, w1, b1, w2, b2, capacity_factor: float = 1.25,
               return_stats: bool = False, *, mesh=None,
               axis_name: str = "ep"):
    """Top-1 (Switch) MoE layer.

    Tokens route to their argmax expert, subject to a per-expert capacity
    of ``ceil(N/E * capacity_factor)``; overflow tokens pass through with
    zero expert output.  Dropped tokens are accounted, never silent: a
    call outside a CUDA graph capture ticks ``moe.dropped_tokens``
    (``telemetry.record_moe_dropped``, a host read of the count); a
    caller inside a captured step passes ``return_stats=True`` and
    records ``stats["dropped_tokens"]`` itself.

    Returns ``(y, aux_loss)``, ``aux_loss`` the Switch load-balancing
    loss (E · Σ_e f_e · p̄_e), or ``(y, aux_loss, stats)`` with
    ``return_stats=True``: ``dropped_tokens`` (int32 0-d tensor),
    ``capacity`` (int) and ``expert_load`` ((E,) tokens routed per
    expert, before the drop)."""
    route = []
    if mesh is None:
        from . import tensor_parallel as _tp
        sc = _tp.active()
        if sc is not None and sc.moe_axes:
            mesh = sc.mesh
            route = [a for a in (mesh.axis(n) for n in sc.moe_axes)
                     if comm.live(a)]
    ax = mesh.axis(axis_name) if mesh is not None else None
    if not route and comm.live(ax):
        route = [ax]
    p = ax.size if comm.live(ax) else 1
    n_loc, h = x.shape
    n = n_loc * math.prod(a.size for a in route)
    e = gate_w.shape[1]
    cap = max(1, math.ceil(n / e * capacity_factor))

    logits = x @ gate_w                                   # (n, E)
    probs = torch.softmax(logits, dim=-1)
    expert = probs.argmax(dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = F.one_hot(expert, e).to(x.dtype)             # (n, E)
    counts = onehot.sum(dim=0)
    # the tokens of the lower ranks come first in every expert's queue
    below = torch.zeros_like(counts)
    if route:
        every, me = counts.detach(), 0
        for a in reversed(route):               # inner axis first
            every = comm.all_gather_flat(every.reshape(-1), a).reshape(
                (a.size,) + tuple(every.shape))
        for a in route:
            me = me * a.size + a.index
        every = every.reshape(-1, e)
        below = every[:me].sum(dim=0)
        total = every.sum(dim=0)
    else:
        total = counts
    pos = torch.cumsum(onehot, dim=0) - onehot + below    # (n, E)
    keep = (pos < cap).to(x.dtype) * onehot
    slot = keep[:, :, None] * F.one_hot(
        pos.long().clamp(max=cap), cap + 1)[..., :cap].to(x.dtype)

    # dispatch: tokens → expert-major buffers
    xe = torch.einsum("nec,nh->ech", slot, x)             # (E, C, H)
    if p > 1:
        # rows for expert shard j to rank j, summed there
        xe = comm.all_to_all(xe.reshape(p, e // p, cap, h), ax).sum(dim=0)
    hdn = F.relu(torch.einsum("ech,ehf->ecf", xe, w1) + b1[:, None, :])
    ye = torch.einsum("ecf,efh->ech", hdn, w2) + b2[:, None, :]
    if p > 1:
        # every rank's expert outputs to every rank
        ye = comm.all_to_all(ye[None].expand(p, *ye.shape).contiguous(),
                             ax).reshape(e, cap, h)

    combine = slot * gate[:, None, None]
    y = torch.einsum("nec,ech->nh", combine, ye)          # (n, H)

    # load-balancing loss (Switch Transformer eq. 4) over all N tokens
    frac_tokens, frac_probs = onehot.sum(dim=0), probs.sum(dim=0)
    for a in route:
        frac_tokens = comm.all_reduce(frac_tokens, a)
        frac_probs = comm.all_reduce(frac_probs, a)
    aux = e * torch.sum((frac_tokens / n) * (frac_probs / n))

    dropped = (n_loc - keep.sum()).to(torch.int32)
    for a in route:
        dropped = comm.all_reduce_(dropped.detach().clone(), a)
    if return_stats:
        return y, aux, {"dropped_tokens": dropped, "capacity": cap,
                        "expert_load": total.detach()}
    if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
        telemetry.record_moe_dropped(int(dropped))
    return y, aux


def moe_expert_sharding(mesh, axis_name: str = "ep"):
    """NamedShardings for (gate_w, w1, b1, w2, b2): gate replicated,
    expert weights sharded on the leading E axis over ``axis_name``."""
    rep = NamedSharding(mesh, PartitionSpec())
    ex = NamedSharding(mesh, PartitionSpec(axis_name))
    return rep, ex, ex, ex, ex
