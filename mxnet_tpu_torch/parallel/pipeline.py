"""Pipeline parallelism over a ``pp`` mesh axis (counterpart of
``mxnet_tpu/parallel/pipeline.py``): GPipe, the interleaved schedule
and true 1F1B.

Stages live one per rank along ``pp``; microbatches stream through and a
stage's output hops to the next stage.  The schedules are written once
over a stage transport (a *pipe*) with two implementations:

* :class:`_MeshPipe`: the ranks of a ``pp`` axis, this process one stage
  of it; a hop is one ``batch_isend_irecv`` to the next (or, backward,
  the previous) rank and from the other side, the port's
  ``lax.ppermute``;
* :class:`_FoldedPipe`: every stage held by this one process (one
  device); a hop hands each stage's tensor to the next, a list roll.
  ``fold=True`` on the entry points takes it: the stage count is the
  parameters' leading axis and no ``pp`` axis is used.  It runs the same
  slots, in the same order, with the same kernel launches as S ranks.

Every rank makes every hop, in one order, whatever slots it computes: a
bubble slot (no microbatch there) computes nothing and sends zeros, and
the schedule's backward is explicit (``torch.autograd.Function``): its
reverse hops are called by the schedule, never left to autograd, which
would prune a hop whose output a rank does not read and leave its
neighbours waiting.

Schedules, with S stages and M microbatches:

* GPipe (:func:`gpipe_apply`, :func:`pipeline_forward`): fill-drain over
  S+M-1 ticks.  Its forward keeps each slot's autograd graph, and its
  backward walks the ticks in reverse and runs each slot's graph against
  the cotangent that arrived (the last stage's from the output's), so
  every microbatch's activations stay live until the backward, as under
  ``jax.grad`` in the reference;
* interleaved (:func:`interleaved_apply`,
  :func:`pipeline_forward_interleaved`): V virtual stages a rank (layer
  ``j*S + d`` on rank d), V*S+M-1 ticks, M <= S;
* 1F1B (:func:`one_f_one_b_apply`, :func:`pipeline_value_and_grad_1f1b`):
  M+2S-2 ticks, each with one forward (F) and one backward (B) slot.  F
  runs without a graph and stashes its stage input in a ring of
  W = min(2S-1, M) slots; B recomputes the stage forward from the stash
  and takes ``torch.autograd.grad`` against the cotangent that arrived
  (the last stage seeds it from the loss in the tick its forward lands,
  and skips its own F compute, whose output no stage reads).  The
  activations held at once are one stage's, for one microbatch: flat in
  M.

The whole-tensor entry points take what the reference's caller passes,
on every rank (the stacked parameters, the whole batch), cut this rank's
part (the stage over pp, rows over dp, ``param_specs``' tp dims) and
return whole results on every rank: outputs gathered over dp, gradients
gathered over pp and tp, as :func:`.ring_attention.seq_shard_call` does.
The per-rank bodies (``*_apply``) take this rank's parts, as the
reference's do inside ``shard_map``.  A parameter tree is a pytree of
tensors (tuples, lists, dicts).
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ..base import MXNetError
from . import collectives as comm
from .mesh import PartitionSpec, spec_box, spec_gather

__all__ = ["gpipe_apply", "pipeline_forward", "interleaved_apply",
           "pipeline_forward_interleaved", "pipeline_forward_1f1b",
           "interleave_params", "interleaved_ticks", "gpipe_ticks",
           "one_f_one_b_apply", "pipeline_value_and_grad_1f1b",
           "one_f_one_b_ticks"]


# -- the stage transport --------------------------------------------------------

class _MeshPipe:
    """The ranks of a ``pp`` axis; this process holds stage
    ``ax.index``."""

    def __init__(self, ax):
        self.ax, self.size, self.stages = ax, ax.size, (ax.index,)

    def fwd(self, xs):
        return [comm._rotate(x, self.ax, 1) for x in xs]

    def bwd(self, xs):
        return [comm._rotate(x, self.ax, -1) for x in xs]

    def holds(self, i, src):
        """Whether held stage ``i`` needs a buffer for a value stage
        ``src`` makes: every rank takes part in its broadcast."""
        return True

    def replicate(self, values, src):
        """Stage ``src``'s tensor on every rank of the axis (``values``:
        this rank's, the same shape on every rank)."""
        t = values[0].contiguous()
        comm._count(self.ax, t.nbytes)
        dist.broadcast(t, src=self.ax.ranks[src], group=self.ax.group)
        return t


class _FoldedPipe:
    """All ``n`` stages in this process: a hop is a local index."""

    def __init__(self, n):
        self.size, self.stages = n, tuple(range(n))

    def fwd(self, xs):
        return xs[-1:] + xs[:-1]

    def bwd(self, xs):
        return xs[1:] + xs[:1]

    def holds(self, i, src):
        return self.stages[i] == src

    def replicate(self, values, src):
        return values[src]


def _pipe(mesh, axis_name, fold, n_stages):
    """The transport: folded, or over ``mesh``'s (else the running
    trainer step's) ``axis_name`` axis."""
    if fold:
        return _FoldedPipe(n_stages)
    if mesh is None:
        from . import tensor_parallel as _tp
        scope = _tp.active()
        mesh = scope.mesh if scope is not None else None
    ax = mesh.axis(axis_name) if mesh is not None else None
    if ax is None:
        raise MXNetError(
            f"the pipeline body runs on a stage of the {axis_name!r} axis: "
            f"pass mesh= (with a {axis_name!r} axis), or fold=True to "
            f"run every stage in this process")
    if ax.size != n_stages:
        raise MXNetError(f"the {axis_name!r} axis has {ax.size} ranks, the "
                         f"schedule {n_stages} stages")
    return _MeshPipe(ax) if ax.size > 1 else _FoldedPipe(1)


def _grad_or_zeros(g, like):
    return torch.zeros_like(like) if g is None else g


# -- fill-drain: GPipe and the interleaved schedule -----------------------------

def _slot(t, d, S, V, M):
    """(round j, microbatch m) of stage ``d`` at tick ``t``, or None for a
    bubble.  Microbatch m enters stage 0 at tick m and reaches stage d in
    round j at tick m + j*S + d."""
    k = t - d
    if k < 0:
        return None
    j, m = (0, k) if V == 1 else divmod(k, S)
    if j >= V or m >= M:
        return None
    return j, m


class _FillDrain(torch.autograd.Function):
    """The fill-drain forward (GPipe at V = 1) on the stages ``pipe``
    holds, with its backward run tick by tick in reverse.

    Inputs: ``x_mb`` (M, mb, ...) and each parameter leaf stacked over
    (held stage, round): (len(pipe.stages), V, ...).  Output: the last
    stage's outputs (M, mb, ...), on every stage."""

    @staticmethod
    def forward(ctx, meta, x_mb, *leaves):
        stage_fn, pipe, spec, V = meta
        S, M = pipe.size, x_mb.shape[0]
        T = V * S + M - 1
        grad = any(ctx.needs_input_grad[1:])
        zero = torch.zeros_like(x_mb[0])
        held = range(len(pipe.stages))
        outs = [torch.zeros_like(x_mb) if pipe.holds(i, S - 1) else None
                for i in held]
        carry = [zero] * len(held)
        tape = []
        for t in range(T):
            send, row = [zero] * len(held), []
            for i in held:
                d = pipe.stages[i]
                slot = _slot(t, d, S, V, M)
                if slot is None:        # a bubble: nothing computed
                    continue
                j, m = slot
                inp = x_mb[m] if d == 0 and j == 0 else carry[i]
                with torch.enable_grad():
                    inp = inp.detach().requires_grad_(grad)
                    ps = [lf[i, j].detach().requires_grad_(grad)
                          for lf in leaves]
                    y = stage_fn(pytree.tree_unflatten(ps, spec), inp)
                if d == S - 1 and j == V - 1:
                    outs[i][m] = y.detach()
                send[i] = y.detach()
                if grad:
                    row.append((i, j, m, inp, ps, y))
            tape.append(row)
            if t + 1 < T:
                carry = pipe.fwd(send)
        ctx.meta, ctx.tape = meta, tape
        ctx.leaf_like = [(lf.shape, lf.dtype, lf.device) for lf in leaves]
        ctx.x_like = (x_mb.shape, x_mb.dtype)
        return pipe.replicate(outs, S - 1)

    @staticmethod
    def backward(ctx, dout):
        stage_fn, pipe, spec, V = ctx.meta
        S = pipe.size
        tape, ctx.tape = ctx.tape, None
        held = range(len(pipe.stages))
        zero = dout.new_zeros(ctx.x_like[0][1:], dtype=ctx.x_like[1])
        want_dx = ctx.needs_input_grad[1]
        dx = [dout.new_zeros(ctx.x_like[0], dtype=ctx.x_like[1])
              if pipe.holds(i, 0) else None for i in held] \
            if want_dx else None
        grads = [torch.zeros(shape, dtype=dtype, device=dev)
                 if need else None for (shape, dtype, dev), need in
                 zip(ctx.leaf_like, ctx.needs_input_grad[2:])]
        carry = [zero] * len(held)
        for t in range(len(tape) - 1, -1, -1):
            send = [zero] * len(held)
            for i, j, m, inp, ps, y in tape[t]:
                d = pipe.stages[i]
                ct = dout[m] if d == S - 1 and j == V - 1 else carry[i]
                gs = torch.autograd.grad(y, [inp] + ps, ct.to(y.dtype),
                                         allow_unused=True)
                for g, acc in zip(gs[1:], grads):
                    if g is not None and acc is not None:
                        acc[i, j] += g
                g_in = _grad_or_zeros(gs[0], inp)
                if d == 0 and j == 0:
                    if want_dx:
                        dx[i][m] = g_in
                else:
                    send[i] = g_in
            tape[t] = None
            if t > 0:
                carry = pipe.bwd(send)
        if want_dx:
            dx = pipe.replicate(dx, 0)
        return (None, dx) + tuple(grads)


def gpipe_apply(stage_fn: Callable, n_stages: int, axis_name: str = "pp",
                *, mesh=None, fold: bool = False):
    """The per-rank GPipe body.

    ``stage_fn(stage_params, x) -> y`` is one stage's computation; every
    stage maps (mb, ...) -> (mb, ...) alike.  Returns ``apply(
    stage_params, x_microbatches)``: ``stage_params`` is this rank's
    stage (``fold=True``: every stage, stacked on a leading axis of
    ``n_stages``), ``x_microbatches`` (M, mb, ...).  The result is the
    last stage's outputs, (M, mb, ...), on every rank of the axis;
    differentiable, with the backward run in reverse ticks."""
    def apply(stage_params, x_mb):
        pipe = _pipe(mesh, axis_name, fold, n_stages)
        leaves, spec = pytree.tree_flatten(stage_params)
        leaves = [lf.unsqueeze(1) if fold else lf[None, None]
                  for lf in leaves]
        return _FillDrain.apply((stage_fn, pipe, spec, 1), x_mb, *leaves)
    return apply


def _dp_axis(mesh, batch_axis_name):
    if mesh is None or not batch_axis_name \
            or batch_axis_name not in mesh.axis_names:
        return None
    return mesh.axis(batch_axis_name)


def _stage_count(tree, mesh, axis_name, fold, what, n_stages=None):
    """The stage count S: the pp axis size or, folded, ``n_stages`` (else
    the leaves' leading axis), and the tree's leaves."""
    leaves = pytree.tree_flatten(tree)[0]
    if not fold:
        return mesh.shape[axis_name], leaves
    if mesh is not None and mesh.shape.get(axis_name, 1) != 1:
        raise MXNetError(f"{what}: fold=True runs every stage in this "
                         f"process; the mesh's {axis_name!r} axis must be "
                         f"absent or of size 1")
    return int(n_stages or leaves[0].shape[0]), leaves


def _stage_params(tree, mesh, axis_name, fold, dp):
    """This rank's stage of a stacked tree (folded: every stage), each
    leaf through ``copy_to`` over dp (its gradient summed over the dp
    ranks, which saw other rows) and ``scatter_to`` over pp (the stacked
    gradient gathered back)."""
    ax = None if fold else mesh.axis(axis_name)

    def cut(lf):
        lf = comm.copy_to(lf, dp)
        if fold:
            return lf
        return (comm.scatter_to(lf, ax, 0) if comm.live(ax) else lf)[0]
    return pytree.tree_map(cut, tree)


def _microbatches(x, M):
    return x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))


def _batch_in(x, dp, M):
    """This rank's dp rows of ``x``, as (M, mb, ...)."""
    return _microbatches(comm.scatter_to(x, dp, 0) if comm.live(dp) else x,
                         M)


def _batch_out(out, dp):
    """(M, mb, ...) outputs as the whole (B, ...) batch on every rank."""
    out = out.reshape((-1,) + tuple(out.shape[2:]))
    return comm.gather_from(out, dp, 0) if comm.live(dp) else out


def pipeline_forward(stage_fn: Callable, stacked_params, x, mesh,
                     n_microbatches: int, axis_name: str = "pp",
                     batch_axis_name: Optional[str] = "dp", *,
                     fold: bool = False):
    """A whole pipeline forward (GPipe), differentiable.

    ``stacked_params``: a tree whose leaves have a leading stage axis of
    the pp axis's size.  ``x``: the (B, ...) batch, split into
    ``n_microbatches`` along axis 0, and over ``batch_axis_name`` when
    the mesh has it (dp×pp).  Every rank passes the same whole values and
    gets the whole (B, ...) output.  ``fold=True``: every stage in this
    process (S = the leading axis; ``mesh`` may be None)."""
    S, leaves = _stage_count(stacked_params, mesh, axis_name, fold,
                             "pipeline_forward")
    for leaf in leaves:
        if leaf.shape[0] != S:
            raise ValueError(
                f"pipeline_forward: param leading (stage) axis "
                f"{leaf.shape[0]} != pp mesh size {S} — one stage per "
                f"device (stack multiple layers inside stage_fn instead)")
    dp = _dp_axis(mesh, batch_axis_name)
    n_dp = dp.size if dp is not None else 1
    if x.shape[0] % (n_dp * n_microbatches):
        raise ValueError(
            f"pipeline_forward: batch {x.shape[0]} not divisible by "
            f"dp({n_dp}) x n_microbatches({n_microbatches})")
    body = gpipe_apply(stage_fn, S, axis_name, mesh=mesh, fold=fold)
    out = body(_stage_params(stacked_params, mesh, axis_name, fold, dp),
               _batch_in(x, dp, n_microbatches))
    return _batch_out(out, dp)


# -- the interleaved schedule -----------------------------------------------------

def interleaved_ticks(n_stages: int, n_virtual: int,
                      n_microbatches: int) -> int:
    """Total schedule ticks (per-device time in single-layer units)."""
    return n_virtual * n_stages + n_microbatches - 1


def gpipe_ticks(n_stages: int, n_virtual: int, n_microbatches: int) -> int:
    """GPipe per-device time in the same units: each of the S+M-1 ticks
    runs all V layers the device owns."""
    return n_virtual * (n_stages + n_microbatches - 1)


def _check_interleaved(M, S):
    if M > S:
        raise ValueError(
            f"interleaved schedule needs M <= S (got M={M}, S={S}); use "
            f"gpipe_apply for deep microbatching")


def interleaved_apply(stage_fn: Callable, n_stages: int, n_virtual: int,
                      axis_name: str = "pp", *, mesh=None,
                      fold: bool = False):
    """The per-rank body of the interleaved pipeline.

    ``stage_fn(layer_params, x) -> y`` is one layer (a virtual stage).
    Returns ``apply(vstage_params, x_microbatches)``: ``vstage_params``
    has a leading axis V, this rank's virtual stages in ring order
    (global layer j*S + d; ``fold=True``: (S, V, ...), every rank's, as
    :func:`interleave_params` lays them out), ``x_microbatches`` is
    (M, mb, ...) with M <= S (a larger M would put two microbatches on
    one stage in one tick)."""
    def apply(vstage_params, x_mb):
        _check_interleaved(x_mb.shape[0], n_stages)
        pipe = _pipe(mesh, axis_name, fold, n_stages)
        leaves, spec = pytree.tree_flatten(vstage_params)
        if not fold:
            leaves = [lf[None] for lf in leaves]
        return _FillDrain.apply((stage_fn, pipe, spec, n_virtual), x_mb,
                                *leaves)
    return apply


def interleave_params(layer_params, n_stages: int):
    """Rearrange a (L, ...) layer stack into the interleaved layout
    (S, V, ...): device d's round j applies global layer j*S + d."""
    def rearrange(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(
                f"layer count {L} not divisible by pp size {n_stages}")
        V = L // n_stages
        idx = (torch.arange(V)[None, :] * n_stages
               + torch.arange(n_stages)[:, None]).reshape(-1)
        return a[idx.to(a.device)].reshape((n_stages, V)
                                           + tuple(a.shape[1:]))
    return pytree.tree_map(rearrange, layer_params)


def pipeline_forward_interleaved(stage_fn: Callable, layer_params, x, mesh,
                                 n_microbatches: int, axis_name: str = "pp",
                                 batch_axis_name: Optional[str] = "dp", *,
                                 fold: bool = False,
                                 n_stages: Optional[int] = None):
    """The interleaved fill-drain pipeline forward (virtual stages).

    Cuts the bubble from GPipe's (S-1)/(S+M-1) to (S-1)/(V*S+M-1) by
    sending each microbatch V times round the ring.  Its backward runs
    after the whole forward, so all M microbatches' activations stay
    live: for the activation-bounded schedule use
    :func:`pipeline_value_and_grad_1f1b`.

    ``layer_params``: a tree with leading axis L = V*S (the layer stack
    in network order), rearranged here to the interleaved placement.
    Otherwise as :func:`pipeline_forward`; ``fold=True`` runs
    ``n_stages`` stages in this process."""
    if fold and not n_stages:
        raise MXNetError("pipeline_forward_interleaved(fold=True) needs "
                         "n_stages")
    S, leaves = _stage_count(layer_params, mesh, axis_name, fold,
                             "interleaved", n_stages)
    L = leaves[0].shape[0]
    V = L // S
    if L % S:
        raise ValueError(
            f"interleaved: layer count {L} not divisible by S={S}")
    dp = _dp_axis(mesh, batch_axis_name)
    n_dp = dp.size if dp is not None else 1
    if x.shape[0] % (n_dp * n_microbatches):
        raise ValueError(
            f"interleaved: batch {x.shape[0]} not divisible by dp({n_dp}) "
            f"x n_microbatches({n_microbatches})")
    body = interleaved_apply(stage_fn, S, V, axis_name, mesh=mesh,
                             fold=fold)
    out = body(_stage_params(interleave_params(layer_params, S), mesh,
                             axis_name, fold, dp),
               _batch_in(x, dp, n_microbatches))
    return _batch_out(out, dp)


def pipeline_forward_1f1b(*args, **kwargs):
    """Deprecated alias for :func:`pipeline_forward_interleaved`.

    The schedule it runs is interleaved fill-drain (smaller bubble), not
    activation-bounded 1F1B; the honest name is ``interleaved``.  For
    the true 1F1B training step see :func:`pipeline_value_and_grad_1f1b`.
    """
    warnings.warn(
        "pipeline_forward_1f1b is renamed pipeline_forward_interleaved "
        "(it is an interleaved fill-drain schedule, not activation-"
        "bounded 1F1B); for true 1F1B use pipeline_value_and_grad_1f1b",
        DeprecationWarning, stacklevel=2)
    return pipeline_forward_interleaved(*args, **kwargs)


# -- true 1F1B --------------------------------------------------------------------

def one_f_one_b_ticks(n_stages: int, n_microbatches: int) -> int:
    """Total 1F1B schedule ticks; each tick is one F slot + one B slot."""
    return n_microbatches + 2 * n_stages - 2


def _one_f_one_b(stage_fn, loss_fn, pipe, params, x_mb, t_mb, want_dx):
    """The 1F1B schedule on the stages ``pipe`` holds (``params``: one
    tree a held stage).  Returns ``(loss, grads, dx)``: the mean of the M
    microbatch losses on every stage, each held stage's gradient leaves,
    and (``want_dx``) d(loss)/d(x_mb) on every stage, else None."""
    S, M = pipe.size, x_mb.shape[0]
    W = min(2 * S - 1, M)
    T = one_f_one_b_ticks(S, M)
    held = range(len(pipe.stages))
    flat = [pytree.tree_flatten(p) for p in params]
    zero = torch.zeros_like(x_mb[0])
    stash = [[None] * W for _ in held]
    grads = [[None] * len(flat[i][0]) for i in held]
    loss_acc = [x_mb.new_zeros((), dtype=torch.float32) for _ in held]
    dx_acc = [torch.zeros_like(x_mb) if want_dx and pipe.holds(i, 0)
              else None for i in held]
    carry_f = carry_b = [zero] * len(held)
    for t in range(T):
        send_f, send_b = [zero] * len(held), [zero] * len(held)
        for i in held:
            d = pipe.stages[i]
            leaves, spec = flat[i]
            # F slot: microbatch t - d flows GPipe-style
            mf = t - d
            if 0 <= mf < M:
                inp = x_mb[mf] if d == 0 else carry_f[i]
                stash[i][mf % W] = inp
                if d != S - 1:      # the last stage's B slot recomputes it
                    with torch.no_grad():
                        send_f[i] = stage_fn(params[i], inp)
            # B slot: microbatch t - (2S-2) + d drains the ring
            mb = t - (2 * S - 2) + d
            if not 0 <= mb < M:
                continue
            need_dx = d > 0 or want_dx
            with torch.enable_grad():
                xin = stash[i][mb % W].detach().requires_grad_(need_dx)
                ps = [lf.detach().requires_grad_(True) for lf in leaves]
                y = stage_fn(pytree.tree_unflatten(ps, spec), xin)
                if d == S - 1:
                    loss_m = loss_fn(y, t_mb[mb])
                    dldy, = torch.autograd.grad(loss_m, y, retain_graph=True)
                    cot = (dldy / M).to(y.dtype)
                    loss_acc[i] = loss_acc[i] + (
                        loss_m.detach() / M).to(torch.float32)
                else:
                    cot = carry_b[i].to(y.dtype)
                gs = torch.autograd.grad(y, ([xin] if need_dx else []) + ps,
                                         cot, allow_unused=True)
            if need_dx:
                g_in, gs = _grad_or_zeros(gs[0], xin), gs[1:]
                if d == 0:
                    dx_acc[i][mb] = g_in.to(dx_acc[i].dtype)
                else:
                    send_b[i] = g_in
            for n, g in enumerate(gs):
                g = _grad_or_zeros(g, leaves[n])
                grads[i][n] = g if grads[i][n] is None else grads[i][n] + g
        if t + 1 < T:
            carry_f, carry_b = pipe.fwd(send_f), pipe.bwd(send_b)
    loss = pipe.replicate(loss_acc, S - 1)
    dx = pipe.replicate(dx_acc, 0) if want_dx else None
    return loss, grads, dx


def one_f_one_b_apply(stage_fn: Callable, loss_fn: Callable, n_stages: int,
                      n_microbatches: int, axis_name: str = "pp",
                      return_input_grad: bool = False, *, mesh=None,
                      fold: bool = False):
    """The per-rank 1F1B training-step body.

    ``stage_fn(stage_params, x) -> y`` is one stage (uniform shapes);
    ``loss_fn(y, target) -> scalar`` is applied to the last stage's
    output per microbatch.  Returns ``apply(stage_params, x_mb, t_mb)``
    -> ``(mean_loss, grads)``, ``x_mb``/``t_mb`` (M, mb, ...)
    microbatches and ``grads`` shaped as ``stage_params`` (this rank's
    stage; ``fold=True``: every stage, stacked on a leading axis of
    ``n_stages``); the loss is on every rank.  With
    ``return_input_grad`` the result is ``(loss, grads, dx_mb)``,
    d(loss)/d(x_mb) on every rank (stage 0 collects it), for chaining
    e.g. an embedding lookup in front of the pipeline."""
    def apply(stage_params, x_mb, t_mb):
        if x_mb.shape[0] != n_microbatches:
            raise ValueError(f"1f1b: {x_mb.shape[0]} microbatches, the "
                             f"body was built for {n_microbatches}")
        pipe = _pipe(mesh, axis_name, fold, n_stages)
        if fold:
            per = [pytree.tree_map(lambda a: a[s], stage_params)
                   for s in range(n_stages)]
        else:
            per = [stage_params]
        loss, grads, dx = _one_f_one_b(stage_fn, loss_fn, pipe, per, x_mb,
                                       t_mb, return_input_grad)
        spec = pytree.tree_flatten(stage_params)[1]
        if fold:
            g = [torch.stack([grads[s][n] for s in range(n_stages)])
                 for n in range(len(grads[0]))]
        else:
            g = grads[0]
        g = pytree.tree_unflatten(g, spec)
        return (loss, g, dx) if return_input_grad else (loss, g)
    return apply


def _spec_leaves(param_specs, n, axis_name):
    if param_specs is None:
        return [PartitionSpec(axis_name)] * n
    specs = pytree.tree_flatten(
        param_specs,
        is_leaf=lambda s: s is None or isinstance(s, PartitionSpec))[0]
    if len(specs) != n:
        raise MXNetError(f"param_specs has {len(specs)} leaves, the "
                         f"parameters {n}")
    return [s if s is not None else PartitionSpec(axis_name)
            for s in specs]


def pipeline_value_and_grad_1f1b(stage_fn: Callable, loss_fn: Callable,
                                 stacked_params, x, targets, mesh,
                                 n_microbatches: int, axis_name: str = "pp",
                                 batch_axis_name: Optional[str] = "dp",
                                 param_specs=None,
                                 return_input_grad: bool = False, *,
                                 fold: bool = False):
    """True 1F1B pipeline training step: ``(mean_loss, grads)``.

    Backward work is interleaved per microbatch, so activation memory is
    bounded by the stage count S, not the microbatch count M (deep
    microbatching: no ``M <= S`` limit).  ``stacked_params`` has a leading
    stage axis of the pp axis's size; ``x``/``targets`` are (B, ...)
    batches split into ``n_microbatches`` (and over ``batch_axis_name``
    if the mesh has it; loss and gradients are averaged over it).  Every
    rank passes the whole values and gets the whole results: grads in the
    stacked layout of ``stacked_params``.

    ``param_specs``: an optional tree of PartitionSpecs matching
    ``stacked_params`` for sharding inside a stage (tensor parallelism:
    ``P('pp', None, 'tp')`` on a column-parallel weight); each rank's
    ``stage_fn`` then sees its shards and makes its own tp collectives
    (``collectives.copy_to`` / ``reduce_from``, Megatron's f and g, or
    ``collectives.all_reduce``, ``lax.psum``'s pair).  Defaults to
    ``P(axis_name)`` on every leaf.  ``return_input_grad`` also returns
    d(mean_loss)/dx, already scaled for the dp mean (each row's own
    gradient: a caller chains it straight into an embedding scatter).
    ``fold=True``: every stage in this process (S = the leading axis)."""
    S, leaves = _stage_count(stacked_params, mesh, axis_name, fold, "1f1b")
    for leaf in leaves:
        if leaf.shape[0] != S:
            raise ValueError(
                f"1f1b: param leading (stage) axis {leaf.shape[0]} != pp "
                f"mesh size {S} — one stage per device")
    dp = _dp_axis(mesh, batch_axis_name)
    n_dp = dp.size if dp is not None else 1
    if x.shape[0] % (n_dp * n_microbatches):
        raise ValueError(
            f"1f1b: batch {x.shape[0]} not divisible by dp({n_dp}) x "
            f"n_microbatches({n_microbatches})")
    if targets.shape[0] != x.shape[0]:
        raise ValueError(
            f"1f1b: targets batch {targets.shape[0]} != x batch "
            f"{x.shape[0]} (a mismatch would silently broadcast in "
            f"loss_fn)")
    tree = pytree.tree_flatten(stacked_params)[1]
    specs = _spec_leaves(param_specs, len(leaves), axis_name)
    skip = (axis_name,) if fold else ()
    with torch.no_grad():
        local = []
        for lf, sp in zip(leaves, specs):
            if mesh is not None:
                start, n = spec_box(lf.shape, sp, mesh, skip)
                lf = lf[tuple(slice(a, a + k) for a, k in zip(start, n))]
            local.append(lf if fold else lf[0])
        xl, tl = x, targets
        if comm.live(dp):
            xl, tl = comm._slice(x, dp, 0), comm._slice(targets, dp, 0)
    body = one_f_one_b_apply(stage_fn, loss_fn, S, n_microbatches,
                             axis_name, return_input_grad, mesh=mesh,
                             fold=fold)
    res = body(pytree.tree_unflatten(local, tree),
               _microbatches(xl, n_microbatches),
               _microbatches(tl, n_microbatches))
    loss, grads = res[0], pytree.tree_flatten(res[1])[0]
    with torch.no_grad():
        if not fold:
            grads = [g[None] for g in grads]
        if comm.live(dp):
            loss = comm.all_reduce_(loss.clone(), dp) / n_dp
            grads = [comm.all_reduce_(g.contiguous(), dp) / n_dp
                     for g in grads]
        if mesh is not None:
            grads = [spec_gather(g, sp, mesh, skip)
                     for g, sp in zip(grads, specs)]
        grads = pytree.tree_unflatten(grads, tree)
        if not return_input_grad:
            return loss, grads
        dx = res[2].reshape(xl.shape)
        if comm.live(dp):
            # a row's gradient lives on its own dp shard; the global-mean
            # loss scales each shard's by 1/n_dp
            dx = comm._gather((dx / n_dp).to(dx.dtype), dp, 0)
        return loss, grads, dx
