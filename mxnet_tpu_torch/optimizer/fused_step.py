"""The fused whole-set optimizer step (counterpart of
``mxnet_tpu/optimizer/fused_step.py``).

:func:`step` updates every live parameter of a ``gluon.Trainer`` (or a
multi-key kvstore push) through one call of the op's multi-tensor form
(``ops/optimizer_ops.py`` ``<op>_multi``, on ``torch._foreach_*``) per
group of equal (op, attributes, dtypes), instead of one call per
parameter: the eager counterpart of the reference's one executable for
the whole set.  Each parameter's lr, wd and rescale_grad go in as lists
of floats, so an lr schedule, ``lr_mult``/``wd_mult`` or a new batch
size changes no call; ``clip_gradient`` is an attribute of the call.
Weights and states are written back in place.

The numerics are the per-parameter path's: each multi form runs the
single form's operations in the same order under the same low-precision
guard.  It declines (returns False, having changed nothing but the
states it created) exactly where the reference declines: when
``MXNET_FUSED_STEP`` is 0/false/off, an updater that is not an
``Updater``, an optimizer without an op, a custom ``update`` (SGLD,
FTML, Test), attributes that move with the update count (``t``,
``m_schedule``: Adamax, Nadam, LAMB, LANS), float16 weights under
``multi_precision``, parameters whose attributes differ, or one tensor
that appears twice (tied parameters).

ZeRO-1 weight-update sharding (``MXNET_ZERO=1`` / ``Trainer(zero=1)``,
``fused_step.py:163-420``): over the dp axis of ``parallel.default_mesh``
(every rank of a started process group; 1 without one, where ``zero``
changes nothing), every rank runs the same forward and backward on the
same batch, so the gradients agree, and each updates only its chunk of
the flattened, zero-padded weights and optimizer state
(:func:`make_sharded_update_fn`); the updated chunks are all-gathered
back into the weights.  The states live as those flat chunks
(:func:`shard_states`; :func:`unshard_states` gathers them back, a
collective).  The layout is ``parallel.collectives.flat_chunk``'s, the
one ``SPMDTrainer``'s ZeRO uses: padded to a multiple of the dp width.
The reference tunes a larger pad unit as a kernel config
(``zero_flatten_pad``); padding with zeros and slicing never alter the
surviving elements of an elementwise update, so the port keeps none.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Sequence, Tuple

import torch

from .. import tracing
from ..ops import optimizer_ops
from .optimizer import Updater, _note_dispatch, _tensor, write_back

__all__ = ["step", "enabled", "stats", "reset_stats", "zero_enabled",
           "zero_degree",
           "make_sharded_update_fn", "shard_states", "unshard_states",
           "opt_state_bytes_per_device"]

# steps: fused applications; compiles / hits: a (family, signature) met
# for the first time / again; fallbacks: calls that declined; zero_steps
# the subset of steps that ran the sharded update
_STATS = {"compiles": 0, "hits": 0, "fallbacks": 0, "steps": 0,
          "zero_steps": 0}
_SEEN = set()


def stats() -> Dict[str, int]:
    """Snapshot of the fused step's counters."""
    return dict(_STATS)


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0


def enabled() -> bool:
    """``MXNET_FUSED_STEP``: 0/false/off turns fusion off (read at each
    step)."""
    return os.environ.get("MXNET_FUSED_STEP", "1").lower() \
        not in ("0", "false", "off")


def _decline() -> bool:
    _STATS["fallbacks"] += 1
    return False


# -- ZeRO-1 ------------------------------------------------------------------

def zero_enabled() -> bool:
    """``MXNET_ZERO``: 1/true/on shards the update over the dp axis (read
    at each step)."""
    return os.environ.get("MXNET_ZERO", "0").lower() in ("1", "true", "on")


def _zero_axis():
    """The dp axis of ``parallel.default_mesh``, or None when no process
    group of more than one rank is started (a dp width of 1)."""
    from ..parallel import _dist
    if _dist.world_size() <= 1:
        return None
    from ..parallel.mesh import default_mesh
    return default_mesh().axis("dp")


def zero_degree() -> int:
    """The dp width the sharded update splits over."""
    ax = _zero_axis()
    return ax.size if ax is not None else 1


def make_sharded_update_fn(op_name: str, statics_key: Tuple,
                           dyn_names: Tuple[str, ...], axis):
    """The ZeRO-1 form of the multi-tensor update ``<op_name>_multi``:
    ``fused(dyn, weights, grads, states) -> (new weights, new states)``.
    Weights and gradients come in whole (the same on every rank), the
    states as this rank's flat chunks; ``dyn`` maps each dynamic name to
    a per-parameter list.  Each weight and gradient is cut to this
    rank's flat chunk (``collectives.flat_chunk``; under the
    AMP policy the gradient takes the storage dtype's round trip first,
    the reference's wire dtype); the update runs on the chunks; the new
    weight chunks are all-gathered (one call), un-padded and reshaped."""
    from ..amp import policy as _amp_policy
    from ..parallel import collectives as comm
    multi = getattr(optimizer_ops, f"{op_name}_multi")
    statics = dict(statics_key)
    wire = _amp_policy.enabled()

    def fused(dyn, weights, grads, states):
        kw = dict(statics)
        for name in dyn_names:
            kw[name + "s" if name in ("lr", "wd") else name] = dyn[name]
        wc, gc = [], []
        for w, g in zip(weights, grads):
            if wire and g.is_floating_point():
                g = _amp_policy.wire_cast(g)
            wc.append(comm.flat_chunk(w, axis))
            gc.append(comm.flat_chunk(g, axis))
        n_state = len(states[0]) if states else 0
        out = multi(wc, gc, *[[st[j] for st in states]
                              for j in range(n_state)], **kw)
        new_wc, new_states = out[0], out[1:]
        every = comm.all_gather_flat(torch.cat(list(new_wc)), axis)
        every = every.reshape(axis.size, -1).split(
            [c.numel() for c in new_wc], dim=1)
        new_w = [e.reshape(-1)[:w.numel()].view(w.shape)
                 for e, w in zip(every, weights)]
        return new_w, [tuple(col[n] for col in new_states)
                       for n in range(len(weights))]

    return fused


def _zero_meta(updater) -> Dict[Any, Tuple]:
    """index → the original shapes of the states held as flat chunks."""
    meta = getattr(updater, "_zero_states", None)
    if meta is None:
        meta = updater._zero_states = {}
    return meta


@torch.no_grad()
def shard_states(updater, indices, axis) -> None:
    """Migrate weight-shaped optimizer states to this rank's flat, padded
    chunks (once per index).  A replicated checkpoint enters a ZeRO run
    this way: ``set_states`` lands weight-shaped slots, and the next
    sharded step cuts them here."""
    from ..parallel import collectives as comm
    meta = _zero_meta(updater)
    for i in indices:
        if i in meta:
            continue
        sts = updater.states[i]
        meta[i] = tuple(tuple(_tensor(s).shape) for s in sts)
        updater.states[i] = type(sts)(
            _rewrap(s, comm.flat_chunk(_tensor(s), axis).clone())
            for s in sts) if isinstance(sts, tuple) else sts


def _rewrap(old, t):
    from ..ndarray.ndarray import NDArray
    return NDArray._wrap(t) if isinstance(old, NDArray) else t


@torch.no_grad()
def unshard_states(updater) -> None:
    """Gather flat-chunk optimizer states back to their original shapes
    (collective: every rank calls it).  Called before any path that
    expects weight-shaped states."""
    meta = getattr(updater, "_zero_states", None)
    if not meta:
        return
    from ..parallel import collectives as comm
    ax = _zero_axis()
    for i, shapes in sorted(meta.items()):
        sts = updater.states.get(i)
        if sts is None:
            continue
        new = []
        for s, shp in zip(sts, shapes):
            t = _tensor(s)
            full = comm.all_gather_flat(t, ax) if ax is not None else t
            size = 1
            for d in shp:
                size *= d
            new.append(_rewrap(s, full[:size].reshape(shp).clone()))
        updater.states[i] = tuple(new)
    meta.clear()


def opt_state_bytes_per_device(arrays) -> int:
    """Bytes of the given optimizer states resident on this rank's device
    (flat chunks count their chunk)."""
    return sum(int(_tensor(a).nbytes) for a in arrays)


@torch.no_grad()
def step(updater, items: Sequence[Tuple[Any, Any, Any]],
         zero: bool = False) -> bool:
    """Apply one fused step to ``items`` = ``[(index, weight, grad)]``
    (NDArrays) through ``updater``.  True when it ran (weights and states
    written, update counts moved); False when it declined and the caller
    must take its per-parameter or aggregated path.  ``zero=True`` takes
    the sharded update over the dp width (:func:`make_sharded_update_fn`)
    when it is more than 1; a step that does not shard, or declines,
    first gathers flat-chunk states back (collective)."""
    axis = _zero_axis() if zero else None
    zero = axis is not None and enabled()
    if getattr(updater, "_zero_states", None) and not zero:
        unshard_states(updater)
    ok = _step_impl(updater, items, axis if zero else None)
    if not ok and getattr(updater, "_zero_states", None):
        unshard_states(updater)
    return ok


def _step_impl(updater, items, axis) -> bool:
    if not items or not enabled() or type(updater) is not Updater:
        return _decline() if items else False
    opt = updater.optimizer
    if opt.op_name is None:
        return _decline()
    multi = getattr(optimizer_ops, f"{opt.op_name}_multi", None)
    indices = [it[0] for it in items]
    weights = [it[1] for it in items]
    grads = [it[2] for it in items]
    if any(getattr(a, "stype", "default") == "row_sparse"
           for a in grads + weights):
        # row-sparse gradients take the optimizer's lazy update, one
        # parameter at a time
        return _decline()
    if multi is None or (opt.multi_precision and any(
            _tensor(w).dtype == torch.float16 for w in weights)):
        return _decline()
    statics = opt._fused_statics(indices[0])
    if statics is None or any(opt._fused_statics(i) != statics
                              for i in indices[1:]):
        return _decline()
    for i, w in zip(indices, weights):
        updater._ensure_state(i, w)
    if axis is not None:
        # flat chunks keep the update rule only for weight-shaped slots
        meta = _zero_meta(updater)
        for i, w in zip(indices, weights):
            if i not in meta and any(
                    tuple(_tensor(s).shape) != tuple(_tensor(w).shape)
                    for s in updater.states[i]):
                return _decline()
    states = [updater.states[i] for i in indices]
    seen = set()
    for w, g, sts in zip(weights, grads, states):
        for a in (w, g, *sts):
            if id(_tensor(a)) in seen:
                return _decline()
            seen.add(id(_tensor(a)))

    # groups of equal dtypes, each one multi-tensor call
    groups: Dict[tuple, list] = {}
    for n, (w, g, sts) in enumerate(zip(weights, grads, states)):
        key = (_tensor(w).dtype, _tensor(g).dtype,
               tuple(_tensor(s).dtype for s in sts))
        groups.setdefault(key, []).append(n)
    sig = (type(opt).__name__, opt.op_name,
           tuple(sorted(statics.items())),
           ("zero", axis.size) if axis is not None else None,
           tuple((key, tuple(tuple(_tensor(weights[n]).shape)
                             for n in members))
                 for key, members in groups.items()))
    if sig in _SEEN:
        _STATS["hits"] += 1
    else:
        _SEEN.add(sig)
        _STATS["compiles"] += 1

    # the counts move first, so Adam's fold sees this step's t and a
    # schedule sees the aggregated path's num_update
    for i in indices:
        opt._update_count(i)
    dyns = [opt._fused_dynamics(i) for i in indices]
    if axis is not None:
        shard_states(updater, indices, axis)
        states = [updater.states[i] for i in indices]
        with tracing.span("step.fused_update"):
            for members in groups.values():
                fused = make_sharded_update_fn(
                    opt.op_name, tuple(sorted(statics.items())),
                    tuple(sorted(dyns[members[0]])), axis)
                dyn = {name: [dyns[n][name] for n in members]
                       for name in dyns[members[0]]
                       if name != "lr" or opt.uses_lr}
                new_w, new_s = fused(
                    dyn, [_tensor(weights[n]) for n in members],
                    [_tensor(grads[n]) for n in members],
                    [tuple(_tensor(s) for s in states[n])
                     for n in members])
                _note_dispatch()
                dests = [weights[n] for n in members] + \
                    [s for n in members for s in states[n]]
                write_back(dests, list(new_w) + [t for st in new_s
                                                 for t in st])
        _record_state_bytes(states)
        _STATS["steps"] += 1
        _STATS["zero_steps"] += 1
        return True
    with tracing.span("step.fused_update"):
        for members in groups.values():
            kw = dict(statics)
            kw["wds"] = [dyns[n]["wd"] for n in members]
            kw["rescale_grad"] = [dyns[n]["rescale_grad"] for n in members]
            if opt.uses_lr:
                kw["lrs"] = [dyns[n]["lr"] for n in members]
            n_state = len(states[members[0]])
            state_lists = [[_tensor(states[n][j]) for n in members]
                           for j in range(n_state)]
            out = multi([_tensor(weights[n]) for n in members],
                        [_tensor(grads[n]) for n in members], *state_lists,
                        **kw)
            _note_dispatch()
            dests = [weights[n] for n in members] + \
                [s for col in state_lists for s in col]
            write_back(dests, [t for col in out for t in col])
    _record_state_bytes(states)
    _STATS["steps"] += 1
    return True


def _record_state_bytes(states):
    """The optimizer-state gauge after a fused step, as the reference's
    ``fused_step.step`` refreshes it (``opt_state.bytes_per_device``)."""
    from .. import telemetry
    telemetry.record_opt_state_bytes(opt_state_bytes_per_device(
        s for sts in states for s in sts))
