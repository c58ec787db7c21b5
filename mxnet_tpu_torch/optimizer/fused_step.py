"""The fused whole-set optimizer step (counterpart of
``mxnet_tpu/optimizer/fused_step.py:1-130, 433-700``, without ZeRO).

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

The ZeRO-sharded update (``make_sharded_update_fn``, ``shard_states``,
``zero_*``) is not ported yet (distribution, queue 1 item 10).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Sequence, Tuple

import torch

from .. import tracing
from ..ops import optimizer_ops
from .optimizer import Updater, _note_dispatch, _tensor, write_back

__all__ = ["step", "enabled", "stats", "reset_stats"]

# steps: fused applications; compiles / hits: a (family, signature) met
# for the first time / again; fallbacks: calls that declined
_STATS = {"compiles": 0, "hits": 0, "fallbacks": 0, "steps": 0}
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


@torch.no_grad()
def step(updater, items: Sequence[Tuple[Any, Any, Any]]) -> bool:
    """Apply one fused step to ``items`` = ``[(index, weight, grad)]``
    (NDArrays) through ``updater``.  True when it ran (weights and states
    written, update counts moved); False when it declined and the caller
    must take its per-parameter or aggregated path."""
    if not items or not enabled() or type(updater) is not Updater:
        return _decline() if items else False
    opt = updater.optimizer
    if opt.op_name is None:
        return _decline()
    multi = getattr(optimizer_ops, f"{opt.op_name}_multi", None)
    indices = [it[0] for it in items]
    weights = [it[1] for it in items]
    grads = [it[2] for it in items]
    if multi is None or (opt.multi_precision and any(
            _tensor(w).dtype == torch.float16 for w in weights)):
        return _decline()
    statics = opt._fused_statics(indices[0])
    if statics is None or any(opt._fused_statics(i) != statics
                              for i in indices[1:]):
        return _decline()
    for i, w in zip(indices, weights):
        updater._ensure_state(i, w)
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
    _STATS["steps"] += 1
    return True
