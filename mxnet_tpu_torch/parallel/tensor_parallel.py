"""What the layers read of a meshed trainer's step, and the
tensor-parallel Dense.

``SPMDTrainer`` opens a :func:`scope` around each forward of a meshed
step.  Inside it:

* a ``Dense`` whose weight is sharded over ``tp`` (``Parameter.shard``)
  reads its local shard and runs :func:`dense` (Megatron's
  column / row pairs, below) instead of gathering the weight;
* ``TransformerLM`` offsets its positions by this rank's sequence shard
  when the batch is sharded over ``sp`` (``seq_axis``);
* ``MultiHeadAttention(ring_mesh=...)`` runs the sequence-parallel body
  on the local shard instead of sharding whole tensors itself;
* ``BatchNorm`` in training mode refuses a batch split over the ranks:
  its statistics would be the rank's, where the reference's are the
  whole batch's (cross-rank statistics are not ported yet).

A Dense weight in the gluon (out, in) layout:

* ``P("tp", None)``, column parallel: each rank computes its slice of the
  output features (``copy_to`` the input: its gradient sums over tp),
  and the slices are gathered (``gather_from``) — a tp-sharded bias adds
  to the slice, a replicated one after the gather;
* ``P(None, "tp")``, row parallel: each rank takes its slice of the input
  features (``scatter_to``) and the partial products are summed
  (``reduce_from``); the bias adds after the sum.

Every rank of the tp axis computes the same thing outside the sharded
matmul.  The output of a column-parallel layer is gathered before the
next layer rather than kept sharded into a following row-parallel one
(Megatron's pairing, which saves a gather and a slice): simpler, the
same numbers, more traffic — a later change may pair them.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from ..base import MXNetError
from . import collectives as comm
from .mesh import spec_axes

__all__ = ["scope", "active", "local_axis", "dense", "seq_offset",
           "refuse_split_batch_stats"]

_local = threading.local()


class _Scope:
    __slots__ = ("mesh", "seq_sharded", "tp_local", "batch_split",
                 "moe_axes", "tp_rows")

    def __init__(self, mesh, seq_sharded, tp_local, batch_split, moe_axes):
        self.mesh = mesh
        self.seq_sharded = bool(seq_sharded)
        # the rank holds a part of the batch (a live dp or sp axis)
        self.batch_split = bool(batch_split)
        # id(parameter) -> the tp axis, for parameters read as local shards
        self.tp_local: Dict[int, object] = tp_local
        # the axes the tokens of a switch_moe called without a mesh are
        # split over (Mesh4DTrainer's step: dp and ep), outer first
        self.moe_axes = tuple(moe_axes or ())
        # MeshPlan.tp_row calls in the scope
        self.tp_rows = 0


@contextlib.contextmanager
def scope(mesh, seq_sharded=False, tp_local=None, batch_split=False,
          moe_axes=None):
    prev = getattr(_local, "scope", None)
    _local.scope = _Scope(mesh, seq_sharded, tp_local or {}, batch_split,
                          moe_axes)
    try:
        yield _local.scope
    finally:
        _local.scope = prev


def active() -> Optional[_Scope]:
    return getattr(_local, "scope", None)


def local_axis(param):
    """The tp axis when ``param`` is read as its local shard in this
    step, else None."""
    s = active()
    if s is None or param is None:
        return None
    return s.tp_local.get(id(param))


def seq_offset(s_local: int):
    """``(offset, global length)`` of this rank's sequence shard."""
    s = active()
    if s is None or not s.seq_sharded:
        return 0, s_local
    ax = s.mesh.axis("sp")
    return ax.index * s_local, ax.size * s_local


def refuse_split_batch_stats(layer):
    """Raise where a layer would take batch statistics of this rank's
    part of a batch split over the mesh."""
    s = active()
    if s is not None and s.batch_split:
        raise MXNetError(
            f"{layer} in training mode on a batch split over the mesh "
            f"needs the whole batch's statistics (cross-rank BatchNorm): "
            f"not ported yet (queue 1 item 11d)")


def _tp_dim(spec):
    """0 (column parallel) or 1 (row parallel) for a 2-D Dense weight
    spec naming tp."""
    parts = list(spec or ()) + [None, None]
    if parts[0] == "tp" and parts[1] is None:
        return 0
    if parts[0] is None and parts[1] == "tp":
        return 1
    raise MXNetError(f"Dense weight sharding {spec!r}: the port's tensor "
                     f"parallel Dense takes P('tp', None) (column) or "
                     f"P(None, 'tp') (row)")


def dense(fc, x, w, b, w_param, b_param, ax, flatten):
    """``fc(x, w, b, flatten)`` with ``w`` (and maybe ``b``) this rank's
    tp shard of ``w_param`` / ``b_param``."""
    dim = _tp_dim(w_param._sharding)
    b_local = b_param is not None and "tp" in spec_axes(b_param._sharding)
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    if dim == 0:
        x = comm.copy_to(x, ax)
        y = fc(x, w, b if b_local else None, False)
        y = comm.gather_from(y, ax, -1)
        return y + b if b is not None and not b_local else y
    if b_local:
        raise MXNetError("a row-parallel Dense (weight P(None, 'tp')) "
                         "takes a replicated bias")
    y = comm.reduce_from(fc(comm.scatter_to(x, ax, -1), w, None, False), ax)
    return y + b if b is not None else y
