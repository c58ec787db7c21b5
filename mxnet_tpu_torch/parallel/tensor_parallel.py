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
* ``BatchNorm`` in training mode takes the whole batch's statistics
  when the batch is split over live axes (``batch_axes``): it asks
  :func:`batch_reducer` for the reducer over those axes and runs
  ``ops.nn.sync_batch_norm``, as the reference's BatchNorm under GSPMD
  reduces over the whole batch;
* ``Dropout`` draws the whole batch's mask and keeps this rank's part of
  it (:func:`batch_shards`), so ranks seeded alike drop different
  elements of different rows, as one device would.

A Dense weight in the gluon (out, in) layout:

* ``P("tp", None)``, column parallel: each rank computes its slice of the
  output features (``copy_to`` the input: its gradient sums over tp),
  and the slices are gathered (``gather_from``) — a tp-sharded bias adds
  to the slice, a replicated one after the gather;
* ``P(None, "tp")``, row parallel: each rank takes its slice of the input
  features (``scatter_to``) and the partial products are summed
  (``reduce_from``); the bias adds after the sum.

Every rank of the tp axis computes the same thing outside the sharded
matmul.  Megatron's pairing: where the code sees that a column-parallel
Dense's only consumer is a row-parallel Dense on the same axis, with at
most an elementwise activation between them (``TransformerBlock``'s
``ffn1 → act → ffn2``, adjacent Dense pairs in a ``(Hybrid)Sequential``),
it runs them under :func:`paired`: the column output stays this rank's
slice (a replicated column bias is sliced to it, ``scatter_to``) and the
row Dense reads that slice without ``scatter_to``.  That saves the
column's gather in the forward and the row's in the backward, the same
numbers.  Everywhere else a column output is gathered: a layer that
expects the whole tensor must not get a part of it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

from ..base import MXNetError
from . import collectives as comm
from .mesh import spec_axes

__all__ = ["scope", "active", "local_axis", "dense", "seq_offset",
           "batch_reducer", "batch_shards", "pair_axis", "paired"]

_local = threading.local()


class _Scope:
    __slots__ = ("mesh", "seq_sharded", "tp_local", "batch_axes",
                 "moe_axes", "tp_rows", "paired")

    def __init__(self, mesh, seq_sharded, tp_local, batch_axes, moe_axes):
        self.mesh = mesh
        self.seq_sharded = bool(seq_sharded)
        # ((axis, dim), ...): the live axes that split the batch (dp, and
        # sp over the sequence), each with the batch dim it splits
        self.batch_axes = tuple(batch_axes or ())
        # id(parameter) -> the tp axis, for parameters read as local shards
        self.tp_local: Dict[int, object] = tp_local
        # the axes the tokens of a switch_moe called without a mesh are
        # split over (Mesh4DTrainer's step: dp and ep), outer first
        self.moe_axes = tuple(moe_axes or ())
        # MeshPlan.tp_row calls in the scope
        self.tp_rows = 0
        # id(weight) -> "out" (a column Dense keeping its slice) or "in"
        # (a row Dense reading one), under ``paired``
        self.paired: Dict[int, str] = {}


@contextlib.contextmanager
def scope(mesh, seq_sharded=False, tp_local=None, batch_axes=(),
          moe_axes=None):
    prev = getattr(_local, "scope", None)
    _local.scope = _Scope(mesh, seq_sharded, tp_local or {}, batch_axes,
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


def batch_reducer(channel_axis: int, ndim: int):
    """The reducer of a BatchNorm's statistics (channels on
    ``channel_axis`` of an ``ndim``-D input) in this step: a
    ``collectives.BatchReducer`` over the live axes that split the batch
    along a dim it reduces, or None where the rank holds the whole batch
    (no scope, one rank, ``predict``)."""
    s = active()
    if s is None:
        return None
    c = channel_axis % ndim
    axes = [a for a, d in s.batch_axes if d % ndim != c]
    return comm.BatchReducer(axes) if axes else None


def batch_shards(ndim: int):
    """``((dim, parts, index), ...)``: how this step's batch (an
    ``ndim``-D activation) is split over the live axes, one entry per
    split dim: the number of parts it is cut into and this rank's part.
    Several axes on one dim split it outer first, in the order of
    ``batch_axes`` (as ``Mesh4DTrainer._local`` cuts dp, then ep), so
    the part is ``Σ index_j · Π size_k (k after j)``.  Empty where the
    rank holds the whole batch.  A Dropout draws the whole batch's mask
    and keeps this rank's part, as the reference draws a global mask
    that GSPMD shards."""
    s = active()
    if s is None:
        return ()
    split = {}
    for a, d in s.batch_axes:
        if d < ndim:
            parts, index = split.get(d % ndim, (1, 0))
            split[d % ndim] = (parts * a.size, index * a.size + a.index)
    return tuple((d, parts, index) for d, (parts, index) in split.items())


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
    tp shard of ``w_param`` / ``b_param``; under :func:`paired` a column
    layer returns its slice and a row layer takes one."""
    dim = _tp_dim(w_param._sharding)
    b_local = b_param is not None and "tp" in spec_axes(b_param._sharding)
    role = active().paired.get(id(w_param))
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    if dim == 0:
        x = comm.copy_to(x, ax)
        if role == "out":
            if b is not None and not b_local:
                b = comm.scatter_to(b, ax, -1)
            return fc(x, w, b, False)
        y = fc(x, w, b if b_local else None, False)
        y = comm.gather_from(y, ax, -1)
        return y + b if b is not None and not b_local else y
    if b_local:
        raise MXNetError("a row-parallel Dense (weight P(None, 'tp')) "
                         "takes a replicated bias")
    if role != "in":
        x = comm.scatter_to(x, ax, -1)
    y = comm.reduce_from(fc(x, w, None, False), ax)
    return y + b if b is not None else y


def pair_axis(col, row):
    """The tp axis when Dense ``col`` is read column parallel and Dense
    ``row`` row parallel on the same axis in this step (Megatron's
    pair), else None."""
    a = local_axis(getattr(col, "weight", None))
    if a is None or a is not local_axis(getattr(row, "weight", None)):
        return None
    if row._flatten and not col._flatten:
        return None         # the row layer would fold a sliced dim
    try:
        dims = (_tp_dim(col.weight._sharding), _tp_dim(row.weight._sharding))
    except MXNetError:
        return None
    return a if dims == (0, 1) else None


@contextlib.contextmanager
def paired(col, row):
    """Run ``col``'s output into ``row`` as Megatron's pair when
    :func:`pair_axis` allows it (the caller guarantees that ``row`` is
    the column output's only consumer, through at most an elementwise
    activation); else a no-op."""
    s = active()
    if s is None or pair_axis(col, row) is None:
        yield
        return
    keys = (id(col.weight), id(row.weight))
    s.paired[keys[0]], s.paired[keys[1]] = "out", "in"
    try:
        yield
    finally:
        for k in keys:
            s.paired.pop(k, None)
