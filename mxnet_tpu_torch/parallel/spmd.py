"""The mesh side of ``SPMDTrainer``: what each rank holds and which
collectives a step makes (``mxnet_tpu/parallel/trainer.py:96-226,
746-813``).

The reference compiles one program for every device and lets GSPMD
place the collectives its shardings imply.  The port runs one process
per rank over ``torch.distributed`` and makes those collectives itself,
explicitly, inside the step (on a card, inside the step's CUDA graph):
an explicit collective has a known place and cost, where a DTensor would
decide both behind each op and would not run inside the captured step
the port already has.

Each rank trains on its shard of the batch: ``batch_axis`` over ``dp``,
and ``seq_axis`` over ``sp`` (every rank of an axis is handed the whole
batch, as the single-controller reference is, and keeps its slice).  Its
loss is its shard's mean over the number of data shards N (dp · sp), so
that the gradients summed over the data axes are those of the global
mean, and the loss it returns is that sum.

Per parameter (:class:`_Layout`), as the reference's shardings decide:

* its own spec (``Parameter.shard``): any ``PartitionSpec`` the
  reference takes, one axis name or a tuple of names (major first) per
  dim.  The rank holds its box of the value (``mesh.spec_box``), as the
  reference's ``NamedSharding`` does.  A ``Dense`` whose weight is cut
  over tp alone reads its shard through the tensor-parallel matmul
  (``tensor_parallel.dense``); anything else is all-gathered in the
  step, inner axis first.  The gather's backward depends on the axis: over
  an axis that splits the batch (dp, and sp over the sequence) the
  ranks' gradients differ and are reduce-scattered (``gather_sum``);
  over any other (tp, ep, pp) every rank holds the same gradient and
  keeps its slice (``gather_from``).  A reduce-scatter over tp would
  multiply the gradient by the tp width, a slice over dp would drop the
  other ranks' share;
* ZeRO (``zero_stage`` 1–3), composed as the reference's
  ``_composed_zero_spec``: a spec that names dp is left as it is; else a
  parameter with a free dim divisible by the dp width keeps its
  optimizer state as this rank's 1/dp chunk of the flattened (local)
  value.  Stages 1 and 2 coincide, as in the reference: the gradient is
  reduce-scattered over dp into the chunk, the chunk of the master is
  updated, and the masters are all-gathered back.  Stage 3 also keeps
  the master as the chunk (only for a parameter without its own spec,
  as ``_param_sharding`` does), all-gathered for each forward; the
  gather's backward reduce-scatters the gradient.  Chunking a flattened
  value changes nothing in an elementwise update, which every optimizer
  op with a multi-tensor form is, and holds the same bytes as the
  reference's cut of the largest divisible dim;
* otherwise the gradient is all-reduced over dp (and sp): over every
  data axis its gather did not already reduce-scatter.

Reductions of one kind are bucketed: one flat buffer and one collective
for all the parameters they cover.  Every collective over an axis of
size 1 is elided (``collectives``), so a mesh of one rank runs the
unmeshed step's arithmetic bit for bit.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.distributed as dist

from ..base import MXNetError
from . import collectives as comm
from .mesh import spec_axes, spec_box, spec_gather

__all__ = ["MeshRun"]

_PLAIN, _CHUNKED, _FSDP = "plain", "chunked", "fsdp"


def _names(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class _Layout:
    """What one rank holds of one parameter."""

    def __init__(self, key, param, mesh, zero_stage):
        self.key, self.param = key, param
        shape = tuple(param.shape)
        spec = list(param._sharding or ())
        if len(spec) > len(shape):
            raise MXNetError(f"parameter {key}: spec {param._sharding!r} "
                             f"longer than its shape {shape}")
        spec += [None] * (len(shape) - len(spec))
        self.spec = tuple(spec)
        # [(dim, axis)] of the live axes the value is cut over, in spec
        # order (dims in order, each dim's names major first)
        self.cuts, named = [], set()
        for dim, entry in enumerate(spec):
            for name in _names(entry):
                if name in named:
                    raise MXNetError(f"parameter {key}: axis {name!r} named "
                                     f"twice in {param._sharding!r}")
                named.add(name)
                ax = mesh.axis(name)
                if ax is None:
                    raise MXNetError(f"parameter {key} is sharded over "
                                     f"{name!r}; the mesh {mesh.shape} has "
                                     f"no {name} axis")
                if comm.live(ax):
                    self.cuts.append((dim, ax))
        try:
            self.start, self.local_shape = spec_box(shape, spec, mesh)
        except ValueError as e:
            raise MXNetError(f"parameter {key}: {e}") from None
        self.named = named
        self.own = {ax.name for _, ax in self.cuts}
        self.shape = shape
        self.numel = int(math.prod(self.local_shape))
        # the tp axis when tp alone cuts it, as a tensor-parallel Dense
        # reads it (tensor_parallel.dense)
        self.tp_dim, self.tp = None, None
        if named == {"tp"} and len(self.cuts) == 1:
            self.tp_dim, self.tp = self.cuts[0]
        # ZeRO: the reference's composition rule decides which parameters
        # shard over dp (a dp-divisible dim the spec leaves free; none
        # when the spec names dp)
        dp = mesh.axis("dp")
        divisible = comm.live(dp) and "dp" not in named and any(
            spec[d] is None and shape[d] % dp.size == 0
            for d in range(len(shape)))
        self.kind = _PLAIN
        if zero_stage >= 1 and divisible and param.grad_req != "null":
            self.kind = _FSDP if zero_stage >= 3 and not named else _CHUNKED
        self.dp = dp if self.kind != _PLAIN else None
        self.chunk = self.numel // dp.size if self.dp is not None else None
        # whether a Dense reads the local tp shard (else it is gathered);
        # MeshRun decides
        self.tp_native = False

    @property
    def sharded(self) -> bool:
        """The rank holds less than the whole master."""
        return bool(self.cuts) or self.kind == _FSDP

    def local_of(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's master cut from the whole value."""
        t = full[tuple(slice(a, a + n) for a, n in
                       zip(self.start, self.local_shape))]
        if self.kind == _FSDP:
            t = comm.flat_chunk(t.contiguous(), self.dp)
        return t.contiguous()

    def state_view(self, master: torch.Tensor) -> torch.Tensor:
        """What the optimizer updates: the master, or (stage 1/2) this
        rank's chunk of it, a view."""
        if self.kind == _CHUNKED:
            return comm.flat_chunk(master, self.dp)
        return master


class MeshRun:
    """The mesh, the layouts and the collectives of one meshed trainer."""

    def __init__(self, mesh, plan, net, params, keys, batch_axis, seq_axis,
                 zero_stage, micro_batches=1):
        if not mesh.is_member:
            raise MXNetError("this rank is not on the trainer's mesh")
        self.mesh, self.plan = mesh, plan
        self.batch_axis = batch_axis
        self.micro_batches = int(micro_batches)
        self.seq_axis = (seq_axis if seq_axis is not None
                         and "sp" in mesh.shape and seq_axis != batch_axis
                         else None)
        self.dp = mesh.axis("dp")
        self.sp = mesh.axis("sp") if self.seq_axis is not None else None
        self.data_axes = [a for a in (self.dp, self.sp) if comm.live(a)]
        self.n_data = math.prod(a.size for a in self.data_axes)
        # ((axis, batch dim), ...) for the layers' scope (BatchNorm)
        self.batch_axes = tuple((a, d) for a, d in (
            (self.dp, batch_axis), (self.sp, self.seq_axis))
            if comm.live(a))
        self.layouts = [_Layout(k, p, mesh, zero_stage)
                        for k, p in zip(keys, params)]
        # a Dense reads its own weight and bias as tp shards
        # (tensor_parallel.dense); any other block gets them gathered
        dense = _dense_params(net)
        for lay in self.layouts:
            lay.tp_native = lay.tp is not None and id(lay.param) in dense
        self.masters: List[Optional[torch.Tensor]] = [None] * len(params)
        self.tp_local = {id(lay.param): lay.tp for lay in self.layouts
                         if lay.tp_native}
        # bytes the step's sequence-parallel collectives move, by axis,
        # from its first run (collectives.tally)
        self.step_bytes = None

    # -- masters -------------------------------------------------------------
    def take(self):
        """Cut each sharded parameter's master from its value; the full
        tensors' storage is released and the parameters refuse reads
        until ``gather_params``."""
        for i, lay in enumerate(self.layouts):
            p = lay.param
            if not lay.sharded:
                continue
            with torch.no_grad():
                self.masters[i] = torch.nn.Parameter(
                    lay.local_of(p._data.detach()).clone(),
                    requires_grad=p.grad_req != "null")
            p._data.untyped_storage().resize_(0)
            p._shard_state = "stale"

    def master_list(self):
        return [m if m is not None else lay.param._data
                for m, lay in zip(self.masters, self.layouts)]

    def compute(self, tensors):
        """The tensors a forward reads, from the (cast) masters: stage-3
        chunks all-gathered over dp, boxes all-gathered over their axes
        (inner first) unless a Dense reads its tp shard itself.  Over an
        axis that splits the batch the gather's backward reduce-scatters
        the gradient; over any other it slices it."""
        batch = {a.name for a in self.data_axes}
        out = []
        for t, lay in zip(tensors, self.layouts):
            if lay.kind == _FSDP:
                t = comm.gather_sum(t, lay.dp).view(lay.local_shape)
            if not lay.tp_native:
                for dim, ax in reversed(lay.cuts):
                    t = (comm.gather_sum(t, ax, dim) if ax.name in batch
                         else comm.gather_from(t, ax, dim))
            out.append(t)
        return out

    # -- the batch -------------------------------------------------------------
    def local_batch(self, x, lead=0):
        """This rank's shard of a batch array (numpy or tensor):
        ``batch_axis`` over dp, ``seq_axis`` over sp; ``lead`` leading
        axes (a ``run_steps`` window) come first.  Under ``micro_batches``
        k the dp shard is taken micro-batch by micro-batch: the rank's
        j-th micro-batch is its shard of the global j-th, the rows whose
        statistics a BatchNorm of that micro-batch takes over all ranks,
        as the reference's micro-batches are cut from the global
        batch."""
        nd = x.ndim - lead
        for ax, dim in ((self.dp, self.batch_axis),
                        (self.sp, self.seq_axis)):
            if not comm.live(ax) or dim is None or dim >= nd:
                continue
            d = lead + dim
            k = self.micro_batches if ax is self.dp else 1
            if x.shape[d] % (ax.size * k):
                raise MXNetError(f"batch dim {dim} ({x.shape[d]}) not "
                                 f"divisible by the {ax.name} axis size "
                                 f"{ax.size}" + (f" times micro_batches="
                                                 f"{k}" if k > 1 else ""))
            m = x.shape[d] // (ax.size * k)
            shape = tuple(x.shape)
            x = x.reshape(shape[:d] + (k, ax.size, m) + shape[d + 1:])
            if isinstance(x, torch.Tensor):
                x = x.select(d + 1, ax.index)
            else:
                x = x.take(ax.index, axis=d + 1)
            x = x.reshape(shape[:d] + (k * m,) + shape[d + 1:])
        return x

    # -- the step's collectives ------------------------------------------------
    def scale_loss(self, loss):
        """A shard's loss as its share of the global mean."""
        return loss / self.n_data if self.n_data > 1 else loss

    def global_loss(self, loss):
        """The global mean from the shards' shares (no gradient)."""
        loss = loss.detach()
        for ax in self.data_axes:
            loss = comm.all_reduce_(loss.clone(), ax)
        return loss

    def reduce_grads(self, grads, live):
        """The live parameters' gradients summed over the data axes: the
        optimizer's view of each (stage 1/2: this rank's chunk).  A
        gradient whose gather already reduce-scattered it over an axis
        (a box cut over dp or sp, a stage-3 chunk) is not reduced over
        that axis again."""
        grads = list(grads)
        lays = [self.layouts[i] for i in live]
        if comm.live(self.dp):
            plain = [j for j, lay in enumerate(lays)
                     if lay.kind == _PLAIN and "dp" not in lay.own]
            chunked = [j for j, lay in enumerate(lays)
                       if lay.kind == _CHUNKED]
            for j, g in zip(plain, _bucket_all_reduce(
                    [grads[j] for j in plain], self.dp)):
                grads[j] = g
            for j, g in zip(chunked, _bucket_reduce_scatter(
                    [grads[j] for j in chunked], self.dp)):
                grads[j] = g
        if comm.live(self.sp):
            rest = [j for j, lay in enumerate(lays) if "sp" not in lay.own]
            for j, g in zip(rest, _bucket_all_reduce(
                    [grads[j] for j in rest], self.sp)):
                grads[j] = g
        return grads

    def agree(self, finite):
        """The AMP all-finite flag agreed by every rank of the mesh (each
        saw only its shards)."""
        group = self.mesh.all_group
        if group is None:
            return finite
        f = finite.to(torch.float32).reshape(1)
        dist.all_reduce(f, op=dist.ReduceOp.MIN, group=group)
        return f[0] > 0.5

    def gather_updated(self, masters):
        """Stage 1/2: every rank's updated chunk back into the masters."""
        idx = [i for i, lay in enumerate(self.layouts)
               if lay.kind == _CHUNKED]
        if not idx or not comm.live(self.dp):
            return
        by_dtype = {}
        for i in idx:
            by_dtype.setdefault(masters[i].dtype, []).append(i)
        n = self.dp.size
        for members in by_dtype.values():
            views = [self.layouts[i].state_view(masters[i]) for i in members]
            every = comm.all_gather_flat(torch.cat(views), self.dp)
            every = every.reshape(n, -1).split(
                [self.layouts[i].chunk for i in members], dim=1)
            torch._foreach_copy_([masters[i].view(-1) for i in members],
                                 [e.reshape(-1) for e in every])

    # -- whole values (collective) ---------------------------------------------
    def full_value(self, i, t):
        """The whole value of parameter ``i`` from this rank's ``t`` (its
        master, or a state of the same layout); collective over the
        parameter's axes."""
        lay = self.layouts[i]
        if lay.kind in (_FSDP, _CHUNKED) and t.numel() == lay.chunk:
            t = comm.all_gather_flat(t.reshape(-1), lay.dp).view(
                lay.local_shape)
        return spec_gather(t, lay.spec, self.mesh)

    # -- persistence -----------------------------------------------------------
    def box(self, i):
        """``(start, stop)`` of this rank's box of parameter ``i`` in the
        whole value (the whole value for one without a spec)."""
        lay = self.layouts[i]
        return lay.start, tuple(a + n for a, n in
                                zip(lay.start, lay.local_shape))

    def _chunked(self, i, t):
        lay = self.layouts[i]
        return lay.dp is not None and t.numel() == lay.chunk

    def pieces(self, i, t):
        """What this rank writes of ``t`` (parameter ``i``'s master, or a
        state of its layout) in a save: a ``checkpoint.Pieces`` of its
        boxes of the whole value, or None when another rank writes the
        same bytes."""
        from ..checkpoint import box_pieces
        lay = self.layouts[i]
        chunked = self._chunked(i, t)
        own = lay.own | ({"dp"} if chunked else set())
        if not self.mesh.writes(own):
            return None
        return box_pieces(lay.shape, lay.start, lay.local_shape, t,
                          lay.dp.index * lay.chunk if chunked else None)

    def from_box(self, i, box, like):
        """This rank's tensor, shaped as ``like``, from its box of the
        whole value (a ZeRO chunk cut from it when ``like`` is one)."""
        if self._chunked(i, like):
            return comm.flat_chunk(box.contiguous(), self.layouts[i].dp)
        return box.reshape(like.shape)

    # -- telemetry -------------------------------------------------------------
    def comm_model(self, amp, tokens):
        """The reference's analytic bytes a step (``trainer.py:746-813``):
        ``(reduce-scatter, all-gather, all-reduce, tp)`` over dp and tp."""
        from ..amp import policy as _amp_policy
        ndp = self.mesh.shape.get("dp", 1)
        ntp = self.mesh.shape.get("tp", 1)
        gfrac = min(_amp_policy.compute_itemsize(), 4) / 4.0 if amp else 1.0
        isz = _amp_policy.compute_itemsize() if amp else 4
        rs = ag = ar = tpb = 0
        for lay in self.layouts:
            p = lay.param
            nbytes = int(math.prod(lay.shape)) * p.dtype.itemsize
            if ndp > 1:
                # the optimizer state's spec names dp: ZeRO's composed
                # chunk, or the parameter's own spec
                if lay.kind != _PLAIN or "dp" in lay.named:
                    rs += int(nbytes * gfrac) * (ndp - 1) // ndp
                    ag += nbytes * (ndp - 1) // ndp
                else:
                    ar += 2 * int(nbytes * gfrac) * (ndp - 1) // ndp
            spec = p._sharding
            if ntp > 1 and len(lay.shape) >= 2 and "tp" in spec_axes(spec):
                first = spec[0] if len(spec) else None
                col = first == "tp" or (isinstance(first, (tuple, list))
                                        and "tp" in first)
                dim = int(lay.shape[1]) if col else int(lay.shape[0])
                tpb += 2 * tokens * dim * isz * (ntp - 1) // ntp
        return rs, ag, ar, tpb


def _dense_params(net):
    """ids of the weights and biases of the ``Dense`` blocks in ``net``."""
    from ..gluon.nn.basic_layers import Dense
    ids = set()

    def visit(block):
        if isinstance(block, Dense):
            ids.update(id(p) for p in (block.weight, block.bias)
                       if p is not None)

    net.apply(visit)
    return ids


def _bucket_all_reduce(tensors, axis):
    """All-reduce each tensor over ``axis``: one flat buffer and one call
    per dtype.  Returns the reduced tensors (views of the buffers)."""
    if not tensors:
        return []
    out = [None] * len(tensors)
    by_dtype = {}
    for j, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(j)
    for members in by_dtype.values():
        flat = torch.cat([tensors[j].reshape(-1) for j in members])
        comm.all_reduce_(flat, axis)
        for j, piece in zip(members, flat.split(
                [tensors[j].numel() for j in members])):
            out[j] = piece.view(tensors[j].shape)
    return out


def _bucket_reduce_scatter(tensors, axis):
    """Each tensor summed over ``axis``, this rank's 1/n chunk of its
    flattened value: one reduce-scatter per dtype."""
    if not tensors:
        return []
    n = axis.size
    out = [None] * len(tensors)
    by_dtype = {}
    for j, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(j)
    for members in by_dtype.values():
        rows = torch.cat([tensors[j].reshape(n, -1) for j in members], dim=1)
        mine = comm.reduce_scatter_flat(rows.reshape(-1), axis)
        for j, piece in zip(members, mine.split(
                [tensors[j].numel() // n for j in members])):
            out[j] = piece
    return out
