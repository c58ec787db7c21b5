"""One mesh over every parallelism axis, and the 4-D trainer over it
(counterpart of ``mxnet_tpu/parallel/mesh4d.py``): :class:`MeshPlan`,
the plan object ``SPMDTrainer(mesh=...)`` and :class:`Mesh4DTrainer`
accept, and :func:`mesh_plan_from_env` (``MXNET_MESH``).

A plan builds one :class:`~.mesh.Mesh` carrying the axes pp, dp, ep, sp
and tp in that order (pp outermost, tp innermost), size-1 axes included,
so a spec naming tp stays valid on a dp4×tp1 mesh.  It derives the
composed specs (``batch_spec``, ``zero_spec``: the ZeRO dp shard on the
largest still-unsharded dp-divisible axis), the analytic ring cost of
one collective (``ring_bytes``), which the telemetry producers use, and
Megatron's column → row pair kept sharded (``tp_column`` / ``tp_row``).

:class:`Mesh4DTrainer` composes pp (1F1B), dp (ZeRO), tp and ep with the
AMP policy in one captured executable a ``run_steps`` window.
"""
from __future__ import annotations

import os
import re
import time
from functools import partial
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as onp
import torch
from torch.utils import _pytree as pytree

from .. import telemetry, tracing
from ..amp import policy as _amp_policy
from ..amp.loss_scaler import advance_device, all_finite, device_state
from ..base import MXNetError
from ..executable import CaptureOwner, Executable, input_spec
from ..ops.tensor import IdCheck
from . import collectives as comm
from . import tensor_parallel as _tp
from .pipeline import _grad_or_zeros
from .mesh import (Mesh, NamedSharding, PartitionSpec, make_mesh, spec_axes,
                   spec_box, spec_gather)

__all__ = ["MeshPlan", "Mesh4DTrainer", "mesh_plan_from_env"]

_AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")


class MeshPlan:
    """One mesh, every parallelism axis, composed specs.

    ``MeshPlan(dp=2, tp=2)`` on 4+ ranks builds a mesh whose axis names
    are exactly pp, dp, ep, sp, tp (size-1 axes included); ``dp=-1``
    fills the ranks the named axes leave over."""

    def __init__(self, dp: int = -1, tp: int = 1, pp: int = 1,
                 ep: int = 1, sp: int = 1,
                 devices: Optional[Sequence[int]] = None, *, device=None):
        sizes = {"dp": int(dp), "tp": int(tp), "pp": int(pp),
                 "ep": int(ep), "sp": int(sp)}
        for ax, s in sizes.items():
            if s == 0 or s < -1:
                raise MXNetError(f"MeshPlan: bad {ax}={s} (>=1, or "
                                 f"dp=-1 to fill)")
            if s == -1 and ax != "dp":
                raise MXNetError(f"MeshPlan: only dp may be -1, got "
                                 f"{ax}=-1")
        self._mesh = make_mesh({ax: sizes[ax] for ax in _AXIS_ORDER},
                               devices, device=device)
        self.dp = int(self._mesh.shape["dp"])
        self.tp = int(self._mesh.shape["tp"])
        self.pp = int(self._mesh.shape["pp"])
        self.ep = int(self._mesh.shape["ep"])
        self.sp = int(self._mesh.shape["sp"])

    @classmethod
    def from_env(cls, default: Optional[str] = None,
                 devices: Optional[Sequence[int]] = None
                 ) -> Optional["MeshPlan"]:
        """Build from ``MXNET_MESH`` (``dp2,tp2`` / ``dp=2,tp=2`` /
        ``dp:2 tp:2``); None when unset and no ``default`` given."""
        spec = os.environ.get("MXNET_MESH", default)
        if not spec:
            return None
        sizes: Dict[str, int] = {}
        for tok in re.split(r"[,\s]+", spec.strip()):
            if not tok:
                continue
            m = re.fullmatch(r"(dp|tp|pp|ep|sp)[=:]?(-?\d+)", tok)
            if m is None:
                raise MXNetError(
                    f"MXNET_MESH: cannot parse {tok!r} in {spec!r} "
                    f"(expected e.g. dp2,tp2)")
            sizes[m.group(1)] = int(m.group(2))
        return cls(devices=devices, **sizes)

    @property
    def mesh(self) -> Mesh:
        return self._mesh

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {ax: int(self._mesh.shape[ax]) for ax in _AXIS_ORDER}

    def describe(self) -> str:
        """One-line mesh summary for logs and reports."""
        live = [f"{ax}{n}" for ax, n in self.axis_sizes.items() if n > 1]
        return "×".join(live) if live else "single-device"

    def named(self, *spec) -> NamedSharding:
        return NamedSharding(self._mesh, PartitionSpec(*spec))

    @property
    def replicated(self) -> NamedSharding:
        return self.named()

    def batch_spec(self, ndim: int, batch_axis: int = 0,
                   seq_axis: Optional[int] = None) -> PartitionSpec:
        """Batch tensors: dp on the batch axis, sp on the sequence axis
        when sequence parallelism is requested."""
        spec = [None] * ndim
        if batch_axis < ndim:
            spec[batch_axis] = "dp"
        if (seq_axis is not None and seq_axis < ndim
                and seq_axis != batch_axis and self.sp > 1):
            spec[seq_axis] = "sp"
        return PartitionSpec(*spec)

    def batch_sharding(self, ndim: int, batch_axis: int = 0,
                       seq_axis: Optional[int] = None) -> NamedSharding:
        return NamedSharding(self._mesh,
                             self.batch_spec(ndim, batch_axis, seq_axis))

    @staticmethod
    def column_spec(ndim: int = 2) -> PartitionSpec:
        """Column-parallel weight in the gluon (out, in) layout: the output
        dim sharded over tp."""
        return PartitionSpec(*(("tp",) + (None,) * (ndim - 1)))

    @staticmethod
    def row_spec(ndim: int = 2) -> PartitionSpec:
        """Row-parallel weight in the gluon (out, in) layout: the input dim
        sharded over tp."""
        return PartitionSpec(*((None,) * (ndim - 1) + ("tp",)))

    def tp_column(self, x, feature_axis: int = -1):
        """Mark a column-parallel matmul's output: ``x`` is this rank's
        slice of the feature axis (the step hands a stage function the tp
        shards of its weights).  Returned as it is: the pair's collective
        is :meth:`tp_row`'s."""
        if x.dim() and not -x.dim() <= feature_axis < x.dim():
            raise MXNetError(f"tp_column: feature axis {feature_axis} of a "
                             f"{x.dim()}-d tensor")
        return x

    def tp_row(self, x):
        """A row-parallel matmul's output, replicated over tp: ``x`` is
        this rank's partial sum, all-reduced over tp (the column → row
        pair's one forward collective).  Its backward all-reduces too:
        inside ``Mesh4DTrainer``'s step every tp rank seeds 1/tp of the
        loss, so the gradients of replicated values are partial sums as
        well, and the trainer sums those of its replicated parameters
        over tp.  On a tp axis of size 1 it is the identity."""
        sc = _tp.active()
        if sc is not None:
            sc.tp_rows += 1
        return comm.all_reduce(x, self._mesh.axis("tp"))

    def zero_spec(self, shape, base_spec: Optional[PartitionSpec] = None
                  ) -> Optional[PartitionSpec]:
        """Compose the ZeRO dp shard onto ``base_spec``: the largest
        still-unsharded dp-divisible axis takes dp.  Returns ``base_spec``
        unchanged (possibly None) when nothing divides or dp is 1."""
        if self.dp <= 1:
            return base_spec
        base = list(base_spec) if base_spec is not None else []
        base += [None] * (len(shape or ()) - len(base))
        if "dp" in spec_axes(base):
            return base_spec
        best = None
        for ax, dim in enumerate(shape or ()):
            if base[ax] is not None:
                continue
            if dim % self.dp == 0 and (best is None or dim > shape[best]):
                best = ax
        if best is None:
            return base_spec
        base[best] = "dp"
        return PartitionSpec(*base)

    def param_sharding(self, spec: Optional[PartitionSpec]
                       ) -> NamedSharding:
        return NamedSharding(self._mesh, spec or PartitionSpec())

    def opt_state_sharding(self, shape, spec: Optional[PartitionSpec] = None,
                           zero: bool = True) -> NamedSharding:
        """Optimizer-state sharding for a leaf of ``shape`` whose parameter
        carries ``spec``: its own axes plus (``zero=True``) the composed
        ZeRO dp shard."""
        s = self.zero_spec(shape, spec) if zero else spec
        return NamedSharding(self._mesh, s or PartitionSpec())

    def ring_bytes(self, nbytes: int, axis: str,
                   kind: str = "allreduce") -> int:
        """Ring-cost wire bytes for one collective of ``nbytes`` payload
        over ``axis``: all-reduce 2(n-1)/n, reduce-scatter / all-gather /
        all-to-all (n-1)/n, ppermute the full payload per hop."""
        n = self.axis_sizes.get(axis, 1)
        if n <= 1:
            return 0
        if kind == "allreduce":
            return 2 * int(nbytes) * (n - 1) // n
        if kind == "ppermute":
            return int(nbytes)
        return int(nbytes) * (n - 1) // n


def mesh_plan_from_env() -> Optional[MeshPlan]:
    """The process-wide ``MXNET_MESH`` plan, or None when unset."""
    return MeshPlan.from_env()


class _Leaf:
    """One parameter leaf as this rank holds it: the box of the global
    value its spec gives it (its f32 master) and the momentum, this
    rank's dp chunk of the flattened master under ZeRO."""

    def __init__(self, plan, value, spec, zero, device):
        mesh = plan.mesh
        self.shape = tuple(value.shape)
        spec = tuple(spec or ())
        if len(spec) > len(self.shape):
            raise MXNetError(f"param spec {spec!r} longer than its leaf "
                             f"{self.shape}")
        self.spec = spec + (None,) * (len(self.shape) - len(spec))
        self.axes = spec_axes(self.spec)
        bad = self.axes - {"pp", "tp", "ep"}
        if bad:
            raise MXNetError(f"param spec {spec!r}: the port shards "
                             f"parameters over pp, tp and ep (not "
                             f"{sorted(bad)})")
        self.start, self.local_shape = spec_box(self.shape, self.spec, mesh)
        t = torch.as_tensor(onp.asarray(value) if not isinstance(
            value, torch.Tensor) else value)
        self.floating = t.is_floating_point()
        whole = t.to(device, torch.float32 if self.floating else t.dtype)
        box = tuple(slice(a, a + n) for a, n in
                    zip(self.start, self.local_shape))
        self.master = whole[box].clone()
        dp = mesh.axis("dp")
        composed = plan.zero_spec(self.shape, PartitionSpec(*self.spec))
        self.dp = dp if (zero and comm.live(dp) and self.floating
                         and "dp" in spec_axes(composed)) else None
        n = self.master.numel()
        self.chunk = n // dp.size if self.dp is not None else n
        self.momentum = torch.zeros(
            (self.chunk,) if self.dp is not None else self.local_shape,
            dtype=torch.float32, device=device)

    def view(self, master):
        """What the update reads and writes of the master."""
        if self.dp is None:
            return master
        return comm.flat_chunk(master, self.dp)

    def pieces(self, mesh, t, chunked):
        """What this rank writes of ``t`` in a save (a
        ``checkpoint.Pieces``), or None when another rank writes it."""
        from ..checkpoint import box_pieces
        if not mesh.writes(self.axes | ({"dp"} if chunked else set())):
            return None
        return box_pieces(self.shape, self.start, self.local_shape, t,
                          self.dp.index * self.chunk if chunked else None)


def _unpack(res):
    """``(out, aux, dropped)`` of what a stage function returned."""
    if isinstance(res, tuple):
        return (res[0], res[1] if len(res) > 1 else None,
                res[2] if len(res) > 2 else None)
    return res, None, None


class Mesh4DTrainer:
    """The 4-D trainer: one captured executable a ``run_steps`` window,
    composing dp (ZeRO), tp, pp (1F1B), ep (Switch MoE) and the AMP
    policy.

    Every rank passes the reference's global parameters (a pytree of
    numpy arrays or tensors) and keeps its part of each leaf, the box
    its ``param_specs`` entry gives it; every rank passes the same whole
    batch and trains on its rows.  Two composition paths, by the plan's
    pp size:

    - ``pp == 1``: ``stage_fn(params, x)`` is a plain function of this
      rank's parameter parts (the reference's GSPMD path).  The batch is
      split over dp and ep.  A leaf sharded over tp reaches it as its tp
      shard: Megatron's column → row pair kept sharded, the column
      matmul's output marked ``plan.tp_column`` and the row matmul's
      partial sum reduced by ``plan.tp_row`` (every tp rank seeds 1/tp
      of the loss, and the gradients of leaves not sharded over tp are
      summed over it).  The port has no GSPMD to place that all-reduce:
      a step with tp-sharded leaves whose stage function never calls
      ``tp_row`` raises.  Leaves sharded over ep reach it as their
      expert shards, and ``switch_moe`` called with no mesh routes every
      rank's tokens over dp × ep and shuffles them over ep.
      ``stage_fn`` may return ``(out, aux_loss)`` or ``(out, aux_loss,
      dropped)`` (dropped tokens, recorded in ``moe.dropped_tokens``).
    - ``pp > 1``: ``stage_fn(stage_params, h)`` is one stage of the 1F1B
      schedule (:mod:`.pipeline`), leaves carry a leading stage axis of
      size pp and specs like ``P('pp', None, 'tp')``; the stage function
      makes its own tp collectives (``collectives.copy_to`` /
      ``reduce_from``, or ``all_reduce`` for ``lax.psum``).  Specs naming
      ep are refused: expert parallelism composes on the pp == 1 path.

    The optimizer is SGD with momentum (``m = mu·m + g``, ``w -= lr·(m +
    wd·w)``) on f32 masters under ZeRO: a leaf with a free dp-divisible
    axis (``MeshPlan.zero_spec``) keeps its momentum as this rank's dp
    chunk of the flattened master (``collectives.flat_chunk``), its
    gradient is reduce-scattered over dp into it and the updated chunks
    all-gathered back; any other leaf's gradient is all-reduced.  Under
    the AMP policy the parameters and floating data are cast to its
    compute dtype inside the step (the gradients arrive in f32 on the
    masters and take the ``wire_cast`` round trip), with a dynamic loss
    scale on the device (grown x2 after 2000 clean steps, halved on an
    overflow, whose update is skipped).

    ``run_steps(n)`` runs one executable per (batch signature, n,
    ``per_step_data``): on CUDA the window's n steps captured in one CUDA
    graph (its first call runs them eagerly and captures), replayed by
    later calls — one dispatch a window.  On the CPU it runs uncaptured.
    ``save_checkpoint`` / ``load_checkpoint`` persist the f32 masters
    and the momentum as global arrays, each rank writing and reading
    only its boxes (collective), so a dp2×tp2 save restores bit for bit
    onto a dp4×tp1 plan."""

    def __init__(self, plan: MeshPlan, stage_fn: Callable,
                 loss_fn: Callable, params, *,
                 param_specs=None, learning_rate: float = 0.01,
                 momentum: float = 0.9, weight_decay: float = 0.0,
                 n_microbatches: Optional[int] = None,
                 zero: bool = True, donate: bool = True):
        self.plan = plan
        self.stage_fn = stage_fn
        self.loss_fn = loss_fn
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.zero = bool(zero)
        self._donate = bool(donate)       # updates are in place anyway
        self.n_microbatches = int(n_microbatches
                                  if n_microbatches is not None
                                  else max(plan.pp, 1))
        self.num_update = 0
        mesh = plan.mesh
        if not mesh.is_member:
            raise MXNetError("this rank is not on the plan's mesh")
        self.device = mesh.device
        leaves, self._treedef = pytree.tree_flatten(params)
        if param_specs is None:
            specs = [None] * len(leaves)
        else:
            specs = pytree.tree_flatten(
                param_specs, is_leaf=lambda s: s is None
                or isinstance(s, PartitionSpec))[0]
        if len(specs) != len(leaves):
            raise MXNetError(
                f"param_specs has {len(specs)} leaves, params "
                f"{len(leaves)}")
        if plan.pp > 1:
            for lf, sp in zip(leaves, specs):
                if lf.shape[0] != plan.pp:
                    raise MXNetError(
                        f"pp={plan.pp}: param leaf {tuple(lf.shape)} must "
                        f"carry a leading stage axis of size pp")
                if "ep" in spec_axes(sp):
                    raise MXNetError(
                        "expert parallelism ('ep' in a param spec) "
                        "composes on the GSPMD path (pp=1); in-pipeline "
                        "MoE runs with replicated experts")
            specs = [s if s is not None else PartitionSpec("pp")
                     for s in specs]
        self._specs = specs
        self._leaves = [_Leaf(plan, lf, sp, self.zero, self.device)
                        for lf, sp in zip(leaves, specs)]
        self._amp = _amp_policy.enabled()
        self._compute_dtype = (_amp_policy.compute_dtype() if self._amp
                               else None)
        # (scale, clean steps, skipped steps) on the device
        self._amp_state = device_state(self.device)
        if self._amp:
            half = _amp_policy.compute_dtype_str() == "float16"
            self._amp_state[0].fill_(2.0 ** 16 if half else 1.0)
        self._dp = mesh.axis("dp")
        self._tp = mesh.axis("tp")
        self._pp = mesh.axis("pp")
        # the axes the batch is split over (dp, and ep on the pp == 1 path)
        self._data = [a for a in (self._dp, None if plan.pp > 1
                                  else mesh.axis("ep")) if comm.live(a)]
        self._n_data = int(onp.prod([a.size for a in self._data]))
        # signature -> (Executable, its IdCheck)
        self._exec: Dict[Any, Any] = {}
        self._owner = CaptureOwner()
        self._drops = False
        self._comm_model = None
        self.compiles = 0

    # -- views ------------------------------------------------------------------
    @property
    def params(self):
        """This rank's f32 master parts as the constructor's pytree."""
        return pytree.tree_unflatten([lf.master for lf in self._leaves],
                                     self._treedef)

    def gather_params(self):
        """The whole f32 masters as the constructor's pytree, on every
        rank (collective)."""
        return pytree.tree_unflatten(
            [self._whole(lf, lf.master) for lf in self._leaves],
            self._treedef)

    def gather_momentum(self):
        """The whole momentum as the constructor's pytree (collective)."""
        out = []
        for lf in self._leaves:
            m = lf.momentum
            if lf.dp is not None:
                m = comm.all_gather_flat(m, lf.dp).view(lf.local_shape)
            out.append(self._whole(lf, m))
        return pytree.tree_unflatten(out, self._treedef)

    def _whole(self, lf, t):
        return spec_gather(t, lf.spec, self.plan.mesh)

    @property
    def loss_scale(self) -> float:
        return float(self._amp_state[0])

    # -- the step ---------------------------------------------------------------
    def _cast(self, a):
        if self._compute_dtype is not None and a.is_floating_point():
            return a.to(self._compute_dtype)
        return a

    def _value_and_grads(self, ids, x, y, scale):
        """``(loss, grads, dropped)`` of this rank's rows: the loss the
        rank's share of the global mean (times ``scale``), the gradients
        summed over the data axes (and tp), before the division by their
        size."""
        plan = self.plan
        ps = [lf.master.detach().requires_grad_(lf.floating)
              for lf in self._leaves]
        if plan.pp > 1:
            from .pipeline import _microbatches, one_f_one_b_apply
            cast, M = self._cast, self.n_microbatches

            def stage(sp, h):
                return self.stage_fn(pytree.tree_map(cast, sp), cast(h))

            def lfn(out, t):
                loss = self.loss_fn(out, t).to(torch.float32)
                return loss * scale if scale is not None else loss

            body = one_f_one_b_apply(stage, lfn, plan.pp, M, "pp",
                                     mesh=plan.mesh)
            local = pytree.tree_unflatten([p[0] for p in ps], self._treedef)
            with ids:
                loss, grads = body(local, _microbatches(self._cast(x), M),
                                   _microbatches(y, M))
            grads = [g[None] for g in pytree.tree_flatten(grads)[0]]
            dropped = None
        else:
            with torch.enable_grad():
                tree = pytree.tree_unflatten([self._cast(p) for p in ps],
                                             self._treedef)
                with _tp.scope(plan.mesh,
                               batch_axes=[(a, 0) for a in self._data],
                               moe_axes=[a.name for a in self._data]) \
                        as sc, ids:
                    out, aux, dropped = _unpack(
                        self.stage_fn(tree, self._cast(x)))
                tp_sharded = comm.live(self._tp) and any(
                    "tp" in lf.axes for lf in self._leaves)
                if tp_sharded and not sc.tp_rows:
                    raise MXNetError(
                        "Mesh4DTrainer: leaves sharded over tp reach the "
                        "stage function as their shards, and it never "
                        "called plan.tp_row: the port has no GSPMD to "
                        "reduce the row-parallel partial sums (mark the "
                        "pair with plan.tp_column / plan.tp_row)")
                loss = self.loss_fn(out, y).to(torch.float32)
                if aux is not None:
                    loss = loss + aux.to(torch.float32)
                if scale is not None:
                    loss = loss * scale
                seed = loss / self._tp.size if comm.live(self._tp) \
                    else loss
                live = [p for p in ps if p.requires_grad]
                got = iter(torch.autograd.grad(seed, live,
                                               allow_unused=True))
            grads = [(_grad_or_zeros(next(got), p) if p.requires_grad
                      else None) for p in ps]
            if comm.live(self._tp):
                for g, lf in zip(grads, self._leaves):
                    if g is not None and "tp" not in lf.axes:
                        comm.all_reduce_(g, self._tp)
        loss = loss.detach()
        for a in self._data:
            loss = comm.all_reduce_(loss.clone(), a)
        # experts (sharded over ep) got every ep rank's tokens' gradient
        # through the all-to-all
        for g, lf in zip(grads, self._leaves):
            if g is None:
                continue
            for a in self._data:
                if a.name != "dp" and a.name not in lf.axes:
                    comm.all_reduce_(g, a)
        return loss, grads, dropped

    @torch.no_grad()
    def _step(self, ids, x, y):
        """One training step on this rank's rows: ``(loss, dropped)``."""
        st = self._amp_state
        scale = st[0] if self._amp else None
        loss, grads, dropped = self._value_and_grads(ids, x, y, scale)
        n = float(self._n_data)
        news = []
        for g, lf in zip(grads, self._leaves):
            if g is None:
                news.append(None)
                continue
            g = g.to(torch.float32)
            if lf.dp is not None:
                g = comm.reduce_scatter_flat(g.reshape(-1), lf.dp)
            elif comm.live(self._dp):
                g = comm.all_reduce_(g, self._dp)
            news.append(g / n if n > 1 else g)
        loss = loss / n if n > 1 else loss
        finite = None
        if self._amp:
            inv = 1.0 / scale
            loss = loss * inv
            news = [g * inv if g is not None else None for g in news]
            finite = all_finite([g for g in news if g is not None])
            group = self.plan.mesh.all_group
            if group is not None:
                f = finite.to(torch.float32).reshape(1)
                torch.distributed.all_reduce(
                    f, op=torch.distributed.ReduceOp.MIN, group=group)
                finite = f[0] > 0.5
            news = [_amp_policy.wire_cast(g) if g is not None else None
                    for g in news]
        lr, mu, wd = self.learning_rate, self.momentum, self.weight_decay
        for g, lf in zip(news, self._leaves):
            if g is None:
                continue
            w = lf.view(lf.master)
            m = lf.momentum
            g = g.view(m.shape)
            m2 = mu * m + g
            w2 = w - lr * (m2 + wd * w)
            if finite is not None:
                m2 = torch.where(finite, m2, m)
                w2 = torch.where(finite, w2, w)
            m.copy_(m2)
            w.copy_(w2)
            if lf.dp is not None:
                lf.master.view(-1).copy_(comm.all_gather_flat(w, lf.dp))
        if finite is not None:
            advance_device(st, finite, 2.0, 2000)
        if dropped is None:
            dropped = torch.zeros((), dtype=torch.int32, device=self.device)
        else:
            self._drops = True
        return loss, dropped.to(torch.int32)

    def _window(self, ids, n_steps, per_step, x, y):
        """``n_steps`` steps: ``(losses (n,), dropped tokens summed, the
        embedding ids' bounds)``.  An embedding in the stage function
        runs under the deferred id check (``ops.tensor.IdCheck``), raised
        at the next call, as ``SPMDTrainer``'s."""
        ids.reset()
        losses, drops = [], []
        for i in range(n_steps):
            loss, dropped = self._step(ids, x[i] if per_step else x,
                                       y[i] if per_step else y)
            losses.append(loss)
            drops.append(dropped)
        return torch.stack(losses), torch.stack(drops).sum(), ids.bounds()

    # -- the host API -------------------------------------------------------------
    def _local(self, a, lead):
        """This rank's rows of a whole batch array: the batch axis split
        over the data axes (outer first)."""
        if isinstance(a, torch.Tensor):
            a = a.detach()
        else:
            a = onp.asarray(getattr(a, "asnumpy", lambda: a)())
        for ax in self._data:
            n = a.shape[lead]
            if n % ax.size:
                raise MXNetError(f"batch {n} not divisible by the "
                                 f"{ax.name} axis size {ax.size}")
            k = n // ax.size
            idx = [slice(None)] * a.ndim
            idx[lead] = slice(ax.index * k, (ax.index + 1) * k)
            a = a[tuple(idx)]
        return a

    def run_steps(self, data, label, n_steps: int = 1,
                  per_step_data: bool = False):
        """``n_steps`` training steps in one dispatch (one captured
        executable a window).  With ``per_step_data=True`` the inputs carry
        a leading ``n_steps`` axis consumed one batch a step.  Returns the
        steps' losses, an (n_steps,) f32 tensor on the device."""
        n = int(n_steps)
        lead = 1 if per_step_data else 0
        if per_step_data and (data.shape[0] != n or label.shape[0] != n):
            raise MXNetError(
                f"run_steps(per_step_data=True): leading axis must be "
                f"n_steps={n}, got {tuple(data.shape)}/"
                f"{tuple(label.shape)}")
        d, l = self._local(data, lead), self._local(label, lead)
        sig = (input_spec(d), input_spec(l), n, bool(per_step_data),
               _amp_policy.cache_token())
        self._owner.check_ids()
        entry = self._exec.get(sig)
        fresh = entry is None
        if fresh:
            ids = IdCheck()
            entry = self._exec[sig] = (Executable(
                partial(self._window, ids, n, bool(per_step_data)), (d, l),
                self.device, *self._owner.capture_with(self.device),
                warm="first_call"), ids)
            self.compiles += 1
        ex, ids = entry
        tok = telemetry.begin_step()
        try:
            with tracing.span("step.mesh4d_window", n_steps=n,
                              mesh=self.plan.describe()):
                t0 = time.perf_counter()
                with tracing.span("compile.spmd_step" if fresh
                                  else "step.dispatch"):
                    try:
                        losses, dropped, bounds = ex(d, l)
                    except BaseException:
                        if fresh:
                            self._exec.pop(sig, None)
                        raise
                    telemetry.record_dispatch()
                if fresh:
                    telemetry.record_compile(time.perf_counter() - t0,
                                             "spmd_step")
                losses = losses.clone()
                self._owner.defer_ids(bounds, ids.vocabs, self.device)
                self.num_update += n
                self._account(n, data[0] if per_step_data else data)
                if self._drops:
                    telemetry.record_moe_dropped(int(dropped))
        finally:
            telemetry.end_step(tok, "Mesh4DTrainer", extra={"n_steps": n})
        return losses

    def step(self, data, label):
        """One training step; returns the 0-d loss."""
        return self.run_steps(data, label, n_steps=1)[0]

    # -- per-axis comm accounting -----------------------------------------------
    def _account(self, n_steps: int, d) -> None:
        """The reference's analytic per-axis wire bytes of one window
        (``mesh4d.py:598-668``): dp the gradients' reduce-scatter and the
        masters' all-gather under ZeRO (else their all-reduce), at the AMP
        wire itemsize on gradient legs; tp one activation all-reduce a
        tp-sharded leaf, forward and backward; pp each microbatch's
        activations S-1 hops forward and S-1 back; ep the dispatch and
        combine all-to-alls, forward and backward."""
        model = self._comm_model
        if model is None:
            plan = self.plan
            isz = _amp_policy.compute_itemsize() if self._amp else 4
            gfrac = isz / 4.0
            model = {ax: 0 for ax in ("dp", "tp", "pp", "ep")}
            rs = ag = ar = 0
            for lf in self._leaves:
                nb = int(onp.prod(lf.shape, dtype=onp.int64)) * 4
                if plan.dp > 1:
                    if lf.dp is not None:
                        rs += plan.ring_bytes(int(nb * gfrac), "dp",
                                              "reduce_scatter")
                        ag += plan.ring_bytes(nb, "dp", "all_gather")
                    else:
                        ar += plan.ring_bytes(int(nb * gfrac), "dp",
                                              "allreduce")
            model["dp"] = rs + ag + ar
            self._comm_split = (rs, ag, ar)
            act_bytes = (int(onp.prod(tuple(d.shape), dtype=onp.int64))
                         or 1) * isz
            if plan.tp > 1:
                n_tp = sum(1 for s in self._specs if "tp" in spec_axes(s))
                model["tp"] = 2 * max(n_tp, 1) * plan.ring_bytes(
                    act_bytes, "tp", "allreduce")
            if plan.pp > 1:
                mb = act_bytes // max(self.n_microbatches, 1)
                model["pp"] = (2 * self.n_microbatches * (plan.pp - 1)
                               * plan.ring_bytes(mb, "pp", "ppermute"))
            if plan.ep > 1:
                model["ep"] = 4 * plan.ring_bytes(act_bytes, "ep",
                                                  "all_to_all")
            self._comm_model = model
        rs, ag, ar = self._comm_split
        if rs or ag:
            telemetry.record_comm_bytes(rs * n_steps, "reduce_scatter")
            telemetry.record_comm_bytes(ag * n_steps, "all_gather")
        if ar:
            telemetry.record_comm_bytes(ar * n_steps, "allreduce")
        if model["tp"]:
            telemetry.record_comm_bytes(model["tp"] * n_steps, "allreduce")
        if model["pp"]:
            telemetry.record_comm_bytes(model["pp"] * n_steps, "ppermute")
        if model["ep"]:
            telemetry.record_comm_bytes(model["ep"] * n_steps,
                                        "all_to_all")
        for ax, b in model.items():
            if b:
                telemetry.record_axis_comm_bytes(b * n_steps, ax)
        telemetry.record_opt_state_bytes(self.state_bytes_per_device(
            params=False))

    def state_bytes_per_device(self, params: bool = True) -> int:
        """Bytes of momentum (and, with ``params``, f32 masters) on this
        rank's device: what the ZeRO × tp composition shrinks."""
        arrays = [lf.momentum for lf in self._leaves]
        if params:
            arrays += [lf.master for lf in self._leaves]
        return sum(int(a.nbytes) for a in arrays)

    # -- checkpoint -------------------------------------------------------------
    def save_checkpoint(self, directory, tag="latest", block=True):
        """The f32 masters and the momentum as global arrays through the
        async checkpoint service, every rank writing its own boxes through
        the commit barrier (collective).  The manifest's header keeps the
        plan's axis sizes as provenance: a load does not need them to
        match."""
        from .. import checkpoint as _ckpt
        mesh = self.plan.mesh
        tree = {}
        for i, lf in enumerate(self._leaves):
            for name, t, chunked in ((f"param/{i}", lf.master, False),
                                     (f"momentum/{i}", lf.momentum,
                                      lf.dp is not None)):
                part = lf.pieces(mesh, t, chunked)
                if part is not None:
                    tree[name] = part
        header = {"num_update": int(self.num_update),
                  "mesh_axes": self.plan.axis_sizes,
                  "n_leaves": len(self._leaves)}
        if self._amp:
            header["amp"] = {"scale": float(self._amp_state[0]),
                             "good": float(self._amp_state[1])}
        rank, world = mesh.save_rank()
        job = _ckpt.save(directory, tree, header, tag=tag, block=block,
                         rank=rank, world=world)
        return job.result() if block else job

    @torch.no_grad()
    def load_checkpoint(self, directory, tag="latest"):
        """Restore a :meth:`save_checkpoint` onto this plan's layout (any
        mesh shape: each rank reads its boxes of the global arrays).
        Returns the header dict, or None when there is no checkpoint."""
        from .. import checkpoint as _ckpt
        boxes = {}
        for i, lf in enumerate(self._leaves):
            box = (lf.start, tuple(a + n for a, n in
                                   zip(lf.start, lf.local_shape)))
            boxes[f"param/{i}"] = boxes[f"momentum/{i}"] = box
        loaded = _ckpt.load_boxes(directory, tag, boxes)
        if loaded is None:
            return None
        leaves, header, shapes = loaded
        n = int(header.get("n_leaves", len(self._leaves)))
        if n != len(self._leaves):
            raise MXNetError(
                f"checkpoint has {n} param leaves, trainer has "
                f"{len(self._leaves)}")
        for i, lf in enumerate(self._leaves):
            for name in (f"param/{i}", f"momentum/{i}"):
                if name not in shapes:
                    raise MXNetError(f"checkpoint {directory!r} has no "
                                     f"entry {name!r}")
                if shapes[name][0] != lf.shape:
                    raise MXNetError(
                        f"checkpoint {directory!r}: {name} has shape "
                        f"{shapes[name][0]}, the trainer expects "
                        f"{lf.shape}")
            lf.master.copy_(leaves[f"param/{i}"])
            m = leaves[f"momentum/{i}"].to(torch.float32)
            lf.momentum.copy_(comm.flat_chunk(m.contiguous(), lf.dp)
                              if lf.dp is not None else m)
        self.num_update = int(header.get("num_update", self.num_update))
        amp_hdr = header.get("amp")
        if amp_hdr and self._amp:
            self._amp_state[0].fill_(float(amp_hdr.get("scale", 1.0)))
            self._amp_state[1].fill_(float(amp_hdr.get("good", 0.0)))
        return dict(header)
