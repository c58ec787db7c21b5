"""One mesh over every parallelism axis (counterpart of
``mxnet_tpu/parallel/mesh4d.py:1-247``): :class:`MeshPlan`, the plan
object ``SPMDTrainer(mesh=...)`` accepts, and :func:`mesh_plan_from_env`
(``MXNET_MESH``).

A plan builds one :class:`~.mesh.Mesh` carrying the axes pp, dp, ep, sp
and tp in that order (pp outermost, tp innermost), size-1 axes included,
so a spec naming tp stays valid on a dp4×tp1 mesh.  It derives the
composed specs (``batch_spec``, ``zero_spec``: the ZeRO dp shard on the
largest still-unsharded dp-divisible axis) and the analytic ring cost of
one collective (``ring_bytes``), which the telemetry producers use.

``Mesh4DTrainer`` (the pipeline's 1F1B schedule over pp × dp × tp × ep)
waits for the pipeline: it raises "not ported yet" (queue 1 item 11b).
"""
from __future__ import annotations

import os
import re
from typing import Dict, Optional, Sequence

from ..base import MXNetError
from .mesh import Mesh, NamedSharding, PartitionSpec, make_mesh, spec_axes

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


class Mesh4DTrainer:
    """The pp × dp × tp × ep trainer over the 1F1B pipeline: not ported
    yet."""

    def __init__(self, *args, **kwargs):
        raise MXNetError("Mesh4DTrainer is not ported yet: it waits for "
                         "the pipeline (queue 1 item 11b)")
