"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The axis names are the reference's: dp (data parallel), tp (tensor
parallel), pp (pipeline), sp (sequence / context parallel), ep (expert
parallel).

A :class:`Mesh` lays the process group's ranks (one device each,
``parallel/_dist.py``) on a grid with named axes, over a
``torch.distributed.device_mesh.DeviceMesh``.  Every rank builds the same
mesh (the construction is collective); a rank outside a mesh smaller
than the group holds it with ``is_member`` False.  :meth:`Mesh.axis`
gives what a collective over one axis needs: its size, this rank's
index on it, its process group and the global ranks along it.

:class:`PartitionSpec` and :class:`NamedSharding` are the port's own
counterparts of ``jax.sharding``'s: a spec names, per tensor dim, the
mesh axis it is split over (or None).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as onp
import torch
import torch.distributed as dist

from . import _dist

__all__ = ["make_mesh", "default_mesh", "data_parallel_spec", "replicated",
           "Mesh", "PartitionSpec", "NamedSharding", "spec_axes",
           "spec_box", "spec_gather"]


class PartitionSpec(tuple):
    """Per-dim mesh axis names (a name, a tuple of names, or None); dims
    past the spec's length are unsharded."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def spec_axes(spec) -> set:
    """The mesh axis names a spec uses."""
    used = set()
    for s in spec or ():
        if isinstance(s, (tuple, list)):
            used.update(s)
        elif s is not None:
            used.add(s)
    return used


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: "Mesh", spec: Optional[PartitionSpec] = None):
        self.mesh = mesh
        self.spec = spec if spec is not None else PartitionSpec()

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class _Axis:
    """One mesh axis as this rank sees it."""

    __slots__ = ("name", "size", "index", "group", "ranks")

    def __init__(self, name, size, index, group, ranks):
        self.name, self.size, self.index = name, size, index
        self.group, self.ranks = group, ranks

    def __repr__(self):
        return f"_Axis({self.name}, size={self.size}, index={self.index})"


class Mesh:
    """Ranks on a named grid (``jax.sharding.Mesh``)."""

    def __init__(self, ranks: onp.ndarray, axis_names: Sequence[str],
                 device: torch.device):
        from torch.distributed.device_mesh import DeviceMesh
        self.axis_names = tuple(axis_names)
        self.devices = ranks
        self.shape: Dict[str, int] = {
            n: int(s) for n, s in zip(self.axis_names, ranks.shape)}
        self.size = int(ranks.size)
        self.device = device
        self.device_mesh = DeviceMesh(
            device.type, torch.as_tensor(ranks, dtype=torch.int64),
            mesh_dim_names=self.axis_names)
        coord = self.device_mesh.get_coordinate()
        self.is_member = coord is not None
        self._coord = tuple(coord) if coord is not None else None
        # one group over every rank of the mesh (a mesh-wide agreement,
        # e.g. the loss scaler's all-finite); every rank of the process
        # group takes part in making it
        flat = [int(r) for r in ranks.reshape(-1)]
        self._all = (dist.new_group(flat) if self.size > 1
                     and self.size < _dist.world_size() else
                     (dist.group.WORLD if self.size > 1 else None))
        self._axes: Dict[str, _Axis] = {}

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"

    def coordinate(self, name: str) -> int:
        """This rank's index on axis ``name`` (0 off the mesh)."""
        if self._coord is None:
            return 0
        return self._coord[self.axis_names.index(name)]

    def axis(self, name: Optional[str]) -> Optional[_Axis]:
        """The axis ``name`` as this rank sees it; None for an axis the
        mesh lacks (a size of 1: nothing to communicate)."""
        if name is None or name not in self.shape:
            return None
        ax = self._axes.get(name)
        if ax is None:
            dim = self.axis_names.index(name)
            size = self.shape[name]
            index = self.coordinate(name)
            group, ranks = None, []
            if self.is_member:
                sel = list(self._coord)
                sel[dim] = slice(None)
                ranks = [int(r) for r in self.devices[tuple(sel)]]
                if size > 1:
                    group = self.device_mesh.get_group(name)
            ax = self._axes[name] = _Axis(name, size, index, group, ranks)
        return ax

    def writes(self, own=()) -> bool:
        """Whether this rank writes a value sharded over the axes in
        ``own`` (and replicated over the others) in a save: it is at
        coordinate 0 of every other axis."""
        return not any(self.coordinate(ax) for ax in self.axis_names
                       if ax not in own)

    def save_rank(self):
        """``(rank, world)`` of this rank in a save every rank of the mesh
        makes (the checkpoint service's commit barrier): its place in the
        mesh's grid order and the mesh's size."""
        flat = [int(r) for r in self.devices.reshape(-1)]
        return flat.index(dist.get_rank()) if self.size > 1 else 0, \
            self.size

    @property
    def all_group(self):
        """The process group over every rank of the mesh (None at size
        1)."""
        return self._all


def _spec_names(entry):
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_box(shape, spec, mesh, skip=()):
    """``(start, local shape)`` of this rank's part of a value of global
    ``shape`` under ``spec``: each named dim cut over its axes, outer
    first; the axes in ``skip`` and those of size 1 leave it whole."""
    start, local = [0] * len(shape), list(shape)
    for dim, entry in enumerate(spec or ()):
        for name in _spec_names(entry):
            ax = mesh.axis(name)
            if name in skip or ax is None or ax.size == 1:
                continue
            if local[dim] % ax.size:
                raise ValueError(f"dim {dim} ({shape[dim]}) is not "
                                 f"divisible by the {name!r} axis size "
                                 f"{ax.size}")
            local[dim] //= ax.size
            start[dim] += ax.index * local[dim]
    return tuple(start), tuple(local)


def spec_gather(t, spec, mesh, skip=()):
    """The whole value from this rank's part ``t`` of it under ``spec``
    (an all-gather over each axis of ``spec``, inner first; collective:
    every rank of those axes calls it)."""
    from . import collectives as comm
    spec = tuple(spec or ())
    for dim in range(len(spec) - 1, -1, -1):
        for name in reversed(_spec_names(spec[dim])):
            ax = mesh.axis(name)
            if name not in skip and comm.live(ax):
                t = comm._gather(t, ax, dim)
    return t


def make_mesh(axes: Dict[str, int] | None = None,
              devices: Optional[Sequence[int]] = None, *,
              device=None) -> Mesh:
    """Build a Mesh; ``axes`` maps axis name → size (-1 = fill what is
    left).  ``devices``: the global ranks to lay out (default: every rank
    of the process group, which :mod:`._dist` starts on first use);
    ``device``: the ranks' device type when the group is not started yet
    (default ``cuda``).  Collective: every rank calls it.

    ``make_mesh({"dp": -1})`` → 1-D data-parallel mesh over all ranks;
    ``make_mesh({"dp": 2, "tp": 4})`` → 2×4."""
    dev = _dist.init(device)
    devices = (list(devices) if devices is not None
               else list(range(_dist.world_size())))
    axes = dict(axes or {"dp": -1})
    sizes = list(axes.values())
    n = len(devices)
    if -1 in sizes:
        known = 1
        for s in sizes:
            if s != -1:
                known *= s
        sizes[sizes.index(-1)] = max(n // known, 1)
    total = 1
    for s in sizes:
        total *= s
    if total > n:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} needs {total} "
                         f"devices, have {n}")
    grid = onp.array(devices[:total], dtype=onp.int64).reshape(sizes)
    return Mesh(grid, tuple(axes.keys()), dev)


_default: Optional[Mesh] = None


def default_mesh() -> Mesh:
    global _default
    if _default is None:
        _default = make_mesh({"dp": -1})
    return _default


def data_parallel_spec(mesh: Mesh, batch_axis: int = 0,
                       ndim: int = 2) -> NamedSharding:
    """Sharding for a batch tensor: batch axis split over 'dp'."""
    spec = [None] * ndim
    spec[batch_axis] = "dp"
    return NamedSharding(mesh, PartitionSpec(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
