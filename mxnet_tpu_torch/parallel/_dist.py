"""The process group behind the port's meshes.

The reference is one process driving every device under GSPMD.  The port
runs one process per device over ``torch.distributed``, PyTorch's own
idiom, so every mesh, collective and sharded trainer sits on the process
group this module starts.

:func:`init` starts it once per process:

* under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT`` set) it joins the job's group
  through ``env://``; each rank takes ``cuda:<LOCAL_RANK>``;
* under the repo's launcher, ``tools/launch.py`` (``MXNET_COORDINATOR_ADDR``
  ``host:port``, ``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID``), it joins
  through a ``TCPStore`` that rank 0 serves at that address; each rank
  takes ``cuda:<LOCAL_RANK>``, else ``cuda:<rank>`` where the host has
  that many cards;
* with none of those set it makes a group of one over this process's
  device (an in-process store, no network), so ``make_mesh({"dp": -1})``
  works in a plain ``python`` run as ``jax.devices()`` does for the
  reference;
* a caller that owns the rendezvous (the tests: a ``FileStore`` and
  spawned ranks) passes ``store``, ``rank`` and ``world_size``.

The backend follows the device: NCCL on ``cuda``, gloo only when the
caller asks for ``device="cpu"``.  A size-1 group on the card is NCCL on
the card, never gloo on the host.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["init", "is_initialized", "world_size", "device"]

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_device: Optional[torch.device] = None


def _backend_for(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init(device=None, *, store=None, rank: Optional[int] = None,
         world_size: Optional[int] = None) -> torch.device:
    """Start this process's group (once) and return the device its rank
    computes on.  ``device``: ``None``/``"cuda"`` (the default: the card,
    ``cuda:<LOCAL_RANK>``) or ``"cpu"``.  A second call returns the
    device the first one chose; asking then for another device type
    raises."""
    global _device
    if is_initialized():
        if _device is None:       # a group the caller started itself
            _device = (torch.device("cuda", torch.cuda.current_device())
                       if dist.get_backend() == "nccl"
                       else torch.device("cpu"))
        if device is not None:
            want = torch.device(device) if not isinstance(
                device, torch.device) else device
            if want.type != _device.type:
                raise MXNetError(
                    f"the process group runs on {_device.type}; a mesh "
                    f"on {want.type} needs a process of its own")
        return _device
    if not dist.is_available():
        raise MXNetError("torch.distributed is not available in this "
                         "PyTorch build")
    env = {k: os.environ.get(k) for k in _ENV}
    coord = os.environ.get("MXNET_COORDINATOR_ADDR")
    if store is None and env["WORLD_SIZE"] is not None:
        rank = int(env["RANK"] or 0)
        world_size = int(env["WORLD_SIZE"])
        local = int(env["LOCAL_RANK"] or rank)
    elif store is None and coord and os.environ.get("DMLC_NUM_WORKER"):
        store, rank, world_size = _launcher_store(coord)
        local = int(env["LOCAL_RANK"]) if env["LOCAL_RANK"] else (
            rank if rank < max(torch.cuda.device_count(), 1) else 0)
    else:
        local = int(env["LOCAL_RANK"] or 0) if store is None else 0
        if store is None:
            store, rank, world_size = dist.HashStore(), 0, 1
        elif rank is None or world_size is None:
            raise MXNetError("init(store=...) needs rank and world_size")
    if device is None or str(device) == "cuda":
        dev = resolve_device(f"cuda:{local}")
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    kw = dict(backend=_backend_for(dev), rank=int(rank),
              world_size=int(world_size))
    if dev.type == "cuda":
        kw["device_id"] = dev
    if store is None:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(store=store, **kw)
    _device = dev
    return dev


def _launcher_store(coord: str):
    """``(store, rank, world size)`` of a ``tools/launch.py`` worker: a
    ``TCPStore`` at ``MXNET_COORDINATOR_ADDR``, served by rank 0."""
    from datetime import timedelta
    world = int(os.environ["DMLC_NUM_WORKER"])
    rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
    host, port = coord.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=timedelta(seconds=300))
    return store, rank, world


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def device() -> Optional[torch.device]:
    return _device
