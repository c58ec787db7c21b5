"""horovod.mxnet's API surface over ``torch.distributed`` (counterpart
of ``mxnet_tpu/kvstore/_hvd_jax.py``): ``init`` / ``rank`` / ``size`` /
``local_rank`` / ``broadcast`` / ``allreduce``, the calls the Horovod
adapter makes, on the process group the distributed stores use (real
sockets between processes over gloo; NCCL on the card).  Selected by
``MXNET_HOROVOD_BACKEND=torch``."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..ndarray.ndarray import NDArray

_COLL = None


def init():
    from .dist import _GlobalCollectives, init_distributed
    global _COLL
    init_distributed()
    if _COLL is None:
        _COLL = _GlobalCollectives()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def _tensor_of(tensor) -> torch.Tensor:
    if isinstance(tensor, NDArray):
        return tensor._data.detach()
    return torch.as_tensor(tensor)


def allreduce(tensor, average=False, name=None, priority=0):
    """The sum (or mean) over ranks: one collective."""
    out = _COLL.allreduce(_tensor_of(tensor))
    if average:
        out = out / size()
    return NDArray._wrap(out)


def broadcast(tensor, root_rank=0, name=None, priority=0):
    """``root_rank``'s value on every rank."""
    return NDArray._wrap(_COLL.broadcast(_tensor_of(tensor), root_rank))
