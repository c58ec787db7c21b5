"""The kvstore base and ``create`` (counterpart of
``mxnet_tpu/kvstore/base.py``)."""
from __future__ import annotations

from typing import Dict

from ..base import MXNetError

__all__ = ["KVStoreBase", "create", "payload_nbytes"]

_KV_REGISTRY: Dict[str, type] = {}

_LOCAL = ("local", "local_allreduce_cpu", "local_allreduce_device",
          "device", "nccl")


def payload_nbytes(v) -> int:
    """Bytes of one value (an NDArray or a tensor)."""
    t = getattr(v, "_data", v)
    return int(t.numel()) * t.element_size()


class KVStoreBase:
    """Abstract key-value store for parameter synchronization."""

    OPTIMIZER = "optimizer"
    type = "base"

    @staticmethod
    def register(klass):
        _KV_REGISTRY[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def is_capable(capability: str) -> bool:
        return False

    def has_capability(self, capability: str) -> bool:
        return type(self).is_capable(capability)

    def init(self, key, value):
        raise NotImplementedError

    def push(self, key, value, priority=0):
        raise NotImplementedError

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        raise NotImplementedError

    def pushpull(self, key, value, out=None, priority=0):
        raise NotImplementedError

    def broadcast(self, key, value, out, priority=0):
        raise NotImplementedError

    def set_optimizer(self, optimizer):
        raise NotImplementedError

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def barrier(self):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError


def create(name: str = "local", **kwargs) -> KVStoreBase:
    """``"local"``, ``"device"`` (and the reference's other single-process
    names) make a :class:`~mxnet_tpu_torch.kvstore.KVStore`; a store
    object is returned as it is."""
    if not isinstance(name, str):
        return name
    key = name.lower()
    if key in _LOCAL:
        return _KV_REGISTRY["kvstore"](key)
    if key.startswith(("dist", "p3")) or key in ("horovod", "byteps"):
        raise MXNetError(f"kvstore {name!r} is not ported yet "
                         f"(distribution, queue 1 item 11c)")
    raise MXNetError(f"unknown kvstore type {name!r}")
