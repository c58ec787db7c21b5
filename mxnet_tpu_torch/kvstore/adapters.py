"""Horovod / BytePS kvstore adapters (counterpart of
``mxnet_tpu/kvstore/adapters.py``): thin stores that hand broadcast and
pushpull to the external library when it is installed, and fail with an
actionable message when it is not.  ``MXNET_HOROVOD_BACKEND=torch``
makes ``horovod`` run horovod.mxnet's API surface over
``torch.distributed`` instead (``_hvd_torch.py``), with no horovod
install (the reference's value, ``jax``, selects it too, so a launch
script written for the reference runs unchanged)."""
from __future__ import annotations

import os

from ..base import MXNetError
from .base import KVStoreBase

__all__ = ["Horovod", "BytePS"]


def _import_or_raise(module: str, store: str, hint: str):
    import importlib
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise MXNetError(
            f"kvstore {store!r} requires the {module.split('.')[0]!r} "
            f"package, which is not installed ({e}). {hint}") from e


@KVStoreBase.register
class Horovod(KVStoreBase):
    """An all-reduce store over horovod: pushpull sums over the ranks
    (no averaging), broadcast ships rank 0's value; no server-side
    optimizer."""

    type = "horovod"

    def __init__(self):
        if os.environ.get("MXNET_HOROVOD_BACKEND") in ("torch", "jax"):
            from . import _hvd_torch as hvd
            self._hvd = hvd
        else:
            self._hvd = _import_or_raise(
                "horovod.mxnet", "horovod",
                "Use kv.create('dist_sync') instead — it rides "
                "torch.distributed (NCCL on the card); or set "
                "MXNET_HOROVOD_BACKEND=torch for the torch.distributed-"
                "backed transport with horovod semantics.")
        self._hvd.init()

    @staticmethod
    def is_capable(capability: str) -> bool:
        return False

    def broadcast(self, key, value, out, priority=0):
        if isinstance(value, list):
            value = value[0]    # replicas hold the same tensor
        outs = out if isinstance(out, list) else [out]
        res = self._hvd.broadcast(tensor=value, root_rank=0,
                                  name=str(key), priority=priority)
        for o in outs:
            o[:] = res

    def pushpull(self, key, value, out=None, priority=0):
        # a list value holds replicas of one tensor: all-reduce once,
        # write everywhere
        values = value if isinstance(value, list) else [value]
        res = self._hvd.allreduce(values[0], average=False, name=str(key),
                                  priority=priority)
        targets = values if out is None else \
            (out if isinstance(out, list) else [out])
        for t in targets:
            t[:] = res

    @property
    def rank(self) -> int:
        return self._hvd.rank()

    @property
    def num_workers(self) -> int:
        return self._hvd.size()

    @property
    def local_rank(self) -> int:
        return self._hvd.local_rank()


@KVStoreBase.register
class BytePS(KVStoreBase):
    """A push-pull store over byteps."""

    type = "byteps"

    def __init__(self):
        self._bps = _import_or_raise(
            "byteps.mxnet", "byteps",
            "Use kv.create('dist_async') or 'dist_sync' instead.")
        self._bps.init()
        self._declared = set()

    @staticmethod
    def is_capable(capability: str) -> bool:
        return False

    def _declare(self, key):
        if key not in self._declared:
            self._bps.byteps_declare_tensor(str(key))
            self._declared.add(key)

    def broadcast(self, key, value, out, priority=0):
        if isinstance(value, list):
            value = value[0]
        self._declare(key)
        outs = out if isinstance(out, list) else [out]
        self._bps.byteps_push_pull(value, version=0, priority=priority,
                                   name=str(key), is_average=False)
        for o in outs:
            o[:] = value

    def pushpull(self, key, value, out=None, priority=0):
        values = value if isinstance(value, list) else [value]
        value = values[0]
        self._declare(key)
        self._bps.byteps_push_pull(value, version=0, priority=priority,
                                   name=str(key), is_average=False)
        for t in (values if out is None else
                  (out if isinstance(out, list) else [out])):
            if t is not value:
                t[:] = value

    @property
    def rank(self) -> int:
        return self._bps.rank()

    @property
    def num_workers(self) -> int:
        return self._bps.size()

    @property
    def local_rank(self) -> int:
        return self._bps.local_rank()
