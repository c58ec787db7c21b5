"""``mx.kv`` — key-value stores (counterpart of ``mxnet_tpu/kvstore``).

- ``create("local" | "device")``: the single-process store
  (``KVStore``), row-sparse values included.
- ``create("dist_sync" | "dist_device_sync" | "dist_async")``: the
  distributed store over ``torch.distributed`` (``dist.DistKVStore``:
  batched all-reduce, ZeRO-1 ``update_on_kvstore``, the row-sparse
  collective, 2-bit compression, stale-synchronous async and the
  uncoordinated parameter server of ``ps_server.py``).
- ``create("p3store_dist")``: sliced, priority-scheduled pushpull
  (``p3store.P3StoreDist``).
- ``create("horovod" | "byteps")``: the adapters (``adapters.py``),
  which need their packages; ``MXNET_HOROVOD_BACKEND=torch`` runs
  horovod's API over ``torch.distributed``.
"""
from .base import KVStoreBase, create  # noqa: F401
from .kvstore import KVStore  # noqa: F401
from .gradient_compression import GradientCompression  # noqa: F401

__all__ = ["KVStoreBase", "KVStore", "create", "GradientCompression"]
