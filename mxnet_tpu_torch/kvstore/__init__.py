"""``mx.kv`` — key-value stores (counterpart of ``mxnet_tpu/kvstore``).

Only the single-process store is ported: ``create("local" | "device")``
on one card (``KVStore``).  The distributed stores (``dist_*``,
``horovod``, ``byteps``, ``p3store_dist``) raise "not ported yet"
(distribution, queue 1 item 10)."""
from .base import KVStoreBase, create  # noqa: F401
from .kvstore import KVStore  # noqa: F401

__all__ = ["KVStoreBase", "KVStore", "create"]
