"""The kvstore base, the server-command table and ``create`` (counterpart
of ``mxnet_tpu/kvstore/base.py``)."""
from __future__ import annotations

from typing import Any, Dict

from ..base import MXNetError

__all__ = ["KVStoreBase", "create", "payload_nbytes",
           "register_server_command"]

_KV_REGISTRY: Dict[str, type] = {}

_LOCAL = ("local", "local_allreduce_cpu", "local_allreduce_device",
          "device", "nccl")


def payload_nbytes(v) -> int:
    """Wire bytes of one value: a dense array's (an NDArray, a tensor or
    a numpy array) ``size × itemsize``; a row-sparse value's data plus
    indices — the measure of the ``comm.*.bytes`` and ``embedding.*``
    counters."""
    if getattr(v, "stype", None) == "row_sparse":
        return payload_nbytes(v.data) + payload_nbytes(v.indices)
    t = getattr(v, "_data", v)
    if hasattr(t, "element_size"):
        return int(t.numel()) * t.element_size()
    try:
        return int(t.nbytes)
    except AttributeError:
        return 0


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

    def set_gradient_compression(self, compression_params):
        raise NotImplementedError

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def barrier(self):
        pass

    def send_command_to_servers(self, head, body=""):
        """Run a ``(head, body)`` server command (the profiler's, by
        default) in this process: every process is its own server, so
        call it on every rank to reach every one.  Not a collective."""
        _run_server_command(head, body)

    def get_num_dead_node(self, node_id=0, timeout=60) -> int:
        """Dead workers.  A collective store has no heartbeat: a dead
        rank surfaces as a collective's error, so a reachable store
        reports 0."""
        return 0

    def save_optimizer_states(self, fname, dump_optimizer=False):
        raise NotImplementedError

    def load_optimizer_states(self, fname):
        raise NotImplementedError


# server commands: head -> handler(body)
_COMMANDS: Dict[str, Any] = {}


def register_server_command(head: str):
    def deco(fn):
        _COMMANDS[head] = fn
        return fn
    return deco


def _run_server_command(head, body):
    handler = _COMMANDS.get(str(head))
    if handler is None:
        raise MXNetError(f"unknown server command {head!r}; "
                         f"known: {sorted(_COMMANDS)}")
    handler(body)


@register_server_command("profiler_set_config")
def _cmd_profiler_config(body):
    import json
    from .. import profiler
    profiler.set_config(**(json.loads(body) if body else {}))


@register_server_command("profiler_start")
def _cmd_profiler_start(body):
    from .. import profiler
    profiler.start()


@register_server_command("profiler_stop")
def _cmd_profiler_stop(body):
    from .. import profiler
    profiler.stop()


@register_server_command("profiler_dump")
def _cmd_profiler_dump(body):
    from .. import profiler
    profiler.dump()


def create(name: str = "local", **kwargs) -> KVStoreBase:
    """``"local"``, ``"device"`` (and the reference's other
    single-process names) make a :class:`~mxnet_tpu_torch.kvstore.
    KVStore`; ``"dist_sync"``, ``"dist_device_sync"`` and
    ``"dist_async"`` a :class:`~mxnet_tpu_torch.kvstore.dist.
    DistKVStore`; ``"p3store_dist"`` a :class:`~mxnet_tpu_torch.kvstore.
    p3store.P3StoreDist`; ``"horovod"`` / ``"byteps"`` the adapters.  A
    store object is returned as it is."""
    if not isinstance(name, str):
        return name
    key = name.lower()
    if key in _LOCAL:
        return _KV_REGISTRY["kvstore"](key)
    if key.startswith("p3"):
        from . import p3store  # noqa: F401  (registers P3StoreDist)
        return _KV_REGISTRY["p3storedist"]()
    if key.startswith("dist"):
        from . import dist  # noqa: F401  (registers DistKVStore)
        return _KV_REGISTRY["distkvstore"](key)
    if key in ("horovod", "byteps"):
        from . import adapters  # noqa: F401  (registers the adapters)
    if key in _KV_REGISTRY:
        return _KV_REGISTRY[key](**kwargs)
    raise MXNetError(f"unknown kvstore type {name!r}")
