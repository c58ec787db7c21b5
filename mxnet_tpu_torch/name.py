"""Symbol auto-naming scopes (counterpart of ``mxnet_tpu/name.py``).

``NameManager`` (a thread-local stack supplying auto-generated names for
anonymous symbols) and ``Prefix`` (prepends a prefix to every auto
name), read by ``symbol.symbol._auto_name``: ``with
mx.name.Prefix('net1_'):`` affects symbol construction as in the
reference.  Plain Python: the port's own copy.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["NameManager", "Prefix", "current"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = [NameManager()]
    return _state.stack


def current() -> "NameManager":
    return _stack()[-1]


class NameManager:
    """Auto-name generator: ``opname`` → ``opname{N}`` (parity:
    name.py NameManager.get)."""

    def __init__(self):
        self._counter: Dict[str, int] = {}

    def get(self, name: Optional[str], hint: str) -> str:
        if name is not None:
            return name
        i = self._counter.get(hint, 0)
        self._counter[hint] = i + 1
        return f"{hint}{i}"

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


class Prefix(NameManager):
    """NameManager that prepends ``prefix`` to every auto name
    (parity: name.py Prefix)."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)
