"""Symbol attribute scopes (counterpart of ``mxnet_tpu/attribute.py``).

``AttrScope``: a thread-local stack of attribute dicts applied to every
symbol created inside the scope (``with mx.AttrScope(ctx_group=
'stage1'):``).  Symbols keep the merged attributes in ``Symbol.attr`` /
``list_attr``.  Plain Python: the port's own copy.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current"]

_state = threading.local()


def _stack():
    if not hasattr(_state, "stack"):
        _state.stack = [AttrScope()]
    return _state.stack


def current() -> "AttrScope":
    return _stack()[-1]


class AttrScope:
    def __init__(self, **kwargs):
        for v in kwargs.values():
            if not isinstance(v, str):
                raise ValueError("AttrScope values must be strings")
        self._attr = dict(kwargs)

    def get(self, attr: Optional[Dict[str, str]]) -> Dict[str, str]:
        """Merge scope attrs with per-symbol attrs (symbol wins)."""
        out = dict(self._attr)
        if attr:
            out.update(attr)
        return out

    def __enter__(self):
        merged = AttrScope()
        merged._attr = current().get(self._attr)
        _stack().append(merged)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False
