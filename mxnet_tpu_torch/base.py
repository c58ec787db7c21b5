"""Base types shared by every layer of the port: the package-wide error
type and environment-variable config access (counterpart of
``mxnet_tpu/base.py``)."""
from __future__ import annotations

import os

__all__ = ["MXNetError", "getenv_int"]


class MXNetError(RuntimeError):
    """Error raised by the framework runtime (parity: dmlc::Error)."""


def getenv_int(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default
