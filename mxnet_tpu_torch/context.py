"""Device resolution and the ``Context`` model (counterpart of
``mxnet_tpu/context.py``).

Entry points of the port run on the card: ``device=None`` means
``cuda``.  The host is used only when the caller asks for it with
``device="cpu"`` (as the CPU tests do); without a visible GPU an
entry point that was not asked for the CPU raises instead of quietly
running there.

``Context`` is MXNet's (device_type, device_id) pair over a
``torch.device``, with a thread-local ``with ctx:`` stack.  The default
context is ``gpu(0)``; unlike the reference, which falls back to the CPU
when it finds no accelerator (``mxnet_tpu/context.py:130-136``), a
``gpu`` context without a visible card raises when it is used.
"""
from __future__ import annotations

import threading
from typing import List

import torch

from .base import MXNetError

__all__ = ["resolve_device", "Context", "cpu", "gpu", "current_context",
           "num_gpus"]


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"``/``"cpu"``/``torch.device``/a
    ``Context`` → a concrete ``torch.device`` (a bare ``cuda`` gets the
    current device's index)."""
    if isinstance(device, Context):
        return device.torch_device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise MXNetError(f"unsupported device {device!r}: use 'cuda' or "
                         f"'cpu'")
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is visible; pass device='cpu' to run on the "
            "host explicitly")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.index >= torch.cuda.device_count():
        raise MXNetError(f"{dev} out of range: "
                         f"{torch.cuda.device_count()} CUDA device(s)")
    return dev


_local = threading.local()


class Context:
    """A device context: ``Context("gpu", 0)`` or ``Context("cpu")``
    (``"cuda"`` is accepted for ``"gpu"``).  Parity: ``Context`` in the
    reference, whose accelerator type is ``tpu``."""

    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        device_type = "gpu" if device_type == "cuda" else device_type
        if device_type not in ("cpu", "gpu"):
            raise MXNetError(f"unknown device type {device_type!r}: use "
                             f"'gpu' or 'cpu'")
        self.device_type = device_type
        self.device_id = int(device_id)

    @classmethod
    def of(cls, device: torch.device) -> "Context":
        """The context of a tensor's device."""
        if device.type == "cpu":
            return cls("cpu")
        return cls("gpu", device.index or 0)

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` behind this context; a ``gpu`` context
        raises when no card is visible."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"no CUDA device is visible for {self}; pass ctx=mx.cpu() "
                f"or use `with mx.cpu():` to run on the host")
        return resolve_device(f"cuda:{self.device_id}")

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        return False


def _stack() -> List[Context]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def current_context() -> Context:
    """Innermost ``with ctx:`` context, else ``gpu(0)``."""
    stack = _stack()
    return stack[-1] if stack else Context("gpu", 0)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def num_gpus() -> int:
    return torch.cuda.device_count()
