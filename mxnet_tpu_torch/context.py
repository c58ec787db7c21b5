"""Device resolution (counterpart of ``mxnet_tpu/context.py``).

Entry points of the port run on the card: ``device=None`` means
``cuda``.  The host is used only when the caller asks for it with
``device="cpu"`` (as the CPU tests do); without a visible GPU an
entry point that was not asked for the CPU raises instead of quietly
running there.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"``/``"cpu"``/``torch.device`` →
    a concrete ``torch.device`` (a bare ``cuda`` gets the current
    device's index)."""
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
