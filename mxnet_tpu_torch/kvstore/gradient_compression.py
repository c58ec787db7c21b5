"""2-bit gradient compression with error feedback (counterpart of
``mxnet_tpu/kvstore/gradient_compression.py``).

Each value becomes one of ``{-threshold, 0, +threshold}``; what the
rounding lost is kept as the key's residual and added to the next
gradient.  On the wire the codes travel packed, four to a byte
(``{0: zero, 1: +t, 2: -t}``, the first value in the low bits): a 16th
of the float32 bytes.  Plain torch ops on the gradient's device.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..ndarray.ndarray import NDArray

__all__ = ["GradientCompression"]


def _quantize_2bit(grad, residual, threshold):
    acc = grad + residual
    zero = torch.zeros((), dtype=acc.dtype, device=acc.device)
    q = torch.where(acc >= threshold, threshold,
                    torch.where(acc <= -threshold, -threshold, zero))
    return q, acc - q


def _pack_2bit(qflat: torch.Tensor) -> torch.Tensor:
    """``{-t, 0, +t}`` values → 2-bit codes, 4 a byte."""
    codes = torch.where(qflat > 0, 1, torch.where(qflat < 0, 2, 0)
                        ).to(torch.uint8)
    pad = (-codes.numel()) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    codes = codes.reshape(-1, 4)
    return (codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4)
            | (codes[:, 3] << 6))


def _unpack_2bit(packed: torch.Tensor, n: int) -> torch.Tensor:
    b = packed.reshape(-1, 1)
    codes = torch.cat([(b >> 0) & 3, (b >> 2) & 3, (b >> 4) & 3,
                       (b >> 6) & 3], dim=1).reshape(-1)
    return codes[:n]


class GradientCompression:
    """``type="2bit"`` with ``threshold``; one residual a key."""

    def __init__(self, type: str = "2bit", threshold: float = 0.5):
        if type != "2bit":
            raise ValueError(f"unsupported compression type {type!r}")
        self.type = type
        self.threshold = float(threshold)
        self._residuals: Dict[object, torch.Tensor] = {}

    def get_params(self):
        return {"type": self.type, "threshold": self.threshold}

    def _quantize(self, key, grad: NDArray):
        g = grad._data
        res = self._residuals.get(key)
        if res is None:
            res = torch.zeros_like(g)
        t = torch.tensor(self.threshold, dtype=g.dtype, device=g.device)
        q, self._residuals[key] = _quantize_2bit(g, res, t)
        return q

    def compress(self, key, grad: NDArray) -> NDArray:
        """The quantized gradient (``{-t, 0, +t}``), the residual kept."""
        return NDArray._wrap(self._quantize(key, grad))

    def compress_packed(self, key, grad: NDArray):
        """Quantize and pack: ``(packed uint8, meta)`` with ``meta = (n,
        shape, dtype name)``; the residual as in :meth:`compress`."""
        q = self._quantize(key, grad)
        return _pack_2bit(q.reshape(-1)), \
            (int(q.numel()), tuple(q.shape), str(q.dtype).replace(
                "torch.", ""))

    def dequantize(self, packed: torch.Tensor, meta) -> torch.Tensor:
        n, shape, dtype = meta
        dt = getattr(torch, dtype)
        codes = _unpack_2bit(packed, n)
        t = torch.tensor(self.threshold, dtype=dt, device=packed.device)
        zero = torch.zeros((), dtype=dt, device=packed.device)
        return torch.where(codes == 1, t,
                           torch.where(codes == 2, -t, zero)).reshape(shape)
