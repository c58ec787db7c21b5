"""Contrib layers (counterpart of ``mxnet_tpu/gluon/contrib/layers.py``):
``PixelShuffle1D/2D/3D``, and ``SyncBatchNorm``, ``Identity``,
``Concurrent`` (``nn.Concatenate``) and ``HybridConcurrent``
(``nn.HybridConcatenate``) under their contrib names."""
from __future__ import annotations

from ..block import HybridBlock
from ..nn.basic_layers import Concatenate as Concurrent
from ..nn.basic_layers import HybridConcatenate as HybridConcurrent
from ..nn.basic_layers import Identity, SyncBatchNorm

__all__ = ["SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D", "HybridConcurrent", "Concurrent", "Identity"]


class PixelShuffle1D(HybridBlock):
    """(N, C·f, W) → (N, C, W·f)."""

    def __init__(self, factor):
        super().__init__()
        self._factor = int(factor)

    def forward(self, x):
        f = self._factor
        n, c, w = x.shape
        out = x.reshape(n, c // f, f, w).permute(0, 1, 3, 2)
        return out.reshape(n, c // f, w * f)


class PixelShuffle2D(HybridBlock):
    """(N, C·f1·f2, H, W) → (N, C, H·f1, W·f2)."""

    def __init__(self, factor):
        super().__init__()
        if isinstance(factor, int):
            factor = (factor, factor)
        self._factor = tuple(factor)

    def forward(self, x):
        f1, f2 = self._factor
        n, c, h, w = x.shape
        out = x.reshape(n, c // (f1 * f2), f1, f2, h, w)
        out = out.permute(0, 1, 4, 2, 5, 3)
        return out.reshape(n, c // (f1 * f2), h * f1, w * f2)


class PixelShuffle3D(HybridBlock):
    """(N, C·f1·f2·f3, D, H, W) → (N, C, D·f1, H·f2, W·f3)."""

    def __init__(self, factor):
        super().__init__()
        if isinstance(factor, int):
            factor = (factor, factor, factor)
        self._factor = tuple(factor)

    def forward(self, x):
        f1, f2, f3 = self._factor
        n, c, d, h, w = x.shape
        out = x.reshape(n, c // (f1 * f2 * f3), f1, f2, f3, d, h, w)
        out = out.permute(0, 1, 5, 2, 6, 3, 7, 4)
        return out.reshape(n, c // (f1 * f2 * f3), d * f1, h * f2, w * f3)
