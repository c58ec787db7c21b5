"""gluon.contrib.nn: the contrib layers under the reference's path."""
from ..layers import (Concurrent, HybridConcurrent, Identity,  # noqa: F401
                      PixelShuffle1D, PixelShuffle2D, PixelShuffle3D,
                      SyncBatchNorm)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "PixelShuffle1D",
           "PixelShuffle2D", "PixelShuffle3D", "SyncBatchNorm"]
