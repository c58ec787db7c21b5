"""Operators of the port that carry a hand-written kernel.  Importing a
module registers its :class:`~mxnet_tpu_torch.kernels.KernelSpec`."""
from . import paged_attention, rope  # noqa: F401

__all__ = ["paged_attention", "rope"]
