"""Operators of the port.  ``attention``, ``paged_attention`` and
``rope`` carry hand-written kernels; importing one registers its
:class:`~mxnet_tpu_torch.kernels.KernelSpec`.  ``nn``, ``tensor`` and
``optimizer_ops`` are plain PyTorch."""
from . import attention, paged_attention, rope  # noqa: F401
from . import nn, optimizer_ops, tensor  # noqa: F401

__all__ = ["attention", "paged_attention", "rope", "nn", "optimizer_ops",
           "tensor"]
