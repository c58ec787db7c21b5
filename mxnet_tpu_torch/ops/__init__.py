"""Operators of the port.  ``attention``, ``paged_attention``,
``rope`` and ``layernorm_residual`` carry hand-written kernels;
importing one registers its :class:`~mxnet_tpu_torch.kernels.KernelSpec`.
``nn``, ``tensor`` and ``optimizer_ops`` are plain PyTorch.
``registry`` holds the ops ``mx.nd`` is generated from (``tensor``'s
registered ops and ``layer_norm_residual``)."""
from . import registry  # noqa: F401
from . import attention, layernorm_residual, paged_attention, rope  # noqa: F401
from . import nn, optimizer_ops, tensor  # noqa: F401

__all__ = ["registry", "attention", "layernorm_residual", "paged_attention",
           "rope", "nn", "optimizer_ops", "tensor"]
