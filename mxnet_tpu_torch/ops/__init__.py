"""Operators of the port.  ``attention``, ``paged_attention``,
``rope`` and ``layernorm_residual`` carry hand-written kernels;
importing one registers its :class:`~mxnet_tpu_torch.kernels.KernelSpec`.
``nn``, ``tensor``, ``random``, ``optimizer_ops``, ``rnn`` (torch's
RNN call: cuDNN on the card) and ``legacy`` (MXNet 1.x's op names) are
plain PyTorch.
``registry`` holds the ops ``mx.nd`` is generated from (``tensor``'s
registered ops and ``layer_norm_residual``).  ``np_impl`` holds numpy's
functions on tensors, behind ``mx.np`` and the ``_npi_*`` ops of
``npi``; ``linalg`` the batched ``_linalg_*`` ops over ``torch.linalg``."""
from . import registry  # noqa: F401
from . import attention, layernorm_residual, paged_attention, rope  # noqa: F401
from . import nn, optimizer_ops, random, rnn, tensor  # noqa: F401
from . import legacy  # noqa: F401
from . import linalg, npi  # noqa: F401

__all__ = ["registry", "attention", "layernorm_residual", "paged_attention",
           "rope", "nn", "optimizer_ops", "random", "rnn", "tensor", "legacy",
           "linalg", "npi", "np_impl"]
