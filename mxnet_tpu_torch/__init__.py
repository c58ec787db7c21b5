"""PyTorch/CUDA port of the JAX package, slice by slice.

The JAX package beside this one is the reference; this package mirrors
its module paths (``mxnet_tpu_torch/serving/decode/engine.py`` is the port
of ``mxnet_tpu/serving/decode/engine.py``) and never imports it or JAX.
Every Pallas kernel on a ported path becomes a kernel written by hand
for Hopper (``csrc/`` for CUDA C++, ``@triton.jit`` where a module says
why), with a plain PyTorch version beside it that serves CPU tensors
and is the oracle the kernel is held against.

Ported so far: decode serving (``serving.decode``) with its two kernels,
``ops.paged_attention`` and ``ops.rope``; transformer-LM training
(``gluon``, ``initializer``, ``optimizer``, ``parallel.SPMDTrainer``)
with the three flash-attention kernels of ``ops.attention``.
"""
from .base import MXNetError  # noqa: F401

__all__ = ["MXNetError"]
