"""The parallel training path (counterpart of ``mxnet_tpu/parallel``): the
single-device ``SPMDTrainer``.  Meshes, ZeRO and pipelines are not
ported yet."""
from .trainer import SPMDTrainer  # noqa: F401

__all__ = ["SPMDTrainer"]
