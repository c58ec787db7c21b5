"""Contributed bridges (counterpart of ``mxnet_tpu/contrib/``):
``tensorboard``."""
