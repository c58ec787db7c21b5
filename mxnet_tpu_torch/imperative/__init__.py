"""Imperative execution helpers (counterpart of ``mxnet_tpu/imperative/``):
the whole-step capture of the eager Gluon loop (:mod:`.cached_step`)."""
from . import cached_step

__all__ = ["cached_step"]
