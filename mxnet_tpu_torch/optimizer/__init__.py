"""Optimizers (counterpart of ``mxnet_tpu/optimizer``): the family, the
``Updater`` and the fused whole-set step (``fused_step``)."""
from .optimizer import (Optimizer, Updater, create, register,  # noqa: F401
                        get_updater, SGD, NAG, Adam, AdamW, AdaGrad,
                        AdaDelta, Adamax, Nadam, RMSProp, FTML, FTRL, LAMB,
                        LARS, Signum, SGLD, DCASGD, LANS, GroupAdaGrad, Test)
from . import fused_step  # noqa: F401

__all__ = ["Optimizer", "Updater", "create", "register", "get_updater",
           "SGD", "NAG", "Adam", "AdamW", "AdaGrad", "AdaDelta", "Adamax",
           "Nadam", "RMSProp", "FTML", "FTRL", "LAMB", "LARS", "Signum",
           "SGLD", "DCASGD", "LANS", "GroupAdaGrad", "Test", "fused_step"]
