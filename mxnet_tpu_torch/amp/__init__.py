"""Automatic mixed precision (counterpart of ``mxnet_tpu/amp``): the
execution policy (``policy``: which op computes in which type, read at
each op call), the dynamic loss scaler and the entry points ``init``,
``init_trainer``, ``scale_loss``, ``unscale``, ``convert_model`` and
``convert_hybrid_block``."""
from .amp import (init, init_trainer, reset, scale_loss, unscale,  # noqa
                  convert_model, convert_hybrid_block)
from .loss_scaler import LossScaler, all_finite  # noqa: F401
from . import lists, policy  # noqa: F401

__all__ = ["init", "init_trainer", "reset", "scale_loss", "unscale",
           "convert_model", "convert_hybrid_block", "LossScaler",
           "all_finite", "lists", "policy"]
