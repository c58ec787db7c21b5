"""TensorBoard logging bridge (counterpart of
``mxnet_tpu/contrib/tensorboard.py``).

``_summary_writer(logdir)`` opens a SummaryWriter from mxboard when it
is installed, else from ``torch.utils.tensorboard`` (which needs the
``tensorboard`` package), and raises ``MXNetError`` when neither
imports.  ``telemetry.TensorBoardSink`` also takes any object with
``add_scalar``/``flush``/``close``.
"""
from __future__ import annotations

from ..base import MXNetError


def _summary_writer(logging_dir):
    try:
        from mxboard import SummaryWriter
        return SummaryWriter(logging_dir)
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(logging_dir)
    except ImportError as e:
        raise MXNetError(
            "a TensorBoard writer needs a SummaryWriter backend: install "
            "mxboard or tensorboard, or pass a writer object "
            f"({e})") from e
