"""gluon.contrib (counterpart of ``mxnet_tpu/gluon/contrib``): the
contrib RNN cells (``rnn_cells``, reached as ``gluon.contrib.rnn``) and
layers (``layers``, re-exported by ``gluon.contrib.nn``).  The
reference's ``cnn`` (deformable convolutions), ``estimator`` and
``data`` are not ported yet: reaching them raises."""
from ...base import MXNetError
from . import nn  # noqa: F401
from . import rnn_cells  # noqa: F401
from . import rnn_cells as rnn  # noqa: F401  (the reference's path)
from .layers import (Concurrent, HybridConcurrent, Identity,  # noqa: F401
                     PixelShuffle1D, PixelShuffle2D, PixelShuffle3D,
                     SyncBatchNorm)
from .rnn_cells import (Conv1DGRUCell, Conv1DLSTMCell,  # noqa: F401
                        Conv1DRNNCell, Conv2DGRUCell, Conv2DLSTMCell,
                        Conv2DRNNCell, Conv3DGRUCell, Conv3DLSTMCell,
                        Conv3DRNNCell, LSTMPCell, VariationalDropoutCell)

__all__ = ["nn", "rnn", "rnn_cells", "SyncBatchNorm", "PixelShuffle1D",
           "PixelShuffle2D", "PixelShuffle3D", "HybridConcurrent",
           "Concurrent", "Identity", "Conv1DRNNCell", "Conv2DRNNCell",
           "Conv3DRNNCell", "Conv1DLSTMCell", "Conv2DLSTMCell",
           "Conv3DLSTMCell", "Conv1DGRUCell", "Conv2DGRUCell",
           "Conv3DGRUCell", "VariationalDropoutCell", "LSTMPCell"]

_NOT_PORTED = {
    "cnn": "gluon.contrib.cnn (deformable convolutions) needs the "
           "DeformableConvolution ops, which are not ported yet",
    "DeformableConvolution": "gluon.contrib.DeformableConvolution is not "
                             "ported yet",
    "ModulatedDeformableConvolution": "gluon.contrib."
                                      "ModulatedDeformableConvolution is "
                                      "not ported yet",
    "estimator": "gluon.contrib.estimator is not ported yet",
    "data": "gluon.contrib.data is not ported yet",
}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise MXNetError(_NOT_PORTED[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
