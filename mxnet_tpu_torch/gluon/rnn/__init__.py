"""gluon.rnn (counterpart of ``mxnet_tpu/gluon/rnn``): the fused layers
``RNN``, ``LSTM`` and ``GRU`` over the ``RNN`` op's torch call (cuDNN on
the card), and the cells, unrolled step by step."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell,
                       HybridRecurrentCell, HybridSequentialRNNCell,
                       LSTMCell, ModifierCell, RecurrentCell, RNNCell,
                       ResidualCell, SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell",
           "LSTMCell", "GRUCell", "SequentialRNNCell",
           "HybridSequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ResidualCell", "ZoneoutCell",
           "ModifierCell", "RNN", "LSTM", "GRU"]
