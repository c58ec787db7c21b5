"""Fused recurrent layers ``RNN``, ``LSTM`` and ``GRU`` (counterpart of
``mxnet_tpu/gluon/rnn/rnn_layer.py``).

Each (layer, direction) holds the reference's parameters by its names
(``l0_i2h_weight``, ``l0_h2h_weight``, ``l0_i2h_bias``, ``l0_h2h_bias``,
``l0_h2r_weight`` under projection, ``r0_...`` for the backward
direction), so that checkpoints and ``convert.load_collected_params``
map one to one.  Their order is torch's per-layer weight list, so the
forward hands them as they are to :func:`ops.rnn.run_cells`: one torch
RNN call, cuDNN's on the card.  Inter-layer ``dropout`` applies in
training mode only, drawn from ``mx.random`` between layers.

As in the reference, ``forward`` accepts ``sequence_length`` and does
not use it (``mxnet_tpu/gluon/rnn/rnn_layer.py:160``): every row runs
all T steps.  The ``RNN`` op takes ragged lengths."""
from __future__ import annotations

import torch

from ... import autograd as ag
from ... import initializer as init_mod
from ...base import MXNetError
from ...ops import rnn as rnn_ops
from ..block import HybridBlock
from ..parameter import Parameter
from .rnn_cell import _params_device

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    def __init__(self, mode, hidden_size, num_layers=1, layout="TNC",
                 dropout=0.0, bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", use_sequence_length=False,
                 projection_size=None, h2r_weight_initializer=None,
                 **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC")
        if projection_size is not None and mode != "lstm":
            raise MXNetError("projection_size is LSTM-only")
        self._mode = mode
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._use_sequence_length = use_sequence_length
        self._projection_size = projection_size
        hp = projection_size if projection_size else hidden_size
        ng = _GATES[mode]
        for layer in range(num_layers):
            for prefix in ["l", "r"][:self._dir]:
                in_sz = input_size if layer == 0 else hp * self._dir
                setattr(self, f"{prefix}{layer}_i2h_weight", Parameter(
                    shape=(ng * hidden_size, in_sz if in_sz else 0),
                    dtype=dtype, init=i2h_weight_initializer,
                    allow_deferred_init=True))
                setattr(self, f"{prefix}{layer}_h2h_weight", Parameter(
                    shape=(ng * hidden_size, hp), dtype=dtype,
                    init=h2h_weight_initializer, allow_deferred_init=True))
                if projection_size is not None:
                    setattr(self, f"{prefix}{layer}_h2r_weight", Parameter(
                        shape=(projection_size, hidden_size), dtype=dtype,
                        init=h2r_weight_initializer,
                        allow_deferred_init=True))
                setattr(self, f"{prefix}{layer}_i2h_bias", Parameter(
                    shape=(ng * hidden_size,), dtype=dtype,
                    init=init_mod.create(i2h_bias_initializer),
                    allow_deferred_init=True))
                setattr(self, f"{prefix}{layer}_h2h_bias", Parameter(
                    shape=(ng * hidden_size,), dtype=dtype,
                    init=init_mod.create(h2h_bias_initializer),
                    allow_deferred_init=True))

    def _suffixes(self):
        """The parameters of one (layer, direction) in torch's order."""
        out = ["i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"]
        return out + (["h2r_weight"] if self._projection_size else [])

    def state_info(self, batch_size=0):
        num = self._num_layers * self._dir
        hp = self._projection_size or self._hidden_size
        if self._mode == "lstm":
            return [{"shape": (num, batch_size, hp)},
                    {"shape": (num, batch_size, self._hidden_size)}]
        return [{"shape": (num, batch_size, self._hidden_size)}]

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (``func`` is ignored, as in the
        reference), on ``ctx`` when given, else on the device of the
        layer's parameters, else on the current context."""
        from ... import ndarray as nd
        if "ctx" not in kwargs:
            dev = _params_device(self)
            if dev is not None:
                from ...context import Context
                kwargs["ctx"] = Context.of(dev)
        return [nd.zeros(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _finish_deferred(self, x):
        in_size = x.shape[-1]
        ng = _GATES[self._mode]
        hp = self._projection_size or self._hidden_size
        for layer in range(self._num_layers):
            for prefix in ["l", "r"][:self._dir]:
                w = getattr(self, f"{prefix}{layer}_i2h_weight")
                if w._deferred_init is not None:
                    sz = in_size if layer == 0 else hp * self._dir
                    w._finish_deferred_init((ng * self._hidden_size, sz))
                for suffix in self._suffixes()[1:]:
                    p = getattr(self, f"{prefix}{layer}_{suffix}")
                    if p._deferred_init is not None:
                        p._finish_deferred_init(None)

    def forward(self, x, states=None, sequence_length=None):
        self._finish_deferred(x)
        batch = x.shape[self._layout.find("N")]
        skip_states = states is None
        if skip_states:
            w = getattr(self, "l0_i2h_weight")._tensor()
            states = [torch.zeros(info["shape"], dtype=w.dtype,
                                  device=x.device)
                      for info in self.state_info(batch)]
        if isinstance(states, torch.Tensor):
            states = [states]
        ntc = self._layout == "NTC"
        if ntc:
            x = x.transpose(0, 1)
        params = [getattr(self, f"{prefix}{layer}_{suffix}")._tensor()
                  for layer in range(self._num_layers)
                  for prefix in ["l", "r"][:self._dir]
                  for suffix in self._suffixes()]
        cells = rnn_ops.flat_cells(params, self._mode, self._dir,
                                   self._projection_size is not None)
        lstm = self._mode == "lstm"
        p = self._dropout if ag.is_training() else 0.0
        out, h, c = rnn_ops.run_cells(self._mode, x, states[0],
                                      states[1] if lstm else None, cells,
                                      None, p)
        if ntc:
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, ([h, c] if lstm else [h])

    def __repr__(self):
        return f"{type(self).__name__}({self._hidden_size}, " \
               f"num_layers={self._num_layers}, " \
               f"bidirectional={self._dir == 2})"


class RNN(_RNNLayer):
    """Elman RNN layer, ``activation`` ``relu`` or ``tanh``."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 **kwargs):
        super().__init__(f"rnn_{activation}", hidden_size, num_layers,
                         **kwargs)


class LSTM(_RNNLayer):
    """LSTM layer (gates i, f, g, o), with ``projection_size`` an LSTMP."""

    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("lstm", hidden_size, num_layers, **kwargs)


class GRU(_RNNLayer):
    """GRU layer (gates r, z, n)."""

    def __init__(self, hidden_size, num_layers=1, **kwargs):
        super().__init__("gru", hidden_size, num_layers, **kwargs)
