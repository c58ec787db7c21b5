"""Contrib recurrent cells (counterpart of
``mxnet_tpu/gluon/contrib/rnn_cells.py``): the convolutional
``Conv{1,2,3}D{RNN,LSTM,GRU}Cell`` (i2h and h2h are convolutions over
the spatial dims, stride 1, h2h padded to keep the state's size),
``VariationalDropoutCell`` (one mask a sequence, from ``mx.random``)
and ``LSTMPCell`` (an LSTM whose recurrent state is projected H → P)."""
from __future__ import annotations

import torch

from ... import autograd as ag
from ...base import MXNetError
from ...ops import nn as nn_ops
from ...ops import random as _rng
from ..parameter import Parameter
from ..rnn.rnn_cell import RecurrentCell, _ModifierCell

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell", "LSTMPCell"]


def _tup(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def _act(x, name):
    return torch.tanh(x) if name == "tanh" else torch.relu(x)


class _BaseConvRNNCell(RecurrentCell):
    _num_gates = 1

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1, activation="tanh",
                 **kwargs):
        super().__init__(**kwargs)
        dims = len(input_shape) - 1   # input_shape = (C, *spatial)
        self._dims = dims
        self._input_shape = tuple(input_shape)
        self._hidden_channels = hidden_channels
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        for k in self._h2h_kernel:
            if k % 2 != 1:
                raise MXNetError("h2h_kernel dims must be odd "
                                 f"(got {self._h2h_kernel})")
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        self._activation = activation
        ng = self._num_gates
        self._state_shape = (hidden_channels,) + tuple(
            x + 2 * p - d * (k - 1) for x, p, d, k in
            zip(input_shape[1:], self._i2h_pad, self._i2h_dilate,
                self._i2h_kernel))
        self.i2h_weight = Parameter(
            shape=(ng * hidden_channels, input_shape[0]) + self._i2h_kernel)
        self.h2h_weight = Parameter(
            shape=(ng * hidden_channels, hidden_channels) + self._h2h_kernel)
        self.i2h_bias = Parameter(shape=(ng * hidden_channels,), init="zeros")
        self.h2h_bias = Parameter(shape=(ng * hidden_channels,), init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size,) + self._state_shape,
                 "__layout__": "NC" + "DHW"[-self._dims:]}]

    def _convs(self, x, h):
        i2h = nn_ops.convolution(x, self.i2h_weight._tensor(),
                                 self.i2h_bias._tensor(),
                                 kernel=self._i2h_kernel, pad=self._i2h_pad,
                                 dilate=self._i2h_dilate)
        h2h = nn_ops.convolution(h, self.h2h_weight._tensor(),
                                 self.h2h_bias._tensor(),
                                 kernel=self._h2h_kernel, pad=self._h2h_pad,
                                 dilate=self._h2h_dilate)
        return i2h, h2h


class _ConvRNNCell(_BaseConvRNNCell):
    _num_gates = 1

    def forward(self, x, states):
        i2h, h2h = self._convs(x, states[0])
        out = _act(i2h + h2h, self._activation)
        return out, [out]


class _ConvLSTMCell(_BaseConvRNNCell):
    _num_gates = 4

    def state_info(self, batch_size=0):
        info = super().state_info(batch_size)
        return info + [dict(info[0])]

    def forward(self, x, states):
        h, c = states
        i2h, h2h = self._convs(x, h)
        i, f, g, o = (i2h + h2h).chunk(4, 1)
        cn = torch.sigmoid(f) * c + torch.sigmoid(i) * _act(g,
                                                            self._activation)
        hn = torch.sigmoid(o) * _act(cn, self._activation)
        return hn, [hn, cn]


class _ConvGRUCell(_BaseConvRNNCell):
    _num_gates = 3

    def forward(self, x, states):
        h = states[0]
        i2h, h2h = self._convs(x, h)
        ir, iz, in_ = i2h.chunk(3, 1)
        hr, hz, hn_ = h2h.chunk(3, 1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = _act(in_ + r * hn_, self._activation)
        hn = (1 - z) * n + z * h
        return hn, [hn]


def _make(dims, base, name):
    class Cell(base):
        __doc__ = (f"{name}: input_shape (C, {'x'.join('S' * dims)}), state "
                   f"(N, hidden_channels, ...) of the i2h convolution's "
                   f"output size")

        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     activation="tanh", **kwargs):
            if len(input_shape) != dims + 1:
                raise MXNetError(
                    f"{name} expects input_shape (C, {'x'.join('S' * dims)})"
                    f", got {input_shape}")
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                             activation, **kwargs)

    Cell.__name__ = name
    Cell.__qualname__ = name
    return Cell


Conv1DRNNCell = _make(1, _ConvRNNCell, "Conv1DRNNCell")
Conv2DRNNCell = _make(2, _ConvRNNCell, "Conv2DRNNCell")
Conv3DRNNCell = _make(3, _ConvRNNCell, "Conv3DRNNCell")
Conv1DLSTMCell = _make(1, _ConvLSTMCell, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(2, _ConvLSTMCell, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(3, _ConvLSTMCell, "Conv3DLSTMCell")
Conv1DGRUCell = _make(1, _ConvGRUCell, "Conv1DGRUCell")
Conv2DGRUCell = _make(2, _ConvGRUCell, "Conv2DGRUCell")
Conv3DGRUCell = _make(3, _ConvGRUCell, "Conv3DGRUCell")


def _dropout_mask(like, rate):
    """Kept elements' scale ``1/(1-rate)``, dropped ones 0, from
    ``mx.random``."""
    keep = _rng.draw(lambda g: torch.rand(tuple(like.shape), generator=g,
                                          device=like.device) < 1.0 - rate,
                     like.device)
    return keep.to(like.dtype) / (1.0 - rate)


class VariationalDropoutCell(_ModifierCell):
    """The same dropout mask at every step of a sequence, on the inputs,
    the first state and the outputs, while training or recording; new
    masks after ``reset()``."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0, **kwargs):
        super().__init__(base_cell, **kwargs)
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self._mask_in = None
        self._mask_states = None
        self._mask_out = None

    def reset(self):
        super().reset()
        self._mask_in = None
        self._mask_states = None
        self._mask_out = None

    def forward(self, x, states):
        training = ag.is_training() or ag.is_recording()
        if training and self._drop_inputs:
            if self._mask_in is None:
                self._mask_in = _dropout_mask(x, self._drop_inputs)
            x = x * self._mask_in
        if training and self._drop_states:
            if self._mask_states is None:
                self._mask_states = _dropout_mask(states[0],
                                                  self._drop_states)
            states = [states[0] * self._mask_states] + list(states[1:])
        out, nstates = self.base_cell(x, states)
        if training and self._drop_outputs:
            if self._mask_out is None:
                self._mask_out = _dropout_mask(out, self._drop_outputs)
            out = out * self._mask_out
        return out, nstates


class LSTMPCell(RecurrentCell):
    """LSTM with a projected recurrent state (Sak et al. 2014): states
    ``(r (N, P), c (N, H))``, ``r = (o ⊙ tanh c) · h2r_weightᵀ``."""

    def __init__(self, hidden_size, projection_size, input_size=0, **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        nh, npr = hidden_size, projection_size
        self.i2h_weight = Parameter(shape=(4 * nh, input_size),
                                    allow_deferred_init=True)
        self.h2h_weight = Parameter(shape=(4 * nh, npr))
        self.h2r_weight = Parameter(shape=(npr, nh))
        self.i2h_bias = Parameter(shape=(4 * nh,), init="zeros")
        self.h2h_bias = Parameter(shape=(4 * nh,), init="zeros")

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _finish_deferred(self, x):
        if self.i2h_weight._deferred_init is not None:
            self.i2h_weight._finish_deferred_init(
                (4 * self._hidden_size, x.shape[-1]))

    def forward(self, x, states):
        self._finish_deferred(x)
        r, c = states
        gates = (x @ self.i2h_weight._tensor().t() + self.i2h_bias._tensor()
                 + r @ self.h2h_weight._tensor().t()
                 + self.h2h_bias._tensor())
        i, f, g, o = gates.chunk(4, -1)
        cn = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        hn = torch.sigmoid(o) * torch.tanh(cn)
        rn = hn @ self.h2r_weight._tensor().t()
        return rn, [rn, cn]
