"""Recurrent cells (counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``):
``RNNCell``, ``LSTMCell``, ``GRUCell``, ``SequentialRNNCell``,
``BidirectionalCell``, ``DropoutCell``, ``ResidualCell`` and
``ZoneoutCell``.  A cell's forward is one step, ``(x, states) ->
(out, new_states)``, on tensors (or NDArrays, as every Block);
``unroll`` steps it over a sequence.  Random masks (``DropoutCell``,
``ZoneoutCell``) come from ``mx.random``."""
from __future__ import annotations

import torch

from ... import autograd as ag
from ... import initializer as init_mod
from ...ndarray.ndarray import NDArray
from ...ops import nn as nn_ops
from ...ops import random as _rng
from ...ops.registry import invoke
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell",
           "LSTMCell", "GRUCell", "SequentialRNNCell",
           "HybridSequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ResidualCell", "ZoneoutCell",
           "ModifierCell"]


def _op(name, inputs, **params):
    """A registered op on NDArrays (through the funnel, as the
    reference's ``invoke``) or on tensors (the op's function)."""
    if any(isinstance(x, NDArray) for x in inputs):
        return invoke(name, inputs, **params)
    from ...ops import registry
    return registry.get(name).fn(*[x for x in inputs if x is not None],
                                 **params)


def _params_device(block):
    """The device of ``block``'s first initialised parameter, or None."""
    for p in block.collect_params().values():
        if p._data is not None:
            return p._data.device
    return None


def _bernoulli(p, like):
    """A bool mask of ``like``'s shape, True with probability ``p``, from
    ``mx.random``."""
    return _rng.draw(lambda g: torch.rand(tuple(like.shape), generator=g,
                                          device=like.device) < p,
                     like.device)


class RecurrentCell(HybridBlock):
    """Base cell: ``state_info``, ``begin_state``, ``reset`` and
    ``unroll``."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._modified = False

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Zero states as NDArrays (``func(shape=..., **kwargs)`` instead
        of ``nd.zeros`` when given), on ``ctx`` when given, else on the
        device of the cell's parameters, else on the current context."""
        from ... import ndarray as nd
        if func is None and "ctx" not in kwargs:
            dev = _params_device(self)
            if dev is not None:
                from ...context import Context
                kwargs["ctx"] = Context.of(dev)
        return [nd.zeros(info["shape"], **kwargs) if func is None
                else func(shape=info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def reset(self):
        pass

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell ``length`` times over ``inputs`` (NDArray or
        tensor, time along ``layout``'s T); returns (outputs, states):
        a list of steps, or one array stacked along T with
        ``merge_outputs`` (always when ``valid_length`` masks the steps
        past each row's length)."""
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch)
            if not isinstance(inputs, NDArray):
                begin_state = [s._data for s in begin_state]
        steps = [_op("squeeze", [_op("slice_axis", [inputs], axis=axis,
                                     begin=i, end=i + 1)], axis=axis)
                 for i in range(length)]
        outputs = []
        states = begin_state
        for i in range(length):
            out, states = self(steps[i], states)
            outputs.append(out)
        if valid_length is not None:
            stacked = _op("stack", outputs, axis=axis)
            outputs = _op("SequenceMask", [stacked, valid_length],
                          use_sequence_length=True, axis=axis)
            merge_outputs = True
        if merge_outputs and isinstance(outputs, list):
            outputs = _op("stack", outputs, axis=axis)
        return outputs, states


class _BaseRNNCell(RecurrentCell):
    def __init__(self, hidden_size, num_gates, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = num_gates
        self.i2h_weight = Parameter(shape=(ng * hidden_size, input_size),
                                    init=i2h_weight_initializer,
                                    allow_deferred_init=True)
        self.h2h_weight = Parameter(shape=(ng * hidden_size, hidden_size),
                                    init=h2h_weight_initializer,
                                    allow_deferred_init=True)
        self.i2h_bias = Parameter(shape=(ng * hidden_size,),
                                  init=init_mod.create(i2h_bias_initializer),
                                  allow_deferred_init=True)
        self.h2h_bias = Parameter(shape=(ng * hidden_size,),
                                  init=init_mod.create(h2h_bias_initializer),
                                  allow_deferred_init=True)
        self._num_gates = ng

    def _finish_deferred(self, x):
        if self.i2h_weight._deferred_init is not None:
            self.i2h_weight._finish_deferred_init(
                (self._num_gates * self._hidden_size, x.shape[-1]))
        for p in (self.h2h_weight, self.i2h_bias, self.h2h_bias):
            if p._deferred_init is not None:
                p._finish_deferred_init(None)

    def _gates(self, x, h):
        i2h = nn_ops.fully_connected(x, self.i2h_weight._tensor(),
                                     self.i2h_bias._tensor(), flatten=False)
        h2h = nn_ops.fully_connected(h, self.h2h_weight._tensor(),
                                     self.h2h_bias._tensor(), flatten=False)
        return i2h, h2h


class RNNCell(_BaseRNNCell):
    """Elman cell: ``act(W x + b + R h + b_R)``."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, 1, input_size, **kwargs)
        self._activation = activation

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, x, states):
        self._finish_deferred(x)
        i2h, h2h = self._gates(x, states[0])
        out = nn_ops.activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class LSTMCell(_BaseRNNCell):
    """LSTM cell, gates (i, f, g, o) as the fused op's."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 4, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, x, states):
        self._finish_deferred(x)
        h, c = states
        i2h, h2h = self._gates(x, h)
        i, f, g, o = (i2h + h2h).chunk(4, -1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, [new_h, new_c]


class GRUCell(_BaseRNNCell):
    """GRU cell, gates (r, z, n) as the fused op's."""

    def __init__(self, hidden_size, input_size=0, **kwargs):
        super().__init__(hidden_size, 3, input_size, **kwargs)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def forward(self, x, states):
        self._finish_deferred(x)
        h = states[0]
        i2h, h2h = self._gates(x, h)
        ir, iz, inn = i2h.chunk(3, -1)
        hr, hz, hn = h2h.chunk(3, -1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        new_h = (1 - z) * n + z * h
        return new_h, [new_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each one's output is the next one's input; the
    states are the cells' in order."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        infos = []
        for cell in self._children.values():
            infos.extend(cell.state_info(batch_size))
        return infos

    def forward(self, x, states):
        next_states = []
        p = 0
        for cell in self._children.values():
            n = len(cell.state_info())
            x, s = cell(x, states[p:p + n])
            next_states.extend(s)
            p += n
        return x, next_states

    def __len__(self):
        return len(self._children)


class DropoutCell(RecurrentCell):
    """Dropout on the step's input in training mode; no state."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def forward(self, x, states):
        if self._rate > 0 and ag.is_training():
            x = nn_ops.dropout(x, p=self._rate, axes=self._axes)
        return x, states


class _ModifierCell(RecurrentCell):
    def __init__(self, base_cell, **kwargs):
        super().__init__(**kwargs)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)


class ResidualCell(_ModifierCell):
    """The base cell's output plus its input."""

    def forward(self, x, states):
        out, states = self.base_cell(x, states)
        return out + x, states


class ZoneoutCell(_ModifierCell):
    """In training mode each output element keeps the previous step's
    value with probability ``zoneout_outputs``, each state element its
    old value with probability ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0,
                 **kwargs):
        super().__init__(base_cell, **kwargs)
        self._zo, self._zs = zoneout_outputs, zoneout_states
        self._prev_output = None

    def forward(self, x, states):
        out, new_states = self.base_cell(x, states)
        if ag.is_training():
            if self._zo > 0:
                prev = self._prev_output if self._prev_output is not None \
                    else out * 0
                out = torch.where(_bernoulli(self._zo, out), prev, out)
            if self._zs > 0:
                new_states = [torch.where(_bernoulli(self._zs, n), o, n)
                              for n, o in zip(new_states, states)]
        self._prev_output = out
        return out, new_states


class BidirectionalCell(RecurrentCell):
    """Two cells over the sequence, the second reversed (each row's valid
    prefix under ``valid_length``); outputs concatenated on the feature
    axis.  Only ``unroll`` runs it."""

    def __init__(self, l_cell, r_cell, **kwargs):
        super().__init__(**kwargs)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + \
            self.r_cell.state_info(batch_size)

    def __call__(self, inputs, states):
        raise NotImplementedError("BidirectionalCell cannot be stepped; "
                                  "use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        axis = layout.find("T")
        batch = inputs.shape[layout.find("N")]
        if begin_state is None:
            begin_state = self.begin_state(batch)
            if not isinstance(inputs, NDArray):
                begin_state = [s._data for s in begin_state]
        nl = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(
            length, inputs, begin_state[:nl], layout, merge_outputs=True,
            valid_length=valid_length)
        rev = _op("SequenceReverse", [inputs, valid_length],
                  use_sequence_length=valid_length is not None, axis=axis)
        r_out, r_states = self.r_cell.unroll(
            length, rev, begin_state[nl:], layout, merge_outputs=True,
            valid_length=valid_length)
        r_out = _op("SequenceReverse", [r_out, valid_length],
                    use_sequence_length=valid_length is not None, axis=axis)
        out = _op("concat", [l_out, r_out], dim=2)
        return out, l_states + r_states


# every cell here can be captured like any HybridBlock, so the
# reference's Hybrid* split collapses to aliases, as in the reference
HybridRecurrentCell = RecurrentCell
HybridSequentialRNNCell = SequentialRNNCell
ModifierCell = _ModifierCell
