"""Basic Gluon layers on the training path (counterpart of part of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``HybridSequential``,
``Dense``, ``Dropout``, ``Embedding``, ``LayerNorm`` and ``GELU``."""
from __future__ import annotations

import torch.nn.functional as F

from ... import autograd as ag
from ... import initializer as init_mod
from ...base import MXNetError
from ...ops import nn as nn_ops
from ...ops import tensor as tensor_ops
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["HybridSequential", "Dense", "Dropout", "Embedding",
           "LayerNorm", "GELU"]

class HybridSequential(HybridBlock):
    """Children run in order; ``add`` names them ``0``, ``1``, ..."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x, *args):
        for block in self._children.values():
            x = block(x)
        return x

    def __getitem__(self, key):
        children = list(self._children.values())
        if isinstance(key, slice):
            return type(self)().add(*children[key])
        return children[key]

    def __len__(self):
        return len(self._children)

    def __iter__(self):
        return iter(self._children.values())


class Dense(HybridBlock):
    """Fully-connected layer: weight ``(units, in_units)``, ``in_units``
    deferred to the first forward when 0; ``activation`` (an
    ``Activation`` act_type) is applied after the bias, as in the
    reference."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._activation = activation
        self.weight = Parameter(shape=(units, in_units), dtype=dtype,
                                init=weight_initializer,
                                allow_deferred_init=True)
        self.bias = Parameter(shape=(units,), dtype=dtype,
                              init=init_mod.create(bias_initializer)
                              if bias_initializer else None,
                              allow_deferred_init=True) if use_bias else None

    def _finish_deferred(self, x):
        if self.weight._deferred_init is not None:
            in_units = (x[0].numel() if self._flatten else x.shape[-1])
            self.weight._finish_deferred_init((self._units, in_units))
        if self.bias is not None and self.bias._deferred_init is not None:
            self.bias._finish_deferred_init((self._units,))

    def forward(self, x):
        self._finish_deferred(x)
        out = nn_ops.fully_connected(
            x, self.weight.data(),
            self.bias.data() if self.bias is not None else None,
            flatten=self._flatten)
        if self._activation:
            out = nn_ops.activation(out, act_type=self._activation)
        return out

    def __repr__(self):
        return f"Dense({self._units}, {self._activation or 'linear'})"


class Dropout(HybridBlock):
    """Zeroes elements at ``rate`` in training mode
    (``autograd.is_training()``), through PyTorch's generator."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        if tuple(axes):
            raise MXNetError("Dropout over shared axes is not ported yet")
        self._rate = rate

    def forward(self, x):
        if not ag.is_training() or self._rate <= 0:
            return x
        return F.dropout(x, self._rate, training=True)


class Embedding(HybridBlock):
    """Rows of a ``(input_dim, output_dim)`` table at integer ids."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True) is not ported "
                             "yet")
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = Parameter(shape=(input_dim, output_dim), dtype=dtype,
                                init=weight_initializer)

    def forward(self, x):
        return tensor_ops.embedding(x, self.weight.data())

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class LayerNorm(HybridBlock):
    """Normalisation over ``axis`` with learned gamma and beta."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = Parameter(shape=(in_channels,),
                               init=init_mod.create(gamma_initializer),
                               allow_deferred_init=True,
                               grad_req="write" if scale else "null")
        self.beta = Parameter(shape=(in_channels,),
                              init=init_mod.create(beta_initializer),
                              allow_deferred_init=True,
                              grad_req="write" if center else "null")

    def forward(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta):
            if p._deferred_init is not None:
                p._finish_deferred_init((c,))
        return nn_ops.layer_norm(x, self.gamma.data(), self.beta.data(),
                                 axis=self._axis, eps=self._epsilon)


class GELU(HybridBlock):
    """GELU; ``approximation="erf"`` (the default) is exact, anything
    else the tanh form."""

    def __init__(self, approximation="erf", **kwargs):
        super().__init__(**kwargs)
        self._approx = approximation

    def forward(self, x):
        return nn_ops.leaky_relu(
            x, act_type="gelu" if self._approx == "erf" else "gelu_tanh")
