"""Basic Gluon layers on the training paths (counterpart of part of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Sequential``,
``HybridSequential``,
``Dense``, ``Dropout``, ``Embedding``, ``BatchNorm``, ``BatchNormReLU``,
``LayerNorm``, ``Flatten``, ``Identity``, ``Activation`` and ``GELU``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ... import autograd as ag
from ... import initializer as init_mod
from ...base import MXNetError
from ...imperative import cached_step as _cs
from ...ops import nn as nn_ops
from ...ops import tensor as tensor_ops
from ..block import Block, HybridBlock, current_trace
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "BatchNormReLU", "LayerNorm", "Flatten", "Identity",
           "Activation", "GELU"]

class _SequentialMixin:
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


class Sequential(_SequentialMixin, Block):
    """The eager container (``mxnet_tpu/gluon/nn/basic_layers.py:29``)."""


class HybridSequential(_SequentialMixin, HybridBlock):
    """The hybridizable container; here it runs eagerly too."""


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
            x, self.weight._tensor(),
            self.bias._tensor() if self.bias is not None else None,
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
        return tensor_ops.embedding(x, self.weight._tensor())

    def __repr__(self):
        return f"Embedding({self._input_dim} -> {self._output_dim})"


class BatchNorm(HybridBlock):
    """Batch normalisation over every axis but ``axis``
    (``mxnet_tpu/gluon/nn/basic_layers.py:157-222``).  ``gamma`` and
    ``running_var`` start at ones, ``beta`` and ``running_mean`` at zeros,
    whatever the net's initializer; the running statistics are auxiliary
    states (``grad_req="null"``).

    In training mode (``autograd.is_training()``, as inside
    ``autograd.record()`` or a trainer's step) the batch's statistics
    normalise, and each running statistic becomes ``old·momentum +
    batch·(1 - momentum)`` with the batch's population variance,
    computed in the type the forward sees the statistics in (the compute
    type inside a bf16 trainer step).  Inside a trace context the new
    values go to its aux channel, for the trainer to write back once a
    step; outside one they are written in place, under no-grad.  In eval
    mode the running statistics normalise and nothing is written."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = Parameter(shape=(in_channels,),
                               init=init_mod.create(gamma_initializer),
                               allow_deferred_init=True,
                               grad_req="write" if scale else "null")
        self.beta = Parameter(shape=(in_channels,),
                              init=init_mod.create(beta_initializer),
                              allow_deferred_init=True,
                              grad_req="write" if center else "null")
        self.running_mean = Parameter(
            shape=(in_channels,),
            init=init_mod.create(running_mean_initializer),
            allow_deferred_init=True, grad_req="null", aux_state=True)
        self.running_var = Parameter(
            shape=(in_channels,),
            init=init_mod.create(running_variance_initializer),
            allow_deferred_init=True, grad_req="null", aux_state=True)

    def _finish_deferred(self, x):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            if p._deferred_init is not None:
                p._finish_deferred_init((c,))

    def forward(self, x):
        self._finish_deferred(x)
        training = ag.is_training() and not self._use_global_stats
        out, mean, var = nn_ops.batch_norm(
            x, self.gamma._tensor(), self.beta._tensor(), self.running_mean._tensor(),
            self.running_var._tensor(), eps=self._epsilon,
            fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            use_batch_stats=training)
        if training:
            m = self._momentum
            with torch.no_grad():
                new = {p: p._tensor() * m + stat * (1 - m)
                       for p, stat in ((self.running_mean, mean),
                                       (self.running_var, var))}
            tc = current_trace()
            if tc is None:
                # an in-place write of real values: the record it runs in
                # cannot be deferred by the whole-step capture
                _cs.note_aux_write()
            for p, value in new.items():
                if tc is not None:
                    tc.aux_update(p, value)
                else:
                    with torch.no_grad():
                        p._tensor().copy_(value)
        return out

    def __repr__(self):
        return f"BatchNorm(axis={self._axis}, momentum={self._momentum}, " \
               f"eps={self._epsilon})"


class BatchNormReLU(BatchNorm):
    """BatchNorm followed by ReLU (``mxnet_tpu/gluon/nn/basic_layers.py:
    225``)."""

    def forward(self, x):
        return torch.relu(super().forward(x))


class Flatten(HybridBlock):
    """Every axis after the first folded into one."""

    def forward(self, x):
        return tensor_ops.flatten(x)

    def __repr__(self):
        return "Flatten"


class Identity(HybridBlock):
    def forward(self, x):
        return x


class Activation(HybridBlock):
    """``act_type`` applied elementwise, as the ``Activation`` op."""

    def __init__(self, activation, **kwargs):
        super().__init__(**kwargs)
        self._act_type = activation

    def forward(self, x):
        return nn_ops.activation(x, act_type=self._act_type)

    def __repr__(self):
        return f"Activation({self._act_type})"


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
        return nn_ops.layer_norm(x, self.gamma._tensor(), self.beta._tensor(),
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
