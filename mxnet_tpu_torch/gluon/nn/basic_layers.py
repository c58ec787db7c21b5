"""Basic Gluon layers (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): ``Sequential``,
``HybridSequential``,
``Dense``, ``Dropout``, ``Embedding``, ``BatchNorm``, ``BatchNormReLU``,
``SyncBatchNorm``, ``LayerNorm``, ``GroupNorm``, ``InstanceNorm``,
``Flatten``, ``Lambda``, ``HybridLambda``, ``Identity``,
``Concatenate``, ``HybridConcatenate`` and the activations
(``Activation``, ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``GELU``,
``Swish``/``SiLU``, ``Softmax``, ``LogSoftmax``)."""
from __future__ import annotations

import torch

from ... import autograd as ag
from ... import initializer as init_mod
from ...imperative import cached_step as _cs
from ...ops import nn as nn_ops
from ...ops import tensor as tensor_ops
from ...parallel import tensor_parallel as _tp
from ..block import Block, HybridBlock, current_trace
from ..parameter import Parameter

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "Embedding",
           "BatchNorm", "BatchNormReLU", "SyncBatchNorm", "LayerNorm",
           "GroupNorm", "InstanceNorm", "Flatten", "Lambda", "HybridLambda",
           "Identity", "Concatenate", "HybridConcatenate", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish", "SiLU",
           "Softmax", "LogSoftmax"]


class _SequentialMixin:
    """Children run in order; ``add`` names them ``0``, ``1``, ...  In a
    meshed step a column-parallel ``Dense`` followed by a row-parallel
    one (at most an ``Activation`` or ``GELU`` between them) runs as
    Megatron's pair (``tensor_parallel.paired``)."""

    def add(self, *blocks):
        for b in blocks:
            self.register_child(b)
        return self

    def forward(self, x, *args):
        blocks = list(self._children.values())
        i = 0
        while i < len(blocks):
            j = _pair_end(blocks, i)
            if j is None:
                x = blocks[i](x)
                i += 1
                continue
            with _tp.paired(blocks[i], blocks[j]):
                for block in blocks[i:j + 1]:
                    x = block(x)
            i = j + 1
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


def _pair_end(blocks, i):
    """The index of the row-parallel ``Dense`` that the column-parallel
    ``Dense`` at ``i`` feeds alone in this step, else None."""
    if _tp.active() is None or not isinstance(blocks[i], Dense):
        return None
    j = i + 1
    if j < len(blocks) and isinstance(blocks[j], (Activation, GELU)):
        j += 1
    if j < len(blocks) and isinstance(blocks[j], Dense) and \
            _tp.pair_axis(blocks[i], blocks[j]) is not None:
        return j
    return None


class Sequential(_SequentialMixin, Block):
    """The eager container (``mxnet_tpu/gluon/nn/basic_layers.py:29``)."""


class HybridSequential(_SequentialMixin, HybridBlock):
    """The hybridizable container; here it runs eagerly too."""


def _fc(x, w, b, flatten):
    return nn_ops.fully_connected(x, w, b, flatten=flatten)


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
        w = self.weight._tensor()
        b = self.bias._tensor() if self.bias is not None else None
        ax = _tp.local_axis(self.weight)
        if ax is not None:
            # a meshed trainer's step reads the weight's tp shard
            out = _tp.dense(_fc, x, w, b, self.weight, self.bias, ax,
                            self._flatten)
        else:
            out = nn_ops.fully_connected(x, w, b, flatten=self._flatten)
        if self._activation:
            out = nn_ops.activation(out, act_type=self._activation)
        return out

    def __repr__(self):
        return f"Dense({self._units}, {self._activation or 'linear'})"


class Dropout(HybridBlock):
    """Zeroes elements at ``rate`` in training mode
    (``autograd.is_training()``) and scales the rest by ``1/(1-rate)``,
    one mask shared along ``axes`` (``mxnet_tpu/gluon/nn/basic_layers.py:
    136-154``), over the ``Dropout`` op: the mask comes from
    ``mx.random`` or from the enclosing trainer step's trace."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        return nn_ops.dropout(x, p=self._rate, axes=self._axes)

    def __repr__(self):
        return f"Dropout(p = {self._rate}, axes={self._axes})"


class Embedding(HybridBlock):
    """Rows of a ``(input_dim, output_dim)`` table at integer ids.  With
    ``sparse_grad=True`` the weight's gradient is row-sparse (its buffer
    a ``RowSparseNDArray`` of the batch's unique ids, no dense (vocab,
    dim) gradient built), and the optimizers update only those rows
    (their lazy updates); such a block cannot be hybridized."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = bool(sparse_grad)
        self.weight = Parameter(
            shape=(input_dim, output_dim), dtype=dtype,
            init=weight_initializer,
            grad_stype="row_sparse" if sparse_grad else "default")

    def forward(self, x):
        fn = tensor_ops.sparse_embedding if self._sparse_grad \
            else tensor_ops.embedding
        return fn(x, self.weight._tensor())

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
    mode the running statistics normalise and nothing is written.

    In a meshed trainer's step whose batch is split over live axes (dp,
    and sp over the sequence) the statistics are the whole batch's, as
    the reference's under GSPMD: ``ops.nn.sync_batch_norm`` sums them
    over those axes (``tensor_parallel.batch_reducer``), so the running
    statistics are the same on every rank.  At one rank, or outside a
    mesh, the single-device path runs unchanged."""

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
        reducer = (_tp.batch_reducer(self._axis, x.dim()) if training
                   else None)
        if reducer is not None:
            out, mean, var = nn_ops.sync_batch_norm(
                x, self.gamma._tensor(), self.beta._tensor(), reducer,
                eps=self._epsilon, fix_gamma=not self._scale,
                axis=self._axis)
        else:
            out, mean, var = nn_ops.batch_norm(
                x, self.gamma._tensor(), self.beta._tensor(),
                self.running_mean._tensor(), self.running_var._tensor(),
                eps=self._epsilon, fix_gamma=not self._scale,
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


class SyncBatchNorm(BatchNorm):
    """Cross-device BatchNorm, with the reference's signature
    (``mxnet_tpu/gluon/nn/basic_layers.py:235-242``): ``BatchNorm``
    already takes the whole batch's statistics when a meshed step splits
    the batch over ranks, so ``num_devices`` is accepted and unused."""

    def __init__(self, in_channels=0, num_devices=None, **kwargs):
        super().__init__(in_channels=in_channels, **kwargs)


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


class _ChannelNorm(HybridBlock):
    """gamma and beta over the channels, deferred to the first
    forward."""

    def __init__(self, center, scale, beta_initializer, gamma_initializer,
                 in_channels, **kwargs):
        super().__init__(**kwargs)
        self.gamma = Parameter(shape=(in_channels,),
                               init=init_mod.create(gamma_initializer),
                               allow_deferred_init=True,
                               grad_req="write" if scale else "null")
        self.beta = Parameter(shape=(in_channels,),
                              init=init_mod.create(beta_initializer),
                              allow_deferred_init=True,
                              grad_req="write" if center else "null")

    def _affine(self, c):
        for p in (self.gamma, self.beta):
            if p._deferred_init is not None:
                p._finish_deferred_init((c,))
        return self.gamma._tensor(), self.beta._tensor()


class GroupNorm(_ChannelNorm):
    """Normalisation over channel groups and the spatial axes
    (``mxnet_tpu/gluon/nn/basic_layers.py:308-330``)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)
        self._num_groups = num_groups
        self._epsilon = epsilon

    def forward(self, x):
        g, b = self._affine(x.shape[1])
        return nn_ops.group_norm(x, g, b, num_groups=self._num_groups,
                                 eps=self._epsilon)


class InstanceNorm(_ChannelNorm):
    """Normalisation of each sample over every axis but ``axis``
    (``mxnet_tpu/gluon/nn/basic_layers.py:333-356``)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(center, scale, beta_initializer, gamma_initializer,
                         in_channels, **kwargs)
        self._axis = axis
        self._epsilon = epsilon

    def forward(self, x):
        g, b = self._affine(x.shape[self._axis % x.dim()])
        return tensor_ops.instance_norm(x, g, b, eps=self._epsilon,
                                        axis=self._axis)


class _LambdaMixin:
    """``function`` (a callable, or the name of an ``mx.nd`` function,
    which takes NDArrays) applied to the inputs."""

    def __init__(self, function, **kwargs):
        super().__init__(**kwargs)
        self._func = function if callable(function) else None
        self._fname = function if isinstance(function, str) else None

    def forward(self, *args):
        if self._func is not None:
            return self._func(*args)
        from ... import ndarray as nd
        from ...ndarray.ndarray import NDArray
        out = getattr(nd, self._fname)(*[NDArray._wrap(a) if isinstance(
            a, torch.Tensor) else a for a in args])
        return out._data if isinstance(out, NDArray) else out


class Lambda(_LambdaMixin, Block):
    """(``mxnet_tpu/gluon/nn/basic_layers.py:359-369``)"""


class HybridLambda(_LambdaMixin, HybridBlock):
    """(``mxnet_tpu/gluon/nn/basic_layers.py:372-382``)"""


class _ConcatenateMixin:
    """Every child on the same input, their outputs concatenated along
    ``axis``."""

    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def forward(self, x):
        return tensor_ops.concat(*[block(x) for block in
                                   self._children.values()], dim=self.axis)


class Concatenate(_ConcatenateMixin, Sequential):
    """(``mxnet_tpu/gluon/nn/basic_layers.py:390-400``)"""


class HybridConcatenate(_ConcatenateMixin, HybridSequential):
    """(``mxnet_tpu/gluon/nn/basic_layers.py:403-411``)"""


class LeakyReLU(HybridBlock):
    def __init__(self, alpha=0.01, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return nn_ops.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope per channel (``alpha``, shape
    ``(in_channels,)``, initialised to 0.25)."""

    def __init__(self, alpha_initializer=None, in_channels=1, **kwargs):
        super().__init__(**kwargs)
        self.alpha = Parameter(name="alpha", shape=(in_channels,),
                               init=alpha_initializer
                               or init_mod.Constant(0.25))

    def forward(self, x):
        return nn_ops.leaky_relu(x, self.alpha._tensor(), act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def forward(self, x):
        return nn_ops.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return nn_ops.leaky_relu(x, act_type="selu")


class Swish(HybridBlock):
    """``x · sigmoid(beta · x)``."""

    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def forward(self, x):
        return x * (1.0 / (1.0 + torch.exp(-self._beta * x)))


SiLU = Swish


class Softmax(HybridBlock):
    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def forward(self, x):
        return nn_ops.softmax(x, axis=self._axis)


class LogSoftmax(HybridBlock):
    def __init__(self, axis=-1, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis

    def forward(self, x):
        return nn_ops.log_softmax(x, axis=self._axis)
