"""Convolution and pooling Gluon layers (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): ``Conv1D/2D/3D``,
``Max/AvgPool1D/2D/3D`` and ``GlobalMax/AvgPool1D/2D/3D``, channels
first, over the ``Convolution`` and ``Pooling`` ops.  The transposed
convolutions and ``ReflectionPad2D`` are not ported yet."""
from __future__ import annotations

from ... import initializer as init_mod
from ...ops import nn as nn_ops
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["Conv1D", "Conv2D", "Conv3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class _Conv(HybridBlock):
    """A convolution with weight ``(channels, in_channels/groups,
    *kernel)``; ``in_channels`` 0 is filled in by the first forward."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__(**kwargs)
        n = len(kernel_size)
        self._channels = channels
        self._kernel = tuple(kernel_size)
        self._strides = _tup(strides, n)
        self._padding = _tup(padding, n)
        self._dilation = _tup(dilation, n)
        self._groups = groups
        self._layout = layout
        self._activation = activation
        self.weight = Parameter(
            shape=(channels, in_channels // groups if in_channels else 0)
            + self._kernel, dtype=dtype, init=weight_initializer,
            allow_deferred_init=True)
        self.bias = Parameter(shape=(channels,), dtype=dtype,
                              init=init_mod.create(bias_initializer),
                              allow_deferred_init=True) if use_bias else None

    def _finish_deferred(self, x):
        if self.weight._deferred_init is not None:
            self.weight._finish_deferred_init(
                (self._channels, x.shape[1] // self._groups) + self._kernel)
        if self.bias is not None and self.bias._deferred_init is not None:
            self.bias._finish_deferred_init((self._channels,))

    def forward(self, x):
        self._finish_deferred(x)
        out = nn_ops.convolution(
            x, self.weight._tensor(),
            self.bias._tensor() if self.bias is not None else None,
            kernel=self._kernel, stride=self._strides,
            dilate=self._dilation, pad=self._padding,
            num_filter=self._channels, num_group=self._groups,
            layout=self._layout)
        if self._activation:
            out = nn_ops.activation(out, act_type=self._activation)
        return out

    def __repr__(self):
        return f"{type(self).__name__}({self._channels}, " \
               f"kernel_size={self._kernel}, stride={self._strides})"


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 1), strides, padding,
                         dilation, groups, layout, in_channels, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", in_channels=0,
                 **kwargs):
        super().__init__(channels, _tup(kernel_size, 2), strides, padding,
                         dilation, groups, layout, in_channels, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", in_channels=0, **kwargs):
        super().__init__(channels, _tup(kernel_size, 3), strides, padding,
                         dilation, groups, layout, in_channels, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = dict(
            kernel=pool_size, stride=_tup(strides, len(pool_size)),
            pad=_tup(padding, len(pool_size)), global_pool=global_pool,
            pool_type=pool_type,
            pooling_convention="full" if ceil_mode else "valid",
            layout=layout)
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def forward(self, x):
        return nn_ops.pooling(x, **self._kwargs)

    def __repr__(self):
        return f"{type(self).__name__}(size={self._kwargs['kernel']}, " \
               f"stride={self._kwargs['stride']})"


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 1), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 2), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, **kwargs):
        super().__init__(_tup(pool_size, 3), strides, padding, ceil_mode,
                         False, "max", layout, **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        super().__init__(_tup(pool_size, 1), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 2), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True,
                 **kwargs):
        super().__init__(_tup(pool_size, 3), strides, padding, ceil_mode,
                         False, "avg", layout, count_include_pad, **kwargs)


class _GlobalPooling(HybridBlock):
    """Every spatial axis pooled to size 1 (kept: ``(N, C, 1, ...)``)."""

    def __init__(self, pool_type, layout, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = dict(kernel=(1,), global_pool=True,
                            pool_type=pool_type, layout=layout)

    def forward(self, x):
        return nn_ops.pooling(x, **self._kwargs)


class GlobalMaxPool1D(_GlobalPooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__("max", layout, **kwargs)


class GlobalMaxPool2D(_GlobalPooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__("max", layout, **kwargs)


class GlobalMaxPool3D(_GlobalPooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__("max", layout, **kwargs)


class GlobalAvgPool1D(_GlobalPooling):
    def __init__(self, layout="NCW", **kwargs):
        super().__init__("avg", layout, **kwargs)


class GlobalAvgPool2D(_GlobalPooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__("avg", layout, **kwargs)


class GlobalAvgPool3D(_GlobalPooling):
    def __init__(self, layout="NCDHW", **kwargs):
        super().__init__("avg", layout, **kwargs)
