"""Inception v3 at 299² (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``): branches
concatenated on the channels, BatchNorm at epsilon 1e-3, an
``AvgPool2D(8)`` over the last 8×8 map and ``Dropout(0.5)`` before the
classifier."""
from ...block import HybridBlock
from ... import nn
from .alexnet import _no_pretrained

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential()
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for channels, kernel_size, strides, padding in conv_settings:
        kwargs = {"channels": channels, "kernel_size": kernel_size}
        if strides is not None:
            kwargs["strides"] = strides
        if padding is not None:
            kwargs["padding"] = padding
        out.add(_make_basic_conv(**kwargs))
    return out


def _make_A(pool_features):
    out = nn.HybridConcatenate(axis=1)
    out.add(_make_branch(None, (64, 1, None, None)))
    out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, None, 1)))
    out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B():
    out = nn.HybridConcatenate(axis=1)
    out.add(_make_branch(None, (384, 3, 2, None)))
    out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                         (96, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7):
    out = nn.HybridConcatenate(axis=1)
    out.add(_make_branch(None, (192, 1, None, None)))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0))))
    out.add(_make_branch(None, (channels_7x7, 1, None, None),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (channels_7x7, (1, 7), None, (0, 3)),
                         (channels_7x7, (7, 1), None, (3, 0)),
                         (192, (1, 7), None, (0, 3))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D():
    out = nn.HybridConcatenate(axis=1)
    out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
    out.add(_make_branch(None, (192, 1, None, None),
                         (192, (1, 7), None, (0, 3)),
                         (192, (7, 1), None, (3, 0)), (192, 3, 2, None)))
    out.add(_make_branch("max"))
    return out


def _make_E():
    out = nn.HybridConcatenate(axis=1)
    out.add(_make_branch(None, (320, 1, None, None)))
    branch_3x3 = nn.HybridSequential()
    out.add(branch_3x3)
    branch_3x3.add(_make_branch(None, (384, 1, None, None)))
    branch_3x3_split = nn.HybridConcatenate(axis=1)
    branch_3x3_split.add(_make_branch(None, (384, (1, 3), None, (0, 1))))
    branch_3x3_split.add(_make_branch(None, (384, (3, 1), None, (1, 0))))
    branch_3x3.add(branch_3x3_split)
    branch_3x3dbl = nn.HybridSequential()
    out.add(branch_3x3dbl)
    branch_3x3dbl.add(_make_branch(None, (448, 1, None, None),
                                   (384, 3, None, 1)))
    branch_3x3dbl_split = nn.HybridConcatenate(axis=1)
    branch_3x3dbl.add(branch_3x3dbl_split)
    branch_3x3dbl_split.add(_make_branch(None, (384, (1, 3), None, (0, 1))))
    branch_3x3dbl_split.add(_make_branch(None, (384, (3, 1), None, (1, 0))))
    out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        f = self.features = nn.HybridSequential()
        f.add(_make_basic_conv(channels=32, kernel_size=3, strides=2))
        f.add(_make_basic_conv(channels=32, kernel_size=3))
        f.add(_make_basic_conv(channels=64, kernel_size=3, padding=1))
        f.add(nn.MaxPool2D(pool_size=3, strides=2))
        f.add(_make_basic_conv(channels=80, kernel_size=1))
        f.add(_make_basic_conv(channels=192, kernel_size=3))
        f.add(nn.MaxPool2D(pool_size=3, strides=2))
        f.add(_make_A(32))
        f.add(_make_A(64))
        f.add(_make_A(64))
        f.add(_make_B())
        f.add(_make_C(128))
        f.add(_make_C(160))
        f.add(_make_C(160))
        f.add(_make_C(192))
        f.add(_make_D())
        f.add(_make_E())
        f.add(_make_E())
        f.add(nn.AvgPool2D(pool_size=8))
        f.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    _no_pretrained(pretrained)
    return Inception3(**kwargs)
