"""SqueezeNet 1.0 and 1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``): fire modules whose
two expand paths are concatenated on the channels, pooling with
``ceil_mode`` (the ``Pooling`` op's ``pooling_convention="full"``)."""
from ...block import HybridBlock
from ... import nn
from .alexnet import _no_pretrained

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential()
    out.add(nn.Conv2D(squeeze_channels, kernel_size=1, activation="relu"))
    paths = nn.HybridConcatenate(axis=1)
    p1 = nn.HybridSequential()
    p1.add(nn.Conv2D(expand1x1_channels, kernel_size=1, activation="relu"))
    p3 = nn.HybridSequential()
    p3.add(nn.Conv2D(expand3x3_channels, kernel_size=3, padding=1,
                     activation="relu"))
    paths.add(p1)
    paths.add(p3)
    out.add(paths)
    return out


def _pool():
    return nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        assert version in ("1.0", "1.1")
        f = self.features = nn.HybridSequential()
        if version == "1.0":
            f.add(nn.Conv2D(96, kernel_size=7, strides=2, activation="relu"))
            f.add(_pool())
            f.add(_make_fire(16, 64, 64))
            f.add(_make_fire(16, 64, 64))
            f.add(_make_fire(32, 128, 128))
            f.add(_pool())
            f.add(_make_fire(32, 128, 128))
            f.add(_make_fire(48, 192, 192))
            f.add(_make_fire(48, 192, 192))
            f.add(_make_fire(64, 256, 256))
            f.add(_pool())
            f.add(_make_fire(64, 256, 256))
        else:
            f.add(nn.Conv2D(64, kernel_size=3, strides=2, activation="relu"))
            f.add(_pool())
            f.add(_make_fire(16, 64, 64))
            f.add(_make_fire(16, 64, 64))
            f.add(_pool())
            f.add(_make_fire(32, 128, 128))
            f.add(_make_fire(32, 128, 128))
            f.add(_pool())
            f.add(_make_fire(48, 192, 192))
            f.add(_make_fire(48, 192, 192))
            f.add(_make_fire(64, 256, 256))
            f.add(_make_fire(64, 256, 256))
        f.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential()
        self.output.add(nn.Conv2D(classes, kernel_size=1, activation="relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(pretrained=False, ctx=None, root=None, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, ctx=None, root=None, **kwargs):
    _no_pretrained(pretrained)
    return SqueezeNet("1.1", **kwargs)
