"""AlexNet (counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``):
five convolutions and three dense layers, two ``Dropout(0.5)`` in the
classifier.  Parameter names equal the reference's, so that
``convert.load_collected_params`` carries a net across.
``pretrained=True`` is not ported (no download)."""
from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self.features = nn.HybridSequential()
        self.features.add(nn.Conv2D(64, kernel_size=11, strides=4, padding=2,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                    activation="relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(nn.Flatten())
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.features.add(nn.Dense(4096, activation="relu"))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def _no_pretrained(pretrained):
    if pretrained:
        raise MXNetError("pretrained weights are not ported (no download): "
                         "initialize, or carry the reference's across with "
                         "convert.load_collected_params")


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    _no_pretrained(pretrained)
    return AlexNet(**kwargs)
