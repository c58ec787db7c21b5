"""model_zoo.vision (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``):
ResNet v1/v2, AlexNet, VGG 11–19 (with and without BatchNorm),
MobileNet v1/v2, SqueezeNet 1.0/1.1, DenseNet 121–201 and Inception v3,
and ``get_model`` over their names."""
from ....base import MXNetError
from . import resnet as _resnet
from . import alexnet as _alexnet
from . import vgg as _vgg
from . import mobilenet as _mobilenet
from . import squeezenet as _squeezenet
from . import densenet as _densenet
from . import inception as _inception

__all__ = ["get_model"]
_models = {}
for _mod in (_resnet, _alexnet, _vgg, _mobilenet, _squeezenet, _densenet,
             _inception):
    for _name in _mod.__all__:
        _obj = getattr(_mod, _name)
        globals()[_name] = _obj
        __all__.append(_name)
        if _name[0].islower() and not _name.startswith("get_"):
            _models[_name] = _obj


def get_model(name, **kwargs):
    """The zoo model ``name`` built with ``kwargs``; takes the reference's
    underscore spellings and its dotted ones (``squeezenet1.0``,
    ``mobilenetv2_1.0``, ``inceptionv3``)."""
    name = name.lower()
    if name not in _models:
        alias = (name.replace(".", "_")
                 .replace("mobilenetv2_", "mobilenet_v2_")
                 .replace("inceptionv3", "inception_v3"))
        name = alias if alias in _models else name
    if name not in _models:
        raise MXNetError(f"model {name!r} not found; available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
