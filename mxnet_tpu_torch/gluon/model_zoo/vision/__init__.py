"""model_zoo.vision (counterpart of ``mxnet_tpu/gluon/model_zoo/vision``):
the ResNet family, and ``get_model`` over its names.  The reference's
other families (AlexNet, VGG, MobileNet, SqueezeNet, DenseNet,
Inception) are not ported yet: ``get_model`` names them as such."""
from ....base import MXNetError
from . import resnet  # noqa: F401
from .resnet import *  # noqa: F401,F403
from .resnet import __all__ as _resnet_all

__all__ = list(_resnet_all) + ["get_model"]

_models = {name: getattr(resnet, name) for name in _resnet_all
           if name[0].islower() and not name.startswith("get_")}

# the reference's other model names, which the port does not have yet
_NOT_PORTED = (
    ["alexnet", "inception_v3", "squeezenet1_0", "squeezenet1_1"]
    + [f"vgg{n}{bn}" for n in (11, 13, 16, 19) for bn in ("", "_bn")]
    + [f"mobilenet{m}" for m in ("1_0", "0_75", "0_5", "0_25")]
    + [f"mobilenet_v2_{m}" for m in ("1_0", "0_75", "0_5", "0_25")]
    + [f"densenet{n}" for n in (121, 161, 169, 201)])


def get_model(name, **kwargs):
    """The zoo model ``name`` built with ``kwargs``; takes the reference's
    underscore spellings and its dotted ones (``squeezenet1.0``,
    ``mobilenetv2_1.0``, ``inceptionv3``)."""
    name = name.lower()
    alias = (name.replace(".", "_")
             .replace("mobilenetv2_", "mobilenet_v2_")
             .replace("inceptionv3", "inception_v3"))
    if name not in _models and alias in _models:
        name = alias
    if name in _models:
        return _models[name](**kwargs)
    if alias in _NOT_PORTED:
        raise MXNetError(f"model {name!r} is not ported yet; the port has "
                         f"{sorted(_models)}")
    raise MXNetError(f"model {name!r} not found; available: "
                     f"{sorted(_models)}")
