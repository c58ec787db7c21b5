"""The vision zoo's families against the reference on the CPU.

For one or two names of each family (AlexNet, VGG with BatchNorm,
SqueezeNet 1.0 and 1.1, DenseNet, Inception v3, MobileNet v1 and v2) at
toy input sizes (Inception at 299² and DenseNet at 224², the least their
last pooling takes; batch 2 there, else 4; 10 classes): the reference's net is made
and its parameters set (Xavier from a seeded numpy generator), they are
carried across by ``convert.load_collected_params``, and

* the port's eval forward matches the reference's within 1e-4 relative
  L2 in fp32 (TF32 does not arise on the CPU);
* one ``SPMDTrainer`` SGD step (lr 0.01, momentum 0.9, wd 1e-4), both
  nets cast to f64 (the reference under ``jax.enable_x64``), matches in
  loss (rtol 1e-4) and in every parameter within 1e-4 of its norm in L2
  (plus an RMS of 1e-12: a convolution bias right before a BatchNorm
  has an exact gradient of 0 and moves by rounding noise alone), with
  the rate of every ``Dropout`` set to 0 on both sides after
  construction, so that the rest of the step is held exactly.

Why the step runs in f64: in f32, at a toy batch from random weights,
the early layers of the nets with BatchNorm part by 1-5% of their
movement between the packages, while the same step in f64 gives the
same loss to the last bit and every parameter within 3e-12 of its norm
(within 1e-10 of its movement) on every net run here.  The gap is the
f32 step's conditioning (many BatchNorms behind ReLU and max-pool kinks
amplify rounding), not a fault of either package; f64 holds every
layer of every net to 1e-4, where a fault of a layer moves its
parameters by far more.

The names those runs leave out differ from the run ones only in their
family's tables (VGG's layers, DenseNet's blocks, MobileNet's
multiplier): for every name the reference's ``get_model`` builds, the
port's builds the same parameter names (collect_params order included)
and gives ``(1, 10)`` at a size its last pooling takes.  The reference's
f64 step compiles for ~30-50 s on the CPU for DenseNet-121 and
Inception, which is why the full comparison runs on these names alone.
"""
import functools

import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import SPMDTrainer as JTrainer
from mxnet_tpu.parallel import make_mesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.parallel import SPMDTrainer

CLASSES = 10
# the RMS a parameter may part by besides 1e-4 of its norm: a
# convolution's bias right before a BatchNorm has an exact gradient of 0
# and moves by f64 rounding noise alone
BIAS_NOISE = 1e-12
SGD = dict(optimizer="sgd", optimizer_params={"learning_rate": 0.01,
                                              "momentum": 0.9, "wd": 1e-4})
# name -> input size
FULL = {"alexnet": 64, "vgg11_bn": 64, "squeezenet1_0": 64,
        "squeezenet1_1": 64, "densenet121": 224, "inception_v3": 299,
        "mobilenet0_25": 64, "mobilenet_v2_0_25": 64}
# every name the reference's get_model builds beyond ResNet
NAMES = sorted(n for n in jvision._models if not n.startswith("resnet"))
# the size each family's last pooling takes
HW = {"densenet": 224, "inception": 299, "alexnet": 64, "squeezenet": 64}


def _hw(name):
    return next((v for k, v in HW.items() if name.startswith(k)), 32)


def _batch(hw, seed=0):
    r = onp.random.RandomState(seed)
    n = 2 if hw > 200 else 4
    return (r.standard_normal((n, 3, hw, hw)).astype(onp.float32),
            onp.array([3.0, 7.0, 1.0, 9.0][:n], onp.float32))


def _no_dropout(blocks):
    for b in blocks:
        if type(b).__name__ == "Dropout":
            b._rate = 0.0


def _ref_blocks(block):
    yield block
    for child in block._children.values():
        yield from _ref_blocks(child)


def _port_shapes(name):
    """Each parameter's shape by name in the port's net after a forward."""
    net = vision.get_model(name, classes=CLASSES)
    net.initialize(device="cpu")
    with torch.no_grad():
        net(torch.zeros((1, 3, FULL[name], FULL[name])))
    return {k: tuple(p.shape) for k, p in net.collect_params().items()}


def _init_value(key, shape, rng):
    """A parameter's first value by the suffix of its name, as the
    reference's initializers dispatch (``gamma`` and ``running_var`` 1,
    ``beta``, ``bias`` and ``running_mean`` 0), Xavier's uniform draw
    (magnitude 3, fans averaged) for a weight."""
    suffix = key.rsplit(".", 1)[-1]
    if suffix in ("gamma", "running_var"):
        return onp.ones(shape, onp.float32)
    if suffix in ("beta", "bias", "running_mean"):
        return onp.zeros(shape, onp.float32)
    assert suffix == "weight", key
    field = int(onp.prod(shape[2:]))
    scale = onp.sqrt(3.0 / ((shape[0] + shape[1]) * field / 2.0))
    return rng.uniform(-scale, scale, shape).astype(onp.float32)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's eval logits and its weights in f32, then, the net
    cast to f64, its loss and parameters after one SGD step in f64.  Its
    parameters are set from numpy (seeded, Xavier) at the port's shapes;
    the shape setter refuses any that disagree with what the reference
    knows.  So its eval forward runs hybridized, as one XLA program,
    where deferred init through its own initializer would compile op by
    op (~90 s on the CPU for DenseNet-121 and Inception together)."""
    hw = FULL[name]
    x, y = _batch(hw)
    rng = onp.random.RandomState(3)
    net = jvision.get_model(name, classes=CLASSES)
    params = net.collect_params()
    for k, shape in _port_shapes(name).items():
        params[k].set_data(_init_value(k, shape, rng))
    net.hybridize()
    logits = net(NDArray(x)).asnumpy()
    net.hybridize(False)
    weights = {k: p.data().asnumpy() for k, p in
               net.collect_params().items()}
    _no_dropout(_ref_blocks(net))
    with jax.enable_x64(True):
        net.cast("float64")
        tr = JTrainer(net, jloss.SoftmaxCrossEntropyLoss(),
                      mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                      **SGD)
        loss = float(tr.step(NDArray(x.astype(onp.float64)),
                             NDArray(y.astype(onp.float64))).asnumpy())
        after = {k: p.data().asnumpy() for k, p in
                 net.collect_params().items()}
    return logits, weights, loss, after


def _port(name, weights):
    net = vision.get_model(name, classes=CLASSES)
    net.initialize(device="cpu")
    net(torch.zeros((1, 3, FULL[name], FULL[name])))
    convert.load_collected_params(net, weights, device="cpu")
    return net


def _rel_l2(got, want):
    return onp.linalg.norm(got - want) / max(onp.linalg.norm(want), 1e-30)


# DenseNet-121 and Inception-v3 run from files of their own
# (test_torch_vision_zoo_densenet.py, test_torch_vision_zoo_inception.py),
# so that --dist loadfile compiles their reference programs on other
# workers than the rest of the zoo
SPLIT = ("densenet121", "inception_v3")


@pytest.mark.parametrize("name", sorted(set(FULL) - set(SPLIT)))
def test_eval_forward_matches_the_reference(name):
    check_eval_forward(name)


@pytest.mark.parametrize("name", sorted(set(FULL) - set(SPLIT)))
def test_one_sgd_step_matches_the_reference(name):
    check_sgd_step(name)


def check_eval_forward(name):
    logits, weights, _, _ = _reference(name)
    net = _port(name, weights)
    x, _ = _batch(FULL[name])
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == logits.shape == (x.shape[0], CLASSES)
    assert _rel_l2(got, logits) <= 1e-4, _rel_l2(got, logits)


def check_sgd_step(name):
    _, weights, want_loss, want = _reference(name)
    net = _port(name, weights)
    net.cast("float64")
    _no_dropout(net.modules())
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), device="cpu",
                     **SGD)
    x, y = _batch(FULL[name])
    loss = float(tr.step(torch.from_numpy(x.astype(onp.float64)),
                         torch.from_numpy(y.astype(onp.float64))))
    onp.testing.assert_allclose(loss, want_loss, rtol=1e-4)
    got = {k: p._tensor().detach().numpy().copy()
           for k, p in net.collect_params().items()}
    assert list(got) == list(want)
    moved = 0
    for k, w in want.items():
        assert got[k].dtype == w.dtype == onp.float64, k
        apart = onp.linalg.norm(got[k] - w)
        bound = 1e-4 * onp.linalg.norm(w) + BIAS_NOISE * onp.sqrt(w.size)
        assert apart <= bound, (k, apart, bound)
        moved += not onp.array_equal(w, weights[k])
    assert moved == len(want), (moved, len(want))   # the step held all


@pytest.mark.parametrize("name", NAMES)
def test_every_reference_name_builds_the_same_parameters(name):
    ref = jvision.get_model(name, classes=CLASSES)
    net = vision.get_model(name, classes=CLASSES)
    assert list(net.collect_params()) == list(ref.collect_params())
    hw = _hw(name)
    net.initialize(device="cpu")
    with torch.no_grad():
        out = net(torch.zeros((1, 3, hw, hw)))
    assert tuple(out.shape) == (1, CLASSES)


def test_get_model_takes_the_reference_spellings():
    for alias, name in (("squeezenet1.0", "squeezenet1_0"),
                        ("mobilenetv2_1.0", "mobilenet_v2_1_0"),
                        ("inceptionv3", "inception_v3"),
                        ("VGG16", "vgg16")):
        assert type(vision.get_model(alias)) is \
            type(vision.get_model(name))
    with pytest.raises(mt.MXNetError):
        vision.get_model("lenet")
    with pytest.raises(mt.MXNetError):
        vision.get_model("alexnet", pretrained=True)


def test_depthwise_convolution_groups_match_the_reference():
    """MobileNet's depthwise convolution: ``groups == channels`` gives a
    (C, 1, 3, 3) weight and the reference's output."""
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn
    x = onp.random.RandomState(1).standard_normal((2, 8, 9, 9)).astype(
        onp.float32)
    ref = jnn.Conv2D(8, 3, 2, 1, groups=8, use_bias=False)
    mx.random.seed(0)
    ref.initialize(init=mx.initializer.Xavier())
    want = ref(NDArray(x)).asnumpy()
    net = nn.Conv2D(8, 3, 2, 1, groups=8, use_bias=False)
    net.initialize(device="cpu")
    net(torch.from_numpy(x))
    assert tuple(net.weight.shape) == (8, 1, 3, 3)
    convert.load_collected_params(
        net, {k: p.data().asnumpy() for k, p in
              ref.collect_params().items()}, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert _rel_l2(got, want) <= 1e-6


LAYERS = {
    "LeakyReLU": ((0.2,), {}), "ELU": ((0.7,), {}), "SELU": ((), {}),
    "Swish": ((1.5,), {}), "Softmax": ((), {"axis": 1}),
    "LogSoftmax": ((), {}), "PReLU": ((), {"in_channels": 4}),
    "GroupNorm": ((2,), {"in_channels": 4}),
    "InstanceNorm": ((), {"in_channels": 4, "scale": True}),
}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_matches_the_reference(layer):
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn
    args, kw = LAYERS[layer]
    x = onp.random.RandomState(2).standard_normal((2, 4, 5, 3)).astype(
        onp.float32)
    ref = getattr(jnn, layer)(*args, **kw)
    mx.random.seed(0)
    ref.initialize(init=mx.initializer.Xavier())
    want = ref(NDArray(x)).asnumpy()
    net = getattr(nn, layer)(*args, **kw)
    net.initialize(device="cpu")
    weights = {k: p.data().asnumpy() for k, p in
               ref.collect_params().items()}
    if weights:
        net(torch.from_numpy(x))
        convert.load_collected_params(net, weights, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_concatenate_and_lambda_blocks_match_the_reference():
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu_torch.gluon import nn
    x = onp.random.RandomState(4).standard_normal((2, 3, 4)).astype(
        onp.float32)

    def build(pkg):
        c = pkg.HybridConcatenate(axis=1)
        c.add(pkg.HybridLambda(lambda a: a * 2), pkg.Lambda("relu"))
        s = pkg.Concatenate(axis=-1)
        s.add(pkg.Identity(), pkg.HybridLambda("tanh"))
        return c, s

    ref = [b(NDArray(x)).asnumpy() for b in build(jnn)]
    got = [b(torch.from_numpy(x)).numpy() for b in build(nn)]
    for g, r in zip(got, ref):
        onp.testing.assert_allclose(g, r, rtol=1e-6)
