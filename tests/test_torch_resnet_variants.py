"""The rest of the ResNet path of the port against the reference on the
CPU, on the same weights (carried across by
``convert.load_collected_params``, running statistics included) and the
same numpy inputs; the helpers are ``test_torch_resnet.py``'s:

* ``remat`` against the reference's: three SGD steps of ResNet-18 v1
  thumbnail, losses rtol 1e-4, masters and momenta 3e-4 in L2 (the first
  file's fp32 bounds);
* ResNet-50 v1 thumbnail (classes 10) eval logits on a (2, 3, 32, 32)
  batch, with running statistics set away from their initial values so
  that the aux states carried across take part: fp32, within 1e-4 of
  the largest logit;
* BatchNorm eager under ``autograd.record()`` (a ``BasicBlockV1`` with
  downsampling): the output (1e-5), the input's gradient (1e-4) and the
  running statistics written in place (1e-5);
* ``predict`` (1e-4) and ``Block.cast("bfloat16")``'s eval forward
  (2e-2 of the largest logit);
* ``get_model`` over the reference's names, and ``SPMDTrainer(net,
  loss)`` with the default optimizer, SGD.

Elementwise bounds are the shared helper's ``|got − ref| ≤ tol·(|ref| +
max|ref|)``.
"""
import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.parallel import SPMDTrainer

from test_torch_parity import close
from test_torch_resnet import (SGD, X, Y, _assert_steps_match, _jax_resnet,
                               _numpy, _port_net18)


def test_remat_matches_reference():
    _assert_steps_match({"remat": True}, 1e-4, 3e-4)

def test_resnet50_thumbnail_logits():
    """Eval logits with running statistics set away from their initial
    values, so that the aux states carried across take part."""
    ref = _jax_resnet(50, 32, 2)
    rng = onp.random.RandomState(3)
    for k, p in ref.collect_params().items():
        if k.endswith("running_mean"):
            p.set_data(0.1 * rng.standard_normal(p.shape).astype(onp.float32))
        elif k.endswith("running_var"):
            p.set_data(0.5 + rng.rand(*p.shape).astype(onp.float32))
    x = rng.standard_normal((2, 3, 32, 32)).astype(onp.float32)
    want = ref(NDArray(x)).asnumpy()
    net = vision.get_resnet(1, 50, classes=10, thumbnail=True)
    convert.load_collected_params(net, _numpy(ref), device="cpu")
    got = net(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 10)
    tol = 1e-4 * onp.abs(want).max()
    assert onp.abs(got - want).max() <= tol, onp.abs(got - want).max()
    names = list(net.collect_params())
    assert "features.1.0.body.1.running_mean" in names
    # thumbnail: no stem BatchNorm; 16 blocks of 3 and 4 downsamplings
    assert sum(k.endswith("running_var") for k in names) == 52


def test_batch_norm_eager_under_record():
    """A ``BasicBlockV1`` with downsampling, one forward under
    ``autograd.record()`` and a backward in each package: the output and
    the three BatchNorms' running statistics, written in place."""
    mx.random.seed(4)
    ref = jax_vision.BasicBlockV1(8, 2, downsample=True, in_channels=4)
    ref.initialize(init=mx.initializer.Xavier())
    x = onp.random.RandomState(5).standard_normal(
        (2, 4, 6, 6)).astype(onp.float32)
    ref(NDArray(x))                           # deferred dims, eval mode
    init = _numpy(ref)
    xr = NDArray(x)
    xr.attach_grad()
    with mx.autograd.record():
        want = ref(xr)
    want.backward()
    blk = vision.BasicBlockV1(8, 2, downsample=True, in_channels=4)
    convert.load_collected_params(blk, init, device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    with mt.autograd.record():
        out = blk(xt)
    out.sum().backward()
    close(out, want.asnumpy(), 1e-5, "out")
    close(xt.grad, xr.grad.asnumpy(), 1e-4, "dx")
    got, want_p = convert.collected_params_to_numpy(blk), _numpy(ref)
    stats = [k for k in want_p if k.endswith(("running_mean",
                                              "running_var"))]
    assert len(stats) == 6
    for k in stats:
        assert not onp.array_equal(want_p[k], init[k]), k
        close(got[k], want_p[k], 1e-5, k)
    for name, p in blk.collect_params().items():
        if name.endswith("running_mean"):
            assert p.grad_req == "null" and p._is_aux
            assert not p.data().requires_grad


def test_predict_and_cast_to_bf16():
    """``predict`` (eval mode: running statistics, nothing written) in
    fp32 against the reference's; ``net.cast("bfloat16")`` then an eval
    forward on bf16 input against the reference's cast net, at bf16
    tolerance (2e-2 of the largest logit)."""
    ref = _jax_resnet(18, 16, 1)
    rng = onp.random.RandomState(6)
    for k, p in ref.collect_params().items():
        if k.endswith("running_var"):
            p.set_data(0.5 + rng.rand(*p.shape).astype(onp.float32))
    init = _numpy(ref)
    tr = JaxTrainer(ref, jax_loss.SoftmaxCrossEntropyLoss(),
                    mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                    **SGD)
    want = tr.predict(NDArray(X)).asnumpy()
    net = vision.get_resnet(1, 18, classes=10, thumbnail=True)
    convert.load_collected_params(net, init, device="cpu")
    ptr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), device="cpu",
                      **SGD)
    got = ptr.predict(X)
    assert got.dtype == torch.float32
    close(got, want, 1e-4, "predict")
    assert onp.array_equal(convert.collected_params_to_numpy(net)[
        "features.1.0.body.1.running_var"],
        init["features.1.0.body.1.running_var"])

    ref.cast("bfloat16")
    want16 = ref(NDArray(X).astype("bfloat16")).astype("float32").asnumpy()
    net.cast("bfloat16")
    for p in net.collect_params().values():
        assert p.data().dtype == torch.bfloat16 and p.dtype == torch.bfloat16
    got16 = net(torch.from_numpy(X).bfloat16())
    assert got16.dtype == torch.bfloat16
    err = onp.abs(got16.float().detach().numpy() - want16).max()
    assert err <= 2e-2 * onp.abs(want16).max(), err


def test_get_model_and_the_default_optimizer():
    net = vision.get_model("resnet50_v1", classes=10, thumbnail=True)
    assert isinstance(net, vision.ResNetV1)
    assert isinstance(mt.gluon.model_zoo.get_model("ResNet18_V2"),
                      vision.ResNetV2)
    with pytest.raises(MXNetError, match="not ported yet"):
        vision.get_model("squeezenet1.0")
    with pytest.raises(MXNetError, match="not ported yet"):
        vision.get_model("vgg16_bn")
    with pytest.raises(MXNetError, match="not found"):
        vision.get_model("resnet51_v1")
    with pytest.raises(MXNetError, match="pretrained"):
        vision.resnet18_v1(pretrained=True)
    net = _port_net18()
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), device="cpu")
    assert isinstance(tr.optimizer, mt.optimizer.SGD)
    assert tr.optimizer.op_name == "sgd_update"
    w0 = net.output.weight.data().clone()
    loss = tr.step(X, Y)
    assert torch.isfinite(loss) and not torch.equal(w0,
                                                    net.output.weight.data())

