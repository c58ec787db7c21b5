"""The eager Gluon loop on ResNet-18 v1 thumbnail against the reference
on the CPU, as ``test_torch_gluon_trainer.py`` holds the other nets (its
text gives the setting): a file of its own, so that ``--dist loadfile``
runs the reference's loop on another worker."""
import numpy as onp

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo import vision as jax_vision

from test_torch_gluon_trainer import (RESNET_SGD, RESNET_X, RESNET_Y,
                                      _l2_close, _l2_within, _params,
                                      _port_resnet, _ref_loop, _ref_states)


def test_resnet18_eager_loop_matches_reference():
    """Three recorded steps of ResNet-18 v1 thumbnail (10 classes) on two
    32x32 images, fp32: losses, every weight and running statistic (each
    BatchNorm's written eagerly in training mode) and every momentum.

    With two images a channel's batch statistics come from 32 elements in
    the last stage, and the reference's f32 gradients there lie ~1% (in
    L2) from the same net's f64 ones, where the port's lie 3e-6 away
    (measured on this input).  So: the first loss at rtol 1e-5 and the
    three at 1e-2; every tensor no farther from the reference's than
    twice the reference's own distance from the port's f64 run of the
    same steps, plus 1e-3 of its norm (in L2); and the port's f32 run
    within 3e-4 of that f64 run (L2; losses rtol 1e-4)."""
    mx.random.seed(1)
    jnet = jax_vision.get_resnet(1, 18, classes=10, thumbnail=True)
    jnet.initialize(init=mx.initializer.Xavier())
    jnet(mx.nd.array(onp.zeros((1, 3, 32, 32), onp.float32)))
    init = _params(jnet)
    jtr, want_l = _ref_loop(jnet, jax_loss.SoftmaxCrossEntropyLoss(),
                            RESNET_X, RESNET_Y, "sgd", RESNET_SGD)
    want_p, want_s = _params(jnet), {i: s[0] for i, s in
                                     _ref_states(jtr).items()}
    got_l, got_p, got_s = _port_resnet(init)
    f64_l, f64_p, f64_s = _port_resnet(init, "float64")
    onp.testing.assert_allclose(got_l[0], want_l[0], rtol=1e-5)
    onp.testing.assert_allclose(got_l, want_l, rtol=1e-2)
    onp.testing.assert_allclose(got_l, f64_l, rtol=1e-4)
    assert got_l[-1] < got_l[0]
    _l2_within(got_p, want_p, f64_p, 1e-3)
    _l2_close(got_p, f64_p, 3e-4)
    assert sorted(got_s) == sorted(want_s)
    _l2_within(got_s, want_s, f64_s, 1e-3)
    _l2_close(got_s, f64_s, 3e-4)
    moved = [k for k in want_p if k.endswith("running_mean")
             and not onp.array_equal(got_p[k], init[k])]
    assert len(moved) == 19                    # every BatchNorm's
