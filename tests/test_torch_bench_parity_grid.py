"""The port's counterpart of ``tests/test_bench_parity_grid.py``: every
model of bench.py's parity grids (the single source of truth,
``bench.py:81-90``) builds through the port's ``get_model`` and gives
``(1, 1000)`` at the reference test's toy sizes, and every name of the
reference's ``get_model`` resolves in the port's."""
import numpy as onp
import pytest
import torch

from mxnet_tpu.gluon.model_zoo import vision as jvision

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo import vision

import bench

# the reference test's sizes (tests/test_bench_parity_grid.py:15-16)
TOY_HW = {"resnet152_v1": 32, "vgg16": 32, "alexnet": 32,
          "inceptionv3": 299}
GRID = sorted({g[0] for g in bench.TRAIN_PARITY_GRID}
              | {g[0] for g in bench.INFER_PARITY_GRID})


@pytest.mark.parametrize("name", GRID)
def test_parity_grid_model_constructs(name):
    hw = TOY_HW.get(name, 224)
    net = vision.get_model(name, classes=1000)
    net.initialize(init=mt.initializer.Xavier(), device="cpu")
    with torch.no_grad():
        out = net(torch.zeros((1, 3, hw, hw)))
    assert tuple(out.shape) == (1, 1000), (name, tuple(out.shape))
    assert onp.isfinite(out.numpy()).all()


def test_every_reference_name_resolves():
    names = sorted(jvision._models)
    assert len(names) >= 34
    for name in names:
        assert callable(vision._models[name]), name
    assert sorted(vision._models) == names
