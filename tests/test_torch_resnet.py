"""Training ResNet through the port's ``SPMDTrainer`` against the
reference on the CPU, on the same weights (carried across by
``convert.load_collected_params``, running statistics included) and the
same numpy batches: three SGD steps (lr 0.005, momentum 0.9, wd 1e-4) of
ResNet-18 v1 thumbnail (classes 10) on a (4, 3, 16, 16) batch with float
labels, comparing the losses, every master (every BatchNorm's running
statistics, written once a step from the compute-dtype copies) and
every momentum:

* plain, in fp32 and in bf16;
* ``micro_batches=2`` on 8 images (the last micro-batch's statistics
  kept), so that each micro-batch's BatchNorm sees the 4 images a plain
  step sees;
* ``remat``: the port's plain step, bitwise (against the reference's,
  with the rest of the ResNet path, in ``test_torch_resnet_variants.py``,
  which imports this file's helpers);
* ``run_steps(…, 2)``: two ``step`` calls bitwise, statistics included.

Tolerances and why:

* fp32: losses rtol 1e-4; each master and momentum within 3e-4 of its
  norm in L2 (measured: 2e-5 and 6e-5).  Not elementwise: a channel
  whose batch variance is near zero amplifies rounding in BatchNorm's
  backward, so one step's momentum can differ by ~1% of its largest
  element in that channel alone (seen at other seeds);
* ``micro_batches=2``: 1e-2 in L2 (measured: up to 2.4e-3): two
  backward passes a step on half the batch let that amplification grow
  further in three steps.  A fault of the aux channel moves them far
  more: the first micro-batch's statistics kept instead of the last's
  put the running means ~80% of their norm apart;
* bf16: losses 2e-2 of the largest loss; a master or momentum may lie
  no farther from the reference's bf16 value (in L2) than twice the
  reference's own bf16 value lies from its fp32 one, plus 2e-2 of its
  norm.  Why not 2e-2 alone: in bf16 this net's gradients carry
  rounding noise of the order of the update itself (the reference's bf16
  masters lie 40–65% of a step's movement from its fp32 ones after one
  step), and the port's bf16 noise is of the same size, not the same
  bits;
* the learning rate: at 0.05 (bench.py's) a third step of a few images
  amplifies f32 rounding differences chaotically (ResNet-50 thumbnail
  on 8 images: the two packages' fp32 third losses 17% apart), which no
  tolerance separates from a fault; at 0.005 three steps stay within
  the bounds above.
"""
import functools

import numpy as onp
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh

from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.parallel import SPMDTrainer

def _batch(n, seed):
    rng = onp.random.RandomState(seed)
    return (rng.standard_normal((n, 3, 16, 16)).astype(onp.float32),
            rng.randint(0, 10, size=(n,)).astype(onp.float32))


X, Y = _batch(4, 0)
# images -> (data, float labels)
BATCHES = {4: (X, Y), 8: _batch(8, 9)}
SGD = dict(optimizer="sgd", optimizer_params={"learning_rate": 0.005,
                                              "momentum": 0.9, "wd": 1e-4})


def _numpy(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _jax_resnet(depth, size, seed):
    mx.random.seed(seed)
    net = jax_vision.get_resnet(1, depth, classes=10, thumbnail=True)
    net.initialize(init=mx.initializer.Xavier())
    net(NDArray(onp.zeros((1, 3, size, size), onp.float32)))
    return net


@functools.lru_cache(maxsize=None)
def _init18():
    return _numpy(_jax_resnet(18, 16, 1))


@functools.lru_cache(maxsize=None)
def _ref_train(dtype=None, remat=False, micro_batches=1, images=4):
    """The reference's 3 steps from ``_init18`` on ``BATCHES[images]``:
    (losses, masters, momenta) as numpy."""
    x, y = BATCHES[images]
    net = jax_vision.get_resnet(1, 18, classes=10, thumbnail=True)
    net.initialize()
    net(NDArray(onp.zeros((1, 3, 16, 16), onp.float32)))
    for k, p in net.collect_params().items():
        p.set_data(_init18()[k])
    tr = JaxTrainer(net, jax_loss.SoftmaxCrossEntropyLoss(),
                    mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]),
                    dtype=dtype, remat=remat, micro_batches=micro_batches,
                    **SGD)
    losses = [float(tr.step(NDArray(x), NDArray(y)).asnumpy())
              for _ in range(3)]
    moms = {k: onp.asarray(s[0]._data if hasattr(s[0], "_data") else s[0])
            for k, s in tr._opt_state.items() if s}
    return losses, _numpy(net), moms


def _port_net18():
    net = vision.get_resnet(1, 18, classes=10, thumbnail=True)
    convert.load_collected_params(net, _init18(), device="cpu")
    return net


def _port_train(dtype=None, images=4, **kw):
    x, y = (torch.from_numpy(a) for a in BATCHES[images])
    net = _port_net18()
    tr = SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), device="cpu",
                     dtype=dtype, **SGD, **kw)
    losses = [float(tr.step(x, y)) for _ in range(3)]
    moms = {k: s[0].float().numpy() for k, s in tr._opt_state.items() if s}
    return losses, convert.collected_params_to_numpy(net), moms


def _assert_state_close(got, want, tol):
    """Each tensor within ``tol`` of its norm, in L2."""
    assert set(got) == set(want)
    for k in want:
        err = onp.linalg.norm(got[k] - want[k])
        assert err <= tol * onp.linalg.norm(want[k]), (
            k, err / onp.linalg.norm(want[k]))


def _assert_steps_match(kw, loss_rtol, state_tol):
    """The port's 3 steps against the reference's: losses, masters
    (every BatchNorm's running statistics moved) and momenta."""
    want_l, want_p, want_m = _ref_train(**kw)
    got_l, got_p, got_m = _port_train(**kw)
    onp.testing.assert_allclose(got_l, want_l, rtol=loss_rtol)
    assert got_l[-1] < got_l[0]
    _assert_state_close(got_p, want_p, state_tol)
    _assert_state_close(got_m, want_m, state_tol)
    moved = [k for k in want_p if k.endswith(("running_mean", "running_var"))
             and not onp.array_equal(want_p[k], _init18()[k])]
    assert len(moved) == 2 * 19          # every BatchNorm's statistics


def test_resnet18_sgd_steps_fp32():
    _assert_steps_match({}, 1e-4, 3e-4)


def test_resnet18_sgd_steps_bf16():
    want_l, want_p, want_m = _ref_train("bfloat16")
    _, f32_p, f32_m = _ref_train()
    got_l, got_p, got_m = _port_train("bfloat16")
    scale = max(abs(v) for v in want_l)
    assert all(abs(a - b) <= 2e-2 * scale for a, b in zip(got_l, want_l)), (
        got_l, want_l)
    for got, want, f32 in ((got_p, want_p, f32_p), (got_m, want_m, f32_m)):
        assert set(got) == set(want)
        for k in want:
            apart = onp.linalg.norm(got[k] - want[k])
            noise = onp.linalg.norm(want[k] - f32[k])
            assert apart <= 2 * noise + 2e-2 * onp.linalg.norm(want[k]), (
                k, apart, noise)


def test_remat_is_the_plain_step_bitwise():
    plain = _port_train()
    remat = _port_train(remat=True)
    assert plain[0] == remat[0]
    for a, b in zip(plain[1:], remat[1:]):
        for k in a:
            assert onp.array_equal(a[k], b[k]), k


def test_micro_batches_match_reference():
    """On 8 images, so that each micro-batch's BatchNorm sees the 4
    images a plain step sees; 1e-2 in L2 (see the module's note)."""
    _assert_steps_match({"micro_batches": 2, "images": 8}, 1e-4, 1e-2)


def test_run_steps_writes_the_statistics_every_step():
    """``run_steps(x, y, 2)`` is two ``step`` calls, bit for bit, the
    running statistics included (each step writes them once)."""
    x, y = (torch.from_numpy(a) for a in BATCHES[4])
    trainers = [SPMDTrainer(_port_net18(), gloss.SoftmaxCrossEntropyLoss(),
                            device="cpu", **SGD) for _ in range(3)]
    one, two, window = trainers
    one.step(x, y)
    losses = [float(two.step(x, y)), float(two.step(x, y))]
    assert window.run_steps(x, y, 2)._data.tolist() == losses
    assert window.num_update == two.num_update == 2
    for k in two._pkeys:
        a, b = two._params[k]._tensor(), window._params[k]._tensor()
        assert torch.equal(a, b), k
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(a, one._params[k]._tensor()), k
        if two._opt_state[k]:
            assert torch.equal(two._opt_state[k][0],
                               window._opt_state[k][0]), k
