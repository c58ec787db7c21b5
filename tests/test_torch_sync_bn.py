"""BatchNorm on a batch split over dp against the reference, on the CPU.

The reference's BatchNorm under ``make_mesh({"dp": ...})`` takes the
statistics of the whole batch (GSPMD makes the batch reduction global,
``mxnet_tpu/ops/nn.py:376-398``); the port's sums them over the ranks
(``ops.nn.sync_batch_norm``).  The reference runs on the 8 emulated
devices ``tests/conftest.py`` sets up, the port on 4 spawned gloo ranks
(``torch_dist_cases.RankPool``, one pool for the file).  Both get the
same numpy weights and batches.  Held, at fp32 rtol 1e-5 / atol 1e-6:
the losses of 3 steps (``step`` or one ``run_steps`` window), every
parameter after them and the running statistics, for
the nets of ``tests/test_parallel.py:137-143`` and ``:181-186``
(``remat``), ``micro_batches=2``, ``BatchNormReLU``, ``SyncBatchNorm``
and ``scale=False``; the running statistics bitwise equal on every rank;
at one rank, bitwise equal to the unmeshed trainer; and the folded
reducer (every shard in one process) against the gloo reducer on the
same shards.  bf16 (on ResNet's layout, a convolution without bias):
losses at rtol 2e-2, and each parameter by ``test_torch_resnet.py``'s
rule, no farther from the reference's bf16 value (in L2) than twice the
reference's own bf16 value lies from its fp32 one, plus 2e-2 of its
norm: the gradients of such a net carry bf16 rounding noise of the order
of the update itself, the port's of the same size and not the same
bits.
"""
import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.ndarray import NDArray
from mxnet_tpu.parallel import SPMDTrainer as JTrainer
from mxnet_tpu.parallel import make_mesh as jmesh

import torch_dist_cases as cases

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-6)
SGD = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = cases.RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def conv(bn=("BatchNorm", (), {"in_channels": 4}), relu=True, **conv_kw):
    """``tests/test_parallel.py:137-143``'s net, channels given."""
    return [("Conv2D", (4, 3), {"padding": 1, "in_channels": 2,
                                **conv_kw}), bn] + (
        [("Activation", ("relu",), {})] if relu else []) + [
        ("GlobalAvgPool2D", (), {}), ("Dense", (3,), {"in_units": 4})]


NETS = {
    "conv": conv(),
    # tests/test_parallel.py:181-186, remat's net
    "mlp": [("Dense", (16,), {"activation": "relu", "in_units": 6}),
            ("BatchNorm", (), {"in_channels": 16}),
            ("Dense", (3,), {"in_units": 16})],
    "bnrelu": conv(("BatchNormReLU", (), {"in_channels": 4}), relu=False),
    "sync": conv(("SyncBatchNorm", (), {"in_channels": 4,
                                        "num_devices": 4})),
    "noscale": conv(("BatchNorm", (), {"in_channels": 4, "scale": False})),
    # ResNet's layout, a convolution without bias before the BatchNorm:
    # a bias there has an exact gradient of 0, which bf16 rounding in the
    # reference turns into noise of ~1e-3 a step
    "conv_nobias": conv(use_bias=False),
}


def reference(net_name, seed=0):
    """The reference net (Xavier, seeded) and its weights as numpy."""
    mx.random.seed(seed)
    net = cases.layer_net(jnn, NETS[net_name])
    net.initialize(init=mx.initializer.Xavier())
    shape = (1, 6) if net_name == "mlp" else (1, 2, 8, 8)
    net(NDArray(onp.zeros(shape, onp.float32)))
    return net, {k: p.data().asnumpy()
                 for k, p in net.collect_params().items()}


def data(net_name, steps=3, seed=1):
    rng = onp.random.RandomState(seed)
    shape = (8, 6) if net_name == "mlp" else (8, 2, 8, 8)
    return [(rng.randn(*shape).astype("float32"),
             rng.randint(0, 3, size=(8,)).astype("float32"))
            for _ in range(steps)]


def ref_train(net_name, axes, batches, mode, kw):
    net, weights = reference(net_name)
    tr = JTrainer(net, jloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                  optimizer_params=SGD, mesh=jmesh(axes), **kw)
    if mode == "step":
        losses = [float(tr.step(d, l).asnumpy()) for d, l in batches]
    else:
        losses = list(tr.run_steps(batches[0][0], batches[0][1],
                                   len(batches)).asnumpy())
    params = {k: p.data().asnumpy() for k, p in tr._params.items()}
    return weights, losses, params


BN_CASES = {
    "conv_dp2_step": ("conv", {"dp": 2}, "step", {}),
    "conv_dp4_step": ("conv", {"dp": 4}, "step", {}),
    "conv_dp2_run_steps": ("conv", {"dp": 2}, "run_steps", {}),
    "conv_dp4_run_steps": ("conv", {"dp": 4}, "run_steps", {}),
    "remat_dp2": ("mlp", {"dp": 2}, "step", {"remat": True}),
    "remat_dp4": ("mlp", {"dp": 4}, "step", {"remat": True}),
    "micro_batches2_dp2": ("conv", {"dp": 2}, "step", {"micro_batches": 2}),
    "bnrelu_dp2": ("bnrelu", {"dp": 2}, "step", {}),
    "sync_batchnorm_dp4": ("sync", {"dp": 4}, "step", {}),
    "no_scale_dp2": ("noscale", {"dp": 2}, "step", {}),
    "bf16_dp2": ("conv_nobias", {"dp": 2}, "step", {"dtype": "bfloat16"}),
}


@pytest.mark.parametrize("name", sorted(BN_CASES))
def test_batchnorm_on_a_dp_split_batch_matches_the_reference(pool, name):
    """Losses, parameters and running statistics against the reference;
    the running statistics bitwise equal on every rank."""
    net_name, axes, mode, kw = BN_CASES[name]
    batches = data(net_name)
    weights, want_l, want_p = ref_train(net_name, axes, batches, mode, kw)
    bf16 = kw.get("dtype") == "bfloat16"
    if bf16:
        f32_p = ref_train(net_name, axes, batches, mode, {})[2]
    got = [r for r in pool.run("case_bn_train", NETS[net_name], weights,
                               axes, batches, SGD, mode, kw)
           if r is not None]
    assert len(got) == axes["dp"]
    for losses, params, stats in got:
        onp.testing.assert_allclose(losses, want_l,
                                    **(dict(rtol=2e-2) if bf16 else TOL))
        assert sorted(params) == sorted(want_p)
        for k in want_p:
            if bf16:
                apart = onp.linalg.norm(params[k] - want_p[k])
                noise = onp.linalg.norm(want_p[k] - f32_p[k])
                assert apart <= 2 * noise + 2e-2 * onp.linalg.norm(
                    want_p[k]), (k, apart, noise)
            else:
                onp.testing.assert_allclose(params[k], want_p[k], **TOL,
                                            err_msg=k)
        assert stats == got[0][2]
    # the statistics moved, so the comparison held something
    assert any(not onp.array_equal(got[0][1][k], weights[k])
               for k in got[0][2])


def test_one_rank_is_the_unmeshed_path_bitwise(pool):
    """``make_mesh({"dp": 1})``: the batch is whole, BatchNorm keeps the
    single-device path, and every number equals the unmeshed trainer's
    bit for bit (the unmeshed one in this process, which starts no
    process group, on one thread as the ranks run)."""
    import torch
    batches = data("conv")
    _, weights = reference("conv")
    got = pool.run("case_bn_train", NETS["conv"], weights, {"dp": 1},
                   batches, SGD, "step", {})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = [cases.case_bn_train(NETS["conv"], weights, None, batches,
                                    SGD, "step", {})]
    finally:
        torch.set_num_threads(threads)
    assert got[0][0] == want[0][0]
    for k in want[0][1]:
        onp.testing.assert_array_equal(got[0][1][k], want[0][1][k])
    assert got[0][2] == want[0][2]


@pytest.mark.parametrize("dp", [2, 4])
def test_folded_reducer_equals_the_gloo_reducer(pool, dp):
    """``sync_batch_norm`` with the folded reducer (the shards stacked in
    one process) against the gloo reducer on the same shards: output,
    statistics, dx, and dγ / dβ summed over the ranks."""
    import torch
    from mxnet_tpu_torch.ops.nn import sync_batch_norm
    from mxnet_tpu_torch.parallel.collectives import FoldedReducer
    rng = onp.random.RandomState(3)
    x = rng.randn(dp, 2, 3, 4, 4).astype("float32") * 2 + 0.5
    dy = rng.randn(*x.shape).astype("float32")
    gamma = rng.randn(3).astype("float32")
    beta = rng.randn(3).astype("float32")
    got = [r for r in pool.run("case_bn_reducer", x, gamma, beta, dy,
                               {"dp": dp}) if r is not None]
    assert len(got) == dp
    xt = torch.tensor(x, requires_grad=True)
    g = torch.tensor(gamma, requires_grad=True)
    b = torch.tensor(beta, requires_grad=True)
    out, mean, var = sync_batch_norm(xt, g, b, FoldedReducer(dp), eps=1e-5,
                                     fix_gamma=False)
    dx, dg, db = torch.autograd.grad(out, [xt, g, b], torch.tensor(dy))
    tight = dict(rtol=1e-6, atol=1e-6)
    for i, (o, m, v, gx, gg, gb) in enumerate(got):
        onp.testing.assert_allclose(o, out[i].detach().numpy(), **tight)
        onp.testing.assert_allclose(gx, dx[i].numpy(), **tight)
        onp.testing.assert_allclose(m, mean.numpy(), **tight)
        onp.testing.assert_allclose(v, var.numpy(), **tight)
    onp.testing.assert_allclose(sum(r[4] for r in got), dg.numpy(), **tight)
    onp.testing.assert_allclose(sum(r[5] for r in got), db.numpy(), **tight)


def test_folded_batchnorm_equals_the_unsplit_one():
    """The folded body over 4 shards against the single-device
    ``batch_norm`` on the whole batch (fp32, and f64 as the plain
    version), with the reference's op on the same input."""
    import torch
    from mxnet_tpu.ops.nn import _batch_norm as jbn
    from mxnet_tpu_torch.ops.nn import batch_norm, sync_batch_norm
    from mxnet_tpu_torch.parallel.collectives import FoldedReducer
    rng = onp.random.RandomState(5)
    x = rng.randn(8, 3, 5, 5).astype("float32")
    gamma = rng.randn(3).astype("float32")
    beta = rng.randn(3).astype("float32")
    args = [torch.tensor(a) for a in (gamma, beta)]
    out, mean, var = sync_batch_norm(torch.tensor(x).view(4, 2, 3, 5, 5),
                                     *args, FoldedReducer(4), eps=1e-5,
                                     fix_gamma=False)
    w_out, w_mean, w_var = batch_norm(
        torch.tensor(x), *args, None, None, eps=1e-5, fix_gamma=False,
        use_batch_stats=True)
    j_out, j_mean, j_var = (onp.asarray(a) for a in jbn(
        x, gamma, beta, onp.zeros(3, "float32"), onp.ones(3, "float32"),
        eps=1e-5, fix_gamma=False, use_batch_stats=True))
    for a, b, c in ((out.reshape(8, 3, 5, 5), w_out, j_out),
                    (mean, w_mean, j_mean), (var, w_var, j_var)):
        onp.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        onp.testing.assert_allclose(a.numpy(), c, **TOL)
