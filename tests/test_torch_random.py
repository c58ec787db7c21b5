"""``mx.random`` and Dropout in the port against the reference, on the CPU.

JAX's threefry and torch's generators give different streams, so the
samplers are held to the reference's distributions, not its bits: 10⁵
draws of each package, the means and the variances within 5σ of each
other (σ of a mean from both samples' variances, of a variance from
their fourth central moments).  Dropout is held to what it must do: the
identity outside training, survivors scaled by exactly ``1/(1-p)``, the
kept fraction within 5σ of ``1-p``, one mask along ``axes``, a seed
that repeats a mask and a next call that does not, the gradient zero
where the mask is.  The trainer's randomness: a captured step (on the
CPU, the function a graph holds, run uncaptured) bitwise equal to
``_step_eager`` from the same generator state, a fresh mask every step
(and every step of ``run_steps``), remat handed the forward's own masks,
``mx.random.seed`` repeating a run, a checkpoint resuming the stream,
the whole-step capture of the eager Gluon loop bitwise equal to the
uncaptured loop, and a dp mesh on gloo ranks dropping what one device
would.
"""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.imperative import cached_step
from mxnet_tpu_torch.ops import random as prng
from mxnet_tpu_torch.parallel import SPMDTrainer

import torch_dist_cases as cases

N = 100_000

# name -> (function name, positional args, keyword args), the same call
# in both packages' mx.nd.random
SAMPLERS = {
    "uniform": ("uniform", (-1.0, 3.0), {}),
    "normal": ("normal", (2.0, 3.0), {}),
    "gamma": ("gamma", (2.5, 1.5), {}),
    "exponential": ("exponential", (2.0,), {}),
    "poisson": ("poisson", (4.0,), {}),
    "negative_binomial": ("negative_binomial", (3, 0.4), {}),
    "generalized_negative_binomial": ("generalized_negative_binomial",
                                      (2.0, 0.5), {}),
    "randint": ("randint", (-3, 7), {}),
    "bernoulli": ("bernoulli", (0.3,), {}),
    "laplace": ("laplace", (1.0, 2.0), {}),
    "rayleigh": ("rayleigh", (2.0,), {}),
    "gumbel": ("gumbel", (1.0, 2.0), {}),
    "logistic": ("logistic", (1.0, 2.0), {}),
}

# per-row samplers: (op name, parameter rows)
ROW_SAMPLERS = {
    "_sample_uniform": ([-1.0, 2.0], [1.0, 5.0]),
    "_sample_normal": ([0.0, 10.0], [1.0, 3.0]),
    "_sample_gamma": ([1.5, 4.0], [2.0, 0.5]),
    "_sample_exponential": ([0.5, 3.0],),
    "_sample_poisson": ([1.0, 6.0],),
    "_sample_negative_binomial": ([2.0, 5.0], [0.3, 0.7]),
    "_sample_generalized_negative_binomial": ([2.0, 4.0], [0.5, 0.2]),
}


def _se_var(x):
    d = x - x.mean()
    return onp.sqrt(max(onp.mean(d ** 4) - onp.mean(d ** 2) ** 2, 0.0)
                    / x.size)


def _moments_agree(got, ref, what):
    got, ref = (onp.asarray(a, onp.float64).reshape(-1) for a in (got, ref))
    assert onp.isfinite(got).all(), what
    se_mean = onp.sqrt(got.var() / got.size + ref.var() / ref.size)
    assert abs(got.mean() - ref.mean()) <= 5 * se_mean + 1e-12, (
        what, got.mean(), ref.mean(), se_mean)
    se_var = onp.hypot(_se_var(got), _se_var(ref))
    assert abs(got.var() - ref.var()) <= 5 * se_var + 1e-12, (
        what, got.var(), ref.var(), se_var)


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_sampler_matches_the_reference_in_distribution(name):
    fn, args, kw = SAMPLERS[name]
    mx.random.seed(1)
    ref = getattr(mx.nd.random, fn)(*args, shape=(N,), **kw).asnumpy()
    mt.random.seed(1)
    got = getattr(mt.nd.random, fn)(*args, shape=(N,), ctx=mt.cpu(), **kw)
    assert got.shape == (N,) and got.dtype == ref.dtype
    _moments_agree(got.asnumpy(), ref, name)


@pytest.mark.parametrize("name", sorted(ROW_SAMPLERS))
def test_row_sampler_matches_the_reference_in_distribution(name):
    rows = [onp.asarray(r, onp.float32) for r in ROW_SAMPLERS[name]]
    ref = onp.asarray(jreg.get(name).fn(
        jax.random.PRNGKey(2), *[jnp.asarray(r) for r in rows],
        shape=(N,)))
    with mt.cpu():
        got = getattr(mt.nd, name)(*[mt.nd.array(r) for r in rows],
                                   shape=(N,)).asnumpy()
    assert got.shape == ref.shape == (2, N)
    for i in range(2):
        _moments_agree(got[i], ref[i], (name, i))


def test_multinomial_frequencies_match_the_reference():
    p = onp.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]], onp.float32)
    ref = mx.nd.random.multinomial(mx.nd.array(p), shape=N).asnumpy()
    with mt.cpu():
        got = mt.nd.random.multinomial(mt.nd.array(p), shape=N).asnumpy()
    assert got.shape == ref.shape == (2, N)
    for i in range(2):
        for c in range(3):
            a, b = (got[i] == c).mean(), (ref[i] == c).mean()
            se = onp.sqrt(p[i, c] * (1 - p[i, c]) * 2 / N)
            assert abs(a - b) <= 5 * se, (i, c, a, b)


def test_shuffle_permutes_rows_and_draws_anew():
    data = onp.arange(64, dtype=onp.float32).reshape(32, 2)
    with mt.cpu():
        x = mt.nd.array(data)
        a = mt.nd.random.shuffle(x).asnumpy()
        b = mt.random.shuffle(x).asnumpy()
    for out in (a, b):
        assert sorted(map(tuple, out)) == sorted(map(tuple, data))
        assert (out[:, 1] - out[:, 0] == 1).all()
    assert not onp.array_equal(a, b) and not onp.array_equal(a, data)


def test_seed_repeats_draws_and_another_seed_does_not():
    with mt.cpu():
        mt.random.seed(7)
        a = mt.random.uniform(shape=(16,)).asnumpy()
        b = mt.random.normal(shape=(16,)).asnumpy()
        mt.random.seed(7)
        assert onp.array_equal(mt.nd.random.uniform(shape=(16,)).asnumpy(), a)
        assert onp.array_equal(mt.nd.random.normal(shape=(16,)).asnumpy(), b)
        mt.random.seed(8)
        assert not onp.array_equal(mt.random.uniform(shape=(16,)).asnumpy(),
                                   a)
        assert mt.random.rand(3, 4).shape == (3, 4)
        assert mt.nd.random.randn(2, 5).shape == (2, 5)
        assert mt.random.uniform(shape=(4,), dtype="float16").dtype == \
            onp.float16


def test_state_bits_round_trip_and_a_foreign_key_seeds_alike():
    with mt.cpu():
        mt.random.seed(3)
        mt.random.uniform(shape=(5,))
        bits = mt.random.get_state_bits()
        assert bits.dtype == onp.uint32
        a = mt.random.uniform(shape=(8,)).asnumpy()
        mt.random.set_state_bits(bits)
        assert onp.array_equal(mt.random.uniform(shape=(8,)).asnumpy(), a)
        # the reference's two-word key: a deterministic seed, not a state
        key = onp.asarray(mx.random.current_key())
        mt.random.set_state_bits(key)
        c = mt.random.uniform(shape=(8,)).asnumpy()
        mt.random.set_state_bits(key.tolist())
        assert onp.array_equal(mt.random.uniform(shape=(8,)).asnumpy(), c)
        assert len(prng.key_words()) == 2


def test_seed_of_one_device_leaves_the_others():
    mt.random.seed(4)
    host = prng.generator("cpu").get_state()
    mt.random.seed(9, ctx=mt.cpu())
    assert not torch.equal(prng.generator("cpu").get_state(), host)
    mt.random.seed(4, ctx=mt.cpu())
    assert torch.equal(prng.generator("cpu").get_state(), host)


def test_initialize_draws_from_mx_random():
    def weights():
        net = nn.Dense(6, in_units=5)
        net.initialize(ctx=mt.cpu())
        return net.weight._tensor().clone()

    mt.random.seed(21)
    a, b = weights(), weights()
    mt.random.seed(21)
    assert torch.equal(weights(), a)
    assert not torch.equal(a, b)
    mt.random.seed(22)
    assert not torch.equal(weights(), a)


# -- Dropout -------------------------------------------------------------------

def _x(shape=(64, 512), seed=0):
    return onp.random.RandomState(seed).uniform(0.5, 1.5, shape).astype(
        onp.float32)


def test_dropout_is_the_identity_outside_training():
    with mt.cpu():
        x = mt.nd.array(_x())
        assert onp.array_equal(mt.nd.Dropout(x, p=0.5).asnumpy(),
                               x.asnumpy())
        layer = nn.Dropout(0.5)
        assert torch.equal(layer(x._data), x._data)
        with mt.autograd.record(train_mode=False):
            assert onp.array_equal(mt.nd.Dropout(x, 0.5).asnumpy(),
                                   x.asnumpy())
    # the reference's rule too
    jx = mx.nd.array(_x())
    assert onp.array_equal(mx.nd.Dropout(jx, p=0.5).asnumpy(), _x())


@pytest.mark.parametrize("p", [0.1, 0.5, 0.8])
def test_dropout_scales_survivors_and_keeps_one_minus_p(p):
    x = _x()
    with mt.cpu():
        out = mt.nd.Dropout(mt.nd.array(x), p, "always").asnumpy()
    kept = out != 0
    assert onp.array_equal(out[kept], (torch.from_numpy(x) / (1 - p))
                           .numpy()[kept])
    se = onp.sqrt(p * (1 - p) / x.size)
    assert abs(kept.mean() - (1 - p)) <= 5 * se, kept.mean()
    # the reference's kept fraction, by the same bound
    jout = mx.nd.Dropout(mx.nd.array(x), p, "always").asnumpy()
    assert abs((jout != 0).mean() - (1 - p)) <= 5 * se


def test_dropout_axes_share_the_mask():
    x = _x((8, 16, 32))
    with mt.cpu():
        for axes in [(1,), (0, 2), (-1,)]:
            out = mt.nd.Dropout(mt.nd.array(x), p=0.5, mode="always",
                                axes=axes).asnumpy()
            kept = out != 0
            for ax in axes:
                assert (kept == kept.take([0], axis=ax)).all(), axes
            jout = mx.nd.Dropout(mx.nd.array(x), p=0.5, mode="always",
                                 axes=axes).asnumpy()
            assert ((jout != 0) == (jout != 0).take([0], axis=axes[0])).all()
        with mt.autograd.record():
            y = nn.Dropout(0.5, axes=(1,))(mt.nd.array(x))
        assert ((y.asnumpy() != 0) == (y.asnumpy()[:, :1] != 0)).all()


def test_dropout_seed_repeats_the_mask_and_the_next_call_differs():
    with mt.cpu():
        x = mt.nd.array(_x())
        mt.random.seed(5)
        a = mt.nd.Dropout(x, 0.5, "always").asnumpy()
        b = mt.nd.Dropout(x, 0.5, "always").asnumpy()
        mt.random.seed(5)
        assert onp.array_equal(mt.nd.Dropout(x, 0.5, "always").asnumpy(), a)
        assert not onp.array_equal(a, b)


def test_dropout_gradient_is_zero_where_the_mask_is():
    with mt.cpu():
        x = mt.nd.array(_x())
        x.attach_grad()
        with mt.autograd.record():
            y = mt.nd.Dropout(x, p=0.25)
        y.backward(mt.nd.ones(x.shape))
    kept = y.asnumpy() != 0
    g = x.grad.asnumpy()
    assert (g[~kept] == 0).all()
    assert onp.array_equal(g[kept], onp.full(kept.sum(), 1 / 0.75,
                                             onp.float32))


def test_dropout_refuses_an_explicit_key():
    with mt.cpu():
        x = mt.nd.array(_x((4, 4)))
        with pytest.raises(mt.MXNetError):
            mt.nd.Dropout(x, mt.nd.array([0, 1]), 0.5)


# -- the trainer's randomness ----------------------------------------------------

def _batch(seed=0, n=8):
    r = onp.random.RandomState(seed)
    return (torch.from_numpy(r.standard_normal((n, 16)).astype(onp.float32)),
            torch.from_numpy(r.randint(0, 4, (n,)).astype(onp.float32)))


def _net():
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=16), nn.Dropout(0.5),
            nn.Dense(32, activation="relu", in_units=32), nn.Dropout(0.3),
            nn.Dense(4, in_units=32))
    mt.random.seed(0)
    net.initialize(device="cpu")
    return net


def _trainer(lr=0.1, **kw):
    return SPMDTrainer(_net(), gloss.SoftmaxCrossEntropyLoss(),
                       optimizer="sgd", optimizer_params={
                           "learning_rate": lr, "momentum": 0.9},
                       device="cpu", **kw)


def _state(tr):
    out = {k: p._tensor().clone() for k, p in tr._params.items()}
    out.update({k + ":mom": s[0].clone() for k, s in tr._opt_state.items()
                if s})
    return out


def _run(mode, steps=4, seed=5, **kw):
    x, y = _batch()
    tr = _trainer(**kw)
    mt.random.seed(seed)
    if mode == "step":
        losses = [float(tr.step(x, y)) for _ in range(steps)]
    elif mode == "eager":
        losses = [float(tr._step_eager(x, y)) for _ in range(steps)]
    else:
        losses = tr.run_steps(x, y, steps).asnumpy().tolist()
    return losses, _state(tr)


def _same(a, b):
    assert a[0] == b[0]
    assert set(a[1]) == set(b[1])
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


@pytest.mark.parametrize("mode", ["eager", "window", "remat"])
def test_captured_steps_equal_eager_steps_from_the_same_state(mode):
    """``step`` against ``_step_eager``, a ``run_steps`` window and a
    remat trainer (handed the forward's own masks), bitwise: losses,
    masters and momenta."""
    want = _run("step")
    got = _run("step", remat=True) if mode == "remat" else _run(mode)
    _same(got, want)


def test_every_step_draws_a_fresh_mask():
    """At lr 0 the weights never move, so only the masks part two steps'
    losses: each ``step`` and each step of a window differ."""
    x, y = _batch()
    tr = _trainer(lr=0.0)
    steps = [float(tr.step(x, y)) for _ in range(3)]
    window = tr.run_steps(x, y, 3).asnumpy().tolist()
    assert len(set(steps + window)) == 6
    # and predict, in eval mode, draws none
    a, b = tr.predict(x).asnumpy(), tr.predict(x).asnumpy()
    assert onp.array_equal(a, b)


def test_seed_repeats_a_run_and_another_seed_does_not():
    a = _run("step", steps=3, seed=11)
    _same(_run("step", steps=3, seed=11), a)
    assert _run("step", steps=3, seed=12)[0] != a[0]


def test_micro_batches_draw_each_micro_batch_its_own_mask():
    x, y = _batch(n=8)
    tr = _trainer(micro_batches=2)
    mt.random.seed(1)
    losses = [float(tr.step(x, y)) for _ in range(3)]
    assert onp.isfinite(losses).all()
    tr2 = _trainer(micro_batches=2)
    mt.random.seed(1)
    assert [float(tr2._step_eager(x, y)) for _ in range(3)] == losses


def test_checkpoint_resumes_the_stream(tmp_path):
    """Save after 2 steps, take a third; load and take it again: the
    same mask, so the same loss, masters and momenta bit for bit."""
    x, y = _batch()
    tr = _trainer()
    mt.random.seed(6)
    for _ in range(2):
        tr.step(x, y)
    tr.save_checkpoint(tmp_path / "ck")
    third = float(tr.step(x, y))
    after = _state(tr)
    mt.random.seed(99)                  # a stream the load must undo
    tr.load_checkpoint(tmp_path / "ck")
    assert float(tr.step(x, y)) == third
    for k, t in _state(tr).items():
        assert torch.equal(t, after[k]), k


def _gluon_run(monkeypatch, env, steps=4):
    monkeypatch.setenv("MXNET_CACHED_STEP", env)
    net = _net()
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=None)
    x, y = (mt.nd.array(a.numpy(), ctx=mt.cpu()) for a in _batch())
    loss_fn = gloss.SoftmaxCrossEntropyLoss()
    mt.random.seed(3)
    losses = []
    for _ in range(steps):
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        tr.step(8)
        losses.append(loss.asnumpy().sum())
    return ({k: p.data().asnumpy() for k, p in net.collect_params().items()},
            losses, cached_step.trainer_state(tr))


def test_cached_step_replays_equal_the_eager_loop(monkeypatch):
    got, got_l, state = _gluon_run(monkeypatch, "1")
    assert state["captures"] == 1 and state["breaks"] == 0
    want, want_l, _ = _gluon_run(monkeypatch, "0")
    assert got_l == want_l
    for k in want:
        assert onp.array_equal(got[k], want[k]), k


# -- a dp mesh on gloo ranks ----------------------------------------------------

WORLD = 2
LAYERS = [("Dense", (32,), {"activation": "relu", "in_units": 16}),
          ("Dropout", (0.5,), {}), ("Dense", (4,), {"in_units": 32})]
SGD = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = cases.RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _weights():
    net = cases.layer_net(nn, LAYERS)
    mt.random.seed(0)
    net.initialize(device="cpu")
    return {k: p._tensor().detach().numpy().copy()
            for k, p in net.collect_params().items()}


def _unmeshed(weights, batches):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return cases.case_dropout_train(LAYERS, weights, None, batches, SGD,
                                        4)
    finally:
        torch.set_num_threads(threads)


def test_dp_ranks_drop_what_one_device_would(pool):
    """dp 2: each rank draws the whole batch's mask and keeps its rows,
    so the meshed steps are the unmeshed steps (fp32 rtol 1e-5: only the
    gradient's sum over ranks is in another order); at dp 1 bit for
    bit."""
    weights = _weights()
    batches = [tuple(a.numpy() for a in _batch(s)) for s in range(3)]
    want = _unmeshed(weights, batches)
    two = [r for r in pool.run("case_dropout_train", LAYERS, weights,
                               {"dp": 2}, batches, SGD, 4) if r is not None]
    assert len(two) == 2
    for losses, params in two:
        onp.testing.assert_allclose(losses, want[0], rtol=1e-5)
        for k in want[1]:
            onp.testing.assert_allclose(params[k], want[1][k], rtol=1e-5,
                                        atol=1e-6, err_msg=k)
    one = pool.run("case_dropout_train", LAYERS, weights, {"dp": 1},
                   batches, SGD, 4)[0]
    assert one[0] == want[0]
    for k in want[1]:
        onp.testing.assert_array_equal(one[1][k], want[1][k])
