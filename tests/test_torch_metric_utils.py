"""``gluon.metric`` and ``gluon.utils`` of the port against the
reference's, on the CPU with the same numpy inputs: every metric's
``get()`` after two updates (rtol 1e-6; both read numpy on the host),
``create`` / ``register`` / ``np`` / composites, and ``split_data``,
``split_and_load``, ``clip_global_norm`` (norm and clipped arrays at rtol
1e-6), ``check_sha1`` and ``shape_is_known`` (exact).  ``download`` is
not called: no test touches the network.
"""
import hashlib

import numpy as onp
import pytest

import mxnet_tpu as ref
from mxnet_tpu.gluon import metric as rm
from mxnet_tpu.gluon import utils as ru

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import metric as pm
from mxnet_tpu_torch.gluon import utils as pu


def _pnd(a):
    return mt.nd.array(a, ctx=mt.cpu(), dtype=a.dtype)


def _inputs(kind, seed):
    rng = onp.random.RandomState(seed)
    if kind == "class":
        logits = rng.rand(12, 4).astype(onp.float32)
        return rng.randint(0, 4, 12).astype(onp.float32), \
            logits / logits.sum(-1, keepdims=True)
    if kind == "binary":
        return rng.randint(0, 2, 16).astype(onp.float32), \
            rng.rand(16, 2).astype(onp.float32)
    if kind == "prob":
        return rng.randint(0, 2, 10).astype(onp.float32), \
            rng.rand(10).astype(onp.float32)
    return rng.rand(8, 3).astype(onp.float32), \
        rng.rand(8, 3).astype(onp.float32)


METRICS = [
    ("Accuracy", {}, "class"), ("TopKAccuracy", {"top_k": 2}, "class"),
    ("F1", {}, "binary"), ("Fbeta", {"beta": 2.0}, "binary"),
    ("MCC", {}, "binary"), ("PCC", {}, "class"),
    ("MAE", {}, "reg"), ("MSE", {}, "reg"), ("RMSE", {}, "reg"),
    ("CrossEntropy", {}, "class"), ("NegativeLogLikelihood", {}, "class"),
    ("Perplexity", {"ignore_label": 1}, "class"),
    ("PearsonCorrelation", {}, "reg"), ("BinaryAccuracy", {}, "prob"),
    ("MeanPairwiseDistance", {}, "reg"),
    ("MeanCosineSimilarity", {}, "reg"), ("Loss", {}, "reg"),
]


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=[m[0] for m in METRICS])
def test_metric_matches(name, kw, kind):
    p, r = getattr(pm, name)(**kw), getattr(rm, name)(**kw)
    for seed in (0, 1):
        label, pred = _inputs(kind, seed)
        p.update([_pnd(label)], [_pnd(pred)])
        r.update([ref.nd.array(label)], [ref.nd.array(pred)])
    (pn, pv), (rn, rv) = p.get(), r.get()
    assert pn == rn
    onp.testing.assert_allclose(pv, rv, rtol=1e-6)
    p.reset()
    assert onp.isnan(p.get()[1]) or name in ("F1", "Fbeta", "MCC", "PCC")


def test_create_register_composite_and_np():
    for spec in ("acc", "ce", "top_k_accuracy", "pearsonr", "torch",
                 ["mse", "mae"]):
        p, r = pm.create(spec), rm.create(spec)
        assert type(p).__name__ == type(r).__name__
    label, pred = _inputs("class", 3)

    def feval(l, p_):
        return float((p_.argmax(-1) == l).mean())
    p, r = pm.np(feval), rm.np(feval)
    p.update([_pnd(label)], [_pnd(pred)])
    r.update([ref.nd.array(label)], [ref.nd.array(pred)])
    assert p.get() == r.get()
    p, r = pm.create(["acc", "ce"]), rm.create(["acc", "ce"])
    p.update([_pnd(label)], [_pnd(pred)])
    r.update([ref.nd.array(label)], [ref.nd.array(pred)])
    assert p.get()[0] == r.get()[0]
    onp.testing.assert_allclose(p.get()[1], r.get()[1], rtol=1e-6)
    assert p.get_name_value()[0][0] == "accuracy"

    @pm.register
    class TwiceAcc(pm.Accuracy):
        pass
    assert isinstance(pm.create("twiceacc"), TwiceAcc)
    with pytest.raises(mt.MXNetError, match="unknown metric"):
        pm.create("no-such-metric")


def test_split_data_and_split_and_load():
    x = onp.arange(30, dtype=onp.float32).reshape(10, 3)
    for n, even in ((2, True), (3, False), (1, True)):
        got = pu.split_data(_pnd(x), n, even_split=even)
        want = ru.split_data(ref.nd.array(x), n, even_split=even)
        assert [g.asnumpy().tolist() for g in got] == \
            [w.asnumpy().tolist() for w in want]
    with pytest.raises(ValueError, match="evenly split"):
        pu.split_data(_pnd(x), 3)
    got = pu.split_and_load(x, [mt.cpu(), "cpu"], batch_axis=0)
    assert [g._data.device.type for g in got] == ["cpu", "cpu"]
    onp.testing.assert_array_equal(
        onp.concatenate([g.asnumpy() for g in got]), x)
    got1 = pu.split_and_load(x.T.copy(), [mt.cpu()], batch_axis=1)
    onp.testing.assert_array_equal(got1[0].asnumpy(), x.T)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_global_norm_matches(max_norm):
    rng = onp.random.RandomState(7)
    arrays = [rng.randn(4, 5).astype(onp.float32),
              rng.randn(7).astype(onp.float32)]
    p = [_pnd(a) for a in arrays]
    r = [ref.nd.array(a) for a in arrays]
    pn, rn = pu.clip_global_norm(p, max_norm), ru.clip_global_norm(r,
                                                                    max_norm)
    onp.testing.assert_allclose(pn, rn, rtol=1e-6)
    for a, b in zip(p, r):
        onp.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-6)
    with pytest.warns(UserWarning, match="nan or inf"):
        pu.clip_global_norm([_pnd(onp.array([onp.inf], onp.float32))], 1.0)
    with pytest.raises(ValueError):
        pu.clip_global_norm([], 1.0)


def test_sha1_and_shape_is_known(tmp_path):
    f = tmp_path / "blob"
    f.write_bytes(b"tpu-mx" * 1000)
    good = hashlib.sha1(f.read_bytes()).hexdigest()
    assert pu.check_sha1(str(f), good) == ru.check_sha1(str(f), good)
    assert pu.check_sha1(str(f), good)
    assert not pu.check_sha1(str(f), "0" * 40)
    for shape in (None, (2, 3), (2, -1), (0, 4), (None, 2)):
        assert pu.shape_is_known(shape) == ru.shape_is_known(shape)
    # download returns a file already present with a matching hash,
    # without a request
    assert pu.download("http://example.invalid/blob", path=str(f),
                       sha1_hash=good) == str(f)
    assert pu.HookHandle is not None
