"""Served rows of the port's batch serving against the reference's
(``mxnet_tpu/serving/``) on the CPU: the same weights in both packages
(``convert.load_collected_params``), the same numpy requests through
each package's ``DynamicBatcher`` → ``InferenceEngine`` (the reference
compiles its buckets on the CPU, its flash kernel in interpret mode; the
port runs each bucket's forward on its static input).

Tolerances and why:
* an MLP's rows: rtol 1e-5 / atol 1e-6 (f32, GEMMs summed in another
  order);
* a 2-layer TransformerLM (vocab 64, units 32, 2 heads) scoring
  variable-length prompts through ``seq_axes=(0,)``: 1e-4 of each row's
  largest logit (f32 through two layers and the flash forward);
* on the port alone, each bucket's rows bitwise equal to the eager
  forward of the same padded batch.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM
from mxnet_tpu.serving import DynamicBatcher as JaxBatcher
from mxnet_tpu.serving import InferenceEngine as JaxEngine

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert, telemetry
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
from mxnet_tpu_torch.serving import DynamicBatcher, InferenceEngine

UNITS = 16
VOCAB = 64
LM = dict(units=32, num_layers=2, num_heads=2, max_len=64, tie_weights=True)
LENGTHS = (5, 7, 13)          # seq buckets 8, 8, 16


def _params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _serve(batcher, examples):
    futs = [batcher.submit(x) for x in examples]
    batcher.flush()
    return [f.result(0) for f in futs]


def _mlp_pair():
    mx.random.seed(7)
    ref = jax_nn.Sequential()
    ref.add(jax_nn.Dense(32, in_units=UNITS, activation="relu"),
            jax_nn.Dense(4, in_units=32))
    ref.initialize()
    got = nn.Sequential()
    got.add(nn.Dense(32, in_units=UNITS, activation="relu"),
            nn.Dense(4, in_units=32))
    got.initialize(device="cpu")
    convert.load_collected_params(got, _params(ref), device="cpu")
    return ref, got


def test_mlp_served_rows_match_the_reference():
    ref, got = _mlp_pair()
    rng = onp.random.RandomState(0)
    xs = [rng.randn(UNITS).astype("float32") for _ in range(7)]
    kw = dict(example_shape=(UNITS,), dtype="float32")
    jb = JaxBatcher(JaxEngine(ref, **kw), max_batch_size=4, start=False)
    pb = DynamicBatcher(InferenceEngine(got, **kw), max_batch_size=4,
                        start=False)
    want, have = _serve(jb, xs), _serve(pb, xs)      # batches of 4 and 3
    assert pb.engine.buckets() == jb.engine.buckets() == \
        [f"4x{UNITS}:float32"]
    for h, w in zip(have, want):
        assert h.dtype == onp.float32 and h.shape == w.shape
        onp.testing.assert_allclose(h, onp.asarray(w), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def lm_pair():
    ref = JaxLM(VOCAB, **LM)
    ref.initialize(init=mx.initializer.Xavier())
    ref(mx.nd.array(onp.zeros((1, 8), onp.int32)))
    got = TransformerLM(VOCAB, **LM)
    got.initialize(device="cpu")
    with torch.no_grad():
        got(torch.zeros((1, 8), dtype=torch.int32))
    convert.load_collected_params(got, _params(ref), device="cpu")
    return ref, got


def _prompts():
    rng = onp.random.RandomState(1)
    return [rng.randint(0, VOCAB, size=n).astype(onp.int32)
            for n in LENGTHS]


def _lm_engine(cls, net):
    return cls(net, example_shape=(None,), dtype="int32", seq_axes=(0,))


def test_lm_scoring_through_seq_buckets_matches_the_reference(lm_pair):
    """Prompts of 5, 7 and 13 tokens pad to 8, 8 and 16: two buckets,
    (2, 8) and (1, 16), in both packages, and the rows agree."""
    ref, got = lm_pair
    xs = _prompts()
    jb = JaxBatcher(_lm_engine(JaxEngine, ref), start=False)
    pb = DynamicBatcher(_lm_engine(InferenceEngine, got), start=False)
    want, have = _serve(jb, xs), _serve(pb, xs)
    assert pb.engine.buckets() == jb.engine.buckets() == \
        ["1x16:int32", "2x8:int32"]
    for x, h, w in zip(xs, have, want):
        w = onp.asarray(w)
        assert h.shape == w.shape == (1 << (len(x) - 1).bit_length(),
                                      VOCAB)
        scale = float(onp.abs(w).max())
        onp.testing.assert_allclose(h, w, rtol=0, atol=1e-4 * scale)


def test_lm_bucket_rows_equal_the_ports_eager_forward(lm_pair):
    """A replayed bucket (here: its forward on the static input) gives
    the rows of the eager forward of the same padded batch, bitwise, and
    a request's unpadded prefix those of its own unpadded forward within
    1e-5 (the causal mask keeps the padding out of earlier positions)."""
    _, got = lm_pair
    eng = _lm_engine(InferenceEngine, got)
    xs = [eng.pad_example(eng.validate(x))[0] for x in _prompts()[:2]]
    c0 = telemetry.counter("compile.serving.count").value
    results, meta = eng.infer_batch(xs)
    assert meta["compiled"] and meta["bucket"] == "2x8:int32"
    assert telemetry.counter("compile.serving.count").value - c0 == 1
    with mt.autograd.pause():
        same = got(mt.nd.array(onp.stack(xs), ctx=mt.cpu(),
                               dtype="int32")).asnumpy()
    for i, r in enumerate(results):
        onp.testing.assert_array_equal(r, same[i])
    for x, r in zip(_prompts()[:2], results):
        with torch.no_grad():
            alone = got(torch.from_numpy(x[None])).numpy()[0]
        onp.testing.assert_allclose(r[:len(x)], alone, rtol=0,
                                    atol=1e-5 * float(onp.abs(alone).max()))
