"""The device-feed pipeline (``data.DevicePrefetcher``) and its consumers
on the CPU, mirroring the reference's ``tests/test_data_pipeline.py``
contracts with the same numpy inputs:

* ``MXNET_DEVICE_PREFETCH`` sets the depth; depth 0 returns the source
  itself; a wrapped loader gives the bare loader's batches bitwise, in
  order, epoch after epoch;
* an error in the source is raised at the consumer; ``close()`` and a
  consumer that breaks off leave no producer thread (each wait bounded);
* window staging stacks ``n`` batches for ``run_steps(per_step_data=
  True)``, drops a partial window, and ``fast_forward`` skips windows;
  the reference's windows hold the same values;
* ``SPMDTrainer`` fed through the prefetcher trains bitwise as the same
  trainer fed host batches, with no ``input.step_h2d``, and step records
  carry ``input_wait_ms`` / ``h2d_bytes``; the reference counts the same
  bytes for numpy batches (exact);
* a ``gluon.Trainer`` loop (the captured step included) fed from
  ``DataLoader(prefetch_to_device=trainer)`` is bitwise the host-fed
  loop; ``InferenceEngine`` takes an NDArray batch as it takes rows;
* with no consumer the pipeline places on ``cuda:0`` and raises where no
  card is visible.

On the CPU the pipeline runs its thread with no stream; the CUDA side
stream, the pinned ring and the overlap are exercised on the card by
``chip_smoke.py``'s ``input_pipeline`` phase.
"""
import gc
import threading
import time

import numpy as onp
import pytest
import torch

from mxnet_tpu import telemetry as ref_tel
from mxnet_tpu.data import wrap as ref_wrap

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd, gluon, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.data import DevicePrefetcher, prefetch_depth, wrap
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
from mxnet_tpu_torch.parallel import SPMDTrainer

CPU = torch.device("cpu")


def _dataset(n=64, d=4, seed=0):
    rs = onp.random.RandomState(seed)
    return ArrayDataset(rs.rand(n, d).astype("float32"),
                        onp.arange(n, dtype="float32"))


def _threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("DevicePrefetch", "DataLoaderPrefetch"))]


def _await_no_threads(deadline_s=8.0):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        gc.collect()
        if not _threads():
            return []
        time.sleep(0.05)
    return _threads()


def _np(b):
    if isinstance(b, (tuple, list)):
        return [_np(x) for x in b]
    return b.asnumpy() if hasattr(b, "asnumpy") else onp.asarray(b)


def test_prefetch_depth_env(monkeypatch):
    monkeypatch.delenv("MXNET_DEVICE_PREFETCH", raising=False)
    assert prefetch_depth() == 2
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "5")
    assert prefetch_depth() == 5
    assert DevicePrefetcher([], sharding=CPU).depth == 5
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "-3")
    assert prefetch_depth() == 0
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "x")
    with pytest.raises(MXNetError, match="MXNET_DEVICE_PREFETCH"):
        prefetch_depth()


def test_depth_zero_wrap_is_identity(monkeypatch):
    loader = DataLoader(_dataset(), batch_size=8)
    monkeypatch.setenv("MXNET_DEVICE_PREFETCH", "0")
    assert wrap(loader, CPU) is loader
    assert wrap(loader, CPU, depth=0) is loader
    monkeypatch.delenv("MXNET_DEVICE_PREFETCH")
    assert isinstance(wrap(loader, CPU), DevicePrefetcher)


def test_wrapped_loader_is_bitwise_the_bare_loader_epoch_after_epoch():
    ds = _dataset()
    onp.random.seed(3)
    bare = [_np(b) for b in DataLoader(ds, batch_size=8, shuffle=True)]
    onp.random.seed(3)
    pf = DevicePrefetcher(DataLoader(ds, batch_size=8, shuffle=True),
                          sharding=CPU, depth=3)
    epochs = [[_np(b) for b in pf] for _ in range(2)]
    assert len(epochs[0]) == len(bare) == len(pf) == 8
    for a, b in zip(epochs[0], bare):
        for x, y in zip(a, b):
            onp.testing.assert_array_equal(x, y)
    # the second epoch reshuffles: same rows, another order
    assert sorted(onp.concatenate([b[1] for b in epochs[1]])) == \
        sorted(onp.concatenate([b[1] for b in bare]))
    assert not _await_no_threads()


def test_source_error_surfaces_at_consumer():
    def gen():
        yield onp.zeros(2, onp.float32)
        raise ValueError("broken source")
    it = iter(DevicePrefetcher(gen(), sharding=CPU, depth=2))
    next(it)
    with pytest.raises(ValueError, match="broken source"):
        next(it)
    assert not _await_no_threads()


def test_close_and_interruption_leave_no_thread():
    pf = DevicePrefetcher(DataLoader(_dataset(256), batch_size=4,
                                     prefetch=2, timeout=30),
                          sharding=CPU, depth=2)
    for i, _ in enumerate(pf):
        if i == 2:
            break
    pf.close()
    assert not _await_no_threads()
    it = iter(DevicePrefetcher(DataLoader(_dataset(256), batch_size=4),
                               sharding=CPU, depth=2))
    next(it)
    del it                        # the consumer drops the iterator
    assert not _await_no_threads()


def test_ndarray_iter_reset_and_next():
    data = onp.random.RandomState(2).rand(32, 4).astype("float32")
    bare = [b.data[0].asnumpy() for b in mt.io.NDArrayIter(data, data[:, 0],
                                                          batch_size=8)]
    pf = DevicePrefetcher(mt.io.NDArrayIter(data, data[:, 0], batch_size=8),
                          sharding=mt.cpu(), depth=2)
    for _ in range(2):
        got = [b.data[0].asnumpy() for b in pf]
        for a, b in zip(got, bare):
            onp.testing.assert_array_equal(a, b)
        pf.reset()
    batch = pf.next()
    assert batch.pad == 0 and batch.data[0]._data.device.type == "cpu"
    pf.close()
    assert not _await_no_threads()


def _batches(n, bs=8, d=4, seed=0):
    rng = onp.random.RandomState(seed)
    return [(rng.randn(bs, d).astype("float32"),
             rng.randint(0, 3, (bs,)).astype("float32")) for _ in range(n)]


def _spmd(seed=3):
    rng = onp.random.RandomState(seed)
    net = nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    net.weight.set_data(torch.from_numpy(
        rng.randn(3, 4).astype(onp.float32)))
    return SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1},
                       device="cpu")


def test_spmd_fed_matches_host_fed_with_no_step_h2d():
    batches = _batches(4)
    host, fed = _spmd(), _spmd()
    want = [host.step(x, y).asnumpy() for x, y in batches]
    got = []
    c0 = telemetry.counter("input.step_h2d").value
    h0 = telemetry.counter("input.h2d_bytes").value
    for x, y in wrap(batches, fed):
        got.append(fed.step(x, y).asnumpy())
    assert telemetry.counter("input.step_h2d").value == c0
    assert telemetry.counter("input.h2d_bytes").value - h0 == \
        sum(x.nbytes + y.nbytes for x, y in batches)
    onp.testing.assert_array_equal(got, want)
    onp.testing.assert_array_equal(
        fed.net.weight._tensor().detach().numpy(),
        host.net.weight._tensor().detach().numpy())
    # the reference accounts the same bytes for the same numpy batches
    r0 = ref_tel.counter("input.h2d_bytes").value
    list(ref_wrap(batches, None))
    assert ref_tel.counter("input.h2d_bytes").value - r0 == \
        telemetry.counter("input.h2d_bytes").value - h0


def test_window_staging_feeds_run_steps():
    W = 3
    batches = _batches(3 * W + 2, seed=4)
    direct, fed = _spmd(), _spmd()
    drop0 = telemetry.counter("input.window_dropped").value
    pf = wrap(batches, consumer=fed, window=W)
    assert len(pf) == 3
    seen = 0
    for i, (d, l) in enumerate(pf):
        assert d.shape == (W, 8, 4) and l.shape == (W, 8)
        c0 = telemetry.counter("input.step_h2d").value
        got = fed.run_steps(d, l, W, per_step_data=True).asnumpy()
        assert telemetry.counter("input.step_h2d").value == c0
        xs = onp.stack([b[0] for b in batches[i * W:(i + 1) * W]])
        ys = onp.stack([b[1] for b in batches[i * W:(i + 1) * W]])
        want = direct.run_steps(xs, ys, W, per_step_data=True).asnumpy()
        onp.testing.assert_array_equal(got, want)
        seen += 1
    assert seen == 3
    assert telemetry.counter("input.window_dropped").value - drop0 == 2
    # the reference's windows hold the same values
    ref_windows = list(ref_wrap(batches, None, depth=0, window=W))
    for (d, l), (rd, rl) in zip(wrap(batches, CPU, window=W), ref_windows):
        onp.testing.assert_array_equal(d.asnumpy(), onp.asarray(rd))
        onp.testing.assert_array_equal(l.asnumpy(), onp.asarray(rl))


def test_window_at_depth_zero_and_fast_forward():
    W = 4
    batches = _batches(3 * W)
    pf0 = wrap(batches, consumer=None, depth=0, window=W)
    assert isinstance(pf0, DevicePrefetcher)
    first = next(iter(pf0))
    assert isinstance(first[0], onp.ndarray) and first[0].shape == (W, 8, 4)
    pf = wrap(batches, consumer=CPU, window=W)
    pf.fast_forward(2)
    remaining = list(pf)
    assert len(remaining) == 1
    onp.testing.assert_array_equal(
        remaining[0][0].asnumpy(), onp.stack([b[0] for b in batches[2 * W:]]))


def test_step_records_carry_input_fields():
    class Sink:
        def __init__(self):
            self.records = []

        def emit(self, rec):
            self.records.append(rec)
    sink = Sink()
    telemetry.add_sink(sink)
    try:
        tr = _spmd()
        h0 = telemetry.counter("input.h2d_bytes").value
        for x, y in wrap(_batches(3), tr):
            tr.step(x, y)
        tr.step(*_batches(1)[0])       # host batch: staged in the call
    finally:
        telemetry.remove_sink(sink)
    assert len(sink.records) == 4
    for rec in sink.records:
        assert rec["input_wait_ms"] >= 0 and rec["h2d_bytes"] >= 0
    # every copied batch is accounted in the registry (the per-record
    # delta covers the step's own window only, as in the reference)
    assert telemetry.counter("input.h2d_bytes").value - h0 == \
        4 * (8 * 4 * 4 + 8 * 4)


def _gluon_loop(loader_kw, cached):
    rng = onp.random.RandomState(1)
    net = nn.Dense(2, in_units=4)
    net.initialize(device="cpu")
    net.weight.set_data(torch.from_numpy(rng.randn(2, 4).astype("float32")))
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1}, kvstore=None)
    loader = DataLoader(_dataset(40), batch_size=8, **loader_kw(trainer))
    losses = []
    for _ in range(2):
        for x, y in loader:
            with autograd.record():
                loss = ((net(x) - y.reshape((-1, 1))) ** 2).mean()
            loss.backward()
            trainer.step(1)
            losses.append(float(loss.asnumpy()))
    return losses, net.weight._tensor().detach().numpy()


@pytest.mark.parametrize("cached", ["0", "1"], ids=["eager", "captured"])
def test_gluon_loop_fed_by_the_prefetcher_is_bitwise_host_fed(cached,
                                                              monkeypatch):
    monkeypatch.setenv("MXNET_CACHED_STEP", cached)
    want = _gluon_loop(lambda tr: {}, cached)
    got = _gluon_loop(lambda tr: {"prefetch_to_device": tr}, cached)
    assert got[0] == want[0]
    onp.testing.assert_array_equal(got[1], want[1])
    assert not _await_no_threads()


def test_inference_engine_takes_an_ndarray_batch():
    from mxnet_tpu_torch.serving import InferenceEngine
    rng = onp.random.RandomState(4)
    net = nn.Dense(3, in_units=4)
    net.initialize(device="cpu")
    eng = InferenceEngine(net, example_shape=(4,), dtype="float32",
                          bucket_sizes=[4, 8])
    exs = [rng.rand(4).astype("float32") for _ in range(5)]
    res_host, meta_host = eng.infer_batch(exs)
    (batch,) = wrap([mt.io.host_nd(onp.stack(exs))], CPU)
    res_dev, meta_dev = eng.infer_batch(batch)
    assert meta_dev["device_committed"] and "device_committed" not in \
        meta_host
    for a, b in zip(res_host, res_dev):
        onp.testing.assert_array_equal(a, b)


def test_default_placement_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        DevicePrefetcher([onp.zeros(2)])
    with pytest.raises(MXNetError, match="no CUDA device"):
        iter(DataLoader(_dataset(8), batch_size=4, prefetch_to_device=True))
    pf = DevicePrefetcher([onp.zeros(2)], sharding="cpu")
    assert [b.asnumpy().tolist() for b in pf] == [[0.0, 0.0]]
    assert DevicePrefetcher([onp.zeros(2)], depth=0) is not None
