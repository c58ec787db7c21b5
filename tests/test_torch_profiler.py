"""``mx.profiler`` over ``torch.profiler`` and the device-trace reader
(``mxnet_tpu_torch/profiler.py``, ``kineto.py``) on the CPU, against the
reference where both have the same thing to say:

* every public name of the reference's ``profiler``, ``telemetry``,
  ``tracing``, ``monitor``, ``clustermon`` and ``serving.slo`` exists in
  the port's;
* ``counters()`` has the reference's sections and keys, recursively;
* a cycle (``start``/``stop``) writes one trace, ``pause``/``resume``
  a second segment of it, ``capture_guard`` closes and reopens the
  session; the op table, ``dumps``, ``dump``, the user ``Counter``;
* ``kineto.device_op_table`` on a hand-written trace (kernels, copies and
  memsets counted; host events not), on one cut short (the events
  before the cut), on a directory of two cycles (the newer), and on none
  (``{}`` / None).

On the CPU ``torch.profiler`` records no device event: the tables of a
real cycle are ``{}`` here, and ``chip_smoke.py``'s ``observability``
phase holds them on the card.
"""
import importlib
import json
import os

import numpy as onp
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kineto, profiler, telemetry, tracing
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import SPMDTrainer

RNG = onp.random.RandomState(0)
X = RNG.randn(5, 3).astype("float32")
Y = RNG.randint(0, 4, size=(5,)).astype("int32")


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    profiler.stop()
    saved = dict(profiler._config)
    profiler.set_config(filename=str(tmp_path / "profile.json"))
    telemetry.clear_sinks()
    yield
    profiler.stop()
    profiler._config.clear()
    profiler._config.update(saved)
    profiler.reset_stats()
    telemetry.clear_sinks()


@pytest.mark.parametrize("mod", ["profiler", "telemetry", "tracing",
                                 "monitor", "clustermon", "serving.slo"])
def test_the_reference_modules_public_names_exist(mod):
    ref = importlib.import_module("mxnet_tpu." + mod)
    port = importlib.import_module("mxnet_tpu_torch." + mod)
    missing = [n for n in ref.__all__ if not hasattr(port, n)]
    assert missing == []
    assert set(ref.__all__) <= set(port.__all__) | {
        n for n in ref.__all__ if hasattr(port, n)}


def _key_tree(d):
    return {k: _key_tree(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_counters_have_the_reference_sections():
    from mxnet_tpu import profiler as jprof
    assert _key_tree(profiler.counters()) == _key_tree(jprof.counters())
    c = profiler.counters()
    assert c["cluster"]["straggler_rank"] == -1
    assert c["eager_jit"] == {"hits": 0, "misses": 0, "latches": 0}
    assert c["amp"]["enabled"] is False


def _trainer():
    net = nn.Dense(4, in_units=3)
    net.initialize(device="cpu")
    return SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(),
                       optimizer="sgd", device="cpu")


def test_a_cycle_writes_its_trace_and_the_op_table(tmp_path):
    tr = _trainer()
    tr.step(X, Y)
    sink_records = []

    class Sink:
        def emit(self, r):
            sink_records.append(r)

    telemetry.add_sink(Sink())
    profiler.set_config(profile_imperative=True)
    profiler.start()
    assert profiler.is_running() and profiler.imperative_enabled()
    for _ in range(3):
        tr.step(X, Y)
    with profiler.Task("user-task"):
        pass
    profiler.Marker("m").mark()
    profiler.pause()
    assert not profiler.imperative_enabled()
    tr.step(X, Y)                       # not in the op table
    profiler.resume()
    tr.step(X, Y)
    profiler.stop()
    files = kineto.cycle_files(profiler.trace_dir())
    assert [os.path.basename(f).rsplit("-", 1)[1] for f in files] == [
        "0.pt.trace.json", "1.pt.trace.json"]
    for f in files:
        assert kineto.read_events(f), f      # host events, no device ones
    assert profiler.device_op_table() == {}
    ops = profiler.op_stats()
    assert ops["SPMDTrainer::step"]["count"] == 4
    assert ops["user-task"]["count"] == 1 and "marker:m" in ops
    tr.step(X, Y)
    assert sink_records[-1]["device_ms"] is None   # no device events here
    c = profiler.Counter("items", value=3)
    c.increment(2)
    text = profiler.dumps()
    assert "SPMDTrainer::step" in text and "items" in text
    profiler.dump()
    with open(profiler._config["filename"]) as f:
        doc = json.load(f)
    assert set(doc) == {"traceEvents", "trace_dir", "device_op_table"}
    assert doc["trace_dir"] == profiler.trace_dir()
    profiler.reset_stats()
    assert "SPMDTrainer::step" not in profiler.dumps()


def test_capture_guard_closes_and_reopens_the_session():
    profiler.start()
    first = profiler._session
    assert first is not None
    with profiler.capture_guard():
        assert profiler._session is None
    assert profiler._session is not None and profiler._session is not first
    profiler.stop()
    assert len(kineto.cycle_files(profiler.trace_dir())) == 2
    with profiler.capture_guard():          # no cycle: nothing happens
        assert profiler._session is None


def test_device_memory_on_the_host():
    assert profiler.device_memory_info() == {}
    assert profiler.device_memory_summary().startswith("Device memory:")
    assert telemetry.device_memory_record() == []


def test_serving_engine_feeds_the_op_table():
    from mxnet_tpu_torch.serving import InferenceEngine
    net = nn.Dense(4, in_units=3)
    net.initialize(device="cpu")
    eng = InferenceEngine(net, example_shape=(3,), dtype="float32",
                          name="probe")
    profiler.set_config(profile_all=True)
    profiler.start()
    eng.infer_batch(list(X[:2]))
    profiler.stop()
    assert profiler.op_stats()["Serving::probe"]["count"] == 1


# -- the device-trace reader --------------------------------------------------

def _event(name, cat, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": 1.0, "dur": dur}


TRACE = {"schemaVersion": 1, "traceEvents": [
    _event("aten::mm", "cpu_op", 50.0),
    _event("cudaLaunchKernel", "cuda_runtime", 5.0),
    _event("void fa_fwd_wgmma_kernel<64>(...)", "kernel", 100.0),
    _event("void fa_fwd_wgmma_kernel<64>(...)", "kernel", 110.0),
    _event("void fa_bwd_dq_mma_kernel<64, 64>(...)", "kernel", 300.0),
    _event("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 20.0),
    _event("Memset (Device)", "gpu_memset", 2.0),
    _event("fa_fwd", "kernel", 0.0, ph="i"),
]}


def test_device_op_table_of_a_written_trace(tmp_path):
    path = tmp_path / "c1-0.pt.trace.json"
    path.write_text(json.dumps(TRACE))
    table = kineto.device_op_table(str(path))
    assert table == {
        "void fa_fwd_wgmma_kernel<64>(...)":
            {"count": 2, "total_us": 210.0, "avg_us": 105.0},
        "void fa_bwd_dq_mma_kernel<64, 64>(...)":
            {"count": 1, "total_us": 300.0, "avg_us": 300.0},
        "Memcpy HtoD (Pageable -> Device)":
            {"count": 1, "total_us": 20.0, "avg_us": 20.0},
        "Memset (Device)": {"count": 1, "total_us": 2.0, "avg_us": 2.0}}
    assert kineto.device_total_ms(str(tmp_path)) == pytest.approx(0.532)
    text = kineto.format_table(table)
    assert text.splitlines()[0] == "Device op statistics:"
    assert "TOTAL" in text.splitlines()[-1] and "532.0" in text


def test_a_trace_cut_short_gives_the_events_before_the_cut(tmp_path):
    text = json.dumps(TRACE, indent=1)
    cut = text.index("fa_bwd_dq") + 4          # inside the third kernel
    path = tmp_path / "c1-0.pt.trace.json"
    path.write_text(text[:cut])
    table = kineto.device_op_table(str(path))
    assert table == {"void fa_fwd_wgmma_kernel<64>(...)":
                     {"count": 2, "total_us": 210.0, "avg_us": 105.0}}
    path.write_text(text[:20])
    assert kineto.device_op_table(str(path)) == {}
    assert kineto.device_total_ms(str(path)) is None
    path.write_text("not json")
    assert kineto.read_events(str(path)) == []


def test_a_directory_reads_its_newest_cycle(tmp_path):
    old = {"traceEvents": [_event("old_kernel", "kernel", 5.0)]}
    (tmp_path / "a-0.pt.trace.json").write_text(json.dumps(old))
    os.utime(tmp_path / "a-0.pt.trace.json", (1, 1))
    for seg in (0, 1):
        (tmp_path / f"b-{seg}.pt.trace.json").write_text(json.dumps(TRACE))
    files = kineto.cycle_files(str(tmp_path))
    assert [os.path.basename(f) for f in files] == [
        "b-0.pt.trace.json", "b-1.pt.trace.json"]
    table = kineto.device_op_table(str(tmp_path))
    assert "old_kernel" not in table
    assert table["void fa_fwd_wgmma_kernel<64>(...)"]["count"] == 4
    empty = tmp_path / "empty"
    empty.mkdir()
    assert kineto.device_op_table(str(empty)) == {}
    assert kineto.device_total_ms(str(empty)) is None
    assert kineto.cycle_files(str(empty)) == []
    assert mt.profiler is profiler and tracing.enabled() in (True, False)
