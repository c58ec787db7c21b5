"""The port's step record and its sinks (``mxnet_tpu_torch/telemetry.py``)
against the reference's, on the CPU.

* The record's key set, recursively, for 3 steps of a ``Dense(4,
  in_units=3)`` ``SPMDTrainer`` and of a ``gluon.Trainer`` loop
  (``MXNET_CACHED_STEP=0`` in both packages, their eager step) with the
  same weights and batches, and its structural values: every field but
  the times (``ts``, ``host_ms``, ``compile_ms``, ``critical_path``'s
  ``compute``), ``device_mem`` (the reference lists the host as a device
  with zeros; the port lists initialised CUDA devices, none here) and
  the first steps' ``compiles`` / ``dispatches`` (the reference
  compiles its eager ops there; the port captures nothing on the CPU),
  which are held on the steady step instead.
* The sinks (JSONL, log, TensorBoard with a writer object or a log
  directory), the environment switches and their refresh, a broken sink
  detached, ``set_slo_provider``, ``step_count`` and the ``record_*``
  producers, each against the reference's effect on its registry.
* The reference's offline tools (``tools/telemetry_report.py``,
  ``tools/slo_report.py``, ``tools/cluster_report.py``) read the port's
  JSONL and spools unchanged and print the same sections as for the
  reference's output of the same steps (subprocesses, 120 s timeout).
"""
import json
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon import loss as jax_loss
from mxnet_tpu.gluon import nn as jax_nn
from mxnet_tpu.parallel import SPMDTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as gloss
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.parallel import SPMDTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = onp.random.RandomState(0)
X = RNG.randn(5, 3).astype("float32")
Y = RNG.randint(0, 4, size=(5,)).astype("int32")
W = {"weight": RNG.randn(4, 3).astype("float32") * 0.5,
     "bias": RNG.randn(4).astype("float32") * 0.1}
# fields that hold times, or what a package's runtime (not the step)
# makes of a first call
TIMES = ("ts", "host_ms", "compile_ms")


def _same_state():
    """Both packages' process-wide state that adds a record section back
    to its default: the MoE drop counter (``moe``), the SLO provider
    (``serving_slo``) and the AMP policy (``amp``).  Another test in the
    same process (the reference's MoE tests drop tokens) must not decide
    which sections a record here carries.  Also this thread's input wait
    not yet drained into a record: a prefetcher an earlier test consumed
    while a sink was set (``tests/test_data_pipeline.py``) leaves it for
    the next record, which would then carry that test's wait."""
    from mxnet_tpu.amp import policy as jpolicy
    from mxnet_tpu_torch.amp import policy
    for tel in (telemetry, jtel):
        tel.clear_sinks()
        tel.set_slo_provider(None)
        tel.reset("moe.")          # a dropped token adds a record section
        tel._wait_tls.__dict__.pop("ms", None)
    for pol in (policy, jpolicy):
        pol.deactivate()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("MXNET_TELEMETRY_JSONL", "MXNET_TELEMETRY_LOG_EVERY",
              "MXNET_CLUSTER_DIR", "MXNET_METRICS_PORT", "MXNET_TRACE",
              "MXNET_WATCHDOG_SEC", "MXNET_TRACE_JSONL", "MXNET_AMP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    _same_state()
    for tel in (telemetry, jtel):
        tel.enabled()
    yield
    _same_state()


class Sink:
    def __init__(self):
        self.records = []

    def emit(self, r):
        self.records.append(r)


def keys(d, p=""):
    out = set()
    for k, v in d.items():
        out.add(p + k)
        if isinstance(v, dict):
            out |= keys(v, p + k + ".")
    return out


def structural(rec):
    r = {k: v for k, v in rec.items()
         if k not in TIMES + ("step", "device_mem", "compiles",
                              "dispatches")}
    r["critical_path"] = {k: v for k, v in rec["critical_path"].items()
                          if k != "compute"}
    return r


def _jax_dense():
    net = jax_nn.Dense(4, in_units=3)
    net.initialize()
    for k, p in net.collect_params().items():
        p.set_data(mx.nd.array(W[k.split("_")[-1]]))
    return net


def _port_dense():
    net = nn.Dense(4, in_units=3)
    net.initialize(device="cpu")
    for k, p in net.collect_params().items():
        p.set_data(mt.nd.array(W[k.split("_")[-1]], ctx=mt.cpu()))
    return net


def _records(tel, run):
    sink = Sink()
    tel.add_sink(sink)
    try:
        run()
    finally:
        tel.remove_sink(sink)
    return sink.records


def _spmd_runs():
    def ref():
        tr = JaxTrainer(_jax_dense(), jax_loss.SoftmaxCrossEntropyLoss(),
                        optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1},
                        mesh=make_mesh({"dp": 1}, devices=jax.devices()[:1]))
        for _ in range(3):
            tr.step(mx.nd.array(X), mx.nd.array(Y))

    def port():
        tr = SPMDTrainer(_port_dense(), gloss.SoftmaxCrossEntropyLoss(),
                         optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1},
                         device="cpu")
        for _ in range(3):
            tr.step(X, Y)
    return _records(jtel, ref), _records(telemetry, port)


def _gluon_runs():
    def loop(pkg, net, lf):
        tr = pkg.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
        ag = pkg.autograd
        for _ in range(3):
            x = pkg.nd.array(X) if pkg is mx else mt.nd.array(X,
                                                              ctx=mt.cpu())
            y = pkg.nd.array(Y) if pkg is mx else mt.nd.array(Y,
                                                              ctx=mt.cpu())
            with ag.record():
                loss = lf(net(x), y)
            loss.backward()
            tr.step(5)

    return (_records(jtel, lambda: loop(mx, _jax_dense(),
                                        jax_loss.SoftmaxCrossEntropyLoss())),
            _records(telemetry, lambda: loop(
                mt, _port_dense(), gloss.SoftmaxCrossEntropyLoss())))


@pytest.mark.parametrize("runs", [_spmd_runs, _gluon_runs],
                         ids=["SPMDTrainer", "gluon.Trainer"])
def test_step_record_matches_the_reference(runs):
    ref, got = runs()
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert keys(g) == keys(r)
        assert structural(g) == structural(r)
        assert g["device_mem"] == []
        assert isinstance(g["critical_path"]["compute"], float)
    # the steady step: no capture, and the reference's dispatch count
    assert (got[-1]["compiles"], got[-1]["dispatches"]) == \
        (ref[-1]["compiles"], ref[-1]["dispatches"])
    assert [g["step"] - got[0]["step"] for g in got] == [0, 1, 2]


@pytest.fixture(scope="module")
def reference_dropped_a_token():
    """A token dropped by the reference's MoE producer before the test
    begins, as an earlier test in the same process leaves it (the
    reference's ``test_switch_moe_capacity_drops_tokens``).  Module scope:
    it is set up before the function-scoped ``_clean``."""
    jtel.record_moe_dropped(3)
    return jtel.counter("moe.dropped_tokens").value


@pytest.mark.parametrize("runs", [_spmd_runs, _gluon_runs],
                         ids=["SPMDTrainer", "gluon.Trainer"])
def test_step_record_matches_after_a_reference_token_drop(
        reference_dropped_a_token, runs):
    """The records agree whatever an earlier test left in either
    package's process-wide state: ``_clean`` resets it before each
    test."""
    assert reference_dropped_a_token > 0
    test_step_record_matches_the_reference(runs)


def test_step_record_sections_when_active():
    """``amp`` joins the record under the AMP policy, ``serving_slo``
    with a provider, ``moe`` once a token was dropped; a provider that
    raises drops only its section."""
    from mxnet_tpu_torch.amp import policy
    sink = Sink()
    telemetry.add_sink(sink)
    policy.activate("bfloat16")
    try:
        telemetry.end_step(telemetry.begin_step(), "t")
    finally:
        policy.deactivate()
    assert set(sink.records[-1]["amp"]) == {
        "compute_dtype", "loss_scale", "overflow_steps", "skipped_updates"}
    assert sink.records[-1]["amp"]["compute_dtype"] == "bfloat16"
    telemetry.set_slo_provider(lambda: {"burning": None})
    telemetry.end_step(telemetry.begin_step(), "t")
    assert sink.records[-1]["serving_slo"] == {"burning": None}
    telemetry.set_slo_provider(lambda: 1 / 0)
    telemetry.end_step(telemetry.begin_step(), "t")
    assert "serving_slo" not in sink.records[-1]
    telemetry.record_moe_dropped(torch.tensor(3))
    telemetry.end_step(telemetry.begin_step(), "t")
    assert sink.records[-1]["moe"] == {"dropped_tokens": 0}


def test_producers_move_the_registry_as_the_reference_does():
    names = ("comm.bytes", "comm.local.bytes", "comm.sparse.bytes",
             "comm.dp.bytes", "dispatch.count", "embedding.rows_pulled",
             "embedding.rows_pushed", "embedding.sparse_bytes",
             "embedding.dense_equiv_bytes", "moe.dropped_tokens",
             "compile.count", "compile.test.count")
    moved = []
    for tel in (telemetry, jtel):
        before = {n: tel.counter(n).value for n in names}
        tel.record_comm_bytes(100, "local")
        tel.record_axis_comm_bytes(40, "dp")
        tel.record_dispatch(3)
        tel.record_embedding_wire(2, 3, 64, 256)
        tel.record_moe_dropped(5)
        tel.record_compile(0.002, "test")
        tel.record_opt_state_bytes(1234)
        tel.record_op_time("probe", 0.5)
        moved.append({n: tel.counter(n).value - before[n] for n in names})
        assert tel.gauge("opt_state.bytes_per_device").value == 1234
        assert tel.histogram("op.probe").count >= 1
    assert moved[0] == moved[1]


def test_kvstore_accounts_local_bytes_like_the_reference():
    """The local kvstore's push and pushpull add their payload to
    ``comm.bytes`` and ``comm.local.bytes`` as the reference's do, and
    the ``comm.*`` spans carry ``payload_nbytes``."""
    from mxnet_tpu_torch import tracing
    a = onp.ones((4, 5), "float32")
    moved = []
    for pkg, arr in ((mt, lambda v: mt.nd.array(v, ctx=mt.cpu())),
                     (mx, mx.nd.array)):
        tel = telemetry if pkg is mt else jtel
        kv = pkg.kv.create("local")
        kv.init(3, arr(a))
        c0 = (tel.counter("comm.bytes").value,
              tel.counter("comm.local.bytes").value)
        kv.push(3, [arr(a), arr(a)])
        out = arr(onp.zeros_like(a))
        kv.pushpull(3, arr(a), out=out)
        moved.append((tel.counter("comm.bytes").value - c0[0],
                      tel.counter("comm.local.bytes").value - c0[1]))
    assert moved[0] == moved[1] == (160, 160)
    tracing.enable()
    try:
        kv = mt.kv.create("local")
        kv.init(1, mt.nd.array(a, ctx=mt.cpu()))
        kv.push(1, mt.nd.array(a, ctx=mt.cpu()))
        sp = [e for e in tracing.recent(5) if e["name"] == "comm.push"][-1]
        assert sp["args"]["payload_nbytes"] == 80
    finally:
        tracing._env_default()


def test_jsonl_and_log_sinks_follow_the_environment(tmp_path, monkeypatch,
                                                    caplog):
    path = tmp_path / "steps.jsonl"
    monkeypatch.setenv("MXNET_TELEMETRY_JSONL", str(path))
    monkeypatch.setenv("MXNET_TELEMETRY_LOG_EVERY", "2")
    import logging
    from mxnet_tpu_torch.log import get_logger
    get_logger("mxnet_tpu_torch.telemetry")     # its first set-up
    caplog.set_level(logging.INFO, logger="mxnet_tpu_torch.telemetry")
    n0 = telemetry.step_count()
    for _ in range(4):
        telemetry.end_step(telemetry.begin_step(), "env")
    recs = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["step"] for r in recs] == [n0 + 1 + i for i in range(4)]
    assert len([s for s in telemetry.sinks()
                if isinstance(s, (telemetry.JSONLSink,
                                  telemetry.LogSink))]) == 2
    assert sum("[env]" in m for m in caplog.messages) == 2
    # clear_sinks forgets the cached switch: still set, it re-attaches
    telemetry.clear_sinks()
    telemetry.end_step(telemetry.begin_step(), "env")
    assert len(path.read_text().splitlines()) == 5
    monkeypatch.delenv("MXNET_TELEMETRY_JSONL")
    monkeypatch.delenv("MXNET_TELEMETRY_LOG_EVERY")
    assert telemetry.enabled() is False
    assert telemetry.begin_step() is None
    monkeypatch.setenv("MXNET_TELEMETRY_LOG_EVERY", "x")
    assert telemetry.enabled() is False      # warned, nothing attached


def test_a_broken_sink_is_detached_and_the_step_goes_on():
    good = Sink()

    class Broken:
        closed = False

        def emit(self, r):
            raise RuntimeError("disk full")

        def close(self):
            Broken.closed = True

    telemetry.add_sink(Broken())
    telemetry.add_sink(good)
    tr = SPMDTrainer(_port_dense(), gloss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd", device="cpu")
    tr.step(X, Y)
    tr.step(X, Y)
    assert len(good.records) == 2 and Broken.closed
    assert telemetry.sinks() == [good]


class Writer:
    def __init__(self):
        self.scalars, self.flushes, self.closed = [], 0, False

    def add_scalar(self, tag, value, global_step=None):
        self.scalars.append((tag, value, global_step))

    def flush(self):
        self.flushes += 1

    def close(self):
        self.closed = True


def test_tensorboard_sink_with_a_writer_and_a_logdir(tmp_path, monkeypatch):
    w = Writer()
    sink = telemetry.TensorBoardSink(w)
    telemetry.add_sink(sink)
    telemetry.end_step(telemetry.begin_step(), "tb")
    step = telemetry.step_count()
    assert {t for t, _, s in w.scalars if s == step} == {
        "telemetry/host_ms", "telemetry/compiles", "telemetry/compile_ms",
        "telemetry/collective_bytes"}
    telemetry.remove_sink(sink)
    assert w.closed and w.flushes == 1
    # no backend: MXNetError, as the reference's contrib bridge raises
    for mod in ("mxboard", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, mod, None)
    with pytest.raises(MXNetError, match="SummaryWriter"):
        telemetry.TensorBoardSink(str(tmp_path))


def test_nothing_runs_with_no_sink(monkeypatch):
    """With no sink and no switch, ``begin_step`` is None and no record is
    made; the counters still move."""
    assert telemetry.enabled() is False
    n0, d0 = telemetry.step_count(), telemetry.counter("dispatch.count").value
    tr = SPMDTrainer(_port_dense(), gloss.SoftmaxCrossEntropyLoss(),
                     optimizer="sgd", device="cpu")
    last = telemetry.last_record()
    tr.step(X, Y)
    assert telemetry.step_count() == n0
    assert telemetry.last_record() is last
    assert telemetry.counter("dispatch.count").value > d0


# -- the reference's offline tools on the port's output ----------------------

def _tool(name, *args):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", name), *args],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def _sections(text):
    return [ln.split(":")[0] for ln in text.splitlines()
            if ln and not ln.startswith(" ") and ln.rstrip().endswith(":")]


def _observed_run(pkg, root, monkeypatch):
    """6 SPMDTrainer steps and a served batch under a declared objective,
    spooled and written as JSONL by ``pkg``."""
    tel = telemetry if pkg is mt else jtel
    monkeypatch.setenv("MXNET_TELEMETRY_JSONL", str(root / "steps.jsonl"))
    monkeypatch.setenv("MXNET_CLUSTER_DIR", str(root / "cluster"))
    try:
        if pkg is mt:
            from mxnet_tpu_torch.serving import InferenceEngine, slo
            from mxnet_tpu_torch.serving import DynamicBatcher
            tr = SPMDTrainer(_port_dense(), gloss.SoftmaxCrossEntropyLoss(),
                             optimizer="sgd", device="cpu")
            for _ in range(6):
                tr.step(X, Y)
            eng = InferenceEngine(_port_dense(), example_shape=(3,),
                                  dtype="float32")
        else:
            from mxnet_tpu.serving import InferenceEngine, slo
            from mxnet_tpu.serving import DynamicBatcher
            tr = JaxTrainer(_jax_dense(), jax_loss.SoftmaxCrossEntropyLoss(),
                            optimizer="sgd",
                            mesh=make_mesh({"dp": 1},
                                           devices=jax.devices()[:1]))
            for _ in range(6):
                tr.step(mx.nd.array(X), mx.nd.array(Y))
            eng = InferenceEngine(_jax_dense(), example_shape=(3,),
                                  dtype="float32")
        slo.declare(latency_ms=1000.0, window_s=30.0)
        b = DynamicBatcher(eng, start=False, max_delay_ms=0.0)
        for x in X:
            b.submit(x)
        b.flush()
        b.close(drain=False)
        slo.undeclare()
    finally:
        monkeypatch.delenv("MXNET_TELEMETRY_JSONL")
        monkeypatch.delenv("MXNET_CLUSTER_DIR")
        tel.enabled()


def test_reference_tools_read_the_ports_output(tmp_path, monkeypatch):
    for name, pkg in (("ref", mx), ("port", mt)):
        (tmp_path / name).mkdir()
        _observed_run(pkg, tmp_path / name, monkeypatch)
    got, ref = {}, {}
    for d, out in (("port", got), ("ref", ref)):
        root = tmp_path / d
        out["telemetry"] = json.loads(_tool(
            "telemetry_report.py", str(root / "steps.jsonl"), "--json"))
        out["telemetry_text"] = _tool("telemetry_report.py",
                                      str(root / "steps.jsonl"))
        out["slo"] = _tool("slo_report.py", str(root / "steps.jsonl"),
                           "--latency-ms", "1000")
        out["cluster"] = json.loads(_tool(
            "cluster_report.py", str(root / "cluster"), "--json"))
    assert set(got["telemetry"]) == set(ref["telemetry"])
    assert _sections(got["telemetry_text"]) == \
        _sections(ref["telemetry_text"])
    assert _sections(got["slo"]) == _sections(ref["slo"])
    assert set(got["cluster"]) == set(ref["cluster"])
    assert got["telemetry"]["steps"] == ref["telemetry"]["steps"]
