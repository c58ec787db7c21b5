"""The port stands alone: mxnet_tpu_torch and chip_smoke.py import
neither JAX nor the reference package, and the port's entry points run
on the GPU unless the caller asks for the CPU."""
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from mxnet_tpu_torch.base import MXNetError

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "mxnet_tpu_torch"
# a path such as ``mxnet_tpu/ops/rope.py`` cites the reference kernel a
# port replaces (file and line), and a hyphenated name such as
# ``mxnet_tpu-updater-states-v1`` is a data format both packages read and
# write; the bare package name or a dotted module path would be a use of
# it
REFERENCE = re.compile(r"\bmxnet_tpu\b(?!_torch|/|-)")
JAX_IMPORT = re.compile(r"\bimport jax\b|\bfrom jax\b")


SOURCES = sorted(PORT.rglob("*.py")) + sorted(PORT.rglob("*.cu")) + [
    ROOT / "chip_smoke.py"]
BAD_TOP = ("jax", "mxnet_tpu", "ml_dtypes", "triton")

RESNET_MODULES = ["ops/nn.py", "ops/optimizer_ops.py",
                  "optimizer/optimizer.py", "gluon/parameter.py",
                  "gluon/block.py", "gluon/nn/basic_layers.py",
                  "gluon/nn/conv_layers.py",
                  "gluon/model_zoo/vision/__init__.py",
                  "gluon/model_zoo/vision/resnet.py", "parallel/trainer.py"]
PERSISTENCE_MODULES = ["checkpoint.py", "checkpoint_gc.py", "faultinject.py",
                       "ndarray/legacy_serialization.py", "ndarray/ndarray.py",
                       "gluon/block.py", "gluon/parameter.py",
                       "parallel/trainer.py", "base.py"]
CAPTURE_MODULES = ["imperative/__init__.py", "imperative/cached_step.py",
                   "ops/registry.py", "autograd.py", "gluon/block.py",
                   "gluon/trainer.py", "executable.py"]
INPUT_MODULES = ["recordio.py", "engine.py", "io/__init__.py", "io/io.py",
                 "io/native.py", "gluon/data/__init__.py",
                 "gluon/data/dataset.py", "gluon/data/sampler.py",
                 "gluon/data/batchify.py", "gluon/data/dataloader.py",
                 "gluon/data/vision/__init__.py",
                 "gluon/data/vision/transforms.py",
                 "gluon/data/vision/datasets.py", "image/__init__.py",
                 "image/image.py", "data/__init__.py",
                 "data/device_pipeline.py", "gluon/metric.py",
                 "gluon/utils.py", "telemetry.py", "kernels/build.py"]
OBSERVABILITY_MODULES = ["telemetry.py", "tracing.py", "profiler.py",
                         "kineto.py", "monitor.py", "clustermon.py",
                         "serving/slo.py", "serving/server.py",
                         "serving/engine.py", "serving/batcher.py",
                         "contrib/__init__.py", "contrib/tensorboard.py",
                         "checkpoint.py", "data/device_pipeline.py",
                         "executable.py", "parallel/trainer.py",
                         "kvstore/kvstore.py"]
DISTRIBUTION_MODULES = ["parallel/__init__.py", "parallel/_dist.py",
                        "parallel/mesh.py", "parallel/mesh4d.py",
                        "parallel/collectives.py", "parallel/spmd.py",
                        "parallel/tensor_parallel.py",
                        "parallel/ring_attention.py", "parallel/ulysses.py",
                        "parallel/moe.py", "optimizer/fused_step.py"]


KVSTORE_MODULES = ["ndarray/sparse.py", "kvstore/__init__.py",
                   "kvstore/base.py", "kvstore/kvstore.py",
                   "kvstore/dist.py", "kvstore/gradient_compression.py",
                   "kvstore/ps_server.py", "kvstore/p3store.py",
                   "kvstore/adapters.py", "kvstore/_hvd_torch.py",
                   "embedding/__init__.py", "embedding/sharded.py",
                   "embedding/cache.py", "ops/tensor.py", "autograd.py",
                   "gluon/trainer.py"]
# the numpy front end: each module imported alone loads no JAX either
NUMPY_MODULES = ["util.py", "_numpy_dispatch.py", "numpy/__init__.py",
                 "numpy/linalg.py", "numpy/fft.py", "numpy/random.py",
                 "numpy_extension/__init__.py", "ops/np_impl.py",
                 "ops/npi.py", "ops/linalg.py", "ndarray/linalg.py",
                 "gluon/model_zoo/transformer.py"]
CASE_BODIES = ROOT / "tests" / "torch_dist_cases.py"


def _module(rel):
    return "mxnet_tpu_torch." + rel[:-3].replace("/", ".").removesuffix(
        ".__init__")


# One process imports torch, then forks a child for each check (up to
# four at a time): each module imported alone, the whole port walked,
# and the bare import under an audit hook.  Every child starts from the
# same state (torch loaded, nothing of the port), as a fresh interpreter
# that imports the port would after its first line.
_CHILDREN = textwrap.dedent("""
    import importlib, json, os, pkgutil, sys, traceback
    import torch

    BAD = {bad!r}

    def bad():
        return sorted(n for n in sys.modules if n.split(".")[0] in BAD)

    def whole():
        import mxnet_tpu_torch
        for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                       "mxnet_tpu_torch."):
            importlib.import_module(m.name)
        return {{"modules": len([n for n in sys.modules
                                if n.startswith("mxnet_tpu_torch")]),
                "bad": bad()}}

    def bare():
        events = []

        def hook(event, args):
            if event == "subprocess.Popen":
                events.append(["popen", str(args[0])])
            elif event == "ctypes.dlopen" and "torch_kernels" in str(
                    args[0]):
                events.append(["dlopen", str(args[0])])

        sys.addaudithook(hook)
        import mxnet_tpu_torch
        from mxnet_tpu_torch.kernels import build
        return {{"events": events, "bad": bad(),
                "libs": sorted(build._LIBS)}}

    def alone(mod):
        import threading
        import torch.distributed as dist
        importlib.import_module(mod)
        return {{"bad": bad(),
                "threads": [t.name for t in threading.enumerate()],
                "process_group": dist.is_initialized()}}

    checks = [("whole", whole), ("bare", bare)] + [
        (m, lambda m=m: alone(m)) for m in {mods!r}]
    out, running = {{}}, []

    def collect():
        name, pid, r = running.pop(0)
        with os.fdopen(r) as f:
            data = f.read()
        os.waitpid(pid, 0)
        out[name] = json.loads(data)

    # up to four children at a time, each forked from this same state
    for name, fn in checks:
        if len(running) == 4:
            collect()
        r, w = os.pipe()
        pid = os.fork()
        if pid == 0:
            os.close(r)
            try:
                res = {{"ok": True, **fn()}}
            except BaseException:
                res = {{"ok": False, "error": traceback.format_exc()}}
            with os.fdopen(w, "w") as f:
                f.write(json.dumps(res))
            os._exit(0)
        os.close(w)
        running.append((name, pid, r))
    while running:
        collect()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def children():
    import json
    mods = sorted({_module(r) for r in
                   RESNET_MODULES + PERSISTENCE_MODULES + CAPTURE_MODULES
                   + INPUT_MODULES + OBSERVABILITY_MODULES
                   + DISTRIBUTION_MODULES + KVSTORE_MODULES
                   + NUMPY_MODULES})
    out = subprocess.run(
        [sys.executable, "-c", _CHILDREN.format(bad=BAD_TOP, mods=mods)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_reference_or_jax(path):
    code = path.read_text()
    assert not REFERENCE.search(code), REFERENCE.search(code)
    assert not JAX_IMPORT.search(code), JAX_IMPORT.search(code)


def test_importing_the_whole_port_loads_no_jax_or_reference(children):
    res = children["whole"]
    assert res["ok"], res.get("error")
    assert res["modules"] >= 20
    assert not [n for n in res["bad"]
                if n.split(".")[0] in ("jax", "mxnet_tpu")], res["bad"]


def test_importing_the_whole_port_loads_no_triton(children):
    """Every kernel of the port is CUDA C++ behind ctypes: no module
    imports Triton, at import time or otherwise."""
    res = children["whole"]
    assert res["ok"], res.get("error")
    assert not [n for n in res["bad"] if n.split(".")[0] == "triton"]
    for path in SOURCES:
        assert not re.search(r"\bimport triton\b|\bfrom triton\b",
                             path.read_text()), path


def test_bare_import_builds_nothing(children):
    """``import mxnet_tpu_torch`` alone starts no process (no nvcc),
    loads no built kernel library, builds nothing, and imports no
    Triton, JAX or reference module."""
    res = children["bare"]
    assert res["ok"], res.get("error")
    assert (res["events"], res["bad"], res["libs"]) == ([], [], [])


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from mxnet_tpu_torch.serving import DecodeModel
    from mxnet_tpu_torch.serving.decode.paged_kv import PagedKVCache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        DecodeModel(48, dim=32, n_heads=4, n_layers=2)
    with pytest.raises(MXNetError, match="device='cpu'"):
        PagedKVCache(layers=1, num_pages=2, page_size=2, heads=1,
                     head_dim=8, max_slots=1)
    m = DecodeModel(48, dim=32, n_heads=4, n_layers=2, device="cpu")
    assert m.params["embed"].device.type == "cpu"

    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
    from mxnet_tpu_torch.parallel import SPMDTrainer
    net = TransformerLM(48, units=32, num_layers=1, num_heads=4, max_len=16)
    with pytest.raises(MXNetError, match="device='cpu'"):
        net.initialize()
    net.initialize(device="cpu")
    net(torch.zeros((1, 4), dtype=torch.int32))
    assert net.embed.weight._tensor().device.type == "cpu"
    with pytest.raises(MXNetError, match="device='cpu'"):
        SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="adam")
    tr = SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="adam",
                     device="cpu")
    assert tr.device.type == "cpu"


@pytest.mark.parametrize("rel", RESNET_MODULES)
def test_resnet_path_modules_are_held_to_the_rules(rel, children):
    """The ResNet path's modules are among the sources checked above, and
    each imports alone (a child process that had imported only torch)
    without loading JAX or the reference."""
    path = PORT / rel
    assert path in SOURCES
    res = children[_module(rel)]
    assert res["ok"], res.get("error")
    assert res["bad"] == [], res["bad"]


def test_resnet_entry_points_default_to_cuda(monkeypatch):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    from mxnet_tpu_torch.parallel import SPMDTrainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = get_resnet(1, 18, classes=10, thumbnail=True)
    with pytest.raises(MXNetError, match="device='cpu'"):
        net.initialize()
    net.initialize(device="cpu")
    net(torch.zeros((1, 3, 8, 8)))
    with pytest.raises(MXNetError, match="device='cpu'"):
        SPMDTrainer(net, SoftmaxCrossEntropyLoss())
    tr = SPMDTrainer(net, SoftmaxCrossEntropyLoss(), device="cpu")
    assert tr.device.type == "cpu" and tr.optimizer.op_name == "sgd_update"


ML_DTYPES = re.compile(r"\bimport ml_dtypes\b|\bfrom ml_dtypes\b")


@pytest.mark.parametrize("rel", PERSISTENCE_MODULES)
def test_persistence_modules_are_held_to_the_rules(rel, children):
    """The persistence path's modules are among the sources checked
    above, import no ``ml_dtypes`` (the card's machine lacks it: bfloat16
    and fp8 travel as bit patterns), and each imports alone (a child
    process that had imported only torch) without loading JAX,
    ``ml_dtypes`` or the reference."""
    path = PORT / rel
    assert path in SOURCES
    assert not ML_DTYPES.search(path.read_text()), rel
    res = children[_module(rel)]
    assert res["ok"], res.get("error")
    assert res["bad"] == [], res["bad"]


@pytest.mark.parametrize("rel", CAPTURE_MODULES)
def test_capture_modules_are_held_to_the_rules(rel, children):
    """The whole-step capture's and ``hybridize``'s modules are among the
    sources checked above and each imports alone (a child process that
    had imported only torch) without loading JAX, ``ml_dtypes``, Triton
    or the reference."""
    path = PORT / rel
    assert path in SOURCES
    assert not ML_DTYPES.search(path.read_text()), rel
    res = children[_module(rel)]
    assert res["ok"], res.get("error")
    assert res["bad"] == [], res["bad"]


def test_no_port_module_imports_ml_dtypes(children):
    res = children["whole"]
    assert res["ok"], res.get("error")
    assert not [n for n in res["bad"] if n.split(".")[0] == "ml_dtypes"]
    for path in SOURCES:
        assert not ML_DTYPES.search(path.read_text()), path


@pytest.mark.parametrize("rel", INPUT_MODULES)
def test_input_pipeline_modules_are_held_to_the_rules(rel, children):
    """The input pipeline's modules are among the sources checked above,
    import no ``ml_dtypes`` and each imports alone (a child process that
    had imported only torch) without loading JAX, Triton or the
    reference, and without building the native IO library."""
    path = PORT / rel
    assert path in SOURCES
    assert not ML_DTYPES.search(path.read_text()), rel
    res = children[_module(rel)]
    assert res["ok"], res.get("error")
    assert res["bad"] == [], res["bad"]


def test_input_pipeline_entry_points_default_to_cuda(monkeypatch):
    """``DevicePrefetcher`` / ``wrap`` with no consumer and
    ``DataLoader(prefetch_to_device=True)`` place on ``cuda:0`` and raise
    without a card; an explicit CPU device runs on the host."""
    import numpy as onp
    from mxnet_tpu_torch.data import DevicePrefetcher, wrap
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        DevicePrefetcher([onp.zeros(2)])
    with pytest.raises(MXNetError, match="no CUDA device"):
        wrap([onp.zeros(2)])
    ds = ArrayDataset(onp.zeros((4, 2), onp.float32))
    with pytest.raises(MXNetError, match="no CUDA device"):
        iter(DataLoader(ds, batch_size=2, prefetch_to_device=True))
    got = list(DataLoader(ds, batch_size=2, prefetch_to_device="cpu"))
    assert [b._data.device.type for b in got] == ["cpu", "cpu"]


def test_native_io_sources_build_outside_the_reference():
    """The native IO library is built from the port's own copies under
    ``csrc/io`` into ``build/``, never from ``src_native`` or into the
    reference's ``lib/``."""
    from mxnet_tpu_torch.io import native
    src = (PORT / "io" / "native.py").read_text()
    assert "src_native" not in src and "Makefile" not in src
    for rel in native.SOURCES:
        assert (PORT / "csrc" / rel).is_file(), rel


@pytest.mark.parametrize("rel", OBSERVABILITY_MODULES)
def test_observability_modules_are_held_to_the_rules(rel, children):
    """The observability slice's modules are among the sources checked
    above, import no ``ml_dtypes``, and each imports alone (a child
    process that had imported only torch) without loading JAX, Triton or
    the reference and without starting a thread (no aggregator, exporter
    or watchdog while their switches are unset)."""
    path = PORT / rel
    assert path in SOURCES
    assert not ML_DTYPES.search(path.read_text()), rel
    res = children[_module(rel)]
    assert res["ok"], res.get("error")
    assert res["bad"] == [], res["bad"]
    assert res["threads"] == ["MainThread"], res["threads"]


@pytest.mark.parametrize("rel", DISTRIBUTION_MODULES)
def test_distribution_modules_are_held_to_the_rules(rel, children):
    """The distribution slice's modules are among the sources checked
    above, import no ``ml_dtypes``, and each imports alone without
    loading JAX, Triton or the reference, without starting a thread, and
    without starting a process group (the group starts at the first
    mesh)."""
    path = PORT / rel
    assert path in SOURCES
    assert not ML_DTYPES.search(path.read_text()), rel
    res = children[_module(rel)]
    assert res["ok"], res.get("error")
    assert res["bad"] == [], res["bad"]
    assert res["threads"] == ["MainThread"], res["threads"]
    assert res["process_group"] is False


@pytest.mark.parametrize("rel", KVSTORE_MODULES)
def test_kvstore_modules_are_held_to_the_rules(rel, children):
    """The kvstore slice's modules are among the sources checked above,
    import no ``ml_dtypes``, and each imports alone without loading JAX,
    Triton or the reference, without starting a thread (no parameter
    server) and without starting a process group (a store starts it)."""
    path = PORT / rel
    assert path in SOURCES
    assert not ML_DTYPES.search(path.read_text()), rel
    res = children[_module(rel)]
    assert res["ok"], res.get("error")
    assert res["bad"] == [], res["bad"]
    assert res["threads"] == ["MainThread"], res["threads"]
    assert res["process_group"] is False


def test_case_bodies_import_no_reference_or_jax():
    """The spawned ranks' case bodies import neither JAX nor the
    reference: they run the port alone."""
    code = CASE_BODIES.read_text()
    ref_import = re.compile(r"\b(?:import|from) mxnet_tpu\b(?!_torch)")
    assert not ref_import.search(code), ref_import.search(code)
    assert not JAX_IMPORT.search(code), JAX_IMPORT.search(code)
    assert not ML_DTYPES.search(code)


def test_a_mesh_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """``make_mesh`` runs on the card unless asked for the CPU: without a
    card it raises before it starts any process group."""
    import torch.distributed as dist
    from mxnet_tpu_torch.parallel import make_mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        make_mesh({"dp": -1})
    assert not dist.is_initialized()


@pytest.mark.parametrize("rel", NUMPY_MODULES)
def test_numpy_front_end_modules_are_held_to_the_rules(rel, children):
    """The numpy front end's modules (``numpy/``, ``numpy_extension/``,
    ``util``, the dispatch protocol, the ``_npi_`` and ``_linalg_`` ops
    and the ViT) are among the sources checked above, and each imports
    alone (a child process that had imported only torch) without loading
    JAX, ``ml_dtypes`` or the reference."""
    path = PORT / rel
    assert path in SOURCES
    assert not ML_DTYPES.search(path.read_text()), rel
    res = children[_module(rel)]
    assert res["ok"], res.get("error")
    assert res["bad"] == [], res["bad"]
