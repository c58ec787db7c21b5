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


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_names_no_reference_or_jax(path):
    code = path.read_text()
    assert not REFERENCE.search(code), REFERENCE.search(code)
    assert not JAX_IMPORT.search(code), JAX_IMPORT.search(code)


def test_importing_the_whole_port_loads_no_jax_or_reference():
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import mxnet_tpu_torch
        for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                       "mxnet_tpu_torch."):
            importlib.import_module(m.name)
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.")
                     or n == "mxnet_tpu" or n.startswith("mxnet_tpu."))
        print(len([n for n in sys.modules
                   if n.startswith("mxnet_tpu_torch")]), bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20 and bad.strip() == "[]", out.stdout


def test_importing_the_whole_port_loads_no_triton():
    """Every kernel of the port is CUDA C++ behind ctypes: no module
    imports Triton, at import time or otherwise."""
    script = textwrap.dedent("""
        import importlib, pkgutil, sys
        import mxnet_tpu_torch
        for m in pkgutil.walk_packages(mxnet_tpu_torch.__path__,
                                       "mxnet_tpu_torch."):
            importlib.import_module(m.name)
        print(sorted(n for n in sys.modules
                     if n == "triton" or n.startswith("triton.")))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for path in SOURCES:
        assert not re.search(r"\bimport triton\b|\bfrom triton\b",
                             path.read_text()), path


def test_bare_import_builds_nothing():
    """``import mxnet_tpu_torch`` alone starts no process (no nvcc),
    loads no built kernel library, builds nothing, and imports no
    Triton, JAX or reference module."""
    script = textwrap.dedent("""
        import sys
        events = []

        def hook(event, args):
            if event == "subprocess.Popen":
                events.append(("popen", str(args[0])))
            elif event == "ctypes.dlopen" and "torch_kernels" in str(
                    args[0]):
                events.append(("dlopen", str(args[0])))

        sys.addaudithook(hook)
        import mxnet_tpu_torch
        from mxnet_tpu_torch.kernels import build
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("triton", "jax", "mxnet_tpu"))
        print(events, bad, sorted(build._LIBS))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] [] []", out.stdout


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
    assert net.embed.weight.data().device.type == "cpu"
    with pytest.raises(MXNetError, match="device='cpu'"):
        SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="adam")
    tr = SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="adam",
                     device="cpu")
    assert tr.device.type == "cpu"


RESNET_MODULES = ["ops/nn.py", "ops/optimizer_ops.py",
                  "optimizer/optimizer.py", "gluon/parameter.py",
                  "gluon/block.py", "gluon/nn/basic_layers.py",
                  "gluon/nn/conv_layers.py",
                  "gluon/model_zoo/vision/__init__.py",
                  "gluon/model_zoo/vision/resnet.py", "parallel/trainer.py"]


@pytest.mark.parametrize("rel", RESNET_MODULES)
def test_resnet_path_modules_are_held_to_the_rules(rel):
    """The ResNet path's modules are among the sources checked above, and
    each imports alone in a fresh process without loading JAX or the
    reference."""
    path = PORT / rel
    assert path in SOURCES
    mod = "mxnet_tpu_torch." + rel[:-3].replace("/", ".").removesuffix(
        ".__init__")
    script = textwrap.dedent(f"""
        import importlib, sys
        importlib.import_module({mod!r})
        print(sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "mxnet_tpu", "triton")))
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


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
