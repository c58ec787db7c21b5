"""``HybridBlock.export`` / ``SymbolBlock.imports`` of the port against
the reference's on the CPU (``tests/test_export.py``'s cases): the same
numpy weights and inputs through both packages' hybridized forward and
the port's imported export (float32, rtol 1e-5); an export that reaches
K1 and K6, whose program names the port's custom ops, loaded in a fresh
process that never sees the defining class; both ``.params`` formats;
the serving engine over an imported block, under
``MXNET_ARTIFACT_DIR``; ``SPMDTrainer.warm_start`` and
``cost_analysis``.
"""
import base64
import io
import json
import os
import subprocess
import sys

import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ndarray import NDArray

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.gluon.block import SymbolBlock
from mxnet_tpu_torch.ops import attention as attn_ops
from mxnet_tpu_torch.ops import layernorm_residual as lnr_ops

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _on_the_host():
    with mt.cpu():
        yield


def _close(got, ref, rtol=RTOL):
    got, ref = onp.asarray(got), onp.asarray(ref)
    assert got.shape == ref.shape
    onp.testing.assert_allclose(got, ref, rtol=rtol,
                                atol=rtol * max(1.0, float(abs(ref).max())))


def _make_net(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Conv2D(8, kernel_size=3, padding=1,
                                activation="relu"))
    net.add(pkg.gluon.nn.BatchNorm())
    net.add(pkg.gluon.nn.MaxPool2D(pool_size=2))
    net.add(pkg.gluon.nn.Flatten())
    net.add(pkg.gluon.nn.Dense(16, activation="relu"))
    net.add(pkg.gluon.nn.Dense(4))
    return net


def _x(seed, batch=2):
    return onp.random.RandomState(seed).randn(batch, 3, 8, 8) \
        .astype("float32")


def _port_net(x):
    mt.random.seed(1)
    net = _make_net(mt)
    net.initialize(init=mt.initializer.Xavier(), device="cpu")
    net(mt.nd.array(x))
    net.hybridize()
    return net


def _programs(sym_file):
    with open(sym_file) as f:
        manifest = json.load(f)
    return manifest, [torch.export.load(io.BytesIO(
        base64.b64decode(n["payload"]))) for n in manifest["nodes"]]


def _targets(prog):
    return [str(n.target) for n in prog.graph.nodes
            if n.op == "call_function"]


@pytest.mark.parametrize("params_format", ["npz", "mxnet"])
def test_export_import_same_process(tmp_path, params_format):
    """The imported export equals the hybridized forward bitwise; the
    ``.params`` in MXNet's format also loads into the reference's net,
    which computes the same forward (rtol 1e-5)."""
    x = _x(0)
    net = _port_net(x)
    ref_out = net(mt.nd.array(x)).asnumpy()
    sym_file, param_file = net.export(str(tmp_path / "model"), epoch=0,
                                      params_format=params_format)
    manifest, progs = _programs(sym_file)
    assert manifest["format"] == "mxnet_tpu_torch-export-v1"
    assert manifest["params"] == list(net.collect_params().keys())
    assert len(manifest["nodes"]) == 1 and \
        manifest["nodes"][0]["inputs"] == [{"shape": [2, 3, 8, 8],
                                            "dtype": "float32"}]
    loaded = SymbolBlock.imports(sym_file, ["data"], param_file)
    onp.testing.assert_array_equal(loaded(mt.nd.array(x)).asnumpy(),
                                   ref_out)
    if params_format == "mxnet":
        # MXNet's binary format, arg: / aux: prefixes: the reference's
        # net loads it and computes the same forward
        ref = _make_net(mx)
        ref.initialize()
        ref(NDArray(x))
        ref.load_parameters(param_file)
        _close(ref(NDArray(x)).asnumpy(), ref_out)


def test_export_requires_forward(tmp_path):
    net = _make_net(mt)
    net.initialize(init=mt.initializer.Xavier(), device="cpu")
    net.hybridize()
    with pytest.raises(MXNetError, match="hybridize"):
        net.export(str(tmp_path / "m"))
    net(mt.nd.array(_x(0)))           # the first call: deferred init only
    with mt.autograd.record():
        net(mt.nd.array(_x(0)))
    with pytest.raises(MXNetError):
        net.export(str(tmp_path / "m"))


class _AttnLNR(mt.gluon.HybridBlock):
    """A block whose forward reaches K1 (flash attention) and K6
    (``layer_norm_residual``)."""

    def __init__(self, units=16, heads=2):
        super().__init__()
        self._heads = heads
        self.qkv = nn.Dense(3 * units, flatten=False)
        self.gamma = mt.gluon.Parameter("gamma", shape=(units,),
                                        init=mt.initializer.One())
        self.beta = mt.gluon.Parameter("beta", shape=(units,),
                                       init=mt.initializer.Zero())

    def forward(self, x):
        u = x.shape[-1]
        qkv = self.qkv(x)
        attn = attn_ops.multi_head_attention(
            qkv[..., :u], qkv[..., u:2 * u], qkv[..., 2 * u:],
            num_heads=self._heads, causal=True)
        return lnr_ops.layer_norm_residual(attn, x, self.gamma._tensor(),
                                           self.beta._tensor())


def test_export_reaching_k1_and_k6_loads_in_a_fresh_process(tmp_path):
    """Exports of the conv net and of a block reaching K1 and K6 run in
    a process that never imports their classes, equal to the in-process
    forward; the program keeps the kernels as the port's custom ops."""
    x = _x(1)
    conv = _port_net(x)
    conv_out = conv(mt.nd.array(x)).asnumpy()
    conv_files = conv.export(str(tmp_path / "conv"))
    mt.random.seed(2)
    blk = _AttnLNR()
    blk.initialize(init=mt.initializer.Xavier(), device="cpu")
    h = onp.random.RandomState(2).randn(2, 8, 16).astype("float32")
    blk(mt.nd.array(h))
    blk.hybridize()
    blk_out = blk(mt.nd.array(h)).asnumpy()
    blk_files = blk.export(str(tmp_path / "attn"))
    _, (prog,) = _programs(blk_files[0])
    targets = _targets(prog)
    assert targets.count("mxnet_tpu_torch.flash_attention.default") == 1
    assert targets.count("mxnet_tpu_torch.layer_norm_residual.default") == 1
    onp.save(tmp_path / "x.npy", x)
    onp.save(tmp_path / "h.npy", h)
    script = f"""
import sys
import numpy as onp
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import SymbolBlock
with mt.cpu():
    for stem, files in (("x", {conv_files!r}), ("h", {blk_files!r})):
        net = SymbolBlock.imports(files[0], ["data"], files[1])
        x = mt.nd.array(onp.load({str(tmp_path)!r} + "/" + stem + ".npy"))
        onp.save({str(tmp_path)!r} + "/out_" + stem + ".npy",
                 net(x).asnumpy())
assert "test_torch_export" not in sys.modules
"""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-c", script], check=True, env=env,
                   cwd=str(tmp_path), timeout=300)
    onp.testing.assert_array_equal(onp.load(tmp_path / "out_x.npy"),
                                   conv_out)
    onp.testing.assert_array_equal(onp.load(tmp_path / "out_h.npy"),
                                   blk_out)


def test_exported_lm_names_one_k1_a_layer(tmp_path):
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    mt.random.seed(3)
    lm = TransformerLM(64, units=16, num_layers=3, num_heads=2, max_len=16,
                       tie_weights=True)
    lm.initialize(device="cpu")
    ids = onp.random.RandomState(3).randint(0, 64, (2, 8)).astype("int32")
    lm(mt.nd.array(ids, dtype="int32"))
    lm.hybridize()
    for n in (1, 2):
        want = lm(mt.nd.array(ids[:n], dtype="int32")).asnumpy()
    files = lm.export(str(tmp_path / "lm"))
    manifest, progs = _programs(files[0])
    assert sorted(n["inputs"][0]["shape"][0] for n in manifest["nodes"]) \
        == [1, 2]
    assert all(n["vocabs"] == [64] for n in manifest["nodes"])
    for prog in progs:
        assert _targets(prog).count(
            "mxnet_tpu_torch.flash_attention.default") == 3
    loaded = SymbolBlock.imports(files[0], ["data"], files[1])
    onp.testing.assert_array_equal(
        loaded(mt.nd.array(ids[:2], dtype="int32")).asnumpy(), want)
    bad = ids[:1].copy()
    bad[0, 0] = 64
    with pytest.raises(MXNetError, match="Embedding ids"):
        loaded(mt.nd.array(bad, dtype="int32"))


def test_serving_an_imported_block_under_the_artifact_dir(tmp_path,
                                                          monkeypatch):
    """The engine's buckets are the exported batch sizes; a row equals
    the imported forward of its padded batch, also under
    ``MXNET_ARTIFACT_DIR``."""
    from mxnet_tpu_torch.serving import InferenceEngine, ServingServer
    x = _x(4, batch=4)
    net = _port_net(x)
    for n in (2, 4):
        net(mt.nd.array(x[:n]))
    files = net.export(str(tmp_path / "srv"))
    loaded = SymbolBlock.imports(files[0], ["data"], files[1])
    monkeypatch.setenv("MXNET_ARTIFACT_DIR", str(tmp_path / "artifacts"))
    eng = InferenceEngine(loaded)
    assert eng._bucket_sizes == [2, 4] and eng.example_shape == (3, 8, 8)
    results, meta = eng.infer_batch(list(x[:3]))
    assert meta["padded"] == 4 and meta["compiled"]
    padded = onp.concatenate([x[:3], onp.zeros_like(x[:1])])
    want = loaded(mt.nd.array(padded)).asnumpy()
    onp.testing.assert_array_equal(onp.stack(results), want[:3])
    srv = ServingServer(loaded, start=True)
    try:
        got = srv.predict(x[0])
    finally:
        srv.stop()
    want2 = loaded(mt.nd.array(onp.concatenate(
        [x[:1], onp.zeros_like(x[:1])]))).asnumpy()
    onp.testing.assert_array_equal(onp.asarray(got), want2[0])


def test_trainer_warm_start_and_cost_analysis():
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer
    net = _make_net(mt)
    net.initialize(init=mt.initializer.Xavier(), device="cpu")
    x = _x(5)
    net(mt.nd.array(x))
    tr = SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1},
                     device="cpu")
    assert tr.warm_start() == 0
    y = onp.array([1, 3], "int32")
    before = {k: p._data.detach().clone()
              for k, p in net.collect_params().items()}
    cost = tr.cost_analysis(x, y)
    for k, p in net.collect_params().items():
        torch.testing.assert_close(p._data, before[k], rtol=0, atol=0)
    # conv 2·(2·8·8·8·27) and the two dense layers, forward; the
    # backward twice that (the input's gradient is not taken)
    fwd = 2 * (2 * 8 * 8 * 8 * 27 + 2 * 128 * 16 + 2 * 16 * 4)
    assert fwd * 2 <= cost["flops"] <= fwd * 3
    assert cost["argument_size_in_bytes"] >= sum(
        v.numel() * 4 for v in before.values())
    assert set(cost["unfilled"]) == set(SPMDTrainer.COST_KEYS_UNFILLED)
