"""Persistence in the port against the reference's, on the CPU:
``nd.save`` / ``nd.load`` / ``nd.load_frombuffer`` in both codecs (npz
and the reference's binary ``.params`` format), ``Block.save_parameters``
/ ``load_parameters`` / ``save`` / ``load`` and ``ParameterDict.save`` /
``load``.

Every comparison is exact: a file written by either package loads in the
other with the same dtype and the same bit patterns (bfloat16 compared as
its 16-bit patterns), and both codecs write the same bytes in both
packages.  Arrays load onto the current context (here ``mx.cpu()``).
"""
import ml_dtypes
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon.model_zoo import vision as jax_vision
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JaxLM

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.ndarray import legacy_serialization as port_legacy

DTYPES = ["float32", "float16", "bfloat16", "int32", "bool"]
CODECS = ["npz", "mxnet"]
CONTAINERS = ["single", "list", "dict", "empty_list", "empty_dict"]


def _values(dtype, seed=0):
    rng = onp.random.RandomState(seed)
    a = rng.randn(3, 5) * 4
    if dtype == "bool":
        return [a > 0, (a[:, :2] < 0).copy(), onp.array(True)]
    if dtype == "int32":
        return [a.astype("int32"), a[:1].astype("int32"),
                onp.array(7, "int32")]
    return [a.astype("float32"), a[:, 1:].astype("float32"),
            onp.array(-2.5, "float32")]


def _port(a, dtype):
    return mt.nd.array(a, ctx=mt.cpu(), dtype=dtype)


def _ref(a, dtype):
    return mx.nd.array(a).astype(dtype) if dtype not in ("bool", "int32") \
        else mx.nd.array(a, dtype=dtype)


def _bits(x):
    """The bit patterns of an NDArray of either package, as numpy."""
    if isinstance(x, mt.nd.NDArray):
        t = x._data
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(onp.uint16)
        return t.numpy()
    a = x.asnumpy()
    return a.view(onp.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _dtype_name(x):
    if isinstance(x, mt.nd.NDArray):
        return str(x._data.dtype).replace("torch.", "")
    return str(x.asnumpy().dtype)


def _container(make, dtype, kind):
    vals = [make(a, dtype) for a in _values(dtype)]
    return {"single": vals[0], "list": vals,
            "dict": {"w": vals[0], "blocks.0.b": vals[1], "s": vals[2]},
            "empty_list": [], "empty_dict": {}}[kind]


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert _dtype_name(got) == _dtype_name(want)
        assert got.shape == want.shape
        onp.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kind", CONTAINERS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("codec", CODECS)
def test_save_load_round_trip_and_cross_package(codec, dtype, kind,
                                                tmp_path):
    """The port's file loads in both packages, the reference's in the
    port, with the same values bit for bit; ``load_frombuffer`` reads
    the same bytes; both packages write the same bytes."""
    got_data = _container(_port, dtype, kind)
    ref_data = _container(_ref, dtype, kind)
    pf, rf = str(tmp_path / "port.bin"), str(tmp_path / "ref.bin")
    mt.nd.save(pf, got_data, format=codec)
    mx.nd.save(rf, ref_data, format=codec)
    with open(pf, "rb") as f:
        port_bytes = f.read()
    with open(rf, "rb") as f:
        assert f.read() == port_bytes
    # the binary format has no single-array marker and names no empty
    # container: one array loads as a list of one and an empty dict as an
    # empty list, in both packages
    binary = codec == "mxnet"
    want, ref_want = got_data, ref_data
    if binary and kind == "single":
        want, ref_want = [got_data], [ref_data]
    elif binary and kind == "empty_dict":
        want = ref_want = []
    with mt.cpu():
        for loaded in (mt.nd.load(pf), mt.nd.load(rf),
                       mt.nd.load_frombuffer(port_bytes)):
            _assert_same(loaded, want)
    _assert_same(mx.nd.load(pf), ref_want)


def test_save_format_comes_from_the_environment(tmp_path, monkeypatch):
    """``MXNET_NDARRAY_SAVE_FORMAT=mxnet`` picks the binary codec, which
    ``load`` detects by its magic; an unknown format raises."""
    monkeypatch.setenv("MXNET_NDARRAY_SAVE_FORMAT", "mxnet")
    f = str(tmp_path / "a.params")
    mt.nd.save(f, {"a": _port(onp.ones((2,)), "float32")})
    with open(f, "rb") as fh:
        assert port_legacy.is_mxnet_format(fh.read(8))
    with mt.cpu():
        assert list(mt.nd.load(f)) == ["a"]
    with pytest.raises(MXNetError, match="unknown format"):
        mt.nd.save(f, [], format="hdf5")


def test_loaded_arrays_land_on_the_current_context(tmp_path, monkeypatch):
    """Loaded arrays are placed on the current context: the ``with
    mx.cpu():`` scope; with no scope the default ``gpu(0)``, which
    raises without a card (there is no quiet fallback to the host)."""
    f = str(tmp_path / "a.npz")
    mt.nd.save(f, [_port(onp.ones((2,)), "float32")])
    with mt.cpu():
        assert mt.nd.load(f)[0].context == mt.cpu()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        mt.nd.load(f)


def test_load_finds_the_npz_suffix_and_refuses_garbage(tmp_path):
    f = tmp_path / "w"
    mt.nd.save(str(f) + ".npz", {"a": _port(onp.ones((2,)), "float32")})
    with mt.cpu():
        assert list(mt.nd.load(str(f))) == ["a"]
    bad = tmp_path / "bad"
    bad.write_bytes(b"not an array file at all")
    with pytest.raises(MXNetError):
        mt.nd.load(str(bad))


def test_binary_format_reads_legacy_records_and_refuses_sparse():
    """Pre-V2 records (V1 magic with an int64 shape; the oldest, whose
    magic is the ndim of a uint32 shape) decode as the reference decodes
    them; a row-sparse record raises "not ported yet"."""
    from mxnet_tpu.ndarray import legacy_serialization as ref_legacy
    a = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    w = port_legacy._Writer()
    w.u64(port_legacy.LIST_MAGIC)
    w.u64(0)
    w.u64(2)
    w.u32(port_legacy.NDARRAY_V1_MAGIC)
    w.tshape(a.shape)
    w.i32(1), w.i32(0), w.i32(0)
    w.raw(a.tobytes())
    w.u32(2)                                      # legacy: ndim 2
    w.raw(onp.array(a.shape, "<u4").tobytes())
    w.i32(1), w.i32(0), w.i32(0)
    w.raw(a.tobytes())
    w.u64(0)
    buf = w.getvalue()
    with mt.cpu():
        got = mt.nd.load_frombuffer(buf)
    ref = ref_legacy.decode_list(buf)[0]
    for g, r in zip(got, ref):
        onp.testing.assert_array_equal(g.asnumpy(), r.asnumpy())
    sparse = mx.nd.sparse.row_sparse_array(
        (onp.ones((1, 3), onp.float32), onp.array([1])), shape=(4, 3))
    with pytest.raises(MXNetError, match="not ported yet"):
        with mt.cpu():
            mt.nd.load_frombuffer(ref_legacy.encode_list([sparse], []))


@pytest.mark.parametrize("codec", CODECS)
def test_bfloat16_bits_survive_both_codecs_exactly(codec, tmp_path):
    """Every bfloat16 bit pattern (NaNs included) survives the port's
    writer and the reference's reader, and the port's reader."""
    bits = onp.arange(0, 1 << 16, dtype=onp.uint16)
    t = torch.from_numpy(bits.view(onp.int16).copy()).view(torch.bfloat16)
    f = str(tmp_path / "bits")
    mt.nd.save(f, [mt.nd.NDArray._wrap(t)], format=codec)
    with open(f, "rb") as fh:
        raw = fh.read()
    for back in (mx.nd.load(f)[0], mx.nd.load_frombuffer(raw)[0]):
        back = back.asnumpy().view(onp.uint16)
        onp.testing.assert_array_equal(back, bits)
    with mt.cpu():
        again = mt.nd.load_frombuffer(raw)[0]
    onp.testing.assert_array_equal(_bits(again), bits)


# -- Block and ParameterDict ------------------------------------------------------

LM_CFG = dict(units=64, num_layers=2, num_heads=4, max_len=32,
              tie_weights=True)
LM_VOCAB = 50


def _jax_lm():
    net = JaxLM(LM_VOCAB, **LM_CFG)
    net.initialize(init=mx.initializer.Xavier())
    net(mx.nd.array(onp.zeros((1, 8), onp.int32)))
    return net


def _port_lm(init=None):
    net = TransformerLM(LM_VOCAB, **LM_CFG)
    if init is None:
        net.initialize(ctx=mt.cpu())
        net(torch.zeros((1, 8), dtype=torch.int32))
    else:
        convert.load_collected_params(net, init, device="cpu")
    return net


def _jax_resnet18():
    mx.random.seed(3)
    net = jax_vision.get_resnet(1, 18, classes=10, thumbnail=True)
    net.initialize(init=mx.initializer.Xavier())
    net(mx.nd.array(onp.zeros((1, 3, 16, 16), onp.float32)))
    return net


def _port_resnet18(init=None):
    net = vision.get_resnet(1, 18, classes=10, thumbnail=True)
    net.initialize(ctx=mt.cpu(), init=mt.initializer.Xavier())
    net(torch.zeros((1, 3, 16, 16)))
    if init is not None:
        convert.load_collected_params(net, init, device="cpu")
    return net


def _numpy(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


NETS = {"transformer": (_jax_lm, _port_lm),
        "resnet18": (_jax_resnet18, _port_resnet18)}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("which", sorted(NETS))
def test_save_parameters_crosses_the_packages(which, codec, tmp_path,
                                              monkeypatch):
    """A reference net's ``save_parameters`` loads into a port net made
    with other weights (and the reverse), every parameter exact; the
    load writes into the port's tensors in place."""
    monkeypatch.setenv("MXNET_NDARRAY_SAVE_FORMAT", codec)
    make_ref, make_port = NETS[which]
    ref = make_ref()
    want = _numpy(ref)
    ref.save_parameters(str(tmp_path / "ref.params"))
    port = make_port()
    held = {k: p._tensor() for k, p in port.collect_params().items()}
    port.load_parameters(str(tmp_path / "ref.params"))
    got = convert.collected_params_to_numpy(port)
    assert sorted(got) == sorted(want)
    for k in want:
        onp.testing.assert_array_equal(got[k], want[k])
        assert port.collect_params()[k]._tensor() is held[k], k
    # the reverse: the port's file into a fresh reference net
    port.save_parameters(str(tmp_path / "port.params"))
    again = make_ref()
    again.load_parameters(str(tmp_path / "port.params"))
    for k, v in _numpy(again).items():
        onp.testing.assert_array_equal(v, want[k])


def test_block_save_and_load_by_prefix(tmp_path):
    """``save(prefix)`` / ``load(prefix)`` use ``prefix + ".params"``."""
    ref = _jax_lm()
    port = _port_lm(_numpy(ref))
    port.save(str(tmp_path / "lm"))
    assert (tmp_path / "lm.params").is_file()
    other = _port_lm()
    other.load(str(tmp_path / "lm"))
    for k, v in convert.collected_params_to_numpy(other).items():
        onp.testing.assert_array_equal(v, _numpy(ref)[k])


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(4, in_units=3), pkg.gluon.nn.Dense(2,
                                                                in_units=4))
    if pkg is mt:
        net.initialize(ctx=mt.cpu())
    else:
        net.initialize()
    return net


def test_missing_and_extra_names_raise_as_in_the_reference(tmp_path):
    """A file without a parameter raises unless ``allow_missing``; a file
    with names the net lacks raises unless ``ignore_extra``: the same
    outcomes in both packages.  ``arg:`` / ``aux:`` prefixes are
    dropped; an unnamed list is refused."""
    w = onp.ones((4, 3), onp.float32)
    files = {}
    for pkg in (mx, mt):
        ctx = {"ctx": mt.cpu()} if pkg is mt else {}
        d = str(tmp_path / f"{pkg.__name__}")
        pkg.nd.save(d + "_part", {"0.weight": pkg.nd.array(w, **ctx)})
        pkg.nd.save(d + "_extra", {
            **{k: p.data() for k, p in _mlp(pkg).collect_params().items()},
            "9.weight": pkg.nd.array(w, **ctx)})
        pkg.nd.save(d + "_argaux", {
            "arg:" + k: p.data() for k, p in _mlp(pkg).collect_params()
            .items()})
        pkg.nd.save(d + "_list", [pkg.nd.array(w, **ctx)])
        files[pkg] = d
    for pkg, errors in ((mx, mx.base.MXNetError), (mt, MXNetError)):
        for src in (mx, mt):
            d = files[src]
            net = _mlp(pkg)
            with pytest.raises(errors, match="missing"):
                net.load_parameters(d + "_part")
            net.load_parameters(d + "_part", allow_missing=True)
            onp.testing.assert_array_equal(
                net.collect_params()["0.weight"].data().asnumpy(), w)
            with pytest.raises(errors, match="extra"):
                net.load_parameters(d + "_extra")
            net.load_parameters(d + "_extra", ignore_extra=True)
            net.load_parameters(d + "_argaux")
            with pytest.raises(errors, match="unnamed"):
                net.load_parameters(d + "_list")


def test_load_parameters_rejects_a_wrong_shape(tmp_path):
    f = str(tmp_path / "w.params")
    mt.nd.save(f, {"0.weight": _port(onp.ones((5, 3)), "float32"),
                   "0.bias": _port(onp.ones((4,)), "float32"),
                   "1.weight": _port(onp.ones((2, 4)), "float32"),
                   "1.bias": _port(onp.ones((2,)), "float32")})
    with pytest.raises(MXNetError, match="shape"):
        _mlp(mt).load_parameters(f)


@pytest.mark.parametrize("strip,restore", [("", ""), ("0.", ""),
                                           ("", "net.")])
def test_parameter_dict_save_and_load_with_prefixes(strip, restore,
                                                    tmp_path):
    """``ParameterDict.save(strip_prefix)`` / ``load(restore_prefix)``
    name the entries as the reference's do, and a file of one package
    loads in the other."""
    names, values = {}, {}
    for pkg in (mx, mt):
        net = _mlp(pkg)
        params = net.collect_params()
        values[pkg] = {k: p.data().asnumpy() for k, p in params.items()}
        f = str(tmp_path / pkg.__name__)
        if restore:
            # a file whose names carry the prefix the load restores
            pkg.nd.save(f, {restore + k: p.data()
                            for k, p in params.items()})
        else:
            params.save(f, strip_prefix=strip)
        with (mt.cpu() if pkg is mt else mx.cpu()):
            names[pkg] = sorted(pkg.nd.load(f))
    assert names[mt] == names[mx]
    for src in (mx, mt):
        for pkg in (mx, mt):
            dst = _mlp(pkg).collect_params()
            f = str(tmp_path / src.__name__)
            if strip:
                with pytest.raises(Exception, match="missing"):
                    dst.load(f, restore_prefix=restore)
                continue
            dst.load(f, restore_prefix=restore)
            for k, p in dst.items():
                onp.testing.assert_array_equal(p.data().asnumpy(),
                                               values[src][k])
