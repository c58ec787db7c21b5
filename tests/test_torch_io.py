"""The port's record files, native IO runtime and ``mx.io`` iterators
against the reference's, on the CPU with the same numpy inputs:

* ``recordio``: files the two packages write are byte-identical (plain
  and indexed, scalar and vector labels, ``pack_img``), and each reads
  the other's;
* the native library (the port's own copy of the C++ under
  ``csrc/io``, built by g++ at first use): its writer's bytes equal the
  Python writer's, and ``ImageRecordIter`` (with ``UInt8`` / ``Int8``)
  gives batches bitwise equal to the reference library's over the same
  ``.rec`` and seed, with random crop and mirror, over two epochs;
* ``NDArrayIter`` (pad, discard, roll over, shuffle under one numpy
  seed), ``CSVIter``, ``ResizeIter``, ``PrefetchingIter`` and
  ``MNISTIter`` give equal batches (exact), as host NDArrays.
"""
import gzip
import os
import struct

import numpy as onp
import pytest

import mxnet_tpu as ref
from mxnet_tpu import recordio as ref_rec
from mxnet_tpu.io import native as ref_native

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import recordio as rec
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.io import native

cv2 = pytest.importorskip("cv2")


def _payloads(n=7, seed=0):
    rng = onp.random.RandomState(seed)
    # lengths 0..3 mod 4 exercise the padding; one payload holds the magic
    out = [rng.bytes(int(k)) for k in rng.randint(0, 40, size=n)]
    out.append(b"ab" + struct.pack("<I", 0xced7230a) + b"cd")
    return out


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_record_files_are_byte_identical(tmp_path, writer):
    bufs = _payloads()
    paths = {}
    for name, mod in (("port", rec), ("ref", ref_rec)):
        p = tmp_path / f"{name}.rec"
        w = mod.MXIndexedRecordIO(str(tmp_path / f"{name}.idx"), str(p), "w")
        for i, b in enumerate(bufs):
            w.write_idx(i, b)
        w.close()
        paths[name] = p
    assert paths["port"].read_bytes() == paths["ref"].read_bytes()
    assert (tmp_path / "port.idx").read_text() == \
        (tmp_path / "ref.idx").read_text()
    # each package reads the other's file, sequentially and by index
    other = rec if writer == "ref" else ref_rec
    r = other.MXRecordIO(str(paths[writer]), "r")
    assert [r.read() for _ in bufs] == bufs and r.read() is None
    r.close()
    ir = other.MXIndexedRecordIO(str(tmp_path / f"{writer}.idx"),
                                 str(paths[writer]), "r")
    assert [ir.read_idx(i) for i in (5, 0, 7)] == [bufs[5], bufs[0],
                                                    bufs[7]]
    ir.close()


def test_pack_and_pack_img_match_the_reference():
    h = rec.IRHeader(0, 3.0, 7, 0)
    assert rec.pack(h, b"xyz") == ref_rec.pack(ref_rec.IRHeader(0, 3.0, 7, 0),
                                               b"xyz")
    vec = rec.pack(rec.IRHeader(0, [1.0, 2.5, -3.0], 9, 1), b"p")
    assert vec == ref_rec.pack(ref_rec.IRHeader(0, [1.0, 2.5, -3.0], 9, 1),
                               b"p")
    hh, payload = rec.unpack(vec)
    hr, pr = ref_rec.unpack(vec)
    assert payload == pr == b"p" and hh.flag == hr.flag == 3
    onp.testing.assert_array_equal(hh.label, hr.label)
    img = (onp.random.RandomState(1).rand(20, 24, 3) * 255).astype(onp.uint8)
    packed = rec.pack_img(rec.IRHeader(0, 1.0, 2, 0), img, quality=90)
    assert packed == ref_rec.pack_img(ref_rec.IRHeader(0, 1.0, 2, 0), img,
                                      quality=90)
    onp.testing.assert_array_equal(rec.unpack_img(packed)[1],
                                   ref_rec.unpack_img(packed)[1])


def test_native_writer_and_reader_cross_the_packages(tmp_path):
    bufs = _payloads(seed=3)
    with native.NativeRecordWriter(str(tmp_path / "n.rec")) as w:
        pos = [w.write(b) for b in bufs]
    py = rec.MXRecordIO(str(tmp_path / "p.rec"), "w")
    for b in bufs:
        py.write(b)
    py.close()
    assert (tmp_path / "n.rec").read_bytes() == \
        (tmp_path / "p.rec").read_bytes()
    with native.NativeRecordReader(str(tmp_path / "p.rec")) as r:
        assert [r.read() for _ in bufs] == bufs and r.read() is None
        r.seek(pos[4])
        assert r.read() == bufs[4]
    with ref_native.NativeRecordReader(str(tmp_path / "n.rec")) as r:
        assert [r.read() for _ in bufs] == bufs


def _jpeg_rec(tmp_path, n=20, seed=5, size=(40, 30)):
    """A .rec of ``n`` JPEG records (random pixels, labels i % 4)."""
    rng = onp.random.RandomState(seed)
    path = str(tmp_path / "img.rec")
    w = rec.MXRecordIO(path, "w")
    for i in range(n):
        img = (rng.rand(size[1], size[0], 3) * 255).astype(onp.uint8)
        w.write(rec.pack(rec.IRHeader(0, float(i % 4), i, 0),
                         native.jpeg_compress(img, quality=95)))
    w.close()
    return path


ITER_KW = dict(batch_size=8, data_shape=(3, 24, 24), shuffle=True,
               rand_crop=True, rand_mirror=True, mean_r=123.68,
               mean_g=116.28, mean_b=103.53, std_r=58.395, std_g=57.12,
               std_b=57.375, seed=11, preprocess_threads=1)


@pytest.mark.parametrize("cls,kw", [
    ("ImageRecordIter", ITER_KW),
    ("ImageRecordIter", dict(batch_size=6, data_shape=(3, 20, 28),
                             preprocess_threads=3, layout="NHWC")),
    ("ImageRecordUInt8Iter", dict(batch_size=8, data_shape=(3, 16, 16),
                                  rand_mirror=True, seed=2,
                                  preprocess_threads=1)),
    ("ImageRecordInt8Iter", dict(batch_size=8, data_shape=(3, 16, 16))),
], ids=["augmented", "threads-nhwc", "uint8", "int8"])
def test_image_record_iter_is_bitwise_the_references(tmp_path, cls, kw):
    path = _jpeg_rec(tmp_path)
    mine = getattr(mt.io, cls)(path, **kw)
    theirs = getattr(ref.io, cls)(path, **kw)
    assert mine.num_records == theirs.num_records == 20
    for epoch in range(2):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in mine]
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in theirs]
        assert len(got) == len(want) == -(-20 // kw["batch_size"])
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            assert gd.dtype == wd.dtype and gd.shape == wd.shape
            onp.testing.assert_array_equal(gd, wd)
            onp.testing.assert_array_equal(gl, wl)
            assert gp == wp
        mine.reset()
        theirs.reset()
    batch = next(iter(mine))
    assert batch.data[0]._data.device.type == "cpu"
    mine.close()
    theirs.close()


def test_jpeg_encoder_round_trips(tmp_path):
    """The test-tooling encoder writes JPEGs cv2 decodes, as close to the
    source pixels at quality 95 as cv2's own encoder (mean abs error
    within 0.5 of cv2's)."""
    rng = onp.random.RandomState(0)
    img = onp.kron(rng.randint(0, 255, (6, 8, 3)),
                   onp.ones((8, 8, 1))).astype(onp.uint8)

    def err(jpeg):
        dec = cv2.imdecode(onp.frombuffer(jpeg, onp.uint8), 1)[:, :, ::-1]
        assert dec.shape == img.shape
        return onp.abs(dec.astype(int) - img.astype(int)).mean()
    theirs = cv2.imencode(".jpg", img[:, :, ::-1],
                          [cv2.IMWRITE_JPEG_QUALITY, 95])[1].tobytes()
    assert err(native.jpeg_compress(img, 95)) <= err(theirs) + 0.5


def test_image_record_iter_raises_without_its_library(monkeypatch):
    from mxnet_tpu_torch.kernels import build

    def no_compiler(*a, **k):
        raise MXNetError("no C++ compiler (g++) to build mxtpu_io")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(build, "build_host_library", no_compiler)
    with pytest.raises(MXNetError, match="g\\+\\+"):
        mt.io.ImageRecordIter("missing.rec", batch_size=2)
    assert not native.available()


def _batches(it):
    return [([d.asnumpy() for d in b.data],
             [l.asnumpy() for l in (b.label or [])], b.pad) for b in it]


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        for a, b in zip(gd + gl, wd + wl):
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
            onp.testing.assert_array_equal(a, b)
        assert gp == wp


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches(handle, shuffle):
    rng = onp.random.RandomState(4)
    data = rng.rand(22, 3).astype(onp.float64)
    label = onp.arange(22)
    its = {}
    for name, mod in (("port", mt), ("ref", ref)):
        onp.random.seed(9)
        its[name] = mod.io.NDArrayIter({"x": data, "y": data * 2}, label,
                                       batch_size=5, shuffle=shuffle,
                                       last_batch_handle=handle)
    for _ in range(2):
        for name in its:
            onp.random.seed(10)
        got, want = _batches(its["port"]), _batches(its["ref"])
        _assert_same(got, want)
        assert [d.name for d in its["port"].provide_data] == \
            [d.name for d in its["ref"].provide_data]
        for it in its.values():
            onp.random.seed(10)
            it.reset()


def test_csv_resize_and_prefetching_iters_match(tmp_path):
    rng = onp.random.RandomState(6)
    data = rng.rand(9, 4).astype(onp.float32)
    label = rng.rand(9).astype(onp.float32)
    onp.savetxt(tmp_path / "d.csv", data, delimiter=",")
    onp.savetxt(tmp_path / "l.csv", label, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 2),
              label_csv=str(tmp_path / "l.csv"), batch_size=4)
    _assert_same(_batches(mt.io.CSVIter(**kw)),
                 _batches(ref.io.CSVIter(**kw)))
    got = _batches(mt.io.ResizeIter(mt.io.NDArrayIter(data, label, 4), 5))
    want = _batches(ref.io.ResizeIter(ref.io.NDArrayIter(data, label, 4), 5))
    _assert_same(got, want)
    pit = mt.io.PrefetchingIter(mt.io.NDArrayIter(data, label, 4))
    for _ in range(2):
        _assert_same(_batches(pit),
                     _batches(ref.io.NDArrayIter(data, label, 4)))
        pit.reset()


def test_mnist_iter_reads_local_idx_files(tmp_path):
    rng = onp.random.RandomState(7)
    imgs = rng.randint(0, 256, (10, 28, 28)).astype(onp.uint8)
    labels = rng.randint(0, 10, 10).astype(onp.uint8)
    with gzip.open(tmp_path / "img.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 10, 28, 28) + imgs.tobytes())
    with open(tmp_path / "lbl", "wb") as f:
        f.write(struct.pack(">II", 2049, 10) + labels.tobytes())
    kw = dict(image=str(tmp_path / "img.gz"), label=str(tmp_path / "lbl"),
              batch_size=4, shuffle=True, seed=3, silent=True)
    for flat in (False, True):
        _assert_same(_batches(mt.io.MNISTIter(flat=flat, **kw)),
                     _batches(ref.io.MNISTIter(flat=flat, **kw)))
    with pytest.raises(MXNetError, match="idx3"):
        mt.io.MNISTIter(image=str(tmp_path / "lbl"), label=kw["label"])


def test_iterator_batches_are_host_ndarrays():
    it = mt.io.NDArrayIter(onp.zeros((4, 2)), onp.zeros(4), batch_size=2)
    b = next(iter(it))
    assert isinstance(b.data[0], mt.nd.NDArray)
    assert b.data[0]._data.device.type == "cpu"
    assert b.data[0].dtype == onp.float32 and b.label[0].dtype == onp.float32
    with pytest.raises(MXNetError, match="not ported yet"):
        mt.io.LibSVMIter("x.libsvm", (4,))
    assert os.path.basename(native.SOURCES[0]) == "recordio.cc"
