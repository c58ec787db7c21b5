"""``gluon.data`` of the port against the reference's, on the CPU with the
same numpy inputs and seeds:

* datasets (``ArrayDataset``, ``SimpleDataset``, ``RecordFileDataset``,
  ``filter`` / ``shard`` / ``take`` / ``sample`` / ``transform`` /
  ``transform_first``), the samplers and the batchify functions give the
  reference's items and batches (exact);
* ``DataLoader`` under one numpy seed gives the reference's batches
  (exact), synchronously, with the ``num_workers=0`` prefetch thread,
  with 2 forked process workers (shared memory on and off) and with the
  thread pool, each held against the reference's synchronous loader;
  every loader has ``timeout=`` set, so a stuck worker fails the test
  instead of hanging it;
* the vision transforms under one seed of Python's ``random`` and
  numpy's generator: the exact ones bitwise, the ones that sum (contrast,
  saturation, hue, the resizing ones) within 1e-4 of 255 (float32
  rounding: the sums run in another order; a hybridized chain within 2
  ulps, XLA fusing its divisions); the vision datasets (the
  synthetic fallbacks, an image folder, an image record file, an image
  list) exact.
"""
import os
import random

import numpy as onp
import pytest

import mxnet_tpu as ref
from mxnet_tpu import recordio as ref_rec
from mxnet_tpu.gluon import data as rdata
from mxnet_tpu.gluon.data.vision import transforms as RT

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import recordio as rec
from mxnet_tpu_torch.gluon import data as pdata
from mxnet_tpu_torch.gluon.data.vision import transforms as PT

TIMEOUT = 30


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(e) for e in x]
    if hasattr(x, "asnumpy"):
        return x.asnumpy()
    return onp.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert a.shape == b.shape, (a.shape, b.shape)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    onp.testing.assert_array_equal(a, b)


def _arrays(n=20, seed=0):
    rng = onp.random.RandomState(seed)
    return rng.rand(n, 3).astype(onp.float32), onp.arange(n)


def test_dataset_ops_match():
    x, y = _arrays()
    for mod in (pdata, rdata):
        ds = mod.ArrayDataset(x, y)
        assert len(ds) == 20
    p, r = pdata.ArrayDataset(x, y), rdata.ArrayDataset(x, y)
    views = [
        lambda d: d.filter(lambda s: s[1] % 3 == 0),
        lambda d: d.shard(3, 1), lambda d: d.shard(3, 2),
        lambda d: d.take(7),
        lambda d: d.sample(pdata.SequentialSampler(5, start=4)),
        lambda d: d.transform(lambda a, b: (a * 2, b + 1)),
        lambda d: d.transform(lambda a, b: (a - 1, b), lazy=False),
        lambda d: d.transform_first(lambda a: a + 0.5),
    ]
    for view in views:
        vp, vr = view(p), view(r)
        assert len(vp) == len(vr)
        for i in range(len(vp)):
            _same(list(vp[i]), list(vr[i]))
    assert list(pdata.SimpleDataset([1, 2, 3])) == [1, 2, 3]


def test_record_file_dataset_reads_either_packages_file(tmp_path):
    path = str(tmp_path / "d.rec")
    w = ref_rec.MXIndexedRecordIO(str(tmp_path / "d.idx"), path, "w")
    for i in range(6):
        w.write_idx(i, bytes([i]) * (i + 1))
    w.close()
    p, r = pdata.RecordFileDataset(path), rdata.RecordFileDataset(path)
    assert len(p) == len(r) == 6
    assert [p[i] for i in range(6)] == [r[i] for i in range(6)]


@pytest.mark.parametrize("make", [
    lambda m: m.SequentialSampler(9, start=2),
    lambda m: m.RandomSampler(11),
    lambda m: m.IntervalSampler(10, 3),
    lambda m: m.IntervalSampler(10, 3, rollover=False),
    lambda m: m.BatchSampler(m.SequentialSampler(10), 4, "keep"),
    lambda m: m.BatchSampler(m.SequentialSampler(10), 4, "discard"),
    lambda m: m.BatchSampler(m.SequentialSampler(10), 4, "rollover"),
    lambda m: m.BucketSampler([3, 9, 4, 1, 7, 12, 2, 5, 8, 6], 2,
                              num_buckets=3, seed=4),
    lambda m: m.BucketSampler([3, 9, 4, 1, 7, 12], 2, bucket_keys=[4, 8],
                              shuffle=False, last_batch="discard"),
], ids=["sequential", "random", "interval", "interval-norollover",
        "batch-keep", "batch-discard", "batch-rollover", "bucket",
        "bucket-keys"])
def test_samplers_match(make):
    onp.random.seed(3)
    sp = make(pdata)
    onp.random.seed(3)
    sr = make(rdata)
    for _ in range(2):          # a second epoch: rollover carries over
        onp.random.seed(5)
        a = list(sp)
        onp.random.seed(5)
        assert a == list(sr)
        assert len(sp) == len(sr)
    filt = pdata.FilterSampler(lambda v: v > 2, [1, 5, 3, 0])
    assert list(filt) == list(rdata.FilterSampler(lambda v: v > 2,
                                                  [1, 5, 3, 0]))


def test_batchify_functions_match():
    from mxnet_tpu.gluon.data import batchify as rb
    from mxnet_tpu_torch.gluon.data import batchify as pb
    rng = onp.random.RandomState(2)
    same = [rng.rand(2, 3).astype(onp.float32) for _ in range(4)]
    ragged = [rng.randint(0, 9, (k,)).astype(onp.int64) for k in (3, 1, 5)]
    _same(pb.Stack()(same), rb.Stack()(same))
    _same(pb.Pad(val=-1)(ragged), rb.Pad(val=-1)(ragged))
    _same(pb.Pad(val=0, round_to=4, dtype="float32")(ragged),
          rb.Pad(val=0, round_to=4, dtype="float32")(ragged))
    _same(pb.Append()(ragged), rb.Append()(ragged))
    _same(pb.Append(expand=False)(ragged), rb.Append(expand=False)(ragged))
    samples = list(zip(same[:3], ragged))
    _same(list(pb.Group(pb.Stack(), pb.Pad(val=7))(samples)),
          list(rb.Group(rb.Stack(), rb.Pad(val=7))(samples)))
    assert pb.AsList()(["a", "b"]) == rb.AsList()(["a", "b"])


def _image_set(n=24, seed=1):
    rng = onp.random.RandomState(seed)
    return ((rng.rand(n, 10, 12, 3) * 255).astype(onp.uint8),
            rng.randint(0, 5, n))


def _loader_batches(mod, nd, t, x, y, seed, **kw):
    ds = mod.ArrayDataset(nd(x), y).transform_first(
        t.Compose([t.ToTensor(), t.Normalize((0.5, 0.4, 0.3),
                                             (0.2, 0.25, 0.3))]))
    onp.random.seed(seed)
    loader = mod.DataLoader(ds, batch_size=5, shuffle=True,
                            timeout=TIMEOUT, **kw)
    out = []
    for _ in range(2):
        out.append([_np(b) for b in loader])
    return out


def _port_nd(a):
    return mt.nd.array(a, ctx=mt.cpu(), dtype=a.dtype)


@pytest.mark.parametrize("kw", [
    {}, {"prefetch": 2}, {"last_batch": "discard"},
    {"last_batch": "rollover"},
    {"num_workers": 2}, {"num_workers": 2, "use_shared_mem": False},
    {"num_workers": 2, "thread_pool": True},
], ids=["sync", "prefetch-thread", "discard", "rollover", "workers-shm",
        "workers-pipe", "thread-pool"])
def test_dataloader_matches_the_reference(kw):
    """The reference runs synchronously: its JAX transforms cannot run in
    a forked worker of a process that has started JAX (it hangs), and its
    workers give the same batches as its synchronous path."""
    x, y = _image_set()
    got = _loader_batches(pdata, _port_nd, PT, x, y, 7, **kw)
    sync = {k: v for k, v in kw.items()
            if k not in ("num_workers", "use_shared_mem", "thread_pool")}
    want = _loader_batches(rdata, ref.nd.array, RT, x, y, 7, **sync)
    _same(got, want)


def test_dataloader_env_and_host_batches(monkeypatch):
    from mxnet_tpu_torch.gluon.data import dataloader as dl
    monkeypatch.setenv("MXNET_DATALOADER_SHM", "0")
    x, y = _arrays()
    loader = pdata.DataLoader(pdata.ArrayDataset(x, y), batch_size=4,
                              num_workers=2, timeout=TIMEOUT)
    assert not loader._use_shm
    batches = list(loader)
    assert all(b[0]._data.device.type == "cpu" for b in batches)
    monkeypatch.setenv("MXNET_MP_START_METHOD", "forkserver")
    assert dl._mp_context().get_start_method() == "forkserver"
    monkeypatch.setenv("MXNET_MP_START_METHOD", "bogus")
    assert dl._mp_context().get_start_method() == "fork"
    onp.testing.assert_array_equal(
        dl.default_mp_batchify_fn([(_port_nd(x[0]), 1), (_port_nd(x[1]), 2)]
                                  )[0], x[:2])


def _run_transform(make, mod_t, nd, img, seed):
    random.seed(seed)
    onp.random.seed(seed)
    t = make(mod_t)
    return _np(t(nd(img)))


EXACT = {
    "to_tensor": lambda T: T.ToTensor(),
    "normalize": lambda T: T.Compose([T.ToTensor(),
                                      T.Normalize((0.4, 0.5, 0.6),
                                                  (0.2, 0.3, 0.4))]),
    "cast": lambda T: T.Cast("float16"),
    "center_crop": lambda T: T.CenterCrop((9, 7)),
    "flip_lr": lambda T: T.RandomFlipLeftRight(),
    "flip_tb": lambda T: T.RandomFlipTopBottom(),
    "brightness": lambda T: T.RandomBrightness(0.3),
    "random_crop": lambda T: T.RandomCrop(8),
    "random_crop_pad": lambda T: T.RandomCrop((10, 9), pad=2),
    "crop": lambda T: T.CropResize(2, 1, 6, 5),
    "lighting": lambda T: T.Compose([T.Cast("float32"),
                                     T.RandomLighting(0.5)]),
    "gray": lambda T: T.RandomGray(1.0),
    "apply": lambda T: T.RandomApply(T.RandomBrightness(0.5), p=0.7),
}
CLOSE = {
    "contrast": lambda T: T.RandomContrast(0.4),
    "saturation": lambda T: T.RandomSaturation(0.4),
    "hue": lambda T: T.RandomHue(0.3),
    "jitter": lambda T: T.RandomColorJitter(0.2, 0.2, 0.2, 0.1),
    "resize_down": lambda T: T.Resize((7, 5)),
    "resize_up": lambda T: T.Resize(19),
    "resized_crop": lambda T: T.RandomResizedCrop(8),
    "crop_resize": lambda T: T.CropResize(1, 2, 8, 6, size=(5, 4)),
    "rotate": lambda T: T.Rotate(17.0),
    "rotation": lambda T: T.RandomRotation((-30, 30), zoom_in=True),
    "random_crop_up": lambda T: T.RandomCrop(20),
}


@pytest.mark.parametrize("name", sorted(EXACT) + sorted(CLOSE))
def test_transforms_match(name):
    rng = onp.random.RandomState(4)
    img = (rng.rand(14, 12, 3) * 255).astype(onp.uint8)
    if name in ("lighting",):
        img = img.astype(onp.float32)
    for seed in (0, 1, 2):
        make = EXACT.get(name) or CLOSE[name]
        got = _run_transform(make, PT, _port_nd, img, seed)
        want = _run_transform(make, RT, ref.nd.array, img, seed)
        assert got.shape == want.shape and got.dtype == want.dtype
        if name in EXACT:
            onp.testing.assert_array_equal(got, want)
        elif got.dtype == onp.uint8:
            assert onp.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            onp.testing.assert_allclose(got, want, rtol=0,
                                        atol=1e-4 * 255)


def test_transform_on_a_batch_and_hybrid_compose():
    rng = onp.random.RandomState(5)
    imgs = (rng.rand(3, 9, 8, 3) * 255).astype(onp.uint8)
    got = _np(PT.HybridCompose([PT.ToTensor(), PT.Normalize(0.5, 0.2)])(
        _port_nd(imgs)))
    want = _np(RT.HybridCompose([RT.ToTensor(), RT.Normalize(0.5, 0.2)])(
        ref.nd.array(imgs)))
    # the reference compiles the hybridized chain as one XLA program,
    # which may reassociate the divisions: within 2 float32 ulps
    onp.testing.assert_allclose(got, want, rtol=2.4e-7, atol=5e-7)
    onp.testing.assert_allclose(
        _np(PT.Resize((4, 5))(_port_nd(imgs))),
        _np(RT.Resize((4, 5))(ref.nd.array(imgs))), rtol=0, atol=1e-4 * 255)


def test_vision_datasets_match(tmp_path):
    from mxnet_tpu.gluon.data import vision as rv
    from mxnet_tpu_torch.gluon.data import vision as pv
    for name in ("MNIST", "FashionMNIST", "CIFAR10", "CIFAR100"):
        kw = dict(root=str(tmp_path / "none"), train=False)
        p, r = getattr(pv, name)(**kw), getattr(rv, name)(**kw)
        assert p.synthetic and r.synthetic and len(p) == len(r)
        for i in (0, 7, len(p) - 1):
            _same(list(p[i]), list(r[i]))
    rng = onp.random.RandomState(6)
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / "folder" / cls)
        for i in range(2):
            onp.save(tmp_path / "folder" / cls / f"{i}.npy",
                     (rng.rand(4, 5, 3) * 255).astype(onp.uint8))
    p = pv.ImageFolderDataset(str(tmp_path / "folder"))
    r = rv.ImageFolderDataset(str(tmp_path / "folder"))
    assert p.synsets == r.synsets and len(p) == len(r) == 4
    for i in range(4):
        _same(list(p[i]), list(r[i]))
    path = str(tmp_path / "im.rec")
    w = rec.MXIndexedRecordIO(str(tmp_path / "im.idx"), path, "w")
    imgs = [(rng.rand(6, 7, 3) * 255).astype(onp.uint8) for _ in range(3)]
    for i, im in enumerate(imgs):
        w.write_idx(i, rec.pack_img(rec.IRHeader(0, float(i), i, 0), im))
    w.close()
    p, r = pv.ImageRecordDataset(path), rv.ImageRecordDataset(path)
    for i in range(3):
        _same(p[i][0], r[i][0])
        assert p[i][1] == r[i][1]
    lst = [[float(i), im] for i, im in enumerate(imgs)]
    p, r = pv.ImageListDataset(imglist=lst), rv.ImageListDataset(imglist=lst)
    for i in range(3):
        _same(p[i][0], r[i][0])
        assert p[i][1] == r[i][1]
