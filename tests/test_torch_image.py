"""``mx.image`` of the port against the reference's, on the CPU with the
same numpy inputs and seeds (Python's ``random`` and numpy's generator):

* decoding (``imdecode`` / ``imread``, cv2 here) and the crop helpers
  exact; resizing (``imresize``, ``resize_short``, the resizing crops)
  within 1 on uint8 output and 1e-4 of 255 on float output — the
  reference's ``jax.image.resize`` weights in float32, summed in another
  order;
* every augmenter and the ``CreateAugmenter`` chain: exact where no sum
  is taken, else within 1e-4 of 255;
* ``ImageIter`` over a record file, over an image list and over a
  ``.lst`` of files: equal batches (float32 within 1e-4 of 255);
* ``imrotate`` / ``copyMakeBorder`` within 1e-4 of 255 / exact.
"""
import random

import numpy as onp
import pytest

import mxnet_tpu as ref
from mxnet_tpu import image as rimg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import image as pimg
from mxnet_tpu_torch import recordio as rec

cv2 = pytest.importorskip("cv2")
TOL = 1e-4 * 255


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else onp.asarray(x)


def _close(got, want, exact=False):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if exact:
        onp.testing.assert_array_equal(got, want)
    elif got.dtype == onp.uint8:
        assert onp.abs(got.astype(int) - want.astype(int)).max() <= 1
    else:
        onp.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _img(h=30, w=40, seed=0, dtype=onp.uint8):
    rng = onp.random.RandomState(seed)
    return (rng.rand(h, w, 3) * 255).astype(dtype)


def _both(fn, img, seed=0):
    out = []
    for mod, nd in ((pimg, lambda a: mt.nd.array(a, ctx=mt.cpu(),
                                                  dtype=a.dtype)),
                    (rimg, lambda a: ref.nd.array(a, dtype=a.dtype))):
        random.seed(seed)
        onp.random.seed(seed)
        out.append(fn(mod, nd(img)))
    return out


def test_decode_and_read_match(tmp_path):
    img = _img()
    buf = cv2.imencode(".png", img)[1].tobytes()
    _close(pimg.imdecode(buf), rimg.imdecode(buf), exact=True)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    _close(pimg.imread(str(tmp_path / "a.png")),
           rimg.imread(str(tmp_path / "a.png")), exact=True)
    assert pimg.imdecode(buf)._data.device.type == "cpu"


@pytest.mark.parametrize("name,fn,exact", [
    ("imresize_down", lambda m, x: m.imresize(x, 17, 11), False),
    ("imresize_up", lambda m, x: m.imresize(x, 53, 47, interp=2), False),
    ("resize_short", lambda m, x: m.resize_short(x, 20), False),
    ("fixed_crop", lambda m, x: m.fixed_crop(x, 3, 4, 10, 12), True),
    ("fixed_crop_size", lambda m, x: m.fixed_crop(x, 3, 4, 10, 12,
                                                  size=(8, 9)), False),
    ("center_crop", lambda m, x: m.center_crop(x, (16, 10))[0], True),
    ("random_crop", lambda m, x: m.random_crop(x, (16, 10))[0], True),
    ("random_size_crop", lambda m, x: m.random_size_crop(
        x, (12, 12), (0.3, 1.0), (0.75, 1.33))[0], False),
], ids=lambda v: v if isinstance(v, str) else "")
def test_geometry_helpers_match(name, fn, exact):
    for seed in (0, 3):
        got, want = _both(fn, _img(), seed)
        _close(got, want, exact)
    assert pimg.scale_down((30, 20), (40, 40)) == rimg.scale_down(
        (30, 20), (40, 40))


AUGS = {
    "resize": (lambda m: m.ResizeAug(18), False),
    "force_resize": (lambda m: m.ForceResizeAug((14, 9)), False),
    "center_crop": (lambda m: m.CenterCropAug((12, 12)), True),
    "random_crop": (lambda m: m.RandomCropAug((12, 12)), True),
    "sized_crop": (lambda m: m.RandomSizedCropAug((10, 10), 0.2,
                                                  (0.75, 1.33)), False),
    "flip": (lambda m: m.HorizontalFlipAug(0.5), True),
    "cast": (lambda m: m.CastAug(), True),
    "normalize": (lambda m: m.SequentialAug([
        m.CastAug(), m.ColorNormalizeAug(onp.array([120., 110., 100.]),
                                         onp.array([50., 60., 70.]))]),
        True),
    "brightness": (lambda m: m.SequentialAug([
        m.CastAug(), m.BrightnessJitterAug(0.3)]), True),
    "contrast": (lambda m: m.SequentialAug([
        m.CastAug(), m.ContrastJitterAug(0.3)]), False),
    "saturation": (lambda m: m.SequentialAug([
        m.CastAug(), m.SaturationJitterAug(0.3)]), False),
    "hue": (lambda m: m.SequentialAug([m.CastAug(), m.HueJitterAug(0.2)]),
            False),
    "color_jitter": (lambda m: m.SequentialAug([
        m.CastAug(), m.ColorJitterAug(0.2, 0.2, 0.2)]), False),
    "lighting": (lambda m: m.SequentialAug([m.CastAug(), m.LightingAug(
        0.1, [55.46, 4.794, 1.148], [[-0.5675, 0.7192, 0.4009],
                                     [-0.5808, -0.0045, -0.814],
                                     [-0.5836, -0.6948, 0.4203]])]), True),
    "gray": (lambda m: m.SequentialAug([m.CastAug(), m.RandomGrayAug(1.0)]),
             False),
    "order": (lambda m: m.RandomOrderAug([m.CastAug(),
                                          m.HorizontalFlipAug(1.0)]), True),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenters_match(name):
    make, exact = AUGS[name]
    for seed in (0, 1):
        got, want = _both(lambda m, x: make(m)(x), _img(seed=seed), seed)
        _close(got, want, exact)


@pytest.mark.parametrize("kw", [
    dict(resize=24, rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(rand_crop=True, rand_resize=True, brightness=0.1, contrast=0.1,
         saturation=0.1, hue=0.1, pca_noise=0.1, rand_gray=0.5),
], ids=["standard", "all-jitters"])
def test_create_augmenter_chain_matches(kw):
    def run(m, x):
        for aug in m.CreateAugmenter((3, 16, 16), **kw):
            x = aug(x)
        return x
    for seed in (0, 2):
        got, want = _both(run, _img(seed=seed), seed)
        _close(got, want)


def test_image_iter_matches(tmp_path):
    imgs = [_img(24, 20, seed=i) for i in range(7)]
    path = str(tmp_path / "x.rec")
    w = rec.MXIndexedRecordIO(str(tmp_path / "x.idx"), path, "w")
    for i, im in enumerate(imgs):
        w.write_idx(i, rec.pack_img(rec.IRHeader(0, float(i), i, 0), im,
                                    img_fmt=".png"))
    w.close()
    lst = tmp_path / "x.lst"
    with open(lst, "w") as f:
        for i, im in enumerate(imgs[:3]):
            cv2.imwrite(str(tmp_path / f"{i}.png"), im)
            f.write(f"{i}\t{float(i)}\t{i}.png\n")
    sources = [dict(path_imgrec=path, shuffle=True),
               dict(imglist=[[float(i), im] for i, im in enumerate(imgs)]),
               dict(path_imglist=str(lst), path_root=str(tmp_path))]
    for src in sources:
        its = []
        for m in (pimg, rimg):
            random.seed(4)
            its.append(m.ImageIter(3, (3, 16, 16), aug_list=m.CreateAugmenter(
                (3, 16, 16), rand_crop=True, rand_mirror=True), **src))
        for _ in range(2):
            random.seed(5)
            got = [(b.data[0], b.label[0], b.pad) for b in its[0]]
            random.seed(5)
            want = [(b.data[0], b.label[0], b.pad) for b in its[1]]
            assert len(got) == len(want)
            for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
                _close(gd, wd)
                _close(gl, wl, exact=True)
                assert gp == wp
            for it in its:
                random.seed(6)
                it.reset()


def test_rotate_and_border_match():
    for deg, kw in ((30.0, {}), (-75.0, {"zoom_in": True}),
                    (45.0, {"zoom_out": True})):
        got, want = _both(lambda m, x: m.imrotate(x, deg, **kw),
                          _img(dtype=onp.float32))
        _close(got, want)
        got, want = _both(lambda m, x: m.imrotate(x, deg, **kw), _img())
        _close(got, want)
    got, want = _both(lambda m, x: m.copyMakeBorder(x, 1, 2, 3, 4,
                                                    value=7.0), _img())
    _close(got, want, exact=True)
    got, want = _both(lambda m, x: m.copyMakeBorder(
        x, 2, 1, 0, 3, values=[1, 2, 3]), _img())
    _close(got, want, exact=True)
