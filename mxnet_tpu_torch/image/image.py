"""Image utilities + ImageIter (counterpart of ``mxnet_tpu/image/image.py``).

Parity: python/mxnet/image/image.py (imread/imdecode/imresize, crop
helpers, Augmenter chain via CreateAugmenter, ImageIter over .rec files).

Resizing reproduces ``jax.image.resize`` (the reference's): ``"linear"``
is a triangle kernel that is widened by the scale when downsampling (an
antialiased filter), with the same float32 weight matrices, contracted
here with ``torch.einsum`` — the results agree to float32 rounding, not
bitwise, since the sums run in another order (a float result within
1e-3 of the reference's on 0..255 data, a uint8 one within 1).
``"nearest"`` takes the same source pixels exactly.  The image ops run
on whatever device the array lies on; decoding is on the host (cv2,
else PIL, else ``.npy`` payloads).
"""
from __future__ import annotations

import functools
import math
import os
import random as pyrandom
from typing import List

import numpy as onp
import torch

from ..base import MXNetError
from ..io.io import DataBatch, DataDesc, DataIter, host_nd
from ..ndarray import NDArray
from ..ops.registry import apply_torch

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "ImageIter",
           "CreateAugmenter", "Augmenter", "resize"]


def _cv2():
    try:
        import cv2
        return cv2
    except ImportError:
        return None


# -- resize: jax.image.resize's weights -----------------------------------

@functools.lru_cache(maxsize=256)
def _linear_weights(in_size: int, out_size: int) -> torch.Tensor:
    """The (in_size, out_size) float32 weight matrix of
    ``jax.image.resize(..., "linear")`` along one axis
    (``jax/_src/image/scale.py`` ``compute_weight_mat``, antialiased,
    translation 0)."""
    f32 = torch.float32
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=f32) + 0.5)
                * torch.tensor(inv_scale, dtype=f32)
                - torch.tensor(0.0 * inv_scale, dtype=f32) - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() \
        / torch.tensor(kernel_scale, dtype=f32)
    w = torch.clamp(1 - x.abs(), min=0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(onp.finfo(onp.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(in_size: int, out_size: int) -> torch.Tensor:
    off = (torch.arange(out_size, dtype=torch.float32) + 0.5) * in_size \
        / out_size
    return torch.floor(off).to(torch.int64)


def resize(a: torch.Tensor, shape, method: str = "linear") -> torch.Tensor:
    """``jax.image.resize(a, shape, method)`` on a tensor: ``"linear"``
    (antialiased triangle) or ``"nearest"``.  Only axes whose size
    changes are touched; "linear" returns float32 (integer input is
    promoted), "nearest" keeps the dtype."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != a.dim():
        raise MXNetError(f"resize: shape {shape} has {len(shape)} axes, "
                         f"the array {a.dim()}")
    dims = [d for d in range(a.dim()) if a.shape[d] != shape[d]]
    if method == "nearest":
        for d in dims:
            idx = _nearest_index(a.shape[d], shape[d]).to(a.device)
            a = a.index_select(d, idx)
        return a
    if method != "linear":
        raise MXNetError(f"resize: unsupported method {method!r}")
    if not a.is_floating_point():
        a = a.to(torch.float32)
    if not dims:
        return a
    letters = "abcdefghijklmnopqrstuvwxyz"
    ins = list(letters[:a.dim()])
    outs = list(ins)
    operands, specs = [a], ["".join(ins)]
    for i, d in enumerate(dims):
        new = letters[a.dim() + i].upper()
        w = _linear_weights(a.shape[d], shape[d]).to(a.device, a.dtype)
        operands.append(w)
        specs.append(ins[d] + new)
        outs[d] = new
    return torch.einsum(",".join(specs) + "->" + "".join(outs), *operands)


def _interp(interp) -> str:
    """cv2-style interpolation code → resize method (0 nearest, else
    linear), as the reference maps it."""
    return "linear" if interp else "nearest"


def _t(src) -> torch.Tensor:
    return src._data if isinstance(src, NDArray) else torch.as_tensor(
        onp.asarray(src))


def _as_nd(x):
    """An NDArray input as it is; anything else as a host NDArray."""
    return x if isinstance(x, NDArray) else host_nd(onp.asarray(x))


# -- decoding --------------------------------------------------------------

def imread(filename, flag=1, to_rgb=True) -> NDArray:
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(filename, flag)
        if img is None:
            raise MXNetError(f"cannot read image {filename}")
        if to_rgb and img.ndim == 3:
            img = img[:, :, ::-1]
        return host_nd(onp.ascontiguousarray(img))
    try:
        from PIL import Image
        img = onp.asarray(Image.open(filename).convert(
            "RGB" if flag else "L"))
        return host_nd(img)
    except ImportError:
        if filename.endswith(".npy"):
            return host_nd(onp.load(filename))
        raise MXNetError("no image backend (cv2/PIL) available")


def imdecode(buf, flag=1, to_rgb=True) -> NDArray:
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imdecode(onp.frombuffer(buf, dtype=onp.uint8), flag)
        if img is None:
            raise MXNetError("image decode failed")
        if to_rgb and img.ndim == 3:
            img = img[:, :, ::-1]
        return host_nd(onp.ascontiguousarray(img))
    import io as _io
    try:
        return host_nd(onp.load(_io.BytesIO(buf)))
    except Exception:
        from PIL import Image
        img = onp.asarray(Image.open(_io.BytesIO(buf)))
        return host_nd(img)


# -- geometry --------------------------------------------------------------

def imresize(src, w, h, interp=1) -> NDArray:
    a = _t(src)
    out = resize(a.to(torch.float32), (h, w) + tuple(a.shape[2:]),
                 _interp(interp))
    return NDArray._wrap(out.to(a.dtype))


def resize_short(src, size, interp=2) -> NDArray:
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2) -> NDArray:
    out = NDArray._wrap(_t(src)[y0:y0 + h, x0:x0 + w])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None) -> NDArray:
    out = src - mean if not isinstance(mean, (int, float)) or mean else src
    if std is not None:
        out = out / std
    return out


def _matmul(a: torch.Tensor, m) -> torch.Tensor:
    """``jnp.dot(a, m)`` with numpy's type promotion (an integer image
    times a float32 matrix is float32)."""
    m = torch.as_tensor(m).to(a.device)
    dt = torch.promote_types(a.dtype, m.dtype)
    return a.to(dt) @ m.to(dt)


class Augmenter:
    """Base augmenter (parity: image.py Augmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src: NDArray) -> NDArray:
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return NDArray._wrap(torch.flip(_t(src), dims=(1,)))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = mean
        self.std = std

    def __call__(self, src):
        dev = _t(src).device
        mean = NDArray._wrap(torch.as_tensor(onp.asarray(
            self.mean, onp.float32)).to(dev))
        std = NDArray._wrap(torch.as_tensor(onp.asarray(
            self.std, onp.float32)).to(dev))
        return color_normalize(src, mean, std)


def scale_down(src_size, size):
    """Scale size down so it fits in src_size, keeping aspect ratio
    (parity: image.py scale_down)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random-area/aspect crop then resize (parity: image.py
    random_size_crop — the inception-style crop)."""
    h, w = src.shape[0], src.shape[1]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (onp.log(ratio[0]), onp.log(ratio[1]))
        new_ratio = onp.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(onp.sqrt(target_area * new_ratio)))
        new_h = int(round(onp.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    # fallback: center crop (parity behavior)
    return center_crop(src, size, interp)


class ForceResizeAug(Augmenter):
    """Force-resize to exact (w, h), ignoring aspect (parity:
    image.py ForceResizeAug)."""

    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomSizedCropAug(Augmenter):
    """Inception-style random area/aspect crop (parity: image.py
    RandomSizedCropAug)."""

    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class BrightnessJitterAug(Augmenter):
    """src *= 1 + U(-b, b) (parity: image.py BrightnessJitterAug)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return NDArray._wrap(_t(src) * alpha)


_GRAY = onp.array([0.299, 0.587, 0.114], onp.float32)


class ContrastJitterAug(Augmenter):
    """Blend with the mean gray level (parity: image.py
    ContrastJitterAug)."""

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        x = _t(src)
        gray = (x * torch.from_numpy(_GRAY).to(x.device)).sum()
        gray = (3.0 * (1.0 - alpha) / x.numel()) * gray
        return NDArray._wrap(x * alpha + gray)


class SaturationJitterAug(Augmenter):
    """Blend with the per-pixel gray image (parity: image.py
    SaturationJitterAug)."""

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        x = _t(src)
        gray = (x * torch.from_numpy(_GRAY).to(x.device)).sum(
            dim=-1, keepdim=True)
        return NDArray._wrap(x * alpha + gray * (1.0 - alpha))


class HueJitterAug(Augmenter):
    """Rotate hue via the YIQ linear approximation (parity: image.py
    HueJitterAug)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u = onp.cos(alpha * onp.pi)
        w = onp.sin(alpha * onp.pi)
        bt = onp.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], onp.float32)
        tyiq = onp.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], onp.float32)
        ityiq = onp.array([[1.0, 0.956, 0.621],
                           [1.0, -0.272, -0.647],
                           [1.0, -1.107, 1.705]], onp.float32)
        t = onp.dot(onp.dot(ityiq, bt), tyiq)
        return NDArray._wrap(_matmul(_t(src), onp.ascontiguousarray(t.T)))


class ColorJitterAug(Augmenter):
    """Random order of brightness/contrast/saturation jitter (parity:
    image.py ColorJitterAug, a RandomOrderAug of the three jitters)."""

    def __init__(self, brightness, contrast, saturation):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        augs = []
        if brightness > 0:
            augs.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            augs.append(ContrastJitterAug(contrast))
        if saturation > 0:
            augs.append(SaturationJitterAug(saturation))
        self._order = RandomOrderAug(augs)

    def __call__(self, src):
        return self._order(src)


class LightingAug(Augmenter):
    """AlexNet-style PCA lighting noise (parity: image.py LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = onp.asarray(eigval, onp.float32)
        self.eigvec = onp.asarray(eigvec, onp.float32)

    def __call__(self, src):
        alpha = onp.random.normal(0, self.alphastd, size=(3,))
        rgb = onp.dot(self.eigvec * alpha, self.eigval)
        x = _t(src)
        return NDArray._wrap(x + torch.from_numpy(
            rgb.astype(onp.float32)).to(x.device))


class RandomGrayAug(Augmenter):
    """Randomly convert to 3-channel gray (parity: image.py
    RandomGrayAug)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self._mat = onp.array([[0.21, 0.21, 0.21],
                               [0.72, 0.72, 0.72],
                               [0.07, 0.07, 0.07]], onp.float32)

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return NDArray._wrap(_matmul(_t(src), self._mat))
        return src


class SequentialAug(Augmenter):
    """Apply augmenters in order (parity: image.py SequentialAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in self.ts:
            src = t(src)
        return src


class RandomOrderAug(Augmenter):
    """Apply augmenters in random order (parity: image.py
    RandomOrderAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        order = list(self.ts)
        pyrandom.shuffle(order)
        for t in order:
            src = t(src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Parity: image.py CreateAugmenter — builds the standard augmenter
    chain."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = onp.array([55.46, 4.794, 1.148])
        eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = onp.array([123.68, 116.28, 103.53])
    if std is True:
        std = onp.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Image iterator over .rec/.lst/raw files (parity: image.py ImageIter
    over the C++ ImageRecordIter); batches are host NDArrays."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None, **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self._records = []
        if path_imgrec:
            from ..recordio import MXIndexedRecordIO, MXRecordIO
            idx = os.path.splitext(path_imgrec)[0] + ".idx"
            if os.path.exists(idx):
                rec = MXIndexedRecordIO(idx, path_imgrec, "r")
                for k in rec.keys:
                    self._records.append(("rec", rec, k))
            else:
                rec = MXRecordIO(path_imgrec, "r")
                while True:
                    buf = rec.read()
                    if buf is None:
                        break
                    self._records.append(("raw", buf, None))
        elif imglist is not None:
            for entry in imglist:
                self._records.append(("list", entry[1], entry[0]))
        elif path_imglist:
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = float(parts[1])
                    self._records.append(
                        ("file", os.path.join(path_root, parts[-1]), label))
        self.shuffle = shuffle
        self._order = list(range(len(self._records)))
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self.cur = 0
        if self.shuffle:
            pyrandom.shuffle(self._order)

    def _read_one(self, i):
        kind, src, extra = self._records[self._order[i]]
        from ..recordio import unpack_img
        if kind == "rec":
            header, img = unpack_img(src.read_idx(extra))
            label = float(header.label if onp.isscalar(header.label)
                          else header.label[0])
            return host_nd(img), label
        if kind == "raw":
            header, img = unpack_img(src)
            label = float(header.label if onp.isscalar(header.label)
                          else header.label[0])
            return host_nd(img), label
        if kind == "file":
            return imread(src), extra
        img, label = src, extra
        return _as_nd(img), float(label)

    def next(self):
        if self.cur >= len(self._records):
            raise StopIteration
        datas, labels = [], []
        read_cur, pad = self.cur, 0
        for _ in range(self.batch_size):
            if read_cur >= len(self._records):
                read_cur = 0    # pad the final batch by wraparound
            img, label = self._read_one(read_cur)
            read_cur += 1
            self.cur += 1
            if self.cur > len(self._records):
                pad += 1        # this sample is padding, not fresh data
            for aug in self.auglist:
                img = aug(img)
            arr = img.asnumpy()
            if arr.ndim == 3 and arr.shape[-1] in (1, 3):
                arr = arr.transpose(2, 0, 1)  # HWC -> CHW
            datas.append(arr)
            labels.append(label)
        # cur past the end ⇒ epoch over; next call raises StopIteration
        return DataBatch([host_nd(onp.stack(datas))],
                         [host_nd(onp.asarray(labels, dtype=onp.float32))],
                         pad=pad)

    def iter_next(self):
        return self.cur < len(self._records)


def _rotate_tensor(a: torch.Tensor, degrees, zoom_in=False,
                   zoom_out=False) -> torch.Tensor:
    """Bilinear rotation of an HWC / NHWC tensor about the image center,
    zeros outside (the reference's ``_rotate``, in float32)."""
    rad = math.radians(degrees)
    c, s = math.cos(rad), math.sin(rad)
    if zoom_in and zoom_out:
        raise ValueError("zoom_in and zoom_out are mutually exclusive")
    k = abs(c) + abs(s)
    zoom = (1.0 / k) if zoom_in else (k if zoom_out else 1.0)
    c, s = c * zoom, s * zoom
    H, W = a.shape[-3], a.shape[-2]
    f32 = torch.float32
    dev = a.device
    yy = torch.arange(H, dtype=f32, device=dev) - (H - 1) / 2.0
    xx = torch.arange(W, dtype=f32, device=dev) - (W - 1) / 2.0
    gy, gx = torch.meshgrid(yy, xx, indexing="ij")
    # inverse-rotate output coords into source space
    sx = c * gx + s * gy + (W - 1) / 2.0
    sy = -s * gx + c * gy + (H - 1) / 2.0
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    wx = sx - x0
    wy = sy - y0
    af = a.to(f32)

    def sample(yi, xi):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        yi = torch.clamp(yi, 0, H - 1).to(torch.int64)
        xi = torch.clamp(xi, 0, W - 1).to(torch.int64)
        v = af[..., yi, xi, :]
        return v * inb[..., None]

    out = (sample(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + sample(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
           + sample(y0 + 1, x0) * (wy * (1 - wx))[..., None]
           + sample(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    if a.is_floating_point():
        return out.to(a.dtype)
    return torch.clamp(out, 0, 255).to(a.dtype)


def _rotate(x, degrees, zoom_in=False, zoom_out=False):
    """Rotation of an HWC / NHWC NDArray or tensor (parity:
    image.imrotate); a tensor in, a tensor out."""
    if isinstance(x, torch.Tensor):
        return _rotate_tensor(x, degrees, zoom_in, zoom_out)
    return apply_torch(lambda a: _rotate_tensor(a, degrees, zoom_in,
                                                zoom_out), [_as_nd(x)])


def imrotate(src, rotation_degrees, zoom_in=False, zoom_out=False):
    """Rotate an HWC/NHWC image by ``rotation_degrees`` about its
    center (parity: image.imrotate — bilinear sampling; zoom_in crops
    so no fill pixels show, zoom_out fits the whole source)."""
    return _rotate(src, rotation_degrees, zoom_in, zoom_out)


def copyMakeBorder(src, top, bot, left, right, type=0, value=0.0,  # noqa: A002
                   values=None):
    """Pad the H/W axes of an HWC (or NHWC) image with a constant
    border (parity: image.copyMakeBorder / cv2 signature).  Only
    ``type=0`` (BORDER_CONSTANT) is implemented; ``values`` gives a
    per-channel fill color."""
    if type != 0:
        raise NotImplementedError(
            "copyMakeBorder: only type=0 (BORDER_CONSTANT) is "
            "implemented")
    top, bot, left, right = int(top), int(bot), int(left), int(right)

    def fn(a):
        pads = (0, 0, left, right, top, bot)
        if values is None:
            return torch.nn.functional.pad(a, pads, value=value)
        out = torch.nn.functional.pad(a, pads)
        fill = torch.as_tensor(onp.asarray(values)).to(a.device, a.dtype)
        h, w = out.shape[-3], out.shape[-2]
        mask = torch.zeros((h, w), dtype=torch.bool, device=a.device)
        mask[top:h - bot, left:w - right] = True
        return torch.where(mask[..., None], out, fill)

    return apply_torch(fn, [_as_nd(src)])
