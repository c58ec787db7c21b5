"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``).

Parity: python/mxnet/gluon/data/vision/transforms/ (ToTensor, Normalize,
Resize, CenterCrop, RandomResizedCrop, RandomFlip*, Cast, Compose) over
src/operator/image/ ops.  Each forward works on the tensor of the
NDArray it is called with (``Block.__call__`` unwraps it), on the
array's own device, so a transform in a DataLoader worker stays on the
host; a numpy input is taken as a host array.  The random transforms
draw from Python's ``random`` and numpy's global generator, as the
reference's do, so seeding both gives the reference's draws.  Resizing
is ``image.image.resize``, the reference's ``jax.image.resize`` weights
(float32 rounding apart).
"""
from __future__ import annotations

import math
import random as pyrandom

import numpy as onp
import torch

from ....image.image import _interp, _rotate, resize
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "HybridCompose", "Cast", "ToTensor", "Normalize",
           "Resize", "CenterCrop", "CropResize", "RandomCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomLighting", "RandomColorJitter", "RandomApply",
           "HybridRandomApply", "RandomGray", "RandomHue", "Rotate",
           "RandomRotation"]


def _t(x) -> torch.Tensor:
    """The forward's input as a tensor (a numpy array lies on the host)."""
    if isinstance(x, torch.Tensor):
        return x
    if hasattr(x, "_data"):
        return x._data
    return torch.from_numpy(onp.ascontiguousarray(x))


def _back(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A float result cast back to ``like``'s dtype: floats as they are,
    integers clipped to 0..255 first (the reference's image rule)."""
    if like.is_floating_point():
        return out.to(like.dtype)
    return torch.clamp(out, 0, 255).to(like.dtype)


class Compose(Sequential):
    """Parity: transforms.Compose."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        from ....base import torch_dtype
        return _t(x).to(torch_dtype(self._dtype))


class ToTensor(HybridBlock):
    """HWC uint8 → CHW float32 in [0,1] (parity: image to_tensor op)."""

    def forward(self, x):
        a = _t(x).to(torch.float32) / 255.0
        if a.dim() == 3:
            return a.permute(2, 0, 1).contiguous()
        return a.permute(0, 3, 1, 2).contiguous()


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = onp.asarray(mean, dtype=onp.float32)
        self._std = onp.asarray(std, dtype=onp.float32)

    def forward(self, x):
        a = _t(x)

        def const(v):
            t = torch.from_numpy(v).to(a.device)
            return t.reshape((-1,) + (1,) * (a.dim() - 1)) if v.ndim else t
        return (a - const(self._mean)) / const(self._std)


class Resize(HybridBlock):
    """Resize HWC image (parity: image resize op)."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        a = _t(x).to(torch.float32)
        h, w = self._size[1], self._size[0]
        if a.dim() == 3:
            return resize(a, (h, w, a.shape[2]))
        return resize(a, (a.shape[0], h, w, a.shape[3]))


class CenterCrop(HybridBlock):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        a = _t(x)
        w, h = self._size
        H, W = a.shape[-3], a.shape[-2]
        y0 = max((H - h) // 2, 0)
        x0 = max((W - w) // 2, 0)
        return a[..., y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(HybridBlock):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        a = _t(x)
        H, W = a.shape[-3], a.shape[-2]
        area = H * W
        for _ in range(10):
            target_area = pyrandom.uniform(*self._scale) * area
            log_ratio = (math.log(self._ratio[0]), math.log(self._ratio[1]))
            aspect = math.exp(pyrandom.uniform(*log_ratio))
            w = int(round(math.sqrt(target_area * aspect)))
            h = int(round(math.sqrt(target_area / aspect)))
            if 0 < w <= W and 0 < h <= H:
                x0 = pyrandom.randint(0, W - w)
                y0 = pyrandom.randint(0, H - h)
                break
        else:
            w, h, x0, y0 = W, H, 0, 0
        ow, oh = self._size
        crop = a[..., y0:y0 + h, x0:x0 + w, :].to(torch.float32)
        return resize(crop, tuple(crop.shape[:-3]) + (oh, ow, crop.shape[-1]))


class _RandomFlip(HybridBlock):
    _axis = -2

    def forward(self, x):
        a = _t(x)
        if pyrandom.random() < 0.5:
            return a
        return torch.flip(a, dims=(self._axis,))


class RandomFlipLeftRight(_RandomFlip):
    _axis = -2


class RandomFlipTopBottom(_RandomFlip):
    _axis = -3


class RandomBrightness(HybridBlock):
    def __init__(self, brightness):
        super().__init__()
        self._b = brightness

    def forward(self, x):
        alpha = 1.0 + pyrandom.uniform(-self._b, self._b)
        return _t(x) * alpha


def _float(a: torch.Tensor) -> torch.Tensor:
    return a if a.is_floating_point() else a.to(torch.float32)


class RandomContrast(HybridBlock):
    def __init__(self, contrast):
        super().__init__()
        self._c = contrast

    def forward(self, x):
        alpha = 1.0 + pyrandom.uniform(-self._c, self._c)
        a = _t(x)
        gray = _float(a).mean()
        return a * alpha + gray * (1 - alpha)


class RandomSaturation(HybridBlock):
    def __init__(self, saturation):
        super().__init__()
        self._s = saturation

    def forward(self, x):
        alpha = 1.0 + pyrandom.uniform(-self._s, self._s)
        a = _t(x)
        gray = _float(a).mean(dim=-1, keepdim=True)
        return a * alpha + gray * (1 - alpha)


class RandomLighting(HybridBlock):
    """AlexNet-style PCA noise (parity: transforms RandomLighting)."""

    _eigval = onp.array([55.46, 4.794, 1.148], dtype=onp.float32)
    _eigvec = onp.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.814],
                         [-0.5836, -0.6948, 0.4203]], dtype=onp.float32)

    def __init__(self, alpha):
        super().__init__()
        self._alpha_std = alpha

    def forward(self, x):
        alpha = onp.random.normal(0, self._alpha_std, size=(3,)) \
            .astype(onp.float32)
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        a = _t(x)
        return a + torch.from_numpy(rgb).to(a.device)


class RandomColorJitter(HybridBlock):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._ts = []
        if brightness:
            self._ts.append(RandomBrightness(brightness))
        if contrast:
            self._ts.append(RandomContrast(contrast))
        if saturation:
            self._ts.append(RandomSaturation(saturation))
        if hue:
            self._ts.append(RandomHue(hue))

    def forward(self, x):
        ts = list(self._ts)
        pyrandom.shuffle(ts)
        x = _t(x)
        for t in ts:
            x = t.forward(x)
        return x


class HybridCompose(Compose):
    """Parity: transforms.HybridCompose — a Compose that hybridizes its
    chain."""

    def __init__(self, transforms):
        super().__init__(transforms)
        self.hybridize()


class RandomApply(Block):
    """Apply ``transform`` with probability p (parity: RandomApply)."""

    def __init__(self, transforms, p=0.5):
        super().__init__()
        self.transforms = transforms
        self.p = p

    def forward(self, x):
        if pyrandom.random() < self.p:
            return self.transforms(x)
        return x


class HybridRandomApply(RandomApply):
    """Parity: HybridRandomApply.  The choice is a host coin, as in the
    reference (transforms run eagerly between steps)."""


class RandomCrop(Block):
    """Random crop with optional padding (parity: RandomCrop over
    image random_crop + copyMakeBorder).  Sources smaller than the crop
    upsample first, like the reference's random_crop."""

    def __init__(self, size, pad=None, pad_value=0, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        if pad is not None and not isinstance(pad, int) and len(pad) != 4:
            raise ValueError(
                f"RandomCrop pad must be an int or a 4-tuple (t,b,l,r), "
                f"got {pad!r}")
        self._pad = (pad,) * 4 if isinstance(pad, int) else pad
        self._pad_value = pad_value
        self._interp = _interp(interpolation)

    def forward(self, x):
        a = _t(x)
        w, h = self._size
        if self._pad:
            t, b, l, r = self._pad
            a = torch.nn.functional.pad(a, (0, 0, l, r, t, b),
                                        value=self._pad_value)
        H, W = a.shape[-3], a.shape[-2]
        if H < h or W < w:      # upsample small sources, then crop
            scale = max(h / H, w / W)
            nh, nw = max(h, int(round(H * scale))), \
                max(w, int(round(W * scale)))
            out = resize(a.to(torch.float32),
                         tuple(a.shape[:-3]) + (nh, nw, a.shape[-1]),
                         self._interp)
            a = _back(out, a)
            H, W = nh, nw
        y0 = pyrandom.randint(0, max(H - h, 0)) if H > h else 0
        x0 = pyrandom.randint(0, max(W - w, 0)) if W > w else 0
        return a[..., y0:y0 + h, x0:x0 + w, :]


class CropResize(HybridBlock):
    """Fixed crop then resize (parity: transforms.CropResize)."""

    def __init__(self, x0, y0, width, height, size=None, interpolation=1):
        super().__init__()
        self._box = (int(x0), int(y0), int(width), int(height))
        self._size = ((size, size) if isinstance(size, int)
                      else tuple(size) if size else None)
        self._interp = _interp(interpolation)

    def forward(self, x):
        a = _t(x)
        x0, y0, w, h = self._box
        crop = a[..., y0:y0 + h, x0:x0 + w, :]
        if self._size is None:
            return crop
        ow, oh = self._size
        return resize(crop.to(torch.float32),
                      tuple(crop.shape[:-3]) + (oh, ow, crop.shape[-1]),
                      self._interp)


class RandomGray(Block):
    """Convert to 3-channel grayscale with probability p (parity:
    transforms.RandomGray)."""

    def __init__(self, p=0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        a = _t(x)
        if pyrandom.random() >= self.p:
            return a
        lum = (0.299 * a[..., 0] + 0.587 * a[..., 1]
               + 0.114 * a[..., 2]).to(a.dtype)
        return torch.stack([lum, lum, lum], dim=-1)


class RandomHue(Block):
    """Random hue jitter in [max(0,1-hue), 1+hue] (parity: RandomHue
    over image random_hue — the reference's fast YIQ-rotation
    approximation)."""

    def __init__(self, hue):
        super().__init__()
        self._h = hue

    def forward(self, x):
        a = _t(x)
        alpha = pyrandom.uniform(max(0.0, 1 - self._h), 1 + self._h)
        u = math.cos(alpha * math.pi)
        w = math.sin(alpha * math.pi)
        f32 = torch.float32
        t_yiq = torch.tensor([[0.299, 0.587, 0.114],
                              [0.596, -0.274, -0.321],
                              [0.211, -0.523, 0.311]], dtype=f32)
        t_rgb = torch.tensor([[1.0, 0.956, 0.621],
                              [1.0, -0.272, -0.647],
                              [1.0, -1.107, 1.705]], dtype=f32)
        rot = torch.tensor([[1.0, 0.0, 0.0],
                            [0.0, u, -w],
                            [0.0, w, u]], dtype=f32)
        m = (t_rgb @ rot @ t_yiq).to(a.device)
        out = torch.einsum("...c,kc->...k", a.to(f32), m)
        return _back(out, a)


class Rotate(HybridBlock):
    """Rotate by a fixed angle in degrees (parity: transforms.Rotate
    over image imrotate; bilinear sampling, zeros outside)."""

    def __init__(self, rotation_degrees, zoom_in=False, zoom_out=False):
        super().__init__()
        self._deg = rotation_degrees
        self._zoom_in, self._zoom_out = zoom_in, zoom_out

    def forward(self, x):
        return _rotate(_t(x), self._deg, self._zoom_in, self._zoom_out)


class RandomRotation(Block):
    """Uniform random rotation from [lo, hi] degrees (parity:
    transforms.RandomRotation)."""

    def __init__(self, angle_limits, zoom_in=False, zoom_out=False,
                 rotate_with_proba=1.0):
        super().__init__()
        self._limits = tuple(angle_limits)
        self._p = rotate_with_proba
        self._zoom_in, self._zoom_out = zoom_in, zoom_out

    def forward(self, x):
        a = _t(x)
        if pyrandom.random() >= self._p:
            return a
        return _rotate(a, pyrandom.uniform(*self._limits),
                       self._zoom_in, self._zoom_out)
