"""``mx.np.fft`` (counterpart of ``mxnet_tpu/numpy/fft.py``) over
``torch.fft``: cuFFT on the card.  numpy's ``axis`` / ``axes`` keywords
are torch's ``dim``; real input gives complex64."""
from __future__ import annotations

import torch

from . import _canon, _dev, _lift, ndarray

__all__ = ["fft", "ifft", "fft2", "ifft2", "fftn", "ifftn", "rfft", "irfft",
           "fftshift", "ifftshift", "hfft", "ihfft", "fftfreq", "rfftfreq"]


def _fix(fn, one_axis):
    def g(a, *args, **kwargs):
        if "axis" in kwargs:
            kwargs["dim"] = kwargs.pop("axis")
        if "axes" in kwargs:
            kwargs["dim"] = kwargs.pop("axes")
        if not (a.dtype.is_floating_point or a.dtype.is_complex):
            a = a.to(torch.float32)
        if a.dtype == torch.float16 or a.dtype == torch.bfloat16:
            a = a.float()
        out = fn(a, *args, **kwargs)
        return out.resolve_conj() if out.is_conj() else out
    g.__name__ = fn.__name__
    return g


fft = _lift(_fix(torch.fft.fft, True), "fft")
ifft = _lift(_fix(torch.fft.ifft, True), "ifft")
fft2 = _lift(_fix(torch.fft.fft2, False), "fft2")
ifft2 = _lift(_fix(torch.fft.ifft2, False), "ifft2")
fftn = _lift(_fix(torch.fft.fftn, False), "fftn")
ifftn = _lift(_fix(torch.fft.ifftn, False), "ifftn")
rfft = _lift(_fix(torch.fft.rfft, True), "rfft")
irfft = _lift(_fix(torch.fft.irfft, True), "irfft")
fftshift = _lift(_fix(torch.fft.fftshift, False), "fftshift")
ifftshift = _lift(_fix(torch.fft.ifftshift, False), "ifftshift")
hfft = _lift(_fix(torch.fft.hfft, True), "hfft")
ihfft = _lift(_fix(torch.fft.ihfft, True), "ihfft")


def fftfreq(n, d=1.0, ctx=None):
    return ndarray._wrap(_canon(torch.fft.fftfreq(n, d, device=_dev(ctx))))


def rfftfreq(n, d=1.0, ctx=None):
    return ndarray._wrap(_canon(torch.fft.rfftfreq(n, d, device=_dev(ctx))))
