"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``).

Parity: python/mxnet/gluon/utils.py (split_data:41, split_and_load:87,
clip_global_norm:117, check_sha1:179, download:271, HookHandle:395,
shape_is_known:430).  ``split_and_load`` places one slice on each
context of the list (``Context``, ``torch.device`` or device string);
``clip_global_norm`` computes one global norm over all arrays on their
device (no host read per array, unlike the reference's per-array loop)
and rescales them, reading the norm on the host once at the end.
"""
from __future__ import annotations

import hashlib
import os

import numpy as onp
import torch

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download", "shape_is_known", "HookHandle"]

def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split ``data`` into ``num_slice`` slices along ``batch_axis``.

    With ``even_split`` the batch must divide evenly; otherwise the
    leading slices carry one extra element each (reference
    gluon/utils.py:41 semantics).
    """
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. Use a batch "
            f"size that's a multiple of {num_slice} or set "
            f"even_split=False.")
    if num_slice == 1:
        return [data]

    step = size // num_slice
    extra = size % num_slice
    slices = []
    start = 0
    for i in range(num_slice):
        stop = start + step + (1 if i < extra else 0)
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(start, stop)
        slices.append(data[tuple(idx)])
        start = stop
    return slices


def _as_device(ctx) -> torch.device:
    """Context | torch.device | device string -> torch.device."""
    from ..context import Context, resolve_device

    if isinstance(ctx, Context):
        return ctx.torch_device
    if isinstance(ctx, (torch.device, str)):
        return resolve_device(ctx)
    raise TypeError(f"not a Context or torch.device: {ctx!r}")


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` and place one slice per
    device in ``ctx_list`` (reference gluon/utils.py:87)."""
    from ..io.io import host_nd
    from ..ndarray import NDArray

    if not isinstance(data, NDArray):
        data = host_nd(onp.asarray(data))
    if len(ctx_list) == 1:
        return [NDArray._wrap(data._data.to(_as_device(ctx_list[0])))]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [NDArray._wrap(s._data.to(_as_device(c)))
            for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Rescale ``arrays`` in place so their joint L2 norm is at most
    ``max_norm``; returns the pre-clip global norm as a float.

    The norm and every rescaled array are computed on the arrays' device
    in one pass (:func:`_fused_clip`; the reference loops per array,
    gluon/utils.py:117-165)."""
    if not arrays:
        raise ValueError("arrays must not be empty")

    clipped, norm = _fused_clip([a._data for a in arrays], float(max_norm))
    norm = float(norm)
    if check_isfinite and not onp.isfinite(norm):
        import warnings

        warnings.warn(f"nan or inf is detected. Clipping results will "
                      f"be undefined. norm={norm}", stacklevel=2)
    for a, c in zip(arrays, clipped):
        a._rebind(c)
    return norm


@torch.no_grad()
def _fused_clip(xs, max_norm):
    """(rescaled arrays, global f32 norm): the sum of squares in f32,
    each array times ``min(1, max_norm / max(norm, 1e-20))`` in its own
    dtype (the reference's ``_fused_clip``)."""
    total = sum(torch.sum(torch.square(x.detach().to(torch.float32)))
                for x in xs)
    norm = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-20), max=1.0)
    return [x.detach() * scale.to(x.dtype) for x in xs], norm


def check_sha1(filename, sha1_hash):
    """True iff the sha1 of ``filename``'s content matches
    ``sha1_hash`` (reference gluon/utils.py:179)."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            sha1.update(chunk)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """Download ``url`` to ``path`` (reference gluon/utils.py:271).

    Implemented as the reference's; it raises the underlying URLError
    on a network failure, after exhausting ``retries``.
    """
    if path is None:
        fname = url.split("/")[-1]
        if not fname:
            raise ValueError(f"can't construct file-name from url {url}")
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if retries < 0:
        raise ValueError("Number of retries should be at least 0")

    if not overwrite and os.path.exists(fname) and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname

    import ssl
    import urllib.request

    ctx = None if verify_ssl else ssl._create_unverified_context()
    dirname = os.path.dirname(os.path.abspath(os.path.expanduser(fname)))
    os.makedirs(dirname, exist_ok=True)
    last = None
    for _ in range(retries + 1):
        try:
            with urllib.request.urlopen(url, context=ctx) as r, \
                    open(fname, "wb") as f:
                while True:
                    chunk = r.read(1 << 20)
                    if not chunk:
                        break
                    f.write(chunk)
            if sha1_hash and not check_sha1(fname, sha1_hash):
                raise OSError(
                    f"File {fname} is downloaded but the content hash "
                    f"does not match.")
            return fname
        except Exception as e:    # noqa: BLE001 — retry any transport error
            last = e
    raise last


def shape_is_known(shape):
    """True iff every dim of ``shape`` is known (> 0; reference
    gluon/utils.py:430 with np-shape unknown = -1)."""
    if shape is None:
        return False
    for d in shape:
        if d is None or d < 0:
            return False
    return True


# the working implementation lives on Block (block.py:_HookHandle);
# re-exported here under the reference's public name
from .block import _HookHandle as HookHandle  # noqa: E402
