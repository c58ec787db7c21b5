"""Batchify functions (counterpart of
``mxnet_tpu/gluon/data/batchify.py``); batches are host NDArrays.

Parity: python/mxnet/gluon/data/batchify.py — ``Stack`` (:30), ``Pad``
(:157), ``Append`` (:279), ``Group`` (:317), ``AsList`` (:391):
composable per-field batch collation for DataLoader, the standard
toolkit for variable-length and multi-field samples.
"""
from __future__ import annotations

from typing import Optional

import numpy as onp

from ...base import MXNetError
from ...io.io import host_nd
from ...ndarray import NDArray

__all__ = ["Stack", "Pad", "Append", "Group", "AsList"]


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return onp.asarray(x)


class Stack:
    """Stack same-shape samples along a new batch axis (parity:
    batchify.Stack)."""

    def __call__(self, data):
        return host_nd(onp.stack([_np(d) for d in data]))


class Pad:
    """Pad samples to the per-batch max shape, then stack (parity:
    batchify.Pad): ``val`` pad value, ``dtype`` output type,
    ``round_to`` rounds each padded dim up to a multiple (the bucketing
    /static-shape knob)."""

    def __init__(self, val=None, dtype=None, round_to: Optional[int] = None,
                 use_shared_mem=False):
        self._val = 0 if val is None else val
        self._dtype = dtype
        self._round_to = round_to

    def __call__(self, data):
        arrs = [_np(d) for d in data]
        ndim = arrs[0].ndim
        if any(a.ndim != ndim for a in arrs):
            raise MXNetError("Pad requires samples of equal rank")
        max_shape = [max(a.shape[i] for a in arrs) for i in range(ndim)]
        if self._round_to:
            r = self._round_to
            max_shape = [((s + r - 1) // r) * r for s in max_shape]
        dtype = self._dtype or arrs[0].dtype
        out = onp.full([len(arrs)] + max_shape, self._val, dtype=dtype)
        for i, a in enumerate(arrs):
            out[(i,) + tuple(slice(0, s) for s in a.shape)] = a
        return host_nd(out)


class Append:
    """Batch as a list of per-sample arrays, no stacking (parity:
    batchify.Append — for fully ragged data); ``expand`` adds a leading
    batch axis of 1 to each sample."""

    def __init__(self, expand=True, batch_axis=0, use_shared_mem=False):
        self._expand = expand
        self._batch_axis = batch_axis

    def __call__(self, data):
        out = []
        for d in data:
            a = _np(d)
            if self._expand:
                a = onp.expand_dims(a, self._batch_axis)
            out.append(host_nd(a))
        return out


class Group:
    """Apply one batchify function per sample field (parity:
    batchify.Group): ``Group(Stack(), Pad(val=-1))`` collates
    (img, ragged_label) samples."""

    def __init__(self, fn, *args):
        if isinstance(fn, (list, tuple)):
            if args:
                raise MXNetError("Group accepts a single list OR varargs")
            self._fn = list(fn)
        else:
            self._fn = [fn] + list(args)

    def __call__(self, data):
        if len(data[0]) != len(self._fn):
            raise MXNetError(
                f"Group has {len(self._fn)} functions but samples have "
                f"{len(data[0])} fields")
        return tuple(f([d[i] for d in data])
                     for i, f in enumerate(self._fn))


class AsList:
    """Keep the field as a plain nested list (parity: batchify.AsList
    — for string or object fields)."""

    def __call__(self, data):
        return list(data)
