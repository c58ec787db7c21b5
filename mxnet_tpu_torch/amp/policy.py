"""The AMP execution policy (counterpart of ``mxnet_tpu/amp/policy.py``):
a process-wide (enabled, compute dtype) pair, and the casts each listed
op applies under it.

The reference bakes the casts into the traced partials its funnel
builds.  The port has no traced partials, so the policy is read where
each op runs: every op registered under a name on the lists
(``ops/registry.register`` wraps it with :func:`apply`) casts its inputs
by its category at call time, which reaches both ``mx.nd`` and the Gluon
layers, since the layers call these same functions.  A CUDA graph fixes
the casts it was captured with, so :func:`cache_token` joins the
signature of every captured executable (``SPMDTrainer``'s, the decode
engine's): a graph captured with the policy off is never replayed with
it on.

Categories (from :mod:`.lists`):

- target (``FullyConnected``, ``Convolution``, ``dot``): f32/f64
  inputs cast down to the compute dtype; the output stays low;
- fp32 (the softmax family, ``BatchNorm``, ``LayerNorm``, ``mean``,
  ``sum``, ``exp``, ``log``): low-precision float inputs cast up to f32;
- widest (``elemwise_add`` ... ``elemwise_div``): every float input cast
  to the widest float type among them;
- unlisted ops: untouched.

The compute dtype is ``bfloat16`` (default) or ``float16``
(``amp.init(...)`` or ``MXNET_AMP_DTYPE``; ``MXNET_AMP=1`` turns the
policy on without ``amp.init``).  The fp8 policy (``float8_e4m3fn``) is
not ported yet and raises.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from ..base import MXNetError
from . import lists

__all__ = ["enabled", "activate", "deactivate", "compute_dtype",
           "compute_dtype_str", "storage_dtype", "compute_itemsize",
           "cache_token", "category", "wrap", "wire_cast", "apply"]

_active = False
_active_dtype: Optional[str] = None

_TARGET = frozenset(lists.TARGET_DTYPE_OPS)
_FP32 = frozenset(lists.FP32_OPS)
_WIDEST = frozenset(lists.WIDEST_TYPE_CASTS)

_DTYPE_ALIASES = {
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float16": "float16", "fp16": "float16",
    "float8_e4m3fn": "float8_e4m3fn", "fp8": "float8_e4m3fn",
    "e4m3": "float8_e4m3fn",
}
_WIDE = (torch.float32, torch.float64)


def _canon(name) -> str:
    s = str(name).lower().replace("torch.", "")
    try:
        canon = _DTYPE_ALIASES[s]
    except KeyError:
        raise ValueError(f"unsupported AMP compute dtype {name!r}; one of "
                         f"{sorted(set(_DTYPE_ALIASES))}") from None
    if canon == "float8_e4m3fn":
        raise MXNetError("the fp8 AMP policy (float8_e4m3fn) is not ported "
                         "yet; use bfloat16 or float16")
    return canon


def activate(dtype=None) -> None:
    """Turn the policy on; ``dtype`` overrides ``MXNET_AMP_DTYPE``."""
    global _active, _active_dtype
    canon = _canon(dtype) if dtype is not None else None
    _active = True
    _active_dtype = canon


def deactivate() -> None:
    global _active, _active_dtype
    _active = False
    _active_dtype = None


def enabled() -> bool:
    """True when ``amp.init()`` ran or ``MXNET_AMP=1`` is set."""
    return _active or os.environ.get("MXNET_AMP") == "1"


def compute_dtype_str() -> str:
    """The compute dtype's name (bf16 when off: gate on :func:`enabled`
    first)."""
    if _active_dtype is not None:
        return _active_dtype
    env = os.environ.get("MXNET_AMP_DTYPE")
    return _canon(env) if env else "bfloat16"


def compute_dtype() -> torch.dtype:
    """The dtype target-category ops compute in."""
    return getattr(torch, compute_dtype_str())


def storage_dtype() -> torch.dtype:
    """The dtype gradients travel in (the wire): the compute dtype, since
    the fp8 policy is not ported."""
    return compute_dtype()


def compute_itemsize() -> int:
    """Bytes per element on the gradient wire (4 when the policy is
    off)."""
    if not enabled():
        return 4
    return storage_dtype().itemsize


def cache_token():
    """A hashable fingerprint of the policy (None while it is off), for
    the signature of every captured executable."""
    if not enabled():
        return None
    return ("amp", compute_dtype_str())


def category(op_name: str) -> Optional[str]:
    if op_name in _TARGET:
        return "target"
    if op_name in _FP32:
        return "fp32"
    if op_name in _WIDEST:
        return "widest"
    return None


def _is_float(a) -> bool:
    return isinstance(a, torch.Tensor) and a.is_floating_point()


def wire_cast(g):
    """``g`` rounded through the storage dtype and back (identity for
    non-float tensors, tensors no wider than the wire, and while the
    policy is off)."""
    if not enabled() or not _is_float(g):
        return g
    wire = storage_dtype()
    if g.element_size() <= wire.itemsize:
        return g
    return g.to(wire).to(g.dtype)


def _cast(cat, arrays):
    if cat == "target":
        low = compute_dtype()
        return [a.to(low) if _is_float(a) and a.dtype in _WIDE else a
                for a in arrays]
    if cat == "fp32":
        return [a.float() if _is_float(a) and a.dtype not in _WIDE else a
                for a in arrays]
    fdts = {a.dtype for a in arrays if _is_float(a)}
    if len(fdts) <= 1:
        return arrays
    widest = max(fdts, key=lambda d: (d.itemsize, str(d)))
    return [a.to(widest) if _is_float(a) else a for a in arrays]


def wrap(op_name: str, fn):
    """``fn`` with the casts of ``op_name``'s category, applied always
    (the caller checks :func:`enabled`); ``fn`` itself when unlisted."""
    cat = category(op_name)
    if cat is None:
        return fn

    @functools.wraps(fn)
    def wrapped(*arrays, **params):
        return fn(*_cast(cat, list(arrays)), **params)
    return wrapped


def apply(op_name: str, fn):
    """``fn`` reading the policy at each call: under AMP it casts its
    inputs by ``op_name``'s category; off, it is ``fn``.  Unlisted names
    return ``fn`` itself."""
    cat = category(op_name)
    if cat is None:
        return fn

    @functools.wraps(fn)
    def policed(*arrays, **params):
        if _active or os.environ.get("MXNET_AMP") == "1":
            arrays = _cast(cat, list(arrays))
        return fn(*arrays, **params)
    policed.amp_category = cat
    return policed
