"""Base types shared by every layer of the port: the package-wide error
type, the dtype registry and environment-variable config access
(counterpart of ``mxnet_tpu/base.py``)."""
from __future__ import annotations

import os
from typing import Any, Sequence, Tuple

import numpy as onp
import torch

__all__ = ["MXNetError", "getenv", "getenv_bool", "getenv_int", "DTYPES",
           "torch_dtype", "np_dtype", "dtype_name", "check_shape",
           "numpy_bits", "tensor_from_bits"]


class MXNetError(RuntimeError):
    """Error raised by the framework runtime (parity: dmlc::Error)."""


def getenv(name: str, default: str | None = None) -> str | None:
    return os.environ.get(name, default)


def getenv_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


def getenv_int(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default


# dtype registry: the names MXNet exposes in Python → torch dtypes
DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "bool": torch.bool,
}

_NAMES = {v: k for k, v in DTYPES.items()}


def torch_dtype(dtype: Any) -> torch.dtype:
    """A user-supplied dtype (name, numpy dtype, python type or
    ``torch.dtype``) as a ``torch.dtype``; ``None`` means float32, as in
    the reference."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else onp.dtype(dtype).name
    try:
        return DTYPES[name]
    except KeyError:
        raise MXNetError(f"unknown dtype {dtype!r}") from None


def dtype_name(dtype: Any) -> str:
    """Canonical name of a dtype (``"bfloat16"``, ``"float32"``, …)."""
    return _NAMES[torch_dtype(dtype)]


def np_dtype(dtype: Any) -> onp.dtype:
    """The numpy dtype of a user-supplied dtype.  numpy has no bfloat16
    (the reference takes it from ``ml_dtypes``, which the port does not
    need), so bfloat16 raises."""
    name = dtype_name(dtype)
    if name == "bfloat16":
        raise MXNetError("numpy has no bfloat16: cast to float32 first")
    return onp.dtype(name)


def check_shape(shape: Sequence[int] | int) -> Tuple[int, ...]:
    """Normalize a shape argument to a tuple of ints (scalar int allowed)."""
    if isinstance(shape, (int, onp.integer)):
        return (int(shape),)
    return tuple(int(s) for s in shape)


# itemsize -> (torch integer type, numpy type of its bits, stored type):
# bfloat16 and the fp8 types, which numpy lacks, travel as bit patterns
_BITS = {2: (torch.int16, onp.int16, onp.uint16),
         1: (torch.uint8, onp.uint8, onp.uint8)}


def numpy_bits(t: torch.Tensor) -> Tuple[onp.ndarray, str]:
    """``(array, dtype name)`` of a tensor on the host: numpy's own
    dtypes as they are; bfloat16 and the fp8 types as their bit patterns
    (uint16 / uint8), which :func:`tensor_from_bits` reads back."""
    t = t.detach().cpu()
    name = str(t.dtype).replace("torch.", "")
    try:
        return t.numpy(), name
    except TypeError:
        tdt, _, stored = _BITS[t.element_size()]
        return t.contiguous().view(tdt).numpy().view(stored), name


def tensor_from_bits(raw: onp.ndarray, want, device) -> torch.Tensor:
    """A tensor on ``device`` from a stored array and the name of its
    dtype (``None``, or the array's own: as it is; a type numpy lacks:
    the stored bits viewed as that type)."""
    if want is not None and str(raw.dtype) != want:
        dt = getattr(torch, want, None)
        if not isinstance(dt, torch.dtype) or dt.itemsize != raw.itemsize:
            raise MXNetError(f"cannot read dtype {want!r} from a "
                             f"{raw.dtype} array")
        _, bits, _ = _BITS[raw.itemsize]
        t = torch.from_numpy(onp.array(raw).view(bits)).view(dt)
    else:
        t = torch.from_numpy(onp.array(raw))
    return t.to(device)
