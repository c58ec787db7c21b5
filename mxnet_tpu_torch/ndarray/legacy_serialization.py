"""The reference's binary NDArray format (the ``.params`` wire format),
the port's own copy of ``mxnet_tpu/ndarray/legacy_serialization.py``:
the same bytes are written and read.

Layout (``NDArray::Save/Load``, ``src/ndarray/ndarray.cc:1679``; the list
form with magic 0x112, ``ndarray.cc:1925``)::

    file      := uint64 magic=0x112 | uint64 reserved=0
               | uint64 n_arrays | ndarray*  | uint64 n_names | name*
    name      := uint64 len | bytes
    ndarray   := uint32 magic (V1 0xF993fac8 / V2 0xF993fac9 / V3 0xF993faca
                               / legacy: magic IS ndim, uint32 dims follow)
               | [V2/V3] int32 stype
               | [stype sparse] tshape storage_shape
               | tshape shape                (empty shape => none, stop)
               | int32 dev_type, int32 dev_id
               | int32 type_flag             (mshadow dtype enum)
               | [sparse, per aux] int32 aux_type | tshape aux_shape
               | raw data  (C-order, little-endian)
               | [sparse, per aux] raw aux data
    tshape    := int32 ndim | int64 dim[ndim]

All integers little-endian.  The port has dense arrays only: a record
with sparse storage raises "not ported yet".  bfloat16, which numpy
lacks, is carried as its 16-bit pattern and read back as a
``torch.bfloat16`` tensor; decoded arrays land on the current context.
"""
from __future__ import annotations

import struct
from typing import List, Optional

import numpy as onp
import torch

from ..base import MXNetError

NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
NDARRAY_V3_MAGIC = 0xF993FACA
LIST_MAGIC = 0x112

# storage types (include/mxnet/ndarray.h:61-65)
K_DEFAULT_STORAGE = 0
K_ROW_SPARSE_STORAGE = 1
K_CSR_STORAGE = 2

# device types (include/mxnet/base.h:92-97)
K_CPU = 1

# mshadow dtype enum (3rdparty/mshadow/mshadow/base.h:329-341)
_TYPE_FLAG_TO_DTYPE = {
    0: "float32", 1: "float64", 2: "float16", 3: "uint8", 4: "int32",
    5: "int8", 6: "int64", 7: "bool", 8: "int16", 9: "uint16",
    10: "uint32", 11: "uint64", 12: "bfloat16",
}
_DTYPE_TO_TYPE_FLAG = {v: k for k, v in _TYPE_FLAG_TO_DTYPE.items()}


def _host(arr):
    """``(C-order numpy array, dtype name)`` of an NDArray, tensor or
    array; a bfloat16 value as its uint16 bit pattern."""
    from .ndarray import NDArray
    if isinstance(arr, NDArray):
        arr = arr._data
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(onp.uint16), "bfloat16"
        name = str(t.dtype).replace("torch.", "")
        if name not in _DTYPE_TO_TYPE_FLAG:
            raise MXNetError(
                f"dtype {name} has no representation in the MXNet binary "
                f"format (mshadow enum); cast before saving")
        return t.numpy(), name
    a = onp.asarray(arr, order="C")
    return a, a.dtype.name


def _dtype_flag(name: str) -> int:
    if name not in _DTYPE_TO_TYPE_FLAG:
        raise MXNetError(
            f"dtype {name} has no representation in the MXNet binary "
            f"format (mshadow enum); cast before saving")
    return _DTYPE_TO_TYPE_FLAG[name]


class _Writer:
    def __init__(self):
        self.parts: List[bytes] = []

    def u32(self, v): self.parts.append(struct.pack("<I", v))
    def i32(self, v): self.parts.append(struct.pack("<i", v))
    def u64(self, v): self.parts.append(struct.pack("<Q", v))
    def raw(self, b): self.parts.append(bytes(b))

    def tshape(self, dims):
        self.i32(len(dims))
        for d in dims:
            self.parts.append(struct.pack("<q", int(d)))

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.buf):
            raise MXNetError("invalid NDArray file format (truncated)")
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def u32(self): return struct.unpack("<I", self._take(4))[0]
    def i32(self): return struct.unpack("<i", self._take(4))[0]
    def u64(self): return struct.unpack("<Q", self._take(8))[0]

    def tshape(self, v1_uint32: bool = False, ndim: Optional[int] = None):
        if ndim is None:
            ndim = self.i32()
        if ndim < 0:
            return None  # unknown shape (np semantics "none")
        fmt, width = ("<I", 4) if v1_uint32 else ("<q", 8)
        return tuple(struct.unpack(fmt, self._take(width))[0]
                     for _ in range(ndim))

    def array(self, name: str, shape):
        """The next ``shape`` elements of type ``name`` as an NDArray on
        the current context."""
        n = 1
        for d in shape:
            n *= int(d)
        stored = onp.dtype("uint16" if name == "bfloat16" else name)
        raw = self._take(n * stored.itemsize)
        a = onp.frombuffer(raw, dtype=stored.newbyteorder("<")).astype(
            stored, copy=False).reshape(shape)
        return _nd(a, name)


def _nd(a: onp.ndarray, name: str):
    from ..context import current_context
    from .ndarray import NDArray
    if name == "bfloat16":
        t = torch.from_numpy(onp.array(a).view(onp.int16)).view(
            torch.bfloat16)
        return NDArray._wrap(t.to(current_context().torch_device))
    return NDArray(a)


def _empty():
    return _nd(onp.zeros((0,), onp.float32), "float32")


def encode_ndarray(arr) -> bytes:
    """One dense array (an NDArray, tensor or numpy array) in the
    reference's wire format."""
    a, name = _host(arr)
    out = _Writer()
    # 0-dim arrays only exist under np shape semantics => V3 magic
    # (ndarray.cc: V2 treats ndim==0 as "none")
    out.u32(NDARRAY_V3_MAGIC if a.ndim == 0 else NDARRAY_V2_MAGIC)
    out.i32(K_DEFAULT_STORAGE)
    out.tshape(a.shape)
    out.i32(K_CPU)
    out.i32(0)
    out.i32(_dtype_flag(name))
    out.raw(a.astype(a.dtype.newbyteorder("<")).tobytes())
    return out.getvalue()


def decode_ndarray(r: _Reader):
    """The inverse of :func:`encode_ndarray`; also reads V1 and pre-V1
    records (``ndarray.cc`` LegacyLoad:1760)."""
    magic = r.u32()
    if magic not in (NDARRAY_V2_MAGIC, NDARRAY_V3_MAGIC):
        # V1 has an int64 tshape; anything else means the magic itself
        # was the ndim of a uint32 shape
        if magic == NDARRAY_V1_MAGIC:
            shape = r.tshape()
        else:
            shape = r.tshape(v1_uint32=True, ndim=magic)
        if shape is None or len(shape) == 0:
            return _empty()
        r.i32()
        r.i32()  # context
        return r.array(_TYPE_FLAG_TO_DTYPE[r.i32()], shape)
    stype = r.i32()
    if stype != K_DEFAULT_STORAGE:
        if stype in (K_ROW_SPARSE_STORAGE, K_CSR_STORAGE):
            raise MXNetError("sparse NDArray records are not ported yet "
                             "(sparse storage, queue 1 item 13)")
        raise MXNetError(f"invalid NDArray file format (unknown storage "
                         f"type {stype})")
    shape = r.tshape()
    if shape is None or (magic == NDARRAY_V2_MAGIC and len(shape) == 0):
        return _empty()
    r.i32()
    r.i32()  # context: arrays land on the current one
    return r.array(_TYPE_FLAG_TO_DTYPE[r.i32()], shape)


def encode_list(payload, names: List[str]) -> bytes:
    w = _Writer()
    w.u64(LIST_MAGIC)
    w.u64(0)  # reserved
    w.u64(len(payload))
    for p in payload:
        w.raw(encode_ndarray(p))
    w.u64(len(names))
    for n in names:
        b = n.encode("utf-8")
        w.u64(len(b))
        w.raw(b)
    return w.getvalue()


def decode_list(buf: bytes):
    r = _Reader(buf)
    if r.u64() != LIST_MAGIC:
        raise MXNetError("invalid NDArray file format (bad magic)")
    r.u64()  # reserved
    n = r.u64()
    data = [decode_ndarray(r) for _ in range(n)]
    names = [r._take(r.u64()).decode("utf-8") for _ in range(r.u64())]
    if names and len(names) != len(data):
        raise MXNetError("invalid NDArray file format (name count)")
    return data, names


def is_mxnet_format(head: bytes) -> bool:
    """Sniff the 8-byte list magic (npz files start with 'PK')."""
    return len(head) >= 8 and \
        struct.unpack("<Q", head[:8])[0] == LIST_MAGIC


def save_mxnet(fname: str, data):
    """``nd.save`` with the binary codec.  A bare NDArray is stored as a
    1-element unnamed list: the format has no single-array marker."""
    from .ndarray import NDArray
    if isinstance(data, NDArray):
        payload, names = [data], []
    elif isinstance(data, (list, tuple)):
        payload, names = list(data), []
    elif isinstance(data, dict):
        payload, names = list(data.values()), list(data.keys())
    else:
        raise MXNetError("save: data must be NDArray, list, or dict")
    with open(fname, "wb") as f:
        f.write(encode_list(payload, names))


def load_mxnet(fname: str):
    with open(fname, "rb") as f:
        data, names = decode_list(f.read())
    return dict(zip(names, data)) if names else data
