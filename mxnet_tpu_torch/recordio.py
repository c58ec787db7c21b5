"""RecordIO file format (counterpart of ``mxnet_tpu/recordio.py``).

Magic-framed records with 4-byte alignment, an optional ``.idx``
sidecar for random access, and the ``IRHeader`` (flag, label, id, id2)
image-record packing of im2rec.  A file either package writes is
byte-identical to the other's, so each reads the other's files.  Host
code only: nothing here touches a device.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple
from typing import Optional

import numpy as onp

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xced7230a

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential record file reader/writer (parity: recordio.py MXRecordIO)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.open()

    def open(self):
        if self.flag == "w":
            self._fp = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self._fp = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag}")

    def close(self):
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    # pickling reopens the file in the target process (parity:
    # recordio.py __getstate__/__setstate__ — required by multi-worker
    # DataLoader, which pickles datasets holding readers)
    def __getstate__(self):
        if self.flag == "w":
            raise MXNetError("cannot pickle a writable MXRecordIO")
        state = {k: v for k, v in self.__dict__.items() if k != "_fp"}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self.close()
        self.open()

    def tell(self) -> int:
        return self._fp.tell()

    def write(self, buf: bytes):
        if not self.writable:
            raise MXNetError("not opened for writing")
        length = len(buf)
        header = struct.pack("<II", _MAGIC, length)
        self._fp.write(header)
        self._fp.write(buf)
        pad = (4 - length % 4) % 4
        if pad:
            self._fp.write(b"\x00" * pad)

    def read(self) -> Optional[bytes]:
        if self.writable:
            raise MXNetError("not opened for reading")
        header = self._fp.read(8)
        if len(header) < 8:
            return None
        magic, length = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError("invalid record magic")
        buf = self._fp.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self._fp.read(pad)
        return buf


class MXIndexedRecordIO(MXRecordIO):
    """Random-access record file with .idx sidecar (parity:
    recordio.py MXIndexedRecordIO)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and os.path.isfile(idx_path):
            with open(idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    key = key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if self.writable and self.idx:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def seek(self, idx):
        self._fp.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


IndexedRecordIO = MXIndexedRecordIO  # short alias used by gluon.data


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack an IRHeader + payload (parity: recordio.pack).  A vector
    label is stored inline: flag = label length, scalar slot = 0, label
    floats prepended to the payload — the inverse of :func:`unpack`."""
    header = IRHeader(*header)
    label = header.label
    if isinstance(label, (list, tuple)) or getattr(label, "ndim", 0) != 0:
        label = onp.asarray(label, onp.float32).ravel()
        header = header._replace(flag=label.size, label=0.0)
        s = label.tobytes() + s
    payload = struct.pack(_IR_FORMAT, header.flag, float(header.label),
                          header.id, header.id2)
    return payload + s


def unpack(s: bytes):
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    payload = s[_IR_SIZE:]
    if header.flag > 0:
        label = onp.frombuffer(payload[:header.flag * 4], dtype=onp.float32)
        header = header._replace(label=label)
        payload = payload[header.flag * 4:]
    return header, payload


def pack_img(header: IRHeader, img, quality=95, img_fmt=".jpg") -> bytes:
    """Pack an image array: encoded by cv2 when it is installed, else
    as a raw ``.npy`` payload (parity: recordio.pack_img)."""
    try:
        import cv2
        ret, buf = cv2.imencode(img_fmt, img,
                                [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ret:
            raise MXNetError("image encode failed")
        return pack(header, buf.tobytes())
    except ImportError:
        import io as _io
        bio = _io.BytesIO()
        onp.save(bio, onp.asarray(img))
        return pack(header, bio.getvalue())


def unpack_img(s: bytes, iscolor=-1):
    header, payload = unpack(s)
    try:
        import cv2
        img = cv2.imdecode(onp.frombuffer(payload, dtype=onp.uint8), iscolor)
    except ImportError:
        import io as _io
        img = onp.load(_io.BytesIO(payload))
    return header, img
