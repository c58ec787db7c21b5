"""ctypes bindings for the native IO runtime (counterpart of
``mxnet_tpu/io/native.py``).

The library is the port's own copy of the reference's host C++ —
``csrc/io/recordio.cc`` (dmlc recordio framing), ``image_pipeline.cc``
(the threaded JPEG decode / augment / batch pipeline behind
``ImageRecordIter``, ``src/io/iter_image_recordio_2.cc:887``) and
``engine.cc`` — plus ``jpeg_encode.cc``, a libjpeg encoder used only as
test tooling (:func:`jpeg_compress`).  ``kernels.build.build_host_library``
compiles it with ``g++ ... -ljpeg`` into ``build/torch_kernels/host/`` at
first use, under the build lock; importing this module builds nothing.
Where it cannot be built (no compiler, no libjpeg) :func:`get_lib` raises
:class:`MXNetError`, as the reference's does; nothing stands in for it.

Batches come out as host (CPU) NDArrays: moving them to the card is the
device prefetcher's job (``data.DevicePrefetcher``), or the consumer's.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as onp

from ..base import MXNetError

_LIB: Optional[ctypes.CDLL] = None
SOURCES = ("io/recordio.cc", "io/image_pipeline.cc", "io/engine.cc",
           "io/jpeg_encode.cc")


def get_lib() -> ctypes.CDLL:
    """Load (building it at first use) the native IO library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from ..kernels.build import build_host_library
    lib = build_host_library("mxtpu_io", SOURCES)[0]
    # writer
    lib.mxtpu_rec_writer_open.restype = ctypes.c_void_p
    lib.mxtpu_rec_writer_open.argtypes = [ctypes.c_char_p]
    lib.mxtpu_rec_writer_write.restype = ctypes.c_int64
    lib.mxtpu_rec_writer_write.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
    lib.mxtpu_rec_writer_close.argtypes = [ctypes.c_void_p]
    # reader
    lib.mxtpu_rec_reader_open.restype = ctypes.c_void_p
    lib.mxtpu_rec_reader_open.argtypes = [ctypes.c_char_p]
    lib.mxtpu_rec_reader_next.restype = ctypes.c_int
    lib.mxtpu_rec_reader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.mxtpu_rec_reader_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.mxtpu_rec_reader_tell.restype = ctypes.c_int64
    lib.mxtpu_rec_reader_tell.argtypes = [ctypes.c_void_p]
    lib.mxtpu_rec_reader_close.argtypes = [ctypes.c_void_p]
    # pipeline
    lib.mxtpu_pipe_create.restype = ctypes.c_void_p
    lib.mxtpu_pipe_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint64, ctypes.c_int,
        ctypes.c_int]
    lib.mxtpu_pipe_num_records.restype = ctypes.c_int64
    lib.mxtpu_pipe_num_records.argtypes = [ctypes.c_void_p]
    lib.mxtpu_pipe_next.restype = ctypes.c_int
    lib.mxtpu_pipe_next.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_float)]
    lib.mxtpu_pipe_reset.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mxtpu_pipe_destroy.argtypes = [ctypes.c_void_p]
    # test tooling: the JPEG encoder
    lib.mxtpu_jpeg_compress.restype = ctypes.c_int
    lib.mxtpu_jpeg_compress.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.mxtpu_jpeg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    _LIB = lib
    return lib


def available() -> bool:
    try:
        get_lib()
        return True
    except (MXNetError, OSError):
        return False


def jpeg_compress(rgb, quality: int = 95) -> bytes:
    """Encode an (H, W, 3) uint8 RGB array as baseline JPEG bytes with
    libjpeg.  Test tooling (record files made from seeded pixels where no
    cv2 is installed); no user path calls it."""
    lib = get_lib()
    a = onp.ascontiguousarray(rgb, dtype=onp.uint8)
    if a.ndim != 3 or a.shape[2] != 3:
        raise MXNetError(f"jpeg_compress: want (H, W, 3) uint8, got "
                         f"{a.shape}")
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_uint64(0)
    rc = lib.mxtpu_jpeg_compress(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), a.shape[1],
        a.shape[0], int(quality), ctypes.byref(out), ctypes.byref(n))
    if rc != 0:
        raise MXNetError("jpeg_compress: libjpeg failed")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.mxtpu_jpeg_free(out)


class NativeRecordWriter:
    """Sequential dmlc-format record writer (native)."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.mxtpu_rec_writer_open(path.encode())
        if not self._h:
            raise MXNetError(f"cannot open {path} for writing")

    def write(self, buf: bytes) -> int:
        arr = (ctypes.c_uint8 * len(buf)).from_buffer_copy(buf)
        pos = self._lib.mxtpu_rec_writer_write(self._h, arr, len(buf))
        if pos < 0:
            raise MXNetError("record write failed")
        return pos

    def close(self):
        if self._h:
            self._lib.mxtpu_rec_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeRecordReader:
    """Sequential dmlc-format record reader (native)."""

    def __init__(self, path: str):
        self._lib = get_lib()
        self._h = self._lib.mxtpu_rec_reader_open(path.encode())
        if not self._h:
            raise MXNetError(f"cannot open {path}")

    def read(self) -> Optional[bytes]:
        out = ctypes.POINTER(ctypes.c_uint8)()
        length = ctypes.c_int64(0)
        status = self._lib.mxtpu_rec_reader_next(
            self._h, ctypes.byref(out), ctypes.byref(length))
        if status == 0:
            return None
        if status < 0:
            raise MXNetError(f"corrupt record stream (code {status})")
        return ctypes.string_at(out, length.value) if length.value else b""

    def seek(self, offset: int):
        if self._lib.mxtpu_rec_reader_seek(self._h, offset) != 0:
            raise MXNetError("seek failed")

    def tell(self) -> int:
        return self._lib.mxtpu_rec_reader_tell(self._h)

    def close(self):
        if self._h:
            self._lib.mxtpu_rec_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ImageRecordIter:
    """Threaded native image pipeline (parity: ImageRecordIter,
    src/io/iter_image_recordio_2.cc:887-940).

    Yields DataBatch with NCHW float32 host data, like the reference (the
    native pipeline fills NHWC and this wrapper transposes with one host
    copy unless ``layout="NHWC"``).
    """

    def __init__(self, path_imgrec: str, batch_size: int,
                 data_shape=(3, 224, 224), label_width: int = 1,
                 shuffle: bool = False, rand_mirror: bool = False,
                 rand_crop: bool = False, mean_r: float = 0.0,
                 mean_g: float = 0.0, mean_b: float = 0.0,
                 std_r: float = 1.0, std_g: float = 1.0, std_b: float = 1.0,
                 seed: int = 0, preprocess_threads: int = 4,
                 prefetch_buffer: int = 4, layout: str = "NCHW",
                 round_batch: bool = True, **kwargs):
        self._lib = get_lib()
        c, h, w = data_shape
        mean = (ctypes.c_float * 3)(mean_r, mean_g, mean_b)
        std = (ctypes.c_float * 3)(std_r, std_g, std_b)
        self._h = self._lib.mxtpu_pipe_create(
            path_imgrec.encode(), batch_size, h, w, c, label_width,
            int(shuffle), int(rand_mirror), int(rand_crop), mean, std,
            seed, preprocess_threads, prefetch_buffer)
        if not self._h:
            raise MXNetError(f"cannot open record file {path_imgrec}")
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.label_width = label_width
        self.layout = layout
        self._threads = preprocess_threads
        self._data_buf = onp.empty((batch_size, h, w, c), onp.float32)
        self._label_buf = onp.empty((batch_size, label_width), onp.float32)

    @property
    def num_records(self) -> int:
        return int(self._lib.mxtpu_pipe_num_records(self._h))

    def __iter__(self):
        return self

    def __next__(self):
        from .io import DataBatch, host_nd
        n = self._lib.mxtpu_pipe_next(
            self._h,
            self._data_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._label_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n <= 0:
            raise StopIteration
        data = self._data_buf
        if self.layout == "NCHW":
            data = onp.transpose(data, (0, 3, 1, 2))
        label = self._label_buf[:, 0] if self.label_width == 1 \
            else self._label_buf
        # one owned host copy each: the buffers are refilled next call
        return DataBatch(data=[host_nd(onp.ascontiguousarray(data))],
                         label=[host_nd(label.copy())],
                         pad=self.batch_size - n)

    def next(self):
        return self.__next__()

    def reset(self):
        self._lib.mxtpu_pipe_reset(self._h, self._threads)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.mxtpu_pipe_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class ImageRecordUInt8Iter(ImageRecordIter):
    """ImageRecordIter yielding raw uint8 pixels (parity:
    ImageRecordUInt8Iter, iter_image_recordio_2.cc:908): no
    mean/std normalization, data dtype uint8 — the int8/uint8
    quantized-inference input path."""

    _out_dtype = onp.uint8
    _offset = 0

    def __init__(self, *args, **kwargs):
        for k in ("mean_r", "mean_g", "mean_b"):
            kwargs.pop(k, None)
        for k in ("std_r", "std_g", "std_b"):
            kwargs.pop(k, None)
        super().__init__(*args, **kwargs)

    def __next__(self):
        batch = super().__next__()
        from .io import host_nd
        batch.data = [host_nd((onp.clip(d.asnumpy(), 0, 255)
                               + self._offset).astype(self._out_dtype))
                      for d in batch.data]
        return batch


class ImageRecordInt8Iter(ImageRecordUInt8Iter):
    """Signed-int8 variant (parity: ImageRecordInt8Iter,
    iter_image_recordio_2.cc:925): pixels shifted into [-128, 127]."""

    _out_dtype = onp.int8
    _offset = -128
