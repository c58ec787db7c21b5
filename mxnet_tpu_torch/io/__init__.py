"""mx.io — the DataIter API (counterpart of ``mxnet_tpu/io/``).

``LibSVMIter`` (CSR storage) and ``ImageDetRecordIter`` (the detection
pipeline) are not ported yet: they raise :class:`MXNetError`.
"""
from ..base import MXNetError
from .io import (DataIter, DataBatch, DataDesc, NDArrayIter, CSVIter,
                 ResizeIter, PrefetchingIter, MNISTIter, host_nd)
from . import native
from .native import (ImageRecordIter, ImageRecordUInt8Iter,
                     ImageRecordInt8Iter)

__all__ = ["DataIter", "DataBatch", "DataDesc", "NDArrayIter", "CSVIter",
           "ResizeIter", "PrefetchingIter", "MNISTIter", "ImageRecordIter",
           "ImageRecordUInt8Iter", "ImageRecordInt8Iter", "native",
           "LibSVMIter", "ImageDetRecordIter"]


def LibSVMIter(*args, **kwargs):
    raise MXNetError("io.LibSVMIter is not ported yet (it needs CSR "
                     "storage)")


def ImageDetRecordIter(*args, **kwargs):
    raise MXNetError("io.ImageDetRecordIter is not ported yet (it needs "
                     "image.detection)")
