"""Legacy data iterators (counterpart of ``mxnet_tpu/io/io.py``).

Parity: python/mxnet/io/io.py — DataIter protocol (provide_data/
provide_label, next/reset), NDArrayIter with shuffle + last-batch
handling, CSVIter, prefetching wrapper over the same protocol the C++
iterator chain implements (src/io/iter_prefetcher.h).

Batches are host (CPU) NDArrays, whatever the current context: an
iterator feeds a device through ``data.DevicePrefetcher`` (or the
consumer stages the batch itself), and a DataLoader worker process must
never touch the card.  :func:`host_nd` makes them, with the reference's
dtype rules (float64 becomes float32, int64 becomes int32).
"""
from __future__ import annotations

import threading
import queue as _queue
from collections import namedtuple
import numpy as onp

import torch

from ..base import MXNetError
from ..ndarray import NDArray

__all__ = ["DataIter", "DataBatch", "DataDesc", "NDArrayIter", "CSVIter",
           "ResizeIter", "PrefetchingIter", "MNISTIter", "host_nd"]


def host_nd(a) -> NDArray:
    """A CPU NDArray over ``a`` (numpy or anything ``numpy.asarray``
    takes), with the reference's dtype rules: float64 becomes float32 and
    int64 int32.  An owned, C-contiguous array of another dtype is
    wrapped without a copy: pass one the caller no longer writes."""
    a = onp.asarray(a)
    if a.dtype == onp.float64:
        a = a.astype(onp.float32)
    elif a.dtype == onp.int64:
        a = a.astype(onp.int32)
    elif not (a.flags.c_contiguous and a.flags.writeable
              and a.flags.owndata):
        a = onp.array(a, order="C")
    return NDArray._wrap(torch.from_numpy(a))


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=onp.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Parity: io.py DataIter."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(self.getdata(), self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        return 0


def _init_data(data, allow_empty, default_name):
    if data is None:
        return []
    if isinstance(data, (onp.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        data = {f"{default_name}{'_' + str(i) if i else ''}": d
                for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, onp.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """Parity: io.py NDArrayIter:490 (shuffle, pad/discard/roll_over)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0] if self.data else 0
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size
        self._idx = onp.arange(self.num_data)
        if shuffle:
            onp.random.shuffle(self._idx)

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def reset(self):
        self.cursor = -self.batch_size
        if self.shuffle:
            onp.random.shuffle(self._idx)

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def _take(self, source):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            sel = self._idx[self.cursor:end]
        else:  # pad by wrapping around
            pad = end - self.num_data
            sel = onp.concatenate([self._idx[self.cursor:], self._idx[:pad]])
        return [host_nd(v[sel]) for _, v in source]

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getpad(self):
        end = self.cursor + self.batch_size
        return max(0, end - self.num_data)


class CSVIter(DataIter):
    """Parity: the C++ CSVIter (src/io/iter_csv.cc) — host-side here."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=None,
                 batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = onp.loadtxt(data_csv, delimiter=",", dtype=onp.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = onp.loadtxt(label_csv, delimiter=",", dtype=onp.float32)
            if label_shape:
                label = label.reshape((-1,) + tuple(label_shape))
        self._inner = NDArrayIter(data, label, batch_size,
                                  last_batch_handle="pad")

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()


class ResizeIter(DataIter):
    """Resize an iterator to a fixed number of batches (parity: io.py
    ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur == self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch

    def iter_next(self):
        return self.cur < self.size


class PrefetchingIter(DataIter):
    """Prefetcher scheduled on the native C++ dependency engine (parity:
    io.py PrefetchingIter over the C++ threaded prefetcher,
    src/io/iter_prefetcher.h): fetch tasks are engine ops serialized by a
    mutable variable (exclusive access to the base iterator, ordered),
    running on the engine's worker pool.  Falls back to a Python thread
    if the native engine cannot load."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 prefetch_depth=2):
        if not isinstance(iters, list):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter here supports one base iter")
        self.iter = iters[0]
        super().__init__(self.iter.batch_size)
        self._depth = prefetch_depth
        self._queue: _queue.Queue = _queue.Queue(maxsize=prefetch_depth)
        self._thread = None
        self._stop = threading.Event()
        try:
            from ..engine import native_engine
            self._engine = native_engine()
            self._iter_var = self._engine.new_var()
        except Exception:
            self._engine = None
        self._start()

    def _fetch_one(self):
        if self._stop.is_set() or self._done:
            return
        try:
            batch = self.iter.next()
        except StopIteration:
            self._done = True
            self._queue.put(None)
            return
        self._queue.put(batch)

    def _start(self):
        self._done = False
        if self._engine is not None:
            for _ in range(self._depth):
                self._engine.push(self._fetch_one,
                                  mutable_vars=[self._iter_var])
            return

        def run():
            while not self._stop.is_set():
                try:
                    batch = self.iter.next()
                except StopIteration:
                    self._queue.put(None)
                    return
                self._queue.put(batch)
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def reset(self):
        self._stop.set()
        if self._engine is not None:
            # drain so in-flight fetch tasks can't block on a full queue
            while True:
                try:
                    self._queue.get_nowait()
                except _queue.Empty:
                    if self._engine is not None:
                        self._engine.wait_for_var(self._iter_var)
                    try:
                        self._queue.get_nowait()
                        continue
                    except _queue.Empty:
                        break
        else:
            try:
                while True:
                    self._queue.get_nowait()
            except _queue.Empty:
                pass
            if self._thread is not None:
                self._thread.join(timeout=5)
        self._stop.clear()
        self.iter.reset()
        self._start()

    def next(self):
        batch = self._queue.get()
        if batch is None:
            raise StopIteration
        if self._engine is not None and not self._done:
            # refill: one consumed → schedule one more fetch
            self._engine.push(self._fetch_one, mutable_vars=[self._iter_var])
        return batch

    def iter_next(self):
        return True


class MNISTIter(DataIter):
    """Iterator over the original MNIST idx files (parity:
    src/io/iter_mnist.cc MNISTIter): reads idx3-ubyte images +
    idx1-ubyte labels, optional shuffle/flat/silent, scales pixels
    to [0,1] like the reference.
    """

    def __init__(self, image, label, batch_size=128, shuffle=False,
                 flat=False, silent=False, seed=0, part_index=0,
                 num_parts=1, **kwargs):
        super().__init__(batch_size)
        import gzip
        import struct

        def opener(path):
            return gzip.open(path, "rb") if path.endswith(".gz") \
                else open(path, "rb")

        with opener(image) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise MXNetError(f"{image} is not an idx3-ubyte file")
            X = onp.frombuffer(f.read(n * rows * cols), onp.uint8)
            X = X.reshape(n, rows, cols).astype("float32") / 255.0
        with opener(label) as f:
            magic, n2 = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise MXNetError(f"{label} is not an idx1-ubyte file")
            Y = onp.frombuffer(f.read(n2), onp.uint8).astype("float32")
        if n != n2:
            raise MXNetError("image/label counts differ")
        # multi-part reading (parity: part_index/num_parts fields)
        X = X[part_index::num_parts]
        Y = Y[part_index::num_parts]
        if shuffle:
            perm = onp.random.RandomState(seed).permutation(len(X))
            X, Y = X[perm], Y[perm]
        X = X.reshape(len(X), -1) if flat else X[:, None, :, :]
        if not silent:
            print(f"MNISTIter: load {len(X)} images, shuffle={shuffle}, "
                  f"flat={flat}")
        self._X, self._Y = X, Y
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self._X.shape[1:])]

    @property
    def provide_label(self):
        return [DataDesc("softmax_label", (self.batch_size,))]

    def reset(self):
        self._cursor = 0

    def next(self):
        if self._cursor + self.batch_size > len(self._X):
            raise StopIteration
        i = self._cursor
        self._cursor += self.batch_size
        return DataBatch(
            data=[host_nd(self._X[i:i + self.batch_size])],
            label=[host_nd(self._Y[i:i + self.batch_size])], pad=0,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
