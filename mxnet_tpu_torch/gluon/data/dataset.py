"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``).

Parity: python/mxnet/gluon/data/dataset.py (Dataset, SimpleDataset,
ArrayDataset, RecordFileDataset, transforms chaining) + the C++
random-access datasets of src/io/dataset.cc.
"""
from __future__ import annotations

import os

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract random-access dataset (parity: data/dataset.py Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return _FilteredDataset(self, fn)

    def shard(self, num_shards, index):
        return _ShardedDataset(self, num_shards, index)

    def take(self, count):
        return _TakenDataset(self, count)

    def sample(self, sampler):
        return _SampledDataset(self, sampler)

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if not lazy:
            return SimpleDataset([trans[i] for i in range(len(trans))])
        return trans

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirstClosure(fn), lazy)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _FilteredDataset(SimpleDataset):
    def __init__(self, data, fn):
        super().__init__([data[i] for i in range(len(data))
                          if fn(data[i])])


class _ShardedDataset(Dataset):
    def __init__(self, data, num_shards, index):
        if not 0 <= index < num_shards:
            raise MXNetError(f"shard index {index} out of range")
        self._data = data
        self._num = num_shards
        self._index = index
        length = len(data)
        shard_len = length // num_shards
        rest = length % num_shards
        self._start = shard_len * index + min(index, rest)
        self._end = self._start + shard_len + (index < rest)

    def __len__(self):
        return self._end - self._start

    def __getitem__(self, idx):
        return self._data[self._start + idx]


class _TakenDataset(Dataset):
    def __init__(self, data, count):
        self._data = data
        self._count = min(count, len(data))

    def __len__(self):
        return self._count

    def __getitem__(self, idx):
        if idx >= self._count:
            raise IndexError
        return self._data[idx]


class _SampledDataset(Dataset):
    def __init__(self, data, sampler):
        self._data = data
        self._indices = list(sampler)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, idx):
        return self._data[self._indices[idx]]


class ArrayDataset(Dataset):
    """Zip of arrays/datasets (parity: data/dataset.py ArrayDataset)."""

    def __init__(self, *args):
        if len(args) == 1 and isinstance(args[0], (list, tuple)):
            args = args[0]
        self._length = len(args[0])
        self._data = []
        for a in args:
            if len(a) != self._length:
                raise MXNetError("all arrays must have the same length")
            self._data.append(a)

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO file (parity: data/dataset.py
    RecordFileDataset over dmlc recordio; reader in ``recordio``)."""

    def __init__(self, filename):
        from ...recordio import IndexedRecordIO
        self._filename = filename
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = IndexedRecordIO(idx_file, filename, "r")

    def __len__(self):
        return len(self._record.keys)

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])
