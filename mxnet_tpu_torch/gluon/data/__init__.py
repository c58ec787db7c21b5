"""gluon.data (counterpart of ``mxnet_tpu/gluon/data/``; parity:
python/mxnet/gluon/data/)."""
from .dataset import Dataset, SimpleDataset, ArrayDataset, RecordFileDataset
from .sampler import (Sampler, SequentialSampler, RandomSampler, BatchSampler,
                      IntervalSampler, FilterSampler, BucketSampler)
from .dataloader import DataLoader, default_batchify_fn
from . import batchify
from . import vision

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "IntervalSampler", "FilterSampler", "BucketSampler", "DataLoader",
           "batchify", "vision"]
