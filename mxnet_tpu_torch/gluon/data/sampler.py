"""Samplers (counterpart of ``mxnet_tpu/gluon/data/sampler.py``; parity:
python/mxnet/gluon/data/sampler.py)."""
from __future__ import annotations

import numpy as onp

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "IntervalSampler", "FilterSampler", "BucketSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(onp.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class IntervalSampler(Sampler):
    def __init__(self, length, interval, rollover=True):
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            yield from range(i, self._length, self._interval)

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class BatchSampler(Sampler):
    """Parity: sampler.py BatchSampler (last_batch keep/discard/rollover)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                pass
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(f"invalid last_batch {self._last_batch}")

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._prev)) // self._batch_size


class BucketSampler(Sampler):
    """Batch sampler grouping samples of similar length into buckets.

    Parity: the reference's bucketing story (io.BucketSentenceIter /
    example/rnn/bucketing): variable-length training pads each batch
    only to its bucket's length, and the executor is captured once per
    bucket signature (a hybridized block's or a trainer's graph per
    signature) — feed it batches from this sampler and each bucket is
    captured exactly once.

    Parameters
    ----------
    lengths : sequence of int — per-sample sequence lengths.
    batch_size : int
    bucket_keys : list of int, optional — bucket boundary lengths
        (each sample goes to the smallest key >= its length; longer
        samples are dropped like the reference's BucketSentenceIter).
        Default: ``num_buckets`` evenly spaced quantile keys.
    num_buckets : int — used when bucket_keys is None (default 5).
    shuffle : bool — shuffle within buckets and the batch order.
    last_batch : 'keep'|'discard' per bucket.
    """

    def __init__(self, lengths, batch_size, bucket_keys=None,
                 num_buckets=5, shuffle=True, last_batch="keep", seed=0):
        self._lengths = onp.asarray(lengths, onp.int64)
        self._batch_size = int(batch_size)
        if bucket_keys is None:
            qs = onp.linspace(0, 100, num_buckets + 1)[1:]
            bucket_keys = sorted(set(
                int(onp.percentile(self._lengths, q)) for q in qs))
        self._keys = sorted(int(k) for k in bucket_keys)
        self._shuffle = shuffle
        self._last_batch = last_batch
        self._rng = onp.random.RandomState(seed)
        self._buckets = {k: [] for k in self._keys}
        for i, ln in enumerate(self._lengths):
            for k in self._keys:
                if ln <= k:
                    self._buckets[k].append(i)
                    break

    @property
    def bucket_keys(self):
        return list(self._keys)

    def bucket_of(self, idx):
        """Bucket key that sample ``idx`` falls into (None if dropped)."""
        ln = self._lengths[idx]
        for k in self._keys:
            if ln <= k:
                return k
        return None

    def _batches(self):
        out = []
        for k in self._keys:
            idxs = list(self._buckets[k])
            if self._shuffle:
                self._rng.shuffle(idxs)
            for i in range(0, len(idxs), self._batch_size):
                b = idxs[i:i + self._batch_size]
                if len(b) < self._batch_size and \
                        self._last_batch == "discard":
                    continue
                out.append(b)
        if self._shuffle:
            self._rng.shuffle(out)
        return out

    def __iter__(self):
        return iter(self._batches())

    def __len__(self):
        n = 0
        for k in self._keys:
            sz = len(self._buckets[k])
            if self._last_batch == "discard":
                n += sz // self._batch_size
            else:
                n += (sz + self._batch_size - 1) // self._batch_size
        return n
