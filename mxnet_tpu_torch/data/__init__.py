"""mxnet_tpu_torch.data — the device-feed input pipeline (counterpart of
``mxnet_tpu/data/``).

The host-to-device half of the input story: ``gluon.data`` produces host
batches (workers, batchify, shared memory); this package copies them to
the card ahead of the step that consumes them, on a side stream from a
ring of pinned buffers, so the copy overlaps the previous step's
compute instead of sitting on its critical path.
"""
from .device_pipeline import (DevicePrefetcher, advised_depth,
                              note_advice_depth, prefetch_depth, wrap)

__all__ = ["DevicePrefetcher", "prefetch_depth", "wrap",
           "note_advice_depth", "advised_depth"]
