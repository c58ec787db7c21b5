"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Parity: python/mxnet/gluon/data/dataloader.py:187 (DataLoader with
multiprocessing workers + shared-memory NDArray hand-off).  Batches are
host (CPU) NDArrays until the consumer moves them: the training step
stages them, or ``prefetch_to_device`` hands the epoch to
``data.DevicePrefetcher``, which copies them to the card on a side
stream ahead of the step.

Process workers are forked by default, from a parent that has usually
initialised CUDA: a worker never touches the card (its batchify is
numpy-only and the datasets yield host arrays), its initializer sets
``torch.set_num_threads(1)`` (torch's intra-op pool does not survive a
fork) and clears the autograd and whole-step capture state it inherited,
so a transform ``HybridBlock`` it calls never enters a step's tape.  The
dataset and batchify function reach each worker once, through the pool's
initializer (inherited at the fork), not with every batch's task.
"""
from __future__ import annotations

import multiprocessing
import os
import queue as _queue
import threading
import weakref
import numpy as onp
import torch

from ...base import MXNetError
from ...io.io import host_nd
from ...ndarray import NDArray
from .dataset import Dataset
from .sampler import BatchSampler, RandomSampler, SequentialSampler, Sampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def _stack_nd(data):
    """NDArray samples stacked on the host, as one host tensor."""
    return torch.stack([d._data.detach().cpu() for d in data])


def default_batchify_fn(data):
    """Stack samples into a host batch (parity: dataloader.py
    default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        return NDArray._wrap(_stack_nd(data))
    if isinstance(data[0], (tuple, list)):
        return tuple(default_batchify_fn(list(x)) for x in zip(*data))
    return host_nd(onp.asarray(data))


def default_mp_batchify_fn(data):
    """Worker-side batchify: stacks to host numpy only, never touching the
    device runtime (parity: dataloader.py default_mp_batchify_fn, which
    batches into shared-memory NDArrays — here the invariant is instead
    "no CUDA in worker processes", since a forked child of a parent that
    initialised CUDA cannot use it)."""
    if isinstance(data[0], NDArray):
        return _stack_nd(data).numpy()
    if isinstance(data[0], (tuple, list)):
        return tuple(default_mp_batchify_fn(list(x)) for x in zip(*data))
    arr = onp.asarray(data)
    if arr.dtype == onp.float64:
        arr = arr.astype(onp.float32)
    return arr


# sentinels for the num_workers=0 background-prefetch hand-off
_SYNC_DONE = object()
_SYNC_ERR = object()

_FORK_GUARD_DONE = False


def _install_fork_guard():
    """Drain the native host engine before any fork so none of its
    closures is mid-flight in the parent (parity: src/initialize.cc:
    70-97, which pauses the engine around fork via pthread_atfork).
    Device work needs no drain: a worker never touches the card."""
    global _FORK_GUARD_DONE
    if _FORK_GUARD_DONE:
        return
    _FORK_GUARD_DONE = True

    def _quiesce():
        from ... import engine
        if engine._native_engine is not None:
            try:
                engine._native_engine.wait_all()
            except Exception:
                pass

    os.register_at_fork(before=_quiesce)


def _mp_context():
    """Pick the worker start method. Default is fork — spawn would
    re-import ``__main__`` and break plain user scripts without a main
    guard (and interactive sessions entirely).  Fork is made safe the
    way the reference makes it safe (src/initialize.cc:70-97): the
    host engine is drained immediately before every fork, and
    worker-side batchify never touches the device runtime (numpy-only),
    so children never enter the CUDA context they inherited.  Set
    ``MXNET_MP_START_METHOD=spawn`` (or forkserver) to override."""
    method = os.environ.get("MXNET_MP_START_METHOD", "")
    if method not in ("fork", "spawn", "forkserver"):
        method = "fork"
    if method == "fork":
        _install_fork_guard()
    return multiprocessing.get_context(method)


def _to_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, tuple):
        return tuple(_to_np(e) for e in x)
    return x


# -- shared-memory batch hand-off ------------------------------------------
# Parity: CPUSharedStorageManager + the DataLoader ForkingPickler path
# (src/storage/cpu_shared_storage_manager.h, gluon/data/dataloader.py:28-138):
# workers place batch tensors in POSIX shared memory and send only a
# (name, layout) descriptor through the pipe, so large batches are never
# pickled through the result queue.  The parent maps the segment,
# uploads straight from the mapped view, then unlinks.

def _shm_pack(batch):
    from multiprocessing import shared_memory, resource_tracker
    leaves = []

    def collect(x):
        if isinstance(x, onp.ndarray):
            leaves.append(x)
            return ("__a__", len(leaves) - 1)
        if isinstance(x, tuple):
            return tuple(collect(e) for e in x)
        return x

    tree = collect(batch)
    total = sum(a.nbytes for a in leaves)
    # size >= 1 even when every leaf is empty: zero-size leaves still
    # need their (shape, dtype) metas for reconstruction
    shm = shared_memory.SharedMemory(create=True, size=max(total, 1))
    # the parent owns the segment's lifetime: unregister it from this
    # worker's resource tracker so worker exit doesn't unlink/warn
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass
    metas = []
    off = 0
    for a in leaves:
        a = onp.ascontiguousarray(a)
        dst = onp.ndarray(a.shape, dtype=a.dtype, buffer=shm.buf,
                          offset=off)
        onp.copyto(dst, a)
        metas.append((off, a.shape, str(a.dtype)))
        off += a.nbytes
    name = shm.name
    shm.close()
    return ("__shm__", name, metas, tree)


def _shm_unpack(payload):
    from multiprocessing import shared_memory
    _, name, metas, tree = payload
    shm = shared_memory.SharedMemory(name=name) if name else None
    try:
        def rebuild(x):
            if isinstance(x, tuple):
                if len(x) == 2 and x[0] == "__a__":
                    off, shape, dtype = metas[x[1]]
                    view = onp.ndarray(shape, dtype=dtype, buffer=shm.buf,
                                       offset=off)
                    # one owned host copy before the segment is
                    # unlinked; the NDArray wraps it without another
                    return host_nd(onp.array(view))
                return tuple(rebuild(e) for e in x)
            return x

        return rebuild(tree)
    finally:
        if shm is not None:
            shm.close()
            shm.unlink()


def _unlink_payload(result):
    """Unlink the shm segment behind a worker payload the parent will
    never unpack (early exit, mid-yield failure) — the workers disowned
    it (_shm_pack), so the parent is its only owner."""
    if (isinstance(result, tuple) and len(result) == 4
            and result[0] == "__shm__" and result[1]):
        try:
            from multiprocessing import shared_memory
            seg = shared_memory.SharedMemory(name=result[1])
            seg.close()
            seg.unlink()
        except Exception:
            pass


# a process worker's dataset and batchify function, set once by the
# pool's initializer
_worker_dataset = None
_worker_batchify = None


def _worker_init(dataset, batchify_fn):
    """A process worker's initializer: one intra-op thread, no autograd
    recording and no whole-step capture state inherited from the parent
    thread that forked it, and the loader's dataset and batchify."""
    global _worker_dataset, _worker_batchify
    torch.set_num_threads(1)
    from ... import autograd
    from ...imperative import cached_step
    autograd.set_recording(False)
    autograd.set_training(False)
    cached_step.reset_after_fork()
    _worker_dataset, _worker_batchify = dataset, batchify_fn


def _worker_fn(indices, use_shm=False):
    batch = _to_np(_worker_batchify([_worker_dataset[i] for i in indices]))
    if use_shm:
        return _shm_pack(batch)
    return batch


def _thread_worker_fn(dataset, batchify_fn, indices):
    return _to_np(batchify_fn([dataset[i] for i in indices]))


class DataLoader:
    """Loads batches from a Dataset (parity: gluon.data.DataLoader).

    Beyond the reference surface:

    - ``prefetch`` is honored for ``num_workers=0`` too: a bounded
      background thread runs sampling+batchify ``prefetch`` batches
      ahead of the consumer (the reference silently ignores it without
      workers).  The default stays ``2 * num_workers`` — i.e. 0, the
      fully synchronous path — unless ``prefetch`` is passed.
    - ``prefetch_to_device`` hands the epoch iterator to the async
      device-feed pipeline (``data.DevicePrefetcher``): batches arrive
      on the card, their copies made on a side stream while the step
      computes.  Pass ``True`` (``cuda:0``), a trainer (``SPMDTrainer``
      / ``gluon.Trainer`` — batches land on its device), a
      ``torch.device`` / ``Context`` / device string, or a callable
      ``leaf -> device``.  ``MXNET_DEVICE_PREFETCH=0`` disables it
      (bitwise-identical host path).
    """

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, use_shared_mem=None,
                 prefetch_to_device=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        # shared-memory hand-off is the default for process workers
        # (parity: the reference's shm ForkingPickler fast path); set
        # MXNET_DATALOADER_SHM=0 or use_shared_mem=False to fall back to
        # pipe pickling
        if use_shared_mem is None:
            use_shared_mem = os.environ.get(
                "MXNET_DATALOADER_SHM", "1") not in ("0", "false", "off")
        self._use_shm = bool(use_shared_mem) and num_workers > 0 \
            and not thread_pool
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size required when batch_sampler "
                                 "is not set")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with custom sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError("batch_size/shuffle/sampler/last_batch are "
                             "mutually exclusive with batch_sampler")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        if batchify_fn is not None:
            self._batchify_fn = batchify_fn
        elif self._num_workers > 0 and not thread_pool:
            self._batchify_fn = default_mp_batchify_fn
        else:
            self._batchify_fn = default_batchify_fn
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._thread_pool = thread_pool
        self._timeout = timeout
        self._pool = None
        self._prefetch_to_device = prefetch_to_device

    def _get_pool(self):
        if self._pool is None:
            if self._thread_pool:
                from multiprocessing.pool import ThreadPool
                self._pool = ThreadPool(self._num_workers)
            else:
                self._pool = _mp_context().Pool(
                    self._num_workers, initializer=_worker_init,
                    initargs=(self._dataset, self._batchify_fn))
            # weakref.finalize runs before interpreter teardown (unlike
            # __del__ on a module-global loader), so workers die cleanly
            weakref.finalize(self, _shutdown_pool, self._pool)
        return self._pool

    def __iter__(self):
        it = self._iter_impl()
        ptd = self._prefetch_to_device
        if ptd is None or ptd is False:
            return it
        from ...data import device_pipeline
        # one epoch per wrap: the pipeline owns this epoch's generator
        # (its shutdown close()s it, running the shm finally-drain)
        return iter(device_pipeline.wrap(
            it, None if ptd is True else ptd))

    def _iter_impl(self):
        if self._num_workers == 0:
            if self._prefetch > 0:
                return self._threaded_sync_iter()
            return (self._batchify_fn([self._dataset[i] for i in indices])
                    for indices in self._batch_sampler)
        return self._worker_iter()

    def _threaded_sync_iter(self):
        """num_workers=0 with prefetch>0: sampling + batchify run in one
        bounded background thread, ``prefetch`` batches ahead.  Same
        order, same batches — just pipelined against the consumer."""
        q: _queue.Queue = _queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        dataset, batchify = self._dataset, self._batchify_fn
        sampler = self._batch_sampler

        def produce():
            def put(item) -> bool:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except _queue.Full:
                        continue
                return False

            try:
                for indices in sampler:
                    if stop.is_set():
                        return
                    if not put((None,
                                batchify([dataset[i] for i in indices]))):
                        return
                put((_SYNC_DONE, None))
            except BaseException as e:   # surfaced at the consumer
                put((_SYNC_ERR, e))

        t = threading.Thread(target=produce, name="DataLoaderPrefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                try:
                    tag, payload = q.get(timeout=self._timeout)
                except _queue.Empty:
                    raise MXNetError(
                        f"DataLoader: no batch within timeout="
                        f"{self._timeout} s") from None
                if tag is _SYNC_DONE:
                    return
                if tag is _SYNC_ERR:
                    raise payload
                yield payload
        finally:
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except _queue.Empty:
                    break
            if t is not threading.current_thread():
                t.join(timeout=10)

    def _worker_iter(self):
        pool = self._get_pool()
        pending = []
        it = iter(self._batch_sampler)

        def submit():
            try:
                indices = next(it)
            except StopIteration:
                return False
            if self._thread_pool:
                pending.append(pool.apply_async(
                    _thread_worker_fn,
                    (self._dataset, self._batchify_fn, indices)))
            else:
                pending.append(pool.apply_async(
                    _worker_fn, (indices, self._use_shm)))
            return True

        for _ in range(self._prefetch + 1):
            if not submit():
                break
        try:
            while pending:
                result = pending.pop(0).get(self._timeout)
                # the popped payload is outside pending, so the
                # finally-drain below can no longer see it: from here
                # until _shm_unpack takes ownership (it unlinks even
                # when unpacking raises), any exception — submit()'s
                # sampler/pool failure included — must unlink it here
                try:
                    submit()
                    is_shm = (isinstance(result, tuple)
                              and len(result) == 4
                              and result[0] == "__shm__")
                    payload, result = result, None
                    yield (_shm_unpack(payload) if is_shm
                           else _rewrap(payload))
                finally:
                    if result is not None:
                        _unlink_payload(result)
        finally:
            # consumer stopped early (break/exception/GeneratorExit):
            # drain in-flight results and unlink their shm segments,
            # which the workers deliberately disowned (_shm_pack).
            # Without shm there is nothing to clean up — don't stall
            # the caller's early exit on in-flight batches.
            if not self._use_shm:
                pending = []
            if pending:
                # Drain synchronously with a short per-future timeout so
                # a plain `break` returns promptly (bounded by
                # ~0.5s x prefetch, not timeout x prefetch) while still
                # unlinking segments before pool teardown can race us.
                # Stragglers get a best-effort daemon-thread drain.
                stragglers = []
                for fut in pending:
                    try:
                        _unlink_payload(fut.get(0.5))
                    except multiprocessing.TimeoutError:
                        stragglers.append(fut)
                    except Exception:
                        pass
                if stragglers:
                    timeout = self._timeout

                    def _drain_stragglers():
                        for fut in stragglers:
                            try:
                                _unlink_payload(fut.get(timeout))
                            except Exception:
                                pass

                    threading.Thread(target=_drain_stragglers,
                                     daemon=True).start()

    def __len__(self):
        return len(self._batch_sampler)

    def __del__(self):
        if self._pool is not None:
            _shutdown_pool(self._pool)
            self._pool = None


def _shutdown_pool(pool):
    try:
        pool.terminate()
        pool.join()
    except Exception:
        pass


def _rewrap(x):
    if isinstance(x, onp.ndarray):
        return host_nd(x)
    if isinstance(x, tuple):
        return tuple(_rewrap(e) for e in x)
    return x
