"""One captured executable: the CUDA counterpart of the reference's
``jax.jit(fn).lower(*args).compile()``.  The decode engine keeps one per
exec key (``decode``, ``draft``, ``verify``, ``prefill_b{n}``, ...) and
``SPMDTrainer`` one per step and predict signature.

An :class:`Executable` owns:

- its static inputs: one byte buffer on the device holding every input
  at a fixed address, each in a 16-byte aligned slice viewed in the
  input's dtype and shape, with a pinned host twin, so that a call
  stages all of its host inputs with one host-to-device copy (a batch
  given as :class:`Rows` is written row by row into the twin); an input
  that already lies on the device is copied device to device into its
  slice instead;
- on a CUDA device, a ``torch.cuda.CUDAGraph`` of ``fn`` over those
  inputs, captured after one eager warm run (the warm run resolves
  every kernel config and makes K4's scratch outside the graph).  An
  owner's graphs share a memory pool, since they replay in turn on one
  stream, and a capture stream, since cuBLAS keeps a workspace for each
  stream it runs on and a graph holds the address of its capture
  stream's;
- the graph's static outputs.

The warm run comes in two kinds (``warm``):

- ``"zeros"``: in the constructor, on zeroed inputs.  ``fn`` must be
  harmless there: the decode cores mask every slot and a prefill chunk
  of length 0 writes nothing but the drop page.
- ``"first_call"``: the first call runs ``fn`` eagerly on its real
  inputs, as the call itself, and the capture follows it; the second
  call is the first replay.  A training step is not harmless on any
  input (Adam moves its moments even at lr 0), so each call applies
  exactly one step.

A call copies the inputs in, replays the graph and returns the static
outputs.  The next call of ANY executable of the pool may overwrite
them (a graph captured later can place its outputs where an earlier
one keeps temporaries), so read or copy them first.  On the CPU (an
owner on ``device="cpu"``, which only the tests ask for) nothing is
captured: a call runs ``fn`` on the static inputs.  On CUDA an
executable captures or raises; it never falls back to running ``fn``
eagerly.

A function that draws from ``mx.random`` (a Dropout in a training step)
draws in its warm run, and the capture then registers the device's
generator with the graph: each replay takes the generator's offset at
that moment and advances it, so replays draw fresh numbers and a replay
is bitwise the eager run from the same generator state
(``ops/random.py``).

A capture records kernel launches without running them, so the launch
counts that the wrappers tick in Python (``paged_attention.launches``,
``rope.launches``, the flash kernels' ``launches``) move from the
capture to every replay.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as onp
import torch

from .base import MXNetError
from .ops import random as _rng
from .ops.attention import flash_bwd_dkdv, flash_bwd_dq, flash_fwd
from .ops.paged_attention import paged_attention
from .ops.rope import rope

__all__ = ["Executable", "CaptureOwner", "Rows", "input_spec"]

_ALIGN = 16
# wrappers whose launches a graph holds
_COUNTED = (paged_attention, rope, flash_fwd, flash_bwd_dkdv, flash_bwd_dq)


class CaptureOwner:
    """What an owner of executables keeps beside them (the decode
    engine, ``SPMDTrainer``, a trainer's cached steps, a hybridized
    block): the memory pool and capture stream its graphs share, made at
    first use on a card, and the embedding-id check its last captured
    call deferred."""

    __slots__ = ("_with", "_pending")

    def __init__(self):
        self._with = None
        self._pending = None

    def capture_with(self, device):
        """``(graph pool, capture stream)`` on a CUDA ``device``, else
        ``(None, None)``."""
        if self._with is None:
            self._with = (None, None)
            if device.type == "cuda":
                with torch.cuda.device(device):
                    self._with = (torch.cuda.graph_pool_handle(),
                                  torch.cuda.Stream(device))
        return self._with

    def defer_ids(self, bounds, vocabs, device) -> None:
        """A captured call's embedding id bounds (None: no embedding ran):
        on the CPU, raise now if an id was out of range; on CUDA, copy
        them to the host behind the call's work, for the next call's
        :meth:`check_ids`."""
        from .ops.tensor import IdCheck
        if bounds is None:
            return
        if device.type != "cuda":
            IdCheck.raise_if_bad(bounds, list(vocabs))
            return
        host = torch.empty(bounds.shape, dtype=bounds.dtype,
                           pin_memory=True)
        host.copy_(bounds, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        self._pending = (host, list(vocabs), done)

    def check_ids(self) -> None:
        """Raise the previous call's embedding error, if it had one."""
        pending, self._pending = self._pending, None
        if pending is not None:
            from .ops.tensor import IdCheck
            host, vocabs, done = pending
            done.synchronize()
            IdCheck.raise_if_bad(host, vocabs)


class Rows(list):
    """A batch input given as its rows (host arrays of the input's
    trailing shape, at most its leading size): each row is written
    straight into the input's host twin and the rows after the last are
    zeroed, so the batch is never stacked (nor padded) in a host array
    of its own first."""


def input_spec(a):
    """(shape, torch dtype) of an input: a tensor, a numpy array or a
    scalar."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.dtype
    a = onp.asarray(a)
    # the dtype of an empty array: ``a`` itself may have negative strides
    return a.shape, torch.from_numpy(onp.empty((0,), a.dtype)).dtype


class Executable:
    """``fn(*inputs)`` over static inputs shaped like ``args`` (tensors,
    numpy arrays or scalars; only their shapes and dtypes are read),
    captured as one CUDA graph on a CUDA ``device``."""

    def __init__(self, fn: Callable, args: Sequence, device: torch.device,
                 graph_pool=None, stream=None, warm: str = "zeros"):
        if warm not in ("zeros", "first_call"):
            raise MXNetError(f"Executable: warm must be 'zeros' or "
                             f"'first_call', got {warm!r}")
        self.fn = fn
        self.device = device
        self.graph = None
        self.outputs = None
        specs = [input_spec(a) for a in args]
        self._ends, size = [], 0
        offsets = []
        for shape, dtype in specs:
            offsets.append(size)
            nbytes = int(onp.prod(shape, dtype=onp.int64)) * dtype.itemsize
            self._ends.append(size + nbytes)
            size += -(-nbytes // _ALIGN) * _ALIGN
        cuda = device.type == "cuda"
        self._host = torch.zeros((max(size, _ALIGN),), dtype=torch.uint8,
                                 pin_memory=cuda)
        self._dev = self._host.to(device) if cuda else self._host
        self._host_views, self._staged, inputs = [], [], []
        for (shape, dtype), o, end in zip(specs, offsets, self._ends):
            view = self._host[o:end].view(dtype).view(shape)
            self._host_views.append(view)
            # numpy views of the host twin (numpy has no bfloat16)
            self._staged.append(view.numpy() if dtype != torch.bfloat16
                                else None)
            inputs.append(self._dev[o:end].view(dtype).view(shape))
        self.inputs = tuple(inputs)
        # the last copy out of the host twin (it must end before the twin
        # is written again)
        self._copied = torch.cuda.Event() if cuda else None
        self._scalars = {}      # input index → (dtype, bytes) last staged
        self._launches = [0] * len(_COUNTED)
        self._capture_with = (graph_pool, stream)
        self._warm_on_call = cuda and warm == "first_call"
        if cuda and not self._warm_on_call:
            with torch.cuda.device(device):
                self._capture()

    def _capture(self):
        """The warm run of ``fn`` on the capture stream, then the capture;
        returns the warm run's outputs."""
        dev = self.device
        graph_pool, side = self._capture_with
        if side is None:
            side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        drew = _rng.draws(dev)
        with torch.cuda.stream(side):
            warm = self.fn(*self.inputs)      # configs, K4's scratch
        drew = _rng.draws(dev) != drew
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [f.launches for f in _COUNTED]
        graph = torch.cuda.CUDAGraph()
        if drew:
            # each replay draws anew from mx.random's generator, at its
            # offset then, and moves it on as the eager run does
            graph.register_generator_state(_rng.generator(dev))
        from . import profiler
        try:
            # a running profiler cycle is closed around the capture
            with profiler.capture_guard(), torch.cuda.graph(
                    graph, pool=graph_pool, stream=side,
                    capture_error_mode="thread_local"):
                self.outputs = self.fn(*self.inputs)
        except Exception as e:
            err = MXNetError(f"CUDA graph capture failed: {e}")
            # what the warm run computed (and, for a step, applied)
            err.warm_outputs = warm
            raise err from e
        for i, f in enumerate(_COUNTED):
            self._launches[i] = f.launches - before[i]
            f.launches = before[i]            # nothing ran yet
        self.graph = graph
        return warm

    def _stage(self, args):
        """Host inputs into the host twin and over in one copy; device
        inputs device to device, after it.  A scalar equal to the one
        the last call staged is not written again, so a call whose batch
        is already on the device and whose scalars (a step's lr and wd)
        have not changed neither writes the twin nor waits for the last
        copy out of it."""
        end, on_device, host = 0, [], []
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor) and a.device.type != "cpu" \
                    and self._dev is not self._host:
                on_device.append((self.inputs[i], a))
                continue
            if not isinstance(a, (torch.Tensor, Rows)) and onp.ndim(a) == 0:
                v = onp.asarray(a)
                key = (v.dtype.str, v.tobytes())
                if self._scalars.get(i) == key:
                    end = max(end, self._ends[i])
                    continue
                self._scalars[i] = key
            host.append((i, a))
        if host and self._copied is not None:
            self._copied.synchronize()
        for i, a in host:
            if isinstance(a, torch.Tensor):
                self._host_views[i].copy_(a)
            elif isinstance(a, Rows) and self._staged[i] is not None:
                view = self._staged[i]
                for j, row in enumerate(a):
                    view[j] = row
                view[len(a):] = 0
            elif self._staged[i] is not None:
                self._staged[i][...] = a
            else:
                self._host_views[i].copy_(torch.as_tensor(onp.asarray(a)))
            end = max(end, self._ends[i])
        if self._dev is self._host:
            return
        if host:
            self._dev[:end].copy_(self._host[:end], non_blocking=True)
            self._copied.record()
        for dst, src in on_device:
            dst.copy_(src)

    def __call__(self, *args):
        """Stage ``args`` and replay (on the CPU: run ``fn``); returns the
        outputs.  With ``warm="first_call"`` the first call on CUDA runs
        ``fn`` eagerly, returns its outputs and captures."""
        self._stage(args)
        if self.graph is None:
            if self._warm_on_call:
                with torch.cuda.device(self.device):
                    return self._capture()
            return self.fn(*self.inputs)
        self.graph.replay()
        for f, n in zip(_COUNTED, self._launches):
            f.launches += n
        return self.outputs

    def eager(self, *args):
        """``fn`` run eagerly on the static inputs, after staging ``args``
        when given: the launches a replay stands for, for comparisons."""
        if args:
            self._stage(args)
        return self.fn(*self.inputs)
