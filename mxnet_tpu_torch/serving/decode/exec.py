"""One executable per exec key: the CUDA counterpart of the reference's
``jax.jit(fn).lower(*args).compile()`` in ``DecodeEngine._get_exec``.

An :class:`Executable` owns, for one key (``decode``, ``draft``,
``verify``, ``prefill_b{n}``, ``draft_prefill_b{n}``):

- its static inputs: one byte buffer on the device holding every input
  at a fixed address, each in a 16-byte aligned slice viewed in the
  input's dtype and shape, with a pinned host twin, so that a call
  stages all of its inputs with one host-to-device copy;
- on a CUDA device, a ``torch.cuda.CUDAGraph`` of ``fn`` over those
  inputs, captured after one eager warm run on zeroed inputs (the warm
  run resolves every kernel config and makes K4's scratch outside the
  graph).  An engine's graphs share a memory pool, since they replay in
  turn on one stream, and a capture stream, since cuBLAS keeps a
  workspace for each stream it runs on and a graph holds the address
  of its capture stream's;
- the graph's static outputs.

A call copies the inputs in, replays the graph and returns the static
outputs.  The next call of ANY executable of the pool may overwrite
them (a graph captured later can place its outputs where an earlier
one keeps temporaries), so read them first.  On the CPU (an engine on
``device="cpu"``, which only the tests ask for) nothing is captured: a
call runs ``fn`` on the static inputs.  On CUDA an executable captures
or raises; it never falls back to running ``fn`` eagerly.

``fn`` must be harmless on zeroed inputs: the decode cores mask every
slot and a prefill chunk of length 0 writes nothing but the drop page.

A capture records kernel launches without running them, so the launch
counts that the wrappers tick in Python (``paged_attention.launches``,
``rope.launches``) move from the capture to every replay.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as onp
import torch

from ...base import MXNetError
from ...ops.paged_attention import paged_attention
from ...ops.rope import rope

__all__ = ["Executable"]

_ALIGN = 16
_COUNTED = (paged_attention, rope)     # wrappers whose launches a graph holds


class Executable:
    """``fn(*inputs)`` over static inputs shaped like ``args`` (numpy
    arrays or scalars; only their shapes and dtypes are read), captured
    as one CUDA graph on a CUDA ``device``."""

    def __init__(self, fn: Callable, args: Sequence, device: torch.device,
                 graph_pool=None, stream=None):
        self.fn = fn
        self.device = device
        self.graph = None
        self.outputs = None
        arrays = [onp.asarray(a) for a in args]
        offsets, size = [], 0
        for a in arrays:
            offsets.append(size)
            size += -(-a.nbytes // _ALIGN) * _ALIGN
        cuda = device.type == "cuda"
        self._host = torch.zeros((max(size, _ALIGN),), dtype=torch.uint8,
                                 pin_memory=cuda)
        self._dev = self._host.to(device) if cuda else self._host
        host = self._host.numpy()
        self._staged = []                     # numpy views of the host twin
        inputs = []
        for a, o in zip(arrays, offsets):
            self._staged.append(host[o:o + a.nbytes].view(a.dtype)
                                .reshape(a.shape))
            inputs.append(self._dev[o:o + a.nbytes].view(
                torch.from_numpy(a).dtype).view(a.shape))
        self.inputs = tuple(inputs)
        # the last copy out of the host twin (it must end before the twin
        # is written again)
        self._copied = torch.cuda.Event() if cuda else None
        self._launches = [0] * len(_COUNTED)
        if cuda:
            with torch.cuda.device(device):
                self._capture(graph_pool, stream)

    def _capture(self, graph_pool, side):
        dev = self.device
        if side is None:
            side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.fn(*self.inputs)             # warm: configs, K4's scratch
        torch.cuda.current_stream(dev).wait_stream(side)
        before = [f.launches for f in _COUNTED]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=graph_pool, stream=side,
                                  capture_error_mode="thread_local"):
                self.outputs = self.fn(*self.inputs)
        except Exception as e:
            raise MXNetError(f"CUDA graph capture failed: {e}") from e
        for i, f in enumerate(_COUNTED):
            self._launches[i] = f.launches - before[i]
            f.launches = before[i]            # nothing ran yet
        self.graph = graph

    def _stage(self, args):
        if self._copied is not None:
            self._copied.synchronize()
        for view, a in zip(self._staged, args):
            view[...] = a
        if self._dev is not self._host:
            self._dev.copy_(self._host, non_blocking=True)
            self._copied.record()

    def __call__(self, *args):
        """Stage ``args`` and replay (on the CPU: run ``fn``); returns the
        outputs."""
        self._stage(args)
        if self.graph is None:
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
