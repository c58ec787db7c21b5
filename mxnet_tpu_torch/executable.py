"""One captured executable: the CUDA counterpart of the reference's
``jax.jit(fn).lower(*args).compile()``.  The decode engine keeps one per
exec key (``decode``, ``draft``, ``verify``, ``prefill_b{n}``, ...) and
``SPMDTrainer`` one per step and predict signature.

An :class:`Executable` owns:

- its static inputs: one byte buffer on the device holding every input
  at a fixed address, each in a 16-byte aligned slice viewed in the
  input's dtype and shape, with a pinned host twin, so that a call
  stages all of its host inputs with one host-to-device copy; an input
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
from .ops.attention import flash_bwd_dkdv, flash_bwd_dq, flash_fwd
from .ops.paged_attention import paged_attention
from .ops.rope import rope

__all__ = ["Executable", "input_spec"]

_ALIGN = 16
# wrappers whose launches a graph holds
_COUNTED = (paged_attention, rope, flash_fwd, flash_bwd_dkdv, flash_bwd_dq)


def input_spec(a):
    """(shape, torch dtype) of an input: a tensor, a numpy array or a
    scalar."""
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), a.dtype
    a = onp.asarray(a)
    return a.shape, torch.from_numpy(a).dtype


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
        with torch.cuda.stream(side):
            warm = self.fn(*self.inputs)      # configs, K4's scratch
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
        return warm

    def _stage(self, args):
        """Host inputs into the host twin and over in one copy; device
        inputs device to device, after it."""
        if self._copied is not None:
            self._copied.synchronize()
        end, on_device = 0, []
        for i, a in enumerate(args):
            if isinstance(a, torch.Tensor):
                if a.device.type != "cpu" and self._dev is not self._host:
                    on_device.append((self.inputs[i], a))
                    continue
                self._host_views[i].copy_(a)
            elif self._staged[i] is not None:
                self._staged[i][...] = a
            else:
                self._host_views[i].copy_(torch.as_tensor(onp.asarray(a)))
            end = max(end, self._ends[i])
        if self._dev is self._host:
            return
        if end:
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
