"""Runtime kernel compilation (counterpart of ``mxnet_tpu/rtc.py``).

Parity: MXNet's ``mx.rtc``, whose ``CudaModule``/``CudaKernel`` compile
CUDA C at runtime and launch it on NDArrays.  The reference re-expressed
it for the TPU as ``PallasModule`` (Pallas source launched through
``pl.pallas_call``); the port returns to CUDA C.  The source is compiled
with nvcc into a cubin for ``sm_90a`` at the first launch (cached per
module, and on disk by a hash of the source and the options:
``kernels/build.py`` ``build_cubin``), loaded with ``cuModuleLoadData``
and launched with ``cuLaunchKernel`` on PyTorch's current stream,
through the CUDA driver API over ctypes on ``libcuda.so.1``.

Kernel ABI — every kernel the module exports is declared::

    extern "C" __global__ void name(const T0* in0, ..., T* out, long long n)

with one pointer per input NDArray (in the order given to ``launch``),
the output's pointer, and ``n = out.numel()``.  The inputs are made
contiguous; the output is a new contiguous NDArray of
``out_shape``/``out_dtype`` on the inputs' card.  The default launch is
``ceil(n / 256)`` blocks of 256 threads; ``grid`` (an int or a tuple of
up to 3) overrides the blocks.  Example::

    src = r'''
    extern "C" __global__ void axpy(const float* x, const float* y,
                                    float* out, long long n) {
        long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
        if (i < n) out[i] = 2.0f * x[i] + y[i];
    }
    '''
    mod = rtc.CudaModule(src)
    k = mod.get_kernel("axpy", num_inputs=2)
    out = k.launch([a, b], out_shape=a.shape, out_dtype=a.dtype)

A user's kernel has no plain version: NDArrays on the CPU raise
:class:`MXNetError`, and nothing falls back.  ``CudaKernel.launches`` and
the module-level ``launches`` count the launches.
"""
from __future__ import annotations

import ctypes
import re
import threading
from typing import Optional, Sequence

import torch

from .base import MXNetError, check_shape, torch_dtype

__all__ = ["CudaModule", "CudaKernel", "launches"]

THREADS = 256                  # threads per block of every launch
launches = 0                   # every CudaKernel launch in the process

_DECL = re.compile(
    r'extern\s+"C"\s+__global__\s+'
    r'(?:__launch_bounds__\s*\([^)]*\)\s*)?void\s+'
    r'(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)\s*\(')
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)


class _Driver:
    """The CUDA driver API calls rtc makes, from ``libcuda.so.1``."""

    def __init__(self):
        lib = ctypes.CDLL("libcuda.so.1")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        u32 = ctypes.c_uint
        for name, args in (
                ("cuInit", [u32]),
                ("cuDeviceGet", [ctypes.POINTER(i32), i32]),
                ("cuDevicePrimaryCtxRetain", [ctypes.POINTER(ptr), i32]),
                ("cuCtxSetCurrent", [ptr]),
                ("cuModuleLoadData", [ctypes.POINTER(ptr), ctypes.c_char_p]),
                ("cuModuleGetFunction", [ctypes.POINTER(ptr), ptr,
                                         ctypes.c_char_p]),
                ("cuLaunchKernel", [ptr, u32, u32, u32, u32, u32, u32, u32,
                                    ptr, ctypes.POINTER(ptr),
                                    ctypes.POINTER(ptr)]),
                ("cuGetErrorString", [i32, ctypes.POINTER(ctypes.c_char_p)])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i32
        self._lib = lib
        self._contexts = {}              # device index → primary context
        self._check(lib.cuInit(0), "cuInit")

    def _check(self, err, what):
        if err:
            msg = ctypes.c_char_p()
            self._lib.cuGetErrorString(err, ctypes.byref(msg))
            text = msg.value.decode() if msg.value else f"error {err}"
            raise MXNetError(f"rtc: {what} failed: {text}")

    def make_current(self, index: int):
        """Make the device's primary context (the one PyTorch uses)
        current on the calling thread."""
        ctx = self._contexts.get(index)
        if ctx is None:
            dev, ctx = ctypes.c_int(), ctypes.c_void_p()
            self._check(self._lib.cuDeviceGet(ctypes.byref(dev), index),
                        "cuDeviceGet")
            self._check(self._lib.cuDevicePrimaryCtxRetain(
                ctypes.byref(ctx), dev), "cuDevicePrimaryCtxRetain")
            self._contexts[index] = ctx
        self._check(self._lib.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")

    def load(self, image: bytes, index: int):
        self.make_current(index)
        mod = ctypes.c_void_p()
        self._check(self._lib.cuModuleLoadData(ctypes.byref(mod), image),
                    "cuModuleLoadData")
        return mod

    def function(self, mod, name: str):
        fn = ctypes.c_void_p()
        self._check(self._lib.cuModuleGetFunction(
            ctypes.byref(fn), mod, name.encode()), "cuModuleGetFunction")
        return fn

    def launch(self, fn, index, grid, stream, params):
        """``params``: ctypes values (``c_void_p`` for each device
        pointer, ``c_longlong`` for ``n``), kept alive by the caller."""
        self.make_current(index)
        argv = (ctypes.c_void_p * len(params))(
            *[ctypes.addressof(p) for p in params])
        self._check(self._lib.cuLaunchKernel(
            fn, *grid, THREADS, 1, 1, 0, stream, argv, None),
            "cuLaunchKernel")


_DRIVER: Optional[_Driver] = None
_DRIVER_LOCK = threading.Lock()


def _driver() -> _Driver:
    global _DRIVER
    with _DRIVER_LOCK:
        if _DRIVER is None:
            _DRIVER = _Driver()
        return _DRIVER


def _grid(n: int, grid) -> tuple:
    if grid is None:
        return (-(-n // THREADS), 1, 1)
    dims = tuple(grid) if isinstance(grid, (tuple, list)) else (grid,)
    if not 1 <= len(dims) <= 3 or not all(
            isinstance(d, int) and d >= 1 for d in dims):
        raise MXNetError(f"rtc: grid must be a positive int or a tuple of "
                         f"up to 3, got {grid!r}")
    return dims + (1,) * (3 - len(dims))


class CudaModule:
    """CUDA C source compiled at runtime (parity: ``mx.rtc.CudaModule``).
    The exported kernels are read from the source's ``extern "C"
    __global__ void`` declarations, without a compiler; ``exports``
    narrows them.  ``options`` are extra nvcc flags."""

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        names = _DECL.findall(_COMMENT.sub("", source))
        if not names:
            raise MXNetError('CudaModule: the source declares no '
                             '`extern "C" __global__ void` kernel')
        missing = [e for e in exports if e not in names]
        if missing:
            raise MXNetError(f"CudaModule: exports {missing} are not "
                             f"declared in the source ({names})")
        self.source = source
        self.options = tuple(options)
        self.names = tuple(exports) or tuple(names)
        self.compile_seconds = None      # nvcc time of the first launch
        self._cubin = None
        self._modules = {}               # device index → CUmodule
        self._functions = {}             # (device index, name) → CUfunction
        self._lock = threading.Lock()

    def get_kernel(self, name: str, num_inputs: int = 1) -> "CudaKernel":
        if name not in self.names:
            raise MXNetError(f"kernel {name!r} not defined in module source "
                             f"(it declares {list(self.names)})")
        return CudaKernel(self, name, num_inputs)

    def _function(self, name: str, index: int):
        """The loaded kernel on a device, compiling the module at its
        first use."""
        with self._lock:
            fn = self._functions.get((index, name))
            if fn is not None:
                return fn
            if self._cubin is None:
                from .kernels.build import build_cubin
                path, _log, self.compile_seconds = build_cubin(
                    self.source, self.options)
                with open(path, "rb") as f:
                    self._cubin = f.read()
            mod = self._modules.get(index)
            if mod is None:
                mod = self._modules[index] = _driver().load(self._cubin,
                                                            index)
            fn = self._functions[(index, name)] = _driver().function(mod,
                                                                     name)
            return fn


class CudaKernel:
    """One launchable kernel of a :class:`CudaModule` (parity:
    ``mx.rtc.CudaKernel``)."""

    def __init__(self, module: CudaModule, name: str, num_inputs: int):
        self.module = module
        self.name = name
        self.num_inputs = int(num_inputs)
        self.launches = 0

    def launch(self, args: Sequence, out_shape, out_dtype="float32",
               grid=None):
        """Run the kernel on the NDArrays ``args`` and return a new
        NDArray of ``out_shape``/``out_dtype`` (through the op funnel,
        ``ops/registry.py`` ``apply_torch``)."""
        from .ndarray.ndarray import NDArray
        from .ops.registry import apply_torch
        if len(args) != self.num_inputs:
            raise MXNetError(f"kernel {self.name} expects {self.num_inputs} "
                             f"inputs, got {len(args)}")
        if not all(isinstance(a, NDArray) for a in args):
            raise MXNetError(f"kernel {self.name} takes NDArrays")
        devices = {a._data.device for a in args}
        if any(d.type != "cuda" for d in devices):
            raise MXNetError(f"kernel {self.name}: rtc kernels run on the "
                             f"GPU and have no plain version; got arrays on "
                             f"{sorted(map(str, devices))}")
        if len(devices) > 1:
            raise MXNetError(f"kernel {self.name}: inputs on several "
                             f"devices {sorted(map(str, devices))}")
        if devices:
            device = devices.pop()
        else:
            from .context import current_context
            device = current_context().torch_device
        shape, dtype = check_shape(out_shape), torch_dtype(out_dtype)
        return apply_torch(
            lambda *ts: self._run(ts, shape, dtype, device, grid), args)

    def _run(self, tensors, shape, dtype, device, grid):
        global launches
        out = torch.empty(shape, dtype=dtype, device=device)
        n = out.numel()
        if n == 0:
            return out
        dims = _grid(n, grid)
        ins = [t.detach().contiguous() for t in tensors]
        fn = self.module._function(self.name, device.index)
        params = [ctypes.c_void_p(t.data_ptr()) for t in ins] + [
            ctypes.c_void_p(out.data_ptr()), ctypes.c_longlong(n)]
        stream = torch.cuda.current_stream(device).cuda_stream
        _driver().launch(fn, device.index, dims, stream, params)
        self.launches += 1
        launches += 1
        return out
