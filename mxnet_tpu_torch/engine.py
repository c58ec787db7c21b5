"""The native threaded dependency engine (counterpart of the
``NativeEngine`` part of ``mxnet_tpu/engine.py``, :94-203).

Host work — data-pipeline stages such as ``io.PrefetchingIter``'s
fetches — pushed as closures with read (const) and write (mutable)
variable lists onto ``csrc/io/engine.cc``'s worker pool, with the
reference's ordering protocol (``threaded_engine.h:71-215``); an
exception raised by a closure surfaces at the next wait.  The device's
dataflow is CUDA streams', not this engine's.  The library is the native
IO library (``io.native.get_lib``), built at first use.
"""
from __future__ import annotations

__all__ = ["NativeEngine", "native_engine"]

import ctypes as _ct
import threading as _threading

_CB_TYPE = _ct.CFUNCTYPE(None, _ct.c_void_p)


class NativeEngine:
    """Parity: Engine::Get() push/wait API over the native engine.

    >>> eng = NativeEngine(num_workers=4)
    >>> v = eng.new_var()
    >>> eng.push(lambda: work(), mutable_vars=[v])
    >>> eng.wait_for_var(v)
    """

    def __init__(self, num_workers: int = 0):
        from .io.native import get_lib
        self._lib = get_lib()
        self._lib.EngineCreate.argtypes = [_ct.c_int]
        self._lib.EngineDestroy.argtypes = [_ct.c_void_p]
        self._lib.EngineNewVar.argtypes = [_ct.c_void_p]
        self._lib.EnginePushAsync.argtypes = [
            _ct.c_void_p, _CB_TYPE, _ct.c_void_p,
            _ct.POINTER(_ct.c_int64), _ct.c_int,
            _ct.POINTER(_ct.c_int64), _ct.c_int]
        self._lib.EngineWaitForVar.argtypes = [_ct.c_void_p, _ct.c_int64]
        self._lib.EngineWaitForAll.argtypes = [_ct.c_void_p]
        self._lib.EngineSetError.argtypes = [_ct.c_void_p, _ct.c_char_p]
        self._lib.EngineGetError.argtypes = [_ct.c_void_p, _ct.c_char_p,
                                             _ct.c_int]
        self._lib.EngineCreate.restype = _ct.c_void_p
        self._lib.EngineNewVar.restype = _ct.c_int64
        self._lib.EnginePushAsync.restype = _ct.c_int
        self._lib.EngineWaitForVar.restype = _ct.c_int
        self._lib.EngineGetError.restype = _ct.c_int
        self._h = _ct.c_void_p(self._lib.EngineCreate(int(num_workers)))
        self._cbs = {}           # keep callbacks alive until they run
        self._cb_lock = _threading.Lock()
        self._cb_id = 0

    def new_var(self) -> int:
        """Parity: Engine::NewVariable."""
        return int(self._lib.EngineNewVar(self._h))

    def push(self, fn, const_vars=(), mutable_vars=()):
        """Parity: Engine::PushAsync — run ``fn()`` when all read deps
        (const_vars) and the exclusive write deps (mutable_vars) are
        available.  Exceptions surface at the next wait point."""
        with self._cb_lock:
            self._cb_id += 1
            cid = self._cb_id

        def trampoline(_arg, _fn=fn, _cid=cid):
            try:
                _fn()
            except BaseException as e:  # noqa: BLE001 — cross-ABI boundary
                self._lib.EngineSetError(
                    self._h, f"{type(e).__name__}: {e}".encode())
            finally:
                with self._cb_lock:
                    self._cbs.pop(_cid, None)

        cb = _CB_TYPE(trampoline)
        with self._cb_lock:
            self._cbs[cid] = cb
        n_use = len(const_vars)
        n_mut = len(mutable_vars)
        use = (_ct.c_int64 * max(n_use, 1))(*const_vars)
        mut = (_ct.c_int64 * max(n_mut, 1))(*mutable_vars)
        rc = self._lib.EnginePushAsync(self._h, cb, None, use, n_use,
                                       mut, n_mut)
        if rc != 0:
            from .base import MXNetError
            raise MXNetError("EnginePushAsync failed (unknown variable?)")

    def _check_error(self):
        buf = _ct.create_string_buffer(4096)
        n = self._lib.EngineGetError(self._h, buf, 4096)
        if n > 0:
            from .base import MXNetError
            raise MXNetError(
                f"engine op failed: {buf.value.decode(errors='replace')}")

    def wait_for_var(self, var: int):
        """Parity: Engine::WaitForVar + exception rethrow."""
        self._lib.EngineWaitForVar(self._h, _ct.c_int64(var))
        self._check_error()

    def wait_all(self):
        """Parity: Engine::WaitForAll + exception rethrow."""
        self._lib.EngineWaitForAll(self._h)
        self._check_error()

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.EngineDestroy(self._h)
                self._h = None
        except Exception:
            pass


_native_engine = None
_native_lock = _threading.Lock()


def native_engine() -> "NativeEngine":
    """The process-wide NativeEngine singleton (parity: Engine::Get();
    worker count from MXNET_CPU_WORKER_NTHREADS)."""
    global _native_engine
    with _native_lock:
        if _native_engine is None:
            from .base import getenv_int
            _native_engine = NativeEngine(
                getenv_int("MXNET_CPU_WORKER_NTHREADS", 0))
        return _native_engine
