"""Custom-kernel layer: registry + autotuner + persistent cache
(counterpart of ``mxnet_tpu/kernels``), plus the nvcc build of the
CUDA C++ sources in ``csrc/``."""
from . import cache  # noqa: F401
from .cache import cache_dir, cache_path  # noqa: F401
from .registry import (KernelSpec, register_kernel, get_kernel,  # noqa: F401
                       list_kernels, resolve, commit, invalidate,
                       warm_cache, cache_key, stats, tune_enabled)
from .autotune import tune, tune_registered, candidates, time_ms  # noqa: F401

__all__ = ["KernelSpec", "register_kernel", "get_kernel", "list_kernels",
           "resolve", "commit", "invalidate", "warm_cache", "cache_key",
           "stats", "tune_enabled", "tune", "tune_registered",
           "candidates", "time_ms", "cache", "cache_dir", "cache_path"]
