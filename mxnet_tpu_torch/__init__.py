"""PyTorch/CUDA port of the JAX package, slice by slice.

The JAX package beside this one is the reference; this package mirrors
its module paths (``mxnet_tpu_torch/serving/decode/engine.py`` is the port
of ``mxnet_tpu/serving/decode/engine.py``) and never imports it or JAX.
Every Pallas kernel on a ported path becomes a kernel written by hand
for Hopper in CUDA C++ (``csrc/``, built by nvcc at first use into a
library with a C interface), with a plain PyTorch version beside it
that serves CPU tensors and is the oracle the kernel is held against.
Importing the package builds nothing.

Ported so far: decode serving (``serving.decode``) with its two kernels,
``ops.paged_attention`` and ``ops.rope``; transformer-LM training
(``gluon``, ``initializer``, ``optimizer``, ``parallel.SPMDTrainer``)
with the three flash-attention kernels of ``ops.attention``; and the
imperative NDArray path — ``nd`` (``NDArray`` over a ``torch.Tensor``,
generated from the op registry ``ops.registry``), ``autograd``
(``record``/``backward``/``grad``/``Function``), ``Context`` — with the
fused ``ops.layernorm_residual`` kernel (``mx.nd.layer_norm_residual``)
and ``rtc``, which compiles and launches users' CUDA C kernels; the
ResNet ops and zoo; and the eager Gluon loop — ``gluon.Trainer`` over
``autograd.record``/``backward`` with the optimizer family
(``optimizer``, its fused whole-set step), ``lr_scheduler``, the kvstores
(``kvstore``: local, ``dist_*`` over ``torch.distributed``, P3, the
parameter server) with row-sparse gradients (``nd.sparse``,
``Embedding(sparse_grad=True)``, the lazy updates) and the sharded
embedding tables (``embedding``), and ``amp`` (the policy and the loss
scaler); and the input
pipeline — ``recordio``, ``io`` (with the native ``ImageRecordIter``,
built from ``csrc/io`` by g++ at first use), ``image``, ``gluon.data`` and
``data.DevicePrefetcher``, which copies batches to the card on a side
stream ahead of the step; and observability — the full step record and
its sinks (``telemetry``), the span recorder with its export and stall
watchdog (``tracing``), ``profiler`` over ``torch.profiler`` with the
card's kernels by name (``kineto``), ``monitor``, and ``clustermon``
(spools, straggler incidents, Prometheus; imported at first use); and
the numpy front end — ``np`` (``mx.np``: ``ndarray`` and numpy's
functions in torch ops, with ``np.linalg``, ``np.fft`` and
``np.random``), ``npx`` (the extension ops, the kernels by their
``_npx_`` names) and ``util`` (``set_np`` and the 64-bit switches)::

    import mxnet_tpu_torch as mx
    x = mx.nd.array(data, ctx=mx.gpu(0))
"""
from .base import MXNetError  # noqa: F401
from .context import (Context, cpu, gpu, current_context,  # noqa: F401
                      num_gpus)
from . import autograd, ops, rtc  # noqa: F401
from . import ndarray  # noqa: F401
from . import ndarray as nd  # noqa: F401
from .ndarray import NDArray  # noqa: F401
from . import log, telemetry, tracing, profiler  # noqa: F401
from . import amp, kvstore, lr_scheduler  # noqa: F401
from . import kvstore as kv  # noqa: F401
from . import gluon, initializer, optimizer, parallel, serving  # noqa: F401
from . import data, image, io, recordio  # noqa: F401
from . import monitor  # noqa: F401
from . import embedding  # noqa: F401
from . import random  # noqa: F401
from . import name, attribute  # noqa: F401
from .attribute import AttrScope  # noqa: F401
from . import symbol  # noqa: F401
from . import symbol as sym  # noqa: F401
from . import executor, model, callback, visualization  # noqa: F401
from . import util  # noqa: F401
from . import numpy  # noqa: F401
from . import numpy as np  # noqa: F401
from . import numpy_extension  # noqa: F401
from . import numpy_extension as npx  # noqa: F401
from .util import is_np_array, set_np, reset_np  # noqa: F401

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "num_gpus", "autograd", "ops", "rtc", "ndarray", "nd", "NDArray",
           "gluon", "initializer", "optimizer", "parallel", "serving",
           "tracing", "telemetry", "log", "amp", "kvstore", "kv",
           "lr_scheduler", "data", "image", "io", "recordio", "profiler",
           "monitor", "embedding", "random", "name", "attribute", "AttrScope",
           "symbol", "sym", "executor", "model", "callback",
           "visualization", "util", "numpy", "np", "numpy_extension", "npx",
           "is_np_array", "set_np", "reset_np"]
