"""``mx.nd`` — the imperative NDArray namespace (counterpart of
``mxnet_tpu/ndarray/__init__.py``).  Its op functions are generated from
the port's op registry when it is imported, so only ported ops appear
(``layer_norm_residual`` among them, with its K6 kernel), beside
``save`` / ``load`` / ``load_frombuffer`` and the reference's binary
format (``legacy_serialization``), ``sparse`` (row-sparse and CSR
storage, ``cast_storage``), ``random`` (the samplers over
``mx.random``), ``linalg`` (the ``_linalg_*`` ops) and ``Dropout``."""
from .. import ops as _ops  # noqa: F401  (registers every op first)
from .ndarray import (NDArray, array, zeros, ones, full, empty, arange,
                      concat, stack, waitall, save, load, load_frombuffer)
from .register import populate_namespace, make_op_func
from . import sparse  # noqa: F401
from . import random  # noqa: F401
from . import linalg  # noqa: F401
from .random import shuffle  # noqa: F401
from .sparse import cast_storage  # noqa: F401

populate_namespace(globals())


def Dropout(data, *args, p=0.5, mode="training", axes=(), **kwargs):
    """``mx.nd.Dropout`` with the reference's signature and mode rules
    (``mxnet_tpu/ndarray/__init__.py:26-51``): positional arguments
    after ``data`` are ``p``, ``mode``, ``axes``; ``"training"`` drops
    only under ``autograd.record(train_mode=True)``, ``"always"``
    always.  The mask is drawn from ``mx.random`` on the data's device;
    the reference's explicit key argument has no counterpart here (seed
    ``mx.random`` instead)."""
    from ..base import MXNetError
    from ..ops.registry import invoke
    pos = list(args)
    if pos and isinstance(pos[0], NDArray) or "key" in kwargs:
        raise MXNetError("Dropout: an explicit PRNG key is not taken by "
                         "the port; draws come from mx.random")
    for name, val in zip(("p", "mode", "axes"), pos):
        if name == "p":
            p = val
        elif name == "mode":
            mode = val
        else:
            axes = val
    return invoke("Dropout", [data], p=p, mode=mode, axes=tuple(axes))


dropout = Dropout
