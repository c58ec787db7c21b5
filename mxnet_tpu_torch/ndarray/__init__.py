"""``mx.nd`` — the imperative NDArray namespace (counterpart of
``mxnet_tpu/ndarray/__init__.py``).  Its op functions are generated from
the port's op registry when it is imported, so only ported ops appear
(``layer_norm_residual`` among them, with its K6 kernel), beside
``save`` / ``load`` / ``load_frombuffer`` and the reference's binary
format (``legacy_serialization``)."""
from .. import ops as _ops  # noqa: F401  (registers every op first)
from .ndarray import (NDArray, array, zeros, ones, full, empty, arange,
                      waitall, save, load, load_frombuffer)
from .register import populate_namespace, make_op_func

populate_namespace(globals())
