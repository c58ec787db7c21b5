"""``mx.nd.linalg`` — the linear-algebra namespace (counterpart of
``mxnet_tpu/ndarray/linalg.py``, the reference's ``la_op.cc``): each
function is the registered ``_linalg_*`` op of ``ops/linalg.py``
(cuBLAS / cuSOLVER through ``torch.linalg`` on the card), generated from
the registry as ``mx.nd``'s and called through the op funnel."""
from __future__ import annotations

from .register import make_op_func

__all__ = ["gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "syrk",
           "gelqf", "syevd", "sumlogdiag", "extractdiag", "makediag",
           "extracttrian", "maketrian", "inverse", "det", "slogdet"]

for _name in __all__:
    globals()[_name] = make_op_func("_linalg_" + _name)
    globals()[_name].__name__ = _name
del _name
