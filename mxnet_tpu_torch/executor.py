"""``mx.executor``: the public ``Executor`` (counterpart of
``mxnet_tpu/executor.py``); it lives with the Symbol API
(``symbol/executor.py``)."""
from .symbol.executor import Executor

__all__ = ["Executor"]
