"""The decode engine's executables: one per exec key, the CUDA
counterpart of the reference's ``jax.jit(fn).lower(*args).compile()``
in ``DecodeEngine._get_exec``.  :class:`Executable` lives in
``mxnet_tpu_torch/executable.py``, which the trainer shares; the engine
builds each one with ``warm="zeros"`` (its cores mask every slot)."""
from ...executable import Executable

__all__ = ["Executable"]
