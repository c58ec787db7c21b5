"""``mx.sym``: declarative graph construction (counterpart of
``mxnet_tpu/symbol/``).  Symbols compose the same registered ops as
``mx.nd``; ``bind`` gives an executor whose inference forward replays
one captured executable per bound signature."""
from .symbol import Symbol, Variable, var, Group, load, load_json, trace
from .executor import Executor
from .register import populate_namespace, make_sym_func

populate_namespace(globals())

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "trace", "Executor"]
