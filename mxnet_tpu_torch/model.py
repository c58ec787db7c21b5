"""Legacy model checkpoints (counterpart of ``mxnet_tpu/model.py``):
``prefix-symbol.json`` and ``prefix-%04d.params`` with ``arg:`` /
``aux:`` name prefixes, through the port's ``nd.save`` / ``nd.load`` (so
a pair the reference wrote loads here, and the other way round).
"""
from __future__ import annotations

import logging

from . import ndarray as nd

__all__ = ["save_checkpoint", "load_params", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` + ``prefix-%04d.params`` (as
    model.py:189)."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in (arg_params or {}).items()}
    save_dict.update({f"aux:{k}": v for k, v in (aux_params or {}).items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_params(prefix, epoch):
    """Split a params file back into (arg_params, aux_params) (as
    model.py:221)."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in (save_dict or {}).items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """Load (symbol, arg_params, aux_params) (as model.py:238)."""
    from . import symbol as sym
    symbol = sym.load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params
