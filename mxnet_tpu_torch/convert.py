"""Carry weights from the reference package into the port.

The reference's parameters arrive as numpy arrays (or anything with
``__array__``: this module never imports JAX) and leave as torch tensors
on the port's device, so both packages compute the same thing on the
same weights.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as onp
import torch

from .context import resolve_device

__all__ = ["decode_params_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    a = onp.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: no torch.from_numpy
        return torch.from_numpy(a.astype(onp.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(onp.array(a)).to(device)


def decode_params_from_numpy(tree: Dict[str, Any], device=None) -> dict:
    """The reference ``DecodeModel.params`` pytree (``embed``,
    ``layers[i].{ln1, wq, wk, wv, wo, ln2, w1, w2}``, ``lnf``) → the
    port's ``DecodeModel.params`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return {"embed": _tensor(tree["embed"], dev),
            "layers": [{k: _tensor(v, dev) for k, v in lp.items()}
                       for lp in tree["layers"]],
            "lnf": _tensor(tree["lnf"], dev)}
