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

from .base import MXNetError
from .context import resolve_device

__all__ = ["decode_params_from_numpy", "load_collected_params",
           "collected_params_to_numpy"]


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


def load_collected_params(net, arrays: Dict[str, Any], device=None) -> None:
    """Load the reference net's ``collect_params()`` (hierarchical name →
    array) into the port's ``net`` by name, on ``device`` (default
    ``cuda``).  The two name sets must be equal, and each array's shape
    must match the parameter's declared shape (a dim still unknown to a
    deferred parameter is filled in)."""
    dev = resolve_device(device)
    params = net.collect_params()
    missing = sorted(set(params) - set(arrays))
    extra = sorted(set(arrays) - set(params))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing}, "
                         f"extra {extra}")
    for name, p in params.items():
        a = onp.asarray(arrays[name])
        want = p.shape or ()
        if len(want) != a.ndim or any(w > 0 and w != s
                                      for w, s in zip(want, a.shape)):
            raise MXNetError(f"{name}: shape {a.shape} does not match "
                             f"{tuple(want)}")
        p.set_data(_tensor(a, dev))


def collected_params_to_numpy(net) -> Dict[str, onp.ndarray]:
    """The port's parameters by hierarchical name, as numpy arrays (copies:
    the trainers update the tensors in place)."""
    return {name: p.data().detach().float().cpu().numpy().copy()
            for name, p in net.collect_params().items()}
