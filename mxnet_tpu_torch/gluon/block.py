"""Gluon Block / HybridBlock (counterpart of ``mxnet_tpu/gluon/block.py``).

A ``Block`` is a ``torch.nn.Module``: child Blocks assigned as
attributes register as its submodules, and ``Parameter`` attributes
register in the Block's own ordered table, so ``collect_params()``
returns the reference's hierarchical names
(``blocks.0.attn.qkv.weight``).  ``named_parameters()`` (and so
``parameters()``) yields the initialized tensors under those names.
``hybridize`` keeps the block eager: graph capture (CUDA graphs) is
later work.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from .. import initializer as init_mod
from ..context import resolve_device
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class Block(torch.nn.Module):
    """Base class for layers and models."""

    def __init__(self):
        super().__init__()
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self._reg_params[name] = value
            if value._name in ("weight", "bias", "param", "const"):
                value._name = name
        super().__setattr__(name, value)

    @property
    def _children(self):
        return OrderedDict((k, m) for k, m in self._modules.items()
                           if isinstance(m, Block))

    def register_child(self, block: "Block", name: Optional[str] = None):
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self) -> ParameterDict:
        """Hierarchical name → Parameter: the Block's own parameters, then
        each child's under ``<child name>.``."""
        out = ParameterDict()
        self._collect_params_into(out, "")
        return out

    def _collect_params_into(self, out: ParameterDict, prefix: str):
        for name, p in self._reg_params.items():
            out[prefix + name] = p
        for cname, child in self._children.items():
            child._collect_params_into(out, f"{prefix}{cname}.")

    def named_parameters(self, prefix="", recurse=True,
                         remove_duplicate=True):
        seen = set()
        for name, p in self.collect_params().items():
            t = p._data
            if t is None or (remove_duplicate and id(t) in seen):
                continue
            seen.add(id(t))
            yield (f"{prefix}.{name}" if prefix else name), t

    def initialize(self, init=None, device=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter: each one's own initializer, else
        ``init`` (default ``Uniform()``).  ``device`` defaults to
        ``cuda`` and takes ``"cpu"`` only when asked; values are drawn
        from ``generator`` (default: a host generator seeded with 0) in
        ``collect_params()`` order, deferred ones at their first
        forward."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        default = init_mod.create(init)
        for p in self.collect_params().values():
            p.initialize(init=None, device=dev, default_init=default,
                         force_reinit=force_reinit, generator=generator)

    def hybridize(self, active=True, **kwargs):
        """Accepted for the reference's API; the block stays eager."""

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block the reference can trace into one executable; here it runs
    eagerly."""
