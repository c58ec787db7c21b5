"""Optimizer update ops (counterpart of the part of
``mxnet_tpu/ops/optimizer_ops.py`` the training paths call): SGD, SGD
with momentum and Adam.  Each is a pure function returning the new
``(weight, *state)`` (``sgd_update``: the weight alone); the caller
writes them back.  ``<op>_multi`` applies the same arithmetic to lists of
tensors with PyTorch's multi-tensor (``_foreach``) ops: one launch per
step of the formula for all parameters, instead of one per parameter,
which is what keeps a trainer's update from being bound by the host.

All run under the reference's low-precision guard
(``mxnet_tpu/optimizer/optimizer.py:45-70``): a parameter whose weight,
gradient or state is a float narrower than f32 is updated in f32 and its
weight and states are cast back to their own dtypes; an all-f32 one
(the transformer's f32 masters) computes exactly as before."""
from __future__ import annotations

import functools

import torch

__all__ = ["sgd_update", "sgd_update_multi", "sgd_mom_update",
           "sgd_mom_update_multi", "adam_update", "adam_update_multi"]


def _lowp(arrays) -> bool:
    return any(a.is_floating_point() and a.element_size() < 4
               for a in arrays)


def _f32(a):
    return a.float() if a.is_floating_point() else a


def _back(out, like):
    return out.to(like.dtype) if like.is_floating_point() else out


def _lowp_guard(fn):
    """``fn(weight, grad, *states)`` in f32 when any input is bf16/fp16;
    the outputs ``(weight, *states)`` (or the weight alone, for an op
    without state) cast back to the inputs' dtypes."""
    @functools.wraps(fn)
    def guarded(weight, grad, *states, **kw):
        arrays = (weight, grad, *states)
        if not _lowp(arrays):
            return fn(*arrays, **kw)
        out = fn(*map(_f32, arrays), **kw)
        if isinstance(out, torch.Tensor):
            return _back(out, weight)
        return tuple(_back(o, a) for o, a in zip(out, (weight, *states)))
    return guarded


def _lowp_guard_multi(fn):
    """The same guard for ``fn(weights, grads, *state_lists)``, taken
    parameter by parameter."""
    @functools.wraps(fn)
    def guarded(weights, grads, *states, **kw):
        lists = (weights, grads, *states)
        low = [_lowp(group) for group in zip(*lists)]
        if not any(low):
            return fn(*lists, **kw)
        out = fn(*([_f32(a) if lo else a for a, lo in zip(col, low)]
                   for col in lists), **kw)
        return tuple([_back(o, a) for o, a in zip(outs, ins)]
                     for outs, ins in zip(out, (weights, *states)))
    return guarded


def _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g + wd * weight


@_lowp_guard
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """One SGD step, ``w - lr·g`` with ``g = rescale·grad`` (clipped)
    ``+ wd·w``; returns the new weight (``mxnet_tpu/ops/
    optimizer_ops.py:25``)."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    return weight - lr * g


@_lowp_guard
def sgd_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """One SGD-momentum step as the reference op writes it (``mxnet_tpu/
    ops/optimizer_ops.py:32``): ``mom = μ·mom - lr·g``, then ``w + mom``.
    Not ``torch.optim.SGD``'s ``buf = μ·buf + g``, which parts from it
    once lr moves.  Returns ``(weight, mom)``."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom - lr * g
    return weight + new_mom, new_mom


def _grad_multi(weights, grads, wds, rescale_grad, clip_gradient):
    """``rescale·grad`` (clipped) ``+ wd·w`` over lists."""
    g = torch._foreach_mul(grads, rescale_grad)
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch._foreach_clamp_max(
            torch._foreach_clamp_min(g, -clip_gradient), clip_gradient)
    return torch._foreach_add(g, torch._foreach_mul(weights, wds))


@_lowp_guard_multi
def sgd_update_multi(weights, grads, *, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0, lazy_update=True):
    """:func:`sgd_update` over lists of tensors (``lrs``, ``wds`` as in
    :func:`adam_update_multi`); returns ``(weights,)``."""
    g = _grad_multi(weights, grads, wds, rescale_grad, clip_gradient)
    return (torch._foreach_sub(weights, torch._foreach_mul(g, lrs)),)


@_lowp_guard_multi
def sgd_mom_update_multi(weights, grads, moms, *, lrs, wds, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0,
                         lazy_update=True):
    """:func:`sgd_mom_update` over lists of tensors, element by element
    the same operations in the same order; returns the lists
    ``(weights, moms)``."""
    g = _grad_multi(weights, grads, wds, rescale_grad, clip_gradient)
    new_mom = torch._foreach_sub(torch._foreach_mul(moms, momentum),
                                 torch._foreach_mul(g, lrs))
    return torch._foreach_add(weights, new_mom), new_mom


@_lowp_guard
def adam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """One Adam step exactly as the reference op writes it: no bias
    correction here (callers that want it fold it into ``lr``)."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    return weight - lr * m / (torch.sqrt(v) + epsilon), m, v


@_lowp_guard_multi
def adam_update_multi(weights, grads, means, variances, *, lrs, wds,
                      beta1=0.9, beta2=0.999, epsilon=1e-8,
                      rescale_grad=1.0, clip_gradient=-1.0):
    """:func:`adam_update` over lists of tensors, element by element the
    same operations in the same order; returns the lists ``(weights,
    means, variances)``.  ``lrs`` and ``wds`` are each a list (one float
    or 0-d tensor per tensor) or one float or 0-d tensor for all; a 0-d
    tensor on the device (the trainer's, which a CUDA graph reads at
    each replay) keeps each of its products one multi-tensor launch."""
    g = _grad_multi(weights, grads, wds, rescale_grad, clip_gradient)
    m = torch._foreach_add(torch._foreach_mul(means, beta1),
                           torch._foreach_mul(g, 1 - beta1))
    v = torch._foreach_add(torch._foreach_mul(variances, beta2),
                           torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - beta2))
    step = torch._foreach_div(torch._foreach_mul(m, lrs),
                              torch._foreach_add(torch._foreach_sqrt(v),
                                                 epsilon))
    return torch._foreach_sub(weights, step), m, v
