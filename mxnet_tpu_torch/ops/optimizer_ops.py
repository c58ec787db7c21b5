"""Optimizer update ops (counterpart of ``mxnet_tpu/ops/optimizer_ops.py``):
the whole family — SGD, SGD with momentum, NAG, Adam, AdamW, FTML, FTRL,
RMSProp (plain and centred), signSGD, Signum, AdaGrad, AdaDelta, Adamax,
Nadam, LAMB (whole and in two phases), LARS, SGLD, DCASGD, LANS and
group AdaGrad — the ``mp_*`` forms that carry an f32 master beside a
low-precision weight, and the reference's interleaved ``multi_*`` /
``preloaded_multi_*`` forms.  Each is a pure function returning the new
``(weight, *state)`` (the weight alone for an op without state); the
caller writes them back.  All are registered under the reference's names,
so ``mx.nd`` reaches them.

``<op>_multi`` applies an op's arithmetic to lists of tensors, element
by element the same operations in the same order as the single form,
with PyTorch's multi-tensor (``_foreach``) ops: one launch per step of
the formula for all parameters, instead of one per parameter, which is
what keeps a trainer's update from being bound by the host.  FTRL, LARS
and group AdaGrad branch per element or take a norm or mean per
parameter, which the ``_foreach`` ops do not express; their multi forms
run the single form once per parameter.

All run under the reference's low-precision guard
(``mxnet_tpu/optimizer/optimizer.py:45-70``): a parameter whose weight,
gradient or state is a float narrower than f32 is updated in f32 and its
weight and states are cast back to their own dtypes; an all-f32 one
(the transformer's f32 masters) computes exactly as before.  The
``mp_*`` forms do their own casts, as in the reference."""
from __future__ import annotations

import functools
import math

import torch

from .registry import alias, register

__all__ = ["sgd_update", "sgd_update_multi", "sgd_mom_update",
           "sgd_mom_update_multi", "adam_update", "adam_update_multi",
           "nag_mom_update", "nag_mom_update_multi", "adamw_update",
           "adamw_update_multi", "ftml_update", "ftrl_update",
           "ftrl_update_multi", "rmsprop_update", "rmsprop_update_multi",
           "rmspropalex_update", "rmspropalex_update_multi",
           "signsgd_update", "signsgd_update_multi", "signum_update",
           "signum_update_multi", "adagrad_update", "adagrad_update_multi",
           "adadelta_update", "adadelta_update_multi", "adamax_update",
           "nadam_update", "lamb_update", "lars_update",
           "lars_update_multi", "sgld_update", "dcasgd_update",
           "dcasgd_update_multi", "lans_update", "group_adagrad_update",
           "group_adagrad_update_multi", "mp_sgd_update",
           "mp_sgd_mom_update", "mp_nag_mom_update", "mp_adamw_update",
           "lamb_update_phase1", "lamb_update_phase2",
           "mp_lamb_update_phase1", "mp_lamb_update_phase2",
           "multi_sgd_update", "multi_sgd_mom_update",
           "multi_mp_sgd_update", "multi_mp_sgd_mom_update",
           "preloaded_multi_sgd_update", "preloaded_multi_sgd_mom_update",
           "preloaded_multi_mp_sgd_update",
           "preloaded_multi_mp_sgd_mom_update"]


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


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd):
    g = _clip(grad * rescale_grad, clip_gradient)
    return g + wd * weight


def _norm(a):
    """The 2-norm of every element, as ``jnp.linalg.norm`` of an array."""
    return torch.linalg.vector_norm(a)


def _per_tensor(single):
    """The multi form of an op whose formula ``_foreach`` cannot express:
    ``single`` once per parameter, with each parameter's ``lr``/``wd``
    taken from ``lrs``/``wds`` and any other list-valued attribute
    (``rescale_grad``) taken per parameter too."""
    def multi(weights, grads, *states, lrs=None, wds, **kw):
        def pick(v, i):
            return v[i] if isinstance(v, (list, tuple)) else v
        outs = []
        for i, arrays in enumerate(zip(weights, grads, *states)):
            extra = {k: pick(v, i) for k, v in kw.items()}
            if lrs is not None:
                extra["lr"] = pick(lrs, i)
            out = single(*arrays, wd=pick(wds, i), **extra)
            outs.append(out if isinstance(out, tuple) else (out,))
        return tuple(list(col) for col in zip(*outs))
    multi.__name__ = single.__name__ + "_multi"
    multi.__doc__ = f":func:`{single.__name__}` once per parameter."
    return multi


@register("sgd_update")
@_lowp_guard
def sgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """One SGD step, ``w - lr·g`` with ``g = rescale·grad`` (clipped)
    ``+ wd·w``; returns the new weight (``mxnet_tpu/ops/
    optimizer_ops.py:25``)."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    return weight - lr * g


@register("sgd_mom_update")
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


def _clip_multi(grads, rescale_grad, clip_gradient):
    """``rescale·grad``, clipped, over lists (``rescale_grad`` one value
    or one per tensor)."""
    g = torch._foreach_mul(grads, rescale_grad)
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch._foreach_clamp_max(
            torch._foreach_clamp_min(g, -clip_gradient), clip_gradient)
    return g


def _grad_multi(weights, grads, wds, rescale_grad, clip_gradient):
    """``rescale·grad`` (clipped) ``+ wd·w`` over lists."""
    g = _clip_multi(grads, rescale_grad, clip_gradient)
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


@register("adam_update")
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


# --------------------------------------------------------------------------
# the rest of the family (``mxnet_tpu/ops/optimizer_ops.py:40-287``)
# --------------------------------------------------------------------------

@register("nag_mom_update")
@_lowp_guard
def nag_mom_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum: ``mom = μ·mom + g``, ``w - lr·(g + μ·mom)``."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    new_mom = momentum * mom + g
    return weight - lr * (g + momentum * new_mom), new_mom


@_lowp_guard_multi
def nag_mom_update_multi(weights, grads, moms, *, lrs, wds, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_multi(weights, grads, wds, rescale_grad, clip_gradient)
    new_mom = torch._foreach_add(torch._foreach_mul(moms, momentum), g)
    step = torch._foreach_mul(
        torch._foreach_add(g, torch._foreach_mul(new_mom, momentum)), lrs)
    return torch._foreach_sub(weights, step), new_mom


@register("adamw_update", aliases=("_adamw_update",))
@_lowp_guard
def adamw_update(weight, grad, mean, var, *, lr, eta=1.0, beta1=0.9,
                 beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """Adam with decoupled weight decay: ``w - eta·(lr·m/(√v + ε) +
    wd·w)``; no bias correction."""
    g = _clip(grad * rescale_grad, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    return (weight - eta * (lr * m / (torch.sqrt(v) + epsilon)
                            + wd * weight), m, v)


@_lowp_guard_multi
def adamw_update_multi(weights, grads, means, variances, *, lrs, wds,
                       eta=1.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip_multi(grads, rescale_grad, clip_gradient)
    m = torch._foreach_add(torch._foreach_mul(means, beta1),
                           torch._foreach_mul(g, 1 - beta1))
    v = torch._foreach_add(torch._foreach_mul(variances, beta2),
                           torch._foreach_mul(torch._foreach_mul(g, g),
                                              1 - beta2))
    step = torch._foreach_div(torch._foreach_mul(m, lrs),
                              torch._foreach_add(torch._foreach_sqrt(v),
                                                 epsilon))
    step = torch._foreach_add(step, torch._foreach_mul(weights, wds))
    return torch._foreach_sub(weights, torch._foreach_mul(step, eta)), m, v


@register("ftml_update")
@_lowp_guard
def ftml_update(weight, grad, d, v, z, *, lr, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    """FTML (follow the moving leader); the clip is named ``clip_grad``,
    as in the reference."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_grad, wd)
    v_new = beta2 * v + (1 - beta2) * torch.square(g)
    d_new = (1 - beta1 ** t) / lr * (torch.sqrt(v_new / (1 - beta2 ** t))
                                     + epsilon)
    sigma = d_new - beta1 * d
    z_new = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z_new / d_new, d_new, v_new, z_new


@register("ftrl_update")
@_lowp_guard
def ftrl_update(weight, grad, z, n, *, lr, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    n_new = n + torch.square(g)
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / lr
    z_new = z + g - sigma * weight
    w = torch.where(
        torch.abs(z_new) <= lamda1, 0.0,
        -(z_new - torch.sign(z_new) * lamda1)
        / ((beta + torch.sqrt(n_new)) / lr + wd))
    return w, z_new, n_new


ftrl_update_multi = _lowp_guard_multi(_per_tensor(ftrl_update))


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w


@register("rmsprop_update")
@_lowp_guard
def rmsprop_update(weight, grad, n, *, lr, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    n_new = gamma1 * n + (1 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(n_new + epsilon)
    return _clip_weights(w, clip_weights), n_new


def _clip_weights_multi(ws, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        ws = torch._foreach_clamp_max(
            torch._foreach_clamp_min(ws, -clip_weights), clip_weights)
    return ws


@_lowp_guard_multi
def rmsprop_update_multi(weights, grads, ns, *, lrs, wds, gamma1=0.95,
                         epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0,
                         clip_weights=-1.0):
    g = _grad_multi(weights, grads, wds, rescale_grad, clip_gradient)
    n_new = torch._foreach_add(
        torch._foreach_mul(ns, gamma1),
        torch._foreach_mul(torch._foreach_mul(g, g), 1 - gamma1))
    step = torch._foreach_div(
        torch._foreach_mul(g, lrs),
        torch._foreach_sqrt(torch._foreach_add(n_new, epsilon)))
    w = torch._foreach_sub(weights, step)
    return _clip_weights_multi(w, clip_weights), n_new


@register("rmspropalex_update")
@_lowp_guard
def rmspropalex_update(weight, grad, n, g_state, delta, *, lr, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centred RMSProp (Graves): ``delta = γ2·delta - lr·g/√(n - ḡ² +
    ε)``."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    n_new = gamma1 * n + (1 - gamma1) * torch.square(g)
    g_new = gamma1 * g_state + (1 - gamma1) * g
    delta_new = gamma2 * delta - lr * g / torch.sqrt(
        n_new - torch.square(g_new) + epsilon)
    w = weight + delta_new
    return _clip_weights(w, clip_weights), n_new, g_new, delta_new


@_lowp_guard_multi
def rmspropalex_update_multi(weights, grads, ns, g_states, deltas, *, lrs,
                             wds, gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             clip_weights=-1.0):
    g = _grad_multi(weights, grads, wds, rescale_grad, clip_gradient)
    n_new = torch._foreach_add(
        torch._foreach_mul(ns, gamma1),
        torch._foreach_mul(torch._foreach_mul(g, g), 1 - gamma1))
    g_new = torch._foreach_add(torch._foreach_mul(g_states, gamma1),
                               torch._foreach_mul(g, 1 - gamma1))
    den = torch._foreach_sqrt(torch._foreach_add(
        torch._foreach_sub(n_new, torch._foreach_mul(g_new, g_new)), epsilon))
    delta_new = torch._foreach_sub(
        torch._foreach_mul(deltas, gamma2),
        torch._foreach_div(torch._foreach_mul(g, lrs), den))
    w = torch._foreach_add(weights, delta_new)
    return _clip_weights_multi(w, clip_weights), n_new, g_new, delta_new


@register("signsgd_update")
@_lowp_guard
def signsgd_update(weight, grad, *, lr, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@_lowp_guard_multi
def signsgd_update_multi(weights, grads, *, lrs, wds, rescale_grad=1.0,
                         clip_gradient=-1.0):
    g = _clip_multi(grads, rescale_grad, clip_gradient)
    step = torch._foreach_add(torch._foreach_sign(g),
                              torch._foreach_mul(weights, wds))
    return (torch._foreach_sub(weights, torch._foreach_mul(step, lrs)),)


@register("signum_update")
@_lowp_guard
def signum_update(weight, grad, mom, *, lr, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    m = momentum * mom - (1 - momentum) * (g + wd * weight)
    w = (1 - lr * wd_lh) * weight + lr * torch.sign(m)
    return w, m


@_lowp_guard_multi
def signum_update_multi(weights, grads, moms, *, lrs, wds, momentum=0.0,
                        rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _clip_multi(grads, rescale_grad, clip_gradient)
    m = torch._foreach_sub(
        torch._foreach_mul(moms, momentum),
        torch._foreach_mul(torch._foreach_add(
            g, torch._foreach_mul(weights, wds)), 1 - momentum))
    lr_list = lrs if isinstance(lrs, (list, tuple)) else [lrs] * len(m)
    decay = [1 - lr * wd_lh for lr in lr_list]
    w = torch._foreach_add(torch._foreach_mul(weights, decay),
                           torch._foreach_mul(torch._foreach_sign(m), lrs))
    return w, m


@register("adagrad_update")
@_lowp_guard
def adagrad_update(weight, grad, history, *, lr, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    h = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(h) + epsilon), h


@_lowp_guard_multi
def adagrad_update_multi(weights, grads, histories, *, lrs, wds,
                         epsilon=1e-7, rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_multi(weights, grads, wds, rescale_grad, clip_gradient)
    h = torch._foreach_add(histories, torch._foreach_mul(g, g))
    step = torch._foreach_div(torch._foreach_mul(g, lrs),
                              torch._foreach_add(torch._foreach_sqrt(h),
                                                 epsilon))
    return torch._foreach_sub(weights, step), h


@register("adadelta_update")
@_lowp_guard
def adadelta_update(weight, grad, acc_g, acc_delta, *, rho=0.9,
                    epsilon=1e-5, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    """AdaDelta: no learning rate."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    acc_g_new = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_delta + epsilon) / torch.sqrt(
        acc_g_new + epsilon) * g
    acc_delta_new = rho * acc_delta + (1 - rho) * torch.square(delta)
    return weight - delta, acc_g_new, acc_delta_new


@_lowp_guard_multi
def adadelta_update_multi(weights, grads, acc_gs, acc_deltas, *, wds,
                          rho=0.9, epsilon=1e-5, rescale_grad=1.0,
                          clip_gradient=-1.0):
    g = _grad_multi(weights, grads, wds, rescale_grad, clip_gradient)
    acc_g_new = torch._foreach_add(
        torch._foreach_mul(acc_gs, rho),
        torch._foreach_mul(torch._foreach_mul(g, g), 1 - rho))
    delta = torch._foreach_mul(torch._foreach_div(
        torch._foreach_sqrt(torch._foreach_add(acc_deltas, epsilon)),
        torch._foreach_sqrt(torch._foreach_add(acc_g_new, epsilon))), g)
    acc_delta_new = torch._foreach_add(
        torch._foreach_mul(acc_deltas, rho),
        torch._foreach_mul(torch._foreach_mul(delta, delta), 1 - rho))
    return torch._foreach_sub(weights, delta), acc_g_new, acc_delta_new


@register("adamax_update")
@_lowp_guard
def adamax_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                  t=1, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    m = beta1 * mean + (1 - beta1) * g
    u = torch.maximum(beta2 * var, torch.abs(g))
    return weight - (lr / (1 - beta1 ** t)) * m / (u + 1e-8), m, u


@register("nadam_update")
@_lowp_guard
def nadam_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, t=1, schedule_decay=0.004, m_schedule=1.0,
                 wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """Nadam; ``m_schedule`` is the product of the momentum schedule over
    the earlier steps, which the optimizer keeps."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    mt = beta1 * (1.0 - 0.5 * 0.96 ** (t * schedule_decay))
    mt1 = beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * schedule_decay))
    ms = m_schedule * mt
    ms1 = ms * mt1
    g_prime = g / (1 - ms)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    m_prime = m / (1 - ms1)
    v_prime = v / (1 - beta2 ** t)
    m_bar = (1 - mt) * g_prime + mt1 * m_prime
    return weight - lr * m_bar / (torch.sqrt(v_prime) + epsilon), m, v


def _trust_ratio(w_norm, r_norm):
    """``w_norm / r_norm`` where both are positive, else 1."""
    one = torch.ones((), dtype=w_norm.dtype, device=w_norm.device)
    return torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm, one)


@register("lamb_update")
@_lowp_guard
def lamb_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0,
                lower_bound=-1.0, upper_bound=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    if bias_correction:
        mh = m / (1 - beta1 ** t)
        vh = v / (1 - beta2 ** t)
    else:
        mh, vh = m, v
    r = mh / (torch.sqrt(vh) + epsilon) + wd * weight
    w_norm = _norm(weight)
    r_norm = _norm(r)
    if lower_bound is not None and lower_bound > 0:
        w_norm = torch.clamp(w_norm, min=lower_bound)
    if upper_bound is not None and upper_bound > 0:
        w_norm = torch.clamp(w_norm, max=upper_bound)
    return weight - lr * _trust_ratio(w_norm, r_norm) * r, m, v


@register("lars_update")
@_lowp_guard
def lars_update(weight, grad, mom, *, lr, eta=0.001, momentum=0.9,
                epsilon=1e-9, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    w_norm = _norm(weight)
    g_norm = _norm(g)
    one = torch.ones((), dtype=w_norm.dtype, device=w_norm.device)
    local_lr = torch.where(
        (w_norm > 0) & (g_norm > 0),
        eta * w_norm / (g_norm + wd * w_norm + epsilon), one)
    new_mom = momentum * mom + local_lr * lr * (g + wd * weight)
    return weight - new_mom, new_mom


lars_update_multi = _lowp_guard_multi(_per_tensor(lars_update))


@register("sgld_update")
@_lowp_guard
def sgld_update(weight, grad, noise, *, lr, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0):
    """Langevin dynamics: ``w - lr/2·g + √lr·noise`` (``noise`` standard
    normal, drawn by the caller)."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    return weight - 0.5 * lr * g + math.sqrt(lr) * noise


@register("dcasgd_update")
@_lowp_guard
def dcasgd_update(weight, grad, prev_weight, *, lr, lamda=0.04, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0):
    """Delay-compensated SGD; the new state is the weight before the
    update."""
    g = _apply_wd_rescale(grad, weight, rescale_grad, clip_gradient, wd)
    comp = g + lamda * g * g * (weight - prev_weight)
    return weight - lr * comp, weight


@_lowp_guard_multi
def dcasgd_update_multi(weights, grads, prev_weights, *, lrs, wds,
                        lamda=0.04, rescale_grad=1.0, clip_gradient=-1.0):
    g = _grad_multi(weights, grads, wds, rescale_grad, clip_gradient)
    comp = torch._foreach_add(g, torch._foreach_mul(
        torch._foreach_mul(torch._foreach_mul(g, lamda), g),
        torch._foreach_sub(weights, prev_weights)))
    return (torch._foreach_sub(weights, torch._foreach_mul(comp, lrs)),
            list(weights))


@register("lans_update")
@_lowp_guard
def lans_update(weight, grad, mean, var, *, lr, beta1=0.9, beta2=0.999,
                epsilon=1e-6, t=1, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lower_bound=-1.0, upper_bound=-1.0):
    """LANS: LAMB with Nesterov momentum on a per-layer normalised
    gradient."""
    g = grad * rescale_grad
    g = g / torch.clamp(_norm(g), min=1e-12)
    g = _clip(g, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    mh = m / (1 - beta1 ** t)
    vh = torch.sqrt(v / (1 - beta2 ** t)) + epsilon
    tm = mh / vh + wd * weight
    tg = g / vh + wd * weight
    r1 = _norm(weight)
    if lower_bound is not None and lower_bound >= 0:
        r1 = torch.clamp(r1, min=lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1 = torch.clamp(r1, max=upper_bound)
    rm = _trust_ratio(r1, _norm(tm)) * beta1
    rg = _trust_ratio(r1, _norm(tg)) * (1 - beta1)
    w = weight - lr * rm * tm - lr * rg * tg
    return w, m, v


@register("group_adagrad_update",
          aliases=("_contrib_group_adagrad_update",))
@_lowp_guard
def group_adagrad_update(weight, grad, history, *, lr, epsilon=1e-5,
                         rescale_grad=1.0, clip_gradient=-1.0, wd=0.0):
    """Group AdaGrad: one accumulated scalar per row, the mean of the
    row's squared gradient."""
    g = _clip(grad * rescale_grad, clip_gradient)
    dims = tuple(range(1, g.dim()))
    h = history + (torch.mean(torch.square(g), dim=dims, keepdim=True)
                   if dims else torch.square(g))
    return weight - lr * g / (torch.sqrt(h) + epsilon), h


group_adagrad_update_multi = _lowp_guard_multi(
    _per_tensor(group_adagrad_update))


# --------------------------------------------------------------------------
# mixed precision: an f32 master beside a low-precision weight; outputs
# ``(weight, *state, weight32)`` (``mxnet_tpu/ops/optimizer_ops.py:296``)
# --------------------------------------------------------------------------

def _f32_grad(grad, rescale_grad, clip_gradient):
    return _clip(grad.float() * rescale_grad, clip_gradient)


@register("mp_sgd_update")
def mp_sgd_update(weight, grad, weight32, *, lr, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    g = _f32_grad(grad, rescale_grad, clip_gradient)
    w32 = weight32 - lr * (g + wd * weight32)
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update")
def mp_sgd_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _f32_grad(grad, rescale_grad, clip_gradient)
    m = momentum * mom - lr * (g + wd * weight32)
    w32 = weight32 + m
    return w32.to(weight.dtype), m, w32


@register("mp_nag_mom_update")
def mp_nag_mom_update(weight, grad, mom, weight32, *, lr, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    g = _f32_grad(grad, rescale_grad, clip_gradient) + wd * weight32
    m = momentum * mom + g
    w32 = weight32 - lr * (g + momentum * m)
    return w32.to(weight.dtype), m, w32


@register("_mp_adamw_update")
def mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad_t, *,
                    lr, eta=1.0, beta1=0.9, beta2=0.999, epsilon=1e-8,
                    wd=0.0, clip_gradient=-1.0):
    """AdamW on the f32 master; ``rescale_grad_t`` is a tensor."""
    g = _clip(grad.float() * rescale_grad_t, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    w32 = weight32 - eta * (lr * m / (torch.sqrt(v) + epsilon)
                            + wd * weight32)
    return w32.to(weight.dtype), m, v, w32


@register("lamb_update_phase1")
def lamb_update_phase1(weight, grad, mean, grad_var, *, beta1=0.9,
                       beta2=0.999, epsilon=1e-6, t=1, bias_correction=True,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """LAMB's direction ``m̂/(√v̂ + ε) + wd·w`` (the caller takes the
    norms and applies :func:`lamb_update_phase2`)."""
    g = _clip(grad * rescale_grad, clip_gradient)
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * grad_var + (1 - beta2) * torch.square(g)
    if bias_correction:
        mh = m / (1 - beta1 ** t)
        vh = v / (1 - beta2 ** t)
    else:
        mh, vh = m, v
    return mh / (torch.sqrt(vh) + epsilon) + wd * weight


@register("lamb_update_phase2")
def lamb_update_phase2(weight, g_update, r1, r2, *, lr, lower_bound=-1.0,
                       upper_bound=-1.0):
    """``w - lr·(r1/r2)·g_update`` with r1 clamped to the bounds (a ratio
    of 1 where either norm is 0)."""
    r1_, r2_ = r1.reshape(()), r2.reshape(())
    if lower_bound is not None and lower_bound >= 0:
        r1_ = torch.clamp(r1_, min=lower_bound)
    if upper_bound is not None and upper_bound >= 0:
        r1_ = torch.clamp(r1_, max=upper_bound)
    return weight - lr * _trust_ratio(r1_, r2_) * g_update


@register("mp_lamb_update_phase1")
def mp_lamb_update_phase1(weight, grad, mean, grad_var, weight32, *,
                          beta1=0.9, beta2=0.999, epsilon=1e-6, t=1,
                          bias_correction=True, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0):
    return lamb_update_phase1(
        weight32, grad.float(), mean, grad_var, beta1=beta1, beta2=beta2,
        epsilon=epsilon, t=t, bias_correction=bias_correction, wd=wd,
        rescale_grad=rescale_grad, clip_gradient=clip_gradient)


@register("mp_lamb_update_phase2")
def mp_lamb_update_phase2(weight, g_update, r1, r2, weight32, *, lr,
                          lower_bound=-1.0, upper_bound=-1.0):
    w32 = lamb_update_phase2(weight32, g_update, r1, r2, lr=lr,
                             lower_bound=lower_bound,
                             upper_bound=upper_bound)
    return w32.to(weight.dtype), w32


# --------------------------------------------------------------------------
# the reference's interleaved multi-weight ops (``optimizer_op.cc``
# multi_sgd_* and the contrib preloaded_multi_* ones): one call updates N
# weights; ``preloaded`` ones take lrs and wds as two trailing tensors
# --------------------------------------------------------------------------

def _chunks(arrays, n_per):
    n = len(arrays) // n_per
    return [arrays[i * n_per:(i + 1) * n_per] for i in range(n)]


def _interleaved(single, n_per, preloaded):
    def op(*arrays, lrs=None, wds=None, rescale_grad=1.0,
           clip_gradient=-1.0, num_weights=None, **statics):
        if preloaded:
            arrays, lrs, wds = arrays[:-2], arrays[-2], arrays[-1]
        outs = []
        for i, group in enumerate(_chunks(list(arrays), n_per)):
            out = single(*group, lr=lrs[i], wd=wds[i],
                         rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient, **statics)
            outs.extend(out if isinstance(out, tuple) else (out,))
        return tuple(outs)
    return op


for _single, _n in ((sgd_update, 2), (sgd_mom_update, 3),
                    (mp_sgd_update, 3), (mp_sgd_mom_update, 4)):
    _base = _single.__name__
    for _pre in (False, True):
        _name = ("preloaded_multi_" if _pre else "multi_") + _base
        _fn = _interleaved(_single, _n, _pre)
        _fn.__name__ = _name
        _fn.__doc__ = (f":func:`{_base}` over interleaved "
                       f"({'weight, grad, ...'}) groups"
                       + ("; lrs and wds are the two trailing tensors"
                          if _pre else "") + ".")
        globals()[_name] = register(_name)(_fn)
