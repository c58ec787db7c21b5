"""``mx.nd.random`` — the sampling functions (counterpart of
``mxnet_tpu/ndarray/random.py``).  Each draws through the registered
sampler ops (``ops/random.py``) on the device of ``ctx`` (default: the
current context), from that device's generator or, inside a trainer's
step, from what its trace supplies."""
from __future__ import annotations

from ..ops import random as _r
from ..ops.registry import get as _get, dispatch as _dispatch
from .ndarray import _device

__all__ = ["uniform", "normal", "randn", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial", "randint",
           "multinomial", "bernoulli", "shuffle", "laplace", "rayleigh",
           "gumbel", "logistic", "seed"]

seed = _r.seed


def _sample(op_name, shape, dtype, ctx, out, **params):
    params = dict(params, shape=_r._shape(shape), ctx=str(_device(ctx)))
    if dtype is not None:
        params["dtype"] = dtype
    r = _dispatch(_get(op_name), [], params)
    return out._adopt(r) if out is not None else r


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kw):
    return _sample("_random_uniform", shape, dtype, ctx, out, low=low,
                   high=high)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kw):
    return _sample("_random_normal", shape, dtype, ctx, out, loc=loc,
                   scale=scale)


def randn(*shape, loc=0.0, scale=1.0, dtype=None, ctx=None):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None, out=None,
          **kw):
    return _sample("_random_gamma", shape, dtype, ctx, out, alpha=alpha,
                   beta=beta)


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None, **kw):
    return _sample("_random_exponential", shape, dtype, ctx, out,
                   lam=1.0 / scale)


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None, **kw):
    return _sample("_random_poisson", shape, dtype, ctx, out, lam=lam)


def negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None,
                      out=None, **kw):
    return _sample("_random_negative_binomial", shape, dtype, ctx, out, k=k,
                   p=p)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None, dtype=None,
                                  ctx=None, out=None, **kw):
    return _sample("_random_generalized_negative_binomial", shape, dtype,
                   ctx, out, mu=mu, alpha=alpha)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None, **kw):
    return _sample("_random_randint", shape, dtype, ctx, out, low=low,
                   high=high)


def bernoulli(prob=0.5, shape=None, dtype=None, ctx=None, out=None, **kw):
    return _sample("_random_bernoulli", shape, dtype, ctx, out, prob=prob)


def laplace(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
            **kw):
    return _sample("_random_laplace", shape, dtype, ctx, out, loc=loc,
                   scale=scale)


def rayleigh(scale=1.0, shape=None, dtype=None, ctx=None, out=None, **kw):
    return _sample("_random_rayleigh", shape, dtype, ctx, out, scale=scale)


def gumbel(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
           **kw):
    return _sample("_random_gumbel", shape, dtype, ctx, out, loc=loc,
                   scale=scale)


def logistic(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None,
             **kw):
    return _sample("_random_logistic", shape, dtype, ctx, out, loc=loc,
                   scale=scale)


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kw):
    return _dispatch(_get("_sample_multinomial"), [data],
                     {"shape": shape if isinstance(shape, int)
                      else tuple(shape), "get_prob": get_prob,
                      "dtype": dtype})


def shuffle(data, **kw):
    return _dispatch(_get("_shuffle"), [data], {})
