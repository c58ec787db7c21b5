"""``mx.np.random`` (counterpart of ``mxnet_tpu/numpy/random.py``).

The reference draws from JAX's key chain; the port draws from its own
generator of the device (``ops.random``: ``mx.random.seed`` /
``np.random.seed`` repeat the draws, a captured step replays them with
fresh numbers), never from torch's global one.  The streams differ from
the reference's, so the two agree by distribution, not bit for bit.

A distribution with a registered ``_npi_*`` sampler (``ops/random.py``)
is that op, called through the op funnel; the rest are drawn here.
Where the reference's sampler departs from numpy's (``pareto`` draws
the Pareto of the first kind, support ``[1, inf)``, one more than
``_npi_pareto``), the port follows the reference.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from ..ndarray.ndarray import NDArray as _NDArray
from ..ops.random import draw as _draw
from ..ops.random import seed  # noqa: F401
from ..ops.registry import invoke as _invoke
from . import _canon, _canon_dtype, _dev, _wrap, array, ndarray

__all__ = ["seed", "uniform", "normal", "randn", "rand", "randint", "choice",
           "shuffle", "permutation", "gamma", "beta", "dirichlet",
           "exponential", "poisson", "multinomial", "multivariate_normal",
           "logistic", "gumbel", "laplace", "rayleigh", "pareto", "power",
           "weibull", "chisquare", "f", "lognormal", "binomial", "geometric",
           "t", "standard_t", "negative_binomial"]


def _npi(name, params, size=None, dtype=None, ctx=None, **kw):
    """The registered sampler ``name`` on ``params``, (name, value) pairs
    in the op's order: arrays are its inputs (with every parameter before
    them, made arrays on their device), the rest keywords."""
    last = max((i for i, (_, v) in enumerate(params)
                if isinstance(v, _NDArray)), default=-1)
    on = params[last][1].context if last >= 0 else None
    inputs = [v if isinstance(v, _NDArray) else array(v, ctx=on)
              for _, v in params[:last + 1]]
    kw.update(params[last + 1:])
    if dtype is not None:
        kw["dtype"] = _canon_dtype(torch_dtype(dtype))
    if ctx is not None:
        kw["ctx"] = ctx
    return _wrap(_invoke(name, inputs, size=size, **kw))


def _shape(size):
    if size is None:
        return ()
    if isinstance(size, int):
        return (size,)
    return tuple(int(s) for s in size)


def _p(x, dev):
    """A distribution parameter: an array's tensor, or a Python number."""
    if isinstance(x, _NDArray):
        return x._data.to(dev)
    return x


def _full_shape(size, *params):
    if size is not None:
        return _shape(size)
    shapes = [tuple(p.shape) for p in params if isinstance(p, torch.Tensor)]
    return tuple(torch.broadcast_shapes(*shapes)) if shapes else ()


def _out(t, dtype=None, default=torch.float32):
    dt = default if dtype is None else torch_dtype(dtype)
    return ndarray._wrap(_canon(t.to(dt)))


def _u(g, shape, dev, lo=0.0):
    u = torch.rand(shape, generator=g, device=dev)
    return u * (1.0 - lo) + lo if lo else u


def _std_gamma(g, alpha, shape, dev):
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    return torch._standard_gamma(a.expand(shape).contiguous(), generator=g)


def _sample(body, ctx, device, size, *params, dtype=None,
            default=torch.float32):
    dev = _dev(ctx, device)
    ps = [_p(x, dev) for x in params]
    shape = _full_shape(size, *ps)
    return _out(_draw(lambda g: body(g, shape, dev, *ps), dev), dtype,
                default)


def uniform(low=0.0, high=1.0, size=None, dtype=None, ctx=None, device=None,
            out=None):
    return _npi("_npi_uniform", [("low", low), ("high", high)], size, dtype,
                ctx or device)


def normal(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, device=None,
           out=None):
    return _npi("_npi_normal", [("loc", loc), ("scale", scale)], size, dtype,
                ctx or device)


def randn(*size):
    return normal(0.0, 1.0, size or None)


def rand(*size):
    return uniform(0.0, 1.0, size or None)


def randint(low, high=None, size=None, dtype=None, ctx=None, device=None,
            out=None):
    if high is None:
        low, high = 0, low
    return _sample(lambda g, s, d: torch.randint(
        int(low), int(high), s, generator=g, device=d), ctx, device, size,
        dtype=dtype, default=torch.int32)


def choice(a, size=None, replace=True, p=None, ctx=None, out=None):
    params = [("a", a if isinstance(a, (int, _NDArray))
               else array(a, ctx=ctx))]
    if p is not None:
        params.append(("weights", p if isinstance(p, _NDArray)
                       else array(p, ctx=ctx)))
    return _npi("_npi_choice", params, size, ctx=ctx, replace=replace)


def shuffle(x):
    """Shuffle ``x``'s rows in place."""
    dev = x._data.device
    perm = _draw(lambda g: torch.randperm(x.shape[0], generator=g,
                                          device=dev), dev)
    x._rebind(x._data[perm])


def permutation(x, ctx=None):
    if isinstance(x, int):
        dev = _dev(ctx)
        return ndarray._wrap(_canon(_draw(lambda g: torch.randperm(
            x, generator=g, device=dev), dev)))
    dev = x._data.device
    perm = _draw(lambda g: torch.randperm(x.shape[0], generator=g,
                                          device=dev), dev)
    return ndarray._wrap(x._data.detach()[perm])


def gamma(shape, scale=1.0, size=None, dtype=None, ctx=None, out=None):
    return _npi("_npi_gamma", [("shape", shape), ("scale", scale)], size,
                dtype, ctx)


def beta(a, b, size=None, dtype=None, ctx=None):
    def body(g, s, d, a_, b_):
        x = _std_gamma(g, a_, s, d)
        y = _std_gamma(g, b_, s, d)
        return x / (x + y)
    return _sample(body, ctx, None, size, a, b, dtype=dtype)


def dirichlet(alpha, size=None, dtype=None, ctx=None):
    if not isinstance(alpha, _NDArray):
        alpha = array(alpha, dtype="float32", ctx=ctx)
    return _npi("_npi_dirichlet", [("alpha", alpha)], size, dtype)


def exponential(scale=1.0, size=None, dtype=None, ctx=None, out=None):
    return _npi("_npi_exponential", [("scale", scale)], size, dtype, ctx)


def poisson(lam=1.0, size=None, dtype=None, ctx=None, out=None):
    return _sample(lambda g, s, d, lm: torch.poisson(
        torch.as_tensor(lm, dtype=torch.float32, device=d).expand(s)
        .contiguous(), generator=g), ctx, None, size, lam, dtype=dtype,
        default=torch.int64)


def multinomial(n, pvals, size=None):
    if not isinstance(pvals, _NDArray):
        pvals = array(pvals, dtype="float32")
    return _npi("_npi_multinomial", [("pvals", pvals)], size, n=n)


def multivariate_normal(mean, cov, size=None, check_valid=None, tol=None):
    dev = _dev()
    m = mean._data.to(dev) if isinstance(mean, _NDArray) else \
        torch.as_tensor(mean, dtype=torch.float32, device=dev)
    c = cov._data.to(dev) if isinstance(cov, _NDArray) else \
        torch.as_tensor(cov, dtype=torch.float32, device=dev)
    L = torch.linalg.cholesky(c.float())
    shape = _shape(size) + (m.shape[-1],)
    z = _draw(lambda g: torch.randn(shape, generator=g, device=dev), dev)
    return _out(m.float() + z @ L.mT)


def logistic(loc=0.0, scale=1.0, size=None, ctx=None, out=None):
    return _npi("_npi_logistic", [("loc", loc), ("scale", scale)], size,
                ctx=ctx)


def gumbel(loc=0.0, scale=1.0, size=None, ctx=None, out=None):
    return _npi("_npi_gumbel", [("loc", loc), ("scale", scale)], size,
                ctx=ctx)


def laplace(loc=0.0, scale=1.0, size=None, dtype=None, ctx=None, out=None):
    return _npi("_npi_laplace", [("loc", loc), ("scale", scale)], size,
                dtype, ctx)


def rayleigh(scale=1.0, size=None, ctx=None, out=None):
    return _npi("_npi_rayleigh", [("scale", scale)], size, ctx=ctx)


def pareto(a, size=None, ctx=None, out=None):
    """Pareto of the first kind (support ``[1, inf)``), as the
    reference's sampler: one more than ``_npi_pareto``'s Lomax draw."""
    return _npi("_npi_pareto", [("a", a)], size, ctx=ctx) + 1.0


def power(a, size=None, ctx=None, out=None):
    return _npi("_npi_powerd", [("a", a)], size, ctx=ctx)


def weibull(a, size=None, ctx=None, out=None):
    return _npi("_npi_weibull", [("a", a)], size, ctx=ctx)


def chisquare(df, size=None, dtype=None, ctx=None):
    return _sample(lambda g, s, d, k: 2.0 * _std_gamma(g, k / 2.0, s, d),
                   ctx, None, size, df, dtype=dtype)


def f(dfnum, dfden, size=None, ctx=None):
    def body(g, s, d, a, b):
        num = 2.0 * _std_gamma(g, a / 2.0, s, d)
        den = 2.0 * _std_gamma(g, b / 2.0, s, d)
        return (num / a) / (den / b)
    return _sample(body, ctx, None, size, dfnum, dfden)


def lognormal(mean=0.0, sigma=1.0, size=None, dtype=None, ctx=None,
              out=None):
    return _sample(lambda g, s, d, m, sd: torch.exp(m + sd * torch.randn(
        s, generator=g, device=d)), ctx, None, size, mean, sigma,
        dtype=dtype)


def binomial(n, p, size=None, dtype=None, ctx=None, out=None):
    def body(g, s, d, n_, p_):
        cnt = torch.as_tensor(n_, dtype=torch.float32, device=d).expand(s)
        prob = torch.as_tensor(p_, dtype=torch.float32, device=d).expand(s)
        return torch.binomial(cnt.contiguous(), prob.contiguous(),
                              generator=g)
    return _sample(body, ctx, None, size, n, p, dtype=dtype,
                   default=torch.int64)


def geometric(p, size=None, ctx=None):
    return _sample(lambda g, s, d, p_: torch.ceil(
        torch.log(_u(g, s, d, 1e-7)) / math.log1p(-p_) if not isinstance(
            p_, torch.Tensor) else torch.log(_u(g, s, d, 1e-7))
        / torch.log1p(-p_)), ctx, None, size, p, default=torch.int64)


def t(df, size=None, ctx=None):
    """Student's t: a normal over the root of a chi-square by ``df``."""
    def body(g, s, d, k):
        z = torch.randn(s, generator=g, device=d)
        chi2 = 2.0 * _std_gamma(g, k / 2.0, s, d)
        return z / torch.sqrt(chi2 / k)
    return _sample(body, ctx, None, size, df)


standard_t = t


def negative_binomial(n, p, size=None, dtype=None, ctx=None, out=None):
    """Failures before the ``n``-th success: a Poisson of a Gamma."""
    def body(g, s, d, n_, p_):
        lam = _std_gamma(g, n_, s, d) * (1.0 - p_) / p_
        return torch.poisson(lam, generator=g)
    return _sample(body, ctx, None, size, n, p, dtype=dtype,
                   default=torch.int64)
