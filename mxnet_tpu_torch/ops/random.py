"""Random sampling ops and the global generator state (counterpart of
``mxnet_tpu/ops/random.py``).

The reference keeps one JAX key chain and splits a key off it for every
draw; inside a traced step the key is an input of the trace.  The port
keeps, in PyTorch's idiom, one explicit ``torch.Generator`` per device
(the host's and each card's), made at first use and seeded with the
global seed:

* :func:`seed` reseeds them all (``ctx="all"``) or one device's;
* :func:`draw` is the one funnel a sampler takes: ``make(generator)``
  on the device's generator, or, while a trace hook is installed on this
  thread (:func:`set_trace_hook`: a trainer's step, whose forward may be
  recomputed by remat), whatever the hook supplies;
* :func:`get_state_bits` / :func:`set_state_bits` save and restore every
  generator as a list of uint32 words (a checkpoint's ``rng_state``,
  beside the two-word ``rng_key`` the reference reads, :func:`key_words`).

A CUDA graph replays the draws it captured with fresh numbers: the
executable that captures registers the device's generator with the
graph (``executable.py``), and torch then reads the generator's seed and
offset at each replay and advances the offset by what the graph drew, as
an eager run of the same work would.  So a replay is bitwise the eager
run from the same generator state, and two replays draw different
numbers.

Streams differ from the reference's (JAX's threefry against torch's
philox on a card and Mersenne Twister on the host): the samplers match
the reference's distributions, not its bits.
"""
from __future__ import annotations

import threading
from collections import Counter
from typing import Callable, Dict, Optional

import numpy as onp
import torch

from ..base import MXNetError, torch_dtype
from .registry import register

__all__ = ["seed", "generator", "draw", "next_key", "set_trace_hook",
           "current_key", "get_state_bits", "set_state_bits", "key_words",
           "draws"]

_LOCK = threading.Lock()
_SEED = [0]
_gens: Dict[torch.device, torch.Generator] = {}
_draws: Counter = Counter()
_tls = threading.local()

# the first word of :func:`get_state_bits`'s format ("mxrn")
_MAGIC = 0x6D78726E


def _device(device) -> torch.device:
    """A torch device from a device, a Context, a string or None (the
    current context's device); a card without an index is the current
    one."""
    if device is None:
        from ..context import current_context
        device = current_context().torch_device
    elif hasattr(device, "torch_device"):
        device = device.torch_device
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device=None) -> torch.Generator:
    """The generator of ``device`` (made and seeded with the global seed
    at first use)."""
    dev = _device(device)
    with _LOCK:
        g = _gens.get(dev)
        if g is None:
            g = torch.Generator(device=dev)
            g.manual_seed(_SEED[0])
            _gens[dev] = g
        _draws[dev] += 1
    return g


def draws(device) -> int:
    """How many times ``device``'s generator was handed out: an
    executable whose warm run moved it registers the generator with its
    graph."""
    return _draws[_device(device)]


def seed(seed_state: int, ctx="all") -> None:
    """``mx.random.seed``: every generator (``ctx="all"``, and those made
    later) or ``ctx``'s alone starts again from ``seed_state``."""
    s = int(seed_state)
    with _LOCK:
        if ctx == "all":
            _SEED[0] = s
            gens = list(_gens.values())
        else:
            gens = None
    if gens is None:
        gens = [generator(ctx)]
    for g in gens:
        g.manual_seed(s)


def set_trace_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install ``hook(make, device)`` as the source of this thread's
    draws; returns the hook it replaces."""
    old = getattr(_tls, "hook", None)
    _tls.hook = hook
    return old


def draw(make: Callable[[torch.Generator], torch.Tensor], device):
    """``make(generator)`` on ``device``'s generator, or what this
    thread's trace hook supplies in its place."""
    hook = getattr(_tls, "hook", None)
    if hook is not None:
        return hook(make, device)
    return make(generator(device))


def next_key(device=None) -> torch.Generator:
    """The generator the next draw on ``device`` takes outside a trace
    (the reference hands out a split key here)."""
    return generator(device)


def current_key():
    """The whole generator state, as :func:`get_state_bits` gives it."""
    return get_state_bits()


def get_state_bits() -> onp.ndarray:
    """Every generator's state as host uint32 words: the checkpointable
    state.  The global seed, then each device's generator (its type,
    index and the bytes of ``get_state()``)."""
    with _LOCK:
        items = sorted(_gens.items(), key=lambda kv: str(kv[0]))
        s = _SEED[0] & (2 ** 64 - 1)
    words = [_MAGIC, 1, s & 0xFFFFFFFF, s >> 32, len(items)]
    for dev, g in items:
        state = g.get_state().numpy().tobytes()
        state += b"\0" * (-len(state) % 4)
        words += [0 if dev.type == "cpu" else 1, dev.index or 0, len(state)]
        words += onp.frombuffer(state, dtype=onp.uint32).tolist()
    return onp.asarray(words, dtype=onp.uint32)


def key_words(bits=None) -> list:
    """Two uint32 words that stand for the state ``bits`` (default: the
    current state), in the reference's raw-key format: what a
    checkpoint's ``rng_key`` holds, so that the reference, which reads
    that entry as its JAX key, can resume from the port's checkpoint on
    a deterministic stream of its own.  The exact state goes beside it
    (``rng_state``)."""
    import hashlib
    w = get_state_bits() if bits is None else onp.asarray(bits, onp.uint32)
    digest = hashlib.blake2b(w.tobytes(), digest_size=8).digest()
    return onp.frombuffer(digest, dtype=onp.uint32).tolist()


def set_state_bits(bits) -> None:
    """Restore the state :func:`get_state_bits` gave, so a resumed run
    draws exactly what the saved run would have drawn next.  Words that
    are not in that format (the reference's two-word JAX key) seed every
    generator with the number they make instead: a deterministic stream,
    not the reference's."""
    w = onp.asarray(bits, dtype=onp.uint32).reshape(-1)
    if w.size < 5 or int(w[0]) != _MAGIC:
        seed(int.from_bytes(w.tobytes(), "little") % (2 ** 63))
        return
    if int(w[1]) != 1:
        raise MXNetError(f"random state format {int(w[1])} is not known")
    _SEED[0] = int(w[2]) | (int(w[3]) << 32)
    i, n = 5, int(w[4])
    for _ in range(n):
        kind, index, nbytes = (int(x) for x in w[i:i + 3])
        i += 3
        raw = w[i:i + -(-nbytes // 4)].tobytes()[:nbytes]
        i += -(-nbytes // 4)
        if kind == 1 and not (torch.cuda.is_available()
                              and index < torch.cuda.device_count()):
            continue        # a card this process does not have
        dev = torch.device("cpu") if kind == 0 else torch.device("cuda",
                                                                 index)
        state = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
        generator(dev).set_state(state)


# -- samplers (``mxnet_tpu/ops/random.py:94-190``): ``fn(*, params, shape,
# dtype, ctx)`` drawing through :func:`draw` ---------------------------------

def _shape(shape):
    if shape is None:
        return (1,)
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def _dt(dtype, default=torch.float32):
    return default if dtype is None else torch_dtype(dtype)


def _uniform01(g, shape, dev, lo=0.0):
    """Uniform f32 in ``[lo, 1)``."""
    u = torch.rand(shape, generator=g, device=dev, dtype=torch.float32)
    return u * (1.0 - lo) + lo if lo else u


def _sampler(name, body):
    """Register ``body(g, shape, device, **params)`` as ``name``: one
    draw on the device named by ``ctx``, cast to ``dtype``."""
    def fn(*, shape=(1,), dtype=None, ctx=None, **params):
        dev = _device(ctx)
        shp = _shape(shape)
        out = draw(lambda g: body(g, shp, dev, **params), dev)
        return out.to(_dt(dtype))
    fn.__name__ = name
    fn.__doc__ = body.__doc__
    return register(name)(fn)


def _u(g, shape, dev, *, low=0.0, high=1.0):
    """Uniform on ``[low, high)``."""
    return _uniform01(g, shape, dev) * (high - low) + low


def _n(g, shape, dev, *, loc=0.0, scale=1.0):
    """Normal with mean ``loc`` and deviation ``scale``."""
    return loc + scale * torch.randn(shape, generator=g, device=dev)


def _standard_gamma(g, alpha, shape, dev):
    a = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    return torch._standard_gamma(a.expand(shape).contiguous(), generator=g)


def _gamma(g, shape, dev, *, alpha=1.0, beta=1.0):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    return _standard_gamma(g, alpha, shape, dev) * beta


def _exponential(g, shape, dev, *, lam=1.0):
    """Exponential with rate ``lam``."""
    return torch.empty(shape, device=dev).exponential_(1.0, generator=g) \
        / lam


def _poisson_of(g, rates):
    return torch.poisson(rates, generator=g)


def _poisson(g, shape, dev, *, lam=1.0):
    """Poisson with rate ``lam``."""
    return _poisson_of(g, torch.full(shape, float(lam), device=dev))


def _neg_binomial(g, shape, dev, *, k=1, p=0.5):
    """Failures before the ``k``-th success at success rate ``p``: a
    Poisson of a Gamma(k, (1-p)/p), as the reference draws it."""
    return _poisson_of(g, _standard_gamma(g, k, shape, dev)
                       * ((1.0 - p) / p))


def _gen_neg_binomial(g, shape, dev, *, mu=1.0, alpha=1.0):
    """Negative binomial by mean ``mu`` and dispersion ``alpha`` (a
    Poisson of rate ``mu`` when ``alpha`` is 0)."""
    if alpha == 0.0:
        return _poisson(g, shape, dev, lam=mu)
    return _poisson_of(g, _standard_gamma(g, 1.0 / alpha, shape, dev)
                       * (mu * alpha))


def _randint(g, shape, dev, *, low=0, high=1):
    """Integers uniform on ``[low, high)``."""
    return torch.randint(int(low), int(high), shape, generator=g,
                         device=dev)


def _bernoulli(g, shape, dev, *, prob=0.5):
    """1 with probability ``prob``, else 0."""
    return (_uniform01(g, shape, dev) < prob).float()


def _laplace(g, shape, dev, *, loc=0.0, scale=1.0):
    """Laplace at ``loc`` with scale ``scale`` (inverse CDF)."""
    u = _uniform01(g, shape, dev) - 0.5
    return loc - scale * torch.sign(u) * torch.log1p(-2.0 * u.abs())


def _rayleigh(g, shape, dev, *, scale=1.0):
    """Rayleigh with scale ``scale``."""
    u = _uniform01(g, shape, dev, lo=1e-7)
    return scale * torch.sqrt(-2.0 * torch.log(u))


def _gumbel(g, shape, dev, *, loc=0.0, scale=1.0):
    """Gumbel at ``loc`` with scale ``scale``."""
    u = _uniform01(g, shape, dev, lo=1e-7)
    return loc - scale * torch.log(-torch.log(u))


def _logistic(g, shape, dev, *, loc=0.0, scale=1.0):
    """Logistic at ``loc`` with scale ``scale``."""
    u = _uniform01(g, shape, dev, lo=1e-7)
    return loc + scale * (torch.log(u) - torch.log1p(-u))


for _name, _body in (("_random_uniform", _u), ("_random_normal", _n),
                     ("_random_gamma", _gamma),
                     ("_random_exponential", _exponential),
                     ("_random_poisson", _poisson),
                     ("_random_negative_binomial", _neg_binomial),
                     ("_random_generalized_negative_binomial",
                      _gen_neg_binomial),
                     ("_random_bernoulli", _bernoulli),
                     ("_random_laplace", _laplace),
                     ("_random_rayleigh", _rayleigh),
                     ("_random_gumbel", _gumbel),
                     ("_random_logistic", _logistic)):
    _sampler(_name, _body)


@register("_random_randint")
def _random_randint(*, low=0, high=1, shape=(1,), dtype="int32", ctx=None):
    """Integers uniform on ``[low, high)``."""
    dev = _device(ctx)
    shp = _shape(shape)
    return draw(lambda g: _randint(g, shp, dev, low=low, high=high),
                dev).to(_dt(dtype, torch.int32))


@register("_sample_multinomial")
def _multinomial(data, *, shape=(), get_prob=False, dtype="int32"):
    """``shape`` category draws per row of the probabilities ``data``
    (``(..., K)``)."""
    n = 1
    for s in (shape if isinstance(shape, (tuple, list)) else (shape,)):
        n *= s if s else 1
    extra = (() if not shape else (shape,) if isinstance(shape, int)
             else tuple(shape))
    rows = data.reshape(-1, data.shape[-1]).float().clamp_min(0)
    out = draw(lambda g: torch.multinomial(rows, n, replacement=True,
                                           generator=g), data.device)
    out = out.reshape(data.shape[:-1] + extra)
    return out.to(_dt(dtype, torch.int32))


@register("_shuffle")
def _shuffle(data):
    """``data``'s rows in a random order."""
    perm = draw(lambda g: torch.randperm(data.shape[0], generator=g,
                                         device=data.device), data.device)
    return data[perm]


# -- per-row samplers (``mxnet_tpu/ops/random.py:395-466``): each row of
# the parameter arrays is one distribution, ``shape`` trailing dims -------

def _multisample(body, params, shape, dtype):
    extra = (() if not shape else (shape,) if isinstance(shape, int)
             else tuple(shape))
    first = params[0]
    dev = first.device
    full = tuple(first.shape) + extra
    ps = [p.float().reshape(tuple(p.shape) + (1,) * len(extra)).expand(full)
          for p in params]
    out = draw(lambda g: body(g, full, dev, *ps), dev)
    return out.to(_dt(dtype))


@register("_sample_uniform")
def _sample_uniform(low, high, *, shape=(), dtype="float32"):
    return _multisample(lambda g, s, d, lo, hi: _uniform01(g, s, d)
                        * (hi - lo) + lo, (low, high), shape, dtype)


@register("_sample_normal")
def _sample_normal(mu, sigma, *, shape=(), dtype="float32"):
    return _multisample(lambda g, s, d, m, sd: m + sd * torch.randn(
        s, generator=g, device=d), (mu, sigma), shape, dtype)


@register("_sample_gamma")
def _sample_gamma(alpha, beta, *, shape=(), dtype="float32"):
    return _multisample(lambda g, s, d, a, b: torch._standard_gamma(
        a.contiguous(), generator=g) * b, (alpha, beta), shape, dtype)


@register("_sample_exponential")
def _sample_exponential(lam, *, shape=(), dtype="float32"):
    return _multisample(lambda g, s, d, l_: torch.empty(s, device=d)
                        .exponential_(1.0, generator=g) / l_, (lam,), shape,
                        dtype)


@register("_sample_poisson")
def _sample_poisson(lam, *, shape=(), dtype="float32"):
    return _multisample(lambda g, s, d, l_: _poisson_of(g, l_.contiguous()),
                        (lam,), shape, dtype)


@register("_sample_negative_binomial")
def _sample_negative_binomial(k, p, *, shape=(), dtype="float32"):
    return _multisample(lambda g, s, d, kk, pp: _poisson_of(
        g, torch._standard_gamma(kk.contiguous(), generator=g)
        * ((1.0 - pp) / pp)), (k, p), shape, dtype)


@register("_sample_generalized_negative_binomial")
def _sample_gen_negative_binomial(mu, alpha, *, shape=(), dtype="float32"):
    def body(g, s, d, m, a):
        a = a.clamp_min(1e-8)
        gam = torch._standard_gamma((1.0 / a).contiguous(), generator=g)
        lam = torch.where(a <= 1e-8, m, gam * (m * a))
        return _poisson_of(g, lam.contiguous())
    return _multisample(body, (mu, alpha), shape, dtype)


# -- the numpy samplers ``_npi_*`` (``mxnet_tpu/ops/random.py:195-370``):
# parameters as tensor inputs or keywords; ``size`` the output shape, else
# the parameters' broadcast shape; drawn through :func:`draw` ---------------

def _np_size(size, params):
    if size is not None:
        return (size,) if isinstance(size, int) else tuple(size)
    shapes = [tuple(p.shape) for p in params if isinstance(p, torch.Tensor)]
    return tuple(torch.broadcast_shapes(*shapes)) if shapes else ()


def _np_sampler(name, names, body, default_dtype=torch.float32):
    """Register ``body(g, shape, device, *params)`` as ``name``: params
    ``names`` come positionally as tensors or as keywords."""
    def fn(*tensors, size=None, ctx=None, dtype=None, **kw):
        vals = []
        for i, (pname, default) in enumerate(names):
            v = tensors[i] if i < len(tensors) else kw.get(pname, default)
            vals.append(v)
        dev = tensors[0].device if tensors else _device(ctx)
        vals = [v.to(dev).float() if isinstance(v, torch.Tensor) else v
                for v in vals]
        shape = _np_size(size, vals)
        out = draw(lambda g: body(g, shape, dev, *vals), dev)
        return out.to(default_dtype if dtype is None else _dt(dtype))
    fn.__name__ = name
    fn.__doc__ = body.__doc__
    return register(name)(fn)


def _bc(v, shape, dev):
    return torch.as_tensor(v, dtype=torch.float32, device=dev).expand(
        shape).contiguous()


_np_sampler("_npi_uniform", (("low", 0.0), ("high", 1.0)),
            lambda g, s, d, lo, hi: _uniform01(g, s, d) * (hi - lo) + lo)
_np_sampler("_npi_normal", (("loc", 0.0), ("scale", 1.0)),
            lambda g, s, d, m, sd: m + sd * torch.randn(s, generator=g,
                                                        device=d))
_np_sampler("_npi_exponential", (("scale", 1.0),),
            lambda g, s, d, sc: torch.empty(s, device=d).exponential_(
                1.0, generator=g) * sc)
_np_sampler("_npi_gamma", (("shape", 1.0), ("scale", 1.0)),
            lambda g, s, d, a, sc: torch._standard_gamma(
                _bc(a, s, d), generator=g) * sc)
_np_sampler("_npi_gumbel", (("loc", 0.0), ("scale", 1.0)),
            lambda g, s, d, m, sc: m - sc * torch.log(
                -torch.log(_uniform01(g, s, d, 1e-7))))
_np_sampler("_npi_laplace", (("loc", 0.0), ("scale", 1.0)),
            lambda g, s, d, m, sc: _laplace(g, s, d, loc=m, scale=sc))
_np_sampler("_npi_logistic", (("loc", 0.0), ("scale", 1.0)),
            lambda g, s, d, m, sc: _logistic(g, s, d, loc=m, scale=sc))
_np_sampler("_npi_pareto", (("a", 1.0),),
            lambda g, s, d, a: torch.expm1(torch.empty(s, device=d)
                                           .exponential_(1.0, generator=g)
                                           / a))
_np_sampler("_npi_powerd", (("a", 1.0),),
            lambda g, s, d, a: _uniform01(g, s, d, 1e-7) ** (1.0 / a))
_np_sampler("_npi_rayleigh", (("scale", 1.0),),
            lambda g, s, d, sc: _rayleigh(g, s, d, scale=sc))
_np_sampler("_npi_weibull", (("a", 1.0),),
            lambda g, s, d, a: (-torch.log(_uniform01(g, s, d, 1e-7)))
            ** (1.0 / a))


def _npi_sized(name, body):
    """``body(g, shape, dev, *tensors, size, **kw)`` registered as is."""
    def fn(*tensors, size=None, ctx=None, dtype=None, **kw):
        dev = tensors[0].device if tensors else _device(ctx)
        return draw(lambda g: body(g, dev, *tensors, size=size,
                                   dtype=dtype, **kw), dev)
    fn.__name__ = name
    fn.__doc__ = body.__doc__
    return register(name)(fn)


def _uniform_n(g, dev, *params, low=0.0, high=1.0, size=None, dtype=None):
    """Uniform with ``size`` leading the parameters' shape."""
    lo = params[0].float() if len(params) > 0 else low
    hi = params[1].float() if len(params) > 1 else high
    s = _np_size(size, []) + _np_size(None, [lo, hi])
    return (_uniform01(g, s, dev) * (hi - lo) + lo).to(_dt(dtype))


def _normal_n(g, dev, *params, loc=0.0, scale=1.0, size=None, dtype=None):
    """Normal with ``size`` leading the parameters' shape."""
    m = params[0].float() if len(params) > 0 else loc
    sd = params[1].float() if len(params) > 1 else scale
    s = _np_size(size, []) + _np_size(None, [m, sd])
    return (m + sd * torch.randn(s, generator=g, device=dev)).to(_dt(dtype))


def _bernoulli_np(g, dev, *params, prob=None, logit=None, size=None,
                  dtype=None, is_logit=False):
    """1 with probability ``prob`` (or ``sigmoid(logit)``)."""
    if params:
        if is_logit or (prob is None and logit is not None):
            logit = params[0]
        else:
            prob = params[0]
    if prob is None:
        prob = torch.sigmoid(torch.as_tensor(logit, dtype=torch.float32,
                                             device=dev))
    s = _np_size(size, [prob] if isinstance(prob, torch.Tensor) else [])
    return (_uniform01(g, s, dev) < prob).to(_dt(dtype))


def _dirichlet_np(g, dev, *params, alpha=None, size=None, dtype=None):
    """Dirichlet over the last axis of the concentrations ``alpha``."""
    a = (params[0] if params else torch.as_tensor(
        alpha, device=dev)).float()
    if a.dim() < 1:
        raise ValueError("dirichlet: alpha must be at least 1-d")
    s = _np_size(size, []) + tuple(a.shape)
    x = torch._standard_gamma(a.expand(s).contiguous(), generator=g)
    return (x / x.sum(-1, keepdim=True)).to(_dt(dtype))


def _choice_np(g, dev, *params, a=None, size=None, replace=True,
               weights=None, dtype=None):
    """``np.random.choice``: ``a`` an int or the first tensor input,
    optional probabilities as the second."""
    arr = params[0] if params else a
    p = params[1] if len(params) > 1 else weights
    s = _np_size(size, [])
    k = 1
    for v in s:
        k *= v
    n = int(arr) if not isinstance(arr, torch.Tensor) or arr.dim() == 0 \
        else arr.shape[0]
    if p is not None:
        idx = torch.multinomial(torch.as_tensor(p, device=dev).float(), k,
                                replacement=replace, generator=g)
    elif replace:
        idx = torch.randint(0, n, (k,), generator=g, device=dev)
    else:
        idx = torch.randperm(n, generator=g, device=dev)[:k]
    idx = idx.reshape(s)
    if isinstance(arr, torch.Tensor) and arr.dim() > 0:
        return arr[idx]
    return idx.to(_int_default())


def _multinomial_np(g, dev, *params, n=1, pvals=None, size=None,
                    dtype=None):
    """Counts of ``n`` categorical draws."""
    p = (params[0] if params else torch.as_tensor(pvals,
                                                  device=dev)).float()
    k = p.shape[-1]
    s = _np_size(size, []) + tuple(p.shape[:-1])
    rows_p = torch.broadcast_to(p, s + (k,)).reshape(-1, k)
    rows = rows_p.shape[0]
    idx = torch.multinomial(rows_p.contiguous(), int(n), replacement=True,
                            generator=g)
    counts = torch.zeros(rows, k, dtype=_int_default(), device=dev)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=counts.dtype))
    return counts.reshape(s + (k,))


def _int_default():
    """The reference's default integer: int64 under a 64-bit switch of
    ``util``, else int32."""
    from ..util import x64_enabled
    return torch.int64 if x64_enabled() else torch.int32


for _name, _body in (("_npi_uniform_n", _uniform_n),
                     ("_npi_normal_n", _normal_n),
                     ("_npi_bernoulli", _bernoulli_np),
                     ("_npi_dirichlet", _dirichlet_np),
                     ("_npi_choice", _choice_np),
                     ("_npi_multinomial", _multinomial_np)):
    _npi_sized(_name, _body)


# -- densities ``_random_pdf_*`` (``mxnet_tpu/ops/random.py:463-530``):
# exact functions, one distribution per row of the parameters, the samples
# along the trailing axis ---------------------------------------------------

def _pdf(name):
    def deco(logp_fn):
        def fn(sample, *params, is_log=False):
            logp = logp_fn(sample, *params)
            return logp if is_log else torch.exp(logp)
        fn.__name__ = name
        fn.__doc__ = logp_fn.__doc__
        return register(name)(fn)
    return deco


@_pdf("_random_pdf_uniform")
def _pdf_uniform(sample, low, high):
    # 0 * sample outside: a density flat in the sample still has a
    # (zero) gradient for it, as the reference's
    p = torch.where((sample >= low[..., None]) & (sample <= high[..., None]),
                    1.0 / (high - low)[..., None], 0.0 * sample)
    return torch.log(torch.clamp(p, min=1e-37))


@_pdf("_random_pdf_normal")
def _pdf_normal(sample, mu, sigma):
    m, s = mu[..., None], sigma[..., None]
    return -0.5 * torch.square((sample - m) / s) - torch.log(
        s * (2.0 * torch.pi) ** 0.5)


@_pdf("_random_pdf_gamma")
def _pdf_gamma(sample, alpha, beta):
    a, b = alpha[..., None], 1.0 / beta[..., None]
    return a * torch.log(b) + (a - 1) * torch.log(sample) - b * sample \
        - torch.lgamma(a)


@_pdf("_random_pdf_exponential")
def _pdf_exponential(sample, lam):
    lm = lam[..., None]
    return torch.log(lm) - lm * sample


@_pdf("_random_pdf_poisson")
def _pdf_poisson(sample, lam):
    lm = lam[..., None]
    return sample * torch.log(torch.clamp(lm, min=1e-37)) - lm \
        - torch.lgamma(sample + 1.0)


@_pdf("_random_pdf_negative_binomial")
def _pdf_negative_binomial(sample, k, p):
    kk, pp = k[..., None], p[..., None]
    return torch.lgamma(sample + kk) - torch.lgamma(sample + 1.0) \
        - torch.lgamma(kk) + kk * torch.log(pp) + sample * torch.log1p(-pp)


@_pdf("_random_pdf_generalized_negative_binomial")
def _pdf_gen_negative_binomial(sample, mu, alpha):
    m, a = mu[..., None], alpha[..., None]
    r = 1.0 / a
    p = r / (r + m)
    return torch.lgamma(sample + r) - torch.lgamma(sample + 1.0) \
        - torch.lgamma(r) + r * torch.log(p) + sample * torch.log1p(-p)


@_pdf("_random_pdf_dirichlet")
def _pdf_dirichlet(sample, alpha):
    a = alpha[..., None, :] if alpha.dim() == sample.dim() - 1 else alpha
    return torch.sum((a - 1.0) * torch.log(sample), dim=-1) \
        + torch.lgamma(torch.sum(a, dim=-1)) \
        - torch.sum(torch.lgamma(a), dim=-1)
