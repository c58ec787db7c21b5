"""``mx.random`` — the global seed and the top-level samplers
(counterpart of ``mxnet_tpu/random.py``).  ``mx.random.seed(s)``
reseeds every device's generator (``ops/random.py``): the draws of a run
after it, Dropout's masks and ``Block.initialize``'s weights among them,
repeat bitwise."""
from .ops.random import (seed, next_key, current_key, get_state_bits,
                         set_state_bits, generator)
from .ndarray.random import (uniform, normal, randn, gamma, exponential,
                             poisson, negative_binomial,
                             generalized_negative_binomial, randint,
                             multinomial, bernoulli, shuffle, laplace,
                             rayleigh, gumbel, logistic)

__all__ = ["seed", "uniform", "normal", "randn", "rand", "gamma",
           "exponential", "poisson", "negative_binomial",
           "generalized_negative_binomial", "randint", "multinomial",
           "bernoulli", "shuffle", "laplace", "rayleigh", "gumbel",
           "logistic", "next_key", "current_key", "get_state_bits",
           "set_state_bits", "generator"]


def rand(*shape, **kwargs):
    """Uniform ``[0, 1)`` samples."""
    return uniform(0.0, 1.0, shape=shape or (1,), **kwargs)
