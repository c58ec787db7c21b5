"""The shared parity helper of the port's tests: one numpy case through a
function of the reference (``mxnet_tpu``, on jax arrays) and its
counterpart in the port (on torch tensors on the CPU), outputs and
gradients compared at tolerances keyed by dtype.

Gradients are those of ``Σ ct_i · out_i`` over the differentiated
outputs, with the cotangents ``ct_i`` drawn once in numpy (seeded) and
fed to both packages, taken with ``jax.vjp`` and ``torch.autograd.grad``.
Inputs are made in f32 and rounded to the case's dtype by each package
(both round to nearest even, so both see the same values).

Tolerances (:data:`TOL`), each as ``|got − ref| ≤ tol·(|ref| +
max|ref|)``, so that an element near zero is held to the scale of its
tensor:

* float32 (TF32 off): 1e-5 forward, 1e-4 gradients;
* bfloat16: 2e-2 both (a bf16 rounding is 2**-8 ≈ 4e-3; a few of them
  in a row, and f32 sums in another order).

Other test files import :func:`assert_parity` and :func:`close` (pytest
puts ``tests/`` on the path).

Importing this module also sets torch's CPU ops to one thread.  The
suite runs as several pytest-xdist workers, each of which collects (and
so imports) every test file; with torch's default of one thread per
core in each worker, the workers' thread pools oversubscribe the cores
and the port's small CPU ops run many times slower.  The results are
those of a single-threaded CPU run, held to the same tolerances."""
import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

TOL = {"float32": {"forward": 1e-5, "grad": 1e-4},
       "bfloat16": {"forward": 2e-2, "grad": 2e-2}}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return onp.asarray(jnp.asarray(x, jnp.float32))


def close(got, ref, tol, what=""):
    """``|got − ref| ≤ tol·(|ref| + max|ref|)`` elementwise, in f32."""
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(onp.abs(ref).max()) if ref.size else 0.0
    err = onp.abs(got - ref)
    bound = tol * (onp.abs(ref) + scale)
    assert onp.all(err <= bound) and onp.isfinite(got).all(), (
        what, float(err.max()), float((err - bound).max()), tol)


def _tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def assert_parity(jax_fn, torch_fn, arrays, dtype="float32", grad=True,
                  diff_inputs=None, diff_outputs=None, seed=0, tol=None):
    """Run ``jax_fn(*jax arrays)`` and ``torch_fn(*tensors)`` on
    ``arrays`` (numpy, rounded to ``dtype``; integer arrays pass as they
    are) and compare every output and, with ``grad``, the gradients of
    the outputs ``diff_outputs`` (default all) with respect to the
    floating inputs ``diff_inputs`` (default all).  ``tol`` overrides
    :data:`TOL`'s entry.  Returns ``(reference outputs, port outputs)``
    as numpy."""
    tol = tol or TOL[dtype]
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    floating = [onp.issubdtype(onp.asarray(a).dtype, onp.floating)
                for a in arrays]
    j_in = [jnp.asarray(a, jdt) if f else jnp.asarray(a)
            for a, f in zip(arrays, floating)]
    t_in = [torch.from_numpy(onp.array(a)).to(tdt) if f
            else torch.from_numpy(onp.array(a)) for a, f in zip(arrays, floating)]
    if diff_inputs is None:
        diff_inputs = [i for i, f in enumerate(floating) if f]
    for i in diff_inputs:
        t_in[i].requires_grad_(True)

    ref = _tuple(jax_fn(*j_in))
    got = _tuple(torch_fn(*t_in))
    assert len(ref) == len(got)
    for n, (r, g) in enumerate(zip(ref, got)):
        assert g.dtype == tdt or not g.is_floating_point() \
            or r.dtype != jdt, (n, g.dtype, r.dtype)
        close(g, r, tol["forward"], f"output {n}")
    if not grad:
        return [_np(r) for r in ref], [_np(g) for g in got]

    outs = range(len(ref)) if diff_outputs is None else diff_outputs
    rng = onp.random.RandomState(seed + 1)
    cts = {n: rng.standard_normal(ref[n].shape).astype(onp.float32)
           for n in outs}

    def jax_scalar(*diff):
        full = list(j_in)
        for i, d in zip(diff_inputs, diff):
            full[i] = d
        out = _tuple(jax_fn(*full))
        return sum((out[n].astype(jnp.float32) * cts[n]).sum() for n in outs)

    ref_grads = jax.grad(jax_scalar, argnums=tuple(range(len(diff_inputs))))(
        *[j_in[i] for i in diff_inputs])
    loss = sum((got[n].float() * torch.from_numpy(cts[n])).sum()
               for n in outs)
    got_grads = torch.autograd.grad(loss, [t_in[i] for i in diff_inputs],
                                    allow_unused=True)
    for i, r, g in zip(diff_inputs, ref_grads, got_grads):
        g = torch.zeros_like(t_in[i]) if g is None else g
        close(g, r, tol["grad"], f"gradient of input {i}")
    return [_np(r) for r in ref], [_np(g) for g in got]


# -- the helper's own test ----------------------------------------------------

def _jax_dense_tanh(x, w, b):
    return jnp.tanh(x @ w.T + b)


def _torch_dense_tanh(x, w, b):
    return torch.tanh(x @ w.t() + b)


def _case():
    rng = onp.random.RandomState(3)
    return [rng.standard_normal(s).astype(onp.float32)
            for s in ((4, 8), (5, 8), (5,))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_helper_agrees_on_the_same_function(dtype):
    ref, got = assert_parity(_jax_dense_tanh, _torch_dense_tanh, _case(),
                             dtype)
    assert ref[0].shape == got[0].shape == (4, 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_helper_catches_a_wrong_function(dtype):
    """A bias off by 5% fails the forward; a gradient that misses a
    factor fails the gradient check."""
    with pytest.raises(AssertionError, match="output 0"):
        assert_parity(_jax_dense_tanh,
                      lambda x, w, b: torch.tanh(x @ w.t() + 1.05 * b),
                      _case(), dtype)

    class Half(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            return y.clone()

        @staticmethod
        def backward(ctx, g):
            return 0.5 * g

    with pytest.raises(AssertionError, match="gradient of input"):
        assert_parity(_jax_dense_tanh,
                      lambda x, w, b: torch.tanh(Half.apply(x @ w.t()) + b),
                      _case(), dtype)
