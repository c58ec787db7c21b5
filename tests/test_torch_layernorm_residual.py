"""The port's fused LayerNorm + residual (mxnet_tpu_torch.ops.
layernorm_residual, K6) against the reference's Pallas kernel (interpret
mode on the CPU), through ``mx.nd`` under ``autograd.record()``.

Same numpy inputs in both packages: forward and all four gradients
(x, residual, gamma, beta) for ragged row counts (100, 257), an odd
feature size (100) and a 3-D input.  Tolerances: fp32 forward 2e-5,
gradients 1e-4 (the reference's own kernel-vs-oracle tolerances,
``tests/test_kernels.py``); bf16 compared in float32 at 2e-2.  The CUDA
kernel runs only on a GPU (chip_smoke.py holds it against the plain
version there); here the CPU path, the backward and the wrapper's
routing are tested.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops import layernorm_residual as jlnr

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import layernorm_residual as lnr

TOLS = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}


def _inputs(shape, seed):
    rng = onp.random.RandomState(seed)
    f = shape[-1]
    return (rng.randn(*shape), rng.randn(*shape), rng.rand(f) + 0.5,
            rng.randn(f) * 0.1, rng.randn(*shape))


def _run(pkg, arrays, dtypes, loss):
    """Forward and the four gradients of one package's nd path."""
    ctx = mx.cpu() if pkg is mx else jmx.cpu()
    *ins, dy = [pkg.nd.array(a, ctx=ctx, dtype=d)
                for a, d in zip(arrays, dtypes)]
    for a in ins:
        a.attach_grad()
    with pkg.autograd.record():
        y = pkg.nd.layer_norm_residual(*ins)
        head = (y * y).mean() if loss else y
    head.backward(None if loss else dy)
    return [t.astype("float32").asnumpy()
            for t in (y, *(a.grad for a in ins))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(100, 64), (257, 100), (3, 7, 64)])
def test_forward_and_gradients_against_reference(shape, dtype):
    arrays = _inputs(shape, seed=sum(shape))
    dtypes = [dtype] * 5
    fwd_tol, grad_tol = TOLS[dtype]
    before = lnr.layer_norm_residual.plain_calls
    got = _run(mx, arrays, dtypes, loss=False)
    assert lnr.layer_norm_residual.plain_calls == before + 1
    fallbacks = jmx.kernels.stats()["fallbacks"]
    ref = _run(jmx, arrays, dtypes, loss=False)
    assert jmx.kernels.stats()["fallbacks"] == fallbacks   # Pallas ran
    onp.testing.assert_allclose(got[0], ref[0], rtol=fwd_tol, atol=fwd_tol)
    for g, r in zip(got[1:], ref[1:]):
        onp.testing.assert_allclose(g, r, rtol=grad_tol, atol=grad_tol)


def test_mean_square_loss_and_mixed_dtypes():
    """The chip path's loss, ``(y * y).mean()``, in fp32; then x in fp32
    with a bf16 residual (the output keeps x's dtype)."""
    arrays = _inputs((33, 64), seed=5)
    got = _run(mx, arrays, ["float32"] * 5, loss=True)
    ref = _run(jmx, arrays, ["float32"] * 5, loss=True)
    for g, r in zip(got, ref):
        onp.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)
    mixed = ["float32", "bfloat16", "float32", "float32", "float32"]
    got = _run(mx, arrays, mixed, loss=False)
    ref = _run(jmx, arrays, mixed, loss=False)
    for g, r in zip(got, ref):
        onp.testing.assert_allclose(g, r, rtol=2e-2, atol=2e-2)


def test_plain_version_and_backward_against_torch_autograd():
    """``_lnr_backward`` (the explicit f32 backward) equals autograd of
    the plain version, which ``use_pallas=False`` selects (fp32, 1e-5:
    the two sum in another order)."""
    x, r, g, b, dy = (torch.tensor(a, dtype=torch.float32)
                      for a in _inputs((5, 48), seed=9))
    for t in (x, r, g, b):
        t.requires_grad_()
    out = lnr.layer_norm_residual(x, r, g, b, use_pallas=False)
    auto = torch.autograd.grad(out, (x, r, g, b), dy)
    mine = lnr._lnr_backward(x, r, g, b, 1e-5, dy)
    for a, m in zip(auto, mine):
        onp.testing.assert_allclose(m.detach().numpy(), a.numpy(),
                                    rtol=1e-5, atol=1e-5)
    via_nd = mx.nd.layer_norm_residual(
        *[mx.nd.array(t.detach().numpy(), ctx=mx.cpu()) for t in (x, r, g,
                                                                   b)],
        use_pallas=False)
    onp.testing.assert_allclose(via_nd.asnumpy(), out.detach().numpy(),
                                rtol=1e-6, atol=1e-6)


def test_kernel_spec_and_cache_key_match_the_reference():
    spec = kernels.get_kernel("layer_norm_residual")
    assert spec.config_space == {"rows_per_block": (2, 4, 8, 16)}
    assert spec.default_config == {"rows_per_block": 8}
    for shape in ((100, 64), (257, 100), (3, 7, 64), (8, 2048, 512)):
        t = torch.zeros(shape)
        sig, dt = lnr._lnr_signature(t, t, t[..., 0, :], t[..., 0, :])
        j = jnp.zeros(shape)
        jsig, jdt = jlnr._lnr_signature(j, j, j, j)
        assert (sig, dt) == (jsig, jdt)
    key = kernels.cache_key(spec, "rows16384_f512", "bfloat16")
    assert key.startswith("layer_norm_residual|v1|")
    assert key.endswith("|bfloat16|rows16384_f512")
    case = {"rows": 20, "f": 24, "device": "cpu"}
    (x, r, g, b), params = spec.make_args(case)
    (jx, jr, jg, jb), _ = jmx.kernels.get_kernel(
        "layer_norm_residual").make_args(case)
    for a, ja in zip((x, r, g, b), (jx, jr, jg, jb)):
        onp.testing.assert_allclose(a.numpy(), onp.asarray(ja), rtol=1e-7)
    onp.testing.assert_allclose(spec.fallback(x, r, g, b, **params).numpy(),
                                onp.asarray(jlnr._lnr_reference(
                                    jx, jr, jg, jb, 1e-5)),
                                rtol=2e-5, atol=2e-5)


def test_cuda_path_refuses_cpu_tensors_and_bad_shapes():
    x = torch.zeros((4, 8))
    g = torch.ones(8)
    with pytest.raises(MXNetError, match="CUDA"):
        lnr._launch(x, x, g, g, 1e-5, 8)
    with pytest.raises(MXNetError, match="must match"):
        lnr.layer_norm_residual(x, torch.zeros((4, 9)), g, g)
    before = lnr.layer_norm_residual.launches
    lnr.layer_norm_residual(x, x, g, g)
    assert lnr.layer_norm_residual.launches == before
