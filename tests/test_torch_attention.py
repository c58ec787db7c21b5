"""The port's flash attention (mxnet_tpu_torch.ops.attention) against the
reference's (mxnet_tpu.ops.attention), whose Pallas kernels run in
interpret mode on the CPU.

Same numpy inputs through both.  Tolerances are the reference's own
kernel-vs-oracle ones: 2e-4 for the forward (out and LSE: f32 sums in
another block order) and 1e-3 for gradients (tests/test_attention.py),
2e-4 for the plain backward against the Pallas backward on the same
residuals (the same f32 products, summed in another order).  On the CPU
every wrapper takes its plain version; the CUDA kernels are held
against those versions on the card by chip_smoke.py.
"""
import math

import numpy as onp
import pytest
import torch

import jax
import jax.numpy as jnp
import mxnet_tpu as mx  # noqa: F401  (registers the reference kernels)
from mxnet_tpu.ops import attention as jax_attn

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as attn


def _rand(*shape, seed=0):
    return onp.random.RandomState(seed).randn(*shape).astype("float32")


def _qkv(b, h, sq, sk, d, seed, hkv=None):
    hkv = hkv or h
    return (_rand(b, h, sq, d, seed=seed), _rand(b, hkv, sk, d, seed=seed + 1),
            _rand(b, hkv, sk, d, seed=seed + 2))


T = torch.from_numpy


FWD_CASES = [(128, 128, False), (128, 128, True), (256, 256, False),
             (256, 256, True), (100, 180, False), (100, 180, True)]


@pytest.mark.parametrize("sq,sk,causal", FWD_CASES)
def test_forward_matches_reference(sq, sk, causal):
    q, k, v = _qkv(2, 3, sq, sk, 64, seed=sq + sk + causal)
    got = attn.flash_attention(T(q), T(k), T(v), causal=causal).numpy()
    ref = onp.asarray(jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_k=128))
    dense = onp.asarray(jax_attn.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    onp.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    onp.testing.assert_allclose(got, dense, rtol=2e-4, atol=2e-4)
    port_dense = attn.attention_reference(T(q), T(k), T(v),
                                          causal=causal).numpy()
    onp.testing.assert_allclose(port_dense, dense, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sq,sk,causal", FWD_CASES)
def test_lse_matches_pallas_forward(sq, sk, causal):
    q, k, v = (a.reshape(6, a.shape[2], 64)
               for a in _qkv(2, 3, sq, sk, 64, seed=7 + sq))
    scale = 1.0 / math.sqrt(64)
    out, lse = attn.flash_fwd(T(q), T(k), T(v), causal=causal)
    ref_out, ref_lse = jax_attn._fa_forward_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        128, 128)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ref_out),
                                rtol=2e-4, atol=2e-4)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(ref_lse),
                                rtol=2e-4, atol=2e-4)


def test_grouped_query_attention():
    q, k, v = _qkv(2, 4, 128, 128, 64, seed=21, hkv=2)
    got = attn.flash_attention(T(q), T(k), T(v), causal=True).numpy()
    ref = onp.asarray(jax_attn.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        block_q=128, block_k=128))
    onp.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="GQA"):
        attn.flash_attention(T(q), T(k[:, :1].repeat(3, 1)),
                             T(v[:, :1].repeat(3, 1)))


def test_bf16_forward_close_to_reference():
    """bf16 inputs: the plain version rounds p to bf16 before p·v as the
    kernel and the reference do; 2e-2 covers bf16's 8-bit mantissa."""
    q, k, v = _qkv(1, 2, 128, 128, 64, seed=5)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = attn.flash_attention(*bf, causal=True)
    assert got.dtype == torch.bfloat16
    ref = jax_attn.flash_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in bf),
        causal=True, block_q=128, block_k=128)
    onp.testing.assert_allclose(got.float().numpy(),
                                onp.asarray(ref, onp.float32),
                                rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_grads_match_jax(causal):
    q, k, v = _qkv(1, 2, 128, 128, 32, seed=4)

    def loss_flash(q, k, v):
        return jax_attn.flash_attention(q, k, v, causal=causal,
                                        block_q=64, block_k=64).sum()

    ref = jax.grad(loss_flash, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (T(a).requires_grad_() for a in (q, k, v))
    attn.flash_attention(tq, tk, tv, causal=causal).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                    rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("sq,sk,causal", [(128, 128, True),
                                          (100, 180, False),
                                          (257, 257, True)])
def test_plain_backward_matches_pallas_backward(sq, sk, causal):
    q, k, v = (a.reshape(2, a.shape[2], 64)
               for a in _qkv(1, 2, sq, sk, 64, seed=30 + sq))
    do = _rand(2, sq, 64, seed=99)
    scale = 1.0 / math.sqrt(64)
    out, lse = jax_attn._fa_forward_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, scale,
        128, 128)
    res = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out, lse)
    want = jax_attn._fa_backward_pallas(causal, scale, 128, 128, res,
                                        jnp.asarray(do))
    tout, tlse = T(onp.array(out)), T(onp.array(lse))
    got = attn.flash_backward_reference(T(q), T(k), T(v), tout, tlse,
                                        T(do), causal=causal)
    delta = attn._delta(T(do), tout)
    dk, dv = attn.flash_bwd_dkdv(T(q), T(k), T(v), T(do), tlse, delta,
                                 causal=causal)
    dq = attn.flash_bwd_dq(T(q), T(k), T(v), T(do), tlse, delta,
                           causal=causal)
    for a, b, w in zip(got, (dq, dk, dv), want):
        onp.testing.assert_allclose(a.numpy(), onp.asarray(w),
                                    rtol=2e-4, atol=2e-4)
        onp.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("use_flash", [True, False])
def test_multi_head_attention_op(use_flash):
    rng = onp.random.RandomState(8)
    q = rng.randn(2, 128, 64).astype("float32")
    kv = rng.randn(2, 128, 32).astype("float32"), \
        rng.randn(2, 128, 32).astype("float32")
    want = jax_attn._multi_head_attention(
        jnp.asarray(q), *map(jnp.asarray, kv), num_heads=4, causal=True,
        use_flash=use_flash, num_kv_heads=2)
    got = attn.multi_head_attention(T(q), *map(T, kv), num_heads=4,
                                    causal=True, use_flash=use_flash,
                                    num_kv_heads=2)
    onp.testing.assert_allclose(got.numpy(), onp.asarray(want),
                                rtol=2e-4, atol=2e-4)


def test_cpu_takes_the_plain_versions_and_counts_them():
    fns = (attn.flash_fwd, attn.flash_bwd_dkdv, attn.flash_bwd_dq)
    before = [(f.launches, f.plain_calls) for f in fns]
    q, k, v = (T(a).requires_grad_() for a in _qkv(1, 2, 64, 64, 64, 3))
    attn.flash_attention(q, k, v, causal=True).sum().backward()
    for f, (launches, plain) in zip(fns, before):
        assert f.launches == launches
        assert f.plain_calls == plain + 1


def test_kernel_launchers_refuse_cpu_tensors():
    """No fallback: the launch path takes CUDA tensors or raises."""
    q = torch.zeros(1, 8, 64)
    lse = torch.zeros(1, 8)
    with pytest.raises(MXNetError, match="needs CUDA tensors"):
        attn._launch_fwd(q, q, q, True, 1.0, 64)
    with pytest.raises(MXNetError, match="needs CUDA tensors"):
        attn._launch_dkdv(q, q, q, q, lse, lse, True, 1.0, 64)
    with pytest.raises(MXNetError, match="needs CUDA tensors"):
        attn._launch_dq(q, q, q, q, lse, lse, True, 1.0, 64)


def test_registered_kernel_and_block_selection():
    spec = kernels.get_kernel("flash_attention")
    assert spec.config_space == {"tile": (32, 64)}
    q = torch.zeros(2, 100, 64)
    sig, dt = spec.signature(q, q, q, causal=True)
    assert (sig, dt) == ("sq128_sk128_d64_c1", "float32")
    assert attn._resolve_tile(q, q, q, True, 0.125, 32, 32) == 32
    with pytest.raises(MXNetError, match="square tiles"):
        attn._resolve_tile(q, q, q, True, 0.125, 128, 128)
    fb = spec.fallback(q, q, q, causal=True)
    assert tuple(fb.shape) == (2, 100, 64)
