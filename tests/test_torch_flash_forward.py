"""The port's blocked model of the flash forward (K1's arithmetic,
``flash_forward_blocked`` in mxnet_tpu_torch.ops.attention) against the
reference's Pallas forward (mxnet_tpu.ops.attention, interpret mode on
the CPU) at the same key block, and the flash tuner's repair.

Same numpy inputs through both packages.  Tolerances:
- f32: out and LSE 1e-5 (the same f32 recurrence, sums in another
  order);
- bf16: out within one bf16 ulp of the reference value plus 1e-5 of its
  max.  Both round p against the same running max and the f32 result
  once, but s is summed in another order, so a p near a rounding
  boundary can round the other way: that moves an output by an absolute
  amount (up to 2**-9 p·|v| / l), which near zero is many ulps of the
  value; at 1e-6 of the max one such element of 600 rows fails (4.6e-6
  of the max).  LSE 1e-5 (an f32 value).
On the CPU the wrappers take their plain versions; chip_smoke.py holds
the CUDA K1 against the plain version on the card.
"""
import math

import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx  # noqa: F401  (registers the reference kernels)
from mxnet_tpu.ops import attention as jax_attn

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.ops import attention as attn


def _qkv(bh, sq, sk, d, seed):
    rng = onp.random.RandomState(seed)
    return tuple(rng.randn(bh, s, d).astype("float32")
                 for s in (sq, sk, sk))


def _bf16_ulp(w):
    """One bf16 ulp of each value (8 significant bits)."""
    a = onp.abs(w.astype(onp.float64))
    e = onp.floor(onp.log2(onp.where(a > 0, a, 1.0)))
    return onp.where(a > 0, 2.0 ** (e - 7), 0.0)


CASES = [(128, 128, False, 128), (256, 256, True, 128),
         (100, 180, False, 64), (300, 300, True, 128),
         (257, 257, True, 64)]


@pytest.mark.parametrize("sq,sk,causal,block_k", CASES)
def test_blocked_forward_matches_pallas_f32(sq, sk, causal, block_k):
    q, k, v = _qkv(2, sq, sk, 64, seed=sq + sk + block_k)
    scale = 1.0 / math.sqrt(64)
    out, lse = attn.flash_forward_blocked(
        *map(torch.from_numpy, (q, k, v)), causal, scale, block_k)
    ref_out, ref_lse = jax_attn._fa_forward_pallas(
        *map(jnp.asarray, (q, k, v)), causal, scale, 128, block_k)
    onp.testing.assert_allclose(out.numpy(), onp.asarray(ref_out),
                                rtol=1e-5, atol=1e-5)
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(ref_lse),
                                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sq,sk,causal,block_k", CASES)
def test_blocked_forward_matches_pallas_bf16(sq, sk, causal, block_k):
    """p is rounded to bf16 against the running max before p·v, as the
    reference kernel (and K1) round it."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(2, sq, sk, 64, seed=3 * sq + sk))
    scale = 1.0 / math.sqrt(64)
    out, lse = attn.flash_forward_blocked(q, k, v, causal, scale, block_k)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref_out, ref_lse = jax_attn._fa_forward_pallas(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        causal, scale, 128, block_k)
    want = onp.asarray(ref_out, onp.float32)
    err = onp.abs(out.float().numpy() - want)
    assert (err <= _bf16_ulp(want) + 1e-5 * onp.abs(want).max()).all(), \
        float(err.max())
    onp.testing.assert_allclose(lse.numpy(), onp.asarray(ref_lse),
                                rtol=1e-5, atol=1e-5)


def test_blocked_forward_is_the_plain_forward_in_f32():
    """Without p's rounding the recurrence is the plain softmax: the
    blocked model and flash_forward_reference agree in f32."""
    q, k, v = map(torch.from_numpy, _qkv(3, 200, 200, 64, seed=8))
    out, lse = attn.flash_forward_blocked(q, k, v, True, 0.125, 64)
    ref_out, ref_lse = attn.flash_forward_reference(q, k, v, True, 0.125)
    torch.testing.assert_close(out, ref_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)


def test_tuner_times_forward_and_backward():
    """The tile the tuner picks serves K2 and K3, so a tuning run goes
    through the forward and the backward: on CPU tensors each of the
    three wrappers takes its plain version once."""
    fns = (attn.flash_fwd, attn.flash_bwd_dkdv, attn.flash_bwd_dq)
    before = [(f.launches, f.plain_calls) for f in fns]
    q, k, v = map(torch.from_numpy, _qkv(2, 64, 64, 64, seed=2))
    out = attn._flash_kernel_run({"tile": 64}, q, k, v, causal=True)
    assert out.shape == q.shape and not out.requires_grad
    assert [(f.launches, f.plain_calls) for f in fns] == \
        [(n, p + 1) for n, p in before]
    assert not q.requires_grad           # the caller's tensors untouched


def test_flash_spec_is_version_2_with_square_tiles():
    spec = kernels.get_kernel("flash_attention")
    assert spec.version == 2
    assert spec.run is attn._flash_kernel_run
    assert spec.config_space == {"tile": attn._TILES}
    assert spec.default_config["tile"] in attn._TILES
