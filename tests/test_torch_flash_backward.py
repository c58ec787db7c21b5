"""The bf16 flash-attention backward of the port (K2 dK/dV, K3 dQ of
mxnet_tpu_torch.ops.attention) against the reference's Pallas backward
(mxnet_tpu.ops.attention, interpret mode on the CPU), and the three-term
bf16 split that lets the CUDA kernels form the reference's f32 products
on the tensor cores.

Same numpy inputs through both packages.  Tolerances:
- plain bf16 backward vs the Pallas one: one bf16 ulp of the reference
  value plus 1e-6 of the output's max (both round the same f32 sums,
  taken in another order, once to bf16: they may land one ulp apart);
- the split: ``hi + mid + lo == t`` bitwise, and the three f32 products
  summed match the f32 product to 1e-6 of its max (f32 sums in another
  order).
On the CPU every wrapper takes its plain version; chip_smoke.py holds
the CUDA kernels against the plain f32 values on the card.
"""
import math

import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx  # noqa: F401  (registers the reference kernels)
from mxnet_tpu.ops import attention as jax_attn

from mxnet_tpu_torch.ops import attention as attn


def _bf16_values(*shape, seed):
    """f32 numpy values that are exact in bf16."""
    a = onp.random.RandomState(seed).randn(*shape).astype("float32")
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _bf16_ulp(w):
    """One bf16 ulp of each value (8 significant bits)."""
    a = onp.abs(w.astype(onp.float64))
    e = onp.floor(onp.log2(onp.where(a > 0, a, 1.0)))
    return onp.where(a > 0, 2.0 ** (e - 7), 0.0)


@pytest.mark.parametrize("sq,sk,causal", [(128, 128, True),
                                          (128, 128, False),
                                          (100, 180, False),
                                          (257, 257, True)])
def test_bf16_plain_backward_matches_pallas_backward(sq, sk, causal):
    d = 64
    q, k, v = (_bf16_values(2, s, d, seed=40 + s + i)
               for i, s in enumerate((sq, sk, sk)))
    do = _bf16_values(2, sq, d, seed=77)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, do))
    out, lse = jax_attn._fa_forward_pallas(jq, jk, jv, causal, scale, 128,
                                           128)
    want = jax_attn._fa_backward_pallas(causal, scale, 128, 128,
                                        (jq, jk, jv, out, lse), jdo)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in (q, k, v, do))
    tout = torch.from_numpy(onp.asarray(out, onp.float32)).to(torch.bfloat16)
    tlse = torch.from_numpy(onp.array(lse, onp.float32))
    delta = attn._delta(tdo, tout)
    dk, dv = attn.flash_bwd_dkdv(tq, tk, tv, tdo, tlse, delta, causal=causal)
    dq = attn.flash_bwd_dq(tq, tk, tv, tdo, tlse, delta, causal=causal)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        w = onp.asarray(w, onp.float32)
        err = onp.abs(got.float().numpy() - w)
        bound = _bf16_ulp(w) + 1e-6 * onp.abs(w).max()
        assert (err <= bound).all(), (name, float((err - bound).max()))


def test_split_is_exact_for_probabilities():
    p = torch.from_numpy(onp.random.RandomState(1).rand(1 << 16)
                         .astype("float32"))
    hi, mid, lo = attn.split_bf16x3(p)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi.float() + mid.float() + lo.float(), p)


def test_split_is_exact_across_many_decades():
    rng = onp.random.RandomState(2)
    ds = (rng.randn(1 << 16) * 10.0 ** rng.uniform(-12, 4, 1 << 16)
          ).astype("float32")
    ds[:4] = (0.0, -0.0, 1.0, -3.0e-30)
    t = torch.from_numpy(ds)
    hi, mid, lo = attn.split_bf16x3(t)
    assert torch.equal(hi.float() + mid.float() + lo.float(), t)
    # two terms are not enough: the third carries bits
    assert bool((lo != 0).any())


@pytest.mark.parametrize("causal", [True, False])
def test_three_split_products_match_the_f32_product(causal):
    """dK = Σ termᵀ·Q over the split of dS, in f32, is plain K2's dK."""
    bh, sq, sk, d = 2, 96, 80, 64
    q, k, v, do = (torch.from_numpy(_bf16_values(bh, s, d, seed=60 + i))
                   for i, s in enumerate((sq, sk, sk, sq)))
    scale = 1.0 / math.sqrt(d)
    out, lse = attn.flash_forward_reference(q, k, v, causal, scale)
    delta = attn._delta(do, out)
    _, ds = attn._bwd_probs(q, k, v, do, lse, delta, causal, scale)
    split = sum(torch.matmul(term.float().transpose(-1, -2), q)
                for term in attn.split_bf16x3(ds))
    want, _ = attn._dkdv_reference(q, k, v, do, lse, delta, causal, scale)
    assert want.dtype == torch.float32
    tol = 1e-6 * float(want.abs().max())
    assert float((split - want).abs().max()) <= tol
    one_pass = torch.matmul(ds.to(torch.bfloat16).float().transpose(-1, -2),
                            q)
    assert float((one_pass - want).abs().max()) > tol


def test_f32_values_before_rounding_are_the_plain_versions():
    q, k, v, do = (torch.from_numpy(_bf16_values(2, 64, 64, seed=90 + i))
                   .to(torch.bfloat16) for i in range(4))
    lse = torch.zeros(2, 64)
    delta = attn._delta(do, q)
    dk32, dv32 = attn._dkdv_f32(q, k, v, do, lse, delta, True, 0.125)
    dk, dv = attn._dkdv_reference(q, k, v, do, lse, delta, True, 0.125)
    assert dk32.dtype == dv32.dtype == torch.float32
    assert torch.equal(dk32.to(torch.bfloat16), dk)
    assert torch.equal(dv32.to(torch.bfloat16), dv)
    dq32 = attn._dq_f32(q, k, v, do, lse, delta, True, 0.125)
    assert torch.equal(dq32.to(torch.bfloat16),
                       attn._dq_reference(q, k, v, do, lse, delta, True,
                                          0.125))
