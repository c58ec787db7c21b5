"""The port's paged attention (mxnet_tpu_torch.ops.paged_attention)
against the reference's Pallas kernel (interpret mode on the CPU).

Same numpy inputs through both, ragged lengths with a length-0 slot;
tolerance 2e-4 as the reference's own kernel-vs-oracle test, and the
length-0 slot must be exact zeros.  The CUDA kernel runs only on a GPU
(chip_smoke.py holds it against the plain version there); here the CPU
path and the wrapper's device routing are tested.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx  # noqa: F401  (registers the reference kernels)
import jax.numpy as jnp
from mxnet_tpu.ops.paged_attention import paged_attention as jax_pa

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged_attention as pa_mod


def _case(slots, pps, pages, ps, h, d, lengths, seed):
    rng = onp.random.RandomState(seed)
    q = rng.randn(slots, h, d).astype(onp.float32)
    kp = rng.randn(pages, ps, h, d).astype(onp.float32)
    vp = rng.randn(pages, ps, h, d).astype(onp.float32)
    tables = rng.permutation(pages)[:slots * pps].reshape(slots, pps)
    return (q, kp, vp, tables.astype(onp.int32),
            onp.asarray(lengths, onp.int32))


CASES = [dict(slots=3, pps=3, pages=12, ps=4, h=2, d=8,
              lengths=[5, 0, 12]),
         dict(slots=4, pps=2, pages=9, ps=8, h=4, d=8,
              lengths=[16, 1, 0, 9]),
         dict(slots=2, pps=4, pages=8, ps=2, h=1, d=64,
              lengths=[7, 3])]


@pytest.mark.parametrize("case", CASES)
def test_paged_attention_matches_reference(case):
    args = _case(seed=case["slots"] * 7 + case["d"], **case)
    ref = onp.asarray(jax_pa(*map(jnp.asarray, args)))
    got = pa_mod.paged_attention(*map(torch.from_numpy, args)).numpy()
    onp.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    for s, n in enumerate(case["lengths"]):
        if n == 0:
            assert not got[s].any()     # length-0 slot → exact zeros


def test_bf16_query_against_fp32_pool():
    """The engine's pool is fp32; a bf16 query is accepted and the
    output comes back in the query's type."""
    args = _case(seed=3, **CASES[0])
    q16 = torch.from_numpy(args[0]).to(torch.bfloat16)
    rest = [torch.from_numpy(a) for a in args[1:]]
    got = pa_mod.paged_attention(q16, *rest)
    assert got.dtype == torch.bfloat16
    ref = onp.asarray(jax_pa(jnp.asarray(q16.float().numpy(),
                                         jnp.bfloat16),
                             *map(jnp.asarray, args[1:])))
    onp.testing.assert_allclose(got.float().numpy(),
                                ref.astype(onp.float32),
                                rtol=2e-2, atol=2e-2)


def test_cpu_tensor_takes_plain_version_and_counts_it():
    args = [torch.from_numpy(a) for a in _case(seed=1, **CASES[1])]
    launches = pa_mod.paged_attention.launches
    plain = pa_mod.paged_attention.plain_calls
    pa_mod.paged_attention(*args)
    assert pa_mod.paged_attention.plain_calls == plain + 1
    assert pa_mod.paged_attention.launches == launches


def test_kernel_path_refuses_cpu_tensors():
    args = [torch.from_numpy(a) for a in _case(seed=1, **CASES[1])]
    with pytest.raises(MXNetError, match="CUDA"):
        pa_mod._paged_attention_cuda(*args, 0.125, 8)


def test_paged_attention_is_registered_with_its_plain_version():
    spec = kernels.get_kernel("paged_attention")
    assert spec.fallback is pa_mod.paged_attention_reference
    assert spec.default_config["warps"] in spec.config_space["warps"]
    args = [torch.from_numpy(a) for a in _case(seed=1, **CASES[1])]
    assert spec.signature(*args) == ("s4_h4_d8_ps8_p2", "float32")
