"""The plain model of the paged-attention kernel's split (K4,
``paged_attention_split_reference`` in mxnet_tpu_torch.ops.paged_attention:
page-aligned partitions of ``partition`` keys, a (m, l, acc) each,
merged in partition order) against the reference's Pallas kernel
(interpret mode on the CPU) and against the unsplit plain version.

Same numpy inputs through all three; lengths on either side of the
partition boundaries (0, 1, P-1, P, P+1, a full slot) and ragged page
tables.  Tolerance 2e-4, as the reference's own kernel-vs-oracle test;
a length-0 slot must be exact zeros.
"""
import numpy as onp
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as mx  # noqa: F401  (registers the reference kernels)
from mxnet_tpu.ops.paged_attention import paged_attention as jax_pa

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged_attention as pa_mod


def _case(lengths, pps, ps, h, d, seed, ragged=False):
    """Pools with one spare page; tables either a permutation (every
    entry a live page) or ragged: entries past a slot's pages are 0."""
    rng = onp.random.RandomState(seed)
    slots = len(lengths)
    pages = slots * pps + 1
    q = rng.randn(slots, h, d).astype(onp.float32)
    kp = rng.randn(pages, ps, h, d).astype(onp.float32)
    vp = rng.randn(pages, ps, h, d).astype(onp.float32)
    tables = rng.permutation(pages)[:slots * pps].reshape(slots, pps)
    if ragged:
        for s, n in enumerate(lengths):
            tables[s, -(-n // ps):] = 0
    return (q, kp, vp, tables.astype(onp.int32),
            onp.asarray(lengths, onp.int32))


def _boundary_lengths(part, cap):
    return [0, 1, part - 1, part, part + 1, cap, 2 * part + 3]


@pytest.mark.parametrize("part,ps,pps,d,ragged", [
    (8, 4, 6, 8, False), (8, 4, 6, 8, True), (16, 4, 5, 16, True),
    (12, 2, 13, 8, False), (4, 4, 4, 64, True)])
def test_split_matches_pallas_and_unsplit(part, ps, pps, d, ragged):
    lengths = _boundary_lengths(part, pps * ps)
    args = _case([min(n, pps * ps) for n in lengths], pps, ps, h=2, d=d,
                 seed=part * 10 + d + ragged, ragged=ragged)
    t = [torch.from_numpy(a) for a in args]
    got = pa_mod.paged_attention_split_reference(*t, partition=part)
    ref = onp.asarray(jax_pa(*map(jnp.asarray, args)))
    onp.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    plain = pa_mod.paged_attention_reference(*t).numpy()
    onp.testing.assert_allclose(got.numpy(), plain, rtol=2e-4, atol=2e-4)
    for s, n in enumerate(args[4]):
        if n == 0:
            assert not got[s].any()      # length-0 slot → exact zeros


def test_split_bf16_query_keeps_its_type():
    args = _case([0, 5, 9], pps=3, ps=4, h=2, d=8, seed=4)
    t = [torch.from_numpy(a) for a in args]
    q16 = t[0].to(torch.bfloat16)
    got = pa_mod.paged_attention_split_reference(q16, *t[1:], partition=4)
    assert got.dtype == torch.bfloat16
    plain = pa_mod.paged_attention_reference(q16, *t[1:])
    torch.testing.assert_close(got.float(), plain.float(), rtol=2e-2,
                               atol=2e-2)
    assert not got[0].any()


def test_split_lengths_past_the_table_are_clamped():
    """A length beyond the slot's pages reads only the slot's pages, as
    the kernel clamps it."""
    args = _case([50], pps=3, ps=4, h=1, d=8, seed=6)
    t = [torch.from_numpy(a) for a in args]
    got = pa_mod.paged_attention_split_reference(*t, partition=8)
    full = torch.tensor([12], dtype=torch.int32)
    want = pa_mod.paged_attention_split_reference(*t[:4], full, partition=8)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("part", [0, 6, -4])
def test_split_refuses_partitions_off_the_page_grid(part):
    t = [torch.from_numpy(a) for a in _case([3], 2, 4, 1, 8, seed=1)]
    with pytest.raises(MXNetError, match="multiple of the page size"):
        pa_mod.paged_attention_split_reference(*t, partition=part)


def test_paged_spec_tunes_partition_and_warps():
    spec = kernels.get_kernel("paged_attention")
    assert spec.version == 2
    assert set(spec.config_space) == {"warps", "partition"}
    assert spec.default_config["partition"] in spec.config_space["partition"]
    # every partition is a whole number of the engine's 16-token pages
    assert all(p % 16 == 0 for p in spec.config_space["partition"])


def test_cpu_call_with_a_partition_takes_the_plain_version():
    t = [torch.from_numpy(a) for a in _case([3, 0], 2, 4, 2, 8, seed=2)]
    plain = pa_mod.paged_attention.plain_calls
    got = pa_mod.paged_attention(*t, partition=128, warps=4)
    assert pa_mod.paged_attention.plain_calls == plain + 1
    torch.testing.assert_close(got, pa_mod.paged_attention_reference(*t))
