"""The port's rope (mxnet_tpu_torch.ops.rope) against the reference's
(mxnet_tpu.ops.rope, its Pallas kernel in interpret mode on the CPU).

Same inputs, made with numpy from a seed, go through both; fp32 parity
at rtol/atol 1e-5.  The Triton kernel itself runs only on a GPU
(chip_smoke.py holds it against the plain version there); here the CPU
path and the wrapper's device routing are tested.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx  # noqa: F401  (registers the reference kernels)
import jax.numpy as jnp
from mxnet_tpu.ops.rope import rope as jax_rope

from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import rope as rope_mod


# (shape, max position, base).  Head dim 8 (the decode tests' width)
# runs positions to 2047.  At head dim 64 positions stay below 64: the
# reference's CPU exp is not correctly rounded and differs from torch's
# by 1 ulp for some frequencies, an error the angle multiplies by the
# position (~1e-4 at 2047), beyond the 1e-5 this test holds.
CASES = [((10, 4, 8), 2048, 10000.0),
         ((3, 5, 2, 8), 2048, 10000.0),
         ((6, 2, 64), 64, 10000.0),
         ((7, 3, 16), 512, 500000.0)]


@pytest.mark.parametrize("shape,max_pos,base", CASES)
def test_rope_matches_reference(shape, max_pos, base):
    rng = onp.random.RandomState(sum(shape))
    x = rng.randn(*shape).astype(onp.float32)
    pos = rng.randint(0, max_pos, size=shape[:-2]).astype(onp.int32)
    pos.flat[0] = max_pos - 1
    ref = onp.asarray(jax_rope(jnp.asarray(x), jnp.asarray(pos), base=base))
    got = rope_mod.rope(torch.from_numpy(x), torch.from_numpy(pos),
                        base=base)
    onp.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_rope_scalar_position_broadcasts():
    rng = onp.random.RandomState(4)
    x = rng.randn(5, 2, 8).astype(onp.float32)
    ref = onp.asarray(jax_rope(jnp.asarray(x), 7))
    got = rope_mod.rope(torch.from_numpy(x), 7)
    onp.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cpu_tensor_takes_plain_version_and_counts_it():
    x = torch.randn(4, 2, 8)
    pos = torch.arange(4, dtype=torch.int32)
    launches, plain = rope_mod.rope.launches, rope_mod.rope.plain_calls
    out = rope_mod.rope(x, pos)
    assert rope_mod.rope.plain_calls == plain + 1
    assert rope_mod.rope.launches == launches
    torch.testing.assert_close(out, rope_mod.rope_reference(x, pos),
                               rtol=0, atol=0)


def test_kernel_path_refuses_cpu_tensors():
    """The kernel path never computes on the host: handed a CPU tensor
    it raises instead of falling back."""
    x = torch.randn(4, 2, 8)
    with pytest.raises(MXNetError, match="CUDA"):
        rope_mod._rope_cuda(x, torch.arange(4), 10000.0, 32)


def test_empty_leading_dims_pass_through():
    x = torch.randn(0, 2, 8)
    assert rope_mod.rope(x, torch.zeros(0, dtype=torch.int32)) is x


def test_rope_is_registered_with_its_plain_version():
    spec = kernels.get_kernel("rope")
    assert spec.fallback is rope_mod.rope_reference
    assert spec.default_config["block_v"] in spec.config_space["block_v"]
    sig, dt = spec.signature(torch.zeros(8, 8, 64), torch.zeros(8))
    assert (sig, dt) == ("r64_h8_d64", "float32")
