"""The port's rope (mxnet_tpu_torch.ops.rope) against the reference's
(mxnet_tpu.ops.rope, its Pallas kernel in interpret mode on the CPU).

Same inputs, made with numpy from a seed, go through both; fp32 parity
at rtol/atol 1e-5.  The CUDA kernel (csrc/rope.cu) runs only on a GPU
(chip_smoke.py holds it against the plain version there); here the CPU
path, the wrappers' device routing and host-side preparation, the
kernel's registration, and the decode engine's use of ``rope_qk`` are
tested.
"""
import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx  # noqa: F401  (registers the reference kernels)
import jax.numpy as jnp
from mxnet_tpu.ops.rope import rope as jax_rope
from mxnet_tpu.serving.decode import DecodeEngine as JaxEngine
from mxnet_tpu.serving.decode import DecodeModel as JaxModel

from mxnet_tpu_torch import convert, kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import rope as rope_mod
from mxnet_tpu_torch.serving import DecodeEngine, DecodeModel
from mxnet_tpu_torch.serving.decode import engine as engine_mod


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


# (shape, positions as a numpy array or a scalar): 3-D, 4-D (a verify
# window's (slots, window) rows) and a scalar position
QK_CASES = [((8, 4, 8), "rows"), ((3, 5, 2, 8), "rows"), ((6, 2, 16), 11)]


@pytest.mark.parametrize("shape,positions", QK_CASES)
def test_rope_qk_is_two_ropes_bitwise(shape, positions):
    """``rope_qk`` returns exactly ``(rope(q), rope(k))`` — bitwise on
    the CPU's plain path — and both agree with the reference at 1e-5."""
    rng = onp.random.RandomState(len(shape) + shape[-1])
    q, k = (rng.randn(*shape).astype(onp.float32) for _ in range(2))
    pos = (rng.randint(0, 2048, size=shape[:-2]).astype(onp.int32)
           if positions == "rows" else positions)
    tpos = torch.from_numpy(pos) if positions == "rows" else pos
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    gq, gk = rope_mod.rope_qk(tq, tk, tpos)
    assert torch.equal(gq, rope_mod.rope(tq, tpos))
    assert torch.equal(gk, rope_mod.rope(tk, tpos))
    jpos = jnp.asarray(pos)
    for got, x in ((gq, q), (gk, k)):
        ref = onp.asarray(jax_rope(jnp.asarray(x), jpos))
        onp.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_rope_qk_on_cpu_is_two_plain_calls():
    q, k = torch.randn(4, 2, 8), torch.randn(4, 2, 8)
    pos = torch.arange(4, dtype=torch.int32)
    launches, plain = rope_mod.rope.launches, rope_mod.rope.plain_calls
    rope_mod.rope_qk(q, k, pos)
    assert rope_mod.rope.plain_calls == plain + 2
    assert rope_mod.rope.launches == launches


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
    """The kernel path never computes on the host: handed CPU tensors it
    raises instead of falling back, for one tensor or for q and k."""
    x = torch.randn(4, 2, 8)
    launches = rope_mod.rope.launches
    with pytest.raises(MXNetError, match="CUDA"):
        rope_mod._rope_cuda((x,), torch.arange(4), 10000.0)
    with pytest.raises(MXNetError, match="CUDA"):
        rope_mod._rope_cuda((x, x.clone()), torch.arange(4), 10000.0,
                            {"pairs": 4, "threads": 128})
    assert rope_mod.rope.launches == launches


def test_empty_leading_dims_pass_through():
    x = torch.randn(0, 2, 8)
    assert rope_mod.rope(x, torch.zeros(0, dtype=torch.int32)) is x
    q, k = rope_mod.rope_qk(x, x, torch.zeros(0, dtype=torch.int32))
    assert q is x and k is x


def test_positions_are_taken_as_they_are_when_ready():
    """The host path copies no positions that already are one per row,
    contiguous, on the tensor's device; it views a contiguous (S, W)
    block flat and makes a scalar one position per row."""
    pos = torch.arange(8, dtype=torch.int32)
    assert rope_mod._rows_positions(pos, (8,), 8, pos.device) is pos
    win = torch.arange(15, dtype=torch.int64).reshape(3, 5)
    flat = rope_mod._rows_positions(win, (3, 5), 15, win.device)
    assert flat.shape == (15,) and flat.data_ptr() == win.data_ptr()
    scalar = rope_mod._rows_positions(7, (3,), 3, torch.device("cpu"))
    assert scalar.tolist() == [7, 7, 7] and scalar.is_contiguous()
    strided = torch.arange(16, dtype=torch.int32)[::2]
    copied = rope_mod._rows_positions(strided, (8,), 8, strided.device)
    assert copied.is_contiguous() and torch.equal(copied, strided)


def test_config_is_resolved_once_per_key(monkeypatch):
    """The registry is asked once per (R bucket, H, D, dtype); later
    calls read the wrapper's dict."""
    calls = []
    real = kernels.resolve

    def counting(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    monkeypatch.setattr(rope_mod, "_CONFIGS", {})
    monkeypatch.setattr(rope_mod._kernels, "resolve", counting)
    x, pos = torch.zeros(8, 8, 64), torch.zeros(8, dtype=torch.int32)
    spec = kernels.get_kernel("rope")
    want = (spec.default_config["pairs"], spec.default_config["threads"])
    assert rope_mod._config(x, pos, 10000.0) == want
    assert rope_mod._config(torch.zeros(40, 8, 64), torch.zeros(40),
                            10000.0) == want
    assert len(calls) == 1
    rope_mod._config(torch.zeros(8, 8, 64, dtype=torch.bfloat16), pos,
                     10000.0)
    assert len(calls) == 2


@pytest.mark.parametrize("key", ["pairs", "threads"])
def test_rope_is_registered_with_its_plain_version(key):
    spec = kernels.get_kernel("rope")
    assert spec.version == 2
    assert spec.fallback is rope_mod.rope_reference
    assert spec.default_config[key] in spec.config_space[key]
    sig, dt = spec.signature(torch.zeros(8, 8, 64), torch.zeros(8))
    assert (sig, dt) == ("r64_h8_d64", "float32")


# -- the decode engine rotates q and k with one rope_qk per layer ------------

VOCAB = 48
GEOM = dict(max_slots=4, num_pages=32, page_size=8, prefill_chunk=8)


def test_decode_engine_uses_rope_qk_and_matches_reference(monkeypatch):
    """Prefill, two decode steps and a speculative step on the CPU give
    the reference engine's tokens on weights carried across by
    convert.py, with one ``rope_qk`` call per layer of each pass."""
    jm = JaxModel(VOCAB, dim=32, n_heads=4, n_layers=2, seed=0)
    jd = JaxModel(VOCAB, dim=16, n_heads=2, n_layers=1, seed=7)
    tm = DecodeModel(VOCAB, dim=32, n_heads=4, n_layers=2, seed=0,
                     device="cpu")
    td = DecodeModel(VOCAB, dim=16, n_heads=2, n_layers=1, seed=7,
                     device="cpu")
    for t, j in ((tm, jm), (td, jd)):
        t.params = convert.decode_params_from_numpy(
            jax.tree.map(onp.asarray, j.params), "cpu")
    calls = []
    real = engine_mod.rope_qk

    def spy(q, k, positions, **kw):
        calls.append(q.shape)
        return real(q, k, positions, **kw)

    monkeypatch.setattr(engine_mod, "rope_qk", spy)
    je = JaxEngine(jm, draft_model=jd, spec_k=2, **GEOM)
    te = DecodeEngine(tm, draft_model=td, spec_k=2, **GEOM)
    prompt = [int(t) for t in onp.random.RandomState(3).randint(
        0, VOCAB, size=11)]
    je.acquire_slot(1, len(prompt) + 12)
    te.acquire_slot(1, len(prompt) + 12)
    for start in range(0, len(prompt), 8):
        chunk = prompt[start:start + 8]
        assert te.prefill_chunk_step(1, chunk, start) == \
            je.prefill_chunk_step(1, chunk, start)
    # two chunks, each through the target (2 layers) and the draft (1)
    assert len(calls) == 2 * (2 + 1)
    toks = onp.zeros(4, onp.int32)
    pos = onp.zeros(4, onp.int32)
    act = onp.zeros(4, bool)
    toks[1], pos[1], act[1] = prompt[-1], len(prompt), True
    for _ in range(2):
        del calls[:]
        plain = rope_mod.rope.plain_calls
        a = je.decode_step(toks, pos, act)
        b = te.decode_step(toks, pos, act)
        onp.testing.assert_array_equal(b, a)
        assert len(calls) == 2 and calls[0] == (4, 4, 8)
        assert rope_mod.rope.plain_calls == plain + 2 * 2
        toks, pos = onp.where(act, b, 0).astype(onp.int32), pos + act
    del calls[:]
    ga, aa = je.spec_step(toks, pos, act)
    gb, ab = te.spec_step(toks, pos, act)
    onp.testing.assert_array_equal(gb[act], ga[act])
    onp.testing.assert_array_equal(ab[act], aa[act])
    # the draft's 3 chained steps (1 layer each), then verify (2 layers)
    assert len(calls) == 3 * 1 + 2 and calls[-1] == (4, 3, 4, 8)
