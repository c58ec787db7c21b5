"""Sequence and expert parallelism against the reference
(``mxnet_tpu/parallel/ring_attention.py``, ``ulysses.py``, ``moe.py``
and the transformer's ``ring_mesh``), on the CPU.

The reference runs on the 8 emulated devices ``tests/conftest.py`` sets
up; the port on 4 spawned gloo ranks (``torch_dist_cases.RankPool``),
one pool for the file.  Held at fp32 rtol 1e-5 / atol 1e-6, as the
reference gate's sections (``__graft_entry__.dryrun_multichip``):

* ``loss = mean(attn(q, q, q)²)`` and its gradient for ring, ring-flash
  (causal; K1–K3's plain versions on the CPU) and Ulysses attention at
  sp4, through the whole-tensor wrappers;
* the transformer LM trained at dp2×sp2 with ``seq_axis=1`` and each
  ``sp_mode`` (ring-flash, ring, Ulysses): losses, parameters, SGD
  state, and ``comm.sp.bytes`` counted;
* Switch MoE at ep4 (tokens and experts sharded): loss, output, the
  gradients, and a capacity drop counted in ``moe.dropped_tokens`` as
  the reference counts it;
* ``ring_flash_fold``, the ring-flash body with every rank in this
  process (what the card runs to check that body), against the
  reference's ring-flash on n emulated devices.
"""
import jax
import jax.numpy as jnp
import numpy as onp
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as JLM

import torch_dist_cases as cases

WORLD = 4
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = cases.RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def _inputs(kind):
    sp = WORLD
    if kind == "ring_flash":
        return (onp.random.RandomState(7).randn(1, 2, 32 * sp, 8)
                .astype("float32") * .5)
    if kind == "ulysses":
        return onp.random.RandomState(5).randn(2, sp, 4 * sp, 8) \
            .astype("float32")
    return onp.random.RandomState(2).randn(2, 2, 4 * sp, 8).astype("float32")


@pytest.mark.parametrize("kind,causal", [("ring", False), ("ring", True),
                                         ("ring_flash", True),
                                         ("ulysses", False)])
def test_sequence_attention_matches_the_reference(pool, kind, causal):
    q = _inputs(kind)
    mesh = jpar.make_mesh({"sp": WORLD})
    kw = {"causal": causal}
    if kind == "ring_flash":
        kw.update(block_q=32, block_k=32)
    fn = {"ring": jpar.ring_self_attention,
          "ring_flash": jpar.ring_flash_self_attention,
          "ulysses": jpar.ulysses_self_attention}[kind]
    if kind == "ulysses" and causal:
        kw = {"causal": True}

    def loss(qq):
        return jnp.mean(fn(qq, qq, qq, mesh, **kw) ** 2)

    want_l, want_g = jax.jit(jax.value_and_grad(loss))(jnp.asarray(q))
    got = pool.run("case_seq_attention", kind, q, causal)
    for l, g in got:
        onp.testing.assert_allclose(l, float(want_l), **TOL)
        onp.testing.assert_allclose(g, onp.asarray(want_g), **TOL)


LM = dict(vocab=32, units=16, layers=1, heads=2, max_len=16)


@pytest.mark.parametrize("sp_mode", ["ring_flash", "ring", "ulysses"])
def test_transformer_dp2xsp2_ring_flash_matches_the_reference(pool,
                                                              sp_mode):
    """The LM with its attention context parallel over sp (ring-flash,
    ring, Ulysses) and the sequence axis of the batch sharded on it
    (``seq_axis=1``), SGD with momentum."""
    mx.random.seed(0)
    lm = JLM(LM["vocab"], units=LM["units"], num_layers=LM["layers"],
             num_heads=LM["heads"], max_len=LM["max_len"])
    lm.initialize(init=mx.initializer.Xavier())
    lm(mx.nd.array(onp.zeros((1, 8), onp.int32), dtype="int32"))
    w = {k: p.data().asnumpy() for k, p in lm.collect_params().items()}
    mesh = jpar.make_mesh({"dp": 2, "sp": 2})
    for blk in lm.blocks:
        blk.attn._ring_mesh = mesh
        blk.attn._sp_mode = sp_mode
    ce = jloss.SoftmaxCrossEntropyLoss()

    def lm_loss(logits, labels):
        return ce(logits.reshape((-1, LM["vocab"])), labels.reshape((-1,)))

    toks = onp.random.RandomState(4).randint(0, 32, (4, 17)).astype("int32")
    data = [(toks[:, :16], toks[:, 1:].astype("float32"))] * 3
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    jtr = jpar.SPMDTrainer(lm, lm_loss, optimizer="sgd",
                           optimizer_params=opt, mesh=mesh, seq_axis=1)
    want_l = [float(jtr.step(d, l).asnumpy()) for d, l in data]
    want_p = {k: p.data().asnumpy() for k, p in jtr._params.items()}
    want_s = {k: [onp.asarray(a) for a in jtr._opt_state[k]]
              for k in jtr._pkeys}
    cfg = dict(LM, use_flash=True)
    got = pool.run("case_spmd_lm", w, cfg, None, {"dp": 2, "sp": 2}, 1,
                   sp_mode, data, opt)
    for losses, params, states, _, sp_bytes in got:
        assert sp_bytes > 0          # comm.sp.bytes: the ring / all-to-all
        onp.testing.assert_allclose(losses, want_l, **TOL)
        for k in want_p:
            onp.testing.assert_allclose(params[k], want_p[k], **TOL,
                                        err_msg=k)
            for a, b in zip(states[k], want_s[k]):
                onp.testing.assert_allclose(a, b, **TOL, err_msg=k)


@pytest.mark.parametrize("capacity_factor", [2.0, 0.5])
def test_switch_moe_ep4_matches_the_reference(pool, capacity_factor):
    """The reference gate's switch-MoE section (capacity 2.0), and a
    capacity that drops tokens: both packages count the same drops."""
    rng = onp.random.RandomState(3)
    h, e, f = 8, WORLD * 2, 16
    params = (rng.randn(h, e).astype("float32") * .5,
              rng.randn(e, h, f).astype("float32") * .3,
              rng.randn(e, f).astype("float32") * .1,
              rng.randn(e, f, h).astype("float32") * .3,
              rng.randn(e, h).astype("float32") * .1)
    x = rng.randn(32, h).astype("float32")
    mesh = jpar.make_mesh({"ep": WORLD})
    rep, *ex = jpar.moe_expert_sharding(mesh)
    jp = tuple(jax.device_put(jnp.asarray(p), s)
               for p, s in zip(params, [rep] + list(ex)))
    xt = jax.device_put(jnp.asarray(x), NamedSharding(mesh, JP()))

    def moe_loss(ps):
        y, aux = jpar.switch_moe(xt, *ps, capacity_factor=capacity_factor)
        return jnp.mean(y ** 2) + 0.01 * aux

    (want_l, want_g) = jax.jit(jax.value_and_grad(moe_loss))(jp)
    jtel.reset("moe.")
    try:
        want_y, _ = jpar.switch_moe(jnp.asarray(x),
                                    *[jnp.asarray(p) for p in params],
                                    capacity_factor=capacity_factor)
        want_drop = jtel.counter("moe.dropped_tokens").value
    finally:
        jtel.reset("moe.")     # leave no record section behind (F20)
    got = pool.run("case_moe", x, params, capacity_factor)
    n = e // WORLD
    for r, (loss, y, ggate, gexp, dropped, counted) in enumerate(got):
        onp.testing.assert_allclose(loss, float(want_l), **TOL)
        onp.testing.assert_allclose(y, onp.asarray(want_y), **TOL)
        onp.testing.assert_allclose(ggate, onp.asarray(want_g[0]), **TOL)
        for g, wg in zip(gexp, want_g[1:]):
            onp.testing.assert_allclose(
                g, onp.asarray(wg)[r * n:(r + 1) * n], **TOL)
        assert dropped == counted == want_drop
    assert (want_drop > 0) == (capacity_factor < 1)


@pytest.mark.parametrize("n,causal", [(4, True), (4, False), (1, True),
                                      (1, False)])
def test_folded_ring_flash_matches_the_reference(n, causal):
    """``ring_flash_fold``: the ring-flash body of an n-rank ring with
    every rank in this process (the device check of that body on one
    card) against the reference's ring-flash on n emulated devices, for
    the output and the gradients of a given dO; its LSE against the
    port's unsharded flash forward.  A ring of one shard is flash
    attention itself, bitwise."""
    import torch
    from mxnet_tpu_torch.ops import attention as attn_ops
    from mxnet_tpu_torch.parallel.ring_attention import ring_flash_fold
    rng = onp.random.RandomState(11)
    b, h, s, d = 1, 2, 16 * WORLD, 8
    q, k, v, do = (rng.randn(b, h, s, d).astype("float32") * .5
                   for _ in range(4))
    mesh = jpar.make_mesh({"sp": n})

    def attn(qq, kk, vv):
        return jpar.ring_flash_self_attention(qq, kk, vv, mesh,
                                              causal=causal, block_q=16,
                                              block_k=16)

    want_o, vjp = jax.vjp(attn, *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(do))
    flat = [torch.as_tensor(a.reshape(b * h, s, d)) for a in (q, k, v, do)]
    out, lse, *grads = ring_flash_fold(*flat[:3], n, causal=causal,
                                       do=flat[3])
    onp.testing.assert_allclose(out.numpy().reshape(q.shape),
                                onp.asarray(want_o), **TOL)
    for g, w in zip(grads, want_g):
        onp.testing.assert_allclose(g.numpy().reshape(q.shape),
                                    onp.asarray(w), **TOL)
    whole_o, whole_lse = attn_ops.flash_fwd(*flat[:3], causal=causal)
    onp.testing.assert_allclose(lse.numpy(), whole_lse.numpy(), **TOL)
    if n == 1:
        assert torch.equal(out, whole_o) and torch.equal(lse, whole_lse)
