"""``Mesh4DTrainer``, ``MeshPlan.tp_column`` / ``tp_row`` and the
persistence of state sharded over ranks against the reference
(``mxnet_tpu/parallel/mesh4d.py``, ``trainer.py``), on the CPU.

The reference runs on the 8 emulated devices ``tests/conftest.py`` sets
up; the port on 8 spawned gloo ranks (``torch_dist_cases.RankPool``),
one pool for the file.  Both get the same numpy weights and batches.
Held at fp32 rtol 1e-5 / atol 1e-6, on every rank of the mesh: the
losses of each ``run_steps`` window, the whole f32 masters and momentum
after them (gathered from the ranks), the per-axis comm bytes of the
analytic model and the dropped-token count — pp2×dp2×tp2 through 1F1B
(``tests/test_mesh4d.py:87``), dp2×ep4 through Switch MoE (``:117``),
dp2×tp2 with one dispatch a window in the telemetry records (``:157``);
the refusals (``:148``, and a tp-sharded stage function that never
reduces its partial sums); a dp2×tp2 checkpoint restored bit for bit on
dp4×tp1 (``:190``); the reference's 3-D capstone
(``__graft_entry__.py:489``) at pp2×dp2×tp2, in bf16 compute, at a bf16
tolerance (rtol 2e-2); and ``SPMDTrainer`` saving and loading state
sharded over 4 ranks (ZeRO-3 at dp4; dp2×tp2) bit for bit across mesh
shapes.  ``test_mesh4d.py:242`` is red on the reference and is not used.
"""
import json

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
from jax.sharding import PartitionSpec as JP

from mxnet_tpu import telemetry as jtel
from mxnet_tpu.parallel import MeshPlan as JPlan
from mxnet_tpu.parallel import Mesh4DTrainer as JTrainer
from mxnet_tpu.parallel import switch_moe as jmoe

import torch_dist_cases as cases
from test_torch_mesh import dense_weights, batches, jax_dense, jax_train

WORLD = 8
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = cases.RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def j_mse(out, t):
    return jnp.mean((out - t) ** 2)


def j_fn(name):
    def mlp(p, h):
        a, b = p
        return jax.nn.relu(h @ a) @ b

    def mlp_bias(p, h):
        a, ab, b, c = p
        return jax.nn.relu(h @ a + ab) @ b + c

    def psum(p, h):
        a, b = p
        return jax.lax.psum(jax.nn.relu(h @ a) @ b, "tp")

    def moe(p, x):
        y, aux, stats = jmoe(x, *p, capacity_factor=1.0, return_stats=True)
        return y, 0.01 * aux, stats["dropped_tokens"]

    return {"mlp": mlp, "mlp_bias": mlp_bias, "psum": psum,
            "moe": moe}[name]


KINDS = ("dp", "tp", "pp", "ep", "reduce_scatter", "all_gather",
         "allreduce", "ppermute", "all_to_all")


def reference(plan_kw, fn, params, specs, x, y, windows, opts):
    """The reference's Mesh4DTrainer: the windows' losses, the masters,
    the momentum and the comm counters it moved."""
    jtel.reset("comm.")
    jtel.reset("moe.")
    tr = JTrainer(JPlan(**plan_kw), j_fn(fn), j_mse,
                  tuple(jnp.asarray(p) for p in params),
                  param_specs=None if specs is None else
                  tuple(JP(*s) if s is not None else None for s in specs),
                  **opts)
    losses = [onp.asarray(tr.run_steps(x, y, n_steps=n)) for n in windows]
    comm = {k: jtel.counter(f"comm.{k}.bytes").value for k in KINDS}
    return (losses, [onp.asarray(p) for p in tr._params],
            [onp.asarray(m) for m in tr._momentum], comm,
            jtel.counter("moe.dropped_tokens").value)


def run_both(pool, plan_kw, fn, params, specs, x, y, windows, opts,
             members, jsonl=None):
    want = reference(plan_kw, fn, params, specs, x, y, windows, opts)
    got = [r for r in pool.run("case_mesh4d", plan_kw, fn, params, specs,
                               x, y, windows, opts, jsonl)
           if r is not None]
    assert len(got) == members
    for r in got:
        for a, b in zip(r[0], want[0]):
            onp.testing.assert_allclose(a, b, **TOL)
        for part in (1, 2):          # masters, momentum
            for a, b in zip(r[part], want[part]):
                onp.testing.assert_allclose(a, b, **TOL)
        assert r[3] == want[3]
        assert r[4] == want[4]
    return got, want


def test_tp_column_and_tp_row_outside_a_step():
    """On a tp axis of size 1 the pair is the identity, as GSPMD's
    constraints are; ``tp_column`` checks its feature axis."""
    import torch
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.parallel import MeshPlan
    plan = MeshPlan(dp=1, device="cpu")
    x = torch.randn(4, 6, requires_grad=True)
    y = plan.tp_row(plan.tp_column(x) * 2.0)
    assert torch.equal(y, x * 2.0)
    y.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 2.0))
    with pytest.raises(MXNetError, match="feature axis"):
        plan.tp_column(x, feature_axis=2)


def test_pp_dp_tp_1f1b_matches_the_reference(pool):
    """pp2×dp2×tp2 (``test_mesh4d.py:87``): 1F1B over pp with the stage's
    tp sum (``lax.psum`` / ``collectives.all_reduce``), ZeRO over dp;
    losses, masters, momentum and every axis's bytes."""
    rng = onp.random.RandomState(0)
    S, H, F = 2, 16, 32
    params = (rng.randn(S, H, F).astype("float32") * 0.1,
              rng.randn(S, F, H).astype("float32") * 0.1)
    specs = (("pp", None, "tp"), ("pp", "tp", None))
    x = rng.randn(8, H).astype("float32")
    y = rng.randn(8, H).astype("float32")
    opts = {"learning_rate": 0.05, "n_microbatches": 2}
    got, want = run_both(pool, {"dp": 2, "tp": 2, "pp": 2}, "psum", params,
                         specs, x, y, (4,), opts, 8)
    assert got[0][0][0][-1] < got[0][0][0][0]
    assert all(want[3][k] > 0 for k in ("dp", "tp", "pp"))
    assert all(r[5] > 0 for r in got)


def test_moe_ep_path_matches_the_reference(pool):
    """dp2×ep4 (``test_mesh4d.py:117``): switch_moe with the tokens over
    dp × ep and the experts over ep; capacity drops counted."""
    rng = onp.random.RandomState(1)
    H, E, F = 16, 4, 32
    params = (rng.randn(H, E).astype("float32") * 0.5,
              rng.randn(E, H, F).astype("float32") * 0.2,
              rng.randn(E, F).astype("float32") * 0.1,
              rng.randn(E, F, H).astype("float32") * 0.2,
              rng.randn(E, H).astype("float32") * 0.1)
    specs = (None, ("ep",), ("ep",), ("ep",), ("ep",))
    x = rng.randn(32, H).astype("float32")
    y = rng.randn(32, H).astype("float32")
    got, want = run_both(pool, {"dp": 2, "ep": 4}, "moe", params, specs, x,
                         y, (3,), {"learning_rate": 0.05}, 8)
    assert want[4] > 0 and want[3]["ep"] > 0
    assert got[0][0][0][-1] < got[0][0][0][0]


def test_dp_ep_dropout_keeps_the_rows_of_the_one_device_mask(pool):
    """dp2×ep2 cuts the batch's dim 0 over two axes, dp outer: each rank
    draws the whole batch's mask and keeps rows ``(i_dp·2 + i_ep)·B`` to
    ``+B`` of it, the rows ``Mesh4DTrainer`` gives it, so the four ranks'
    masks put together are the one-device mask, bit for bit."""
    rng = onp.random.RandomState(5)
    params = (rng.randn(16, 32).astype("float32") * 0.1,
              rng.randn(32, 16).astype("float32") * 0.1)
    x = rng.uniform(0.5, 1.5, (32, 16)).astype("float32")
    y = rng.randn(32, 16).astype("float32")
    got = [r for r in pool.run("case_mesh4d_dropout", params, x, y, 0.5, 7)
           if r is not None]
    assert len(got) == 4
    import mxnet_tpu_torch as mt
    with mt.cpu():
        mt.random.seed(7)
        whole = mt.nd.Dropout(mt.nd.array(x), p=0.5,
                              mode="always").asnumpy() != 0
    B = x.shape[0] // 4
    rows = {}
    for i_dp, i_ep, mask in got:
        assert mask.shape == (B, 16)
        rows[i_dp * 2 + i_ep] = mask
    assert sorted(rows) == [0, 1, 2, 3]
    for part, mask in rows.items():
        onp.testing.assert_array_equal(mask, whole[part * B:(part + 1) * B],
                                       err_msg=f"part {part}")


def test_refusals(pool):
    """ep in a spec under pp (``test_mesh4d.py:148``), and a stage
    function that reads tp shards but never reduces their partial
    sums."""
    rng = onp.random.RandomState(2)
    params = (rng.randn(16, 32).astype("float32") * 0.1,
              rng.randn(32, 16).astype("float32") * 0.1)
    got = [r for r in pool.run("case_mesh4d_refusals", params)
           if r is not None]
    assert got
    for r in got:
        for msg in r:
            assert msg is not None and msg.startswith("MXNetError")
    assert any("'ep'" in m for r in got for m in r)
    assert any("tp_row" in m for r in got for m in r)


def test_one_dispatch_a_window_and_by_axis(pool, tmp_path):
    """dp2×tp2 (``test_mesh4d.py:157``): each window is one dispatch in
    its telemetry record, and its bytes land on the dp and tp axes in
    ``collective_split.by_axis``; the column → row pair kept sharded."""
    rng = onp.random.RandomState(2)
    params = (rng.randn(16, 32).astype("float32") * 0.1,
              rng.randn(32, 16).astype("float32") * 0.1)
    specs = ((None, "tp"), ("tp", None))
    x = rng.randn(8, 16).astype("float32")
    y = rng.randn(8, 16).astype("float32")
    path = str(tmp_path / "t.jsonl")
    got, _ = run_both(pool, {"dp": 2, "tp": 2}, "mlp", params, specs, x, y,
                      (3, 3), {"learning_rate": 0.05}, 4, jsonl=path)
    for rank in range(4):
        recs = [json.loads(line) for line in open(f"{path}.{rank}")]
        assert [r["dispatches"] for r in recs] == [1, 1]
        by_axis = recs[-1]["collective_split"]["by_axis"]
        assert by_axis["dp"] > 0 and by_axis["tp"] > 0
        assert by_axis.get("pp", 0) == 0 and by_axis.get("ep", 0) == 0
    assert all(r[6] == 1 for r in got)       # one executable


@pytest.mark.parametrize("zero", [True, False])
def test_tp_pair_with_replicated_leaves_matches_the_reference(pool, zero):
    """dp2×tp2, the GSPMD path with a column bias sharded over tp and a
    replicated output bias (its gradient summed over tp from the ranks'
    partial sums), with and without ZeRO."""
    rng = onp.random.RandomState(5)
    params = (rng.randn(16, 32).astype("float32") * 0.1,
              rng.randn(32).astype("float32") * 0.1,
              rng.randn(32, 16).astype("float32") * 0.1,
              rng.randn(16).astype("float32") * 0.1)
    specs = ((None, "tp"), ("tp",), ("tp", None), None)
    x = rng.randn(8, 16).astype("float32")
    y = rng.randn(8, 16).astype("float32")
    run_both(pool, {"dp": 2, "tp": 2}, "mlp_bias", params, specs, x, y,
             (2, 1), {"learning_rate": 0.05, "weight_decay": 1e-3,
                      "zero": zero}, 4)


def test_checkpoint_restores_across_mesh_shapes(pool, tmp_path):
    """dp2×tp2 → dp4×tp1 (``test_mesh4d.py:190``): every rank writes its
    boxes, every rank of the other plan reads its own; masters and
    momentum bit for bit, and the restored trainer steps on."""
    rng = onp.random.RandomState(3)
    params = (rng.randn(32, 64).astype("float32") * 0.1,
              rng.randn(64, 32).astype("float32") * 0.1)
    specs = ((None, "tp"), ("tp", None))
    x = rng.randn(8, 32).astype("float32")
    y = rng.randn(8, 32).astype("float32")
    got = pool.run("case_mesh4d_restore", params, specs, x, y,
                   str(tmp_path / "ckpt"))
    saved = [r[0] for r in got if r[0] is not None]
    loaded = [r for r in got if r[1] is not None]
    assert len(saved) == 4 and len(loaded) == 4
    for r in loaded:
        assert r[2]["mesh_axes"]["tp"] == 2
        for a, b in zip(r[1][0] + r[1][1], saved[0][0] + saved[0][1]):
            onp.testing.assert_array_equal(a, b)
        assert onp.isfinite(r[3]).all()
    # the reference's own restore, for the values
    ta = JTrainer(JPlan(dp=2, tp=2), j_fn("mlp"), j_mse,
                  tuple(jnp.asarray(p) for p in params),
                  param_specs=tuple(JP(*s) for s in specs),
                  learning_rate=0.05)
    ta.run_steps(x, y, n_steps=2)
    for a, b in zip(saved[0][0], ta._params):
        onp.testing.assert_allclose(a, onp.asarray(b), **TOL)


def test_capstone_3d_matches_the_reference(pool):
    """``__graft_entry__._capstone_3d`` at pp2×dp2×tp2: a bf16 embedding
    chained in front of 1F1B through the input gradient and a row
    scatter, the stages tp-sharded (Megatron's f, then ``lax.psum``),
    SGD with momentum; bf16 compute, so rtol 2e-2."""
    S3, DP, TP, M3 = 2, 2, 2, 4
    Vv, Hc, Fc, Tt = 32, 8, 16, 4
    rng = onp.random.RandomState(9)
    emb = rng.randn(Vv, Hc).astype("float32") * .3
    w1 = rng.randn(S3, Hc, Fc).astype("float32") * .3
    w2 = rng.randn(S3, Fc, Hc).astype("float32") * .3
    B3 = M3 * 2 * DP
    toks = rng.randint(0, Vv, (B3, Tt)).astype("int32")
    tgt = rng.randn(B3, Tt, Hc).astype("float32")
    lr, lr_e, mu = 0.1, 0.2, 0.9
    mesh = jax.sharding.Mesh(
        onp.array(jax.devices()[:8]).reshape(S3, DP, TP), ("pp", "dp", "tp"))

    def tp_enter(v):
        @jax.custom_vjp
        def f(u):
            return u
        f.defvjp(lambda u: (u, None),
                 lambda _, g: (jax.lax.psum(g, "tp"),))
        return f(v)

    def stage(p, x):
        a, b = p
        xb = tp_enter(x)
        h = jax.nn.relu(xb @ a.astype(jnp.bfloat16))
        return x + jax.lax.psum(h @ b.astype(jnp.bfloat16), "tp")

    def loss3(y, t):
        return jnp.mean((y.astype(jnp.float32) - t) ** 2)

    from mxnet_tpu.parallel import pipeline_value_and_grad_1f1b as j1f1b

    @jax.jit
    def step(E, W1, W2):
        xemb = E.astype(jnp.bfloat16)[toks]
        loss, (g1, g2), dxe = j1f1b(
            stage, loss3, (W1, W2), xemb, tgt, mesh, n_microbatches=M3,
            param_specs=(JP("pp", None, "tp"), JP("pp", "tp", None)),
            return_input_grad=True)
        vals = dxe.reshape(-1, Hc).astype(jnp.float32)
        new_e = E.at[toks.reshape(-1)].add(-lr_e * vals)
        m1, m2 = g1.astype(jnp.float32), g2.astype(jnp.float32)
        return loss, new_e, W1 - lr * m1, W2 - lr * m2, m1, m2

    want = [onp.asarray(a) for a in step(emb, w1, w2)]
    got = [r for r in pool.run("case_capstone", emb, w1, w2, toks, tgt, M3,
                               lr, lr_e, mu) if r is not None]
    assert len(got) == 8
    for r in got:
        for a, b in zip(r, want):
            onp.testing.assert_allclose(a, b, rtol=2e-2, atol=2e-3)


def test_spmd_trainer_persists_state_sharded_over_ranks(pool, tmp_path):
    """SPMDTrainer over 4 ranks: a ZeRO-3 dp4 trainer's checkpoint loads
    bit for bit into a dp2×tp2 trainer (head row-parallel, ZeRO-1) and a
    fresh dp4 one, and its ``save_states`` file into another; the loaded
    dp2×tp2 trainer's next step matches the saver's."""
    w = dense_weights()
    data = batches(8)
    opt = {"learning_rate": 0.1}
    got = pool.run("case_spmd_persist", w, data, str(tmp_path), opt)
    saved = [r for r in got if r and "saved" in r]
    tp = [r for r in got if r and "tp" in r]
    assert len(saved) == 4 and len(tp) == 4
    params, states = saved[0]["saved"]
    for r in saved:
        for key in ("dp", "states"):
            loaded = r[key] if key == "states" else r[key][1]
            for k in states:
                for a, b in zip(loaded[k], states[k]):
                    onp.testing.assert_array_equal(a, b)
        for k in params:
            onp.testing.assert_array_equal(r["dp"][0][k], params[k])
        assert r["num_update"] == 2
    for r in tp:
        for k in params:
            onp.testing.assert_array_equal(r["tp"][0][k], params[k])
            for a, b in zip(r["tp"][1][k], states[k]):
                onp.testing.assert_array_equal(a, b)
        onp.testing.assert_allclose(r["tp_next"], saved[0]["saved_next"],
                                    **TOL)
    # the reference's run of the same three steps, for the values
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.parallel import SPMDTrainer as JSPMD
    from mxnet_tpu.parallel import make_mesh as jmesh
    jtr = JSPMD(jax_dense(w), jloss.SoftmaxCrossEntropyLoss(),
                optimizer="adam", optimizer_params=opt,
                mesh=jmesh({"dp": 4}), zero_stage=3)
    want = jax_train(jtr, data)
    onp.testing.assert_allclose(saved[0]["saved_next"], want[0][2], **TOL)
