"""The distributed kvstore (``mxnet_tpu_torch/kvstore/dist.py``,
``p3store.py``, ``adapters.py``, ``gradient_compression.py``) on spawned
gloo ranks (``torch_dist_cases.RankPool``: one pool of 2 and one of 3
ranks for the file), held against the reference run in this one
process: its ``KVStore("local")`` given every rank's values, its
optimizer on the summed gradient, its ``GradientCompression`` once for
each rank's residual, its ``reduce_list``; where one process cannot run
the reference's multi-rank rule (the stale-synchronous window), the
expected values follow the rule ``mxnet_tpu/kvstore/dist.py:15-30``
documents, each update made by the reference's optimizer.

Tolerances (fp32): sums over ranks rtol 1e-6 (gloo's ring adds in its
own order); SGD's stale-synchronous steps rtol 1e-6 (atol 1e-7: the
two packages' SGD may round a product a ulp apart); 2-bit compression,
the row-sparse reduce and every copy bitwise; an optimizer after
reduced gradients rtol 1e-5 (atol 1e-6); the small transformer's
losses rtol 1e-5 and weights rtol 1e-5 (atol 1e-6) after three
SGD-momentum steps; P3 bitwise against ``dist_sync`` on the same
ranks.  One case starts two port workers through the repo's
``tools/launch.py``."""
import json
import os
import socket
import subprocess
import sys

import numpy as onp
import pytest

import mxnet_tpu as mx
from mxnet_tpu.kvstore.gradient_compression import GradientCompression
from mxnet_tpu.ndarray import sparse as jsp

import torch_dist_cases as cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = [2, 3]


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = cases.RankPool(
                world, tmp_path_factory.mktemp(f"kv{world}"))
        return made[world]
    yield get
    for p in made.values():
        p.close()


def _rng(seed):
    return onp.random.RandomState(seed)


# -- pushpull, broadcast, key batching ----------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_pushpull_broadcast_and_key_batching(pools, world):
    rng = _rng(world)
    values = [{"a": rng.randn(3, 4).astype("float32"),
               "b": rng.randn(5).astype("float32"),
               "c": rng.randn(2, 2)} for _ in range(world)]   # float64
    bcast = [rng.randn(4).astype("float32") for _ in range(world)]
    got = pools(world).run("case_kv_pushpull", values, bcast)
    kv = mx.kv.create("local")
    for k in ("a", "b", "c"):
        want = mx.nd.zeros(values[0][k].shape, dtype=values[0][k].dtype)
        kv.init(k, want)
        kv.pushpull(k, [mx.nd.array(v[k], dtype=v[k].dtype)
                        for v in values], out=want)
        for r in got:
            assert r["out"][k].dtype == values[0][k].dtype
            onp.testing.assert_allclose(r["out"][k], want.asnumpy(),
                                        rtol=1e-6, atol=1e-7)
    for rank, r in enumerate(got):
        assert r["allreduce_calls"] == 2       # one a dtype, one push
        assert r["bcast"].tobytes() == bcast[0].tobytes()
        assert r["rank_world"] == (rank, world)
        assert tuple(r["ckpt_rank_world"]) == (rank, world)
        assert r["dead"] == 0 and r["type"] == "dist_sync"


# -- update_on_kvstore: ZeRO-1 slices -----------------------------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("opt,params", [
    ("adam", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3})],
    ids=["adam", "sgd_mom"])
def test_zero_update_on_kvstore_matches_the_reference(pools, world, opt,
                                                      params):
    rng = _rng(10 + world)
    w0 = {"w": rng.randn(5, 3).astype("float32"),
          "b": rng.randn(7).astype("float32")}
    grads = [[{k: rng.randn(*v.shape).astype("float32")
               for k, v in w0.items()} for _ in range(3)]
             for _ in range(world)]
    got = pools(world).run("case_kv_zero", w0, grads, opt, params)
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.create(opt, **params))
    for k in sorted(w0):
        kv.init(k, mx.nd.array(w0[k]))
    for step in range(3):
        for k in sorted(w0):
            kv.push(k, [mx.nd.array(grads[r][step][k])
                        for r in range(world)])
            want = mx.nd.zeros(w0[k].shape)
            kv.pull(k, out=want)
            for seen, _, _ in got:
                onp.testing.assert_allclose(seen[step][k], want.asnumpy(),
                                            rtol=1e-5, atol=1e-6)
    # each rank holds the optimizer state of its slice only
    states = kv._updater.states
    for k in sorted(w0):
        n = w0[k].size
        chunk = -(-n // world)
        for rank, (_, bounds, st) in enumerate(got):
            lo = min(n, rank * chunk)
            assert bounds[k] == (lo, min(n, lo + chunk), chunk)
            ref = states[k] if isinstance(states[k], tuple) \
                else (states[k],)
            for a, b in zip(st[k], ref):
                onp.testing.assert_allclose(
                    a, b.asnumpy().reshape(-1)[lo:lo + a.size],
                    rtol=1e-5, atol=1e-6)


# -- 2-bit compression --------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_two_bit_compression_is_bitwise_the_references(pools, world):
    rng = _rng(20 + world)
    grads = [[{"w": rng.randn(6, 5).astype("float32"),
               "b": rng.randn(3).astype("float32")} for _ in range(3)]
             for _ in range(world)]
    got = pools(world).run("case_kv_compressed", grads, 0.5)
    comps = [GradientCompression("2bit", 0.5) for _ in range(world)]
    for step in range(3):
        for k in ("b", "w"):
            total = None
            for r in range(world):
                packed, meta = comps[r].compress_packed(
                    k, mx.nd.array(grads[r][step][k]))
                deq = comps[r].dequantize(packed, meta)
                total = deq if total is None else total + deq
            want = onp.asarray(total)
            for out, _, _ in got:
                assert out[step][k].tobytes() == want.tobytes()
    for r, (_, res, sizes) in enumerate(got):
        for k in ("b", "w"):
            assert res[k].tobytes() == \
                onp.asarray(comps[r]._residuals[k]).tobytes()
        # 4 codes a byte: a 16th of the f32 bytes (rounded up per key)
        assert sizes == {"packed_bytes": -(-30 // 4) + -(-3 // 4),
                         "dense_bytes": 4 * 33}


# -- the row-sparse collective ------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_row_sparse_collective_matches_reduce_list(pools, world):
    rng = _rng(30 + world)
    shape = (20, 3)
    pushes = []
    for r in range(world):
        mine = {}
        for key, n in (("a", 4 + r), ("b", 2 * r + 1)):
            idx = onp.sort(rng.choice(20, size=n, replace=False))
            mine[key] = (idx, rng.randn(n, 3).astype("float32"))
        pushes.append(mine)
    got = pools(world).run("case_kv_rowsparse", pushes, shape,
                           {"learning_rate": 0.5})
    for key in ("a", "b"):
        want = jsp.reduce_list([jsp.row_sparse_array(
            (pushes[r][key][1], pushes[r][key][0]), shape=shape)
            for r in range(world)])
        for reduced, _, _, _ in got:
            idx, vals = reduced[key]
            onp.testing.assert_array_equal(idx, onp.asarray(want.indices))
            assert vals.tobytes() == onp.asarray(want.data).tobytes()
    # one counts gather, one index and one value gather (one dtype)
    ba = max(len(p["a"][0]) for p in pushes)
    bb = max(len(p["b"][0]) for p in pushes)
    payload = world * 2 * 4 + world * (ba + bb) * 4 \
        + world * (ba + bb) * 3 * 4
    for _, comm, _, _ in got:
        assert comm == {"payload_bytes": payload,
                        "dense_bytes": 2 * 20 * 3 * 4}
    # the store's optimizer: lazy SGD on the reduced rows
    kv = mx.kv.create("local")
    kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.5))
    kv.init("w", mx.nd.zeros(shape))
    kv.push("w", [jsp.row_sparse_array((p["a"][1], p["a"][0]), shape=shape)
                  for p in pushes])
    kv.push("w", [jsp.row_sparse_array((p[k][1], p[k][0]), shape=shape)
                  for p in pushes for k in ("b", "a")])
    want = mx.nd.zeros(shape)
    kv.pull("w", out=want)
    for rank, (_, _, w, rows) in enumerate(got):
        onp.testing.assert_allclose(w, want.asnumpy(), rtol=1e-6,
                                    atol=1e-7)
        onp.testing.assert_array_equal(rows[0], pushes[rank]["a"][0])
        assert rows[1].tobytes() == w[pushes[rank]["a"][0]].tobytes()


# -- dist_async: the stale-synchronous window ---------------------------------

def test_dist_async_staleness_window_and_reconcile(pools):
    """K = 2, three pushes a rank: a rank reads its own slice fresh after
    every push, the other rank's as of the last rendezvous (push 2), and
    every slice fresh after ``reconcile``."""
    world, K, lr = 2, 2, 0.1
    rng = _rng(40)
    w0 = rng.randn(3, 3).astype("float32")
    grads = [[rng.randn(3, 3).astype("float32") for _ in range(3)]
             for _ in range(world)]
    got = pools(world).run("case_kv_async", w0, grads, lr, K)

    def after(r, j):
        """The reference's SGD after rank r's first j pushes."""
        opt = mx.optimizer.SGD(learning_rate=lr)
        w = mx.nd.array(w0)
        st = opt.create_state_multi_precision(0, w)
        for g in grads[r][:j]:
            opt.update_multi_precision(0, w, mx.nd.array(g), st)
        return w.asnumpy().reshape(-1)

    bounds = [b for _, _, b in got]
    for rank, (views, final, _) in enumerate(got):
        for j, view in enumerate(views, start=1):
            want = w0.reshape(-1).copy()
            for s in range(world):
                lo, hi, _ = bounds[s]
                seen = j if s == rank else K * (j // K)
                want[lo:hi] = after(s, seen)[lo:hi]
            onp.testing.assert_allclose(view.reshape(-1), want, rtol=1e-6,
                                        atol=1e-7)
        want = w0.reshape(-1).copy()
        for s in range(world):
            lo, hi, _ = bounds[s]
            want[lo:hi] = after(s, 3)[lo:hi]
        onp.testing.assert_allclose(final.reshape(-1), want, rtol=1e-6,
                                    atol=1e-7)
    assert got[0][1].tobytes() == got[1][1].tobytes()


# -- optimizer-state files across the packages --------------------------------

def test_optimizer_state_files_cross_the_packages(pools, tmp_path):
    world = 2
    rng = _rng(50)
    w0 = rng.randn(4, 5).astype("float32")
    grads = [[rng.randn(4, 5).astype("float32") for _ in range(2)]
             for _ in range(world)]
    jkv = mx.kv.create("dist_sync")         # one process in the reference
    jkv.set_optimizer(mx.optimizer.Adam(learning_rate=0.01))
    jkv.init("0", mx.nd.array(w0))
    for step in range(2):
        jkv.push("0", mx.nd.array(grads[0][step] + grads[1][step]))
    ref_file = str(tmp_path / "ref_states")
    jkv.save_optimizer_states(ref_file)
    ref_states = [s.asnumpy() for s in jkv._opt_states["0"]]
    got = pools(world).run("case_kv_states_files", w0, grads,
                           str(tmp_path), ref_file)
    chunk = -(-w0.size // world)
    for rank, (path, saved, loaded) in enumerate(got):
        # the port's file in the reference
        jkv.load_optimizer_states(path)
        for a, b in zip(jkv._opt_states["0"], saved):
            assert a.asnumpy().tobytes() == b.tobytes()
        for a, b in zip(saved, ref_states):
            lo = rank * chunk
            onp.testing.assert_allclose(
                a, b.reshape(-1)[lo:lo + a.size], rtol=1e-5, atol=1e-7)
        # the reference's file in the port
        assert list(loaded) == ["0"]
        for a, b in zip(loaded["0"], ref_states):
            assert a.tobytes() == b.tobytes()


# -- gluon.Trainer(kvstore="dist_sync") on a small transformer ----------------

LM = {"vocab": 40, "units": 32, "layers": 2, "heads": 2, "max_len": 16}
SGD = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.mark.parametrize("kvstore,uok", [("dist_sync", None),
                                         ("dist_device_sync", False)])
def test_trainer_dist_sync_dp2_matches_the_whole_batch(pools, kvstore, uok):
    """Two ranks each train on half of every batch (8 sequences of 12
    tokens) through ``dist_sync``: the store's ZeRO SGD by default, the
    local fused step with ``update_on_kvstore=False``.  The reference
    trains on the whole batch in one process.  The step is not
    captured."""
    from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM
    rng = _rng(60)
    batches = [(rng.randint(0, LM["vocab"], size=(8, 12)).astype("int32"),
                rng.randint(0, LM["vocab"], size=(8, 12)).astype("int32"))
               for _ in range(3)]
    jnet = TransformerLM(LM["vocab"], units=LM["units"],
                         num_layers=LM["layers"], num_heads=LM["heads"],
                         max_len=LM["max_len"], use_flash=False)
    jnet.initialize(init=mx.initializer.Xavier())
    jnet(mx.nd.array(onp.zeros((1, 8), "int32")))
    weights = {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()}
    got = pools(2).run("case_kv_trainer_lm", weights, LM, batches, SGD,
                       kvstore, uok)
    tr = mx.gluon.Trainer(jnet.collect_params(), "sgd", dict(SGD))
    ce = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    want = []
    for d, l in batches:
        with mx.autograd.record():
            loss = ce(jnet(mx.nd.array(d)), mx.nd.array(l))
        loss.backward()
        tr.step(d.shape[0])
        want.append(loss.asnumpy())
    for step in range(3):
        halves = onp.concatenate([got[0][0][step], got[1][0][step]])
        onp.testing.assert_allclose(halves, want[step], rtol=1e-5)
    for k, p in jnet.collect_params().items():
        for losses, params, used_store, reason in got:
            onp.testing.assert_allclose(params[k], p.data().asnumpy(),
                                        rtol=1e-5, atol=1e-6, err_msg=k)
    for _, _, used_store, reason in got:
        assert used_store is (uok is None)
        assert reason == "kvstore configuration not capturable"


# -- P3 -----------------------------------------------------------------------

def test_p3_slices_overlap_the_backward_and_match_dist_sync(pools):
    """``p3store_dist`` (update_on_kvstore refused): each parameter's
    pushpull is dispatched during the backward, several before its last
    layer gradient is computed, each parameter once a step; a gradient
    of n values makes ⌈n / threshold⌉ all-reduces; the parameters equal
    the same ranks' ``dist_sync`` run's bitwise and the reference's
    plain trainer on the summed (doubled) gradient."""
    rng = _rng(70)
    net = mx.gluon.nn.HybridSequential()
    for _ in range(6):
        net.add(mx.gluon.nn.Dense(16, in_units=16, activation="relu"))
    net.add(mx.gluon.nn.Dense(2, in_units=16))
    net.initialize(init=mx.initializer.Xavier())
    weights = {k: p.data().asnumpy() for k, p in
               net.collect_params().items()}
    x = rng.randn(4, 16).astype("float32")
    threshold = 100
    got = pools(2).run("case_kv_p3", weights, x, threshold)
    n_params = len(weights)
    slices = sum(-(-w.size // threshold) for w in weights.values())
    for events, calls, params, refused in got:
        assert events.count("push") == n_params
        last_bwd = len(events) - 1 - events[::-1].index("bwd")
        assert events.index("push") < last_bwd
        assert sum(e == "push" for e in events[:last_bwd]) >= 3, events
        assert calls == slices
        assert "no server-side optimizer" in refused
    tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.01})
    for _ in range(3):
        with mx.autograd.record():
            out = net(mx.nd.array(x)).sum() * 2.0
        out.backward()
        tr.step(1)
    for k, p in net.collect_params().items():
        for _, _, params, _ in got:
            onp.testing.assert_allclose(params[k], p.data().asnumpy(),
                                        rtol=1e-6, atol=1e-7)
    plain = pools(2).run("case_kv_p3", weights, x, threshold, "dist_sync")
    for (_, _, a, _), (events, _, b, _) in zip(got, plain):
        assert "push" not in events
        assert all(a[k].tobytes() == b[k].tobytes() for k in weights)


# -- the adapters -------------------------------------------------------------

def test_adapters_raise_the_references_message():
    import mxnet_tpu_torch as mt
    for name in ("horovod", "byteps"):
        msgs = []
        for pkg in (mt, mx):
            with pytest.raises(Exception) as e:
                pkg.kv.create(name)
            msgs.append(str(e.value))
        head = f"kvstore {name!r} requires the {name!r} package"
        assert msgs[0].startswith(head) and msgs[1].startswith(head)


def test_horovod_over_torch_distributed(pools):
    rng = _rng(80)
    x = [rng.randn(5).astype("float32") for _ in range(2)]
    got = pools(2).run("case_kv_horovod", x)
    for rank, (summed, bcast, ids) in enumerate(got):
        onp.testing.assert_allclose(summed, x[0] + x[1], rtol=1e-6)
        assert bcast.tobytes() == x[0].tobytes()
        assert ids == (rank, 2, 0)


# -- tools/launch.py ----------------------------------------------------------

def test_launch_py_starts_two_port_workers(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
         "2", "--port", str(port), "--", sys.executable,
         os.path.join(ROOT, "tests", "torch_dist_cases.py"),
         "launch_worker", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    for rank in range(2):
        with open(tmp_path / f"rank{rank}.json") as f:
            got = json.load(f)
        assert got == {"rank": rank, "world": 2, "out": [3.0, 3.0, 3.0]}
