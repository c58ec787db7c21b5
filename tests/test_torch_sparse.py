"""Row-sparse and CSR storage, the sparse Embedding backward, the lazy
optimizer updates and the local store's row-sparse side, in the port
against the reference (``mxnet_tpu/ndarray/sparse.py``,
``tests/test_sparse.py``, ``tests/test_rowsparse_e2e.py``) on the same
numpy inputs, on the CPU, fp32.

Tolerances: the sums of rows (``merge``, ``reduce_list``,
``coalesce_rows``, the Embedding's segment sum) and every copy of rows
are bitwise; the lazy updates rtol 1e-6 against the reference's
``_lazy_kernel`` (XLA may fuse the arithmetic), with the rows they do
not touch bitwise unchanged; dense products (``dot``) rtol 1e-6; a
Gluon loop's weights after three steps rtol 1e-5 (atol 1e-6)."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import nn
from mxnet_tpu_torch.ndarray import sparse as sp

VOCAB, DIM = 50, 4


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    with mt.cpu():
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return onp.asarray(x)


def _same_rsp(got, want):
    """Bitwise equal row-sparse arrays: indices, values and shape."""
    assert tuple(got.shape) == tuple(want.shape)
    onp.testing.assert_array_equal(_np(got.indices).astype(onp.int64),
                                   onp.asarray(want.indices, onp.int64))
    g, w = _np(got.data), onp.asarray(want.data)
    assert g.dtype == w.dtype and g.shape == w.shape
    assert g.tobytes() == w.tobytes()


def _dense_with_zero_rows(rows=6, cols=4, zero_rows=(1, 3, 4), seed=0):
    a = onp.random.RandomState(seed).randn(rows, cols).astype("float32")
    for r in zero_rows:
        a[r] = 0
    return a


# -- constructors, cast_storage, retain, dot, add -----------------------------

def test_cast_storage_matches_the_reference():
    a = _dense_with_zero_rows()
    rsp, jr = mt.nd.array(a).tostype("row_sparse"), \
        mx.nd.array(a).tostype("row_sparse")
    assert rsp.stype == "row_sparse" and rsp.nnz == jr.nnz == 3
    _same_rsp(rsp, jr)
    assert rsp.tostype("default").asnumpy().tobytes() == a.tobytes()
    csr, jc = sp.cast_storage(mt.nd.array(a), "csr"), \
        jsp.cast_storage(mx.nd.array(a), "csr")
    for attr in ("data", "indices", "indptr"):
        onp.testing.assert_array_equal(_np(getattr(csr, attr)),
                                       onp.asarray(getattr(jc, attr)))
    assert csr.asnumpy().tobytes() == a.tobytes()
    assert csr[2].asnumpy().tobytes() == jc[2].asnumpy().tobytes()
    assert mt.nd.cast_storage(rsp, "csr").nnz == jc.nnz


def test_constructors_match_the_reference():
    data = onp.arange(6, dtype="float32").reshape(2, 3)
    r = sp.row_sparse_array((data, [1, 3]), shape=(5, 3))
    jr = jsp.row_sparse_array((data, [1, 3]), shape=(5, 3))
    _same_rsp(r, jr)
    assert r.asnumpy().tobytes() == jr.asnumpy().tobytes()
    assert r.indices.dtype == torch.int32        # the reference's int32
    dense = _dense_with_zero_rows(seed=1)
    _same_rsp(sp.row_sparse_array(dense), jsp.row_sparse_array(dense))
    c = sp.csr_matrix((onp.ones(2, "float32"), [0, 2], [0, 1, 2]),
                      shape=(2, 3))
    jc = jsp.csr_matrix((onp.ones(2, "float32"), [0, 2], [0, 1, 2]),
                        shape=(2, 3))
    assert c.asnumpy().tobytes() == jc.asnumpy().tobytes()
    for stype in ("row_sparse", "csr"):
        z, jz = sp.zeros(stype, (4, 3)), jsp.zeros(stype, (4, 3))
        assert z.nnz == jz.nnz == 0 and z.shape == jz.shape
        assert z.asnumpy().tobytes() == jz.asnumpy().tobytes()
    assert sp.array(dense, stype="row_sparse").nnz == 3
    with pytest.raises(MXNetError):
        sp.row_sparse_array((onp.ones((2, 3)), [0, 1]))   # no shape
    with pytest.raises(MXNetError):
        sp.csr_matrix((onp.ones(2), [0, 1], [0, 1, 2]))
    with pytest.raises(MXNetError):
        sp.zeros("bogus", (2, 2))
    with pytest.raises(MXNetError):
        sp.row_sparse_array((onp.ones((2, 3)), [0]), shape=(4, 3))


def test_retain_dot_add_match_the_reference():
    rng = onp.random.RandomState(2)
    data = rng.randn(3, 4).astype("float32")
    r = sp.row_sparse_array((data, [0, 2, 5]), shape=(6, 4))
    jr = jsp.row_sparse_array((data, [0, 2, 5]), shape=(6, 4))
    _same_rsp(sp.retain(r, [5, 0, 9]), jsp.retain(jr, [5, 0, 9]))
    _same_rsp(r.retain(mt.nd.array(onp.array([2], "int32"))),
              jr.retain([2]))
    rhs = rng.randn(6, 3).astype("float32")
    onp.testing.assert_allclose(
        sp.dot(r, mt.nd.array(rhs), transpose_a=True).asnumpy(),
        jsp.dot(jr, mx.nd.array(rhs), transpose_a=True).asnumpy(),
        rtol=1e-6)
    a = _dense_with_zero_rows(seed=4)
    b = rng.randn(4, 5).astype("float32")
    for ta, bb in ((False, b), (True, rng.randn(6, 5).astype("float32"))):
        got = sp.dot(sp.cast_storage(mt.nd.array(a), "csr"),
                     mt.nd.array(bb), transpose_a=ta).asnumpy()
        want = jsp.dot(jsp.cast_storage(mx.nd.array(a), "csr"),
                       mx.nd.array(bb), transpose_a=ta).asnumpy()
        onp.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    other = sp.row_sparse_array((data[:2], [2, 3]), shape=(6, 4))
    _same_rsp(sp.add(r, other), jsp.add(
        jr, jsp.row_sparse_array((data[:2], [2, 3]), shape=(6, 4))))
    dense_sum = sp.add(r, mt.nd.array(rhs[:, :1].repeat(4, 1)))
    assert dense_sum.asnumpy().tobytes() == jsp.add(
        jr, mx.nd.array(rhs[:, :1].repeat(4, 1))).asnumpy().tobytes()
    onp.testing.assert_array_equal(_np(sp.where_rows(r)._data),
                                   [0, 2, 5])
    with pytest.raises(MXNetError, match="unsupported storage"):
        sp.dot(mt.nd.array(a), r)


# -- merge, reduce_list, coalesce_rows: bitwise -------------------------------

def test_merge_reduce_and_coalesce_are_bitwise_the_references():
    rng = onp.random.RandomState(5)
    parts = []
    for n, seed in ((5, 0), (7, 1), (4, 2)):
        ids = onp.unique(rng.randint(0, 20, size=n))
        vals = rng.randn(ids.size, 3).astype("float32")
        parts.append((vals, ids))
    ports = [sp.row_sparse_array(p, shape=(20, 3)) for p in parts]
    refs = [jsp.row_sparse_array(p, shape=(20, 3)) for p in parts]
    _same_rsp(sp.merge(ports[0], ports[1]), jsp.merge(refs[0], refs[1]))
    _same_rsp(sp.reduce_list(ports), jsp.reduce_list(refs))
    _same_rsp(sp.reduce_list(ports + ports[:1]),
              jsp.reduce_list(refs + refs[:1]))
    with pytest.raises(MXNetError, match="shape mismatch"):
        sp.merge(ports[0], sp.zeros("row_sparse", (21, 3)))
    # many duplicates: the order of the sum is the reference's
    ids = rng.randint(0, 9, size=200)
    vals = rng.randn(200, 5).astype("float32")
    got, want = sp.coalesce_rows(ids, vals), jsp.coalesce_rows(ids, vals)
    onp.testing.assert_array_equal(got[0], want[0])
    assert got[1].tobytes() == want[1].tobytes()
    seg = sp.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids))
    onp.testing.assert_array_equal(_np(seg[0]), want[0])
    assert _np(seg[1]).tobytes() == want[1].tobytes()
    uniq = onp.array([4, 1, 7])
    got = sp.coalesce_rows(uniq, vals[:3])
    want = jsp.coalesce_rows(uniq, vals[:3])
    onp.testing.assert_array_equal(got[0], want[0])
    assert got[1].tobytes() == want[1].tobytes()
    with pytest.raises(MXNetError, match="mismatch"):
        sp.coalesce_rows(onp.zeros((2, 2)), vals[:2])


# -- the lazy updates --------------------------------------------------------

LAZY = [("sgd_update", (("clip_gradient", 0.5), ("rescale_grad", 0.5)), 0),
        ("sgd_mom_update", (("momentum", 0.9), ("rescale_grad", 1.0)), 1),
        ("adagrad_update", (("epsilon", 1e-7), ("rescale_grad", 1.0)), 1),
        ("adam_update", (("beta1", 0.9), ("beta2", 0.999),
                         ("epsilon", 1e-8), ("rescale_grad", 0.25)), 2)]


@pytest.mark.parametrize("kind,statics,n_states", LAZY,
                         ids=[c[0] for c in LAZY])
def test_lazy_updates_match_the_reference_kernel(kind, statics, n_states):
    import jax.numpy as jnp
    rng = onp.random.RandomState(7)
    w = rng.randn(VOCAB, DIM).astype("float32")
    states = [onp.abs(rng.randn(VOCAB, DIM)).astype("float32")
              for _ in range(n_states)]
    rows = onp.array([1, 4, 9, 33], "int32")
    vals = rng.randn(rows.size, DIM).astype("float32")
    lr, wd = 0.05, 0.01
    want = jsp._lazy_kernel(kind, statics)(
        jnp.float32(lr), jnp.float32(wd), jnp.asarray(w), jnp.asarray(vals),
        jnp.asarray(rows), *[jnp.asarray(s) for s in states])
    weight = mt.nd.array(w)
    st = [mt.nd.array(s) for s in states]
    assert sp.lazy_apply(kind, lr, wd, weight,
                         sp.row_sparse_array((vals, rows),
                                             shape=(VOCAB, DIM)),
                         st, dict(statics))
    untouched = onp.setdiff1d(onp.arange(VOCAB), rows)
    for got, ref, before in zip([weight] + st, want, [w] + states):
        got, ref = got.asnumpy(), onp.asarray(ref)
        onp.testing.assert_allclose(got[rows], ref[rows], rtol=1e-6)
        assert got[untouched].tobytes() == before[untouched].tobytes()
    assert not sp.lazy_apply("ftml_update", lr, wd, weight, None, [], {})


def test_module_level_sparse_updates():
    rng = onp.random.RandomState(8)
    w = rng.randn(6, 2).astype("float32")
    g = sp.row_sparse_array((onp.ones((1, 2), "float32"), [3]),
                            shape=(6, 2))
    weight = mt.nd.array(w)
    sp.sgd_update(weight, g, lr=0.5)
    want = w.copy()
    want[3] -= 0.5
    onp.testing.assert_allclose(weight.asnumpy(), want, rtol=1e-6)
    hist = mt.nd.zeros((6, 2))
    sp.adagrad_update(weight, g, hist, lr=0.1)
    assert hist.asnumpy()[3].tolist() == [1.0, 1.0]
    assert hist.asnumpy()[[0, 1, 2, 4, 5]].sum() == 0.0


# -- Embedding(sparse_grad=True) ----------------------------------------------

def _ids_pair(*vals):
    return (mt.nd.array(onp.array(vals, "int32"), dtype="int32"),
            mx.nd.array(onp.array(vals, "float32")))


def _emb_grad(pkg, ids, w0, sparse_grad, steps=1, req="write"):
    emb = (nn if pkg is mt else mx.gluon.nn).Embedding(
        VOCAB, DIM, sparse_grad=sparse_grad)
    emb.initialize()
    emb.weight.set_data(pkg.nd.array(w0))
    if req != "write":
        emb.weight.grad_req = req
        emb.weight._init_grad()
    for x in ids[:steps] if isinstance(ids, list) else [ids]:
        with pkg.autograd.record():
            (emb(x) * 2.0).sum().backward()
    return emb.weight.grad()


def test_embedding_sparse_grad_matches_dense_and_the_reference():
    w0 = onp.random.RandomState(3).randn(VOCAB, DIM).astype("float32")
    ids, jids = _ids_pair(3, 7, 3, 12, 7, 7)
    g = _emb_grad(mt, ids, w0, True)
    assert isinstance(g, sp.RowSparseNDArray)
    _same_rsp(g, _emb_grad(mx, jids, w0, True))
    dense = _emb_grad(mt, ids, w0, False).asnumpy()
    assert g.todense().asnumpy().tobytes() == dense.tobytes()
    assert _np(g.indices).tolist() == [3, 7, 12]
    # grad_req="add": each backward's rows merged into the buffer
    seq = [_ids_pair(1, 2)[0], _ids_pair(2, 4, 4)[0]]
    jseq = [_ids_pair(1, 2)[1], _ids_pair(2, 4, 4)[1]]
    got = _emb_grad(mt, seq, w0, True, steps=2, req="add")
    _same_rsp(got, _emb_grad(mx, jseq, w0, True, steps=2, req="add"))
    assert got.todense().asnumpy().tobytes() == _emb_grad(
        mt, seq, w0, False, steps=2, req="add").asnumpy().tobytes()


def test_sparse_grad_through_nd_and_autograd_grad():
    """``mx.nd.Embedding(..., sparse_grad=True)``: a dense buffer takes
    the rows densified; ``autograd.grad`` returns them row-sparse."""
    w0 = onp.random.RandomState(4).randn(VOCAB, DIM).astype("float32")
    ids = mt.nd.array(onp.array([5, 5, 1], "int32"), dtype="int32")
    w = mt.nd.array(w0)
    w.attach_grad()
    with mt.autograd.record():
        y = mt.nd.Embedding(ids, w, input_dim=VOCAB, output_dim=DIM,
                            sparse_grad=True)
        loss = (y * y).sum()
    loss.backward()
    want = onp.zeros_like(w0)
    want[5] = 4 * w0[5]
    want[1] = 2 * w0[1]
    onp.testing.assert_allclose(w.grad.asnumpy(), want, rtol=1e-6)
    with mt.autograd.record():
        loss = mt.nd.Embedding(ids, w, sparse_grad=True).sum()
    g = mt.autograd.grad(loss, [w])[0]
    assert isinstance(g, sp.RowSparseNDArray) and g.nnz == 2


def test_a_dense_gradient_into_a_row_sparse_buffer_raises():
    """The tied use of a sparse-grad table (a lookup and a dense product
    of one weight) gives it a dense gradient: refused, as in the
    reference."""
    emb = nn.Embedding(VOCAB, DIM, sparse_grad=True)
    emb.initialize()
    ids = mt.nd.array(onp.array([1, 2], "int32"), dtype="int32")
    with mt.autograd.record():
        out = emb(ids).sum() + (emb.weight._data_nd() * 1.0).sum()
    with pytest.raises(MXNetError, match="dense gradient flowed"):
        out.backward()


def test_hybridize_refuses_sparse_grad_at_configuration():
    net = nn.HybridSequential()
    net.add(nn.Embedding(8, 4, sparse_grad=True), nn.Dense(2))
    net.initialize()
    with pytest.raises(MXNetError, match="row_sparse"):
        net.hybridize()
    net.hybridize(active=False)
    ok = nn.HybridSequential()
    ok.add(nn.Embedding(8, 4, sparse_grad=False), nn.Dense(2))
    ok.initialize()
    ok.hybridize()


# -- the lazy optimizer through gluon.Trainer ---------------------------------

BATCHES = [(3, 9, 3), (9, 21, 0), (3, 0, 48)]


def _train(pkg, opt, kw, sparse_grad, kvstore=None, batches=BATCHES):
    w0 = onp.random.RandomState(11).randn(VOCAB, DIM).astype("float32")
    emb = (nn if pkg is mt else mx.gluon.nn).Embedding(
        VOCAB, DIM, sparse_grad=sparse_grad)
    emb.initialize()
    emb.weight.set_data(pkg.nd.array(w0))
    tr = pkg.gluon.Trainer(emb.collect_params(), opt, dict(kw),
                           kvstore=kvstore)
    for b in batches:
        ids = _ids_pair(*b)[0 if pkg is mt else 1]
        with pkg.autograd.record():
            loss = (emb(ids) ** 2).sum()
        loss.backward()
        tr.step(1)
    return emb.weight.data().asnumpy(), w0


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adagrad", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "lazy_update": False}),
    ("rmsprop", {"learning_rate": 0.01})],
    ids=["sgd", "sgd_mom", "adagrad", "adam", "sgd_mom_std", "rmsprop"])
def test_lazy_training_matches_the_reference(opt, kw):
    """Three steps of a sparse-grad Embedding through ``gluon.Trainer``:
    the lazy update (or, without one, the densified update) against the
    reference's trainer on the same weights and ids."""
    got, w0 = _train(mt, opt, kw, True)
    want, _ = _train(mx, opt, kw, True)
    onp.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if opt in ("sgd", "adagrad") and "momentum" not in kw:
        # stateless in rows it does not touch: equals the dense update
        dense, _ = _train(mt, opt, kw, False)
        onp.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6)
    if opt == "adam":
        untouched = sorted(set(range(VOCAB)) - {0, 3, 9, 21, 48})
        assert got[untouched].tobytes() == w0[untouched].tobytes()


def test_lazy_momentum_differs_from_standard():
    """``lazy_update=False`` densifies: momentum keeps moving a row the
    last batch did not touch, the lazy update freezes it."""
    batches = [(2, 5), (5, 9), (9, 2)]
    kw = {"learning_rate": 0.1, "momentum": 0.9}
    lazy, _ = _train(mt, "sgd", kw, True, batches=batches)
    std, _ = _train(mt, "sgd", dict(kw, lazy_update=False), True,
                    batches=batches)
    assert not onp.allclose(lazy[5], std[5])
    onp.testing.assert_allclose(std, _train(mt, "sgd", kw, False,
                                            batches=batches)[0],
                                rtol=1e-6, atol=1e-7)


def test_trainer_through_the_local_store_matches_no_store():
    for opt, kw in (("sgd", {"learning_rate": 0.1}),
                    ("adam", {"learning_rate": 0.05})):
        a, _ = _train(mt, opt, kw, True, kvstore=None)
        for kvs in ("device", "local"):
            b, _ = _train(mt, opt, kw, True, kvstore=kvs)
            assert a.tobytes() == b.tobytes(), (opt, kvs)
        c, _ = _train(mt, opt, kw, True, kvstore=mt.kv.create("local"))
        assert a.tobytes() == c.tobytes()


def test_sparse_steps_are_not_captured(monkeypatch):
    """The whole-step capture declines a row-sparse gradient."""
    from mxnet_tpu_torch.imperative import cached_step
    monkeypatch.setenv("MXNET_CACHED_STEP", "1")
    emb = nn.Embedding(VOCAB, DIM, sparse_grad=True)
    emb.initialize()
    tr = mt.gluon.Trainer(emb.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    ids = _ids_pair(1, 2)[0]
    for _ in range(3):
        with mt.autograd.record():
            (emb(ids) ** 2).sum().backward()
        tr.step(1)
    st = cached_step.trainer_state(tr)
    assert st["captures"] == 0
    assert st["last_reason"] == "row_sparse gradient"


# -- the local store's row-sparse side ----------------------------------------

def test_local_store_row_sparse_push_pull_and_pull_rows():
    W = onp.arange(12, dtype=onp.float32).reshape(4, 3)
    for pkg, mod in ((mt, sp), (mx, jsp)):
        kv = pkg.kv.create("local")
        kv.init("emb", pkg.nd.array(W))
        out = kv.row_sparse_pull("emb", row_ids=pkg.nd.array(
            onp.array([2, 0, 2], onp.int32), dtype="int32"))
        assert isinstance(out, mod.RowSparseNDArray)
        onp.testing.assert_array_equal(_np(out.indices), [0, 2])
        onp.testing.assert_array_equal(_np(out.data), W[[0, 2]])
        g = mod.row_sparse_array((onp.ones((1, 3), onp.float32),
                                  onp.array([1])), shape=(4, 3))
        kv.push("emb", g)
        got = pkg.nd.zeros((4, 3))
        kv.pull("emb", out=got)
        exp = onp.zeros((4, 3), onp.float32)
        exp[1] = 1
        onp.testing.assert_array_equal(got.asnumpy(), exp)
        # a list of row-sparse values sums sparsely
        kv.init("w", pkg.nd.zeros((4, 3)))
        g1 = mod.row_sparse_array((onp.ones((1, 3), onp.float32),
                                   onp.array([0])), shape=(4, 3))
        g2 = mod.row_sparse_array((2 * onp.ones((2, 3), onp.float32),
                                   onp.array([0, 2])), shape=(4, 3))
        out = pkg.nd.zeros((4, 3))
        kv.pushpull("w", [g1, g2], out=out)
        exp = onp.zeros((4, 3), onp.float32)
        exp[0], exp[2] = 3, 2
        onp.testing.assert_array_equal(out.asnumpy(), exp)


def test_local_store_row_sparse_pull_out_buffers_and_errors():
    A = onp.arange(12, dtype=onp.float32).reshape(4, 3)
    B = -onp.arange(6, dtype=onp.float32).reshape(2, 3)
    kv = mt.kv.create("local")
    kv.init(["a", "b"], [mt.nd.array(A), mt.nd.array(B)])
    o = sp.RowSparseNDArray(onp.zeros((1, 3), onp.float32),
                            onp.array([0]), (4, 3))
    ret = kv.row_sparse_pull("a", out=o, row_ids=onp.array([3, 1]))
    assert ret is o
    onp.testing.assert_array_equal(_np(o.indices), [1, 3])
    onp.testing.assert_array_equal(_np(o.data), A[[1, 3]])
    res = kv.row_sparse_pull(["a", "b"], row_ids=[[0], [1]])
    assert len(res) == 2
    onp.testing.assert_array_equal(_np(res[0].data), A[[0]])
    onp.testing.assert_array_equal(_np(res[1].data), B[[1]])
    # the reference's errors, message for message
    jkv = mx.kv.create("local")
    jkv.init(["a", "b"], [mx.nd.array(A), mx.nd.array(B)])
    jo = jsp.RowSparseNDArray(onp.zeros((1, 3), "float32"), [0], (4, 3))
    for store, out in ((kv, o), (jkv, jo)):
        for bad in ([-1], [7]):
            with pytest.raises(Exception, match="out of range"):
                store.row_sparse_pull("a", row_ids=onp.array(bad))
        with pytest.raises(Exception, match="one out buffer per key"):
            store.row_sparse_pull(["a", "b"], out=out,
                                  row_ids=[[0], [1]])
        with pytest.raises(Exception, match="requires row_ids"):
            store.row_sparse_pull("a")
        with pytest.raises(Exception, match="length mismatch"):
            store.row_sparse_pull(["a", "b"], row_ids=[[0], [1], [2]])


def test_local_store_counts_the_embedding_traffic():
    from mxnet_tpu import telemetry as jtel
    from mxnet_tpu_torch import telemetry as tel
    names = ("embedding.rows_pushed", "embedding.rows_pulled",
             "embedding.sparse_bytes", "embedding.dense_equiv_bytes",
             "comm.bytes")
    deltas = []
    for pkg, mod, t in ((mt, sp, tel), (mx, jsp, jtel)):
        before = {n: t.counter(n).value for n in names}
        kv = pkg.kv.create("local")
        kv.init("e", pkg.nd.zeros((10, 3)))
        g = mod.row_sparse_array((onp.ones((2, 3), onp.float32),
                                  onp.array([1, 8])), shape=(10, 3))
        kv.push("e", [g, g])
        kv.row_sparse_pull("e", row_ids=onp.array([4, 1, 4]))
        deltas.append({n: t.counter(n).value - before[n] for n in names})
    assert deltas[0] == deltas[1], deltas


# -- Parameter(stype="row_sparse") --------------------------------------------

def test_row_sparse_data():
    from mxnet_tpu.gluon.parameter import Parameter as JParameter
    from mxnet_tpu_torch.gluon.parameter import Parameter
    w = onp.arange(30, dtype="float32").reshape(10, 3)
    p = Parameter("w", shape=(10, 3), stype="row_sparse",
                  grad_stype="row_sparse")
    p.set_data(mt.nd.array(w))
    jp = JParameter("w", shape=(10, 3), stype="row_sparse",
                    grad_stype="row_sparse")
    jp.set_data(mx.nd.array(w))
    with pytest.raises(MXNetError, match="row_sparse_data"):
        p.data()
    rows = onp.array([7, 2, 2])
    _same_rsp(p.row_sparse_data(rows), jp.row_sparse_data(rows))
    assert p.list_row_sparse_data([0])[0].nnz == 1
    with pytest.raises(MXNetError, match="out of range"):
        p.row_sparse_data([10])
    dense = Parameter("d", shape=(2, 2))
    dense.initialize()
    with pytest.raises(MXNetError, match="use data"):
        dense.row_sparse_data([0])
    with pytest.raises(MXNetError, match="invalid parameter stype"):
        Parameter("x", stype="bogus")
    # the buffer of a row_sparse grad_stype starts with no row
    q = Parameter("q", shape=(5, 2), grad_stype="row_sparse")
    q.initialize()
    assert isinstance(q.grad(), sp.RowSparseNDArray) and q.grad().nnz == 0
    q.zero_grad()
    assert q.grad().nnz == 0
