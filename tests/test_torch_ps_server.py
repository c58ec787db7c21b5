"""The parameter server of uncoordinated ``dist_async``
(``mxnet_tpu_torch/kvstore/ps_server.py``) against the reference's
(``mxnet_tpu/kvstore/ps_server.py``): the wire is the reference's byte
for byte, each package decodes the other's frames, and each package's
client works against the other's server (init, set, push, pull,
row-sparse and packed pushes, ``pull_rows``, push counts, liveness).
Then the port's own contract: HMAC signing, no pickle on the data
plane, an optimizer instance a key with shared step counts, and
``dist_async`` with ``MXNET_ASYNC_UNCOORDINATED=1`` over two spawned
gloo ranks pushing unequal counts, with ``get_num_dead_node``.

Values are bitwise equal between the packages (the server runs numpy
and the optimizer's arithmetic is the same); the uncoordinated run is
held at rtol 1e-6 (atol 1e-7: pushes apply in arrival order) against
the reference's SGD applied push by push."""
import os
import pickle
import socket
import time

import numpy as onp
import pytest
import torch

from mxnet_tpu.kvstore import ps_server as R

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore import ps_server as P

import torch_dist_cases as cases

MSGS = [
    ("push", "w", onp.arange(12, dtype=onp.float32).reshape(3, 4)),
    ("push_sparse", "e", onp.array([1, 5], onp.int64),
     onp.ones((2, 3), onp.float16), (10, 3)),
    ("ok", None), ("ok", (0, 1, 2)), ("ok", ()), ("push_count", "k"),
    ("ok", 42), ("ok", -7), ("set_optimizer", b"\x00\x01opaque\xff"),
    ("ok", onp.array(3.5, onp.float32)),            # 0-dim
    ("ok", onp.zeros((0, 4), onp.int32)),           # 0-size
    ("push_sparse_packed", "e", onp.array([0, 3]),
     onp.array([9, 1], onp.uint8), 6, (4, 3), "float32",
     onp.asarray(0.5, onp.float64)),
    ("ok", onp.arange(5, dtype=onp.uint8), onp.arange(3, dtype=onp.int64),
     onp.ones((2, 2), onp.float64), onp.array([True, False])),
]


def _same(a, b):
    if isinstance(b, onp.ndarray):
        a = onp.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(b, (tuple, list)):
        assert tuple(a) == tuple(b)
    else:
        assert a == b


@pytest.mark.parametrize("msg", MSGS, ids=range(len(MSGS)))
def test_frames_are_the_references_byte_for_byte(msg):
    frame = P._encode_msg(msg)
    assert frame == R._encode_msg(msg)
    for dec in (P._decode_msg, R._decode_msg):
        got = dec(frame)
        assert len(got) == len(msg)
        for a, b in zip(got, msg):
            _same(a, b)


def test_tensors_and_bfloat16_travel_as_the_references_arrays():
    import ml_dtypes
    a = onp.asarray([1.5, -2.0, 3.25], onp.float32)
    assert P._encode_msg(("x", torch.from_numpy(a))) == \
        R._encode_msg(("x", a))
    b = torch.tensor(a, dtype=torch.bfloat16)
    rb = a.astype(ml_dtypes.bfloat16)
    assert P._encode_msg(("x", b)) == R._encode_msg(("x", rb))
    (got,) = R._decode_msg(P._encode_msg((b,)))
    assert got.dtype == rb.dtype and got.tobytes() == rb.tobytes()


@pytest.mark.parametrize("key", [None, b"secret-xyz"], ids=["plain", "hmac"])
def test_signed_and_plain_frames_are_the_references(key):
    msg = ("push", "w", onp.arange(6, dtype=onp.float32))
    sent = []

    class Sink:
        def sendall(self, b):
            sent.append(b)
    P._send_msg(Sink(), msg, key)
    R._send_msg(Sink(), msg, key)
    assert sent[0] == sent[1]


def test_codec_rejects_bad_frames_and_objects():
    with pytest.raises(MXNetError, match="magic"):
        P._decode_msg(b"XXXX\x00")
    good = P._encode_msg(("ok",))
    with pytest.raises(MXNetError, match="trailing"):
        P._decode_msg(good + b"\x00")

    class Evil:
        pass
    with pytest.raises(MXNetError, match="unsupported argument"):
        P._encode_msg(("push", "w", Evil()))


def test_no_pickle_on_the_data_plane():
    arr = onp.arange(6, dtype=onp.float32)
    payload = P._encode_msg(("push", "w", arr))
    assert arr.tobytes() in payload
    called = []
    orig = pickle.loads
    try:
        pickle.loads = lambda *a, **k: called.append(1) or orig(*a, **k)
        P._decode_msg(payload)
        P._decode_msg(R._encode_msg(("push_sparse", "e",
                                     onp.array([1]), arr[:3], (4, 3))))
    finally:
        pickle.loads = orig
    assert not called


# -- each package's client against the other's server -------------------------

def _drive(cli, mod):
    """The same traffic through a client: init (first wins), set, dense
    and row-sparse accumulation, a packed push, pulls, counts."""
    cli.hello(3)
    out = {}
    cli.init("w", onp.ones((4,), onp.float32))
    cli.init("w", onp.full((4,), 9.0, onp.float32))
    out["init"] = cli.pull("w")
    cli.set("w", onp.full((4,), 5.0, onp.float32))
    cli.push("w", onp.arange(4, dtype=onp.float32))
    out["push"] = cli.pull("w")
    cli.init("e", onp.zeros((6, 3), onp.float32))
    cli.push_sparse("e", onp.array([4, 1, 4]),
                    onp.arange(9, dtype=onp.float32).reshape(3, 3), (6, 3))
    packed, n = mod._pack_2bit_np(onp.array(
        [[0.5, -0.5, 0.0], [0.0, 0.5, 0.5]], onp.float32))
    cli.push_sparse_packed("e", onp.array([2, 4]), packed, n, (6, 3),
                           "float32", 0.5)
    out["sparse"] = cli.pull("e")
    out["rows"] = cli.pull_rows("e", onp.array([4, 0]))
    out["counts"] = (cli.push_count("w"), cli.push_count("e"),
                     cli.push_count("none"))
    out["alive"] = cli.alive_ranks()
    # each package's MXNetError
    with pytest.raises(RuntimeError, match="out of range"):
        cli.push_sparse("e", onp.array([6]), onp.ones((1, 3), onp.float32),
                        (6, 3))
    with pytest.raises(RuntimeError, match="unknown key"):
        cli.pull("missing")
    cli.close()
    return out


def test_clients_and_servers_cross_between_the_packages():
    from mxnet_tpu.embedding import sharded as jsh
    from mxnet_tpu_torch.embedding import sharded as sh
    results = {}
    for sname, smod in (("port", P), ("ref", R)):
        for cname, cmod, pack in (("port", P, sh), ("ref", R, jsh)):
            srv = smod.ParamServer("127.0.0.1", 0)
            try:
                results[(sname, cname)] = _drive(
                    cmod.PSClient(srv.address), pack)
            finally:
                srv.stop()
    want = results[("ref", "ref")]
    assert want["counts"] == (1, 2, 0) and want["alive"] == [3]
    for k, got in results.items():
        for name in want:
            if isinstance(want[name], onp.ndarray):
                assert got[name].dtype == want[name].dtype, (k, name)
                assert got[name].tobytes() == want[name].tobytes(), (k, name)
            else:
                assert got[name] == want[name], (k, name)


def test_server_applies_the_port_optimizer_with_per_key_counts():
    srv = P.ParamServer("127.0.0.1", 0)
    try:
        c = P.PSClient(srv.address)
        c.hello(0)
        c.set_optimizer(mt.optimizer.Adam(learning_rate=0.01))
        c.init("a", onp.ones((3,), onp.float32))
        c.init("b", onp.ones((3,), onp.float32))
        for _ in range(5):
            c.push("a", onp.full((3,), 0.5, onp.float32))
        c.push("b", onp.full((3,), 0.5, onp.float32))
        a_opt, b_opt = srv._optimizers["a"], srv._optimizers["b"]
        assert a_opt is not b_opt
        assert a_opt._index_update_count is b_opt._index_update_count
        assert a_opt._index_update_count["a"] == 5
        assert b_opt._index_update_count["b"] == 1
        assert srv._global_num_update == 5
        # the reference's Adam on the same pushes, on the host
        import mxnet_tpu as mx
        opt = mx.optimizer.Adam(learning_rate=0.01)
        w = mx.nd.array(onp.ones((3,), onp.float32))
        st = opt.create_state_multi_precision("a", w)
        for _ in range(5):
            opt.update_multi_precision("a", w, mx.nd.array(
                onp.full((3,), 0.5, onp.float32)), st)
        onp.testing.assert_allclose(c.pull("a"), w.asnumpy(), rtol=1e-6)
        # a row-sparse push takes the lazy update server-side
        c.set_optimizer(mt.optimizer.SGD(learning_rate=0.5))
        c.init("s", onp.zeros((6, 3), onp.float32))
        c.push_sparse("s", onp.array([1, 4, 1]),
                      onp.ones((3, 3), onp.float32), (6, 3))
        got = c.pull("s")
        assert got[1].tolist() == [-1.0] * 3 and got[4].tolist() == \
            [-0.5] * 3 and got[[0, 2, 3, 5]].sum() == 0
        c.close()
    finally:
        srv.stop()


def test_hmac_mismatch_fails_fast_and_a_wrong_key_is_refused(monkeypatch):
    monkeypatch.setenv("MXNET_PS_HMAC_KEY", "secret-xyz")
    keyed = P.ParamServer("127.0.0.1", 0)
    monkeypatch.delenv("MXNET_PS_HMAC_KEY")
    keyless = P.PSClient(keyed.address, timeout=30.0)
    t0 = time.monotonic()
    with pytest.raises(MXNetError):
        keyless.pull("w")
    assert time.monotonic() - t0 < 15
    keyless.close()
    # a signed port client against the signed reference server, and a
    # wrong key dropped before parsing
    monkeypatch.setenv("MXNET_PS_HMAC_KEY", "secret1")
    ref = R.ParamServer("127.0.0.1", 0)
    good = P.PSClient(ref.address)
    good.init("w", onp.ones((2,), onp.float32))
    onp.testing.assert_array_equal(good.pull("w"), 1.0)
    monkeypatch.setenv("MXNET_PS_HMAC_KEY", "wrongkey")
    bad = P.PSClient(ref.address)
    with pytest.raises(MXNetError):
        bad.pull("w")
    bad.close()
    onp.testing.assert_array_equal(good.pull("w"), 1.0)
    good.close()
    ref.stop()
    keyed.stop()


def test_liveness_counts_connected_ranks():
    srv = P.ParamServer("127.0.0.1", 0)
    try:
        a = P.PSClient(srv.address)
        a.hello(0)
        ghost = R.PSClient(srv.address)
        ghost.hello(7)
        for _ in range(50):
            if a.num_alive() == 2:
                break
            time.sleep(0.05)
        assert a.alive_ranks() == [0, 7]
        ghost.close()
        for _ in range(50):
            if a.num_alive() == 1:
                break
            time.sleep(0.05)
        assert a.alive_ranks() == [0]
        a.close()
    finally:
        srv.stop()


# -- uncoordinated dist_async over two gloo ranks -----------------------------

@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = cases.RankPool(2, tmp_path_factory.mktemp("ps_ranks"))
    yield p
    p.close()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_uncoordinated_dist_async_with_unequal_push_counts(pool):
    """Rank 0 pushes three gradients, rank 1 one: no rendezvous, every
    push applied on arrival by the server's SGD; both ranks then read the
    same weight, which is the reference's SGD applied to the four pushes.
    A rank that closes its connection counts as dead."""
    import mxnet_tpu as mx
    w0 = onp.arange(6, dtype=onp.float32).reshape(2, 3)
    grads = {0: [onp.full((2, 3), 0.25 * (i + 1), onp.float32)
                 for i in range(3)],
             1: [onp.full((2, 3), -0.5, onp.float32)]}
    rsp = (onp.array([1, 4]), onp.ones((2, 3), onp.float32))
    addr = f"127.0.0.1:{_free_port()}"
    got = pool.run("case_uncoordinated_async", addr, w0, grads, rsp)
    opt = mx.optimizer.SGD(learning_rate=0.1)
    w = mx.nd.array(w0)
    st = opt.create_state_multi_precision("0", w)
    for g in grads[0] + grads[1]:
        opt.update_multi_precision("0", w, mx.nd.array(g), st)
    for r in got:
        # pushes apply in arrival order: the sum may round a ulp apart
        onp.testing.assert_allclose(r["weight"], w.asnumpy(), rtol=1e-6,
                                    atol=1e-7)
        assert r["dead_before"] == 0
    assert got[0]["counts"] == 4
    assert got[0]["dead_after"] == 1
    want = onp.zeros((6, 3), onp.float32)
    want[[1, 4]] = -0.2                     # two ranks' rows, lr 0.1
    for r in got:
        onp.testing.assert_allclose(r["sparse"], want, rtol=1e-6)
        onp.testing.assert_allclose(r["rows"], want[[4]], rtol=1e-6)
