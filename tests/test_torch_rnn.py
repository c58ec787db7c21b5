"""The fused RNN op and the Gluon recurrent layers against the reference
on the CPU, and the word-level LSTM LM.

Every input comes from a seeded numpy generator; both packages see the
same arrays (the reference's layers are initialised, and their
parameters carried into the port's by name).  Tolerances are fp32 1e-5
(``test_torch_parity.close``: ``|got − ref| ≤ 1e-5·(|ref| + max|ref|)``)
for outputs, states and gradients.  Dropout masks come from each
package's own generator, so they are compared by their statistics.

The op's torch call (``ops.rnn.rnn``, cuDNN's RNN on the card) is also
held against its plain step loop (``ops.rnn.rnn_plain``) in every mode,
and each case of the reference's ``tests/test_rnn_op.py`` and
``tests/test_bucketing.py`` runs through both packages here."""
import numpy as onp
import pytest
import torch

import jax
import mxnet_tpu as mx
from mxnet_tpu.gluon import rnn as ref_rnn
from mxnet_tpu.ndarray import NDArray as RefND
from mxnet_tpu.ops.registry import get as ref_get
from mxnet_tpu.ops.registry import invoke as ref_invoke

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import rnn as prnn
from mxnet_tpu_torch.ops import rnn as rnn_ops
from mxnet_tpu_torch.ops.registry import invoke as port_invoke

from test_torch_parity import assert_parity_jit, close

TOL = {"forward": 1e-5, "grad": 1e-5}
T, N, I, H = 5, 3, 4, 6


def _rng(seed):
    return onp.random.RandomState(seed)


def _op_arrays(mode, bidir, layers, proj=None, seed=0):
    rng = _rng(seed)
    D = 2 if bidir else 1
    P = proj or H
    n = rnn_ops.rnn_param_size(mode, I, H, layers, bidir, proj)
    arrays = [rng.randn(T, N, I).astype("f4"),
              rng.uniform(-0.4, 0.4, n).astype("f4"),
              (0.1 * rng.randn(layers * D, N, P)).astype("f4")]
    if mode == "lstm":
        arrays.append((0.1 * rng.randn(layers * D, N, H)).astype("f4"))
    return arrays


def _params(mode, bidir, layers, proj=None, **extra):
    return dict(state_size=H, num_layers=layers, mode=mode,
                bidirectional=bidir, state_outputs=True,
                projection_size=proj, **extra)


CASES = [("lstm", False, 1, None), ("lstm", True, 2, None),
         ("gru", False, 2, None), ("gru", True, 1, None),
         ("rnn_tanh", False, 1, None), ("rnn_relu", True, 1, None),
         ("lstm", True, 2, 2)]


@pytest.mark.parametrize("mode,bidir,layers,proj", CASES)
def test_rnn_op_matches_the_reference(mode, bidir, layers, proj):
    """Outputs, final states and the gradients with respect to data,
    the flat vector and the states."""
    kw = _params(mode, bidir, layers, proj)
    ref_fn = ref_get("RNN").fn
    assert_parity_jit(lambda *a: ref_fn(*a, **kw),
                      lambda *a: rnn_ops.rnn(*a, **kw),
                      _op_arrays(mode, bidir, layers, proj), tol=TOL)


@pytest.mark.parametrize("mode,bidir", [("lstm", True), ("gru", False),
                                        ("rnn_relu", True)])
def test_rnn_op_sequence_length_matches_the_reference(mode, bidir):
    """Ragged rows (one of length 0): zero outputs and held states past
    each row's length, the backward direction from its last valid
    step; gradients included."""
    kw = _params(mode, bidir, 2, use_sequence_length=True)
    arrays = _op_arrays(mode, bidir, 2, seed=1) + \
        [onp.array([4, 0, 5], "int32")]
    ref_fn = ref_get("RNN").fn
    assert_parity_jit(lambda *a: ref_fn(*a, **kw),
                      lambda *a: rnn_ops.rnn(*a, **kw), arrays, tol=TOL)


def _both_forms(mode, bidir, layers, proj=None, lengths=None, seed=2,
                **extra):
    arrays = _op_arrays(mode, bidir, layers, proj, seed=seed)
    kw = _params(mode, bidir, layers, proj, **extra)
    if lengths is not None:
        arrays.append(onp.array(lengths, "int64"))
        kw["use_sequence_length"] = True
    outs = []
    for fn in (rnn_ops.rnn, rnn_ops.rnn_plain):
        ts = [torch.from_numpy(a.copy()) for a in arrays]
        for t in ts[:4]:
            if t.is_floating_point():
                t.requires_grad_(True)
        res = fn(*ts, **kw)
        ct = [torch.from_numpy(_rng(9).randn(*r.shape).astype("f4"))
              for r in res]
        diff = [t for t in ts if t.requires_grad]
        grads = torch.autograd.grad(
            sum((r * c).sum() for r, c in zip(res, ct)), diff)
        outs.append([r.detach() for r in res] + list(grads))
    return outs


@pytest.mark.parametrize("mode,bidir,layers,proj,lengths", [
    ("lstm", False, 2, None, None), ("lstm", True, 2, None, [5, 2, 0]),
    ("lstm", True, 2, 3, [1, 5, 3]), ("gru", True, 2, None, None),
    ("gru", False, 1, None, [3, 3, 5]), ("rnn_tanh", True, 2, None, None),
    ("rnn_relu", False, 2, None, [2, 5, 4])])
def test_torch_call_matches_the_plain_loop(mode, bidir, layers, proj,
                                           lengths):
    """``rnn`` (one torch RNN call; packed rows for ragged lengths)
    against ``rnn_plain`` (the reference's step loop): outputs, states
    and every gradient."""
    fused, plain = _both_forms(mode, bidir, layers, proj, lengths)
    for i, (a, b) in enumerate(zip(fused, plain)):
        close(a, b, 1e-5, f"tensor {i}")


def test_state_clip_matches_the_reference():
    kw = _params("lstm", True, 2, lstm_state_clip_min=-0.05,
                 lstm_state_clip_max=0.05)
    ref_fn = ref_get("RNN").fn
    ref, got = assert_parity_jit(lambda *a: ref_fn(*a, **kw),
                                 lambda *a: rnn_ops.rnn(*a, **kw),
                                 _op_arrays("lstm", True, 2, seed=3),
                                 tol=TOL)
    assert onp.abs(got[2]).max() <= 0.05 + 1e-7
    fused, plain = _both_forms("lstm", True, 2, seed=3,
                               lstm_state_clip_min=-0.05,
                               lstm_state_clip_max=0.05)
    for i, (a, b) in enumerate(zip(fused, plain)):
        close(a, b, 1e-5, f"tensor {i}")


def _stacked_relu(p):
    """Two rnn_relu layers with identity input weights and no recurrence:
    the second layer's output is the first's after the op's dropout."""
    F_ = 64
    flat = onp.concatenate([onp.eye(F_, dtype="f4").ravel(),
                            onp.zeros(F_ * F_, "f4"),
                            onp.eye(F_, dtype="f4").ravel(),
                            onp.zeros(F_ * F_, "f4"),
                            onp.zeros(4 * F_, "f4")])
    x = _rng(4).uniform(0.5, 1.5, (8, 16, F_)).astype("f4")
    h0 = onp.zeros((2, 16, F_), "f4")
    kw = dict(state_size=F_, num_layers=2, mode="rnn_relu", p=p)
    return x, flat, h0, kw


def _dropped(x, out, p):
    """Zero share of ``out`` and the survivors' error against x/(1-p)."""
    zero = out == 0
    err = onp.abs(out[~zero] - x[~zero] / (1 - p)).max()
    return float(zero.mean()), float(err)


def test_op_dropout_statistics_match_the_reference():
    """The op's inter-layer dropout: the share dropped within 5σ of p in
    both packages, the kept values scaled by 1/(1-p)."""
    p = 0.3
    x, flat, h0, kw = _stacked_relu(p)
    ref = ref_invoke("RNN", [RefND(x), RefND(flat), RefND(h0)], **kw)
    ref = (ref[0] if isinstance(ref, list) else ref).asnumpy()
    mt.random.seed(5)
    got = rnn_ops.rnn(*[torch.from_numpy(a) for a in (x, flat, h0)],
                      **kw)[0].numpy()
    sigma = (p * (1 - p) / x.size) ** 0.5
    for out in (ref, got):
        share, err = _dropped(x, out, p)
        assert abs(share - p) < 5 * sigma, share
        assert err < 1e-5
    # the same generator state draws the same masks in both forms
    mt.random.seed(5)
    plain = rnn_ops.rnn_plain(*[torch.from_numpy(a) for a in (x, flat, h0)],
                              **kw)[0].numpy()
    onp.testing.assert_array_equal(plain == 0, got == 0)


def test_rnn_dropout_key_deterministic():
    """Counterpart of the reference's keyed-dropout case: the same
    ``mx.random`` seed draws the same masks, another seed others; a key
    input (the reference's) is refused."""
    rng = _rng(5)
    L = 2
    x = rng.randn(4, 2, 3).astype("f4")
    flat = (rng.randn(rnn_ops.rnn_param_size("rnn_tanh", 3, 5, L)) *
            0.1).astype("f4")
    h0 = onp.zeros((L, 2, 5), "f4")
    kw = dict(state_size=5, num_layers=L, mode="rnn_tanh", p=0.5)
    args = [mt.nd.array(a, ctx=mt.cpu()) for a in (x, flat, h0)]

    def run(seed):
        mt.random.seed(seed)
        out = port_invoke("RNN", args, **kw)
        return (out[0] if isinstance(out, list) else out).asnumpy()

    a, b, c = run(0), run(0), run(1)
    onp.testing.assert_allclose(a, b)
    assert abs(a - c).max() > 1e-6
    with pytest.raises(MXNetError, match="no dropout key"):
        rnn_ops.rnn(*[torch.from_numpy(v) for v in (x, flat, h0)],
                    torch.zeros(2), **kw)
    ref = ref_invoke("RNN", [RefND(x), RefND(flat), RefND(h0),
                             RefND(jax.random.PRNGKey(0))], **kw)
    assert (ref[0] if isinstance(ref, list) else ref).shape == a.shape


# -- the reference's tests/test_rnn_op.py, through both packages --------------

def _ref_layer(mode, layers, bidir, **kw):
    if mode in ("rnn_tanh", "rnn_relu"):
        return ref_rnn.RNN(H, num_layers=layers, bidirectional=bidir,
                           activation=mode[4:], **kw)
    cls = {"lstm": ref_rnn.LSTM, "gru": ref_rnn.GRU}[mode]
    return cls(H, num_layers=layers, bidirectional=bidir, **kw)


def _port_layer(mode, layers, bidir, **kw):
    if mode in ("rnn_tanh", "rnn_relu"):
        return prnn.RNN(H, num_layers=layers, bidirectional=bidir,
                        activation=mode[4:], **kw)
    cls = {"lstm": prnn.LSTM, "gru": prnn.GRU}[mode]
    return cls(H, num_layers=layers, bidirectional=bidir, **kw)


def _ref_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _carried(mode, layers, bidir, seed=0, **kw):
    """(reference layer, port layer with its weights) after a Xavier init
    of the reference's from a seeded ``mx.random``."""
    mx.random.seed(seed)
    ref = _ref_layer(mode, layers, bidir, input_size=I, **kw)
    ref.initialize(init=mx.initializer.Xavier())
    port = _port_layer(mode, layers, bidir, input_size=I, **kw)
    port.initialize(device="cpu")
    convert.load_collected_params(port, _ref_params(ref), device="cpu")
    return ref, port


def _flat_params(block, layers, ndir):
    """The op's flat vector from a layer's parameters (weights, then
    biases), as ``tests/test_rnn_op.py`` packs it."""
    chunks = []
    for kinds in (("i2h_weight", "h2h_weight"), ("i2h_bias", "h2h_bias")):
        for layer in range(layers):
            for prefix in ["l", "r"][:ndir]:
                for k in kinds:
                    p = getattr(block, f"{prefix}{layer}_{k}")
                    chunks.append(p.data().asnumpy().reshape(-1))
    return onp.concatenate(chunks)


@pytest.mark.parametrize("mode,bidir,layers", [
    ("lstm", False, 1), ("lstm", True, 2), ("gru", False, 2),
    ("gru", True, 1), ("rnn_tanh", False, 1), ("rnn_relu", True, 1)])
def test_rnn_op_matches_gluon_layer(mode, bidir, layers):
    ndir = 2 if bidir else 1
    ref_net, port_net = _carried(mode, layers, bidir)
    ref_net.hybridize()    # a forward only: one compile of it
    x = _rng(7).randn(T, N, I).astype("f4")
    ref_out, _ = ref_net(RefND(x), ref_net.begin_state(batch_size=N))
    with mt.cpu():
        states = port_net.begin_state(batch_size=N)
    port_out, _ = port_net(mt.nd.array(x, ctx=mt.cpu()), states)
    close(port_out.asnumpy(), ref_out.asnumpy(), 1e-5, "layer")
    flat = _flat_params(port_net, layers, ndir)
    assert flat.size == rnn_ops.rnn_param_size(mode, I, H, layers, bidir)
    h0 = onp.zeros((layers * ndir, N, H), "f4")
    inputs = [x, flat, h0] + ([h0.copy()] if mode == "lstm" else [])
    outs = port_invoke("RNN", [mt.nd.array(a, ctx=mt.cpu()) for a in inputs],
                       state_size=H, num_layers=layers, mode=mode,
                       bidirectional=bidir, state_outputs=True)
    close(outs[0].asnumpy(), ref_out.asnumpy(), 1e-5, "op")


def _port_op(arrays, **kw):
    outs = port_invoke("RNN", [mt.nd.array(a, ctx=mt.cpu()) for a in arrays],
                       **kw)
    return [o.asnumpy() for o in outs]


def _ref_op(arrays, **kw):
    return [o.asnumpy() for o in ref_invoke("RNN", [RefND(a) for a in arrays],
                                            **kw)]


def test_rnn_sequence_length_masks_tail():
    _, port_net = _carried("lstm", 1, False, seed=1)
    flat = _flat_params(port_net, 1, 1)
    x = _rng(8).randn(6, 2, I).astype("f4")
    h0 = onp.zeros((1, 2, H), "f4")
    lengths = onp.array([4, 6], "float32")
    kw = dict(state_size=H, num_layers=1, mode="lstm", state_outputs=True)
    for run in (_port_op, _ref_op):
        outs = run([x, flat, h0, h0.copy(), lengths],
                   use_sequence_length=True, **kw)
        onp.testing.assert_allclose(outs[0][4:, 0], 0.0)
        assert onp.abs(outs[0][4:, 1]).max() > 0
        trunc = run([x[:4, :1], flat, h0[:, :1], h0[:, :1].copy()], **kw)
        close(outs[1][:, 0], trunc[1][:, 0], 1e-5, "state")
    close(_port_op([x, flat, h0, h0.copy(), lengths],
                   use_sequence_length=True, **kw)[0],
          _ref_op([x, flat, h0, h0.copy(), lengths],
                  use_sequence_length=True, **kw)[0], 1e-5, "out")


def test_rnn_bidirectional_reversed_sequence_semantics():
    """The backward direction starts at each row's last valid step: row
    0 (length 3) equals the op run on its 3-step prefix alone."""
    _, port_net = _carried("gru", 1, True, seed=2)
    flat = _flat_params(port_net, 1, 2)
    x = _rng(9).randn(5, 2, I).astype("f4")
    h0 = onp.zeros((2, 2, H), "f4")
    lengths = onp.array([3, 5], "float32")
    kw = dict(state_size=H, num_layers=1, mode="gru", bidirectional=True,
              state_outputs=True)
    for run in (_port_op, _ref_op):
        out = run([x, flat, h0, lengths], use_sequence_length=True, **kw)
        onp.testing.assert_allclose(out[0][3:, 0], 0.0)
        prefix = run([x[:3, :1], flat, h0[:, :1]], **kw)
        close(out[0][:3, 0], prefix[0][:, 0], 1e-5, "prefix")
        close(out[1][:, 0], prefix[1][:, 0], 1e-5, "states")


def test_rnn_bucketing_variable_lengths():
    """One op call a bucket of padded rows gives each row the final state
    of running it alone (the reference's BucketingModule workflow)."""
    _, port_net = _carried("gru", 1, False, seed=3)
    flat = _flat_params(port_net, 1, 1)
    rng = _rng(10)
    seqs = [rng.randn(t, I).astype("f4") for t in (2, 3, 5, 5)]
    kw = dict(state_size=H, num_layers=1, mode="gru", state_outputs=True)
    for run in (_port_op, _ref_op):
        for bucket_len, members in ((3, seqs[:2]), (5, seqs[2:])):
            x = onp.zeros((bucket_len, len(members), I), "f4")
            lengths = onp.zeros((len(members),), "f4")
            for j, s in enumerate(members):
                x[:s.shape[0], j] = s
                lengths[j] = s.shape[0]
            h0 = onp.zeros((1, len(members), H), "f4")
            outs = run([x, flat, h0, lengths], use_sequence_length=True,
                       **kw)
            for j, s in enumerate(members):
                alone = run([s[:, None], flat, h0[:, :1]], **kw)
                close(outs[1][0, j], alone[1][0, 0], 1e-5, "final state")


def test_lstm_projection():
    """LSTMP against the reference and an explicit numpy loop."""
    P = 2
    rng = _rng(0)
    n = rnn_ops.rnn_param_size("lstm", I, H, 1, projection_size=P)
    params = rng.uniform(-0.4, 0.4, n).astype("f4")
    x = rng.randn(T, N, I).astype("f4")
    h0 = onp.zeros((1, N, P), "f4")
    c0 = onp.zeros((1, N, H), "f4")
    kw = dict(state_size=H, num_layers=1, mode="lstm", state_outputs=True,
              projection_size=P)
    out, hT, cT = [t.numpy() for t in rnn_ops.rnn(
        *[torch.from_numpy(a) for a in (x, params, h0, c0)], **kw)]
    assert out.shape == (T, N, P) and hT.shape == (1, N, P)
    assert cT.shape == (1, N, H)
    off = 0
    W = params[off:off + 4 * H * I].reshape(4 * H, I)
    off += 4 * H * I
    R = params[off:off + 4 * H * P].reshape(4 * H, P)
    off += 4 * H * P
    Wp = params[off:off + P * H].reshape(P, H)
    off += P * H
    bW, bR = params[off:off + 4 * H], params[off + 4 * H:off + 8 * H]

    def sig(v):
        return 1 / (1 + onp.exp(-v))
    h, c, outs = onp.zeros((N, P)), onp.zeros((N, H)), []
    for t in range(T):
        i, f, g, o = onp.split(x[t] @ W.T + bW + h @ R.T + bR, 4, axis=-1)
        c = sig(f) * c + sig(i) * onp.tanh(g)
        h = (sig(o) * onp.tanh(c)) @ Wp.T
        outs.append(h)
    onp.testing.assert_allclose(out, onp.stack(outs), rtol=1e-5, atol=1e-5)
    ref = ref_get("RNN").fn(x, params, h0, c0, **kw)
    for a, b in zip((out, hT, cT), ref):
        close(a, onp.asarray(b), 1e-5, "reference")


def test_lstm_projection_rejects_other_modes():
    with pytest.raises(ValueError, match="LSTM-only"):
        rnn_ops.rnn(torch.zeros(2, 1, 3), torch.zeros(10),
                    torch.zeros(1, 1, 4), state_size=4, num_layers=1,
                    mode="gru", projection_size=2)
    with pytest.raises(MXNetError, match="LSTM-only"):
        prnn.GRU(4, projection_size=2)


# -- the Gluon layers, forward and backward -----------------------------------

def _layer_grads(pkg, net, x, states, cts):
    """(out, new states, dx, dstates, parameter gradients) of
    ``Σ ct·(out, states)`` through ``pkg``'s autograd."""
    if pkg is mx:
        xs = RefND(x)
        sts = [RefND(s) for s in states]
    else:
        xs = mt.nd.array(x, ctx=mt.cpu())
        sts = [mt.nd.array(s, ctx=mt.cpu()) for s in states]
    for a in [xs] + sts:
        a.attach_grad()
    with pkg.autograd.record():
        out, new = net(xs, sts)
        loss = (out * cts[0]).sum()
        for s, c in zip(new, cts[1:]):
            loss = loss + (s * c).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in net.collect_params().items()}
    return ([out.asnumpy()] + [s.asnumpy() for s in new],
            [xs.grad.asnumpy()] + [s.grad.asnumpy() for s in sts], grads)


@pytest.mark.parametrize("mode,layers,bidir,layout,proj", [
    ("lstm", 2, True, "TNC", None), ("lstm", 2, False, "NTC", 3),
    ("gru", 2, True, "NTC", None), ("rnn_relu", 1, False, "TNC", None),
    ("rnn_tanh", 2, True, "TNC", None)])
def test_gluon_layer_matches_the_reference(mode, layers, bidir, layout,
                                           proj):
    kw = dict(layout=layout)
    if proj:
        kw["projection_size"] = proj
    ref_net, port_net = _carried(mode, layers, bidir, seed=4, **kw)
    rng = _rng(11)
    shape = (T, N, I) if layout == "TNC" else (N, T, I)
    x = rng.randn(*shape).astype("f4")
    infos = ref_net.state_info(N)
    assert [i["shape"] for i in infos] == \
        [i["shape"] for i in port_net.state_info(N)]
    states = [(0.1 * rng.randn(*i["shape"])).astype("f4") for i in infos]
    D = 2 if bidir else 1
    out_shape = shape[:2] + (D * (proj or H),)
    cts = [rng.randn(*out_shape).astype("f4")] + \
        [rng.randn(*i["shape"]).astype("f4") for i in infos]
    ref = _layer_grads(mx, ref_net, x, states, [RefND(c) for c in cts])
    got = _layer_grads(mt, port_net, x, states,
                       [mt.nd.array(c, ctx=mt.cpu()) for c in cts])
    for what, r, g in zip(("outputs", "input grads"), ref[:2], got[:2]):
        for i, (a, b) in enumerate(zip(g, r)):
            close(a, b, 1e-5, f"{what} {i}")
    assert list(got[2]) == list(ref[2])
    for k in ref[2]:
        close(got[2][k], ref[2][k], 1e-5, k)


def test_gluon_layer_without_states_and_deferred_input():
    """``forward(x)`` alone returns the output only; the input size is
    deferred to the first call; ``begin_state`` follows the parameters'
    device."""
    net = prnn.GRU(H, num_layers=2)
    net.initialize(device="cpu")
    x = torch.from_numpy(_rng(12).randn(T, N, I).astype("f4"))
    out = net(x)
    assert out.shape == (T, N, H)
    assert net.l0_i2h_weight.shape == (3 * H, I)
    st = net.begin_state(batch_size=N)
    assert st[0].shape == (2, N, H) and st[0].context.device_type == "cpu"
    out2, new = net(x, [s._data for s in st])
    close(out2, out, 0.0, "zero states")
    assert repr(net) == "GRU(6, num_layers=2, bidirectional=False)"


def test_gluon_dropout_only_in_training():
    """Inter-layer dropout of a layer: none in inference; in training the
    share dropped on the second layer's input is near the rate."""
    net = prnn.RNN(64, num_layers=2, activation="relu", dropout=0.5,
                   input_size=64)
    net.initialize(device="cpu")
    with torch.no_grad():
        net.l0_i2h_weight._data.copy_(torch.eye(64))
        net.l1_i2h_weight._data.copy_(torch.eye(64))
        for p in (net.l0_h2h_weight, net.l1_h2h_weight):
            p._data.zero_()
    x = torch.from_numpy(_rng(13).uniform(0.5, 1.5, (8, 16, 64))
                         .astype("f4"))
    close(net(x), x, 1e-6, "inference")
    mt.random.seed(3)
    with mt.autograd.train_mode():
        out = net(x).detach().numpy()
    share, err = _dropped(x.numpy(), out, 0.5)
    assert abs(share - 0.5) < 5 * (0.25 / out.size) ** 0.5 and err < 1e-5


# -- the reference's tests/test_bucketing.py, through both packages -----------

def _samplers(*args, **kw):
    from mxnet_tpu.gluon.data import BucketSampler as RefSampler
    from mxnet_tpu_torch.gluon.data import BucketSampler
    return RefSampler(*args, **kw), BucketSampler(*args, **kw)


def test_bucket_sampler_grouping():
    lengths = [3, 5, 9, 2, 7, 4, 8, 1, 6, 10]
    for bs in _samplers(lengths, batch_size=2, bucket_keys=[4, 8, 12],
                        shuffle=False):
        assert bs.bucket_keys == [4, 8, 12]
        batches = list(bs)
        assert sum(len(b) for b in batches) == 10
        for batch in batches:
            assert len({bs.bucket_of(i) for i in batch}) == 1
            k = bs.bucket_of(batch[0])
            assert all(lengths[i] <= k for i in batch)
    ref, port = _samplers(lengths, batch_size=2, bucket_keys=[4, 8, 12],
                          shuffle=False)
    assert [list(b) for b in port] == [list(b) for b in ref]


def test_bucket_sampler_drops_overlong():
    for bs in _samplers([2, 3, 50], batch_size=1, bucket_keys=[4],
                        shuffle=False):
        assert sorted(i for b in bs for i in b) == [0, 1]


def test_bucket_sampler_quantile_keys():
    lengths = _rng(0).randint(1, 40, size=100)
    ref, port = _samplers(lengths, batch_size=8, num_buckets=4)
    for bs in (ref, port):
        assert 1 <= len(bs.bucket_keys) <= 4
        assert max(bs.bucket_keys) >= lengths.max()
        assert sum(len(b) for b in bs) == 100
    assert list(port.bucket_keys) == list(ref.bucket_keys)


def test_variable_length_training_one_compile_per_bucket():
    """Bucketed training of Embedding → LSTM → Dense: one padded shape a
    bucket, the loss falls, and the port's whole-step capture keeps one
    step structure a bucket shape (the reference's one compile a
    bucket)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.data import DataLoader, SimpleDataset
    from mxnet_tpu_torch.imperative import cached_step
    rng = _rng(0)
    V, HID, NS = 12, 16, 40
    lengths = rng.randint(2, 11, size=NS)
    seqs = [rng.randint(1, V, size=n) for n in lengths]
    _, sampler = _samplers(lengths, batch_size=4, bucket_keys=[5, 10],
                           shuffle=True, last_batch="discard", seed=1)

    def batchify(items):
        idxs = [i for i, _ in items]
        k = sampler.bucket_of(idxs[0])
        x = onp.zeros((len(items), k), "int32")
        for r, (_, a) in enumerate(items):
            x[r, :len(a)] = a
        return mt.nd.array(x, ctx=mt.cpu(), dtype="int32")

    ds = SimpleDataset([(i, seqs[i]) for i in range(NS)])
    mt.random.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Embedding(V, 8), prnn.LSTM(HID), nn.Dense(V, flatten=False))
    net.initialize(init=mt.initializer.Xavier(), device="cpu")
    net.hybridize()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.01})
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    dl = DataLoader(ds, batch_sampler=sampler, batchify_fn=batchify)
    shapes, losses = set(), []
    for _ in range(3):
        for batch in dl:
            shapes.add(batch.shape)
            with mt.autograd.record():
                out = net(batch)
                loss = loss_fn(out[:, :-1], batch[:, 1:])
            loss.backward()
            trainer.step(batch.shape[0])
            losses.append(float(loss.asnumpy().mean()))
    assert shapes == {(4, 5), (4, 10)}
    state = cached_step.trainer_state(trainer)
    assert state["captures"] == 2, state
    assert onp.mean(losses[-4:]) < onp.mean(losses[:4])


# -- the word-level LM (examples/gluon/word_language_model.py) ----------------

def _ref_example():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "examples", "gluon",
                        "word_language_model.py")
    spec = importlib.util.spec_from_file_location("_ref_wlm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lm_three_steps_match_the_reference(monkeypatch):
    """The example's model (16 wide, 2 layers, vocab 96, tied, dropout
    0) and loop (batch 20, bptt 24, SGD lr 20, clip 2.0, truncated BPTT)
    for 3 steps: the port's losses and clip norms equal the reference's
    step by step, and its weights after the steps too."""
    import chip_smoke
    ex = _ref_example()
    hid, batch, bptt, steps = 16, 20, 24, 3
    data = ex.batchify(ex.synth_corpus(n_tokens=batch * (steps * bptt + 2)),
                       batch)
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")     # the reference's loop
    mx.random.seed(0)
    ref = ex.RNNModel(ex.VOCAB, embed=hid, hidden=hid, layers=2, dropout=0.0)
    ref.initialize(init=mx.initializer.Xavier())
    ref(RefND(onp.zeros((bptt, batch), "float32")))
    monkeypatch.delenv("MXNET_CACHED_STEP")
    with mt.cpu():
        port = chip_smoke.rnn_lm(ex.VOCAB, embed=hid, hidden=hid, layers=2,
                                 dropout=0.0)
        port.initialize(device="cpu")
        convert.load_collected_params(port, _ref_params(ref), device="cpu")
    ref_tr = mx.gluon.Trainer(ref.collect_params(), "sgd",
                              {"learning_rate": 20.0})
    port_tr = mt.gluon.Trainer(port.collect_params(), "sgd",
                               {"learning_rate": 20.0})
    ref_loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    port_loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    monkeypatch.setenv("MXNET_CACHED_STEP", "0")
    ref_states, port_states = None, None
    for i, t in enumerate(range(0, steps * bptt, bptt)):
        x, y = data[t:t + bptt], data[t + 1:t + 1 + bptt]
        ref_states = ex.detach(ref_states)
        with mx.autograd.record():
            logits, ref_states = ref(RefND(x.astype("float32")), ref_states)
            loss = ref_loss_fn(logits, RefND(y.astype("float32")))
        loss.backward()
        ref_norm = mx.gluon.utils.clip_global_norm(
            [p.grad() for p in ref.collect_params().values()
             if p.grad_req != "null"], 2.0)
        ref_tr.step(batch)
        with mt.cpu():
            port_loss, port_states, port_norm = chip_smoke.rnn_lm_step(
                mt, port, port_loss_fn, port_tr,
                mt.nd.array(x, dtype="int32"), mt.nd.array(y),
                port_states, batch, 2.0)
        close(port_loss.asnumpy(), loss.asnumpy(), 1e-5, f"loss {i}")
        assert abs(port_norm - float(ref_norm)) <= 1e-5 * float(ref_norm)
    for k, v in _ref_params(ref).items():
        close(port.collect_params()[k].data().asnumpy(), v, 1e-5, k)


def test_symbol_and_nd_surfaces():
    """``mx.nd.RNN`` / ``mx.nd.rnn`` and ``mx.nd.CTCLoss`` /
    ``mx.nd.ctc_loss`` come from the registry, and ``mx.sym.RNN``'s
    outputs (indexed) evaluate to the op's."""
    rng = _rng(30)
    n = rnn_ops.rnn_param_size("lstm", 3, 4, 1)
    x = mt.nd.array(rng.randn(5, 2, 3), ctx=mt.cpu())
    par = mt.nd.array(rng.randn(n) * 0.1, ctx=mt.cpu())
    h = mt.nd.zeros((1, 2, 4), ctx=mt.cpu())
    kw = dict(state_size=4, num_layers=1, mode="lstm", state_outputs=True)
    want = mt.nd.RNN(x, par, h, h, **kw)
    assert mt.nd.rnn is not None and len(want) == 3
    s = mt.sym.RNN(*[mt.sym.Variable(k) for k in ("data", "par", "h", "c")],
                   **kw)
    for i in range(3):
        got = s[i].eval(ctx=mt.cpu(), data=x, par=par, h=h, c=h)[0]
        close(got.asnumpy(), want[i].asnumpy(), 0.0, f"output {i}")
    data = mt.nd.array(rng.randn(6, 2, 5), ctx=mt.cpu())
    lab = mt.nd.array([[1, 2], [3, -1]], ctx=mt.cpu())
    close(mt.nd.CTCLoss(data, lab).asnumpy(),
          mt.nd.ctc_loss(data, lab).asnumpy(), 0.0, "ctc")


def test_trace_records_the_rnn_op():
    """A block that calls the ``RNN`` op on a flat parameter traces to a
    symbol with the op's node, which evaluates to the forward."""
    from mxnet_tpu_torch.gluon import HybridBlock, Parameter

    class FlatGRU(HybridBlock):
        def __init__(self):
            super().__init__()
            n = rnn_ops.rnn_param_size("gru", 3, 4, 1)
            self.flat = Parameter(shape=(n,))

        def forward(self, x, h0):
            return rnn_ops.rnn(x, self.flat._tensor(), h0, state_size=4,
                               num_layers=1, mode="gru")[0]

    net = FlatGRU()
    net.initialize(device="cpu")
    x = torch.from_numpy(_rng(31).randn(5, 2, 3).astype("f4"))
    h0 = torch.from_numpy(_rng(32).randn(1, 2, 4).astype("f4"))
    sym, args, _ = mt.sym.trace(net, x, h0)
    assert "RNN" in sym.tojson()
    got = sym.eval(ctx=mt.cpu(), **args,
                   **{k: mt.nd.array(v.numpy(), ctx=mt.cpu())
                      for k, v in (("data0", x), ("data1", h0))})[0]
    close(got.asnumpy(), net(x, h0).detach().numpy(), 0.0, "traced")
