"""``gluon.rnn``'s cells, ``gluon.contrib`` (its RNN cells and layers),
the initializers of ``initializer.py`` and the weight carrier against
the reference on the CPU.

Cells are unrolled in both packages over the same seeded numpy inputs
with the reference's weights carried across by name: outputs, states
and every parameter's gradient agree at fp32 1e-5
(``test_torch_parity.close``).  Random masks (``DropoutCell``,
``ZoneoutCell``, ``VariationalDropoutCell``) come from each package's
own generator and are compared by their statistics.  Initializers are
compared by their statistics and shapes (``Load``, ``Mixed``,
``InitDesc`` and the deterministic ones exactly).  Each case of the
reference's ``tests/test_contrib_rnn.py`` runs through both packages."""
import numpy as onp
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import initializer as rinit
from mxnet_tpu import ndarray as rnd
from mxnet_tpu.gluon import contrib as rcontrib
from mxnet_tpu.gluon import rnn as rrnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import initializer as pinit
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import contrib as pcontrib
from mxnet_tpu_torch.gluon import rnn as prnn

from test_torch_parity import close


def _rng(seed):
    return onp.random.RandomState(seed)


def _ref_params(net):
    return {k: p.data().asnumpy() for k, p in net.collect_params().items()}


def _carry(ref, port, first_input=None):
    """The reference's Xavier weights (deferred dims filled by a first
    call on ``first_input``) carried into ``port`` by name."""
    mx.random.seed(0)
    ref.initialize(init=mx.initializer.Xavier())
    if first_input is not None:
        ref(*first_input)
    port.initialize(device="cpu")
    convert.load_collected_params(port, _ref_params(ref), device="cpu")


def _unrolled(pkg, cell, x, length, layout="NTC", valid_length=None,
              states=None):
    """(outputs, states, parameter gradients) of an unroll, the loss
    ``Σ outputs·ct``."""
    ctx = {} if pkg is mx else {"ctx": mt.cpu()}
    xs = pkg.nd.array(x, **ctx)
    vl = pkg.nd.array(valid_length, **ctx) if valid_length is not None \
        else None
    sts = None if states is None else [pkg.nd.array(s, **ctx)
                                       for s in states]
    with pkg.autograd.record():
        out, st = cell.unroll(length, xs, begin_state=sts, layout=layout,
                              merge_outputs=True, valid_length=vl)
        ct = pkg.nd.array(_rng(99).randn(*out.shape).astype("f4"), **ctx)
        loss = (out * ct).sum()
    loss.backward()
    grads = {k: p.grad().asnumpy() for k, p in cell.collect_params().items()
             if p.grad_req != "null"}
    return out.asnumpy(), [s.asnumpy() for s in st], grads


def _compare(ref, got):
    close(got[0], ref[0], 1e-5, "outputs")
    assert len(got[1]) == len(ref[1])
    for i, (a, b) in enumerate(zip(got[1], ref[1])):
        close(a, b, 1e-5, f"state {i}")
    assert sorted(got[2]) == sorted(ref[2])
    for k in ref[2]:
        close(got[2][k], ref[2][k], 1e-5, k)


def _cell_pair(kind):
    if kind == "rnn_tanh":
        return rrnn.RNNCell(6), prnn.RNNCell(6)
    if kind == "rnn_relu":
        return (rrnn.RNNCell(6, activation="relu"),
                prnn.RNNCell(6, activation="relu"))
    if kind == "lstm":
        return rrnn.LSTMCell(6), prnn.LSTMCell(6)
    if kind == "gru":
        return rrnn.GRUCell(6), prnn.GRUCell(6)
    if kind == "sequential":
        pair = []
        for pkg in (rrnn, prnn):
            seq = pkg.SequentialRNNCell()
            seq.add(pkg.LSTMCell(6))
            seq.add(pkg.ResidualCell(pkg.GRUCell(6)))
            seq.add(pkg.DropoutCell(0.0))
            pair.append(seq)
        return tuple(pair)
    if kind == "lstmp":
        return (rcontrib.LSTMPCell(6, 3), pcontrib.LSTMPCell(6, 3))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["rnn_tanh", "rnn_relu", "lstm", "gru",
                                  "sequential", "lstmp"])
def test_cell_unroll_matches_the_reference(kind):
    ref, port = _cell_pair(kind)
    x = _rng(1).randn(3, 4, 5).astype("f4")           # NTC
    _carry(ref, port, (rnd.array(x[:, 0]), ref.begin_state(3)))
    _compare(_unrolled(mx, ref, x, 4), _unrolled(mt, port, x, 4))


def test_unroll_tnc_valid_length_and_given_states():
    ref, port = _cell_pair("lstm")
    x = _rng(2).randn(4, 3, 5).astype("f4")           # TNC
    _carry(ref, port, (rnd.array(x[0]), ref.begin_state(3)))
    states = [(0.1 * _rng(3).randn(3, 6)).astype("f4") for _ in range(2)]
    vl = onp.array([4, 2, 3], "f4")
    _compare(_unrolled(mx, ref, x, 4, "TNC", vl, states),
             _unrolled(mt, port, x, 4, "TNC", vl, states))


def test_bidirectional_cell_matches_the_reference():
    pair = [pkg.BidirectionalCell(pkg.LSTMCell(6), pkg.GRUCell(6))
            for pkg in (rrnn, prnn)]
    x = _rng(4).randn(3, 5, 4).astype("f4")
    mx.random.seed(0)
    ref_in = rnd.array(x[:, 0])
    pair[0].initialize(init=mx.initializer.Xavier())
    pair[0].l_cell(ref_in, pair[0].l_cell.begin_state(3))
    pair[0].r_cell(ref_in, pair[0].r_cell.begin_state(3))
    pair[1].initialize(device="cpu")
    convert.load_collected_params(pair[1], _ref_params(pair[0]),
                                  device="cpu")
    vl = onp.array([5, 2, 4], "f4")
    _compare(_unrolled(mx, pair[0], x, 5, valid_length=vl),
             _unrolled(mt, pair[1], x, 5, valid_length=vl))
    with pytest.raises(NotImplementedError):
        pair[1](torch.zeros(3, 4), [])


def test_cells_on_tensors_and_begin_state():
    """A cell takes tensors as any Block does; ``begin_state`` follows
    the parameters' device; ``unroll`` without ``merge_outputs`` gives a
    list of steps."""
    cell = prnn.GRUCell(4, input_size=3)
    cell.initialize(device="cpu")
    st = cell.begin_state(2)
    assert st[0].shape == (2, 4) and st[0].context.device_type == "cpu"
    x = torch.from_numpy(_rng(5).randn(2, 6, 3).astype("f4"))
    outs, states = cell.unroll(6, x)
    assert isinstance(outs, list) and len(outs) == 6
    assert outs[0].shape == (2, 4) and isinstance(states[0], torch.Tensor)
    out, _ = cell(x[:, 0], [s._data for s in st])
    close(out, outs[0], 0.0, "first step")
    zs = cell.begin_state(2, func=lambda shape, **kw: mt.nd.ones(
        shape, ctx=mt.cpu()))
    assert float(zs[0].asnumpy().min()) == 1.0


def test_dropout_and_zoneout_cells_by_their_statistics():
    """``DropoutCell`` drops ~rate of its input in training only;
    ``ZoneoutCell`` keeps ~rate of the previous output and states."""
    x = torch.from_numpy(_rng(6).uniform(0.5, 1.5, (64, 64)).astype("f4"))
    drop = prnn.DropoutCell(0.3)
    out, _ = drop(x, [])
    close(out, x, 0.0, "inference")
    mt.random.seed(2)
    with mt.autograd.train_mode():
        out, _ = drop(x, [])
    share = float((out == 0).float().mean())
    assert abs(share - 0.3) < 5 * (0.21 / x.numel()) ** 0.5

    base = prnn.RNNCell(64, activation="relu", input_size=64)
    base.initialize(device="cpu")
    with torch.no_grad():
        base.i2h_weight._data.copy_(torch.eye(64))
        base.h2h_weight._data.zero_()
    zone = prnn.ZoneoutCell(base, zoneout_outputs=0.4, zoneout_states=0.4)
    h = [torch.full((64, 64), 7.0)]
    with mt.autograd.train_mode():
        out, new = zone(x, h)
    assert abs(float((out == 0).float().mean()) - 0.4) < 0.05   # prev 0
    kept = float((new[0] == 7.0).float().mean())
    assert abs(kept - 0.4) < 0.05
    out2, _ = zone(x, h)                       # inference: no zoneout
    close(out2, x, 0.0, "inference")


# -- contrib: the reference's tests/test_contrib_rnn.py through both ----------
# Each case runs the reference test's checks on the port, and the same
# block of the reference (its weights carried into the port's) gives the
# same values: a forward, hybridized so that it compiles once (the
# reference's own file runs its checks on the reference).

def _ref_forward(ref, port, *inputs):
    """The reference's ``ref`` (Xavier, seeded) and the port's ``port``
    with its weights, both called on the numpy ``inputs``: (reference
    outputs, port outputs) as flat numpy lists."""
    mx.random.seed(0)
    ref.initialize(init=mx.initializer.Xavier())
    ref.hybridize()
    r = ref(*[[rnd.array(a) for a in x] if isinstance(x, list)
              else rnd.array(x) for x in inputs])
    port.initialize(device="cpu")
    convert.load_collected_params(port, _ref_params(ref), device="cpu")
    g = port(*[[torch.from_numpy(a) for a in x] if isinstance(x, list)
               else torch.from_numpy(x) for x in inputs])

    def flat(v):
        if isinstance(v, (list, tuple)):
            return [y for u in v for y in flat(u)]
        return [v.asnumpy() if hasattr(v, "asnumpy") else
                v.detach().numpy()]
    return flat(r), flat(g)


def _held(ref, got):
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(got, ref)):
        close(a, b, 1e-5, f"value {i}")


def test_conv2d_lstm_cell():
    cell = pcontrib.Conv2DLSTMCell(input_shape=(3, 8, 8), hidden_channels=4,
                                   i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
    cell.initialize(init=mt.initializer.Xavier(), device="cpu")
    states = cell.begin_state(2)
    assert states[0].shape == (2, 4, 8, 8)
    out, nstates = cell(mt.nd.ones((2, 3, 8, 8), ctx=mt.cpu()), states)
    assert out.shape == (2, 4, 8, 8) and len(nstates) == 2
    kw = dict(input_shape=(3, 8, 8), hidden_channels=4, i2h_kernel=3,
              h2h_kernel=3, i2h_pad=1)
    x = _rng(20).randn(2, 3, 8, 8).astype("f4")
    st = [(0.1 * _rng(21).randn(2, 4, 8, 8)).astype("f4") for _ in range(2)]
    _held(*_ref_forward(rcontrib.Conv2DLSTMCell(**kw),
                        pcontrib.Conv2DLSTMCell(**kw), x, st))


def test_conv1d_rnn_and_gru_cells():
    for name in ("Conv1DRNNCell", "Conv1DGRUCell"):
        kw = dict(input_shape=(2, 10), hidden_channels=3, i2h_kernel=3,
                  h2h_kernel=3, i2h_pad=1)
        cell = getattr(pcontrib, name)(**kw)
        cell.initialize(init=mt.initializer.Xavier(), device="cpu")
        out, states = cell(mt.nd.ones((2, 2, 10), ctx=mt.cpu()),
                           cell.begin_state(2))
        assert out.shape == (2, 3, 10) and len(states) == 1
        x = _rng(22).randn(2, 2, 10).astype("f4")
        h = [(0.1 * _rng(23).randn(2, 3, 10)).astype("f4")]
        _held(*_ref_forward(getattr(rcontrib, name)(**kw),
                            getattr(pcontrib, name)(**kw), x, h))


def test_conv_cell_unroll_and_grad():
    cell = pcontrib.Conv2DRNNCell(input_shape=(1, 4, 4), hidden_channels=2,
                                  i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
    cell.initialize(init=mt.initializer.Xavier(), device="cpu")
    seq_np = _rng(0).randn(2, 3, 1, 4, 4).astype("f4")      # (N, T, C, H, W)
    seq = mt.nd.array(seq_np, ctx=mt.cpu())
    w = cell.i2h_weight.data()
    with mt.autograd.record():
        outs, _ = cell.unroll(3, seq, layout="NTC", merge_outputs=False)
        loss = sum(o.sum() for o in outs)
    loss.backward()
    assert cell.i2h_weight.grad().shape == w.shape
    assert float(abs(cell.i2h_weight.grad()).sum().asnumpy()) > 0
    ref = rcontrib.Conv2DRNNCell(input_shape=(1, 4, 4), hidden_channels=2,
                                 i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
    mx.random.seed(0)
    ref.initialize(init=mx.initializer.Xavier())
    ref.hybridize()
    want, _ = ref.unroll(3, rnd.array(seq_np), layout="NTC",
                         merge_outputs=True)
    convert.load_collected_params(cell, _ref_params(ref), device="cpu")
    got, _ = cell.unroll(3, torch.from_numpy(seq_np), layout="NTC",
                         merge_outputs=True)
    close(got, want.asnumpy(), 1e-5, "unrolled")


def test_conv_cell_odd_kernel_required():
    for contrib, err in ((rcontrib, mx.MXNetError), (pcontrib, MXNetError)):
        with pytest.raises(err):
            contrib.Conv2DRNNCell(input_shape=(1, 4, 4), hidden_channels=2,
                                  i2h_kernel=3, h2h_kernel=2)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_variational_dropout_same_mask_across_steps(pkg):
    contrib, nd, kw = _contrib(pkg)
    rnn = rrnn if pkg == "reference" else prnn
    ag = mx.autograd if pkg == "reference" else mt.autograd
    (mx if pkg == "reference" else mt).random.seed(7)
    base = rnn.RNNCell(6)
    cell = contrib.VariationalDropoutCell(base, drop_outputs=0.5)
    cell.initialize(init=_xavier(pkg), **kw)
    x = nd.ones((2, 4), **_ctx(pkg))
    states = cell.begin_state(2)
    with ag.record():
        o1, states = cell(x, states)
        o2, states = cell(x, states)
    z1, z2 = o1.asnumpy() == 0, o2.asnumpy() == 0
    assert z1.any()
    onp.testing.assert_array_equal(z1, z2)
    cell.reset()
    with ag.record():
        o3, _ = cell(x, cell.begin_state(2))
    assert o3.shape == o1.shape
    o4, _ = contrib.VariationalDropoutCell(base, drop_outputs=0.5)(
        x, base.begin_state(2))
    assert not (o4.asnumpy() == 0).all()


def test_lstmp_cell():
    cell = pcontrib.LSTMPCell(hidden_size=8, projection_size=3)
    cell.initialize(init=mt.initializer.Xavier(), device="cpu")
    states = cell.begin_state(2)
    assert states[0].shape == (2, 3) and states[1].shape == (2, 8)
    out, nstates = cell(mt.nd.ones((2, 5), ctx=mt.cpu()), states)
    assert out.shape == (2, 3)
    assert nstates[0].shape == (2, 3) and nstates[1].shape == (2, 8)
    seq = mt.nd.ones((2, 4, 5), ctx=mt.cpu())
    with mt.autograd.record():
        outs, _ = cell.unroll(4, seq, layout="NTC", merge_outputs=False)
        loss = sum(o.sum() for o in outs)
    loss.backward()
    assert float(abs(cell.h2r_weight.grad()).sum().asnumpy()) > 0
    x = _rng(24).randn(2, 5).astype("f4")
    st = [(0.1 * _rng(25).randn(2, n)).astype("f4") for n in (3, 8)]
    ref = rcontrib.LSTMPCell(hidden_size=8, projection_size=3, input_size=5)
    port = pcontrib.LSTMPCell(hidden_size=8, projection_size=3, input_size=5)
    _held(*_ref_forward(ref, port, x, st))


def test_gluon_lstm_projection():
    T, N, I, H, P = 6, 4, 5, 8, 3
    lstm = prnn.LSTM(H, num_layers=2, projection_size=P)
    lstm.initialize(init=mt.initializer.Xavier(), device="cpu")
    x_np = _rng(0).randn(T, N, I).astype("float32")
    x = mt.nd.array(x_np, ctx=mt.cpu())
    assert lstm(x).shape == (T, N, P)
    states = lstm.begin_state(batch_size=N)
    assert states[0].shape == (2, N, P) and states[1].shape == (2, N, H)
    out, new_states = lstm(x, states)
    assert new_states[0].shape == (2, N, P)
    assert new_states[1].shape == (2, N, H)
    with mt.autograd.record():
        y = lstm(x).sum()
    y.backward()
    assert float(onp.abs(lstm.l0_h2r_weight.grad().asnumpy()).sum()) > 0
    with pytest.raises(MXNetError, match="LSTM-only"):
        prnn.GRU(4, projection_size=2)
    kw = dict(num_layers=2, projection_size=P, input_size=I)
    _held(*_ref_forward(rrnn.LSTM(H, **kw), prnn.LSTM(H, **kw), x_np))


def _contrib(pkg):
    if pkg == "reference":
        return rcontrib, mx.nd, {}
    return pcontrib, mt.nd, {"device": "cpu"}


def _ctx(pkg):
    return {} if pkg == "reference" else {"ctx": mt.cpu()}


def _xavier(pkg):
    return (mx if pkg == "reference" else mt).initializer.Xavier()


CONV_CASES = {
    "Conv1DRNNCell": ((2, 9), dict(i2h_kernel=3, h2h_kernel=3, i2h_dilate=2,
                                   activation="relu")),
    "Conv2DLSTMCell": ((3, 6, 5), dict(i2h_kernel=(3, 1), h2h_kernel=3,
                                       i2h_pad=(1, 0))),
    "Conv3DGRUCell": ((1, 3, 4, 3), dict(i2h_kernel=3, h2h_kernel=(3, 1, 3),
                                         i2h_pad=1, h2h_dilate=(1, 2, 1)))}


def test_conv_lstm_cell_matches_the_reference():
    """The 2-D LSTM cell unrolled, with every parameter's gradient."""
    shape, kw = CONV_CASES["Conv2DLSTMCell"]
    ref = rcontrib.Conv2DLSTMCell(input_shape=shape, hidden_channels=3, **kw)
    port = pcontrib.Conv2DLSTMCell(input_shape=shape, hidden_channels=3,
                                   **kw)
    _carry(ref, port)
    x = _rng(8).randn(2, 3, *shape).astype("f4")
    _compare(_unrolled(mx, ref, x, 3), _unrolled(mt, port, x, 3))


@pytest.mark.parametrize("name", ["Conv1DRNNCell", "Conv3DGRUCell"])
def test_conv_cells_match_the_reference(name):
    """The RNN kind in 1-D and the GRU kind in 3-D (dilations, relu,
    unequal kernels): a step's output and state."""
    shape, kw = CONV_CASES[name]
    kw = dict(input_shape=shape, hidden_channels=3, **kw)
    ref = getattr(rcontrib, name)(**kw)
    x = _rng(8).randn(2, *shape).astype("f4")
    h = [(0.1 * _rng(9).randn(*ref.state_info(2)[0]["shape"])).astype("f4")]
    _held(*_ref_forward(ref, getattr(pcontrib, name)(**kw), x, h))


@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
@pytest.mark.parametrize("dims", [1, 2, 3])
def test_every_conv_cell_has_the_references_shapes(kind, dims):
    """All nine ``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``: the reference's
    parameter names and shapes, state shapes and layouts; a step on the
    port gives the state's shape."""
    name = f"Conv{dims}D{kind}Cell"
    shape = (2,) + (5, 4, 3)[:dims]
    kw = dict(input_shape=shape, hidden_channels=3, i2h_kernel=3,
              h2h_kernel=3, i2h_pad=1)
    ref = getattr(rcontrib, name)(**kw)
    port = getattr(pcontrib, name)(**kw)
    assert {k: p.shape for k, p in port.collect_params().items()} == \
        {k: p.shape for k, p in ref.collect_params().items()}
    assert port.state_info(4) == ref.state_info(4)
    port.initialize(device="cpu")
    states = [s._data for s in port.begin_state(4)]
    out, new = port(torch.zeros((4,) + shape), states)
    assert tuple(out.shape) == ref.state_info(4)[0]["shape"]
    assert len(new) == len(ref.state_info(4))


@pytest.mark.parametrize("name,factor,shape", [
    ("PixelShuffle1D", 3, (2, 6, 4)), ("PixelShuffle2D", (2, 3),
                                       (2, 12, 3, 2)),
    ("PixelShuffle3D", 2, (1, 16, 2, 3, 2))])
def test_pixel_shuffle_matches_the_reference(name, factor, shape):
    x = _rng(9).randn(*shape).astype("f4")
    want = getattr(rcontrib, name)(factor)(rnd.array(x)).asnumpy()
    got = getattr(pcontrib.nn, name)(factor)(torch.from_numpy(x))
    close(got, want, 0.0, name)


def test_contrib_layers_and_what_is_not_ported():
    from mxnet_tpu_torch.gluon import nn
    assert pcontrib.SyncBatchNorm is nn.SyncBatchNorm
    assert pcontrib.nn.Identity is nn.Identity
    assert pcontrib.Concurrent is nn.Concatenate
    assert pcontrib.HybridConcurrent is nn.HybridConcatenate
    assert pcontrib.rnn is pcontrib.rnn_cells
    assert sorted(pcontrib.nn.__all__) == sorted(rcontrib.nn.__all__)
    assert set(rcontrib.rnn_cells.__all__) == set(pcontrib.rnn_cells.__all__)
    for name in ("cnn", "estimator", "data", "DeformableConvolution"):
        with pytest.raises(MXNetError, match="not ported yet"):
            getattr(pcontrib, name)
    with pytest.raises(MXNetError, match="not ported yet"):
        from mxnet_tpu_torch.gluon.contrib import estimator  # noqa: F401


# -- initializers -------------------------------------------------------------

def _draw(pkg, init, name, shape):
    if pkg == "reference":
        return onp.asarray(init.init_array(name, shape, "float32"))
    return init.init_array(name, shape, torch.float32,
                           torch.Generator().manual_seed(3)).numpy()


@pytest.mark.parametrize("rand_type,shape", [("uniform", (6, 4)),
                                             ("normal", (3, 2, 2, 2)),
                                             ("uniform", (4, 9))])
def test_orthogonal_by_its_properties(rand_type, shape):
    for pkg, mod in (("reference", rinit), ("port", pinit)):
        w = _draw(pkg, mod.Orthogonal(scale=1.5, rand_type=rand_type),
                  "w", shape)
        assert w.shape == shape
        m = w.reshape(shape[0], -1) / 1.5
        gram = m @ m.T if m.shape[0] <= m.shape[1] else m.T @ m
        onp.testing.assert_allclose(gram, onp.eye(gram.shape[0]),
                                    atol=1e-5)


def test_msra_prelu_and_the_deterministic_initializers():
    shape = (64, 32, 3, 3)
    for pkg, mod in (("reference", rinit), ("port", pinit)):
        w = _draw(pkg, mod.MSRAPrelu(factor_type="in", slope=0.1), "w",
                  shape)
        want = (2.0 / (1 + 0.01) / (32 * 9)) ** 0.5
        assert abs(w.std() / want - 1) < 0.03 and abs(w.mean()) < 0.01
    assert pinit.MSRAPrelu(slope=0.1)._kwargs == \
        rinit.MSRAPrelu(slope=0.1)._kwargs
    for shape in ((2, 3, 4, 4), (1, 1, 5, 3)):
        onp.testing.assert_array_equal(
            _draw("port", pinit.Bilinear(), "up", shape),
            _draw("reference", rinit.Bilinear(), "up", shape))
    onp.testing.assert_array_equal(
        _draw("port", pinit.LSTMBias(2.5), "forget", (8,)),
        _draw("reference", rinit.LSTMBias(2.5), "forget", (8,)))
    assert pinit.LSTMBias(2.5)._kwargs == rinit.LSTMBias(2.5)._kwargs


def test_load_mixed_and_initdesc():
    rng = _rng(10)
    params = {"arg:dense.weight": rng.randn(3, 2).astype("f4"),
              "aux:bn.running_var": rng.rand(3).astype("f4"),
              "w": rng.randn(4).astype("f4")}
    for pkg, mod in (("reference", rinit), ("port", pinit)):
        load = mod.Load(params, default_init=mod.Constant(0.5))
        for name in ("dense.weight", "bn.running_var", "w"):
            key = "arg:" + name if name == "dense.weight" else (
                "aux:" + name if name.startswith("bn") else name)
            onp.testing.assert_array_equal(
                _draw(pkg, load, name, params[key].shape), params[key])
        onp.testing.assert_array_equal(_draw(pkg, load, "other", (2,)),
                                       onp.full((2,), 0.5, "f4"))
        with pytest.raises(Exception, match="cannot be initialized"):
            _draw(pkg, load, "w", (5,))
        d = mod.InitDesc("fc_weight", attrs={"lr_mult": "2"},
                         global_init=load)
        assert d == "fc_weight" and d.attrs == {"lr_mult": "2"}
        assert d.global_init is load and isinstance(d, str)
    for pkg, mod, nd, ctx in (("reference", rinit, mx.nd, {}),
                              ("port", pinit, mt.nd, {"ctx": mt.cpu()})):
        mixed = mod.Mixed(["bias$", ".*"], [mod.Constant(2.0),
                                            mod.Constant(3.0)])
        a = nd.zeros((2, 2), **ctx)
        mixed("fc_bias", a)       # the name rule wins: zeros
        assert float(a.asnumpy().max()) == 0.0
        mixed(mod.InitDesc("fc_weight"), a)
        assert float(a.asnumpy().min()) == 3.0
        with pytest.raises(Exception, match="did not match"):
            mod.Mixed(["^x"], [mod.One()])("fc_weight", a)


def test_mixed_through_initialize():
    """``initialize(init=Mixed(...))`` routes each weight by its name, as
    the reference's does (a callable initializer)."""
    for pkg, mod in ((mx, rinit), (mt, pinit)):
        net = pkg.gluon.nn.Dense(3, in_units=2)
        kw = {} if pkg is mx else {"device": "cpu"}
        net.initialize(init=mod.Mixed([".*weight", ".*"],
                                      [mod.One(), mod.Zero()]), **kw)
        onp.testing.assert_array_equal(net.weight.data().asnumpy(),
                                       onp.ones((3, 2), "f4"))


# -- the weight carrier -------------------------------------------------------

@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_reference_params_load_into_the_port_by_name(kind):
    """A reference layer's ``collect_params`` (bidirectional, two layers,
    and for the LSTM a projection) loads into the port's by name: the
    same names in the same order, and the same forward."""
    kw = dict(num_layers=2, bidirectional=True, input_size=4)
    if kind == "lstm":
        kw["projection_size"] = 3
    cls = {"lstm": (rrnn.LSTM, prnn.LSTM), "gru": (rrnn.GRU, prnn.GRU)}[kind]
    ref, port = cls[0](5, **kw), cls[1](5, **kw)
    mx.random.seed(1)
    ref.initialize(init=mx.initializer.Xavier())
    ref.hybridize()        # a forward only: one compile of it
    assert list(port.collect_params()) == list(ref.collect_params())
    port.initialize(device="cpu")
    convert.load_collected_params(port, _ref_params(ref), device="cpu")
    back = convert.collected_params_to_numpy(port)
    for k, v in _ref_params(ref).items():
        onp.testing.assert_array_equal(back[k], v)
    x = _rng(11).randn(3, 2, 4).astype("f4")
    close(port(torch.from_numpy(x)), ref(rnd.array(x)).asnumpy(), 1e-5,
          "forward")
