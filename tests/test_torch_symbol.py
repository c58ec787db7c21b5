"""``mx.sym`` of the port against the reference's on the CPU: each case
of the reference's ``tests/test_symbol.py`` through both packages on the
same numpy inputs (float32, rtol 1e-5), symbol json and ``.params``
crossing between the two packages in both directions, ``mx.model``
checkpoints, ``trace`` of ResNet-18, AlexNet and the transformer LM at
small widths (the same arguments, auxiliary states and outputs as the
reference's trace), and the name / attribute scopes.  Randomness
(Dropout) is held by its statistics: the two packages' generators
differ.
"""
import json

import numpy as onp
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

RTOL = 1e-5
RNG = onp.random.RandomState(0)


@pytest.fixture(autouse=True)
def _on_the_host():
    with mt.cpu():
        yield


def _f(*shape):
    return RNG.randn(*shape).astype(onp.float32)


def _close(got, ref, rtol=RTOL):
    got, ref = onp.asarray(got), onp.asarray(ref)
    assert got.shape == ref.shape
    onp.testing.assert_allclose(got, ref, rtol=rtol,
                                atol=rtol * max(1.0, float(abs(ref).max())))


def _eval_both(build, **inputs):
    """``build(sym)`` in both packages, evaluated on the same inputs."""
    got = build(mt.sym).eval(**{k: mt.nd.array(v) for k, v in
                                inputs.items()})
    ref = build(mx.sym).eval(**{k: mx.nd.array(v) for k, v in
                                inputs.items()})
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        _close(g.asnumpy(), r.asnumpy())
    return got


def test_variable_and_compose():
    got = _eval_both(lambda s: s.Variable("a") + s.Variable("b") * 2.0,
                     a=onp.array([1.0, 2.0], "float32"),
                     b=onp.array([3.0, 4.0], "float32"))
    onp.testing.assert_allclose(got[0].asnumpy(), [7.0, 10.0])
    c = mt.sym.Variable("a") + mt.sym.Variable("b") * 2.0
    assert sorted(c.list_arguments()) == ["a", "b"]


@pytest.mark.parametrize("expr", ["a + 1.0", "1.0 + a", "a - 1.0",
                                  "1.0 - a", "a * 2.0", "2.0 * a",
                                  "a / 2.0", "2.0 / a", "a ** 2.0", "-a"])
def test_scalar_arith_all_directions(expr):
    x = onp.array([1.0, 2.0, 4.0], "float32")
    _eval_both(lambda s: eval(expr, {"a": s.Variable("a")}), a=x)


def test_op_namespace_and_infer_shape():
    def build(s):
        fc = s.FullyConnected(s.Variable("data"), s.Variable("w"),
                              s.Variable("b"), num_hidden=16)
        return s.Activation(fc, act_type="relu")
    shapes = dict(data=(4, 8), w=(16, 8), b=(16,))
    assert build(mt.sym).infer_shape(**shapes) == \
        build(mx.sym).infer_shape(**shapes)
    _eval_both(build, data=_f(4, 8), w=_f(16, 8), b=_f(16))


def _bound(s, nd, shapes, grad_req="write"):
    return s.simple_bind(grad_req=grad_req, **shapes), nd


def test_bind_forward_backward():
    an, bn = _f(2, 2), _f(2, 2)
    outs, grads = [], []
    for s, nd in ((mt.sym, mt.nd), (mx.sym, mx.nd)):
        c = s.sum(s.Variable("a") * s.Variable("b"))
        ex = c.simple_bind(a=an.shape, b=bn.shape)
        outs.append(ex.forward(is_train=True, a=nd.array(an),
                               b=nd.array(bn))[0].asnumpy())
        ex.backward()
        grads.append([ex.grad_dict[k].asnumpy() for k in ("a", "b")])
    _close(outs[0], outs[1])
    for g, r in zip(*grads):
        _close(g, r)
    _close(grads[0][0], bn)


def test_grad_req_add_and_null():
    an = onp.array([1.0, 2.0], "float32")
    got = []
    for s, nd in ((mt.sym, mt.nd), (mx.sym, mx.nd)):
        a = s.Variable("a")
        loss = s.sum(a * a)
        ex = loss.simple_bind(a=an.shape, grad_req="add")
        for _ in range(2):
            ex.forward(is_train=True, a=nd.array(an))
            ex.backward()
        got.append(ex.grad_dict["a"].asnumpy())
        ex2 = loss.simple_bind(a=an.shape, grad_req="null")
        ex2.forward(is_train=True, a=nd.array(an))
        ex2.backward()
        assert ex2.grad_arrays == [None]
    _close(got[0], got[1])
    _close(got[0], 4 * an)


def _fc_tanh(s):
    return s.Activation(s.FullyConnected(s.Variable("data"),
                                         s.Variable("w"), None,
                                         num_hidden=4, no_bias=True),
                        act_type="tanh")


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_json_roundtrip(writer):
    """json written by either package loads in both and computes the
    same outputs."""
    src = mt.sym if writer == "port" else mx.sym
    js = _fc_tanh(src).tojson()
    x, w = _f(2, 3), _f(4, 3)
    port = mt.sym.load_json(js)
    ref = mx.sym.load_json(js)
    assert port.list_arguments() == ref.list_arguments() == ["data", "w"]
    _close(port.eval(data=mt.nd.array(x), w=mt.nd.array(w))[0].asnumpy(),
           ref.eval(data=mx.nd.array(x), w=mx.nd.array(w))[0].asnumpy())


def test_save_load_file(tmp_path):
    f = str(tmp_path / "net-symbol.json")
    (mt.sym.exp(mt.sym.Variable("a")) + 1.0).save(f)
    for s, nd in ((mt.sym, mt.nd), (mx.sym, mx.nd)):
        out = s.load(f).eval(a=nd.array([0.0]))[0].asnumpy()
        onp.testing.assert_allclose(out, [2.0], rtol=1e-6)


def test_get_internals_and_getitem():
    got = []
    for s, nd in ((mt.sym, mt.nd), (mx.sym, mx.nd)):
        a = s.Variable("a")
        h = s.relu(a * 2.0, name="hidden")
        out = s.sum(h, name="out")
        assert "hidden" in [x.name for x in out.get_internals()]
        got.append(out["hidden"].eval(a=nd.array([-1.0, 3.0]))[0]
                   .asnumpy())
    _close(got[0], got[1])
    onp.testing.assert_allclose(got[0], [0.0, 6.0])


def test_compose_substitution():
    def build(s):
        return s.exp(s.Variable("x"))(x=s.Variable("y") * 2.0)
    assert build(mt.sym).list_arguments() == ["y"]
    _eval_both(build, y=onp.array([1.0], "float32"))


def test_missing_arg_errors():
    c = mt.sym.Variable("a") + mt.sym.Variable("b")
    with pytest.raises(MXNetError):
        c.eval(a=mt.nd.array([1.0]))
    with pytest.raises(MXNetError):
        c.infer_shape(a=(1,))


def test_group():
    got = _eval_both(lambda s: s.Group([s.exp(s.Variable("a")),
                                        s.log(s.Variable("a"))]),
                     a=onp.array([1.0], "float32"))
    assert len(got) == 2


def _fc_relu(s):
    return s.Activation(
        s.FullyConnected(s.Variable("data"), s.Variable("fc_weight"), None,
                         num_hidden=4, no_bias=True), act_type="relu")


def test_symbol_block(tmp_path):
    """``SymbolBlock`` over a symbol, and ``SymbolBlock.imports`` of a
    symbol json and ``.params`` written by either package."""
    from mxnet_tpu.gluon import SymbolBlock as RefBlock
    from mxnet_tpu_torch.gluon import SymbolBlock
    wn, x = _f(4, 6), _f(2, 6)
    blk = SymbolBlock(_fc_relu(mt.sym), ["data"], params={"fc_weight": wn})
    ref = RefBlock(_fc_relu(mx.sym), ["data"], params={"fc_weight": wn})
    _close(blk(mt.nd.array(x)).asnumpy(), ref(mx.nd.array(x)).asnumpy())
    expect = onp.maximum(x @ wn.T, 0)
    _close(blk(mt.nd.array(x)).asnumpy(), expect)
    for name, (s, nd) in (("p", (mt.sym, mt.nd)), ("r", (mx.sym, mx.nd))):
        sfile = str(tmp_path / f"{name}-symbol.json")
        pfile = str(tmp_path / f"{name}-0000.params")
        _fc_relu(s).save(sfile)
        nd.save(pfile, {"fc_weight": nd.array(wn)})
        got = SymbolBlock.imports(sfile, ["data"], pfile)(mt.nd.array(x))
        back = RefBlock.imports(sfile, ["data"], pfile)(mx.nd.array(x))
        _close(got.asnumpy(), expect)
        _close(back.asnumpy(), expect)


def test_symbol_block_grads():
    from mxnet_tpu.gluon import SymbolBlock as RefBlock
    from mxnet_tpu_torch.gluon import SymbolBlock
    wn = onp.ones((3, 2), "float32")
    x = onp.array([[1.0, 2.0]], "float32")
    got = []
    for blk_cls, s, nd, ag in ((SymbolBlock, mt.sym, mt.nd, mt.autograd),
                               (RefBlock, mx.sym, mx.nd, mx.autograd)):
        net = s.FullyConnected(s.Variable("data"), s.Variable("w"), None,
                               num_hidden=3, no_bias=True)
        blk = blk_cls(net, ["data"], params={"w": wn})
        if blk_cls is RefBlock:
            for p in blk.collect_params().values():
                p.initialize()
        with ag.record():
            loss = blk(nd.array(x)).sum()
        loss.backward()
        got.append(blk.collect_params()["w"].grad().asnumpy())
    _close(got[0], got[1])
    _close(got[0], onp.tile(x, (3, 1)))


def test_sym_auto_param_variables():
    for s in (mt.sym, mx.sym):
        fc = s.FullyConnected(s.Variable("data"), name="fc", num_hidden=4)
        assert fc.list_arguments() == ["data", "fc_weight", "fc_bias"]
        conv = s.Convolution(s.Variable("x"), name="c0", kernel=(3, 3),
                             num_filter=2, no_bias=True)
        assert conv.list_arguments() == ["x", "c0_weight"]


def test_sym_partial_shape_inference():
    def build(s):
        net = s.FullyConnected(s.Variable("data"), name="fc1", num_hidden=8)
        net = s.Activation(net, act_type="relu")
        return s.FullyConnected(net, name="fc2", num_hidden=3)
    port, ref = build(mt.sym), build(mx.sym)
    assert port.list_arguments() == ref.list_arguments()
    assert port.infer_shape(data=(2, 5)) == ref.infer_shape(data=(2, 5))
    d = dict(zip(port.list_arguments(), port.infer_shape(data=(2, 5))[0]))
    assert d["fc1_weight"] == (8, 5) and d["fc2_weight"] == (3, 8)
    shapes, _, _ = port.infer_shape_partial(data=(2, 5))
    assert shapes[0] == (2, 5)
    # missing data: the partial variant reports what it knows
    shapes, outs, _ = port.infer_shape_partial()
    assert outs is None and shapes[0] is None


def _bn(s):
    return s.BatchNorm(s.var("data"), s.var("gamma"), s.var("beta"),
                       s.var("mean"), s.var("var"), use_global_stats=True,
                       fix_gamma=False, name="bn")


def test_aux_states_split():
    port, ref = _bn(mt.sym), _bn(mx.sym)
    assert port.list_auxiliary_states() == ref.list_auxiliary_states() \
        == ["mean", "var"]
    assert port.list_arguments() == ref.list_arguments()
    shapes = port.infer_shape(data=(2, 4, 8, 8))
    assert shapes == ref.infer_shape(data=(2, 4, 8, 8))
    arg_shapes, _, aux_shapes = shapes
    args = {n: onp.random.RandomState(i).rand(*s).astype("float32") + 0.5
            for i, (n, s) in enumerate(zip(port.list_arguments(),
                                           arg_shapes))}
    aux = {n: onp.random.RandomState(9 + i).rand(*s).astype("float32") + .5
           for i, (n, s) in enumerate(zip(port.list_auxiliary_states(),
                                          aux_shapes))}
    dy = _f(2, 4, 8, 8)
    res = []
    for sym_, nd in ((port, mt.nd), (ref, mx.nd)):
        grads = {n: nd.array(onp.zeros(s, "float32"))
                 for n, s in zip(sym_.list_arguments(), arg_shapes)}
        ex = sym_.bind(args={k: nd.array(v) for k, v in args.items()},
                       args_grad=grads,
                       aux_states={k: nd.array(v) for k, v in aux.items()})
        assert len(ex.aux_arrays) == 2
        out = ex.forward(is_train=True)[0]
        ex.backward(nd.array(dy))
        assert set(ex.grad_dict) == set(args)
        res.append([out.asnumpy()] + [grads[k].asnumpy()
                                      for k in sorted(grads)])
        assert len(sym_.simple_bind(data=(2, 4, 8, 8)).aux_arrays) == 2
    for g, r in zip(*res):
        _close(g, r, rtol=1e-4)
    assert abs(res[0][2]).sum() > 0           # gamma took a gradient


LEGACY = {
    "nodes": [
        {"op": "null", "name": "data", "inputs": []},
        {"op": "null", "name": "w", "inputs": []},
        {"op": "null", "name": "b", "inputs": []},
        {"op": "FullyConnected", "name": "fc",
         "attrs": {"num_hidden": "4", "flatten": "True"},
         "inputs": [[0, 0, 0], [1, 0, 0], [2, 0, 0]]},
        {"op": "Activation", "name": "act",
         "attr": {"act_type": "relu"},
         "inputs": [[3, 0, 0]]},
    ],
    "arg_nodes": [0, 1, 2],
    "heads": [[4, 0, 0]],
    "attrs": {"mxnet_version": ["int", 10700]},
}


def test_load_legacy_reference_json():
    """MXNet 1.x json (stringified attributes, ``attr`` and ``attrs``,
    no format tag) loads and runs as in the reference."""
    inputs = dict(data=_f(2, 3), w=_f(4, 3), b=_f(4))
    got = _eval_both(lambda s: s.load_json(json.dumps(LEGACY)), **inputs)
    assert mt.sym.load_json(json.dumps(LEGACY)).list_arguments() == \
        ["data", "w", "b"]
    assert (got[0].asnumpy() >= 0).all()


def test_load_json_unknown_format():
    bad = {"nodes": [], "arg_nodes": [], "heads": [],
           "attrs": {"format": "mxnet_tpu-symbol-v99"}}
    with pytest.raises(MXNetError, match="unknown symbol json format"):
        mt.sym.load_json(json.dumps(bad))


def test_trace_twice_is_clean():
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.symbol.symbol import _topo_nodes
    net = nn.HybridSequential()
    net.add(nn.Dense(5, activation="relu"), nn.Dense(3))
    net.initialize(device="cpu")
    x = mt.nd.array(_f(2, 4))
    s1, a1, _ = mt.sym.trace(net, x)
    s2, a2, _ = mt.sym.trace(net, x)
    assert len(_topo_nodes([o[0] for o in s1._outputs])) == \
        len(_topo_nodes([o[0] for o in s2._outputs]))
    assert sorted(a1) == sorted(a2)
    r1 = s1.bind(args={**a1, "data": x}).forward()[0].asnumpy()
    r2 = s2.bind(args={**a2, "data": x}).forward()[0].asnumpy()
    onp.testing.assert_array_equal(r1, r2)
    _close(r1, net(x).asnumpy())


def test_symbolic_dropout_train_eval_and_keys():
    ones = mt.nd.array(onp.ones((1000,), "float32"))
    x = mt.sym.var("x")
    ex = mt.sym.Dropout(x, p=0.5).bind(None, {"x": ones})
    assert (ex.forward(is_train=False)[0].asnumpy() == 1).all()
    t1 = ex.forward(is_train=True)[0].asnumpy()
    t2 = ex.forward(is_train=True)[0].asnumpy()
    assert 0.35 < (t1 == 0).mean() < 0.65
    assert (t1 != t2).any()
    onp.testing.assert_array_equal(t1[t1 != 0], 2.0)
    ex2 = mt.sym.Dropout(x, p=0.5, mode="always").bind(None, {"x": ones})
    assert 0.35 < (ex2.forward(is_train=False)[0].asnumpy()
                   == 0).mean() < 0.65
    port = mt.sym.Dropout(x, p=0.5).list_arguments()
    ref = mx.sym.Dropout(mx.sym.var("x"), p=0.5).list_arguments()
    assert len(port) == len(ref) == 2 and port[0] == ref[0] == "x"
    assert port[1].endswith("_key") and ref[1].endswith("_key")


def test_symbolic_prng_keys_are_structural():
    ones = mt.nd.array(onp.ones((1000,), "float32"))
    x = mt.sym.var("x")
    ex = mt.sym.Dropout(x, p=0.5).bind(
        None, {"x": ones},
        args_grad={"x": mt.nd.array(onp.zeros(1000, "float32"))},
        grad_req="add")
    ex.forward(is_train=True)
    ex.backward(mt.nd.array(onp.ones(1000, "float32")))
    ex2 = mt.sym.Dropout(x, p=0.5, mode="always").bind(None, {"x": ones})
    a = ex2.forward(is_train=False)[0].asnumpy()
    b = ex2.forward(is_train=False)[0].asnumpy()
    assert (a != b).any()
    z = mt.sym.FullyConnected(mt.sym.var("att_key"), num_hidden=4)
    with pytest.raises(MXNetError):
        z.bind(None, {})
    ex3 = mt.sym.Dropout(mt.sym.var("x"), p=0.5).simple_bind(None, x=(8,))
    assert ex3.forward(is_train=True)[0].shape == (8,)


def test_prng_key_pinning_and_eval():
    ones = mt.nd.array(onp.ones((1000,), "float32"))
    symb = mt.sym.Dropout(mt.sym.var("x"), p=0.5)
    out = symb.eval(x=ones)[0].asnumpy()
    assert 0.35 < (out == 0).mean() < 0.65
    kn = symb.list_prng_keys()[0]
    pinned = symb.bind(None, {"x": ones,
                              kn: mt.nd.array(onp.array([0, 7]),
                                              dtype="int64")})
    a = pinned.forward(is_train=True)[0].asnumpy()
    b = pinned.forward(is_train=True)[0].asnumpy()
    onp.testing.assert_array_equal(a, b)
    auto = symb.bind(None, {"x": ones})
    c = auto.forward(is_train=True)[0].asnumpy()
    d = auto.forward(is_train=True)[0].asnumpy()
    assert (c != d).any()


def test_infer_type_and_scopes():
    for s, pkg in ((mt.sym, mt), (mx.sym, mx)):
        c = s.Variable("a") + s.Variable("b")
        assert c.infer_type(a="float32", b="float16")[0][1] == \
            onp.dtype("float16")
        with pkg.name.Prefix("net1_"):
            fc = s.FullyConnected(s.Variable("data"), num_hidden=2)
        with pkg.AttrScope(ctx_group="stage1"):
            v = s.Variable("v")
        assert v.attr("ctx_group") == "stage1"
        assert fc.name.startswith("net1_")
        assert fc.list_arguments()[1].startswith("net1_fullyconnected")
    # the reference names that node net1_net1_fullyconnectedN beside its
    # net1_fullyconnectedN_weight (test_torch_reference_faults.py); the
    # port prefixes once
    with mt.name.Prefix("net1_"):
        fc = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2)
    assert fc.name.startswith("net1_fullyconnected")
    assert fc.list_arguments()[1] == fc.name + "_weight"
    assert mt.gluon.Parameter("w0").var().name == "w0"


# -- checkpoints --------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_pairs_cross(tmp_path, writer):
    """A ``save_checkpoint`` pair written by either package loads through
    the other's ``load_checkpoint`` and binds to the same outputs."""
    args = {"fc_weight": _f(4, 6)}
    aux = {"bn_mean": _f(4)}
    prefix = str(tmp_path / "ck")
    pkg = mx if writer == "reference" else mt
    pkg.model.save_checkpoint(prefix, 3, _fc_relu(pkg.sym),
                              {k: pkg.nd.array(v) for k, v in args.items()},
                              {k: pkg.nd.array(v) for k, v in aux.items()})
    x = _f(2, 6)
    outs = []
    for other in (mt, mx):
        sym_, arg_p, aux_p = other.model.load_checkpoint(prefix, 3)
        assert sorted(arg_p) == ["fc_weight"] and sorted(aux_p) == \
            ["bn_mean"]
        _close(aux_p["bn_mean"].asnumpy(), aux["bn_mean"])
        ex = sym_.bind(args={**arg_p, "data": other.nd.array(x)})
        outs.append(ex.forward()[0].asnumpy())
    _close(outs[0], outs[1])


def test_callbacks_and_visualization(tmp_path, capsys):
    from mxnet_tpu_torch import callback, visualization
    from mxnet_tpu_torch.gluon import nn
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), name="fc",
                                num_hidden=4)
    got = visualization.print_summary(net, shape={"data": (2, 6)})
    ref = mx.visualization.print_summary(
        mx.sym.load_json(net.tojson()), shape={"data": (2, 6)})
    assert got == ref == 6 * 4 + 4
    assert "digraph" in visualization.plot_network(net)
    cb = callback.do_checkpoint(str(tmp_path / "cb"), period=2)
    blk = nn.Dense(3)
    blk.initialize(device="cpu")
    blk(mt.nd.array(_f(1, 2)))
    cb(1, blk)
    assert (tmp_path / "cb-0002.params").exists()
    param = callback.BatchEndParam(epoch=0, nbatch=0)
    speed = callback.Speedometer(4, frequent=1)
    speed(param)
    param.nbatch = 1
    speed(param)
    callback.log_train_metric(1)(param)
    callback.ProgressBar(10)(param)
    blk.summary(mt.nd.array(_f(1, 2)))
    assert "Total params: 9" in capsys.readouterr().out


# -- trace --------------------------------------------------------------------

def _copy_params(port_net, ref_net):
    """The port's values into the reference's net, which was never
    initialised: no deferred init there, which would run op by op."""
    ref_params = ref_net.collect_params()
    for k, p in port_net.collect_params().items():
        ref_params[k].set_data(p._data.detach().float().numpy())


def _zoo(name):
    from mxnet_tpu.gluon.model_zoo import vision as ref_vision
    from mxnet_tpu_torch.gluon.model_zoo import vision
    return vision.get_model(name, classes=10), \
        ref_vision.get_model(name, classes=10)


def _lm():
    from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM as Ref
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerLM
    kw = dict(units=16, num_layers=2, num_heads=2, max_len=16,
              tie_weights=True)
    return TransformerLM(64, **kw), Ref(64, **kw)


@pytest.mark.parametrize("which", ["resnet18_v1", "alexnet", "lm"])
def test_trace_matches_the_reference(which):
    """``trace`` of a zoo net gives the reference's arguments, auxiliary
    states and outputs, and its graph binds in both packages."""
    if which == "lm":
        port_net, ref_net = _lm()
        x = RNG.randint(0, 64, (2, 8)).astype(onp.int32)
        px, rx = mt.nd.array(x, dtype="int32"), mx.nd.array(x,
                                                            dtype="int32")
    else:
        port_net, ref_net = _zoo(which)
        x = _f(1, 3, 16, 16) if which == "resnet18_v1" else _f(1, 3, 64, 64)
        px, rx = mt.nd.array(x), mx.nd.array(x)
    port_net.initialize(device="cpu")
    port_net(px)
    _copy_params(port_net, ref_net)
    ps, pa, paux = mt.sym.trace(port_net, px)
    rs, ra, raux = mx.sym.trace(ref_net, rx)
    assert ps.list_arguments() == rs.list_arguments()
    assert ps.list_auxiliary_states() == rs.list_auxiliary_states()
    assert sorted(pa) == sorted(ra) and sorted(paux) == sorted(raux)
    got = ps.bind(args={**pa, "data": px}, aux_states=paux).forward()[0]
    ref = rs.bind(args={**ra, "data": rx}, aux_states=raux).forward()[0]
    _close(got.asnumpy(), ref.asnumpy(), rtol=1e-4)
    _close(got.asnumpy(), port_net(px).asnumpy())
    # the port's traced json loads in the reference and computes the same
    back = mx.sym.load_json(ps.tojson())
    out = back.bind(args={**ra, "data": rx}, aux_states=raux).forward()[0]
    _close(out.asnumpy(), ref.asnumpy(), rtol=1e-4)
