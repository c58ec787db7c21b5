"""``gluon.loss`` and the ``CTCLoss`` op against the reference on the CPU.

Each of the 14 losses runs in both packages on the same seeded numpy
inputs, with ``weight`` and ``sample_weight`` (and ``batch_axis`` where
it matters): the values and the gradient with respect to the
prediction agree at fp32 1e-5 (``test_torch_parity.close``).  CTC runs
with both blank conventions, padded labels, label and data lengths,
unreachable alignments and empty labels; where a case has a true CTC
value, ``torch.nn.functional.ctc_loss`` agrees too.  The reference's
``tests/test_gluon.py::test_losses`` and
``::test_sdml_loss_and_name_parity`` run through both packages."""
import numpy as onp
import pytest
import torch
import torch.nn.functional as F

import mxnet_tpu as mx
from mxnet_tpu import ndarray as rnd
from mxnet_tpu.gluon import loss as rloss
from mxnet_tpu.ops.registry import get as ref_get

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import loss as ploss
from mxnet_tpu_torch.ops import nn as nn_ops

from test_torch_parity import assert_parity_jit, close

TOL = {"forward": 1e-5, "grad": 1e-5}


def _rng(seed):
    return onp.random.RandomState(seed)


def _f(rng, *shape, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, shape).astype("f4")


def _cases():
    rng = _rng(0)
    pred, lab = _f(rng, 4, 5), _f(rng, 4, 5)
    sw = _f(rng, 4, 1, lo=0.1, hi=1.0)
    sign = onp.where(_f(rng, 4, 5) > 0, 1.0, -1.0).astype("f4")
    bits = (_f(rng, 4, 5) > 0).astype("f4")
    prob = _f(rng, 4, 5, lo=0.05, hi=0.95)
    logp = onp.log(onp.exp(pred) / onp.exp(pred).sum(1, keepdims=True))
    dist = onp.exp(_f(rng, 4, 5))
    dist = (dist / dist.sum(1, keepdims=True)).astype("f4")
    counts = rng.poisson(2.0, (4, 5)).astype("f4")
    cls = rng.randint(0, 5, (4,)).astype("f4")
    return {
        "L2Loss": ("L2Loss", dict(weight=0.7), [pred, lab.reshape(4, 5, 1)],
                   sw),
        "L1Loss": ("L1Loss", dict(weight=2.0), [pred, lab], sw),
        "SigmoidBCE": ("SigmoidBinaryCrossEntropyLoss", dict(weight=0.5),
                       [pred, bits], sw),
        "SigmoidBCE_pos_weight": ("SigmoidBinaryCrossEntropyLoss", {},
                                  [pred, bits], None,
                                  dict(pos_weight=_f(rng, 4, 5, lo=0.5,
                                                     hi=2.0))),
        "SigmoidBCE_from_sigmoid": ("SigmoidBCELoss",
                                    dict(from_sigmoid=True),
                                    [prob, bits], sw),
        "SigmoidBCE_from_sigmoid_pos_weight": (
            "SigmoidBCELoss", dict(from_sigmoid=True), [prob, bits], None,
            dict(pos_weight=_f(rng, 4, 5, lo=0.5, hi=2.0))),
        "SoftmaxCE": ("SoftmaxCrossEntropyLoss", dict(weight=1.5),
                      [pred, cls], sw[:, 0]),
        "SoftmaxCE_dense": ("SoftmaxCELoss", dict(sparse_label=False),
                            [pred, dist], sw[:, 0]),
        "SoftmaxCE_logits_axis0": ("SoftmaxCrossEntropyLoss",
                                   dict(from_logits=True, axis=0,
                                        batch_axis=1),
                                   [logp.T.copy(), cls], None),
        "KLDiv": ("KLDivLoss", dict(weight=0.3), [logp, dist], sw),
        "KLDiv_not_logits": ("KLDivLoss", dict(from_logits=False),
                             [pred, dist], sw),
        "Huber": ("HuberLoss", dict(rho=0.8, weight=1.2), [pred, lab], sw),
        "Hinge": ("HingeLoss", dict(margin=1.5), [pred, sign], sw),
        "SquaredHinge": ("SquaredHingeLoss", dict(margin=0.5, weight=2.0),
                         [pred, sign], sw),
        "Logistic": ("LogisticLoss", dict(weight=0.9), [pred, sign], sw),
        "Logistic_binary": ("LogisticLoss", dict(label_format="binary"),
                            [pred, bits], sw),
        "Triplet": ("TripletLoss", dict(margin=0.5, weight=1.3),
                    [pred, lab, _f(rng, 4, 5)], sw[:, 0]),
        "PoissonNLL": ("PoissonNLLLoss", dict(weight=0.5),
                       [pred * 0.5, counts], sw),
        "PoissonNLL_full": ("PoissonNLLLoss",
                            dict(from_logits=False, compute_full=True),
                            [prob * 3, counts], sw),
        "CosineEmbedding": ("CosineEmbeddingLoss", dict(margin=0.2),
                            [pred, lab, onp.array([1, -1, 1, -1], "f4")],
                            sw[:, 0]),
        "SDML": ("SDMLLoss", dict(smoothing_parameter=0.2), [pred, lab],
                 sw[:, 0]),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_matches_the_reference(case):
    """The loss and its gradient with respect to the prediction (every
    float input of the metric losses), ``weight`` and ``sample_weight``
    included."""
    name, kw, inputs, sw, *extra = CASES[case]
    extra = extra[0] if extra else {}
    ref_blk = getattr(rloss, name)(**kw)
    ref_blk.hybridize()    # one compile of its forward and backward
    port_blk = getattr(ploss, name)(**kw)
    diff = [0] if name not in ("TripletLoss", "SDMLLoss",
                               "CosineEmbeddingLoss") else [0, 1]
    rargs = [rnd.array(a) for a in inputs]
    pargs = [torch.from_numpy(a.copy()) for a in inputs]
    for i in diff:
        rargs[i].attach_grad()
        pargs[i].requires_grad_(True)
    rextra = {k: rnd.array(v) for k, v in extra.items()}
    pextra = {k: torch.from_numpy(v) for k, v in extra.items()}
    if sw is not None:
        rextra["sample_weight"] = rnd.array(sw)
        pextra["sample_weight"] = torch.from_numpy(sw)
    with mx.autograd.record():
        ref = ref_blk(*rargs, **rextra)
    ref.backward()
    got = port_blk(*pargs, **pextra)
    close(got, ref.asnumpy(), 1e-5, "loss")
    grads = torch.autograd.grad(got.sum(), [pargs[i] for i in diff])
    for i, g in zip(diff, grads):
        close(g, rargs[i].grad.asnumpy(), 1e-5, f"gradient {i}")


def test_losses():
    """The reference's ``test_gluon.py::test_losses`` in both packages."""
    for nd, gl in ((mx.nd, rloss), (mt.nd, ploss)):
        ctx = {} if nd is mx.nd else {"ctx": mt.cpu()}
        pred = nd.array([[1.0, 2.0], [3.0, 4.0]], **ctx)
        label = nd.array([[1.5, 2.5], [2.0, 5.0]], **ctx)
        onp.testing.assert_allclose(
            gl.L2Loss()(pred, label).asnumpy(),
            ((pred.asnumpy() - label.asnumpy()) ** 2).mean(1) / 2, rtol=1e-5)
        onp.testing.assert_allclose(
            gl.L1Loss()(pred, label).asnumpy(),
            onp.abs(pred.asnumpy() - label.asnumpy()).mean(1), rtol=1e-5)
        logits_np = _rng(1).randn(4, 5).astype("float32")
        logits = nd.array(logits_np, **ctx)
        lbl = nd.array([0, 2, 1, 4], **ctx)
        ce = gl.SoftmaxCrossEntropyLoss()(logits, lbl).asnumpy()
        p = onp.exp(logits_np)
        p /= p.sum(-1, keepdims=True)
        onp.testing.assert_allclose(
            ce, -onp.log(p[onp.arange(4), [0, 2, 1, 4]]), rtol=1e-4)


def test_sdml_loss_and_name_parity():
    """The reference's ``test_gluon.py::test_sdml_loss_and_name_parity``
    in both packages: SDML separates aligned pairs, the reference's
    spellings resolve, and ``Load`` round-trips saved parameters by
    their hierarchical names, bias and BatchNorm entries included."""
    for pkg in (mx, mt):
        from importlib import import_module
        base = pkg.__name__
        L = import_module(f"{base}.gluon.loss")
        M = import_module(f"{base}.gluon.metric")
        R = import_module(f"{base}.gluon.rnn")
        Ini = import_module(f"{base}.initializer")
        O = import_module(f"{base}.optimizer")
        gluon = import_module(f"{base}.gluon")
        ctx = {} if pkg is mx else {"ctx": mt.cpu()}

        def arr(a):
            return pkg.nd.array(a, **ctx)
        rng = _rng(0)
        emb = rng.randn(8, 16).astype("float32")
        sd = L.SDMLLoss(smoothing_parameter=0.3)
        good = float(sd(arr(emb), arr(emb + 0.01 * rng.randn(8, 16)
                                      .astype("float32"))).asnumpy().mean())
        bad = float(sd(arr(emb), arr(rng.randn(8, 16).astype("float32")))
                    .asnumpy().mean())
        assert good < bad
        assert O.Ftrl is O.FTRL and callable(O.LANS)
        assert M.Torch is M.Loss and M.Caffe is M.Loss
        assert R.HybridRecurrentCell is R.RecurrentCell
        assert R.HybridSequentialRNNCell is R.SequentialRNNCell
        assert R.ModifierCell.__name__.endswith("ModifierCell")
        assert isinstance(M.create("torch"), M.Loss)
        assert isinstance(M.create("caffe"), M.Loss)

        def make():
            net = gluon.nn.HybridSequential()
            net.add(gluon.nn.Dense(4, in_units=3), gluon.nn.BatchNorm())
            return net
        init = {} if pkg is mx else {"device": "cpu"}
        net = make()
        net.initialize(**init)
        net(arr(onp.ones((2, 3), "float32")))
        rng2 = _rng(3)
        for p in net.collect_params().values():
            p.set_data(arr(rng2.randn(*p.shape).astype("float32")))
        params = {"arg:" + k: p.data()
                  for k, p in net.collect_params().items()}
        net2 = make()
        net2.initialize(init=Ini.Load(params, default_init=Ini.Zero()),
                        **init)
        net2(arr(onp.ones((2, 3), "float32")))
        for k in net.collect_params():
            onp.testing.assert_allclose(
                net2.collect_params()[k].data().asnumpy(),
                net.collect_params()[k].data().asnumpy(), rtol=1e-6,
                err_msg=k)
        err = mx.base.MXNetError if pkg is mx else MXNetError
        with pytest.raises(err):
            Ini.Load({}, default_init=None)("w", net.collect_params()[
                list(net.collect_params())[0]].data())


# -- CTC ----------------------------------------------------------------------

def _ctc_case(seed, T_, N_, C, L, blank="first", pad=True):
    rng = _rng(seed)
    data = rng.randn(T_, N_, C).astype("f4")
    lo = 1 if blank == "first" else 0
    hi = C if blank == "first" else C - 1
    label = rng.randint(lo, hi, (N_, L)).astype("f4")
    if pad:
        for n in range(N_):
            label[n, rng.randint(1, L + 1):] = -1
    return data, label


CTC_CASES = {
    "first_padded": (_ctc_case(0, 12, 4, 6, 4), {}),
    "last_padded": (_ctc_case(1, 12, 4, 6, 4, blank="last"),
                    dict(blank_label="last")),
    "label_lengths": (_ctc_case(2, 10, 3, 5, 4, pad=False),
                      dict(use_label_lengths=True),
                      [onp.array([2, 4, 1], "f4")]),
    "data_and_label_lengths": (_ctc_case(3, 10, 3, 5, 3, pad=False),
                               dict(use_data_lengths=True,
                                    use_label_lengths=True),
                               [onp.array([10, 7, 4], "f4"),
                                onp.array([3, 2, 1], "f4")]),
}


def _unreachable():
    """Row 0 needs 5 frames for 'a a a' in 3; row 1 is an empty label;
    row 2 a reachable one."""
    data = _rng(4).randn(3, 3, 4).astype("f4")
    label = onp.array([[2, 2, 2], [-1, -1, -1], [1, 3, -1]], "f4")
    return data, label


CTC_CASES["unreachable_and_empty"] = (_unreachable(), {})


@pytest.mark.parametrize("case", sorted(CTC_CASES))
def test_ctc_op_matches_the_reference(case):
    """Loss and gradient with respect to the activations."""
    (data, label), kw, *lengths = CTC_CASES[case]
    lengths = lengths[0] if lengths else []
    ref_fn = ref_get("CTCLoss").fn
    arrays = [data, label] + lengths
    assert_parity_jit(lambda d, *a: ref_fn(d, *a, **kw),
                      lambda d, *a: nn_ops.ctc_loss(d, *a, **kw), arrays,
                      diff_inputs=[0], tol=TOL)


def test_ctc_unreachable_and_empty_rows_keep_the_references_values():
    """An unreachable alignment costs the reference's 1e30 (not inf), an
    empty label log 2 less than the blank-only path's cost; a reachable
    row is torch's CTC value."""
    data, label = _unreachable()
    got = nn_ops.ctc_loss(torch.from_numpy(data),
                          torch.from_numpy(label)).numpy()
    assert got[0] == onp.float32(1e30)
    logp = torch.log_softmax(torch.from_numpy(data), -1)
    blank_path = -float(logp[:, 1, 0].sum())
    assert abs(got[1] - (blank_path - onp.log(2))) < 1e-5
    want = F.ctc_loss(logp[:, 2:3], torch.tensor([[1, 3]]),
                      torch.tensor([3]), torch.tensor([2]),
                      reduction="none")
    close(got[2:3], want, 1e-5, "reachable row")


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_equals_torch_ctc_where_both_define_it(blank):
    """On reachable, non-empty labels the op is torch's CTC: value and
    gradient."""
    data, label = _ctc_case(5, 30, 5, 7, 6, blank=blank)
    lab_len = torch.from_numpy((label >= 0).sum(1))
    x = torch.from_numpy(data).requires_grad_(True)
    got = nn_ops.ctc_loss(x, torch.from_numpy(label), blank_label=blank)
    x2 = torch.from_numpy(data).requires_grad_(True)
    want = F.ctc_loss(torch.log_softmax(x2, -1),
                      torch.from_numpy(label).clamp(min=0).long(),
                      torch.full((5,), 30), lab_len,
                      blank=0 if blank == "first" else 6, reduction="none")
    close(got, want, 1e-5, "value")
    g1, = torch.autograd.grad(got.sum(), x)
    g2, = torch.autograd.grad(want.sum(), x2)
    close(g1, g2, 1e-5, "gradient")


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN")])
def test_gluon_ctc_loss_matches_the_reference(layout, label_layout):
    data, label = _ctc_case(6, 8, 3, 5, 3)
    if layout == "NTC":
        data = data.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        label = label.T.copy()
    sw = onp.array([0.5, 1.0, 2.0], "f4")
    plen = onp.array([8, 6, 5], "f4")
    for args in ({}, {"pred_lengths": plen}):
        ref = rloss.CTCLoss(layout, label_layout, weight=0.7)(
            rnd.array(data), rnd.array(label), sample_weight=rnd.array(sw),
            **{k: rnd.array(v) for k, v in args.items()})
        got = ploss.CTCLoss(layout, label_layout, weight=0.7)(
            torch.from_numpy(data), torch.from_numpy(label),
            sample_weight=torch.from_numpy(sw),
            **{k: torch.from_numpy(v) for k, v in args.items()})
        close(got, ref.asnumpy(), 1e-5, str(args))


def test_ctc_under_amp_stays_float32():
    """``CTCLoss`` is on the AMP fp32 list: under the bf16 policy its
    bf16 inputs are cast to f32 and the loss is the f32 one of the same
    values."""
    from mxnet_tpu_torch import amp
    data, label = _ctc_case(7, 6, 2, 5, 2)
    x = torch.from_numpy(data).to(torch.bfloat16)
    want = nn_ops.ctc_loss(x.float(), torch.from_numpy(label))
    amp.init("bfloat16")
    try:
        got = nn_ops.ctc_loss(x, torch.from_numpy(label))
    finally:
        amp.reset()
    assert got.dtype == torch.float32
    close(got, want, 0.0, "amp")
