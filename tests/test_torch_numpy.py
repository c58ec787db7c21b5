"""The port's numpy front end (``mx.np``, ``mx.npx``, ``util`` and the
dispatch protocol) against the reference package's.

The same numpy inputs go through both packages on the CPU (every port
array is made under ``with mx.cpu():``).  Values are compared at the
tolerance each case of ``torch_np_sweep`` states (float32: rtol 1e-5,
atol 1e-6 for elementwise functions; up to 1e-3 for factorizations and
fits), dtypes by name; factorizations by reconstruction, orders numpy
leaves open by sorted values, samplers by their moments.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

import torch_np_sweep as S

CPU = mx.cpu()

# the elementwise, reduction, order, product and polynomial families of
# the sweep (the others: ``test_torch_numpy_sweep.py``)
FAMILIES = ("np_unary", "np_binary", "np_reduce", "np_nan", "np_order",
            "np_product", "np_numeric", "np_poly", "np_method")
NP_CASES = [c for c in S.CASES if c.family in FAMILIES]


@pytest.mark.parametrize("case", NP_CASES,
                         ids=[f"{c.family}-{c.id}" for c in NP_CASES])
def test_np_sweep(case):
    """Each function of ``mx.np`` and each method of its ndarray against
    the reference's."""
    S.check_against(jmx, mx, case)


# -- the reference's own numpy tests, through both packages -------------------

RNG = onp.random.RandomState(0)
NA = RNG.randn(4, 5).astype("f4")
NB = RNG.randn(4, 5).astype("f4")
NV = RNG.randn(7).astype("f4")

# ``tests/test_numpy_namespace.py::test_np_function_matches_numpy``
NAMESPACE_CASES = [
    ("pad", (NV, 2)), ("insert", (NV, 2, 9.0)), ("delete", (NV, 2)),
    ("percentile", (NA, 30.0)), ("quantile", (NA, 0.3)), ("median", (NA,)),
    ("average", (NA,)),
    ("interp", (onp.array([0.5, 1.5], "f4"), onp.arange(4.0),
                onp.arange(4.0) * 2)),
    ("kron", (NA[:2, :2], NB[:2, :2])), ("cross", (NA[:, :3], NB[:, :3])),
    ("trace", (NA,)), ("polyval", (onp.array([1.0, -2.0, 1.0], "f4"), NV)),
    ("cov", (NA,)), ("corrcoef", (NA,)), ("gradient", (NV,)),
    ("diff", (NV,)), ("ediff1d", (NV,)),
    ("unique", (onp.array([1, 2, 2, 3], "f4"),)),
    ("bincount", (onp.array([0, 1, 1, 3]),)),
    ("searchsorted", (onp.sort(NV), onp.array([0.0], "f4"))),
    ("tile", (NA, 2)), ("repeat", (NA, 2)), ("rot90", (NA,)),
    ("flipud", (NA,)), ("roll", (NA, 1)),
    ("take_along_axis", (NA, onp.argsort(NA, axis=1), 1)),
    ("isclose", (NA, NA + 1e-8)), ("hanning", (8,)), ("hamming", (8,)),
    ("blackman", (8,)), ("vander", (NV,)),
    ("select", ([NV > 0, NV <= 0], [NV, -NV])),
    ("einsum", ("ij,ij->i", NA, NB)),
    ("in1d", (onp.array([1.0, 5.0], "f4"), onp.array([1.0, 2.0], "f4"))),
]


def _values(out):
    return S.host(out)


def _same(got, want, rtol=1e-5, atol=1e-6):
    got, want = _values(got), _values(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        onp.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name,args", NAMESPACE_CASES,
                         ids=[c[0] for c in NAMESPACE_CASES])
def test_namespace_function_matches_reference(name, args):
    def call(pkg):
        m_args = [pkg.np.array(a) if isinstance(a, onp.ndarray)
                  and a.dtype != onp.bool_ else a for a in args]
        return getattr(pkg.np, name)(*m_args)
    want = call(jmx)
    with CPU:
        got = call(mx)
    _same(got, want)
    # and numpy's own answer
    n_out = getattr(onp, name)(*args)
    for g, n in zip(_values(got), _values(n_out) if isinstance(
            n_out, (list, tuple)) else [onp.asarray(n_out)]):
        onp.testing.assert_allclose(g, n, rtol=1e-5, atol=1e-6)


def test_np_linalg_sampled():
    M = (NA @ NA.T + 5 * onp.eye(4)).astype("f4")
    with CPU:
        for name, tol in (("inv", 1e-5), ("det", 1e-5), ("norm", 1e-6)):
            arg = NA if name == "norm" else M
            _same(getattr(mx.np.linalg, name)(mx.np.array(arg)),
                  getattr(jmx.np.linalg, name)(jmx.np.array(arg)),
                  rtol=tol, atol=1e-5)
        L = mx.np.linalg.cholesky(mx.np.array(M)).asnumpy()
        onp.testing.assert_allclose(L @ L.T, M, rtol=1e-4, atol=1e-4)
        w, v = mx.np.linalg.eigh(mx.np.array(M))
        jw, _ = jmx.np.linalg.eigh(jmx.np.array(M))
        onp.testing.assert_allclose(sorted(w.asnumpy()),
                                    sorted(jw.asnumpy()), rtol=1e-5)
        # multi_dot takes a list of arrays (the reference's lift does not)
        md = mx.np.linalg.multi_dot([mx.np.array(NA), mx.np.array(NB.T),
                                     mx.np.array(NA)])
        onp.testing.assert_allclose(md.asnumpy(), NA @ NB.T @ NA, rtol=1e-4,
                                    atol=1e-4)


def test_np_fft_roundtrip_and_tail():
    with CPU:
        out = mx.np.fft.ifft(mx.np.fft.fft(mx.np.array(NV)))
    assert out.dtype == jmx.np.fft.ifft(jmx.np.fft.fft(jmx.np.array(NV))
                                        ).dtype == onp.complex64
    onp.testing.assert_allclose(out.asnumpy().real, NV, atol=1e-5)
    x = onp.asarray([1.0, 2.0, 3.0], "f4")
    with CPU:
        _same(mx.np.fft.hfft(mx.np.array(x)), jmx.np.fft.hfft(
            jmx.np.array(x)), atol=1e-5)
        _same(mx.np.fft.fftfreq(4), jmx.np.fft.fftfreq(4))
        _same(mx.np.fft.rfftfreq(5), jmx.np.fft.rfftfreq(5))


def test_np_random_draws_from_the_port_generator():
    """``mx.random.seed`` repeats ``np.random``'s draws, which never come
    from torch's global generator; the moments match the reference's
    (the streams differ by design)."""
    import torch
    with CPU:
        mx.random.seed(5)
        state = torch.get_rng_state()
        a = mx.np.random.normal(0, 1, size=(20000,)).asnumpy()
        assert torch.equal(torch.get_rng_state(), state)
        mx.random.seed(5)
        b = mx.np.random.normal(0, 1, size=(20000,)).asnumpy()
        onp.testing.assert_array_equal(a, b)
        assert abs(a.mean()) < 0.03
        s = mx.np.random.beta(2.0, 3.0, size=(20000,)).asnumpy()
        assert abs(s.mean() - 0.4) < 0.02
        p = mx.np.random.permutation(10)
        assert sorted(p.asnumpy().tolist()) == list(range(10))
        r = mx.np.random.randint(0, 5, size=(1000,))
        assert r.dtype == jmx.np.random.randint(0, 5, size=(3,)).dtype
        assert set(onp.unique(r.asnumpy())) <= {0, 1, 2, 3, 4}
        x = mx.np.array(onp.arange(12.0).reshape(6, 2))
        mx.np.random.shuffle(x)
        assert sorted(x.asnumpy()[:, 0].tolist()) == list(range(0, 12, 2))
        t = mx.np.random.t(5.0, size=(2000,)).asnumpy()
        assert abs(t.mean()) < 0.2
        nb = mx.np.random.negative_binomial(4, 0.5, size=(2000,))
        assert nb.dtype == jmx.np.random.negative_binomial(
            4, 0.5, size=(3,)).dtype
        assert abs(nb.asnumpy().mean() - 4.0) < 0.6


def test_np_autograd_through_lifted_fn():
    from mxnet_tpu import autograd as jag
    with CPU:
        x = mx.np.array(NA)
        x.attach_grad()
        with mx.autograd.record():
            y = mx.np.einsum("ij,ij->", x, x) + mx.np.sum(mx.np.sin(x))
        y.backward()
    j = jmx.np.array(NA)
    j.attach_grad()
    with jag.record():
        jy = jmx.np.einsum("ij,ij->", j, j) + jmx.np.sum(jmx.np.sin(j))
    jy.backward()
    _same(x.grad, j.grad, rtol=1e-5, atol=1e-6)
    onp.testing.assert_allclose(x.grad.asnumpy(), 2 * NA + onp.cos(NA),
                                rtol=1e-5)


def test_npx_masked_and_extras():
    x = onp.array([[1., 2., 3.]], "f4")
    m = onp.array([[1, 1, 0]], "f4")
    with CPU:
        a = mx.npx.masked_softmax(mx.nd.array(x), mx.nd.array(m))
        lo = mx.npx.masked_log_softmax(mx.nd.array(x), mx.nd.array(m))
    _same(a, jmx.npx.masked_softmax(jmx.nd.array(x), jmx.nd.array(m)))
    _same(lo, jmx.npx.masked_log_softmax(jmx.nd.array(x), jmx.nd.array(m)))
    assert a.asnumpy()[0, 2] == 0 and lo.asnumpy()[0, 2] == -onp.inf
    for name in ("rnn", "batch_dot", "is_np_shape", "current_context"):
        assert hasattr(mx.npx, name), name


def test_numpy_long_tail_additions():
    with CPU:
        onp.testing.assert_array_equal(
            mx.np.fix(mx.np.array([-1.7, 1.7])).asnumpy(), [-1.0, 1.0])
        onp.testing.assert_allclose(
            mx.np.geomspace(1, 8, 4).asnumpy(), [1, 2, 4, 8], rtol=1e-5)
        assert float(mx.np.trapz(mx.np.array([0.0, 1.0, 2.0]))) == 2.0
        onp.testing.assert_array_equal(
            mx.np.round_(mx.np.array([1.4, 1.6])).asnumpy(), [1.0, 2.0])
        onp.testing.assert_allclose(
            mx.np.unwrap(mx.np.array([0.0, 3.0, 6.0, 9.0])).asnumpy(),
            onp.unwrap([0.0, 3.0, 6.0, 9.0]), rtol=1e-6)
        ff = mx.np.fromfunction(lambda i, j: i + j, (2, 2))
        jff = jmx.np.fromfunction(lambda i, j: i + j, (2, 2))
        _same(ff, jff)


def test_npx_surface_completions():
    with CPU:
        x = mx.nd.array(onp.ones((2, 3, 4), "float32"))
        assert mx.npx.batch_flatten(x).shape == (2, 12)
        mx.npx.seed(0)
        out, states = mx.npx.foreach(
            lambda d, s: (d + s[0], [s[0] + 1]),
            mx.nd.array(onp.ones((3, 2), "float32")),
            [mx.nd.array(onp.zeros((2,), "float32"))])
    j_out, j_states = jmx.npx.foreach(
        lambda d, s: (d + s[0], [s[0] + 1]),
        jmx.nd.array(onp.ones((3, 2), "float32")),
        [jmx.nd.array(onp.zeros((2,), "float32"))])
    _same(out, j_out)
    _same(states[0], j_states[0])
    for name in ["multibox_prior", "multibox_target", "multibox_detection",
                 "roi_align", "box_nms", "box_iou", "while_loop", "cond",
                 "index_add", "index_update"]:
        assert callable(getattr(mx.npx, name)), name
    # the detection ops are not ported yet: their names say so
    with pytest.raises(MXNetError, match="not ported yet"):
        mx.npx.box_iou(x, x)


def test_npx_control_flow_matches_reference():
    def cond(i, s):
        return i < 4

    def body(i, s):
        return s * 2, (i + 1, s + i)

    with CPU:
        outs, (i, s) = mx.npx.while_loop(
            cond, body, (mx.nd.array([0.0]), mx.nd.array([1.0])),
            max_iterations=6)
        c = mx.npx.cond(mx.nd.array([1.0]) > 0, lambda: mx.nd.array([2.0]),
                        lambda: mx.nd.array([3.0]))
    j_outs, (ji, js) = jmx.npx.while_loop(
        cond, body, (jmx.nd.array([0.0]), jmx.nd.array([1.0])),
        max_iterations=6)
    _same(i, ji)
    _same(s, js)
    _same(outs, j_outs)
    assert float(c.asnumpy()[0]) == 2.0


def test_np_ndarray_method_tail_and_type_flavor():
    with CPU:
        a = mx.np.array([[1.0, 2.0], [3.0, 4.0]])
        assert type(a + a) is mx.np.ndarray
        assert type(a > 0) is mx.np.ndarray
        assert type(a.sum()) is mx.np.ndarray
        assert type(a[0]) is mx.np.ndarray
        assert type(mx.npx.relu(a)) is mx.np.ndarray
        assert abs(float(a.std()) - onp.asarray([[1, 2], [3, 4]]).std()) \
            < 1e-6
        assert a.ravel().shape == (4,)
        assert bool((a > 0).all()) and bool((a > 3).any())
        assert float(a.trace()) == 5.0
        assert a.diagonal().asnumpy().tolist() == [1.0, 4.0]
        assert float(a.ptp()) == 3.0
        assert isinstance(a.tobytes(), bytes)
        assert type(a.as_nd_ndarray()) is mx.nd.NDArray
        c = mx.nd.array([1.0]) + mx.nd.array([1.0])
        assert type(c).__name__ == "NDArray"


def test_block_outputs_take_the_numpy_flavor():
    with CPU:
        net = mx.gluon.nn.Dense(3, in_units=4)
        net.initialize(device="cpu")
        out = net(mx.np.array(onp.ones((2, 4), "f4")))
        assert type(out) is mx.np.ndarray
        assert type(net(mx.nd.array(onp.ones((2, 4), "f4")))) is \
            mx.nd.NDArray


# -- dtypes: the reference's, not torch's -------------------------------------

def _dtype_probe(pkg):
    np = pkg.np
    a = np.array([1, 2], dtype="int32")
    return [np.array([1, 2]).dtype, np.arange(5).dtype,
            np.array([1.0], dtype="float64").dtype, (a + 1.5).dtype,
            (a / 2).dtype, np.mean(a).dtype, np.argmax(a).dtype,
            np.sum(a).dtype, np.linspace(0, 1, 3).dtype,
            np.zeros((2,)).dtype, np.ones((2,), dtype="int64").dtype,
            np.full((2,), 3).dtype, np.eye(2).dtype,
            np.fft.fft(np.array([1.0, 2.0])).dtype]


def test_dtypes_match_the_reference():
    with CPU:
        got = _dtype_probe(mx)
    want = _dtype_probe(jmx)
    assert [onp.dtype(g) for g in got] == [onp.dtype(w) for w in want], (
        got, want)


@pytest.mark.parametrize("switch", ["set_np_default_dtype",
                                    "set_large_tensor"])
def test_64bit_switches_match_the_reference(switch):
    """Either 64-bit switch keeps float64 / int64 results in both
    packages; off again, both narrow to 32 bits."""
    def probe(pkg):
        np = pkg.np
        f = np.array(onp.array([1.5, 2.5]), dtype="float64")
        i = np.array(onp.array([1, 2], dtype="int64"), dtype="int64")
        return [f.dtype, (f * 2).dtype, i.dtype, np.sum(i).dtype,
                np.ones((2,), dtype="float64").dtype]

    getattr(jmx.util, switch)(True)
    getattr(mx.util, switch)(True)
    try:
        assert mx.util.x64_enabled()
        want = probe(jmx)
        with CPU:
            got = probe(mx)
    finally:
        getattr(jmx.util, switch)(False)
        getattr(mx.util, switch)(False)
    assert [onp.dtype(g) for g in got] == [onp.dtype(w) for w in want]
    assert onp.dtype(want[0]) == onp.float64
    with CPU:
        assert mx.np.array(onp.array([1.5]), dtype="float64").dtype == \
            onp.float32


def test_64bit_switch_drops_the_whole_step_capture(monkeypatch):
    """A whole-step capture recorded with the 64-bit switches off is not
    replayed once one is on (``mx.np`` results follow the switch as they
    run): the step after each flip is observed eagerly, a capture under
    the new setting replays from the next, and every step's loss and
    ``np.sum`` dtype are those of the eager loop."""
    from mxnet_tpu_torch.imperative import cached_step
    x = RNG.randn(8, 4).astype("float32")
    y = (onp.arange(8) % 3).astype("int32")

    def loop(cached):
        monkeypatch.setenv("MXNET_CACHED_STEP", "1" if cached else "0")
        out, ran = [], []
        with CPU:
            mx.random.seed(0)
            net = mx.gluon.nn.Dense(3, in_units=4)
            net.initialize(device="cpu")
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1})
            data, label = mx.np.array(x), mx.np.array(y, dtype="int32")
            try:
                for i in range(8):
                    mx.util.set_np_default_dtype(3 <= i < 6)
                    s0 = cached_step.stats()
                    with mx.autograd.record():
                        n = mx.np.sum(label)
                        loss = -mx.np.mean(mx.npx.pick(
                            mx.npx.log_softmax(net(data)), label))
                    loss.backward()
                    tr.step(1)
                    s1 = cached_step.stats()
                    out.append((float(loss), onp.dtype(n.dtype).name))
                    ran.append((s1["compiles"] - s0["compiles"],
                                s1["steps"] - s0["steps"]))
            finally:
                mx.util.set_np_default_dtype(False)
        return out, ran

    captured, ran = loop(True)
    eager, ran0 = loop(False)
    assert captured == eager
    assert [d for _, d in eager] == ["int32"] * 3 + ["int64"] * 3 + \
        ["int32"] * 2
    # (captures, captured steps) a step: step 0 observed, 1 captured, 2
    # replayed; the switch on at 3 (observed), captured again at 4; off
    # at 6 (observed), and at 7 the first capture replays
    assert ran == [(0, 0), (1, 1), (0, 1), (0, 0), (1, 1), (0, 1), (0, 0),
                   (0, 1)], ran
    assert not any(c or s for c, s in ran0)


# -- util ---------------------------------------------------------------------

def test_util_switches_and_scopes():
    u, ju = mx.util, jmx.util
    for pkg in (u, ju):
        pkg.reset_np()
        assert not pkg.is_np_array() and pkg.is_np_shape()
        pkg.set_np()
        assert pkg.is_np_array()
        with pkg.np_array(False):
            assert not pkg.is_np_array()
        assert pkg.is_np_array()
        pkg.reset_np()
        with pkg.np_shape(False):
            assert not pkg.is_np_shape()
        assert pkg.is_np_shape()

        @pkg.use_np
        def f():
            return pkg.is_np_array()
        assert f() and not pkg.is_np_array()
        with pkg.np_default_dtype():
            assert pkg.is_np_default_dtype()
        assert not pkg.is_np_default_dtype()
    assert mx.set_np is u.set_np and mx.npx.set_np is u.set_np
    assert u.np_ufunc_legal_option("where", True)
    assert not u.np_ufunc_legal_option("where", False)
    assert u.getenv("MXNET_NO_SUCH_VAR_X") is None
    u.setenv("MXNET_NO_SUCH_VAR_X", "1")
    assert u.getenv("MXNET_NO_SUCH_VAR_X") == "1"
    u.setenv("MXNET_NO_SUCH_VAR_X", None)
    sq = u.wrap_np_unary_func(lambda x: x * x)
    with CPU:
        assert float(sq(mx.np.array(3.0))) == 9.0
        with pytest.raises(TypeError):
            sq(mx.np.array(3.0), where=False)
        u.set_np()
        try:
            assert type(u.default_array([1.0])) is mx.np.ndarray
        finally:
            u.reset_np()
        assert type(u.default_array([1.0])) is mx.nd.NDArray
    assert u.get_gpu_count() == mx.num_gpus()
    with pytest.raises(ValueError):
        u.get_cuda_compute_capability(mx.cpu())
    f = u.numpy_fallback(onp.cumsum)
    with CPU:
        onp.testing.assert_array_equal(f(mx.nd.array([1.0, 2.0])).asnumpy(),
                                       [1.0, 3.0])


# -- the dispatch protocol ----------------------------------------------------

def test_array_function_dispatch():
    with CPU:
        x = mx.np.array(RNG.rand(3, 4).astype("float32"))
        out = onp.mean(x)
        assert type(out) is mx.np.ndarray
        assert float(out) == pytest.approx(float(x.asnumpy().mean()),
                                           rel=1e-6)
        out2 = onp.concatenate([x, x], axis=0)
        assert type(out2) is mx.np.ndarray and out2.shape == (6, 4)


def test_array_ufunc_dispatch():
    with CPU:
        x = mx.np.array(onp.ones((2, 2), "float32"))
        out = onp.add(x, 1.0)
        assert type(out) is mx.np.ndarray
        onp.testing.assert_allclose(out.asnumpy(), 2.0)
        out = onp.exp(x)
        onp.testing.assert_allclose(out.asnumpy(), onp.e, rtol=1e-6)
        # a ufunc method the namespace does not take: host numpy
        red = onp.add.reduce(x, axis=0)
        assert isinstance(red, onp.ndarray)
        onp.testing.assert_allclose(red, [2.0, 2.0])


def test_fallback_for_exotica():
    """A numpy function ``mx.np`` does not have is evaluated by host
    numpy, as the reference does."""
    with CPU:
        x = mx.np.array(RNG.rand(5).astype("float32"))
        out = onp.nanargmax(onp.stack([x.asnumpy()]))  # warm numpy
        out = onp.around(x)                             # in mx.np
        assert type(out) is mx.np.ndarray
        host = onp.sort_complex(x)                      # not in mx.np
        assert isinstance(host, onp.ndarray) and host.shape == (5,)
        del out


# -- the surface --------------------------------------------------------------

def test_namespace_names_cover_the_reference():
    ref_np = {n for n in dir(jmx.np) if not n.startswith("_")}
    ref_npx = {n for n in dir(jmx.npx) if not n.startswith("_")}
    assert len(ref_np) >= 300 and len(ref_npx) >= 60
    assert not ref_np - set(dir(mx.np)), sorted(ref_np - set(dir(mx.np)))
    assert not ref_npx - set(dir(mx.npx)), sorted(ref_npx - set(dir(mx.npx)))
    for sub in ("linalg", "fft", "random"):
        names = set(getattr(jmx.np, sub).__all__)
        assert not names - set(dir(getattr(mx.np, sub))), sub
    for name in ("util", "np", "npx", "numpy", "numpy_extension",
                 "is_np_array", "set_np", "reset_np"):
        assert hasattr(mx, name), name
    assert not set(jmx.nd.linalg.__all__) - set(dir(mx.nd.linalg))
