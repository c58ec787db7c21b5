"""The port's ``_npi_*`` / ``_np_*`` / ``_npx_*``, ``_linalg_*`` and
``_random_pdf_*`` ops, the attention extras and the kernels' registered
names (``ops/npi.py``, ``ops/linalg.py``, ``ops/random.py``,
``ops/attention.py``, ``ops/rope.py``, ``ops/paged_attention.py``)
against the reference's registered ops.

Each op of ``torch_np_sweep.OP_NAMES`` runs through both packages'
funnels (``registry.invoke``) on the CPU from the same numpy inputs: the
grad sweep's inputs (``tests/grad_sweep_specs.py``) where it has a spec,
a case of its own where it exempts the op.  Values and dtypes at rtol /
atol 1e-5 (factorizations by reconstruction at 1e-4, samplers by
moments).  Their gradients are in ``test_torch_npi_grad.py``.
"""
import numpy as onp
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import registry

import torch_np_sweep as S

CPU = mx.cpu()
OP_CASES = [c for c in S.CASES if c.family.startswith("op")]


@pytest.mark.parametrize("case", OP_CASES,
                         ids=[f"{c.family}-{c.id}" for c in OP_CASES])
def test_op_sweep(case):
    S.check_against(jmx, mx, case)


def test_the_slice_registers_every_reference_name():
    """Every name the reference registers in ``ops/npi.py``,
    ``ops/linalg.py``, the ``_npi_`` / ``_random_pdf_`` parts of
    ``ops/random.py``, the attention extras, ``rope`` and
    ``paged_attention`` is in the port's registry, under the same
    primary; every op of the slice has a case above."""
    ref = set()
    for name, op in jreg._REGISTRY.items():
        mod = getattr(op.fn, "__module__", "") or ""
        if mod.endswith(("ops.npi", "ops.linalg")) or (
                mod.endswith("ops.random")
                and name.startswith(("_npi_", "_random_pdf_"))):
            ref.add(name)
    extras = set(S.OP_NAMES) - ref
    assert {n for n in extras if not n.startswith(
        ("masked", "_npx_masked", "_contrib_", "div_sqrt", "interleaved",
         "rope", "_npx_rope", "paged", "_npx_paged"))} == set()
    assert ref <= set(S.OP_NAMES)
    ours = registry._REGISTRY
    assert not set(S.OP_NAMES) - set(ours)
    for n in S.OP_NAMES:
        assert ours[n].name == jreg._REGISTRY[n].name, n
    covered = {registry.get(c.call.__kwdefaults__["_n"]).name
               for c in OP_CASES}
    assert {ours[n].name for n in S.OP_NAMES} <= covered
    # the port registers only the reference's names, now 604 of its 695
    assert set(ours) <= set(jreg._REGISTRY)
    assert len(ours) >= 604
    assert "_npi_arctan2" in ours          # the reference's ops/tensor.py


# -- the reference's ``tests/test_op_sweep.py`` cases of the slice, through
# both packages ---------------------------------------------------------------

RNG = onp.random.RandomState(42)


def inv(pkg, name, arrays, **params):
    nds = [pkg.nd.array(onp.asarray(a)) for a in arrays]
    out = S.invoke(pkg, name, nds, params)
    return S.host(out)


def both(name, arrays, **params):
    want = inv(jmx, name, arrays, **params)
    with CPU:
        got = inv(mx, name, arrays, **params)
    assert [g.dtype for g in got] == [w.dtype for w in want], name
    return got, want


def same(name, arrays, rtol=1e-5, atol=1e-6, **params):
    got, want = both(name, arrays, **params)
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return got


def test_npi_binary_and_scalar():
    a = RNG.randn(3, 4).astype("float32")
    b = RNG.randn(3, 4).astype("float32")
    onp.testing.assert_allclose(same("_npi_add", [a, b])[0], a + b,
                                rtol=1e-6)
    same("_npi_multiply", [a, b])
    same("_npi_fmax", [a, b])
    same("_npi_rsubtract_scalar", [a], scalar=2.0)
    same("_npi_rtrue_divide_scalar", [a + 3], scalar=1.0)


def test_npi_reductions_and_stats():
    a = RNG.randn(4, 5).astype("float32")
    same("_npi_sum", [a], axis=1)
    same("_npi_std", [a], ddof=1)
    onp.testing.assert_allclose(same("_npi_average", [a])[0], a.mean(),
                                rtol=1e-5)


def test_npi_manipulation():
    a = RNG.randn(2, 3).astype("float32")
    b = RNG.randn(2, 3).astype("float32")
    same("_npi_concatenate", [a, b], axis=0)
    same("_npi_vstack", [a, b])
    same("_npi_flip", [a], axis=1)
    same("_npi_roll", [a], shift=2)
    same("_np_moveaxis", [a], source=0, destination=1)
    onp.testing.assert_allclose(
        same("_npi_pad", [a], pad_width=((1, 1), (0, 2)))[0],
        onp.pad(a, ((1, 1), (0, 2))))
    same("_npi_diff", [a], n=1, axis=1)
    onp.testing.assert_allclose(
        same("_npi_unique", [onp.array([3, 1, 3, 2])])[0], [1, 2, 3])


def test_npi_creation_windows():
    onp.testing.assert_allclose(same("_npi_eye", [], N=3, k=1)[0],
                                onp.eye(3, k=1))
    onp.testing.assert_allclose(same("_npi_hanning", [], M=8)[0],
                                onp.hanning(8), rtol=1e-5, atol=1e-6)
    same("_npi_blackman", [], M=5)
    same("_npi_logspace", [], start=0, stop=2, num=5)
    same("_npi_tri", [], N=4, k=-1)


def test_npi_numeric_specials():
    x = onp.array([0.5, 1.5, 2.5], dtype="float32")
    xp = onp.array([0.0, 1.0, 2.0, 3.0], dtype="float32")
    fp = onp.array([0.0, 10.0, 20.0, 30.0], dtype="float32")
    same("_npi_interp", [x, xp, fp])
    a = RNG.rand(20).astype("float32")
    onp.testing.assert_allclose(same("_npi_percentile", [a], q=30.0)[0],
                                onp.percentile(a, 30.0), rtol=1e-5)
    same("_npi_polyval", [onp.array([1.0, -2.0, 3.0], "float32"), x])
    same("_npi_cross", [RNG.randn(3).astype("float32"),
                        RNG.randn(3).astype("float32")])
    same("_npi_kron", [RNG.randn(2, 3).astype("float32"),
                       RNG.randn(4, 5).astype("float32")])
    same("_npi_einsum", [RNG.randn(3, 4).astype("float32"),
                         RNG.randn(4, 5).astype("float32")],
         subscripts="ij,jk->ik", rtol=1e-5, atol=1e-5)


def test_linalg_family():
    A = RNG.randn(3, 3).astype("float32")
    spd = A @ A.T + 3 * onp.eye(3, dtype="float32")
    L = same("_linalg_potrf", [spd], rtol=1e-5, atol=1e-5)[0]
    same("_linalg_potri", [L], rtol=1e-4, atol=1e-5)
    B = RNG.randn(3, 2).astype("float32")
    C = RNG.randn(3, 2).astype("float32")
    same("_linalg_gemm", [A, B, C], alpha=2.0, beta=0.5, rtol=1e-5,
         atol=1e-5)
    same("_linalg_trsm", [L, B], alpha=1.0, rtol=1e-5, atol=1e-5)
    same("_linalg_slogdet", [spd], rtol=1e-5, atol=1e-5)
    same("_npi_eigvalsh", [spd], rtol=1e-5, atol=1e-5)
    got, want = both("_linalg_syevd", [spd])
    onp.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    got, _ = both("_linalg_gelqf", [B.T])
    onp.testing.assert_allclose(got[0] @ got[1], B.T, rtol=1e-4, atol=1e-4)
    packed = same("_linalg_extracttrian", [spd])[0]
    onp.testing.assert_allclose(same("_linalg_maketrian", [packed])[0],
                                onp.tril(spd), rtol=1e-6)
    for lower in (True, False):
        for rightside in (True, False):
            for transpose in (True, False):
                same("_linalg_trsm", [L if lower else L.T,
                                      B.T if rightside else B],
                     lower=lower, rightside=rightside, transpose=transpose,
                     alpha=0.5, rtol=1e-4, atol=1e-5)
                same("_linalg_trmm", [L if lower else L.T,
                                      B.T if rightside else B],
                     lower=lower, rightside=rightside, transpose=transpose,
                     alpha=0.5, rtol=1e-5, atol=1e-5)


def test_npi_random_samplers():
    with CPU:
        u = S.invoke(mx, "_npi_uniform", [], {"low": 2.0, "high": 3.0,
                                              "size": (1000,)}).asnumpy()
        n = S.invoke(mx, "_npi_normal", [], {"loc": 1.0, "scale": 2.0,
                                             "size": (4000,)}).asnumpy()
        w = S.invoke(mx, "_npi_weibull", [], {"a": 1.0,
                                              "size": (2000,)}).asnumpy()
        m = S.invoke(mx, "_npi_multinomial", [],
                     {"n": 100, "pvals": (0.2, 0.8)}).asnumpy()
    assert 2.0 <= u.min() and u.max() <= 3.0 and abs(u.mean() - 2.5) < 0.05
    assert abs(n.mean() - 1.0) < 0.15 and abs(n.std() - 2.0) < 0.15
    assert abs(w.mean() - 1.0) < 0.1
    assert m.sum() == 100 and m[1] > m[0]


def test_random_pdf():
    s = onp.array([[0.5, 1.0]], dtype="float32")
    got = same("_random_pdf_normal", [s, onp.array([0.0], "float32"),
                                      onp.array([1.0], "float32")])[0]
    onp.testing.assert_allclose(got, onp.exp(-0.5 * s ** 2) /
                                onp.sqrt(2 * onp.pi), rtol=1e-5)


@pytest.mark.parametrize("name", sorted(jmx.nd.linalg.__all__))
def test_nd_linalg(name):
    """``mx.nd.linalg`` against the reference's, function by function."""
    A = RNG.randn(3, 3).astype("float32")
    spd = (A @ A.T + 3 * onp.eye(3)).astype("float32")
    L = onp.linalg.cholesky(spd).astype("float32")
    B = RNG.randn(3, 2).astype("float32")
    args = {"gemm": (A, B, B), "gemm2": (A, B), "potrf": (spd,),
            "potri": (L,), "trsm": (L, B), "trmm": (L, B), "syrk": (A,),
            "gelqf": (B.T,), "syevd": (spd,), "sumlogdiag": (spd,),
            "extractdiag": (A,), "makediag": (B[:, 0],),
            "extracttrian": (A,), "maketrian": (A[0],),
            "inverse": (spd,), "det": (spd,), "slogdet": (spd,)}[name]
    want = S.host(getattr(jmx.nd.linalg, name)(*[jmx.nd.array(a)
                                                 for a in args]))
    with CPU:
        got = S.host(getattr(mx.nd.linalg, name)(*[mx.nd.array(a)
                                                   for a in args]))
    assert [g.dtype for g in got] == [w.dtype for w in want]
    if name == "gelqf":
        got, want = [got[0] @ got[1]], [want[0] @ want[1]]
    if name == "syevd":
        got, want = [got[1]], [want[1]]
    for g, w in zip(got, want):
        onp.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
