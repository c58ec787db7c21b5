"""Gradients of the slice's registered ops against the reference's: each
op of ``torch_np_sweep.OP_NAMES`` the grad sweep gives a spec
(``tests/grad_sweep_specs.py``: its inputs, params, differentiated
inputs and output) runs forward and backward through both packages'
funnels under ``autograd.record()`` on the CPU, with the same cotangent
(zero where an output is not finite), and the input gradients agree at
rtol 1e-4, atol 1e-5 (1e-3 for the factorizations)."""
import numpy as onp
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

import torch_np_sweep as S

CPU = mx.cpu()
SPECS = S.SPEC_OPS
_FACTOR = ("_npi_cholesky", "_npi_svd", "_npi_eigh", "_npi_eigvalsh",
           "_npi_pinv", "_npi_pinv_scalar_rcond", "_npi_tensorinv",
           "_npi_tensorsolve", "_npi_solve", "_linalg_potri",
           "_linalg_potrf", "_linalg_inverse", "_linalg_det",
           "_linalg_slogdet", "_linalg_trsm")


def _grads(pkg, name, spec, arrays, cot_seed):
    diff = spec["diff"]
    nds = [pkg.nd.array(a) for a in arrays]
    if diff is None:
        diff = [i for i, a in enumerate(arrays)
                if onp.asarray(a).dtype.kind == "f"]
    for i in diff:
        nds[i].attach_grad()
    with pkg.autograd.record():
        out = S.invoke(pkg, name, nds, spec["params"])
    outs = out if isinstance(out, list) else [out]
    pick = spec["out"]
    if isinstance(pick, int):
        outs = [outs[pick]]
    r = onp.random.RandomState(cot_seed)
    heads, cots = [], []
    for o in outs:
        v = o.asnumpy()
        if v.dtype.kind != "f":
            continue
        c = r.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        c[~onp.isfinite(v)] = 0
        heads.append(o)
        cots.append(pkg.nd.array(c))
    pkg.autograd.backward(heads, cots)
    return [nds[i].grad.asnumpy() for i in diff]


@pytest.mark.parametrize("name,spec,arrays", SPECS,
                         ids=[s[0] for s in SPECS])
def test_op_gradient_matches_reference(name, spec, arrays):
    want = _grads(jmx, name, spec, arrays, 7)
    with CPU:
        got = _grads(mx, name, spec, arrays, 7)
    tol = dict(rtol=1e-3, atol=1e-3) if name in _FACTOR else \
        dict(rtol=1e-4, atol=1e-5)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        onp.testing.assert_allclose(g, w, **tol, err_msg=name)
