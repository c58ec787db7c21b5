"""The pipeline schedules against the reference
(``mxnet_tpu/parallel/pipeline.py``), on the CPU.

The reference runs on the 8 emulated devices ``tests/conftest.py`` sets
up (each call under ``jax.jit``); the port on 8 spawned gloo ranks
(``torch_dist_cases.RankPool``), one pool for the file, each rank one
stage of the ``pp`` axis (``_MeshPipe``: the hop a ``batch_isend_irecv``).
Both get the same numpy weights and batches.  Held at fp32 rtol 1e-5 /
atol 1e-6: GPipe's, the interleaved schedule's and 1F1B's outputs,
losses, gradients and (1F1B) input gradients, on pp4 and dp2×pp4 (the
reference's ``test_pipeline_parity.py`` and ``test_parallel_extra.py``
cases); the same schedules folded into this process (``fold=True``, the
hop a list roll) against the ranked ones; the validation errors word for
word, the tick counts and the alias's warning; and the 1F1B memory
property, as the bytes autograd holds at once
(``saved_tensors_hooks``) on the folded transport.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as onp
import pytest
import torch

from mxnet_tpu import parallel as jpar

import torch_dist_cases as cases
from mxnet_tpu_torch import parallel as par

WORLD = 8
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = cases.RankPool(WORLD, tmp_path_factory.mktemp("ranks"))
    yield p
    p.close()


def j_stage(params, x):
    w, b = params
    return jax.nn.relu(x @ w + b)


def j_stages(n):
    def stage(params, x):
        w, b = params
        for j in range(n):
            x = j_stage((w[j], b[j]), x)
        return x
    return stage


def j_mse(y, t):
    return jnp.mean((y - t) ** 2)


def stack(rng, n, H, lead=()):
    return (rng.randn(*lead, n, H, H).astype("float32") * 0.3,
            rng.randn(*lead, n, H).astype("float32") * 0.1)


# (kind, S, V: layers a stage (gpipe) or virtual stages (interleaved),
#  H, B, M, mesh axes, seed): the reference tests' configurations
CASES = {
    "parity_gpipe": ("gpipe", 4, 1, 6, 16, 4, {"pp": 4}, 10),
    "parity_interleaved": ("interleaved", 4, 1, 6, 16, 4, {"pp": 4}, 10),
    "parity_1f1b": ("1f1b", 4, 1, 6, 16, 4, {"pp": 4}, 10),
    "parity_dp_gpipe": ("gpipe", 4, 1, 4, 16, 4, {"dp": 2, "pp": 4}, 11),
    "parity_dp_1f1b": ("1f1b", 4, 1, 4, 16, 4, {"dp": 2, "pp": 4}, 11),
    "gpipe_forward": ("gpipe", 4, 1, 8, 16, 4, {"pp": 4}, 0),
    "gpipe_grads": ("gpipe", 4, 1, 6, 8, 2, {"pp": 4}, 1),
    "gpipe_dp": ("gpipe", 4, 1, 4, 16, 2, {"dp": 2, "pp": 4}, 2),
    "gpipe_two_layers": ("gpipe", 4, 2, 4, 8, 4, {"pp": 4}, 5),
    "interleaved_v2": ("interleaved", 4, 2, 6, 8, 4, {"pp": 4}, 4),
    "interleaved_dp": ("interleaved", 4, 2, 4, 16, 2, {"dp": 2, "pp": 4},
                       8),
    "1f1b_deep": ("1f1b", 4, 1, 6, 32, 16, {"pp": 4}, 40),
    "1f1b_dp": ("1f1b", 4, 1, 4, 32, 8, {"dp": 2, "pp": 4}, 41),
}


def make_case(name):
    kind, S, V, H, B, M, axes, seed = CASES[name]
    rng = onp.random.RandomState(seed)
    if kind == "gpipe" and V > 1:
        params = stack(rng, V, H, lead=(S,))
    else:
        params = stack(rng, S * V if kind == "interleaved" else S, H)
    x = rng.randn(B, H).astype("float32")
    t = rng.randn(B, H).astype("float32")
    return kind, V, M, axes, params, x, t


def reference(kind, V, M, axes, params, x, t):
    mesh = jpar.make_mesh(axes)
    p = tuple(jnp.asarray(a) for a in params)
    xj, tj = jnp.asarray(x), jnp.asarray(t)
    if kind == "1f1b":
        loss, grads, dx = jax.jit(
            lambda q: jpar.pipeline_value_and_grad_1f1b(
                j_stage, j_mse, q, xj, tj, mesh, n_microbatches=M,
                return_input_grad=True))(p)
        return float(loss), [onp.asarray(g) for g in grads], onp.asarray(dx)
    if kind == "gpipe":
        stage = j_stages(V) if V > 1 else j_stage

        def fwd(q):
            return jpar.pipeline_forward(stage, q, xj, mesh,
                                         n_microbatches=M)
    else:
        def fwd(q):
            return jpar.pipeline_forward_interleaved(j_stage, q, xj, mesh,
                                                     n_microbatches=M)
    out = jax.jit(fwd)(p)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda q: j_mse(fwd(q), tj)))(p)
    return onp.asarray(out), float(loss), [onp.asarray(g) for g in grads]


def assert_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert_close(g, w)
        else:
            onp.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_matches_the_reference(pool, name):
    """Each schedule on ranks (one stage a rank; dp×pp where the case
    has dp) against the reference's, and folded into this process
    against the ranked one."""
    kind, V, M, axes, params, x, t = make_case(name)
    want = reference(kind, V, M, axes, params, x, t)
    layers = V if kind == "gpipe" else 1
    got = [r for r in pool.run("case_pipeline", kind, params, x, t, axes,
                               M, "dp", layers) if r is not None]
    assert len(got) == int(onp.prod(list(axes.values())))
    for r in got:
        assert_close(list(r), list(want))
    folded = cases.case_pipeline(kind, params, x, t, None, M, None, layers,
                                 fold=True)
    assert_close(list(folded), list(got[0]))


def test_validation_errors_match_the_reference(pool):
    rng = onp.random.RandomState(0)
    bad = stack(rng, 8, 4)
    x = onp.ones((8, 4), "float32")
    mesh = jpar.make_mesh({"pp": 4})
    jp = tuple(jnp.asarray(a) for a in bad)
    want = []
    for fn in (lambda: jpar.pipeline_forward(
                   j_stage, jp, jnp.asarray(x), mesh, n_microbatches=2,
                   batch_axis_name=None),
               lambda: jpar.pipeline_forward(
                   j_stage, tuple(a[:4] for a in jp), jnp.ones((10, 4)),
                   mesh, n_microbatches=4, batch_axis_name=None),
               lambda: jpar.pipeline_value_and_grad_1f1b(
                   j_stage, j_mse, tuple(a[:4] for a in jp),
                   jnp.ones((8, 4)), jnp.ones((4, 4)), mesh,
                   n_microbatches=2, batch_axis_name=None),
               lambda: jpar.pipeline_forward_interleaved(
                   j_stage, jp, jnp.ones((16, 4)), mesh, n_microbatches=8,
                   batch_axis_name=None)):
        with pytest.raises(ValueError) as e:
            fn()
        want.append(("ValueError", str(e.value)))
    got = [r for r in pool.run("case_pipeline_errors", bad, x)
           if r is not None]
    assert len(got) == 4
    for r in got:
        assert [tuple(e) for e in r] == want


def test_tick_counts_and_the_alias_warning():
    for S, V, M in ((4, 2, 4), (8, 1, 64), (2, 3, 2)):
        assert par.interleaved_ticks(S, V, M) == \
            jpar.interleaved_ticks(S, V, M)
        assert par.gpipe_ticks(S, V, M) == jpar.gpipe_ticks(S, V, M)
        assert par.one_f_one_b_ticks(S, M) == jpar.one_f_one_b_ticks(S, M)
    assert par.one_f_one_b_ticks(4, 16) == 22
    assert par.one_f_one_b_ticks(8, 64) == 78
    rng = onp.random.RandomState(42)
    layers = stack(rng, 8, 4)
    x = rng.randn(8, 4).astype("float32")
    with pytest.warns(DeprecationWarning, match="interleaved"):
        got = par.pipeline_forward_1f1b(
            cases.relu_stage, cases._tensors(layers), torch.tensor(x), None,
            4, batch_axis_name=None, fold=True, n_stages=4)
    h = torch.tensor(x)
    for w, b in zip(*cases._tensors(layers)):
        h = torch.relu(h @ w + b)
    onp.testing.assert_allclose(got.numpy(), h.numpy(), **TOL)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        par.pipeline_forward_interleaved(
            cases.relu_stage, cases._tensors(layers), torch.tensor(x), None,
            4, batch_axis_name=None, fold=True, n_stages=4)


class _Held:
    """A tensor autograd saved, counted in ``box`` while it is held."""

    def __init__(self, t, box):
        self.t, self.box, self.n = t, box, t.nbytes
        box[0] += self.n
        box[1] = max(box[1], box[0])

    def __del__(self):
        self.box[0] -= self.n


def peak_saved(fn):
    """The most bytes autograd held at once while ``fn`` ran."""
    box = [0, 0]
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: _Held(t, box), lambda h: h.t):
        fn()
    return box[1]


def test_1f1b_activation_memory_is_bounded_in_m():
    """The 1F1B property (``test_parallel_extra.py:549``): the bytes
    autograd holds at once stay flat as M grows 4x (the B slot recomputes
    one stage from its stashed input), while GPipe keeps every
    microbatch's graph until its backward and grows ~4x."""
    S, H, mb = 4, 32, 4
    w = torch.zeros(S, H, H, requires_grad=True)
    b = torch.zeros(S, H, requires_grad=True)

    def one_f_one_b(M):
        x = torch.zeros(M * mb, H)
        return peak_saved(lambda: par.pipeline_value_and_grad_1f1b(
            cases.relu_stage, cases.mse, (w, b), x, x, None, M,
            batch_axis_name=None, fold=True))

    def gpipe(M):
        x = torch.zeros(M * mb, H)

        def run():
            out = par.pipeline_forward(cases.relu_stage, (w, b), x, None, M,
                                       batch_axis_name=None, fold=True)
            cases.mse(out, x).backward()
        return peak_saved(run)

    t8, t32 = one_f_one_b(8), one_f_one_b(32)
    g8, g32 = gpipe(8), gpipe(32)
    assert g32 > 2.5 * g8, (g8, g32)
    assert t32 < 1.1 * t8, (t8, t32)
    assert t32 < g32 / 4, (t32, g32)
