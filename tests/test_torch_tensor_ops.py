"""The tensor ops the vision zoo and the NDArray methods reach, against
the reference's (``mxnet_tpu/ops/tensor.py``), on the CPU: each op
through ``mx.nd`` of both packages on the same numpy inputs (made from
a seed), float32 results within 1e-6 of the reference's (relative to
its largest element; the elementwise transcendental functions within
1e-6 relative to each element, plus 1e-6 of the largest), integer and
index results bitwise equal, and the shape and dtype equal.
``topk``, ``sort`` and ``argsort`` get inputs without ties.  Then the
NDArray methods over those ops, the same way.
"""
import numpy as onp
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

RNG = onp.random.RandomState(0)


def _f(*shape, lo=-2.0, hi=2.0):
    return RNG.uniform(lo, hi, shape).astype(onp.float32)


def _distinct(*shape):
    """Floats without ties."""
    return (RNG.permutation(int(onp.prod(shape))).reshape(shape)
            .astype(onp.float32) / 7.0 - 3.0)


A = _f(3, 4, 5)
B = _f(3, 4, 5)
M = _f(4, 6)
N = _f(6, 3)
V = _f(5)
POS = _f(3, 4, 5, lo=0.1, hi=3.0)
UNIT = _f(3, 4, 5, lo=-0.9, hi=0.9)
IDX = RNG.randint(-2, 7, (2, 3)).astype(onp.float32)
IMG = _f(2, 8, 4, 6)
T = _distinct(4, 9)
SEQ = _f(5, 3, 2)
LENS = onp.array([2.0, 5.0, 1.0], onp.float32)
COND = (RNG.uniform(size=(3, 4, 5)) > 0.5).astype(onp.float32)
I32 = RNG.randint(-50, 50, (3, 4)).astype(onp.int32)
PICK = onp.array([0.0, 5.0, 2.0, 9.0], onp.float32)    # 9: clipped
ALONG = onp.array([[0, 2], [5, 1], [3, 3], [1, 0]], onp.int32)

# name -> (op, inputs, params)
CASES = {
    "clip": ("clip", [A], dict(a_min=-0.5, a_max=1.0)),
    "clip_low": ("clip", [A], dict(a_min=0.0)),
    "argmax": ("argmax", [A], dict(axis=1)),
    "argmax_flat": ("argmax", [A], {}),
    "argmin_keep": ("argmin", [A], dict(axis=2, keepdims=True)),
    "concat": ("concat", [A, B], dict(dim=1)),
    "concat_last": ("concat", [A, B, A], dict(dim=-1)),
    "stack": ("stack", [A, B], dict(axis=1)),
    "split": ("split", [A], dict(num_outputs=2, axis=1)),
    "split_squeeze": ("split", [A], dict(num_outputs=5, axis=2,
                                         squeeze_axis=True)),
    "transpose": ("transpose", [A], {}),
    "transpose_axes": ("transpose", [A], dict(axes=(1, 0, 2))),
    "take": ("take", [M, IDX], {}),
    "take_axis1_wrap": ("take", [M, IDX], dict(axis=1, mode="wrap")),
    "one_hot": ("one_hot", [IDX], dict(depth=5)),
    "one_hot_values": ("one_hot", [IDX], dict(depth=7, on_value=3.0,
                                              off_value=-1.0,
                                              dtype="int32")),
    "where": ("where", [COND, A, B], {}),
    "topk": ("topk", [T], dict(k=3)),
    "topk_value_axis0": ("topk", [T], dict(k=2, axis=0, ret_typ="value")),
    "topk_both_ascend": ("topk", [T], dict(k=4, ret_typ="both",
                                           is_ascend=True)),
    "topk_mask": ("topk", [T], dict(k=2, ret_typ="mask")),
    "sort": ("sort", [T], {}),
    "sort_desc": ("sort", [T], dict(axis=0, is_ascend=False)),
    "argsort": ("argsort", [T], {}),
    "argsort_desc": ("argsort", [T], dict(is_ascend=False)),
    "expand_dims": ("expand_dims", [A], dict(axis=1)),
    "squeeze": ("squeeze", [A[:, :1]], dict(axis=1)),
    "swapaxes": ("swapaxes", [A], dict(dim1=0, dim2=2)),
    "tile": ("tile", [M], dict(reps=(2, 3))),
    "repeat": ("repeat", [M], dict(repeats=2, axis=1)),
    "repeat_flat": ("repeat", [M], dict(repeats=3)),
    "flip": ("flip", [A], dict(axis=1)),
    "roll": ("roll", [A], dict(shift=2, axis=2)),
    "slice": ("slice", [A], dict(begin=(1, None, 0), end=(3, None, 4))),
    "slice_step": ("slice", [A], dict(begin=(None, 3, 0),
                                      end=(None, 0, 5), step=(1, -1, 2))),
    "slice_axis": ("slice_axis", [A], dict(axis=2, begin=1, end=-1)),
    "slice_like": ("slice_like", [A, M[:2, :3]], dict(axes=(0, 1))),
    "pick": ("pick", [M, PICK], dict(axis=1)),
    "pick_keep": ("pick", [M, PICK], dict(axis=1, keepdims=True)),
    "norm": ("norm", [A], {}),
    "norm_l1_axis": ("norm", [A], dict(ord=1, axis=(0, 2))),
    "broadcast_to": ("broadcast_to", [A[:, :1]], dict(shape=(3, 4, 5))),
    "broadcast_like": ("broadcast_like", [A[:1], B], {}),
    "broadcast_axis": ("broadcast_axis", [A[:, :1]], dict(axis=1,
                                                           size=6)),
    "pad_constant": ("pad", [IMG], dict(mode="constant",
                                        pad_width=(0, 0, 0, 0, 1, 2, 3, 0),
                                        constant_value=0.5)),
    "pad_edge": ("pad", [IMG], dict(mode="edge",
                                    pad_width=(0, 0, 0, 0, 2, 1, 1, 3))),
    "pad_reflect": ("pad", [IMG], dict(mode="reflect",
                                       pad_width=(0, 0, 0, 0, 2, 2, 3, 1))),
    "depth_to_space": ("depth_to_space", [IMG], dict(block_size=2)),
    "space_to_depth": ("space_to_depth", [IMG], dict(block_size=2)),
    "diag": ("diag", [M], dict(k=1)),
    "diag_vector": ("diag", [V], {}),
    "gather_nd": ("gather_nd", [M, onp.array([[0, 3, 1], [5, 2, 0]],
                                             onp.float32)], {}),
    "scatter_nd": ("scatter_nd", [V[:3].copy(), onp.array(
        [[0, 3, 1], [5, 2, 0]], onp.float32)], dict(shape=(4, 6))),
    "take_along_axis": ("take_along_axis", [M, ALONG], dict(axis=1)),
    "cumsum": ("cumsum", [A], dict(axis=1)),
    "cumsum_int": ("cumsum", [I32], {}),
    "cumprod": ("cumprod", [UNIT], dict(axis=2)),
    "logsumexp": ("logsumexp", [A], dict(axis=1)),
    "prod": ("prod", [UNIT], dict(axis=(0, 2))),
    "nansum": ("nansum", [onp.where(COND > 0, onp.nan, A)
                          .astype(onp.float32)], dict(axis=1)),
    "nanprod": ("nanprod", [onp.where(COND > 0, onp.nan, UNIT)
                            .astype(onp.float32)], dict(axis=2)),
    "dot_nd": ("dot", [A, N[:5]], {}),
    "dot_transpose_a": ("dot", [M, M], dict(transpose_a=True)),
    "batch_dot": ("batch_dot", [A, B], dict(transpose_b=True)),
    "matmul": ("matmul", [M, N], {}),
    "tensordot": ("tensordot", [A, B], dict(axes=((1, 2), (1, 2)))),
    "kron": ("kron", [M[:2, :2], N[:2]], {}),
    "outer": ("outer", [V, V], {}),
    "inner": ("inner", [M, M], {}),
    "khatri_rao": ("khatri_rao", [M[:2, :3], N[:4]], {}),
    "smooth_l1": ("smooth_l1", [A], dict(scalar=1.5)),
    "hypot": ("hypot", [A, B], {}),
    "arctan2": ("arctan2", [A, B], {}),
    "logical_and": ("logical_and", [COND, (A > 0).astype(onp.float32)],
                    {}),
    "logical_xor": ("logical_xor", [COND, (A > 0).astype(onp.float32)],
                    {}),
    "full_like": ("full_like", [A], dict(fill_value=2.5)),
    "shape_array": ("shape_array", [A], {}),
    "size_array": ("size_array", [A], {}),
    "SequenceMask": ("SequenceMask", [SEQ, LENS],
                     dict(use_sequence_length=True, value=-1.0)),
    "SequenceLast": ("SequenceLast", [SEQ, LENS],
                     dict(use_sequence_length=True)),
    "SequenceReverse": ("SequenceReverse", [SEQ, LENS],
                        dict(use_sequence_length=True)),
    "L2Normalization": ("L2Normalization", [IMG], dict(mode="channel")),
    "InstanceNorm": ("InstanceNorm", [IMG, _f(8), _f(8)], dict(eps=1e-3)),
    "GroupNorm": ("GroupNorm", [IMG, _f(8), _f(8)], dict(num_groups=4)),
    "LeakyReLU": ("LeakyReLU", [A], dict(act_type="leaky", slope=0.1)),
    "LeakyReLU_prelu": ("LeakyReLU", [IMG, _f(8)], dict(act_type="prelu")),
    "LeakyReLU_elu": ("LeakyReLU", [A], dict(act_type="elu", slope=0.7)),
    "LeakyReLU_selu": ("LeakyReLU", [A], dict(act_type="selu")),
}

UNARY = ["sign", "rint", "round", "ceil", "floor", "trunc", "fix", "rsqrt",
         "cbrt", "rcbrt", "expm1", "log10", "log2", "log1p", "sin", "cos",
         "tan", "arcsin", "arccos", "arctan", "sinh", "cosh", "arcsinh",
         "arccosh", "arctanh", "degrees", "radians", "erf", "erfinv",
         "gamma", "gammaln", "digamma", "reciprocal", "logical_not",
         "softsign", "isnan", "isinf", "isfinite"]
# the domain each needs
_DOMAIN = {"rsqrt": POS, "log10": POS, "log2": POS, "log1p": POS,
           "arcsin": UNIT, "arccos": UNIT, "arctanh": UNIT, "erfinv": UNIT,
           "arccosh": POS + 1.0, "gamma": POS, "gammaln": POS,
           "digamma": POS, "reciprocal": POS, "rcbrt": POS}
# rounding ops at halves on purpose
HALVES = (onp.arange(-8, 8, dtype=onp.float32) / 2).reshape(4, 4)


def _check(got, ref, name, elementwise=False):
    if isinstance(ref, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(ref), name
        for i, (g, r) in enumerate(zip(got, ref)):
            _check(g, r, (name, i), elementwise)
        return
    g, r = got.asnumpy(), ref.asnumpy()
    assert g.shape == r.shape, (name, g.shape, r.shape)
    assert g.dtype == r.dtype, (name, g.dtype, r.dtype)
    if not onp.issubdtype(r.dtype, onp.floating):
        assert onp.array_equal(g, r), name
        return
    assert onp.array_equal(onp.isnan(g), onp.isnan(r)), name
    g, r = g[~onp.isnan(r)].astype(onp.float64), \
        r[~onp.isnan(r)].astype(onp.float64)
    scale = float(onp.abs(r).max()) if r.size else 0.0
    bound = 1e-6 * (onp.abs(r) + scale) if elementwise else 1e-6 * scale
    err = onp.abs(g - r)
    assert onp.all(err <= bound + 1e-30), (name, float(err.max()))


def _both(op, inputs, params):
    ref = getattr(mx.nd, op)(*[mx.nd.array(a, dtype=a.dtype)
                               for a in inputs], **params)
    with mt.cpu():
        got = getattr(mt.nd, op)(*[mt.nd.array(a, dtype=a.dtype)
                                   for a in inputs], **params)
    return got, ref


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_the_reference(name):
    op, inputs, params = CASES[name]
    got, ref = _both(op, inputs, params)
    _check(got, ref, name)


@pytest.mark.parametrize("op", UNARY)
def test_unary_op_matches_the_reference(op):
    x = HALVES if op in ("rint", "round", "fix", "trunc") else \
        _DOMAIN.get(op, A)
    got, ref = _both(op, [x], {})
    _check(got, ref, op, elementwise=True)


# name -> (method, args, kwargs) on NDArrays made from the first input
METHODS = {
    "T": ("T", None, None),
    "transpose": ("transpose", (2, 0, 1), {}),
    "transpose_tuple": ("transpose", ((1, 2, 0),), {}),
    "argmax": ("argmax", (), dict(axis=2)),
    "argmin": ("argmin", (), {}),
    "clip": ("clip", (-1.0, 0.5), {}),
    "expand_dims": ("expand_dims", (0,), {}),
    "flatten": ("flatten", (), {}),
    "one_hot": ("one_hot", (4,), {}),
    "topk": ("topk", (), dict(k=2, axis=1)),
    "split": ("split", (2,), dict(axis=1)),
    "tile": ("tile", ((1, 2, 1),), {}),
    "repeat": ("repeat", (2,), dict(axis=0)),
    "sort": ("sort", (), dict(axis=1)),
    "argsort": ("argsort", (), dict(axis=1, is_ascend=False)),
    "norm": ("norm", (), {}),
    "prod": ("prod", (), dict(axis=1)),
    "swapaxes": ("swapaxes", (0, 1), {}),
    "squeeze": ("squeeze", (), {}),
    "flip": ("flip", (0,), {}),
    "slice_axis": ("slice_axis", (1, 0, 2), {}),
    "softmax": ("softmax", (), {}),
    "log_softmax": ("log_softmax", (), dict(axis=1)),
    "round": ("round", (), {}),
    "floor": ("floor", (), {}),
    "broadcast_to": ("broadcast_to", ((2, 3, 4, 5),), {}),
    "pad": ("pad", (), dict(mode="constant",
                            pad_width=(0, 0, 0, 0, 1, 1, 2, 2))),
}


def _method_input(name):
    if name in ("one_hot",):
        return onp.abs(IDX) % 4
    if name in ("topk", "sort", "argsort"):
        return _distinct(3, 4, 5)
    if name == "pad":
        return IMG
    return A


@pytest.mark.parametrize("name", sorted(METHODS))
def test_ndarray_method_matches_the_reference(name):
    method, args, kw = METHODS[name]
    x = _method_input(name)
    ref_x = mx.nd.array(x)
    with mt.cpu():
        got_x = mt.nd.array(x)
        if args is None:
            got = getattr(got_x, method)
        else:
            got = getattr(got_x, method)(*args, **kw)
    ref = getattr(ref_x, method) if args is None else \
        getattr(ref_x, method)(*args, **kw)
    _check(got, ref, name)


def test_dot_and_matmul_methods_match_the_reference():
    with mt.cpu():
        a, b = mt.nd.array(M), mt.nd.array(N)
        got = [a.dot(b), a @ b, a.dot(a, transpose_b=True)]
        got_nd = [mt.nd.concat(a, a, dim=0), mt.nd.stack(a, a, axis=2)]
    ja, jb = mx.nd.array(M), mx.nd.array(N)
    ref = [ja.dot(jb), ja @ jb, ja.dot(ja, transpose_b=True)]
    ref_nd = [mx.nd.concat(ja, ja, dim=0), mx.nd.stack(ja, ja, axis=2)]
    for i, (g, r) in enumerate(zip(got + got_nd, ref + ref_nd)):
        _check(g, r, i)


def test_new_ops_differentiate_as_the_reference():
    """A chain of the zoo's ops (concat, clip, transpose, split, take,
    where) under autograd: the input's gradient against the reference's."""
    idx = onp.array([2, 0, 1], onp.float32)

    def chain(nd, x):
        y = nd.concat(x, x * 2, dim=1).clip(-1.0, 1.5)
        y = nd.transpose(y, axes=(1, 0, 2))
        a, b = nd.split(y, num_outputs=2, axis=0)
        z = nd.take(a * b, nd.array(idx), axis=1)
        return nd.where(z > 0, z, z * 0.5)

    def grad(pkg, nd, ctx=None):
        x = nd.array(A) if ctx is None else nd.array(A, ctx=ctx)
        x.attach_grad()
        with pkg.autograd.record():
            y = chain(nd, x)
        y.backward(nd.ones(y.shape) if ctx is None
                   else nd.ones(y.shape, ctx=ctx))
        return y, x.grad

    ref = grad(mx, mx.nd)
    with mt.cpu():
        got = grad(mt, mt.nd, mt.cpu())
    for i, (g, r) in enumerate(zip(got, ref)):
        _check(g, r, i)
