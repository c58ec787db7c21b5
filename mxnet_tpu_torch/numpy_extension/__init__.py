"""``mx.npx`` — the numpy extensions (counterpart of
``mxnet_tpu/numpy_extension/__init__.py``): the nn and extension ops
under their numpy names (``_NPX_OPS``, each the registered op through
the funnel), the ``set_np`` family, control flow, and the hand-written
kernels by their ``_npx_`` names: ``npx.flash_attention`` (K1–K3),
``npx.rope`` (K5) and ``npx.paged_attention`` (K4).

The detection ops (``box_iou``, ``box_nms``, ``multibox_*``,
``roi_align``), ``deconvolution`` and ``arange_like`` are ops the port
does not have yet: their names raise ``MXNetError`` saying so.
"""
from __future__ import annotations

from ..base import MXNetError
from ..context import cpu, gpu, num_gpus, current_context  # noqa: F401
from ..ndarray.register import make_op_func as _make
from ..ops import registry as _reg
from ..util import (set_np, reset_np, is_np_array, is_np_shape,  # noqa: F401
                    use_np)

# nn / extension ops under their npx names (the reference's table)
_NPX_OPS = {
    "activation": "Activation",
    "batch_norm": "BatchNorm",
    "convolution": "Convolution",
    "deconvolution": "Deconvolution",
    "fully_connected": "FullyConnected",
    "pooling": "Pooling",
    "dropout": "Dropout",
    "embedding": "Embedding",
    "layer_norm": "LayerNorm",
    "group_norm": "GroupNorm",
    "instance_norm": "InstanceNorm",
    "leaky_relu": "LeakyReLU",
    "softmax": "softmax",
    "log_softmax": "log_softmax",
    "masked_softmax": "masked_softmax",
    "masked_log_softmax": "masked_log_softmax",
    "topk": "topk",
    "pick": "pick",
    "one_hot": "one_hot",
    "rnn": "RNN",
    "batch_dot": "batch_dot",
    "sequence_mask": "SequenceMask",
    "smooth_l1": "smooth_l1",
    "gamma": "gamma",
    "reshape_like": None,
    "broadcast_like": "broadcast_like",
    "arange_like": "arange_like",
    "shape_array": "shape_array",
    "gather_nd": "gather_nd",
    "scatter_nd": "scatter_nd",
    "slice": "slice",
    "slice_axis": "slice_axis",
    "slice_like": "slice_like",
    "ctc_loss": "CTCLoss",
    "sigmoid": "sigmoid",
    "relu": "relu",
    "batch_flatten": "Flatten",
    "multibox_prior": "MultiBoxPrior",
    "multibox_target": "MultiBoxTarget",
    "multibox_detection": "MultiBoxDetection",
    "box_iou": "box_iou",
    "box_nms": "box_nms",
    "roi_align": "ROIAlign",
    "index_add": "_npx_index_add",
    "index_update": "_npx_index_update",
    # the port's kernels by their ``_npx_`` names
    "flash_attention": "_npx_flash_attention",
    "multi_head_attention": "_npx_multi_head_attention",
    "rope": "_npx_rope",
    "paged_attention": "_npx_paged_attention",
}


def _not_ported(npx_name, op_name):
    def f(*args, **kwargs):
        raise MXNetError(f"npx.{npx_name}: the op {op_name!r} is not "
                         f"ported yet (ROADMAP, queue 1)")
    f.__name__ = npx_name
    return f


for _npx_name, _op_name in _NPX_OPS.items():
    if _op_name is None:
        continue
    globals()[_npx_name] = (_make(_op_name) if _op_name in _reg._REGISTRY
                            else _not_ported(_npx_name, _op_name))


def reshape_like(a, b):
    return a.reshape(b.shape)


def tpu(device_id=0):
    """The reference's accelerator context: the port has none."""
    raise MXNetError("npx.tpu: the port runs on CUDA cards; use npx.gpu()")


def num_tpus():
    return 0


def waitall():
    from ..ndarray import waitall as _w
    _w()


def load(fname):
    from ..ndarray import load as _l
    return _l(fname)


def save(fname, data):
    from ..ndarray import save as _s
    return _s(fname, data)


def seed(seed_state):
    """``npx.random`` seeding: ``mx.random.seed``."""
    from ..ops.random import seed as _seed
    _seed(seed_state)


# control flow (the reference's ``_foreach`` / ``_while_loop`` / ``_cond``):
# PyTorch runs eagerly, so each is a Python loop of op calls, recorded by
# autograd like any other ops

def _as_list(x):
    return (list(x), False) if isinstance(x, (list, tuple)) else ([x], True)


def _stack(outs):
    from ..ndarray.ndarray import stack
    return stack(*outs, axis=0)


def foreach(body, data, init_states):
    """``body(data_t, states) -> (outputs, new_states)`` over axis 0 of
    ``data``; returns (the outputs stacked, the final states)."""
    data_list, data_single = _as_list(data)
    states, states_single = _as_list(init_states)
    steps = []
    for t in range(data_list[0].shape[0]):
        d = [x[t] for x in data_list]
        out, new = body(d[0] if data_single else d,
                        states[0] if states_single else list(states))
        steps.append(_as_list(out))
        states, _ = _as_list(new)
    outs_single = steps[0][1] if steps else True
    outs = [_stack([s[0][i] for s in steps])
            for i in range(len(steps[0][0]))] if steps else []
    return (outs[0] if outs_single and outs else outs,
            states[0] if states_single else list(states))


def while_loop(cond, func, loop_vars, max_iterations=None):
    """``func(*vars) -> (output, new_vars)`` while ``cond(*vars)``, at
    most ``max_iterations`` times; returns (the outputs stacked, the
    final vars).  The outputs of iterations not run are dropped."""
    if max_iterations is None:
        raise MXNetError("while_loop requires max_iterations")
    vars_, single = _as_list(loop_vars)
    steps = []
    for _ in range(int(max_iterations)):
        if not bool(cond(*vars_)):
            break
        out, new = func(*vars_)
        steps.append(_as_list(out)[0])
        vars_, _ = _as_list(new)
    outs = [_stack([s[i] for s in steps]) for i in range(len(steps[0]))] \
        if steps else []
    return (outs[0] if len(outs) == 1 else outs,
            vars_[0] if single else vars_)


def cond(pred, then_func, else_func):
    """``then_func()`` when ``pred`` holds, else ``else_func()``."""
    return then_func() if bool(pred) else else_func()
