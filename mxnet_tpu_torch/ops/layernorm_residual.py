"""Fused ``LayerNorm(x + residual)`` over the last axis — plain PyTorch
version, CUDA C++ kernel (K6), and the wrapper that picks between them
by the tensor's device.

Replaces the TPU kernel ``mxnet_tpu/ops/layernorm_residual.py``
``_lnr_kernel`` (reached through ``_lnr_pallas``) with
``csrc/layernorm_residual.cu``, built by nvcc into a shared library with
a C interface and called through ``ctypes``.  The source's head comment
gives the design; in short: one warp per row with the row in registers
(a block per row above 1024 features), statistics in f32 by warp
shuffles, 16-byte loads where the row allows them.

What bounds it on an H100: bytes — x and residual read once, the output
written once; gamma and beta are F floats.

Backward: as in the reference, which takes the vjp of its unfused
lowering outside any kernel (``mxnet_tpu/ops/layernorm_residual.py:91``),
the gradients are plain PyTorch in f32 (:func:`_lnr_backward`); there is
no backward kernel.  Unlike the reference (``:173-177``), a CUDA call
never falls back to the plain version: it launches K6 or raises.  The
forward is a torch custom op (``mxnet_tpu_torch::layer_norm_residual``)
inside the ``torch.autograd.Function``, so that ``torch.export`` keeps
it as one node.
"""
import ctypes

import torch

from .. import kernels as _kernels
from ..base import MXNetError
from .attention import _pow2_bucket
from .registry import register

__all__ = ["layer_norm_residual", "layer_norm_residual_reference",
           "layer_norm_residual_op", "build"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ROWS_PER_BLOCK = (2, 4, 8, 16)      # warps (one per row) per block


def layer_norm_residual_reference(x, residual, gamma, beta, eps=1e-5):
    """The plain version (the reference's ``_lnr_reference``): f32 sum,
    mean, variance as the mean of squared deviations, ``rsqrt(var+eps)``,
    affine, cast to ``x.dtype``."""
    y = x.float() + residual.float()
    mean = y.mean(-1, keepdim=True)
    var = (y - mean).square().mean(-1, keepdim=True)
    yn = (y - mean) * torch.rsqrt(var + eps)
    out = yn * gamma.float() + beta.float()
    return out.to(x.dtype)


def _lnr_backward(x, residual, gamma, beta, eps, dout):
    """Gradients of :func:`layer_norm_residual_reference` from the saved
    inputs, in f32, each cast to its input's dtype: ``(dx, dresidual,
    dgamma, dbeta)`` with dx = dresidual."""
    f = x.shape[-1]
    y = (x.float() + residual.float()).reshape(-1, f)
    mean = y.mean(-1, keepdim=True)
    rstd = torch.rsqrt((y - mean).square().mean(-1, keepdim=True) + eps)
    yn = (y - mean) * rstd
    g = dout.reshape(-1, f).float()
    dbeta = g.sum(0)
    dgamma = (g * yn).sum(0)
    dyn = g * gamma.float()
    dy = rstd * (dyn - dyn.mean(-1, keepdim=True)
                 - yn * (dyn * yn).mean(-1, keepdim=True))
    dy = dy.reshape(x.shape)
    return (dy.to(x.dtype), dy.to(residual.dtype),
            dgamma.reshape(gamma.shape).to(gamma.dtype),
            dbeta.reshape(beta.shape).to(beta.dtype))


def _library():
    from ..kernels.build import build_library
    lib = build_library("layernorm_residual")[0]
    fn = lib.mx_layer_norm_residual
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x2, r2, g32, b32, eps, rows_per_block):
    """K6 on 2-D ``(rows, F)`` tensors on the caller's current stream;
    no counting (the wrapper counts)."""
    dev = x2.device
    if dev.type != "cuda":
        raise MXNetError(f"layer_norm_residual kernel needs CUDA tensors, "
                         f"got {dev}")
    rows, f = x2.shape
    for name, t in (("residual", r2), ("gamma", g32), ("beta", b32)):
        if t.device != dev:
            raise MXNetError(f"layer_norm_residual: {name} on {t.device}, "
                             f"x on {dev}")
    if x2.dtype not in _DTYPE_CODE or r2.dtype not in _DTYPE_CODE:
        raise MXNetError(f"layer_norm_residual kernel takes float32, "
                         f"bfloat16 or float16, got {x2.dtype} and "
                         f"{r2.dtype}")
    if tuple(r2.shape) != (rows, f) or tuple(g32.shape) != (f,) \
            or tuple(b32.shape) != (f,):
        raise MXNetError(f"layer_norm_residual: x and residual (rows, F), "
                         f"gamma and beta (F,) expected, got "
                         f"{tuple(x2.shape)}, {tuple(r2.shape)}, "
                         f"{tuple(g32.shape)}, {tuple(b32.shape)}")
    if g32.dtype != torch.float32 or b32.dtype != torch.float32:
        raise MXNetError("layer_norm_residual: the kernel takes float32 "
                         "gamma and beta")
    if not all(t.is_contiguous() for t in (x2, r2, g32, b32)):
        raise MXNetError("layer_norm_residual: inputs must be contiguous")
    if not 0 < rows < 2 ** 31 or not 0 < f < 2 ** 31:
        raise MXNetError(f"layer_norm_residual: rows {rows} and F {f} must "
                         f"lie in [1, 2**31)")
    if int(rows_per_block) not in _ROWS_PER_BLOCK:
        raise MXNetError(f"layer_norm_residual: rows_per_block must be in "
                         f"{_ROWS_PER_BLOCK}, got {rows_per_block}")
    out = torch.empty_like(x2)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.mx_layer_norm_residual(
            x2.data_ptr(), _DTYPE_CODE[x2.dtype], r2.data_ptr(),
            _DTYPE_CODE[r2.dtype], g32.data_ptr(), b32.data_ptr(),
            out.data_ptr(), rows, f, float(eps), int(rows_per_block),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise MXNetError(f"layer_norm_residual launch failed: "
                         f"{lib.mx_cuda_error_string(err).decode()}")
    return out


def _lnr_cuda(x, residual, gamma, beta, eps, rows_per_block):
    """K6 on ``(..., F)`` CUDA tensors: flattened to rows, gamma and beta
    as f32; counts one launch."""
    f = x.shape[-1]
    if x.numel() == 0:
        return torch.empty_like(x)
    out = _launch(x.reshape(-1, f).contiguous(),
                  residual.reshape(-1, f).contiguous(),
                  gamma.reshape(-1).float().contiguous(),
                  beta.reshape(-1).float().contiguous(), eps,
                  rows_per_block)
    layer_norm_residual.launches += 1
    return out.reshape(x.shape)


def _forward(x, residual, gamma, beta, eps, rows_per_block):
    if x.device.type == "cpu":
        layer_norm_residual.plain_calls += 1
        return layer_norm_residual_reference(x, residual, gamma, beta, eps)
    return _lnr_cuda(x, residual, gamma, beta, eps, rows_per_block)


@torch.library.custom_op("mxnet_tpu_torch::layer_norm_residual",
                         mutates_args=())
def layer_norm_residual_op(x: torch.Tensor, residual: torch.Tensor,
                           gamma: torch.Tensor, beta: torch.Tensor,
                           eps: float, rows_per_block: int) -> torch.Tensor:
    """K6 as a torch custom op (the counterpart of the reference's
    ``custom_vjp``): the kernel on a card, the plain version on the CPU;
    ``rows_per_block`` 0 takes the kernel registry's config for the
    shape, resolved when the op runs.  ``torch.export`` keeps it as one
    named node.  Its gradient is :class:`_LayerNormResidual`'s."""
    if x.device.type != "cpu" and not rows_per_block:
        sig, dt = _lnr_signature(x, residual, gamma, beta)
        rows_per_block = _kernels.resolve(
            "layer_norm_residual", sig, dt,
            tune_args=((x, residual, gamma, beta),
                       {"eps": eps}))["rows_per_block"]
    return _forward(x, residual, gamma, beta, eps, rows_per_block)


@layer_norm_residual_op.register_fake
def _lnr_op_fake(x, residual, gamma, beta, eps, rows_per_block):
    return torch.empty_like(x)


class _LayerNormResidual(torch.autograd.Function):
    """Counterpart of the reference's ``custom_vjp``: the forward is K6's
    custom op and saves its inputs; the backward is :func:`_lnr_backward`.
    (The op's own autograd registration would cost each eager call some
    0.35 ms of host time more: ``tools/custom_op_cost.py``.)"""

    @staticmethod
    def forward(ctx, x, residual, gamma, beta, eps, rows_per_block):
        ctx.save_for_backward(x, residual, gamma, beta)
        ctx.eps = eps
        return layer_norm_residual_op(x, residual, gamma, beta, eps,
                                      rows_per_block)

    @staticmethod
    def backward(ctx, dout):
        x, residual, gamma, beta = ctx.saved_tensors
        return (*_lnr_backward(x, residual, gamma, beta, ctx.eps, dout),
                None, None)


def build(device="cuda"):
    """Compile and load the library ahead of traffic and launch it once
    on a small input (not counted in ``layer_norm_residual.launches``).
    Returns ``(nvcc output, build seconds)``."""
    from ..kernels.build import build_library
    _, log, seconds = build_library("layernorm_residual")
    x = torch.zeros((2, 64), device=device)
    g = torch.ones((64,), device=device)
    _launch(x, x, g, g, 1e-5, _ROWS_PER_BLOCK[0])
    torch.cuda.synchronize(device)
    return log, seconds


# -- kernel-registry integration -------------------------------------------

def _lnr_signature(x, residual, gamma, beta, eps=1e-5):
    """Rows bucket to the next power of two ≥ 8; F keys exactly."""
    rows = x.numel() // max(x.shape[-1], 1)
    return (f"rows{_pow2_bucket(rows, floor=8)}_f{x.shape[-1]}",
            str(x.dtype).replace("torch.", ""))


def _lnr_kernel_run(config, x, residual, gamma, beta, eps=1e-5):
    return _lnr_cuda(x, residual, gamma, beta, float(eps),
                     config["rows_per_block"])


def _lnr_kernel_fallback(x, residual, gamma, beta, eps=1e-5):
    return layer_norm_residual_reference(x, residual, gamma, beta,
                                         float(eps))


def _lnr_make_args(case):
    import numpy as onp
    rng = onp.random.RandomState(13)
    rows, f = case["rows"], case["f"]
    dev = case.get("device", "cuda")
    dtype = getattr(torch, case.get("dtype", "float32"))

    def t(a, dt=dtype):
        return torch.as_tensor(a).to(dev, dt)

    return (t(rng.randn(rows, f)), t(rng.randn(rows, f)),
            t(rng.rand(f) + 0.5, torch.float32),
            t(rng.randn(f) * 0.1, torch.float32)), {}


_kernels.register_kernel(_kernels.KernelSpec(
    "layer_norm_residual", version=1,
    run=_lnr_kernel_run, fallback=_lnr_kernel_fallback,
    config_space={"rows_per_block": _ROWS_PER_BLOCK},
    default_config={"rows_per_block": 8},
    signature=_lnr_signature, make_args=_lnr_make_args,
    tune_grid=({"rows": 16384, "f": 512, "dtype": "bfloat16"},
               {"rows": 16384, "f": 512}),
))


@register("layer_norm_residual", aliases=("_npx_layer_norm_residual",))
def layer_norm_residual(x, residual, gamma, beta, *, eps=1e-5,
                        use_pallas=True):
    """``LayerNorm(x + residual)`` over the last axis, fused.

    Shapes: ``x``/``residual`` (..., F) in any float dtype each (the
    output has x's), ``gamma``/``beta`` (F,).  CPU tensors take
    :func:`layer_norm_residual_reference` (``plain_calls``); CUDA tensors
    launch K6 on the current stream (``launches``) with the kernel
    registry's rows per block, or raise.  ``use_pallas=False`` (the
    reference's keyword) asks for the plain version explicitly."""
    if x.shape != residual.shape:
        raise MXNetError(f"x {tuple(x.shape)} and residual "
                         f"{tuple(residual.shape)} must match")
    if not use_pallas:
        layer_norm_residual.plain_calls += 1
        return layer_norm_residual_reference(x, residual, gamma, beta, eps)
    return _LayerNormResidual.apply(x, residual, gamma, beta, float(eps), 0)


layer_norm_residual.launches = 0
layer_norm_residual.plain_calls = 0
