"""Flash attention: plain PyTorch versions, the three CUDA C++ kernels
(forward K1, backward K2 and K3), K1 as a torch custom op
(``mxnet_tpu_torch::flash_attention``, which ``torch.export`` keeps as
one node), the ``torch.autograd.Function`` that ties it to K2 and K3,
and the multi-head attention op the transformer calls (counterpart of ``mxnet_tpu/ops/attention.py``).

Replaces the TPU kernels ``_fa_fwd_kernel`` (K1, reached through
``_fa_forward_pallas``), ``_fa_bwd_dkdv_kernel`` (K2) and
``_fa_bwd_dq_kernel`` (K3, both reached through ``_fa_backward_pallas``)
of ``mxnet_tpu/ops/attention.py`` with ``csrc/flash_attention.cu``,
built by nvcc into a shared library with a C interface and called
through ``ctypes``.  The source's head comment gives the design; in
short: one block per (bh, q tile) for K1 and K3, one per (bh, k tile)
for K2, each looping inside itself over the other axis (up to or from
the diagonal when causal) with f32 accumulators, masking ragged edges
itself instead of padding.  In bf16 all three run their products on the
tensor cores: K1 on ``wgmma`` with TMA loads and warp specialisation
(a producer warpgroup, two consumer warpgroups of 64 query rows, 128
keys a stage), K2 and K3 on ``mma.sync``, forming their products with
an f32 operand (P or dS) as three bf16 passes, hi + mid + lo
(:func:`split_bf16x3`), which keeps the reference's f32 products exact.
In f32 they run on the FMA units.  The registry's ``tile`` config
selects K2's and K3's tile (and the f32 K1's); the bf16 K1 has its own
tiling.  :func:`flash_forward_blocked` is the reference kernel's blocked
recurrence in plain PyTorch, for the tests.

What bounds them on an H100: operations.  The score and probability
tiles never leave the chip, so each kernel moves O(S·D) bytes per head
against O(S²·D) flops.

Each kernel has a wrapper that counts its launches (``.launches``) and
the calls that took its plain version (``.plain_calls``): CPU tensors
take the plain version, CUDA tensors launch the kernel or raise.

Tensors are (BH, S, D) inside and (B, H, S, D) at :func:`flash_attention`
and :func:`attention_reference`, as in the reference.
"""
import ctypes
import math
from typing import Tuple

import torch

from .. import kernels as _kernels
from ..base import MXNetError
from .registry import register

__all__ = ["flash_attention", "attention_reference", "flash_fwd",
           "flash_bwd_dkdv", "flash_bwd_dq", "flash_forward_reference",
           "flash_forward_blocked", "flash_backward_reference",
           "split_bf16x3", "split_heads", "merge_heads",
           "multi_head_attention", "flash_attention_op", "build"]

_NEG_INF = -1e30            # finite -inf stand-in: keeps masked rows NaN-free
_HEAD_DIMS = (64, 128)      # instantiated in csrc/flash_attention.cu
_TILES = (32, 64)           # square tiles instantiated there


# -- plain versions ----------------------------------------------------------

def _scores(q, k, scale):
    """q·kᵀ in f32 from the input type (bf16 products are exact in f32),
    then the scale — the reference's ``preferred_element_type=f32``."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def _mask(sq, sk, causal, device):
    """Top-left causal mask ``qpos >= kpos`` (None when not causal)."""
    if not causal:
        return None
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    return qpos >= kpos


def attention_reference(q, k, v, causal=False, sm_scale=None):
    """Plain softmax(QKᵀ)V on (B, H, S, D) tensors, the scores in f32."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    s = _scores(q, k, scale)
    mask = _mask(q.shape[-2], k.shape[-2], causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(v.dtype), v)


def flash_forward_reference(q, k, v, causal=False, sm_scale=None):
    """K1's plain version on (BH, S, D): ``(out in q's type, lse (BH, Sq)
    f32)``, p rounded to v's type before p·v as in the kernel."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    s = _scores(q, k, scale)
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_forward_blocked(q, k, v, causal=False, scale=None, block_k=128):
    """The reference kernel's recurrence on (BH, S, D), key block by key
    block: s in f32, an online softmax with f32 m / l (m seeded with
    -1e30), p rounded to v's type against the running max before p·v, l
    summed from the f32 p.  ``(out in q's type, lse (BH, Sq) f32)``.
    Not on any path: it models what K1 computes, for the tests."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    bh, sq, d = q.shape
    m = torch.full((bh, sq, 1), _NEG_INF, device=q.device)
    l = torch.zeros((bh, sq, 1), device=q.device)
    acc = torch.zeros((bh, sq, d), device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, k.shape[1], block_k):
        kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
        s = _scores(q, kb, scale)
        if causal:
            kpos = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, _NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vb.float())
        m = m_cur
    l = torch.where(l == 0.0, 1.0, l)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def _bwd_probs(q, k, v, do, lse, delta, causal, scale):
    """P = exp(s - lse) (0 where masked) and dS = P∘(dP - delta)·scale,
    both f32, with dP = dO·Vᵀ formed in f32."""
    s = _scores(q, k, scale)
    p = torch.exp(s - lse[..., None])
    mask = _mask(q.shape[1], k.shape[1], causal, q.device)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - delta[..., None]) * scale


def _dkdv_f32(q, k, v, do, lse, delta, causal, scale):
    """K2's plain products in f32, before rounding: ``(dk, dv)``."""
    p, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    return (torch.matmul(ds.transpose(-1, -2), q.float()),
            torch.matmul(p.transpose(-1, -2), do.float()))


def _dkdv_reference(q, k, v, do, lse, delta, causal, scale):
    """K2's plain version: ``(dk, dv)`` in k's / v's types."""
    dk, dv = _dkdv_f32(q, k, v, do, lse, delta, causal, scale)
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq_f32(q, k, v, do, lse, delta, causal, scale):
    """K3's plain product in f32, before rounding."""
    _, ds = _bwd_probs(q, k, v, do, lse, delta, causal, scale)
    return torch.matmul(ds, k.float())


def _dq_reference(q, k, v, do, lse, delta, causal, scale):
    """K3's plain version: ``dq`` in q's type."""
    return _dq_f32(q, k, v, do, lse, delta, causal, scale).to(q.dtype)


def split_bf16x3(t):
    """An f32 tensor as three bf16 tensors with ``hi + mid + lo == t``
    exactly: the operand split of the bf16 K2 / K3, which multiply P and
    dS by a bf16 operand in three bf16 tensor-core passes accumulated in
    f32.  An f32 has 24 significant bits and each rounding to nearest
    leaves a remainder of at most 8 more (plus its sign), so three terms
    hold them all and the three products sum to the f32 product.  Not on
    any path: it documents the kernels' arithmetic for the tests."""
    t = t.float()
    hi = t.to(torch.bfloat16)
    rest = t - hi.float()                 # exact: hi is t rounded
    mid = rest.to(torch.bfloat16)
    return hi, mid, (rest - mid.float()).to(torch.bfloat16)


def _delta(do, out):
    """rowsum(dO∘O) in f32, (BH, Sq): computed outside the kernels, as the
    reference computes it outside its Pallas calls."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_backward_reference(q, k, v, out, lse, do, causal=False,
                             sm_scale=None):
    """The plain flash backward from the saved residuals (counterpart of
    the reference's ``_fa_backward``): ``(dq, dk, dv)``."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(
        q.shape[-1])
    delta = _delta(do, out)
    dk, dv = _dkdv_reference(q, k, v, do, lse, delta, causal, scale)
    return _dq_reference(q, k, v, do, lse, delta, causal, scale), dk, dv


# -- the CUDA library ----------------------------------------------------------

def _library():
    from ..kernels.build import build_library
    lib = build_library("flash_attention")[0]
    if lib.mx_flash_fwd.argtypes is None:
        tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        lib.mx_flash_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        lib.mx_flash_bwd_dkdv.argtypes = [ctypes.c_void_p] * 8 + tail
        lib.mx_flash_bwd_dq.argtypes = [ctypes.c_void_p] * 7 + tail
        for fn in (lib.mx_flash_fwd, lib.mx_flash_bwd_dkdv,
                   lib.mx_flash_bwd_dq):
            fn.restype = ctypes.c_int
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, q, k, v, tile, extra=()):
    dev = q.device
    if dev.type != "cuda":
        raise MXNetError(f"{name} kernel needs CUDA tensors, got {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError(f"{name}: q must be float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape \
            or q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise MXNetError(f"{name}: q (BH, Sq, D), k and v (BH, Sk, D) "
                         f"expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, sq, d = q.shape
    if d not in _HEAD_DIMS or int(tile) not in _TILES:
        raise MXNetError(f"{name} kernel is built for head_dim in "
                         f"{_HEAD_DIMS} and tiles in {_TILES}, got {d}, "
                         f"{tile}")
    if not 0 < bh <= 65535 or sq <= 0 or k.shape[1] <= 0:
        raise MXNetError(f"{name}: empty or too many heads: "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    for tname, t, dtype in (("k", k, q.dtype), ("v", v, q.dtype)) + extra:
        if t.device != dev:
            raise MXNetError(f"{name}: {tname} on {t.device}, q on {dev}")
        if t.dtype != dtype:
            raise MXNetError(f"{name}: {tname} is {t.dtype}, expected "
                             f"{dtype}")
    for tname, t in (("q", q), ("k", k), ("v", v)) + tuple(
            (e[0], e[1]) for e in extra):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise MXNetError(f"{name}: {tname} must be contiguous and "
                             f"16-byte aligned")


def _raise_if(err, lib, name):
    if err:
        raise MXNetError(f"{name} launch failed: "
                         f"{lib.mx_cuda_error_string(err).decode()}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(q, k, v, causal, scale, tile):
    _check("flash_fwd", q, k, v, tile)
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.mx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), int(q.dtype == torch.bfloat16), bh, sq,
            k.shape[1], d, int(bool(causal)), float(scale), int(tile),
            _stream(q))
    _raise_if(err, lib, "flash_fwd")
    return out, lse


def _bwd_extra(q, do, lse, delta):
    f32 = torch.float32
    if tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != tuple(q.shape[:2]) \
            or tuple(delta.shape) != tuple(q.shape[:2]):
        raise MXNetError(f"flash backward: do {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)}, delta {tuple(delta.shape)} "
                         f"do not match q {tuple(q.shape)}")
    return (("do", do, q.dtype), ("lse", lse, f32), ("delta", delta, f32))


def _launch_dkdv(q, k, v, do, lse, delta, causal, scale, tile):
    _check("flash_bwd_dkdv", q, k, v, tile, _bwd_extra(q, do, lse, delta))
    bh, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.mx_flash_bwd_dkdv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(q.dtype == torch.bfloat16), bh, sq, k.shape[1], d,
            int(bool(causal)), float(scale), int(tile), _stream(q))
    _raise_if(err, lib, "flash_bwd_dkdv")
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, causal, scale, tile):
    _check("flash_bwd_dq", q, k, v, tile, _bwd_extra(q, do, lse, delta))
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.mx_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            int(q.dtype == torch.bfloat16), bh, sq, k.shape[1], d,
            int(bool(causal)), float(scale), int(tile), _stream(q))
    _raise_if(err, lib, "flash_bwd_dq")
    return dq


# -- the three kernel wrappers -----------------------------------------------

def _scale_of(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def flash_fwd(q, k, v, *, causal=False, sm_scale=None, tile=64):
    """K1 on (BH, S, D): ``(out, lse)``.  CPU tensors take
    :func:`flash_forward_reference`; CUDA tensors launch the kernel.
    ``tile`` selects the f32 kernel's square tile; the bf16 kernel has
    its own tiling (128 query rows, 128 keys a stage) and ignores it."""
    scale = _scale_of(q, sm_scale)
    if q.device.type == "cpu":
        flash_fwd.plain_calls += 1
        return flash_forward_reference(q, k, v, causal, scale)
    out = _launch_fwd(q, k, v, causal, scale, tile)
    flash_fwd.launches += 1
    return out


def flash_bwd_dkdv(q, k, v, do, lse, delta, *, causal=False, sm_scale=None,
                   tile=64):
    """K2: ``(dk, dv)`` from the residuals, dO and delta."""
    scale = _scale_of(q, sm_scale)
    if q.device.type == "cpu":
        flash_bwd_dkdv.plain_calls += 1
        return _dkdv_reference(q, k, v, do, lse, delta, causal, scale)
    out = _launch_dkdv(q, k, v, do, lse, delta, causal, scale, tile)
    flash_bwd_dkdv.launches += 1
    return out


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal=False, sm_scale=None,
                 tile=64):
    """K3: ``dq`` from the residuals, dO and delta."""
    scale = _scale_of(q, sm_scale)
    if q.device.type == "cpu":
        flash_bwd_dq.plain_calls += 1
        return _dq_reference(q, k, v, do, lse, delta, causal, scale)
    out = _launch_dq(q, k, v, do, lse, delta, causal, scale, tile)
    flash_bwd_dq.launches += 1
    return out


for _fn in (flash_fwd, flash_bwd_dkdv, flash_bwd_dq):
    _fn.launches = 0
    _fn.plain_calls = 0


@torch.library.custom_op("mxnet_tpu_torch::flash_attention",
                         mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, scale: float,
                       tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 as a torch custom op: ``(out, lse)`` on (BH, S, D) tensors
    through :func:`flash_fwd` (the kernel on a card, its plain version on
    the CPU).  ``tile`` 0 takes the kernel registry's config for the
    shape, resolved when the op runs.  ``torch.export`` keeps the op as
    one named node (a ``ctypes`` launch cannot be traced), and a program
    that holds it runs the kernel where it is loaded.  Its gradient is
    :class:`_FlashAttention`'s."""
    tile = _op_tile(q, k, v, causal, scale, tile)
    return flash_fwd(q, k, v, causal=causal, sm_scale=scale, tile=tile)


@flash_attention_op.register_fake
def _flash_op_fake(q, k, v, causal, scale, tile):
    return (torch.empty_like(q),
            q.new_empty((q.shape[0], q.shape[1]), dtype=torch.float32))


def _op_tile(q, k, v, causal, scale, tile):
    """The tile a call runs: ``tile`` when given, else the registry's
    config on a card (64 on the CPU, whose plain version ignores it)."""
    if tile or q.device.type == "cpu":
        return int(tile) or 64
    return _resolve_tile(q, k, v, bool(causal), scale, None, None)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the reference's ``custom_vjp``: the forward is K1's
    custom op and saves ``(q, k, v, out, lse)``; the backward forms delta
    in f32 and runs K2 and K3.  (The op's own autograd registration would
    cost each eager call some 0.3 ms of host time more:
    ``tools/custom_op_cost.py``.)"""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, tile):
        out, lse = flash_attention_op(q, k, v, causal, scale, tile)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.tile = causal, scale, tile
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = _delta(do, out)
        kw = dict(causal=ctx.causal, sm_scale=ctx.scale,
                  tile=_op_tile(q, k, v, ctx.causal, ctx.scale, ctx.tile))
        dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None, None


def _flash_op_flops(q_shape, k_shape, *args, **kwargs):
    """``FlopCounterMode``'s count for K1: the two products, 2·BH·Sq·Sk·D
    each (the causal half is not taken off, as XLA's count)."""
    bh, sq, d = q_shape
    return 4 * bh * sq * k_shape[1] * d


def _register_flops():
    try:
        from torch.utils.flop_counter import register_flop_formula
        register_flop_formula(torch.ops.mxnet_tpu_torch.flash_attention)(
            _flash_op_flops)
    except (ImportError, AttributeError, TypeError):
        pass


_register_flops()


def build(device="cuda"):
    """Compile and load the library ahead of traffic and launch each
    kernel once on a small input (not counted in the wrappers).
    Returns ``(nvcc output, build seconds)``."""
    from ..kernels.build import build_library
    _, log, seconds = build_library("flash_attention")
    lse = torch.zeros((1, 8), device=device)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((1, 8, 64), dtype=dtype, device=device)
        _launch_fwd(q, q, q, True, 1.0, 64)
        _launch_dkdv(q, q, q, q, lse, lse, True, 1.0, 64)
        _launch_dq(q, q, q, q, lse, lse, True, 1.0, 64)
    torch.cuda.synchronize(device)
    return log, seconds


# -- kernel-registry integration ---------------------------------------------

def _pow2_bucket(n, floor=128):
    """Sequence lengths bucket to the next power of two ≥ ``floor``, so
    ragged lengths share one tuned config."""
    b = floor
    while b < n:
        b *= 2
    return b


def _flash_signature(q, k, v, causal=False, sm_scale=None):
    return (f"sq{_pow2_bucket(q.shape[1])}_sk{_pow2_bucket(k.shape[1])}"
            f"_d{q.shape[2]}_c{int(bool(causal))}",
            str(q.dtype).replace("torch.", ""))


def _flash_kernel_run(config, q, k, v, causal=False, sm_scale=None):
    """The forward and the backward (on a fixed dO of ones) under
    ``config``: what the tuner times.  The ``tile`` it picks serves K2
    and K3 (and the f32 K1); the bf16 K1 has its own tiling, so timing
    the forward alone would pick the backward's tile by noise."""
    scale = _scale_of(q, sm_scale)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        out = _FlashAttention.apply(q, k, v, bool(causal), scale,
                                    int(config["tile"]))
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    return out.detach()


def _flash_kernel_fallback(q, k, v, causal=False, sm_scale=None):
    return attention_reference(q[None], k[None], v[None], causal=causal,
                               sm_scale=sm_scale)[0]


def _flash_make_args(case):
    import numpy as onp
    rng = onp.random.RandomState(11)
    bh, sq, sk, d = case["bh"], case["sq"], case["sk"], case["d"]
    dtype = getattr(torch, case.get("dtype", "float32"))
    q, k, v = (torch.as_tensor(rng.randn(bh, s, d) * 0.5).to(
        case.get("device", "cuda"), dtype) for s in (sq, sk, sk))
    return (q, k, v), {"causal": bool(case.get("causal", False))}


_kernels.register_kernel(_kernels.KernelSpec(
    "flash_attention", version=2,
    run=_flash_kernel_run, fallback=_flash_kernel_fallback,
    config_space={"tile": _TILES},
    default_config={"tile": 64},
    signature=_flash_signature, make_args=_flash_make_args,
    tune_grid=({"bh": 64, "sq": 2048, "sk": 2048, "d": 64,
                "causal": True, "dtype": "bfloat16"},
               # ViT-B/16 at batch 128: 12 heads, 197 tokens, non-causal
               {"bh": 1536, "sq": 197, "sk": 197, "d": 64,
                "causal": False, "dtype": "bfloat16"}),
))


def _resolve_tile(qf, kf, vf, causal, scale, block_q, block_k):
    if block_q is not None or block_k is not None:
        if block_q != block_k or int(block_q) not in _TILES:
            raise MXNetError(f"flash_attention on CUDA runs square tiles "
                             f"{_TILES}: block_q={block_q}, "
                             f"block_k={block_k}")
        return int(block_q)
    sig, dt = _flash_signature(qf, kf, vf, causal=causal)
    return int(_kernels.resolve(
        "flash_attention", sig, dt,
        tune_args=((qf, kf, vf), {"causal": causal,
                                  "sm_scale": scale}))["tile"])


def flash_attention(q, k, v, *, causal=False, sm_scale=None,
                    block_q=None, block_k=None):
    """Flash attention on (B, H, S, D) (or (BH, S, D)) tensors,
    differentiable through K2 and K3.

    Grouped-query attention: ``k``/``v`` may carry fewer heads than
    ``q`` when ``H % Hkv == 0``; KV heads are repeated across the group
    before the kernel.

    ``block_q``/``block_k``: on CUDA, K2 and K3 (and the f32 K1) run
    square tiles, so the two must be equal and name a compiled tile (32
    or 64 rows); left out, the kernel registry's config for the shape is
    used.  The bf16 K1 has its own tiling and ignores them.  CPU tensors
    take the plain versions and ignore them."""
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[None], k[None], v[None]
    b, h, sq, d = q.shape
    hkv = k.shape[1]
    if v.shape[1] != hkv:
        raise ValueError("k and v must have the same head count")
    if hkv != h:
        if hkv <= 0 or h % hkv != 0:
            raise ValueError(f"GQA requires q heads ({h}) divisible by kv "
                             f"heads ({hkv})")
        k = torch.repeat_interleave(k, h // hkv, dim=1)
        v = torch.repeat_interleave(v, h // hkv, dim=1)
    scale = float(sm_scale if sm_scale is not None else 1.0 / math.sqrt(d))
    qf = q.reshape(b * h, sq, d).contiguous()
    kf = k.reshape(b * h, k.shape[2], d).contiguous()
    vf = v.reshape(b * h, v.shape[2], d).contiguous()
    tile = 0
    if (block_q is not None or block_k is not None) \
            and q.device.type != "cpu":
        tile = _resolve_tile(qf, kf, vf, bool(causal), scale, block_q,
                             block_k)
    out = _FlashAttention.apply(qf, kf, vf, bool(causal), scale, tile)
    out = out.reshape(b, h, sq, d)
    return out[0] if squeeze else out


# -- multi-head attention (the op the transformer calls) ----------------------

def split_heads(x, heads):
    """(B, S, heads*hd) → (B, heads, S, hd)."""
    b, s_, e = x.shape
    return x.reshape(b, s_, heads, e // heads).permute(0, 2, 1, 3)


def merge_heads(x):
    """(B, H, S, hd) → (B, S, H*hd)."""
    b, h, s_, hd = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s_, h * hd)


def multi_head_attention(q, k, v, *, num_heads, causal=False,
                         use_flash=True, num_kv_heads=None):
    """(B, S, E) inputs, already projected: split heads, attend, merge.
    ``use_flash=False`` takes the dense :func:`attention_reference`."""
    hkv = num_kv_heads if num_kv_heads is not None else num_heads
    qh, kh, vh = (split_heads(q, num_heads), split_heads(k, hkv),
                  split_heads(v, hkv))
    if use_flash:
        out = flash_attention(qh, kh, vh, causal=causal)
    else:
        if hkv != num_heads:
            kh = torch.repeat_interleave(kh, num_heads // hkv, dim=1)
            vh = torch.repeat_interleave(vh, num_heads // hkv, dim=1)
        out = attention_reference(qh, kh, vh, causal=causal)
    return merge_heads(out)


register("flash_attention", aliases=("_npx_flash_attention",))(
    flash_attention)
register("multi_head_attention", aliases=("_npx_multi_head_attention",))(
    multi_head_attention)


# -- masked softmax and the contrib transformer ops
# (``mxnet_tpu/ops/attention.py:654-739``): plain PyTorch ------------------

_NEG_INF = -1e30    # a finite stand-in for -inf: masked rows stay NaN-free


def masked_softmax(x, mask=None, *, axis=-1, temperature=1.0):
    """Softmax over ``axis`` of the positions where ``mask`` is true;
    masked positions are 0."""
    if mask is not None:
        m = mask.bool()
        x = torch.where(m, x, torch.full_like(x, _NEG_INF))
    p = torch.softmax(x / temperature, dim=axis)
    if mask is not None:
        p = torch.where(m, p, torch.zeros_like(p))
    return p


def masked_log_softmax(x, mask=None, *, axis=-1, temperature=1.0):
    """Log-softmax over the unmasked positions; masked ones are -inf."""
    if mask is not None:
        m = mask.bool()
        x = torch.where(m, x, torch.full_like(x, _NEG_INF))
    out = torch.log_softmax(x / temperature, dim=axis)
    if mask is not None:
        out = torch.where(m, out, torch.full_like(out, -math.inf))
    return out


def div_sqrt_dim(x):
    """``x / sqrt(x.shape[-1])``."""
    return x / math.sqrt(x.shape[-1])


def _split_interleaved(qkv, heads, n):
    """(S, B, heads*hd*n) → n tensors of (B*heads, S, hd)."""
    s_, b, e = qkv.shape
    hd = e // (heads * n)
    t = qkv.reshape(s_, b, heads, n, hd)
    return [t[:, :, :, i, :].permute(1, 2, 0, 3).reshape(b * heads, s_, hd)
            for i in range(n)]


def _attend_and_merge_heads(attention, v, heads):
    """attention (B*H, Sq, Sk) × v (B*H, Sk, hd) → (Sq, B, H*hd)."""
    out = torch.bmm(attention, v)
    bh, s_, hd = out.shape
    b = bh // heads
    return out.reshape(b, heads, s_, hd).permute(2, 0, 1, 3).reshape(
        s_, b, heads * hd)


def interleaved_matmul_selfatt_qk(queries_keys_values, *, heads):
    """Scaled q·kᵀ of an interleaved (S, B, heads*hd*3) projection."""
    q, k, _ = _split_interleaved(queries_keys_values, heads, 3)
    return torch.bmm(q / math.sqrt(q.shape[-1]), k.transpose(1, 2))


def interleaved_matmul_selfatt_valatt(queries_keys_values, attention, *,
                                      heads):
    """The attention-weighted v of an interleaved projection, heads
    merged to (S, B, heads*hd)."""
    _, _, v = _split_interleaved(queries_keys_values, heads, 3)
    return _attend_and_merge_heads(attention, v, heads)


def interleaved_matmul_encdec_qk(queries, keys_values, *, heads):
    """Scaled q·kᵀ of (Sq, B, heads*hd) queries against an interleaved
    (Sk, B, heads*hd*2) key/value projection."""
    sq, b, e = queries.shape
    hd = e // heads
    q = queries.reshape(sq, b, heads, hd).permute(1, 2, 0, 3).reshape(
        b * heads, sq, hd) / math.sqrt(hd)
    k, _ = _split_interleaved(keys_values, heads, 2)
    return torch.bmm(q, k.transpose(1, 2))


def interleaved_matmul_encdec_valatt(keys_values, attention, *, heads):
    _, v = _split_interleaved(keys_values, heads, 2)
    return _attend_and_merge_heads(attention, v, heads)


register("masked_softmax", aliases=("_npx_masked_softmax",))(masked_softmax)
register("masked_log_softmax", aliases=("_npx_masked_log_softmax",))(
    masked_log_softmax)
register("_contrib_div_sqrt_dim", aliases=("div_sqrt_dim",))(div_sqrt_dim)
for _name, _fn in (("interleaved_matmul_selfatt_qk",
                    interleaved_matmul_selfatt_qk),
                   ("interleaved_matmul_selfatt_valatt",
                    interleaved_matmul_selfatt_valatt),
                   ("interleaved_matmul_encdec_qk",
                    interleaved_matmul_encdec_qk),
                   ("interleaved_matmul_encdec_valatt",
                    interleaved_matmul_encdec_valatt)):
    register("_contrib_" + _name, aliases=(_name,))(_fn)
