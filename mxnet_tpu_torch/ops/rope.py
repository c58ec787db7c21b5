"""Rotary position embedding (RoPE): plain PyTorch version, Triton kernel,
and the wrapper that picks between them by the tensor's device.

Replaces the TPU kernel ``mxnet_tpu/ops/rope.py`` ``_rope_kernel``
(reached through ``_rope_pallas``).  NeoX half-split rotation: for
head-dim pairs ``(i, i + D/2)`` the angle at position ``p`` is
``p * base**(-2i/D)``, so

    out[..., :D/2] = x1 * cos - x2 * sin
    out[..., D/2:] = x2 * cos + x1 * sin

**Why Triton.**  The kernel is one fused elementwise pass (load a block
of head vectors, compute the angles, rotate, store) with no data reuse,
no shared-memory tiling and no matrix product, so CUDA C++ written by
hand would gain nothing over Triton's masked block loads.

**What bounds it on an H100.**  Bytes: each element is read once and
written once (``2 * R*H*D * itemsize`` plus the positions) against a
handful of flops and two transcendentals per pair.  At decode shapes
(R = 8 slots × 8 heads × 64) that is 32 KB, far under a microsecond at
3.35 TB/s, so a launch is dominated by its fixed launch cost; the
design keeps it to one launch per call with no host-side tables.

**Numerics.**  The angles use libdevice's accurate ``exp``/``cos``/
``sin`` in f32, never fast-math approximations: positions run into the
thousands, where an approximate ``cos`` loses all precision.  The
inverse frequencies are computed as the reference does,
``exp(k * (-ln(base) / half))`` in f32.  The TPU kernel's lane broadcast
of positions (``_POS_LANES``) was tiling for the TPU and is gone.
"""
import math

import torch

from .. import kernels as _kernels
from ..base import MXNetError

__all__ = ["rope", "rope_reference", "build"]

# Bound to triton.language / libdevice at the first launch, so that the
# jitted kernel body resolves them as module globals while importing
# this module never imports triton (the CPU path has none).
tl = None
libdevice = None
_KERNEL = {}


def rope_reference(x, positions, base=10000.0):
    """RoPE on ``x (..., H, D)`` with ``positions`` shaped like
    ``x.shape[:-2]`` (or scalar): the CPU path and the oracle."""
    d = x.shape[-1]
    half = d // 2
    xf = x.float()
    pos = torch.broadcast_to(torch.as_tensor(positions, device=x.device),
                             x.shape[:-2])
    pos = pos.float()[..., None, None]                    # (..., 1, 1)
    k = torch.arange(half, dtype=torch.float32, device=x.device)
    inv = torch.exp(k * (-math.log(base) / half))         # base^(-2i/D)
    ang = pos * inv                                       # (..., 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _triton_kernel():
    """The jitted kernel, defined at first use (imports triton)."""
    global tl, libdevice
    if "rope" in _KERNEL:
        return _KERNEL["rope"]
    import triton
    import triton.language
    try:
        from triton.language.extra import libdevice as _libdevice
    except ImportError:                      # triton < 3.2 layout
        from triton.language.extra.cuda import libdevice as _libdevice
    tl = triton.language
    libdevice = _libdevice

    @triton.jit
    def _rope_kernel(x_ptr, pos_ptr, o_ptr, n_vec, heads, neg_log_base_half,
                     HALF: tl.constexpr, HALF_P: tl.constexpr,
                     BLOCK_V: tl.constexpr):
        # one program rotates BLOCK_V head vectors (row r, head h) of D
        vec = tl.program_id(0) * BLOCK_V + tl.arange(0, BLOCK_V)
        vmask = vec < n_vec
        pos = tl.load(pos_ptr + vec // heads, mask=vmask, other=0)
        k = tl.arange(0, HALF_P)
        kmask = k < HALF
        inv = libdevice.exp(k.to(tl.float32) * neg_log_base_half)
        ang = pos.to(tl.float32)[:, None] * inv[None, :]
        cos = libdevice.cos(ang)
        sin = libdevice.sin(ang)
        offs = vec[:, None] * (2 * HALF) + k[None, :]
        mask = vmask[:, None] & kmask[None, :]
        x1 = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        x2 = tl.load(x_ptr + offs + HALF, mask=mask,
                     other=0.0).to(tl.float32)
        ty = o_ptr.dtype.element_ty
        tl.store(o_ptr + offs, (x1 * cos - x2 * sin).to(ty), mask=mask)
        tl.store(o_ptr + offs + HALF, (x2 * cos + x1 * sin).to(ty),
                 mask=mask)

    _KERNEL["rope"] = _rope_kernel
    return _rope_kernel


_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _launch(x, positions, base, block_v):
    """Launch the Triton kernel on x (R, H, D) and positions (R,); no
    counting (the wrapper counts)."""
    if x.device.type != "cuda":
        raise MXNetError(f"rope kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise MXNetError(f"rope kernel takes {_DTYPES}, got {x.dtype}")
    if x.dim() != 3 or x.shape[-1] % 2:
        raise MXNetError(f"rope kernel takes (R, H, D) with an even D, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous() or not positions.is_contiguous():
        raise MXNetError("rope kernel needs contiguous x and positions")
    if positions.device != x.device or positions.dtype not in (
            torch.int32, torch.int64) or positions.shape != x.shape[:1]:
        raise MXNetError(
            f"rope positions must be int32/int64 of shape {x.shape[:1]} "
            f"on {x.device}, got {positions.dtype} {tuple(positions.shape)}"
            f" on {positions.device}")
    r, h, d = x.shape
    half = d // 2
    out = torch.empty_like(x)
    n_vec = r * h
    block_v = int(block_v)
    grid = ((n_vec + block_v - 1) // block_v,)
    with torch.cuda.device(x.device):
        _triton_kernel()[grid](
            x, positions, out, n_vec, h, -math.log(base) / half,
            HALF=half, HALF_P=1 << (half - 1).bit_length(), BLOCK_V=block_v)
    return out


def _rope_cuda(x, positions, base, block_v):
    out = _launch(x, positions, base, block_v)
    rope.launches += 1
    return out


def build(device="cuda") -> None:
    """Compile the kernel ahead of traffic with one launch on a dummy
    input (not counted in ``rope.launches``)."""
    x = torch.zeros((1, 1, 64), device=device)
    _launch(x, torch.zeros((1,), dtype=torch.int32, device=device),
            10000.0, 16)
    torch.cuda.synchronize(device)


# -- kernel-registry integration -------------------------------------------

def _pow2(n: int, floor: int) -> int:
    b = max(1, floor)
    while b < n:
        b *= 2
    return b


def _rope_signature(x, positions, base=10000.0):
    return (f"r{_pow2(x.shape[0], 64)}_h{x.shape[1]}_d{x.shape[2]}",
            str(x.dtype).replace("torch.", ""))


def _rope_kernel_run(config, x, positions, base=10000.0):
    return _rope_cuda(x, positions, base, config["block_v"])


def _rope_make_args(case):
    import numpy as onp
    rng = onp.random.RandomState(23)
    dev = case.get("device", "cuda")
    r, h, d = case["r"], case["h"], case["d"]
    x = torch.as_tensor(rng.randn(r, h, d) * 0.5).to(
        device=dev, dtype=getattr(torch, case.get("dtype", "float32")))
    pos = torch.as_tensor(rng.randint(0, 4096, size=(r,)),
                          dtype=torch.int32, device=dev)
    return (x, pos), {"base": float(case.get("base", 10000.0))}


_kernels.register_kernel(_kernels.KernelSpec(
    "rope", version=1,
    run=_rope_kernel_run, fallback=rope_reference,
    config_space={"block_v": (16, 32, 64, 128)},
    default_config={"block_v": 32},
    signature=_rope_signature, make_args=_rope_make_args,
    tune_grid=({"r": 8, "h": 8, "d": 64},
               {"r": 128, "h": 8, "d": 64}),
))


def rope(x, positions, *, base=10000.0, block_v=None):
    """Rotary embedding on ``x (..., H, D)`` at integer ``positions``
    shaped like ``x.shape[:-2]`` (scalars broadcast).

    A CPU tensor takes :func:`rope_reference` (``rope.plain_calls``
    counts those); a CUDA tensor launches the Triton kernel
    (``rope.launches``) or raises — it never falls back."""
    lead = x.shape[:-2]
    r = math.prod(lead)
    if r == 0:
        return x
    if x.device.type == "cpu":
        rope.plain_calls += 1
        return rope_reference(x, positions, base=base)
    xf = x.reshape((r,) + tuple(x.shape[-2:]))
    # a broadcast scalar reshapes to a stride-0 view: the kernel needs
    # one position per row in memory
    pos = torch.broadcast_to(torch.as_tensor(positions, device=x.device),
                             lead).reshape(r).contiguous()
    if block_v is None:
        sig, dt = _rope_signature(xf, pos, base)
        block_v = _kernels.resolve(
            "rope", sig, dt,
            tune_args=((xf, pos), {"base": float(base)}))["block_v"]
    return _rope_cuda(xf, pos, float(base), block_v).reshape(x.shape)


rope.launches = 0
rope.plain_calls = 0
