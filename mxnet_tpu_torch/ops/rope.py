"""Rotary position embedding (RoPE): plain PyTorch version, CUDA C++
kernel (K5), and the wrappers that pick between them by the tensor's
device.

Replaces the TPU kernel ``mxnet_tpu/ops/rope.py`` ``_rope_kernel``
(reached through ``_rope_pallas``) with ``csrc/rope.cu``, built by nvcc
into a shared library with a C interface and called through ``ctypes``.
NeoX half-split rotation: for head-dim pairs ``(i, i + D/2)`` the angle
at position ``p`` is ``p * base**(-2i/D)``, so

    out[..., :D/2] = x1 * cos - x2 * sin
    out[..., D/2:] = x2 * cos + x1 * sin

**What bounds it on an H100.**  Bytes: each element is read once and
written once (``2 * R*H*D * itemsize`` plus the positions) against a
handful of flops and one sincos per pair.  At decode shapes (R = 8
slots × 8 heads × 64) that is 32 KB, far under a microsecond at
3.35 TB/s, so what a caller pays is the launch: the host's work before
it and the card's fixed cost.  Hence the design of the host path:

- one C call per launch, its ``argtypes`` set once, on the stream's raw
  handle (``torch.cuda.current_stream`` builds a Python object each
  call); no allocation but the outputs, no synchronisation, no lengths
  read back;
- no reshape of an ``(R, H, D)`` input or its output;
- the config resolved once per (R bucket, H, D, dtype) and kept in a
  dict;
- ``positions`` used as they are when already a contiguous tensor of
  the rows' shape on the device (no ``as_tensor``/``broadcast_to``);
- only the checks that guard memory (device, dtype, shape,
  contiguity);
- :func:`rope_qk` rotates q and k in one launch.

The source's head comment gives the kernel's design and numerics: the
inverse frequencies ``exp(k * (-ln(base) / half))`` and the angles in
rounded f32 steps, accurate ``expf``/``sincosf`` (positions run into
the thousands, where the fast-math forms lose all precision), products
and sums rounded one by one as the plain version rounds them.  The TPU
kernel's lane broadcast of positions (``_POS_LANES``) was tiling for
the TPU and is gone.
"""
import ctypes
import math

import torch

from .. import kernels as _kernels
from ..base import MXNetError

__all__ = ["rope", "rope_qk", "rope_reference", "build"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_POS_IS_INT64 = {torch.int32: 0, torch.int64: 1}
_PAIRS = (2, 4, 8)              # pairs a thread rotates
_THREADS = (64, 128, 256)       # threads a block
_LIB = []                       # [(mx_rope, mx_cuda_error_string)]
_CONFIGS = {}                   # (R bucket, H, D, dtype) → (pairs, threads)


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


def _library():
    """``(mx_rope, mx_cuda_error_string)``, built, loaded and typed on
    first use."""
    if not _LIB:
        from ..kernels.build import build_library
        lib = build_library("rope")[0]
        fn = lib.mx_rope
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
        _LIB.append((fn, lib.mx_cuda_error_string))
    return _LIB[0]


def _launch(xs, positions, neg_log_base_half, pairs, threads):
    """K5 on one or two ``(R, H, D)`` CUDA tensors of one shape and dtype
    sharing ``positions (R,)``, on the caller's current stream; returns
    the outputs.  No counting (the wrappers count)."""
    x0 = xs[0]
    dev = x0.device
    if dev.type != "cuda":
        raise MXNetError(f"rope kernel needs CUDA tensors, got {dev}")
    code = _DTYPE_CODE.get(x0.dtype)
    if code is None:
        raise MXNetError(f"rope kernel takes {tuple(_DTYPE_CODE)}, got "
                         f"{x0.dtype}")
    if x0.dim() != 3 or x0.shape[-1] % 2:
        raise MXNetError(f"rope kernel takes (R, H, D) with an even D, "
                         f"got {tuple(x0.shape)}")
    for x in xs:
        if x.device != dev or x.dtype != x0.dtype or x.shape != x0.shape \
                or not x.is_contiguous():
            raise MXNetError("rope kernel needs contiguous tensors of one "
                             "shape, dtype and device")
    pos64 = _POS_IS_INT64.get(positions.dtype)
    if pos64 is None or positions.device != dev \
            or positions.shape != x0.shape[:1] \
            or not positions.is_contiguous():
        raise MXNetError(
            f"rope positions must be contiguous int32/int64 of shape "
            f"{tuple(x0.shape[:1])} on {dev}, got {positions.dtype} "
            f"{tuple(positions.shape)} on {positions.device}")
    fn, error_string = _library()
    outs = [torch.empty_like(x) for x in xs]
    r, h, d = x0.shape
    args = (x0.data_ptr(), outs[0].data_ptr(), xs[-1].data_ptr(),
            outs[-1].data_ptr(), len(xs), code, positions.data_ptr(), pos64,
            r, h, d, neg_log_base_half, pairs, threads,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err:
        raise MXNetError(f"rope launch failed: "
                         f"{error_string(err).decode()}")
    return outs


def _rows_positions(positions, lead, r, device):
    """``positions`` as a contiguous ``(R,)`` tensor on ``device``: as it
    is when it already is one (or a contiguous tensor of shape ``lead``,
    viewed flat), else broadcast (a scalar) and copied."""
    if isinstance(positions, torch.Tensor) and positions.shape == lead \
            and positions.device == device and positions.is_contiguous():
        return positions if positions.dim() == 1 else positions.reshape(r)
    # a broadcast scalar reshapes to a stride-0 view: the kernel needs one
    # position per row in memory
    return torch.broadcast_to(torch.as_tensor(positions, device=device),
                              lead).reshape(r).contiguous()


def _config(xf, pos, base):
    """``(pairs, threads)`` for a call: the registry's resolution (memo,
    disk, tuner, default), taken once per (R bucket, H, D, dtype)."""
    key = (_pow2(xf.shape[0], 64), xf.shape[1], xf.shape[2], xf.dtype)
    cfg = _CONFIGS.get(key)
    if cfg is None:
        sig, dt = _rope_signature(xf, pos, base)
        c = _kernels.resolve("rope", sig, dt,
                             tune_args=((xf, pos), {"base": float(base)}))
        cfg = _CONFIGS[key] = (int(c["pairs"]), int(c["threads"]))
    return cfg


def _rope_cuda(xs, positions, base, config=None):
    """One K5 launch over the tensors ``xs`` (one shape ``(..., H, D)``),
    counted once in ``rope.launches``; returns their rotations."""
    x0 = xs[0]
    shape = x0.shape
    if len(shape) == 3:
        lead, r, flat = shape[:1], shape[0], xs
    else:
        lead = shape[:-2]
        r = math.prod(lead)
        flat = [x.reshape(r, shape[-2], shape[-1]) for x in xs]
    pos = _rows_positions(positions, lead, r, x0.device)
    if config is None:
        pairs, threads = _config(flat[0], pos, base)
    else:
        pairs, threads = int(config["pairs"]), int(config["threads"])
    outs = _launch(flat, pos, -math.log(base) / (shape[-1] // 2), pairs,
                   threads)
    rope.launches += 1
    if flat is xs:
        return outs
    return [o.reshape(x.shape) for o, x in zip(outs, xs)]


def build(device="cuda"):
    """Compile and load the library ahead of traffic and launch it once
    on a small input (not counted in ``rope.launches``).  Returns
    ``(nvcc output, build seconds)``."""
    from ..kernels.build import build_library
    _, log, seconds = build_library("rope")
    x = torch.zeros((1, 1, 64), device=device)
    _launch([x], torch.zeros((1,), dtype=torch.int32, device=device),
            -math.log(10000.0) / 32, _PAIRS[0], _THREADS[0])
    torch.cuda.synchronize(device)
    return log, seconds


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
    return _rope_cuda((x,), positions, base, config)[0]


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
    "rope", version=2,
    run=_rope_kernel_run, fallback=rope_reference,
    config_space={"pairs": _PAIRS, "threads": _THREADS},
    default_config={"pairs": 4, "threads": 128},
    signature=_rope_signature, make_args=_rope_make_args,
    tune_grid=({"r": 8, "h": 8, "d": 64},
               {"r": 128, "h": 8, "d": 64}),
))


def rope(x, positions, *, base=10000.0, config=None):
    """Rotary embedding on ``x (..., H, D)`` at integer ``positions``
    shaped like ``x.shape[:-2]`` (scalars broadcast).

    A CPU tensor takes :func:`rope_reference` (``rope.plain_calls``
    counts those); a CUDA tensor launches K5 (``rope.launches``) or
    raises — it never falls back.  ``config`` (``{"pairs", "threads"}``)
    overrides the registry's choice."""
    if math.prod(x.shape[:-2]) == 0:
        return x
    if x.device.type == "cpu":
        rope.plain_calls += 1
        return rope_reference(x, positions, base=base)
    return _rope_cuda((x,), positions, float(base), config)[0]


def rope_qk(q, k, positions, *, base=10000.0):
    """Exactly ``(rope(q, positions), rope(k, positions))``.  On the
    card q and k of one shape and dtype rotate in one launch, counted
    once in ``rope.launches`` (two launches where they differ); on the
    CPU they are two plain calls."""
    if q.device.type == "cpu" or math.prod(q.shape[:-2]) == 0 \
            or q.shape != k.shape or q.dtype != k.dtype:
        return (rope(q, positions, base=base),
                rope(k, positions, base=base))
    oq, ok = _rope_cuda((q, k), positions, float(base))
    return oq, ok


rope.launches = 0
rope.plain_calls = 0
