"""Paged attention: one query token per slot over a paged KV pool —
plain PyTorch version, CUDA C++ kernel, and the wrapper that picks
between them by the tensor's device.

The decode serving plane (serving/decode/) keeps every slot's KV history
in a pre-allocated page pool ``(num_pages, page_size, H, D)`` plus a
per-slot page table ``(max_slots, pages_per_slot)``.

Replaces the TPU kernel ``mxnet_tpu/ops/paged_attention.py``
``_pa_kernel`` (reached through ``_paged_attention_pallas``) with
``csrc/paged_attention.cu``, built by nvcc into a shared library with a
C interface and called through ``ctypes``.  The source's head comment
gives the design; in short (flash-decoding): each slot's keys are split
into page-aligned partitions of ``partition`` keys, one block per (head,
slot, partition) with an online softmax in f32; the last block of a
(head, slot) merges the partials in partition order, in the same launch.
:func:`paged_attention_split_reference` is that split in plain PyTorch,
for the tests.

What bounds it on an H100: bytes — the K and V rows of the live
positions (``2 * sum(lengths) * H * D * 4`` for the fp32 pool) plus q
and the output, streamed once.  Slots of length 0 (inactive) produce
exact zeros, as in the oracle.
"""
import ctypes
import math

import torch

from .. import kernels as _kernels
from ..base import MXNetError
from .registry import register

__all__ = ["paged_attention", "paged_attention_reference",
           "paged_attention_split_reference", "build"]

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)          # instantiated in csrc/paged_attention.cu
_WARPS = (4, 8)
_PARTITIONS = (128, 256, 512)   # keys a block takes; multiples of a page
_PARTITION = 256                # the fastest of them on the served pool


def paged_attention_reference(q, k_pool, v_pool, tables, lengths,
                              sm_scale=None):
    """Gather-based oracle: q (S, H, D), pools (pages, ps, H, D),
    tables (S, P) int32, lengths (S,) int32 → (S, H, D).  Positions at
    or past a slot's length are masked; length-0 slots yield zeros."""
    s_, h, d = q.shape
    ps = k_pool.shape[1]
    p_ = tables.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    idx = tables.long()
    k = k_pool[idx].reshape(s_, p_ * ps, h, d).float()
    v = v_pool[idx].reshape(s_, p_ * ps, h, d).float()
    scores = torch.einsum("shd,skhd->shk", q.float(), k) * scale
    kpos = torch.arange(p_ * ps, device=q.device)[None, None, :]
    mask = kpos < lengths.long()[:, None, None]
    scores = torch.where(mask, scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(scores - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("shk,skhd->shd", p / l, v)
    return out.to(q.dtype)


def paged_attention_split_reference(q, k_pool, v_pool, tables, lengths,
                                    sm_scale=None, partition=_PARTITION):
    """The kernel's split in plain PyTorch: each slot's keys in
    page-aligned partitions of ``partition`` keys, a (m, l, acc) per
    partition in f32, merged in partition order.  Reads the lengths on
    the host; only the tests use it."""
    s_, h, d = q.shape
    ps = k_pool.shape[1]
    if partition <= 0 or partition % ps:
        raise MXNetError(f"paged_attention: partition {partition} is not a "
                         f"positive multiple of the page size {ps}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    cap = tables.shape[1] * ps
    k_rows = k_pool.reshape(-1, h, d).float()
    v_rows = v_pool.reshape(-1, h, d).float()
    out = torch.zeros((s_, h, d), dtype=torch.float32, device=q.device)
    for slot in range(s_):
        n = min(max(int(lengths[slot]), 0), cap)
        parts = []
        for start in range(0, max(n, 1), partition):
            pos = torch.arange(start, min(n, start + partition),
                               device=q.device)
            rows = tables[slot, pos // ps].long() * ps + pos % ps
            s = torch.einsum("hd,khd->hk", q[slot].float() * scale,
                             k_rows[rows])
            m = (s.amax(dim=-1) if len(pos)
                 else torch.full((h,), _NEG_INF, device=q.device))
            p = torch.exp(s - m[:, None])
            parts.append((m, p.sum(dim=-1),
                          torch.einsum("hk,khd->hd", p, v_rows[rows])))
        big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l_sum = torch.zeros(h, device=q.device)
        acc = torch.zeros((h, d), device=q.device)
        for m, l, a in parts:                    # in partition order
            c = torch.exp(m - big)
            l_sum = l_sum + c * l
            acc = acc + c[:, None] * a
        out[slot] = acc / torch.where(l_sum == 0.0, 1.0, l_sum)[:, None]
    return out.to(q.dtype)


def _library():
    from ..kernels.build import build_library
    lib = build_library("paged_attention")[0]
    fn = lib.mx_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.mx_cuda_error_string.argtypes = [ctypes.c_int]
        lib.mx_cuda_error_string.restype = ctypes.c_char_p
    return lib


# (device, slots, heads, partitions, head dim) -> (partials, counters)
_SCRATCH = {}


def _scratch(q, n_parts):
    """The partials buffer and the per-(slot, head) counters of one
    launch shape, made once per device and shape; the counters are
    zeroed here and every launch leaves them zero.  Launches that share
    them run in stream order (one stream per engine).  A CUDA graph holds
    the addresses, so they are made by a launch before its capture."""
    s_, h, d = q.shape
    key = (q.device, s_, h, n_parts, d)
    hit = _SCRATCH.get(key)
    if hit is None:
        if torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                "paged_attention: its scratch for this shape is made in a "
                "warm-up launch, never inside a CUDA graph capture")
        hit = _SCRATCH[key] = (
            torch.empty((s_, h, n_parts, d + 2), dtype=torch.float32,
                        device=q.device),
            torch.zeros((s_, h), dtype=torch.int32, device=q.device))
    return hit


def _check(q, k_pool, v_pool, tables, lengths, warps, partition):
    dev = q.device
    if dev.type != "cuda":
        raise MXNetError(f"paged_attention kernel needs CUDA tensors, got "
                         f"{dev}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != dev:
            raise MXNetError(f"paged_attention: {name} on {t.device}, q on "
                             f"{dev}")
        if not t.is_contiguous():
            raise MXNetError(f"paged_attention: {name} must be contiguous")
    if not q.is_contiguous():
        raise MXNetError("paged_attention: q must be contiguous")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise MXNetError(f"paged_attention: q must be float32 or bfloat16, "
                         f"got {q.dtype}")
    if k_pool.dtype != torch.float32 or v_pool.dtype != torch.float32:
        raise MXNetError("paged_attention: the kernel takes float32 pools")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise MXNetError("paged_attention: tables and lengths must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise MXNetError(
            f"paged_attention: q (S, H, D) and pools (P, ps, H, D) "
            f"expected, got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    s_, h, d = q.shape
    if tuple(k_pool.shape[2:]) != (h, d):
        raise MXNetError(f"paged_attention: pool heads/dim "
                         f"{tuple(k_pool.shape[2:])} != q's {(h, d)}")
    if tables.dim() != 2 or tables.shape[0] != s_ \
            or tuple(lengths.shape) != (s_,):
        raise MXNetError(
            f"paged_attention: tables (S, P) and lengths (S,) with S={s_} "
            f"expected, got {tuple(tables.shape)}, {tuple(lengths.shape)}")
    if d not in _HEAD_DIMS or int(warps) not in _WARPS:
        raise MXNetError(f"paged_attention kernel is built for head_dim in "
                         f"{_HEAD_DIMS} and warps in {_WARPS}, got {d}, "
                         f"{warps}")
    if int(partition) <= 0 or int(partition) % k_pool.shape[1]:
        raise MXNetError(f"paged_attention: partition {partition} is not a "
                         f"positive multiple of the page size "
                         f"{k_pool.shape[1]}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise MXNetError(f"paged_attention: {name} is not 16-byte "
                             f"aligned")


def _launch(q, k_pool, v_pool, tables, lengths, sm_scale, warps,
            partition=_PARTITION):
    """Launch the kernel on the caller's current stream; no counting
    (the wrapper counts)."""
    _check(q, k_pool, v_pool, tables, lengths, warps, partition)
    s_, h, d = q.shape
    ps, pps = k_pool.shape[1], tables.shape[1]
    partials, counters = _scratch(q, -(-pps * ps // int(partition)))
    out = torch.empty_like(q)
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.mx_paged_attention(
            q.data_ptr(), int(q.dtype == torch.bfloat16), k_pool.data_ptr(),
            v_pool.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), partials.data_ptr(), counters.data_ptr(), s_, h,
            d, ps, pps, int(partition), float(sm_scale), int(warps),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise MXNetError(f"paged_attention launch failed: "
                         f"{lib.mx_cuda_error_string(err).decode()}")
    return out


def _paged_attention_cuda(q, k_pool, v_pool, tables, lengths, sm_scale,
                          warps, partition=_PARTITION):
    out = _launch(q, k_pool, v_pool, tables, lengths, sm_scale, warps,
                  partition)
    paged_attention.launches += 1
    return out


def build(device="cuda"):
    """Compile and load the library ahead of traffic and launch it once
    on a length-0 dummy (not counted in ``paged_attention.launches``).
    Returns ``(nvcc output, build seconds)``."""
    from ..kernels.build import build_library
    _, log, seconds = build_library("paged_attention")
    q = torch.zeros((1, 1, 64), device=device)
    pool = torch.zeros((1, 1, 1, 64), device=device)
    zero = torch.zeros((1,), dtype=torch.int32, device=device)
    _launch(q, pool, pool, zero.view(1, 1), zero, 1.0, _WARPS[-1])
    torch.cuda.synchronize(device)
    return log, seconds


# -- kernel-registry integration -------------------------------------------

def _paged_signature(q, k_pool, v_pool, tables, lengths, sm_scale=None):
    """Slots/pages/page-size are fixed by the serving deployment, so
    they key exactly; ragged lengths share one entry (data, not
    shape)."""
    return (f"s{q.shape[0]}_h{q.shape[1]}_d{q.shape[2]}"
            f"_ps{k_pool.shape[1]}_p{tables.shape[1]}",
            str(q.dtype).replace("torch.", ""))


def _paged_kernel_run(config, q, k_pool, v_pool, tables, lengths,
                      sm_scale=None):
    scale = (sm_scale if sm_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    return _paged_attention_cuda(q, k_pool, v_pool, tables, lengths,
                                 scale, config["warps"], config["partition"])


def _paged_make_args(case):
    import numpy as onp
    rng = onp.random.RandomState(17)
    dev = case.get("device", "cuda")
    slots, pps = case["slots"], case["pages_per_slot"]
    ps, h, d = case["page_size"], case["h"], case["d"]
    num_pages = slots * pps + 1

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    q = t(rng.randn(slots, h, d) * 0.5,
          getattr(torch, case.get("dtype", "float32")))
    k_pool = t(rng.randn(num_pages, ps, h, d) * 0.5)
    v_pool = t(rng.randn(num_pages, ps, h, d) * 0.5)
    tables = t(rng.permutation(num_pages - 1)[:slots * pps]
               .reshape(slots, pps), torch.int32)
    lengths = rng.randint(0, pps * ps + 1, size=(slots,))
    lengths[0] = 0                          # an inactive slot included
    return (q, k_pool, v_pool, tables, t(lengths, torch.int32)), {}


_kernels.register_kernel(_kernels.KernelSpec(
    "paged_attention", version=2,
    run=_paged_kernel_run, fallback=paged_attention_reference,
    config_space={"warps": _WARPS, "partition": _PARTITIONS},
    default_config={"warps": 8, "partition": _PARTITION},
    signature=_paged_signature, make_args=_paged_make_args,
    tune_grid=({"slots": 8, "pages_per_slot": 128, "page_size": 16,
                "h": 8, "d": 64},),
))


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    sm_scale=None, warps=None, partition=None):
    """One attention step per slot against its paged KV history.

    ``q (slots, H, D)`` — one query token per slot; ``k_pool/v_pool
    (num_pages, page_size, H, D)``; ``tables (slots, pages_per_slot)``
    int32 page ids; ``lengths (slots,)`` int32 valid context lengths
    (0 = inactive slot → zero output).  ``warps`` and ``partition`` (keys
    a block takes, a multiple of the page size) default to the kernel
    registry's config for the shape.

    CPU tensors take :func:`paged_attention_reference`
    (``paged_attention.plain_calls``); CUDA tensors launch the kernel on
    the current stream (``paged_attention.launches``) or raise."""
    scale = (sm_scale if sm_scale is not None
             else 1.0 / math.sqrt(q.shape[-1]))
    if q.device.type == "cpu":
        paged_attention.plain_calls += 1
        return paged_attention_reference(q, k_pool, v_pool, tables,
                                         lengths, sm_scale=scale)
    if warps is None or partition is None:
        sig, dt = _paged_signature(q, k_pool, v_pool, tables, lengths)
        cfg = _kernels.resolve(
            "paged_attention", sig, dt,
            tune_args=((q, k_pool, v_pool, tables, lengths),
                       {"sm_scale": scale}))
        warps = cfg["warps"] if warps is None else warps
        partition = cfg["partition"] if partition is None else partition
    return _paged_attention_cuda(q, k_pool, v_pool, tables, lengths,
                                 scale, warps, partition)


paged_attention.launches = 0
paged_attention.plain_calls = 0


def _paged_attention_op(q, k_pool, v_pool, tables, lengths, *,
                        sm_scale=None, block_k=None, warps=None,
                        partition=None):
    """The registered ``paged_attention`` / ``_npx_paged_attention``:
    :func:`paged_attention` (K4 on a card).  ``block_k``, the reference's
    Pallas key block, has no counterpart in K4's launch and is accepted
    and ignored; ``warps`` and ``partition`` are K4's own."""
    return paged_attention(q, k_pool, v_pool, tables, lengths,
                           sm_scale=sm_scale, warps=warps,
                           partition=partition)


register("paged_attention", aliases=("_npx_paged_attention",))(
    _paged_attention_op)
