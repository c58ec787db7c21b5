"""Decode engine over paged KV state (counterpart of
``mxnet_tpu/serving/decode/engine.py``).

Device paths, each over fixed shapes:

- ``decode_step`` — one token per slot over the full ``(max_slots,)``
  grid; the active-slot mask, positions and page tables are tensors, so
  admission and completion never change a shape;
- ``prefill[bucket]`` — one prompt chunk for one slot, padded into a
  pow2 bucket (chunked prefill keeps running decodes from stalling
  behind one long prompt);
- ``draft``/``verify`` — speculative decode: the draft model proposes
  ``k`` tokens per slot (its own paged pool, same page geometry), then
  the target scores all ``k+1`` positions in one pass and accepts the
  longest matching prefix.  Every emitted token is the target's own
  argmax, so greedy speculative decode is token-identical to the plain
  path.

Attention inside ``decode_step``/``verify`` runs through
``ops.paged_attention`` and the rotary embedding of q and k through
``ops.rope.rope_qk`` (one launch for both): on a CUDA device those
launch the hand-written kernels, on the CPU their plain versions.

Every device path is ONE executable per exec key (``decode``,
``prefill_b{bucket}``, ``draft``, ``verify``, ``draft_prefill_b{bucket}``;
``serving/decode/exec.py``): on a CUDA device a CUDA graph captured once,
on first use or by :meth:`DecodeEngine.warmup`, and replayed for every
later step, as the reference compiles one jit executable per key; on the
CPU the same cores run on the executable's static inputs.  ``compiles``
counts the executables materialised.  Unlike the reference, which
returned a new pool from each executable, the steps write K/V into the
pool in place.
"""
from __future__ import annotations

import os
import time
from functools import partial
from typing import Dict, List, Optional, Sequence

import numpy as onp
import torch
import torch.nn.functional as F

from ... import kernels, telemetry
from ...amp import policy as _amp_policy
from ...base import MXNetError
from ...context import resolve_device
from ...log import get_logger
from ...ops.paged_attention import paged_attention
from ...ops.rope import rope_qk, rope_reference
from ...executable import CaptureOwner
from .exec import Executable
from .paged_kv import PagedKVCache

__all__ = ["DecodeModel", "DecodeEngine"]

_NEG_INF = -1e30


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        return default
    return v if v > 0 else default


def _pow2(n: int, floor: int) -> int:
    b = max(1, floor)
    while b < n:
        b *= 2
    return b


def _rms(x, g, eps=1e-6):
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale).to(x.dtype) * g


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation; torch's to erf
    return F.gelu(x, approximate="tanh")


class DecodeModel:
    """A small causal LM as a plain dict of tensors + pure functions.

    ``params`` mirrors the reference's pytree: ``embed``,
    ``layers[i].{ln1, wq, wk, wv, wo, ln2, w1, w2}``, ``lnf``; the LM
    head is tied to the embedding.  Weights are drawn from
    ``numpy.random.RandomState(seed)`` in the reference's order (layers
    first, then ``embed``), so one seed gives both packages the same
    weights.  ``device`` defaults to ``cuda``."""

    def __init__(self, vocab_size: int, *, dim: int = 64,
                 n_heads: int = 4, n_layers: int = 2, mlp_ratio: int = 2,
                 rope_base: float = 10000.0, seed: int = 0,
                 dtype="float32", device=None):
        if dim % n_heads:
            raise ValueError(f"dim {dim} not divisible by heads {n_heads}")
        if (dim // n_heads) % 2:
            raise ValueError("head_dim must be even for rope")
        self.device = resolve_device(device)
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.n_heads = int(n_heads)
        self.n_layers = int(n_layers)
        self.head_dim = dim // n_heads
        self.rope_base = float(rope_base)
        rng = onp.random.RandomState(seed)

        def mat(*shape, scale):
            return torch.as_tensor(rng.randn(*shape) * scale).to(
                device=self.device, dtype=self.dtype)

        def ones():
            return torch.ones((dim,), dtype=self.dtype, device=self.device)

        w = 1.0 / (dim ** 0.5)
        layers = []
        for _ in range(n_layers):
            layers.append({
                "ln1": ones(),
                "wq": mat(dim, dim, scale=w),
                "wk": mat(dim, dim, scale=w),
                "wv": mat(dim, dim, scale=w),
                "wo": mat(dim, dim, scale=w),
                "ln2": ones(),
                "w1": mat(dim, mlp_ratio * dim, scale=w),
                "w2": mat(mlp_ratio * dim, dim,
                          scale=1.0 / ((mlp_ratio * dim) ** 0.5)),
            })
        self.params: Dict = {
            "embed": mat(vocab_size, dim, scale=0.5),
            "layers": layers,
            "lnf": ones(),
        }

    # -- dense full-recompute oracle (tests pin the paged path to it) --------

    def _ref_logits_last(self, tokens):
        """Last-position logits of a dense causal forward over the whole
        sequence — O(T^2) recompute, plain torch, no kernels."""
        t = tokens.shape[0]
        pos = torch.arange(t, dtype=torch.int32, device=self.device)
        x = self.params["embed"][tokens]
        h_, hd = self.n_heads, self.head_dim
        scale = 1.0 / (hd ** 0.5)
        causal = torch.ones((t, t), dtype=torch.bool,
                            device=self.device).tril()
        for lp in self.params["layers"]:
            h1 = _rms(x, lp["ln1"])
            q = rope_reference((h1 @ lp["wq"]).reshape(t, h_, hd), pos,
                               base=self.rope_base)
            k = rope_reference((h1 @ lp["wk"]).reshape(t, h_, hd), pos,
                               base=self.rope_base)
            v = (h1 @ lp["wv"]).reshape(t, h_, hd)
            s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
            s = torch.where(causal, s, _NEG_INF)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("hqk,khd->qhd", p, v.float())
            x = x + o.reshape(t, self.dim).to(x.dtype) @ lp["wo"]
            h2 = _rms(x, lp["ln2"])
            x = x + _gelu(h2 @ lp["w1"]) @ lp["w2"]
        x = _rms(x, self.params["lnf"])
        return x[-1] @ self.params["embed"].T

    @torch.no_grad()
    def greedy_reference(self, prompt, max_new_tokens: int,
                         eos: Optional[int] = None) -> List[int]:
        """Reference greedy generation (dense attention, full recompute
        per token).  Returns the generated tokens only."""
        toks = [int(t) for t in prompt]
        out: List[int] = []
        for _ in range(int(max_new_tokens)):
            nxt = int(torch.argmax(self._ref_logits_last(
                torch.as_tensor(toks, device=self.device))))
            out.append(nxt)
            toks.append(nxt)
            if eos is not None and nxt == int(eos):
                break
        return out


# -- cores -------------------------------------------------------------------
#
# ``pool`` is the cache's buffer, ``(layers, 2, num_pages + 1, ps, H, D)``:
# its last page is the drop page, where the rows of masked slots and padded
# prefill rows go (the reference's out-of-range sentinel with
# mode="drop").  Every core writes and reads a fixed number of rows whatever
# the mask, so one CUDA graph per exec key replays it.

def _drop_row(pool) -> int:
    """The drop page's first flat row (page * page_size + offset)."""
    return (pool.shape[2] - 1) * pool.shape[3]


def _write_kv(pool, li, idx, k, v):
    """Copy K/V rows into layer ``li``'s pages at flat positions ``idx``,
    IN PLACE.  Several masked rows may land on one drop row: nothing
    reads it."""
    _, _, pages, ps, h_, hd = pool.shape
    pool[li, 0].view(pages * ps, h_, hd).index_copy_(
        0, idx, k.to(pool.dtype))
    pool[li, 1].view(pages * ps, h_, hd).index_copy_(
        0, idx, v.to(pool.dtype))


def _mlp_residual(x, lp):
    return x + _gelu(_rms(x, lp["ln2"]) @ lp["w1"]) @ lp["w2"]


def _flat_rows(pool, tables, pos, valid):
    """Flat pool rows of ``pos`` through ``tables`` (page ids, gathered
    along the last axis), the drop page's where ``valid`` is False.  An
    invalid position may lie past its table, so it is clamped to 0 before
    the gather: JAX clamps such a gather, torch on CUDA faults."""
    ps = pool.shape[3]
    pos = torch.where(valid, pos, 0).long()
    page = torch.gather(tables, -1, pos // ps).long()
    return torch.where(valid, page * ps + pos % ps, _drop_row(pool))


def _decode_core(mdl: DecodeModel, params, pool, tokens, positions,
                 tables, active):
    """Consume one token per slot at ``positions`` (writing its KV; a
    masked slot's goes to the drop page), return the argmax next token per
    slot (int32)."""
    s_ = tokens.shape[0]
    h_, hd = mdl.n_heads, mdl.head_dim
    x = params["embed"][tokens.long()]
    lengths = torch.where(active, positions + 1, 0).to(torch.int32)
    idx = _flat_rows(pool, tables, positions[:, None], active[:, None])[:, 0]
    for li, lp in enumerate(params["layers"]):
        h1 = _rms(x, lp["ln1"])
        q, k = rope_qk((h1 @ lp["wq"]).reshape(s_, h_, hd),
                       (h1 @ lp["wk"]).reshape(s_, h_, hd), positions,
                       base=mdl.rope_base)
        v = (h1 @ lp["wv"]).reshape(s_, h_, hd)
        _write_kv(pool, li, idx, k, v)
        attn = paged_attention(q, pool[li, 0, :-1], pool[li, 1, :-1],
                               tables, lengths)
        x = x + attn.reshape(s_, mdl.dim).to(x.dtype) @ lp["wo"]
        x = _mlp_residual(x, lp)
    x = _rms(x, params["lnf"])
    logits = x @ params["embed"].T
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _verify_core(mdl: DecodeModel, params, pool, tokens, base_pos,
                 tables, active):
    """Target-model scoring of a ``(slots, k+1)`` speculative window:
    writes KV for every window position (masked slots' to the drop page),
    computes greedy targets at each, and the accepted prefix length.
    Attention per window offset goes through the SAME paged_attention
    kernel as decode_step, so accepted tokens are those the plain path
    emits."""
    s_, w_ = tokens.shape
    h_, hd = mdl.n_heads, mdl.head_dim
    pos = base_pos[:, None] + torch.arange(
        w_, dtype=torch.int32, device=tokens.device)[None, :]
    x = params["embed"][tokens.long()]                # (S, W, dim)
    idx = _flat_rows(pool, tables, pos, active[:, None]).reshape(-1)
    lens = [torch.where(active, base_pos + j + 1, 0).to(torch.int32)
            for j in range(w_)]
    for li, lp in enumerate(params["layers"]):
        h1 = _rms(x, lp["ln1"])
        q, k = rope_qk((h1 @ lp["wq"]).reshape(s_, w_, h_, hd),
                       (h1 @ lp["wk"]).reshape(s_, w_, h_, hd), pos,
                       base=mdl.rope_base)
        v = (h1 @ lp["wv"]).reshape(s_, w_, h_, hd)
        _write_kv(pool, li, idx, k.reshape(-1, h_, hd),
                  v.reshape(-1, h_, hd))
        q_cols = q.transpose(0, 1).contiguous()       # (W, S, H, hd)
        attn = torch.stack([
            paged_attention(q_cols[j], pool[li, 0, :-1], pool[li, 1, :-1],
                            tables, lens[j])
            for j in range(w_)], dim=1)               # (S, W, H, hd)
        x = x + attn.reshape(s_, w_, mdl.dim).to(x.dtype) @ lp["wo"]
        x = _mlp_residual(x, lp)
    x = _rms(x, params["lnf"])
    logits = x @ params["embed"].T                    # (S, W, V)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    eq = (tokens[:, 1:] == greedy[:, :-1]).to(torch.int32)
    accepted = torch.cumprod(eq, dim=1).sum(dim=1)    # (S,)
    return greedy, accepted


def _draft_core(mdl: DecodeModel, params, pool, tokens, base_pos,
                tables, active, k: int):
    """k+1 chained draft decode steps: proposes k tokens and leaves the
    draft pool position-aligned with the target's write window
    (positions base..base+k)."""
    tok = tokens
    outs = []
    for j in range(k + 1):
        tok = _decode_core(mdl, params, pool, tok, base_pos + j, tables,
                           active)
        outs.append(tok)
    return torch.stack(outs[:k], dim=1)               # (S, k)


def _draft_window(window, k: int, mdl: DecodeModel, params, pool, tokens,
                  base_pos, tables, active):
    """``_draft_core`` writing verify's window ``(slots, k+1)`` in place:
    each slot's pending token, then its k proposals.  The window never
    leaves the card between the draft and verify executables."""
    window[:, 0] = tokens
    window[:, 1:] = _draft_core(mdl, params, pool, tokens, base_pos, tables,
                                active, k)


def _prefill_core(mdl: DecodeModel, params, pool, tokens, start,
                  chunk_len, table):
    """One prompt chunk for ONE slot: ``tokens (bucket,)`` padded,
    ``start``/``chunk_len`` 0-d int32 tensors (one executable per bucket
    serves every chunk), ``table (pages_per_slot,)`` the slot's page row.
    Writes the chunk's KV (the padded rows' to the drop page) and returns
    the greedy next token after the chunk's last valid position
    (meaningful only on the final chunk)."""
    b_ = tokens.shape[0]
    h_, hd = mdl.n_heads, mdl.head_dim
    ps = pool.shape[3]
    dev = tokens.device
    scale = 1.0 / (hd ** 0.5)
    offs = torch.arange(b_, dtype=torch.int32, device=dev)
    pos = start + offs
    x = params["embed"][tokens.long()]
    idx = _flat_rows(pool, table, pos, offs < chunk_len)
    tab = table.long()
    p_ = table.shape[0]
    kpos = torch.arange(p_ * ps, device=dev)[None, None, :]
    mask = (kpos <= pos.long()[:, None, None]) & (kpos < start + chunk_len)
    for li, lp in enumerate(params["layers"]):
        h1 = _rms(x, lp["ln1"])
        q, k = rope_qk((h1 @ lp["wq"]).reshape(b_, h_, hd),
                       (h1 @ lp["wk"]).reshape(b_, h_, hd), pos,
                       base=mdl.rope_base)
        v = (h1 @ lp["wv"]).reshape(b_, h_, hd)
        _write_kv(pool, li, idx, k, v)
        # the chunk attends its causal prefix (earlier chunks included)
        # over the slot's gathered pages — the chunk itself was just
        # written, so one mask covers intra- and cross-chunk keys
        kctx = pool[li, 0][tab].reshape(p_ * ps, h_, hd)
        vctx = pool[li, 1][tab].reshape(p_ * ps, h_, hd)
        s = torch.einsum("bhd,khd->bhk", q.float(), kctx.float()) * scale
        s = torch.where(mask, s, _NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        pr = torch.where(mask, torch.exp(s - m), 0.0)
        l = pr.sum(dim=-1, keepdim=True)
        l = torch.where(l == 0.0, 1.0, l)
        attn = torch.einsum("bhk,khd->bhd", pr / l, vctx.float())
        x = x + attn.reshape(b_, mdl.dim).to(x.dtype) @ lp["wo"]
        x = _mlp_residual(x, lp)
    x = _rms(x, params["lnf"])
    last = torch.clamp(chunk_len - 1, min=0).long().reshape(1)
    logits = x.index_select(0, last)[0] @ params["embed"].T
    return torch.argmax(logits).to(torch.int32)


# -- the engine --------------------------------------------------------------

class DecodeEngine:
    """Owns the model(s), the paged KV pools and the executables, one per
    exec key.  All knobs default from the environment:
    ``MXNET_DECODE_SLOTS`` / ``MXNET_DECODE_PAGES`` /
    ``MXNET_DECODE_PAGE_SIZE`` / ``MXNET_DECODE_SPEC_K`` /
    ``MXNET_DECODE_PREFILL_CHUNK``.  Runs on the model's device."""

    def __init__(self, model: DecodeModel, *,
                 draft_model: Optional[DecodeModel] = None,
                 spec_k: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 page_size: Optional[int] = None,
                 pages_per_slot: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_floor: int = 16):
        self.model = model
        self.draft = draft_model
        self.device = model.device
        self.max_slots = (int(max_slots) if max_slots is not None
                          else _env_int("MXNET_DECODE_SLOTS", 8))
        self.page_size = (int(page_size) if page_size is not None
                          else _env_int("MXNET_DECODE_PAGE_SIZE", 16))
        self.num_pages = (int(num_pages) if num_pages is not None
                          else _env_int("MXNET_DECODE_PAGES", 256))
        self.spec_k = (int(spec_k) if spec_k is not None
                       else _env_int("MXNET_DECODE_SPEC_K", 4))
        self.prefill_chunk = (int(prefill_chunk)
                              if prefill_chunk is not None
                              else _env_int("MXNET_DECODE_PREFILL_CHUNK",
                                            128))
        self.prefill_floor = min(int(prefill_floor), self.prefill_chunk)
        if draft_model is not None:
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError("draft/target vocab sizes differ")
            if draft_model.device != model.device:
                raise MXNetError(f"draft model on {draft_model.device}, "
                                 f"target on {model.device}")
        self.cache = PagedKVCache(
            layers=model.n_layers, num_pages=self.num_pages,
            page_size=self.page_size, heads=model.n_heads,
            head_dim=model.head_dim, max_slots=self.max_slots,
            pages_per_slot=pages_per_slot, device=self.device)
        self.draft_cache = None
        if draft_model is not None:
            self.draft_cache = PagedKVCache(
                layers=draft_model.n_layers, num_pages=self.num_pages,
                page_size=self.page_size, heads=draft_model.n_heads,
                head_dim=draft_model.head_dim, max_slots=self.max_slots,
                pages_per_slot=self.cache.pages_per_slot,
                device=self.device)
        # verify's window, written by the draft executable on the card
        self._window = (torch.zeros((self.max_slots, self.spec_k + 1),
                                    dtype=torch.int32, device=self.device)
                        if self.spec_enabled else None)
        self._exec: Dict[str, Executable] = {}
        self._exec_token = _amp_policy.cache_token()
        # what the engine's graphs share: a memory pool and a capture stream
        self._owner = CaptureOwner()
        self.compiles = 0

    # -- properties ----------------------------------------------------------

    @property
    def spec_enabled(self) -> bool:
        return self.draft is not None and self.spec_k >= 1

    @property
    def slot_capacity(self) -> int:
        return self.cache.slot_capacity

    def prefill_bucket(self, n: int) -> int:
        return min(_pow2(n, self.prefill_floor), self.prefill_chunk)

    # -- executable plumbing -------------------------------------------------

    def _get_exec(self, key: str, fn, args) -> Executable:
        """Fetch-or-capture one executable WITHOUT running it (the warm
        run before a capture takes zeroed inputs: every slot masked).
        A capture ticks ``compiles`` and ``compile.decode.*``.  The AMP
        policy's cache token is part of every executable's signature:
        when it changes, the executables captured under the old one are
        dropped and captured again."""
        token = _amp_policy.cache_token()
        if token != self._exec_token:
            self._exec.clear()
            self._exec_token = token
        ex = self._exec.get(key)
        if ex is not None:
            return ex
        t0 = time.perf_counter()
        ex = Executable(fn, args, self.device,
                        *self._owner.capture_with(self.device))
        telemetry.record_compile(time.perf_counter() - t0, "decode")
        self._exec[key] = ex
        self.compiles += 1
        return ex

    def _call(self, key: str, fn, args):
        """Stage ``args`` into ``key``'s executable and replay it; its
        outputs hold until the next call of any executable."""
        return self._get_exec(key, fn, args)(*args)

    def _decode_fn(self):
        mdl = self.model
        return partial(_decode_core, mdl, mdl.params, self.cache.buffer)

    def _draft_fn(self):
        dm = self.draft
        return partial(_draft_window, self._window, self.spec_k, dm,
                       dm.params, self.draft_cache.buffer)

    def _verify_fn(self):
        mdl = self.model
        return partial(_verify_core, mdl, mdl.params, self.cache.buffer,
                       self._window)

    @staticmethod
    def _prefill_fn(mdl, cache):
        return partial(_prefill_core, mdl, mdl.params, cache.buffer)

    @staticmethod
    def _slot_args(tokens, positions, active, cache):
        """The static inputs of the slot-grid keys (decode, draft)."""
        return (onp.asarray(tokens, onp.int32),
                onp.asarray(positions, onp.int32), cache.tables,
                onp.asarray(active, bool))

    @staticmethod
    def _prefill_args(padded, start, chunk_len, cache, slot):
        return (padded, onp.int32(start), onp.int32(chunk_len),
                cache.tables[slot])

    @torch.no_grad()
    def warmup(self, prefill_lengths: Sequence[int] = (1,)) -> List[str]:
        """Materialise every executable this engine will run — decode
        (+ draft/verify under speculation) and one prefill (+ draft
        prefill) per bucket covering ``prefill_lengths`` — without running
        a step, and preload the kernel-autotune cache.  On CUDA each is a
        captured graph, so served traffic captures nothing.  Returns the
        exec keys in the reference's order."""
        n_kern = kernels.warm_cache()
        if n_kern:
            get_logger("mxnet_tpu_torch.serving.decode").info(
                "warmup: %d tuned kernel config(s) preloaded", n_kern)
        zeros = onp.zeros((self.max_slots,), onp.int32)
        mask = onp.zeros((self.max_slots,), bool)
        self._get_exec("decode", self._decode_fn(),
                       self._slot_args(zeros, zeros, mask, self.cache))
        keys = ["decode"]
        if self.spec_enabled:
            self._get_exec("draft", self._draft_fn(), self._slot_args(
                zeros, zeros, mask, self.draft_cache))
            self._get_exec("verify", self._verify_fn(),
                           (zeros, self.cache.tables, mask))
            keys += ["draft", "verify"]
        for bucket in sorted({self.prefill_bucket(int(n))
                              for n in prefill_lengths}):
            padded = onp.zeros((bucket,), onp.int32)
            self._get_exec(f"prefill_b{bucket}",
                           self._prefill_fn(self.model, self.cache),
                           self._prefill_args(padded, 0, 0, self.cache, 0))
            keys.append(f"prefill_b{bucket}")
            if self.draft_cache is not None:
                self._get_exec(
                    f"draft_prefill_b{bucket}",
                    self._prefill_fn(self.draft, self.draft_cache),
                    self._prefill_args(padded, 0, 0, self.draft_cache, 0))
                keys.append(f"draft_prefill_b{bucket}")
        return keys

    # -- device steps --------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, tokens, positions, active):
        """One non-speculative engine step over the full slot grid.
        Returns the next token per slot (host numpy int32)."""
        nxt = self._call("decode", self._decode_fn(), self._slot_args(
            tokens, positions, active, self.cache))
        return nxt.cpu().numpy()

    @torch.no_grad()
    def spec_step(self, tokens, base_pos, active):
        """Draft k proposals into verify's window, then verify in one
        target pass.  Returns (greedy (S, k+1), accepted (S,)) host
        numpy."""
        tok, pos, _, act = args = self._slot_args(tokens, base_pos, active,
                                                  self.draft_cache)
        self._call("draft", self._draft_fn(), args)
        greedy, accepted = self._call("verify", self._verify_fn(),
                                      (pos, self.cache.tables, act))
        return greedy.cpu().numpy(), accepted.cpu().numpy()

    @torch.no_grad()
    def prefill_chunk_step(self, slot: int, chunk, start: int) -> int:
        """Feed one prompt chunk for ``slot`` (padded into its pow2
        bucket); returns the greedy next token after the chunk."""
        bucket = self.prefill_bucket(len(chunk))
        padded = onp.zeros((bucket,), onp.int32)
        padded[:len(chunk)] = chunk
        if self.draft_cache is not None:  # first: the target's output is read
            self._call(f"draft_prefill_b{bucket}",
                       self._prefill_fn(self.draft, self.draft_cache),
                       self._prefill_args(padded, start, len(chunk),
                                          self.draft_cache, slot))
        nxt = self._call(f"prefill_b{bucket}",
                         self._prefill_fn(self.model, self.cache),
                         self._prefill_args(padded, start, len(chunk),
                                            self.cache, slot))
        return int(nxt)

    # -- slot page lifecycle -------------------------------------------------

    def acquire_slot(self, slot: int, tokens: int) -> None:
        self.cache.acquire(slot, tokens)
        if self.draft_cache is not None:
            try:
                self.draft_cache.acquire(slot, tokens)
            except Exception:
                self.cache.release(slot)
                raise

    def release_slot(self, slot: int) -> int:
        n = self.cache.release(slot)
        if self.draft_cache is not None:
            self.draft_cache.release(slot)
        return n

    def can_admit(self, tokens: int) -> bool:
        need = self.cache.pages_for(tokens)
        ok = self.cache.allocator.available >= need
        if self.draft_cache is not None:
            ok = ok and self.draft_cache.allocator.available >= need
        return ok

    def stats(self) -> dict:
        return {"compiles": self.compiles,
                "executables": sorted(self._exec),
                "max_slots": self.max_slots,
                "page_size": self.page_size,
                "num_pages": self.num_pages,
                "pages_used": self.cache.pages_used(),
                "slot_capacity": self.slot_capacity,
                "spec_k": self.spec_k if self.spec_enabled else 0}
