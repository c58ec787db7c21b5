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

The port runs eagerly (no ``jit``).  ``compiles`` keeps the reference's
meaning of *executables materialised*: it ticks on the first use of each
exec key (``decode``, ``prefill_b{bucket}``, ``draft``, ``verify``,
``draft_prefill_b{bucket}``), so the fixed-shape contract stays
observable.  Unlike the reference, which returned a new pool from each
executable, the steps write K/V into the pool in place.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Set

import numpy as onp
import torch
import torch.nn.functional as F

from ... import telemetry
from ...base import MXNetError
from ...context import resolve_device
from ...ops.paged_attention import paged_attention
from ...ops.rope import rope_qk, rope_reference
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

def _write_kv(pool, li, idx, k, v):
    """Copy K/V rows into layer ``li``'s pages at flat positions ``idx``
    (page * page_size + offset), IN PLACE.  Callers pass only the valid
    rows: torch has no drop mode for masked ones."""
    _, _, num_pages, ps, h_, hd = pool.shape
    pool[li, 0].view(num_pages * ps, h_, hd).index_copy_(
        0, idx, k.to(pool.dtype))
    pool[li, 1].view(num_pages * ps, h_, hd).index_copy_(
        0, idx, v.to(pool.dtype))


def _mlp_residual(x, lp):
    return x + _gelu(_rms(x, lp["ln2"]) @ lp["w1"]) @ lp["w2"]


def _decode_core(mdl: DecodeModel, params, pool, tokens, positions,
                 tables, active, rows):
    """Consume one token per slot at ``positions`` (writing its KV for
    the ``rows`` = active slot indices), return the argmax next token per
    slot (int32)."""
    s_ = tokens.shape[0]
    h_, hd = mdl.n_heads, mdl.head_dim
    ps = pool.shape[3]
    x = params["embed"][tokens.long()]
    lengths = torch.where(active, positions + 1, 0).to(torch.int32)
    pos_r = positions[rows].long()
    idx = tables[rows, pos_r // ps].long() * ps + pos_r % ps
    for li, lp in enumerate(params["layers"]):
        h1 = _rms(x, lp["ln1"])
        q, k = rope_qk((h1 @ lp["wq"]).reshape(s_, h_, hd),
                       (h1 @ lp["wk"]).reshape(s_, h_, hd), positions,
                       base=mdl.rope_base)
        v = (h1 @ lp["wv"]).reshape(s_, h_, hd)
        _write_kv(pool, li, idx, k[rows], v[rows])
        attn = paged_attention(q, pool[li, 0], pool[li, 1], tables,
                               lengths)
        x = x + attn.reshape(s_, mdl.dim).to(x.dtype) @ lp["wo"]
        x = _mlp_residual(x, lp)
    x = _rms(x, params["lnf"])
    logits = x @ params["embed"].T
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _verify_core(mdl: DecodeModel, params, pool, tokens, base_pos,
                 tables, active, rows):
    """Target-model scoring of a ``(slots, k+1)`` speculative window:
    writes KV for every window position of the active rows, computes
    greedy targets at each, and the accepted prefix length.  Attention
    per window offset goes through the SAME paged_attention kernel as
    decode_step, so accepted tokens are those the plain path emits."""
    s_, w_ = tokens.shape
    h_, hd = mdl.n_heads, mdl.head_dim
    ps = pool.shape[3]
    pos = base_pos[:, None] + torch.arange(
        w_, dtype=torch.int32, device=tokens.device)[None, :]
    x = params["embed"][tokens.long()]                # (S, W, dim)
    pos_r = pos[rows].long()                          # (A, W)
    idx = (torch.gather(tables[rows].long(), 1, pos_r // ps) * ps
           + pos_r % ps).reshape(-1)
    for li, lp in enumerate(params["layers"]):
        h1 = _rms(x, lp["ln1"])
        q, k = rope_qk((h1 @ lp["wq"]).reshape(s_, w_, h_, hd),
                       (h1 @ lp["wk"]).reshape(s_, w_, h_, hd), pos,
                       base=mdl.rope_base)
        v = (h1 @ lp["wv"]).reshape(s_, w_, h_, hd)
        _write_kv(pool, li, idx, k[rows].reshape(-1, h_, hd),
                  v[rows].reshape(-1, h_, hd))
        q_cols = q.transpose(0, 1).contiguous()       # (W, S, H, hd)
        cols = []
        for j in range(w_):
            lens_j = torch.where(active, base_pos + j + 1,
                                 0).to(torch.int32)
            cols.append(paged_attention(q_cols[j], pool[li, 0],
                                        pool[li, 1], tables, lens_j))
        attn = torch.stack(cols, dim=1)               # (S, W, H, hd)
        x = x + attn.reshape(s_, w_, mdl.dim).to(x.dtype) @ lp["wo"]
        x = _mlp_residual(x, lp)
    x = _rms(x, params["lnf"])
    logits = x @ params["embed"].T                    # (S, W, V)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    eq = (tokens[:, 1:] == greedy[:, :-1]).to(torch.int32)
    accepted = torch.cumprod(eq, dim=1).sum(dim=1)    # (S,)
    return greedy, accepted


def _draft_core(mdl: DecodeModel, params, pool, tokens, base_pos,
                tables, active, rows, k: int):
    """k+1 chained draft decode steps: proposes k tokens and leaves the
    draft pool position-aligned with the target's write window
    (positions base..base+k)."""
    tok = tokens
    outs = []
    for j in range(k + 1):
        tok = _decode_core(mdl, params, pool, tok, base_pos + j, tables,
                           active, rows)
        outs.append(tok)
    return torch.stack(outs[:k], dim=1)               # (S, k)


def _prefill_core(mdl: DecodeModel, params, pool, tokens, start: int,
                  chunk_len: int, table):
    """One prompt chunk for ONE slot: ``tokens (bucket,)`` padded,
    ``table (pages_per_slot,)`` the slot's page row.  Writes the valid
    rows' KV and returns the greedy next token after the chunk's last
    valid position (meaningful only on the final chunk)."""
    b_ = tokens.shape[0]
    h_, hd = mdl.n_heads, mdl.head_dim
    ps = pool.shape[3]
    dev = tokens.device
    scale = 1.0 / (hd ** 0.5)
    pos = start + torch.arange(b_, dtype=torch.int32, device=dev)
    total = start + chunk_len
    x = params["embed"][tokens.long()]
    pos_v = pos[:chunk_len].long()
    idx = table.long()[pos_v // ps] * ps + pos_v % ps
    p_ = table.shape[0]
    kpos = torch.arange(p_ * ps, device=dev)[None, None, :]
    mask = (kpos <= pos.long()[:, None, None]) & (kpos < total)
    for li, lp in enumerate(params["layers"]):
        h1 = _rms(x, lp["ln1"])
        q, k = rope_qk((h1 @ lp["wq"]).reshape(b_, h_, hd),
                       (h1 @ lp["wk"]).reshape(b_, h_, hd), pos,
                       base=mdl.rope_base)
        v = (h1 @ lp["wv"]).reshape(b_, h_, hd)
        _write_kv(pool, li, idx, k[:chunk_len], v[:chunk_len])
        # the chunk attends its causal prefix (earlier chunks included)
        # over the slot's gathered pages — the chunk itself was just
        # written, so one mask covers intra- and cross-chunk keys
        kctx = pool[li, 0][table.long()].reshape(p_ * ps, h_, hd)
        vctx = pool[li, 1][table.long()].reshape(p_ * ps, h_, hd)
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
    logits = x[max(chunk_len - 1, 0)] @ params["embed"].T
    return torch.argmax(logits).to(torch.int32)


# -- the engine --------------------------------------------------------------

class DecodeEngine:
    """Owns the model(s), the paged KV pools and the exec-key ledger.
    All knobs default from the environment: ``MXNET_DECODE_SLOTS`` /
    ``MXNET_DECODE_PAGES`` / ``MXNET_DECODE_PAGE_SIZE`` /
    ``MXNET_DECODE_SPEC_K`` / ``MXNET_DECODE_PREFILL_CHUNK``.  Runs on
    the model's device."""

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
        self._exec: Set[str] = set()
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

    # -- exec-key plumbing ---------------------------------------------------

    def _call(self, key: str, fn, *args):
        """Run one device path; the first use of ``key`` counts as one
        materialised executable (``compiles``, ``compile.decode.*``)."""
        if key in self._exec:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        telemetry.record_compile(time.perf_counter() - t0, "decode")
        self._exec.add(key)
        self.compiles += 1
        return out

    def _host(self, a, dtype):
        return torch.from_numpy(onp.ascontiguousarray(a, dtype)).to(
            self.device)

    def _tables(self, cache):
        return self._host(cache.tables, onp.int32)

    def _slot_args(self, tokens, positions, active):
        act = onp.asarray(active, bool)
        return (self._host(tokens, onp.int32),
                self._host(positions, onp.int32),
                self._host(act, bool),
                self._host(onp.flatnonzero(act), onp.int64))

    # -- device steps --------------------------------------------------------

    @torch.no_grad()
    def decode_step(self, tokens, positions, active):
        """One non-speculative engine step over the full slot grid.
        Returns the next token per slot (host numpy int32)."""
        mdl = self.model
        tok, pos, act, rows = self._slot_args(tokens, positions, active)
        nxt = self._call("decode", _decode_core, mdl, mdl.params,
                         self.cache.pool, tok, pos,
                         self._tables(self.cache), act, rows)
        return nxt.cpu().numpy()

    @torch.no_grad()
    def spec_step(self, tokens, base_pos, active):
        """Draft k proposals then verify in one target pass.
        Returns (greedy (S, k+1), accepted (S,)) host numpy."""
        mdl, dm, k = self.model, self.draft, self.spec_k
        tok, pos, act, rows = self._slot_args(tokens, base_pos, active)
        props = self._call("draft", _draft_core, dm, dm.params,
                           self.draft_cache.pool, tok, pos,
                           self._tables(self.draft_cache), act, rows, k)
        window = torch.cat([tok[:, None], props], dim=1)
        greedy, accepted = self._call(
            "verify", _verify_core, mdl, mdl.params, self.cache.pool,
            window, pos, self._tables(self.cache), act, rows)
        return greedy.cpu().numpy(), accepted.cpu().numpy()

    @torch.no_grad()
    def prefill_chunk_step(self, slot: int, chunk, start: int) -> int:
        """Feed one prompt chunk for ``slot`` (padded into its pow2
        bucket); returns the greedy next token after the chunk."""
        mdl = self.model
        bucket = self.prefill_bucket(len(chunk))
        padded = onp.zeros((bucket,), onp.int32)
        padded[:len(chunk)] = chunk
        tok = self._host(padded, onp.int32)
        nxt = self._call(f"prefill_b{bucket}", _prefill_core, mdl,
                         mdl.params, self.cache.pool, tok, int(start),
                         len(chunk),
                         self._host(self.cache.tables[slot], onp.int32))
        if self.draft_cache is not None:
            dm = self.draft
            self._call(f"draft_prefill_b{bucket}", _prefill_core, dm,
                       dm.params, self.draft_cache.pool, tok, int(start),
                       len(chunk),
                       self._host(self.draft_cache.tables[slot], onp.int32))
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
