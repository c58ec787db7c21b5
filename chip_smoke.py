#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the script
exits non-zero and prints no result:

1. build   — nvcc-build the paged_attention library from
             mxnet_tpu_torch/csrc/ and compile the Triton rope kernel
             (both at once) into build/torch_kernels/.
2. parity  — each kernel against its plain PyTorch version on the card,
             at the decode-serving shapes (fp32 atol/rtol 1e-4, bf16
             2e-2).
3. serve   — the decode-serving path at the full width of the repo's
             transformer LM (vocab 32000, dim 512, 8 heads, 8 layers,
             2048-position slots): DecodeModel → DecodeEngine →
             DecodeScheduler → ServingServer.generate answers 16
             overlapping requests, then 2 short ones that must equal the
             dense greedy reference.  Kernel launch counts are zeroed
             just before and read just after; both kernels must have
             launched and no plain version may have run.
4. spec    — 4 of those requests again with a draft model and spec_k=4;
             the output must be token-identical.
5. times   — each kernel's median time (CUDA events) at the serve
             shapes beside its bound, its plain version's time and its
             launches per engine step.
6. profile — torch.profiler over one decode step and one prefill chunk
             at the serve shapes: host ms, device busy ms, idle share and
             the kernels by device time.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU, and
outside a checkout of the repository (it imports the port from beside
itself).
"""
import json
import os
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as onp

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # H100 SXM fp32 outside the tensor cores

VOCAB, DIM, HEADS, LAYERS, MLP = 32000, 512, 8, 8, 4
SLOTS, PAGE, PAGES_PER_SLOT, NUM_PAGES = 8, 16, 128, 1024
HEAD_DIM = DIM // HEADS
SPEC_K = 4
NO_LIBRARY = ("no single PyTorch call computes it: scaled_dot_product_"
              "attention needs the pages gathered into a dense tensor "
              "first, and torch has no rotary-embedding operator")


def emit(obj):
    print(json.dumps(obj), flush=True)


def max_err(got, ref, atol, rtol):
    import torch
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(f"max |err| {float(err.max())} beyond atol "
                             f"{atol} rtol {rtol}")
    return float(err.max())


def phase_build(torch, rope_mod, pa_mod):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()

    def timed(fn):
        s = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - s

    with ThreadPoolExecutor(2) as ex:
        pa = ex.submit(timed, pa_mod.build)
        rp = ex.submit(timed, rope_mod.build)
        (log, nvcc_s), pa_s = pa.result()
        _, rope_s = rp.result()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "gpu": smi,
          "seconds": round(time.perf_counter() - t0, 3),
          "paged_attention_nvcc_s": round(nvcc_s, 3),
          "paged_attention_s": round(pa_s, 3),
          "rope_triton_s": round(rope_s, 3), "ptxas": ptxas})
    return smi


def rope_case(torch, r, dtype, seed):
    rng = onp.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(r, HEADS, HEAD_DIM) * 0.5).to(
        "cuda", dtype)
    pos = rng.randint(0, PAGES_PER_SLOT * PAGE, size=(r,))
    pos[0] = PAGES_PER_SLOT * PAGE - 1
    return x, torch.as_tensor(pos, dtype=torch.int32, device="cuda")


def pa_case(torch, lengths, dtype, seed, pool_k=None, pool_v=None):
    rng = onp.random.RandomState(seed)
    s_ = len(lengths)
    q = torch.as_tensor(rng.randn(s_, HEADS, HEAD_DIM)).to("cuda", dtype)
    if pool_k is None:
        shape = (NUM_PAGES, PAGE, HEADS, HEAD_DIM)
        pool_k = torch.as_tensor(rng.randn(*shape),
                                 dtype=torch.float32).cuda()
        pool_v = torch.as_tensor(rng.randn(*shape),
                                 dtype=torch.float32).cuda()
    tables = onp.zeros((s_, PAGES_PER_SLOT), onp.int32)
    perm = rng.permutation(NUM_PAGES)
    used = 0
    for i, n in enumerate(lengths):      # pages past a slot's length: 0
        need = -(-int(n) // PAGE)
        tables[i, :need] = perm[used:used + need]
        used += need
    return (q, pool_k, pool_v,
            torch.as_tensor(tables, device="cuda"),
            torch.as_tensor(onp.asarray(lengths, onp.int32), device="cuda"))


def phase_parity(torch, rope_mod, pa_mod):
    out = {"phase": "parity", "rope": [], "paged_attention": []}
    errs = {}
    for r in (SLOTS, SLOTS * (SPEC_K + 1), 128):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x, pos = rope_case(torch, r, dtype, seed=r)
            got = rope_mod.rope(x, pos)
            torch.cuda.synchronize()
            e = max_err(got, rope_mod.rope_reference(x, pos), tol, tol)
            out["rope"].append({"r": r, "dtype": str(dtype), "max_abs_err": e})
            if r == SLOTS and dtype == torch.float32:
                errs["rope"] = e
    x, _ = rope_case(torch, SLOTS, torch.float32, seed=3)   # scalar position
    last = PAGES_PER_SLOT * PAGE - 1
    e = max_err(rope_mod.rope(x, last), rope_mod.rope_reference(x, last),
                1e-4, 1e-4)
    out["rope"].append({"r": SLOTS, "dtype": str(torch.float32),
                        "position": last, "max_abs_err": e})
    lengths = [0, 1, 17, PAGES_PER_SLOT * PAGE, 300, 999, 64, 1032]
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        args = pa_case(torch, lengths, dtype, seed=5)
        got = pa_mod.paged_attention(*args)
        torch.cuda.synchronize()
        e = max_err(got, pa_mod.paged_attention_reference(*args), tol, tol)
        if bool(got[0].any()):
            raise AssertionError("length-0 slot did not give exact zeros")
        out["paged_attention"].append(
            {"lengths": lengths, "dtype": str(dtype), "max_abs_err": e})
        if dtype == torch.float32:
            errs["paged_attention"] = e
    emit(out)
    return errs


class StepRecords:
    """Telemetry sink keeping the scheduler's step records."""

    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def summary(self):
        recs = [r for r in self.records if "decode" in r]
        pre = [r["host_ms"] for r in recs if r["decode"]["prefill_tokens"]]
        dec = [r["host_ms"] for r in recs
               if not r["decode"]["prefill_tokens"]]
        return {"steps": len(recs), "host_ms": sum(pre) + sum(dec),
                "steps_with_prefill": len(pre),
                "host_ms_steps_with_prefill": sum(pre),
                "decode_only_steps": len(dec),
                "host_ms_decode_only_steps": sum(dec)}


def reset_counts(*fns):
    for f in fns:
        f.launches = 0
        f.plain_calls = 0


def serve_requests(srv, prompts, max_new, stagger_s):
    """Each request from its own thread, arrivals staggered so slots
    overlap; returns (outputs, per-request latency s, wall s)."""
    outs = [None] * len(prompts)
    lat = [0.0] * len(prompts)
    errors = []
    t_start = time.perf_counter()

    def one(i):
        time.sleep(i * stagger_s)
        t0 = time.perf_counter()
        try:
            outs[i] = srv.generate(prompts[i], max_new_tokens=max_new,
                                   timeout_ms=120000)
        except Exception as e:          # re-raised below, on the main thread
            errors.append(e)
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads):
        raise AssertionError("a generate request did not return")
    return outs, lat, time.perf_counter() - t_start


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def phase_serve(torch, rope_mod, pa_mod):
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import (DecodeEngine, DecodeModel,
                                         DecodeScheduler, ServingServer, slo)
    t0 = time.perf_counter()
    model = DecodeModel(VOCAB, dim=DIM, n_heads=HEADS, n_layers=LAYERS,
                        mlp_ratio=MLP, seed=0)
    eng = DecodeEngine(model, max_slots=SLOTS, page_size=PAGE,
                       pages_per_slot=PAGES_PER_SLOT, num_pages=NUM_PAGES)
    srv = ServingServer(decoder=DecodeScheduler(eng))
    setup_s = time.perf_counter() - t0
    rng = onp.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, VOCAB,
                                             size=rng.randint(32, 1001))]
               for _ in range(16)]
    short = [[int(t) for t in rng.randint(0, VOCAB, size=n)]
             for n in (48, 128)]
    n_seen = len(slo.recent_requests())
    steps = StepRecords()
    telemetry.add_sink(steps)
    reset_counts(rope_mod.rope, pa_mod.paged_attention)
    outs, lat, wall = serve_requests(srv, prompts, 32, stagger_s=0.05)
    telemetry.remove_sink(steps)
    short_outs = [srv.generate(p, max_new_tokens=16, timeout_ms=120000)
                  for p in short]
    torch.cuda.synchronize()
    counts = {f.__name__: {"launches": f.launches,
                           "plain_calls": f.plain_calls}
              for f in (rope_mod.rope, pa_mod.paged_attention)}
    entries = slo.recent_requests()[n_seen:]
    srv.stop()
    for name, c in counts.items():
        if c["launches"] <= 0 or c["plain_calls"] != 0:
            raise AssertionError(f"{name} did not serve through its kernel:"
                                 f" {c}")
    for o in outs:
        if len(o) != 32 or not all(0 <= t < VOCAB for t in o):
            raise AssertionError(f"bad generation {o[:8]}...")
    for p, o in zip(short, short_outs):
        ref = model.greedy_reference(p, 16)
        if o != ref:
            raise AssertionError(f"paged path {o} != dense reference {ref}")
    ttft = [e["ttft_ms"] for e in entries[:len(prompts)] if "ttft_ms" in e]
    emit({"phase": "serve", "requests": len(prompts), "max_new_tokens": 32,
          "prompt_tokens": sum(map(len, prompts)),
          "model": {"vocab": VOCAB, "dim": DIM, "heads": HEADS,
                    "layers": LAYERS, "mlp_ratio": MLP,
                    "slot_positions": PAGES_PER_SLOT * PAGE},
          "setup_s": round(setup_s, 3), "wall_s": round(wall, 4),
          "tokens_per_s": round(len(prompts) * 32 / wall, 2),
          "latency_ms_p50": round(pct(lat, 50) * 1e3, 2),
          "latency_ms_p95": round(pct(lat, 95) * 1e3, 2),
          "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p95": pct(ttft, 95),
          "short_requests_match_dense_reference": len(short),
          "scheduler_steps": steps.summary(),
          "engine": eng.stats(), "counts": counts})
    return model, eng, prompts, outs, counts


def phase_spec(torch, pa_mod, model, prompts, outs):
    from mxnet_tpu_torch.serving import (DecodeEngine, DecodeModel,
                                         DecodeScheduler, ServingServer)
    draft = DecodeModel(VOCAB, dim=256, n_heads=4, n_layers=2, seed=7)
    eng = DecodeEngine(model, draft_model=draft, spec_k=SPEC_K,
                       max_slots=SLOTS, page_size=PAGE,
                       pages_per_slot=PAGES_PER_SLOT, num_pages=NUM_PAGES)
    sch = DecodeScheduler(eng)
    srv = ServingServer(decoder=sch)
    before = pa_mod.paged_attention.launches
    got, _lat, wall = serve_requests(srv, prompts[:4], 32, stagger_s=0.0)
    st = sch.stats()
    srv.stop()
    if got != outs[:4]:
        raise AssertionError("speculative output differs from plain path")
    if pa_mod.paged_attention.launches <= before:
        raise AssertionError("verify did not launch paged_attention")
    emit({"phase": "spec", "requests": 4, "spec_k": SPEC_K,
          "identical_to_plain": True, "wall_s": round(wall, 4),
          "spec_proposed": st["spec_proposed"],
          "spec_accepted": st["spec_accepted"],
          "paged_attention_launches": pa_mod.paged_attention.launches
          - before})


def device_ms(torch, fn, runs=50):
    """Median device ms of one ``fn()`` with a cold L2: a 256 MiB write
    before each timed call evicts the 50 MB L2 (as the other layers'
    pages do between two calls in a decode step) and keeps the device
    busy while the host enqueues the call, so the event pair brackets
    device time, not host overhead."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda.synchronize()
    for a, b in pairs:
        flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in pairs)[runs // 2]


def phase_times(torch, rope_mod, pa_mod, eng, prompts, counts, errs, smi):
    rows = []
    # rope at the decode shape (q or k of 8 slots: R=8, H=8, D=64)
    x, pos = rope_case(torch, SLOTS, torch.float32, seed=11)
    ms = device_ms(torch, lambda: rope_mod.rope(x, pos))
    plain = device_ms(torch, lambda: rope_mod.rope_reference(x, pos))
    nbytes = 2 * x.numel() * 4 + pos.numel() * 4
    ops = 6 * x.numel() // 2 + 3 * SLOTS * HEAD_DIM // 2
    rows.append(("rope", "triton", "mxnet_tpu_torch/ops/rope.py",
                 "mxnet_tpu/ops/rope.py:63", ms, plain, nbytes, ops))
    # paged attention: layer 0 of the served pool, lengths of 8 served
    # requests at their last decode step (prompt + 31 generated)
    lengths = [len(p) + 31 for p in prompts[:SLOTS]]
    q, _, _, tables, lens = pa_case(torch, lengths, torch.float32, seed=12,
                                    pool_k=eng.cache.pool[0, 0],
                                    pool_v=eng.cache.pool[0, 1])
    kp, vp = eng.cache.pool[0, 0], eng.cache.pool[0, 1]
    ms = device_ms(torch, lambda: pa_mod.paged_attention(q, kp, vp, tables,
                                                         lens))
    plain = device_ms(torch, lambda: pa_mod.paged_attention_reference(
        q, kp, vp, tables, lens))
    live = sum(lengths)
    nbytes = (2 * live * HEADS * HEAD_DIM * 4 + 2 * q.numel() * 4
              + sum(-(-n // PAGE) for n in lengths) * 4 + len(lengths) * 4)
    ops = 4 * live * HEADS * HEAD_DIM + 5 * live * HEADS
    rows.append(("paged_attention", "cuda",
                 "mxnet_tpu_torch/csrc/paged_attention.cu",
                 "mxnet_tpu/ops/paged_attention.py:71", ms, plain, nbytes,
                 ops))
    per_step = {"rope": {"decode_step": 2 * LAYERS,
                         "verify": 2 * LAYERS, "prefill_chunk": 2 * LAYERS},
                "paged_attention": {"decode_step": LAYERS,
                                    "verify": LAYERS * (SPEC_K + 1),
                                    "prefill_chunk": 0}}
    kernels = []
    for name, route, src, repl, ms, plain, nbytes, ops in rows:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": route, "source": src, "replaces": repl,
            "launches": counts[name]["launches"],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    emit({"phase": "times", "gpu": smi, "paged_attention_lengths": lengths,
          "launches_per_step": per_step, "library_ms_null_reason": NO_LIBRARY,
          "kernels": [{k: r[k] for k in ("name", "ms", "plain_ms",
                                         "bound_ms")} for r in kernels]})
    return kernels


def profiled(torch, fn, n):
    """Host wall ms per call of ``fn`` (which ends in a device sync),
    device busy ms per call and the kernels by device time, from
    torch.profiler over ``n`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kern = sorted(((e.self_device_time_total / 1e3 / n, e.count / n, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    busy = sum(k[0] for k in kern)
    return wall, busy, [{"kernel": k[:90], "ms_per_call": ms,
                         "launches_per_call": c} for ms, c, k in kern[:8]]


def phase_profile(torch, eng, prompts):
    """Where one decode step and one prefill chunk spend their time, at
    the serve shapes (8 active slots at the served lengths)."""
    lengths = [len(p) + 31 for p in prompts[:SLOTS]]
    for s, n in enumerate(lengths):
        eng.acquire_slot(s, max(n + 1, eng.prefill_chunk))
    toks = onp.ones(SLOTS, onp.int32)
    pos = onp.asarray(lengths, onp.int32)
    act = onp.ones(SLOTS, bool)

    def step():
        eng.decode_step(toks, pos, act)       # returns host numpy: synced

    chunk = list(range(1, eng.prefill_chunk + 1))

    def prefill():
        eng.prefill_chunk_step(0, chunk, 0)
        torch.cuda.synchronize()

    out = {"phase": "profile"}
    for name, fn in (("decode_step", step), ("prefill_chunk_128", prefill)):
        for _ in range(3):
            fn()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        plain_ms = (time.perf_counter() - t0) * 1e3 / 20
        wall, busy, top = profiled(torch, fn, 20)
        out[name] = {"host_ms": plain_ms, "profiled_host_ms": wall,
                     "device_busy_ms": busy,
                     "device_idle_share": 1 - busy / wall,
                     "top_kernels": top}
    for s in range(SLOTS):
        eng.release_slot(s)
    emit(out)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script measures the port on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch.ops import paged_attention as pa_mod
    from mxnet_tpu_torch.ops import rope as rope_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_build(torch, rope_mod, pa_mod)
    errs = phase_parity(torch, rope_mod, pa_mod)
    model, eng, prompts, outs, counts = phase_serve(torch, rope_mod, pa_mod)
    phase_spec(torch, pa_mod, model, prompts, outs)
    kernels = phase_times(torch, rope_mod, pa_mod, eng, prompts, counts,
                          errs, smi)
    phase_profile(torch, eng, prompts)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
