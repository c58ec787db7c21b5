#!/usr/bin/env python3
"""Compare the rope kernel (K5) and a full-width decode step of the
PyTorch/CUDA port across checkouts of the repository, on one GPU.

    python3 tools/rope_ab.py [TREE ...]

Each TREE is the root of a checkout (default: the one holding this
script).  The trees run in the order given, each in a process of its own
that imports that tree's ``chip_smoke.py`` and ``mxnet_tpu_torch``, so
list them as parent, change, change, parent to bracket any drift of the
host.  Each process builds the tree's paged-attention and rope kernels
and prints one JSON line:

- ``rope``: K5 at the decode shape (q or k of 8 slots, (8, 8, 64) fp32,
  positions in [0, 4096)): the median event ms under a cold L2
  (``chip_smoke.device_ms``), torch.profiler device ms per launch, and
  host µs per call (a perf_counter over 1000 back-to-back calls, one
  synchronise at the end); the same for ``rope_qk`` (q and k in one
  call) where the tree has it; the timer's floor (an empty kernel
  through the same event pair) and the host µs of an empty torch kernel;
- ``decode_step``: the serve phase's model (vocab 32000, dim 512, 8
  heads, 8 layers, seed-0 weights) with 8 slots at the served lengths:
  host ms per step in 5 blocks of 20 steps (each block's mean, and their
  median), and under torch.profiler over 20 more the host ms, device
  busy ms, idle share and K5 and paged-attention kernels per step.

The last line is ``{"trees": [...]}`` with every process's line.  Exits
non-zero without a GPU.
"""
import json
import os
import subprocess
import sys
import time

import numpy as onp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(torch, fn, calls=1000):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def child(tree):
    """Measure one tree (run in a process of its own)."""
    import torch
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import paged_attention as pa_mod
    from mxnet_tpu_torch.ops import rope as rope_mod
    from mxnet_tpu_torch.serving import DecodeEngine, DecodeModel
    if not os.path.abspath(rope_mod.__file__).startswith(tree):
        raise AssertionError(f"imported {rope_mod.__file__}, not {tree}")
    rope_mod.build()
    pa_mod.build()
    out = {"tree": tree, "gpu": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]}

    rng = onp.random.RandomState(11)
    x, x2 = (torch.as_tensor(rng.randn(cs.SLOTS, cs.HEADS, cs.HEAD_DIM)
                             * 0.5, dtype=torch.float32).cuda()
             for _ in range(2))
    pos = torch.as_tensor(rng.randint(0, 4096, size=(cs.SLOTS,)),
                          dtype=torch.int32).cuda()
    calls = {"rope": lambda: rope_mod.rope(x, pos)}
    if hasattr(rope_mod, "rope_qk"):
        calls["rope_qk"] = lambda: rope_mod.rope_qk(x, x2, pos)
    rope = {"timer_floor_ms": cs.device_ms(torch,
                                           lambda: torch.cuda._sleep(0)),
            "empty_torch_kernel_host_us": host_us(
                torch, lambda: torch.cuda._sleep(0))}
    for name, fn in calls.items():
        rope[name] = {"ms": cs.device_ms(torch, fn),
                      "profiler_ms": cs.profiler_ms(torch, fn,
                                                    "rope_kernel"),
                      "host_us_per_call": host_us(torch, fn)}
    out["rope"] = rope

    model = DecodeModel(cs.VOCAB, dim=cs.DIM, n_heads=cs.HEADS,
                        n_layers=cs.LAYERS, mlp_ratio=cs.MLP, seed=0)
    eng = DecodeEngine(model, max_slots=cs.SLOTS, page_size=cs.PAGE,
                       pages_per_slot=cs.PAGES_PER_SLOT,
                       num_pages=cs.NUM_PAGES)
    prng = onp.random.RandomState(1)          # the serve phase's prompts
    lengths = []
    for _ in range(cs.SLOTS):
        n = int(prng.randint(32, 1001))
        prng.randint(0, cs.VOCAB, size=n)
        lengths.append(n + 31)                  # at their last decode step
    for s, n in enumerate(lengths):
        eng.acquire_slot(s, n + 1)
    toks = onp.ones(cs.SLOTS, onp.int32)
    positions = onp.asarray(lengths, onp.int32)
    act = onp.ones(cs.SLOTS, bool)

    def step():
        eng.decode_step(toks, positions, act)   # host numpy: synced

    for _ in range(3):
        step()
    blocks = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        blocks.append((time.perf_counter() - t0) * 1e3 / 20)
    wall, busy, top = cs.profiled(torch, step, 20)[:3]
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            step()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    out["decode_step"] = {
        "lengths": lengths, "host_ms": sorted(blocks)[2],
        "host_ms_blocks": blocks, "profiled_host_ms": wall,
        "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
        "rope_kernels_per_step": sum(e.count for e in kern
                                     if "rope_kernel" in e.key) / 5,
        "paged_attention_kernels_per_step": sum(
            e.count for e in kern if "paged_attention_kernel" in e.key) / 5,
        "kernels_per_step": sum(e.count for e in kern) / 5}
    print(json.dumps(out), flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(os.path.abspath(sys.argv[2]))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("rope_ab: torch.cuda.is_available() is False; this script "
              "measures the port on a GPU", file=sys.stderr)
        return 2
    trees = [os.path.abspath(t) for t in sys.argv[1:]] or [ROOT]
    results = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    print(json.dumps({"trees": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
