#!/usr/bin/env python3
"""Compare two routes of ResNet-50's training-mode BatchNorm on one GPU:
``native`` (``torch.native_batch_norm``, PyTorch's own CUDA kernels) and
``cudnn`` (``torch.cudnn_batch_norm``, whose scale and shift must share
the input's type).  Both return the batch mean and 1/sqrt(var
+ eps), from which the port's ``ops.nn.batch_norm`` derives the variance.

    python3 tools/resnet_bn_ab.py

1. ``shapes``: every BatchNorm input of ResNet-50 v1 at chip_smoke's
   headline row (batch 256, 224 x 224, bf16), collected from one forward;
   for each distinct shape the median CUDA-event ms of a forward and a
   backward (``torch.autograd.grad`` of out, dy fixed) under each route,
   and the summed ms of all 53 layers; the routes' largest differences
   in out, dx, dgamma and dbeta (relative to each one's largest value).
   A route that raises is reported under ``errors`` and left out.
2. ``step``: chip_smoke's headline trainer (``resnet_trainer``, bf16, SGD)
   with ``ops.nn.batch_norm``'s batch-statistics path swapped for each
   route in turns (native, cudnn, cudnn, native), each turn a new capture
   of the step and img/s by chip_smoke's ``marginal`` over run_steps
   windows of 4 and 12 (least of 2 each).

Prints one JSON line per part; the last is ``{"bn_ab": {...}}``.  Exits
non-zero without a GPU.  Run from the repository root (it imports the
checkout's ``chip_smoke`` and ``mxnet_tpu_torch``).
"""
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def route_native(x, gamma, beta, eps):
    out, mean, invstd = torch.native_batch_norm(x, gamma, beta, None, None,
                                                True, 0.0, eps)
    return out, mean, invstd


def route_cudnn(x, gamma, beta, eps):
    out, mean, invstd, _ = torch.cudnn_batch_norm(
        x, gamma, beta, None, None, True, 0.0, eps)
    return out, mean, invstd


ROUTES = {"native": route_native, "cudnn": route_cudnn}


def patched_batch_norm(original, route):
    """``ops.nn.batch_norm`` with its batch-statistics path on ``route``
    (the variance taken from 1/sqrt(var + eps), as the op does)."""
    def batch_norm(x, gamma, beta, moving_mean, moving_var, *, eps=1e-3,
                   fix_gamma=True, use_global_stats=False, axis=1,
                   use_batch_stats=False, **kw):
        if not (use_batch_stats and not use_global_stats and axis == 1):
            return original(x, gamma, beta, moving_mean, moving_var, eps=eps,
                            fix_gamma=fix_gamma,
                            use_global_stats=use_global_stats, axis=axis,
                            use_batch_stats=use_batch_stats, **kw)
        g = torch.ones_like(gamma) if fix_gamma else gamma
        out, mean, invstd = route(x, g, beta, eps)
        with torch.no_grad():
            var = invstd.float().pow(-2) - eps
        return out, mean.detach().to(x.dtype), var.to(x.dtype)
    return batch_norm


def event_ms(fn, runs=20):
    for _ in range(3):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda.synchronize()
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in pairs)[runs // 2]


def bn_shapes(cs, nn_ops):
    """Each BatchNorm input shape of the headline row's forward, with its
    count."""
    seen = {}
    original = nn_ops.batch_norm

    def record(x, *a, **kw):
        seen[tuple(x.shape)] = seen.get(tuple(x.shape), 0) + 1
        return original(x, *a, **kw)

    net = cs.resnet_net(torch, "cuda")
    net.cast("bfloat16")
    nn_ops.batch_norm = record
    try:
        with torch.no_grad():
            net(torch.zeros((cs.RESNET_BATCH, 3, cs.RESNET_IMAGE,
                             cs.RESNET_IMAGE), dtype=torch.bfloat16,
                            device="cuda"))
    finally:
        nn_ops.batch_norm = original
    del net
    return seen


def part_shapes(cs, nn_ops):
    rows, total, errors = [], {name: 0.0 for name in ROUTES}, {}
    worst = {k: 0.0 for k in ("out", "dx", "dgamma", "dbeta")}
    for shape, count in sorted(bn_shapes(cs, nn_ops).items()):
        g = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(shape, generator=g, device="cuda").bfloat16()
        dy = torch.randn(shape, generator=g, device="cuda").bfloat16()
        c = shape[1]
        gamma = (1 + 0.1 * torch.randn(c, generator=g, device="cuda")
                 ).bfloat16().requires_grad_(True)
        beta = (0.1 * torch.randn(c, generator=g, device="cuda")
                ).bfloat16().requires_grad_(True)
        x.requires_grad_(True)
        row, outs = {"shape": list(shape), "layers": count}, {}
        for name, route in ROUTES.items():
            def fwd_bwd():
                out = route(x, gamma, beta, 1e-5)[0]
                return (out,) + torch.autograd.grad(out, (x, gamma, beta),
                                                    dy)
            try:
                outs[name] = [t.detach().float() for t in fwd_bwd()]
            except RuntimeError as e:          # a route cuDNN refuses
                errors[name] = str(e)[:300]
                continue
            row[f"{name}_ms"] = event_ms(fwd_bwd)
            total[name] += row[f"{name}_ms"] * count
        for k, a, b in zip(worst, outs.get("cudnn", ()), outs["native"]):
            worst[k] = max(worst[k], float((a - b).abs().max()
                                           / b.abs().max()))
        rows.append(row)
        del x, dy, outs
        torch.cuda.empty_cache()
    return {"part": "shapes", "rows": rows, "ms_per_step": total,
            "cudnn_vs_native_max_err_over_max": worst, "errors": errors}


def part_step(cs, nn_ops, skip=()):
    original = nn_ops.batch_norm
    trainer = cs.resnet_trainer(torch, cs.resnet_net(torch, "cuda"),
                                dtype="bfloat16")
    data, label = cs.resnet_batch(torch, cs.RESNET_BATCH)
    turns = []
    try:
        for name in ("native", "cudnn", "cudnn", "native"):
            if name in skip:
                continue
            nn_ops.batch_norm = patched_batch_norm(original, ROUTES[name])
            trainer._exec.clear()              # capture the step anew
            float(trainer.step(data, label))
            losses = []
            slope, _, _ = cs.marginal(
                lambda n: losses.extend(trainer.run_steps(data, label,
                                                          n).tolist()),
                (4, 12, 2))
            turns.append({"route": name, "img_per_s": cs.RESNET_BATCH / slope,
                          "step_ms": slope * 1e3,
                          "losses_finite": all(map(lambda v: v == v,
                                                   losses))})
    finally:
        nn_ops.batch_norm = original
    return {"part": "step", "turns": turns}


def main():
    if not torch.cuda.is_available():
        print("resnet_bn_ab: no GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import nn as nn_ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    out = {"gpu": cs.nvidia_smi()}
    t0 = time.perf_counter()
    shapes = part_shapes(cs, nn_ops)
    print(json.dumps(shapes), flush=True)
    step = part_step(cs, nn_ops, skip=shapes["errors"])
    print(json.dumps(step), flush=True)
    out.update(shapes=shapes, step=step)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"bn_ab": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
