#!/usr/bin/env python3
"""What the torch dispatcher adds to a call of K1 and K6 as custom ops.

    python3 tools/custom_op_cost.py [--calls N] [--device cpu]

K1 (``mxnet_tpu_torch::flash_attention``) and K6
(``mxnet_tpu_torch::layer_norm_residual``) are ``torch.library`` custom
ops whose bodies are the kernels' wrappers.  On one card, at shapes
small enough that the host sets the pace (a kernel of a few µs), this
times the host µs a call of each wrapper called directly and of the
custom op around it, in blocks taken in turns, each block ``N`` calls
ended by one synchronisation:

- K1 forward: ``flash_fwd`` against ``flash_attention_op`` (no grad);
- K1 forward and backward under autograd and ``torch.autograd.grad``,
  in three forms: a ``torch.autograd.Function`` over the raw wrappers
  (the form before the custom op), the port's ``_FlashAttention`` (an
  ``autograd.Function`` whose forward is the custom op), and a custom op
  whose backward is registered with ``register_autograd`` (made here, in
  the namespace ``mxnet_tpu_torch_probe``); the raw calls beside them;
- K6 forward: the wrapper against ``layer_norm_residual_op``; forward
  and backward in the same three forms.

Prints one JSON line with the medians and their differences, beside the
card's name and power limit.  ``--device cpu`` runs the plain versions
on the host: a check of the script, not a measurement of the card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _registered(torch, fa, lnr):
    """K1 and K6 as custom ops with their backward registered through
    ``register_autograd``: the form the port does not take."""
    from typing import Tuple

    @torch.library.custom_op("mxnet_tpu_torch_probe::flash_attention",
                             mutates_args=())
    def flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float,
              tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return fa.flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                            tile=tile)

    def flash_setup(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:3], *output)
        ctx.causal, ctx.scale, ctx.tile = inputs[3:]

    def flash_backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        delta = fa._delta(do.contiguous(), out)
        kw = dict(causal=ctx.causal, sm_scale=ctx.scale, tile=ctx.tile)
        dk, dv = fa.flash_bwd_dkdv(q, k, v, do.contiguous(), lse, delta,
                                   **kw)
        dq = fa.flash_bwd_dq(q, k, v, do.contiguous(), lse, delta, **kw)
        return dq, dk, dv, None, None, None

    flash.register_autograd(flash_backward, setup_context=flash_setup)

    @torch.library.custom_op("mxnet_tpu_torch_probe::layer_norm_residual",
                             mutates_args=())
    def lnr_op(x: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
               b: torch.Tensor, eps: float, rpb: int) -> torch.Tensor:
        return lnr._forward(x, r, g, b, eps, rpb)

    def lnr_setup(ctx, inputs, output):
        ctx.save_for_backward(*inputs[:4])
        ctx.eps = inputs[4]

    def lnr_backward(ctx, dout):
        return (*lnr._lnr_backward(*ctx.saved_tensors, ctx.eps, dout),
                None, None)

    lnr_op.register_autograd(lnr_backward, setup_context=lnr_setup)
    return flash, lnr_op


def _functions(torch, fa, lnr):
    """The ``autograd.Function`` forms of K1 and K6 over the raw
    wrappers (the form before the custom ops), for the comparison."""
    class Flash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, scale, tile):
            out, lse = fa.flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                                    tile=tile)
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.causal, ctx.scale, ctx.tile = causal, scale, tile
            return out

        @staticmethod
        def backward(ctx, do):
            q, k, v, out, lse = ctx.saved_tensors
            do = do.contiguous()
            delta = fa._delta(do, out)
            kw = dict(causal=ctx.causal, sm_scale=ctx.scale, tile=ctx.tile)
            dk, dv = fa.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
            dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            return dq, dk, dv, None, None, None

    class LNR(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, r, g, b, eps, rpb):
            ctx.save_for_backward(x, r, g, b)
            ctx.eps = eps
            return lnr._forward(x, r, g, b, eps, rpb)

        @staticmethod
        def backward(ctx, dout):
            x, r, g, b = ctx.saved_tensors
            return (*lnr._lnr_backward(x, r, g, b, ctx.eps, dout), None,
                    None)

    return Flash, LNR


def _blocks(torch, fns, calls, rounds=7):
    out = {name: [] for name in fns}
    for fn in fns.values():           # warm: configs, libraries
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            out[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {name: statistics.median(v) for name, v in out.items()}


def main():
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=500)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = args.device
    if dev == "cuda" and not torch.cuda.is_available():
        print("custom_op_cost: needs a GPU", file=sys.stderr)
        return 2
    from mxnet_tpu_torch.ops import attention as fa
    from mxnet_tpu_torch.ops import layernorm_residual as lnr
    if dev == "cuda":
        fa.build()
        lnr.build()
    else:
        torch.cuda.synchronize = lambda *a, **k: None
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 128, 64), device=dev, generator=g,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = 0.125
    tile = fa._op_tile(q, k, v, True, scale, 0)
    do = torch.randn_like(q)

    def direct_fwd():
        return fa.flash_fwd(q, k, v, causal=True, sm_scale=scale, tile=tile)

    def op_fwd():
        return fa.flash_attention_op(q, k, v, True, scale, 0)

    def direct_fwd_bwd():
        out, lse = fa.flash_fwd(q, k, v, causal=True, sm_scale=scale,
                                tile=tile)
        delta = fa._delta(do, out)
        kw = dict(causal=True, sm_scale=scale, tile=tile)
        fa.flash_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)

    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    Flash, LNR = _functions(torch, fa, lnr)
    reg_flash, reg_lnr = _registered(torch, fa, lnr)

    def port_fwd_bwd():
        out = fa._FlashAttention.apply(qg, kg, vg, True, scale, 0)
        torch.autograd.grad(out, (qg, kg, vg), do)

    def fn_fwd_bwd():
        out = Flash.apply(qg, kg, vg, True, scale, tile)
        torch.autograd.grad(out, (qg, kg, vg), do)

    def reg_fwd_bwd():
        out, _ = reg_flash(qg, kg, vg, True, scale, tile)
        torch.autograd.grad(out, (qg, kg, vg), do)

    x, r = (torch.randn((8, 512), device=dev, generator=g,
                        dtype=torch.bfloat16) for _ in range(2))
    gamma = torch.ones(512, device=dev)
    beta = torch.zeros(512, device=dev)
    sig, dt = lnr._lnr_signature(x, r, gamma, beta)
    rpb = lnr._kernels.resolve("layer_norm_residual", sig, dt)[
        "rows_per_block"] if dev == "cuda" else 0

    def direct_lnr():
        return lnr._forward(x, r, gamma, beta, 1e-5, rpb)

    def op_lnr():
        return lnr.layer_norm_residual_op(x, r, gamma, beta, 1e-5, 0)

    xg, rg = (t.detach().requires_grad_() for t in (x, r))
    dy = torch.randn_like(x)

    def port_lnr_bwd():
        y = lnr._LayerNormResidual.apply(xg, rg, gamma, beta, 1e-5, 0)
        torch.autograd.grad(y, (xg, rg), dy)

    def fn_lnr_bwd():
        y = LNR.apply(xg, rg, gamma, beta, 1e-5, rpb)
        torch.autograd.grad(y, (xg, rg), dy)

    def reg_lnr_bwd():
        y = reg_lnr(xg, rg, gamma, beta, 1e-5, rpb)
        torch.autograd.grad(y, (xg, rg), dy)

    with torch.no_grad():
        fwd = _blocks(torch, {"direct": direct_fwd, "custom_op": op_fwd},
                      args.calls)
        ln = _blocks(torch, {"direct": direct_lnr, "custom_op": op_lnr},
                     args.calls)
    both = _blocks(torch, {"direct": direct_fwd_bwd,
                           "function_over_wrappers": fn_fwd_bwd,
                           "port_function_over_custom_op": port_fwd_bwd,
                           "registered_custom_op": reg_fwd_bwd},
                   args.calls // 2)
    ln_both = _blocks(torch, {"function_over_wrapper": fn_lnr_bwd,
                              "port_function_over_custom_op": port_lnr_bwd,
                              "registered_custom_op": reg_lnr_bwd},
                      args.calls // 2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0] if dev == "cuda" \
        else "cpu (a check of the script)"
    print(json.dumps({
        "gpu": smi, "calls_a_block": args.calls,
        "k1_forward_us": fwd,
        "k1_forward_added_us": fwd["custom_op"] - fwd["direct"],
        "k1_forward_backward_us": both,
        "k1_forward_backward_added_us": both["port_function_over_custom_op"]
        - both["function_over_wrappers"],
        "k6_forward_us": ln,
        "k6_forward_added_us": ln["custom_op"] - ln["direct"],
        "k6_forward_backward_us": ln_both,
        "k6_forward_backward_added_us": ln_both[
            "port_function_over_custom_op"]
        - ln_both["function_over_wrapper"]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
