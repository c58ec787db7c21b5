#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) once on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the script
exits non-zero and prints no result:

1. build   — nvcc-build the paged_attention, flash_attention,
             layernorm_residual and rope libraries from
             mxnet_tpu_torch/csrc/ and the rtc module's cubin (all at
             once) into build/torch_kernels/, and time the rtc compile
             cold and from its on-disk cache; rope's nvcc seconds,
             registers and spills (ptxas) are printed.  Both bf16 K1
             instantiations (D 64, 128) must hold wgmma and TMA loads
             (HGMMA, UTMALDG in cuobjdump's SASS), every bf16 K2 / K3
             instantiation bf16 mma (HMMA); none may spill (ptxas); their
             registers are printed.
2. parity  — each kernel against its plain PyTorch version on the card:
             rope and rope_qk (q and k in one launch) at R = 8, 40 and
             128 rows of (8, 64), int32 and int64 positions holding 0
             and 4095, and a scalar position (fp32 atol/rtol 1e-5, bf16
             2e-2; two rope_qk launches bitwise equal); paged attention
             at the decode-serving shapes (fp32 atol/rtol 1e-4, bf16
             2e-2), paged attention also with
             lengths 0, 1, P-1, P, P+1, 2048 for each partition P, each
             case launched twice and bitwise equal; flash attention K1
             (out, LSE) and K2/K3 (dk, dv / dq) at the training shape (BH
             64, S 2048, D 64, causal) in bf16 (2e-2; LSE 1e-4, K1's out
             also in bf16 ulps) and fp32 (1e-4 forward, 1e-3 gradients),
             plus ragged 100x180 non-causal, 257 causal and head dim 128,
             on both compiled tiles; in bf16, K2 / K3 also within one
             rounding of the plain f32 values (2**-8 |ref| + 1e-6
             max|ref|) on every case; layer_norm_residual (K6)
             at the nd path's shape (16384 rows x F 512) in fp32 (1e-5),
             bf16 and f16 (2e-2) on every rows-per-block config, mixed
             x/residual dtypes, F 100 (scalar loads), F 4096 (a block per
             row) and 37 rows (a part-filled block).
3. serve   — the decode-serving path at the full width of the repo's
             transformer LM (vocab 32000, dim 512, 8 heads, 8 layers,
             2048-position slots): DecodeModel → DecodeEngine →
             DecodeScheduler → ServingServer; ``ServingServer.warmup``
             captures one CUDA graph per exec key (decode, prefill_b16 ..
             prefill_b128), then ``generate`` answers 16 overlapping
             requests and 2 short ones that must equal the dense greedy
             reference, all on graph replays: ``compiles`` may not move
             while serving.  Kernel launch counts are zeroed just before
             and read just after; both kernels must have launched and no
             plain version may have run.  Then one prefill chunk and one
             decode step, counted apart, must each launch rope once per
             layer (q and k together), the decode step paged attention
             once per layer.
   replay_check — a 128-token prefill chunk and a decode step (two live
             slots, six masked ones at a position past their tables)
             replayed, then their cores run eagerly on the same static
             inputs: tokens and the live pages bitwise equal, K4's scratch
             counters back at 0.
4. spec    — 4 of those requests again with a draft model and spec_k=4,
             warmed up the same way (11 exec keys); the output must be
             token-identical and capture nothing; one speculative step,
             counted apart, must launch rope once per layer of verify
             (beside the draft's once per layer of each of its steps);
             replay_check again, for verify and a prefill chunk.
   profile — torch.profiler over one decode step, one 128-token prefill
             chunk and one speculative step at the serve shapes (8 slots
             at the served lengths), each replayed and, in the same
             process, eager (the same cores on the executables' static
             inputs): host ms per step in blocks taken in turns, device
             busy ms, idle share, kernels per step and the kernels by
             device time; K4 and K5 must launch the expected number of
             times per step by the device trace in both modes.
5. train   — the training path at the full width of bench.py's
             transformer row (vocab 32000, units 512, 8 layers, 8 heads,
             max_len 2048, tied weights, batch 8 x 2048, Adam lr 3e-4,
             bf16 compute): TransformerLM + SoftmaxCrossEntropyLoss +
             SPMDTrainer, whose first ``step`` is the warm run and the
             capture of the step's CUDA graph, then 5 timed ``step``
             calls and one ``run_steps(..., 4)`` on a fixed batch, all
             replays.  Losses must be finite and fall; the flash kernels
             must launch 8 times per replayed step each and no plain
             version may run; one capture; the first loss within 0.01 of
             10.375.  Host ms a step replayed against the same step run
             eagerly (``_step_eager``), in blocks of 10 taken in turns;
             tokens/s; warm-up s and memory before and after it; the tile.
   train_replay_check — from the same weights and ids, a captured
             trainer against one stepping eagerly through the function
             the graph holds: a warm step each, then 5 replays against 5
             eager steps (and 5 more each): losses, every master and
             Adam's m and v bitwise equal; K1-K3 8 launches a replayed
             step, no plain call; captures unchanged.  ``predict``'s
             replay bitwise equal to the eager forward in eval mode.  An
             id out of range in a replayed step raises MXNetError at the
             next call, after which the card still runs a step.
   train_variants — ``remat=True`` and ``micro_batches=2`` at full width,
             3 captured steps each from the plain trainer's weights: remat
             bitwise equal to plain (losses, masters), micro-batches' first
             loss within rtol 1e-5 and the later ones within 2e-2; peak
             memory of each.
6. train_check — fp32, TF32 off, one forward and backward of the same
             weights with use_flash=True and use_flash=False (the dense
             attention_reference): the loss and every gradient agree.
7. times   — each kernel's median time (CUDA events, cold L2) beside its
             bound, its plain version's time and its launches per step;
             rope and paged attention at the serve shapes (with their
             torch.profiler device times, the event time of an empty
             kernel as the timer's floor, and paged attention under each
             (partition, warps) config; rope also as rope_qk, and the
             host µs of a call of rope and rope_qk over 1000 back-to-back
             calls with one synchronise), the flash
             kernels at the training shape with
             scaled_dot_product_attention's forward / backward as the
             library yardstick; flash bounds count bf16 tensor-core
             passes (K2 8, K3 5), the old f32-FMA bound printed beside,
             and K1's exponentials' bound (16 a clock an SM).
8. nd_path — the imperative NDArray path at the transformer row's
             activation width: x and residual (8, 2048, 512) with gamma
             and beta (512,) from numpy via mx.nd.array on gpu(0), all
             attach_grad'd; under autograd.record() y =
             mx.nd.layer_norm_residual(x, r, g, b), loss = (y*y).mean(),
             loss.backward(), 20 times in bf16 and 20 in fp32.  K6 must
             launch once per forward and its plain version never; y and
             the four gradients agree with autograd of the plain version.
             Host ms per step beside the same step on tensors through the
             kernel's autograd.Function (the funnel's overhead).
9. rtc     — mx.rtc.CudaModule compiles axpy (CUDA C) and launches it on
             (8, 2048, 512) fp32 NDArrays: bitwise 2*x + y; a grid-stride
             copy with an explicit grid smaller than n/256 gives the same
             bits, and a kernel that writes gridDim shows the grid is
             honoured; a source that does not compile raises MXNetError at
             its first launch, and CPU NDArrays raise.
10. times_nd — K6 (bf16 and fp32) and rtc axpy against their bounds,
             plain versions and library calls (F.layer_norm(x + r), two
             calls; torch.add(y, x, alpha=2)); for K6 also the
             torch.profiler device time of the kernel and of the two
             library kernels, and the host µs of a call of each; for axpy
             also the torch.profiler device time of the kernel and of
             torch.add, and the same cubin launched on the raw tensors
             without the NDArray funnel (event ms and host µs per call).
11. profile_train — torch.profiler over a training step replayed and
             eager, in one process: host ms (blocks taken in turns),
             device busy ms, idle share, kernels a step, the flash kernels
             a step by the device trace (8 each) and the kernels by device
             time.
12. resnet_check — the ResNet path on the card against the port's CPU
             path (which the CPU tests hold against the reference), TF32
             off: entry()'s net, ResNet-50 v1 thumbnail (10 classes,
             Xavier seed 0) on a (8, 3, 32, 32) batch (numpy seed 51);
             eval logits in fp32, then three SGD steps (lr 0.05, momentum
             0.9, wd 1e-4; on the card a warm step and two replays) in fp32
             and fp64, each step from the CPU's fp64 state: losses, every
             master and momentum and every running mean and variance, each
             error printed beside its tolerance.
13. resnet_train — bench.py's headline row at full size: ResNet-50 v1,
             1000 classes, 224 x 224, batch 256, bf16 compute, SGD lr 0.05
             momentum 0.9 wd 1e-4, data and float labels made on the card;
             img/s by bench.py's slope between run_steps windows of 4 and
             24 (least of 3 each) and TFLOP/s by its 3 x 4.089 GFLOP an
             image; losses finite and falling; host ms a step replayed
             against eager; torch.profiler's device busy ms, idle share,
             kernels a step and device ms by kind (convolutions,
             BatchNorm, elementwise, layout transposes, ...); peak memory
             and the graph's pool; warm-up s.  resnet_replay_check: a warm
             step and 3 replays bitwise equal to 4 eager steps (losses,
             masters, momenta, running statistics; cuDNN deterministic).
             resnet_train_fp32: the fp32 row at batch 64, TF32 off.
14. resnet_infer — bench.py's inference rows at batch 128: the eval
             forward in fp32 and in bf16 through net.cast("bfloat16"),
             img/s by the same slope over 4 and 24 forwards, the profile,
             and the bf16 logits within 2e-2 of fp32's largest.
             cuDNN's algorithm search (``cudnn.benchmark``) is on for the
             ResNet phases: it runs in a signature's warm step, before the
             capture.
15. gluon_train — the transformer row at full width (as train) through
             the eager Gluon loop: amp.init("bfloat16"), gluon.Trainer
             (Adam lr 3e-4), amp.init_trainer, autograd.record, backward
             inside amp.scale_loss, trainer.step; a warm step, then 10
             steps with the counts zeroed just before and read just
             after: losses finite and falling, K1-K3 8 launches a step
             each (bf16 q, k, v from FullyConnected under the policy) and
             no plain version.  Host ms a step (blocks of 5), tokens/s,
             device busy ms, idle share and kernels by kind (one
             profile), the optimizer's kernels a step fused and with
             MXNET_FUSED_STEP=0, peak memory, and train's SPMDTrainer
             host ms beside them.  An inf written into a gradient inside
             scale_loss must halve the scale, reset the clean steps and
             zero every gradient.
16. gluon_resnet — ResNet-50 v1 at bench width (1000 classes, 224 x 224,
             batch 256) through the eager loop as
             examples/gluon/image_classification.py runs it in bf16
             (amp.convert_model, SGD lr 0.05 momentum 0.9 wd 1e-4): img/s
             by the slope over windows of 4 and 24 steps, losses falling,
             device ms by kind.
17. gluon_check — fp32, TF32 off: (a) one gluon.Trainer SGD-momentum
             step on the ResNet-50 thumbnail (8, 3, 32, 32) against one
             SPMDTrainer step from the same weights (weights within 1e-5,
             running statistics within 1e-4 of their norm in L2, loss rtol
             1e-5); (b) the fused update bitwise equal to the
             per-parameter one (MXNET_FUSED_STEP=0) over 3 steps, SGD
             momentum and Adam; (c) save_states / load_states bitwise;
             (d) SPMDTrainer under amp.init("bfloat16") on an MLP: a warm
             step and 4 replays bitwise equal to 5 eager steps (losses,
             masters, momenta, scale, skipped count), then a replayed step
             with an inf in the data leaves masters and momenta bitwise
             unchanged, halves the scale and skips one update, without a
             new capture; amp.all_finite sees a NaN.

The line before the last is ``{"kernels": [...]}`` (K1-K7; K1-K3 also
carry ``launches_gluon_train``); the last is
``{"ok": true, "device": {...}}``.  Exits non-zero without a GPU, and
outside a checkout of the repository (it imports the port from beside
itself).

    python3 chip_smoke.py --train-ab TREE [TREE ...]

compares a full-width bf16 training step across checkouts of the
repository instead: each TREE (the root of a checkout) in the order
given, each in a process of its own that imports that tree's
``chip_smoke.py`` and ``mxnet_tpu_torch``, so list them as parent,
change, change, parent to bracket any drift of the host.  Each process
builds the tree's flash-attention kernels, makes the training row and
prints one JSON line with, for ``SPMDTrainer.step`` and, where the tree
has it, the eager ``_step_eager``: the host ms of a step that ends in
``float(loss)`` in 5 blocks of 5 steps (each block's mean, and their
median), the modes' blocks in turns and before any profile; under
torch.profiler over 3 more steps the host ms, device busy
ms, idle share (of the profiled and of the unprofiled host ms) and the
kernels a step (copies and memsets apart); and each kernel's launches a
step by name from a CUDA-only trace; then the host blocks once more,
after the profiles.  The last line is ``{"trees": [...]}``.
"""
import gc
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
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor cores
# exponentials: 16 MUFU ops a clock on each of 132 SMs at the 1.98 GHz
# boost clock (H100 SXM; Hopper's 4 SFUs in each of an SM's 4 quadrants)
MUFU_EXP_PER_S = 16 * 132 * 1.98e9

VOCAB, DIM, HEADS, LAYERS, MLP = 32000, 512, 8, 8, 4
SLOTS, PAGE, PAGES_PER_SLOT, NUM_PAGES = 8, 16, 128, 1024
HEAD_DIM = DIM // HEADS
SPEC_K = 4
# prompt lengths whose prefill buckets (16, 32, 64, 128) cover every chunk
# the served prompts feed, so served traffic captures no graph
PREFILL_LENGTHS = (16, 32, 64, 128)
# a masked slot's position past its page table (the cores clamp it before
# the gather: torch on CUDA would fault)
FAR_POSITION = 10_000
# the training row: bench.py's _transformer_bench
BATCH, SEQ, LR = 8, 2048, 3e-4
# the first (warm) step's loss of this row from these weights, as the
# mma.sync K1 gave it; p rounded against another running max moves it
# only in the last digits
FIRST_LOSS = 10.375
TRAIN_BH = BATCH * HEADS
DEV = "cuda"
LNR_ROWS, EPS = BATCH * SEQ, 1e-5   # K6 on the (8, 2048, 512) activations
ND_STEPS = 20
# the ResNet-50 rows: bench.py's _train_bench (:187-268) and _infer_bench
# (:270-341), and __graft_entry__.entry()'s net
RESNET_IMAGE = 224
RESNET_BATCH, RESNET_FP32_BATCH, RESNET_INFER_BATCH = 256, 64, 128
RESNET_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
# bench.py:76's convention: a training step's model FLOPs are 3 x the
# forward's 4.089 GFLOP an image at 224 x 224
RESNET_TRAIN_FLOPS = 3 * 4.089e9
WINDOWS = (4, 24, 3)              # bench.py's N1, N2 and REPS
CHECK_BATCH, CHECK_IMAGE = 8, 32  # resnet_check: entry()'s thumbnail net
NO_LIBRARY = ("no single PyTorch call computes it: scaled_dot_product_"
              "attention needs the pages gathered into a dense tensor "
              "first, and torch has no rotary-embedding operator")


# runtime kernels of the rtc phase: the reference's docstring axpy in CUDA
# C, a grid-stride copy of it for an explicit grid, and one that records
# the grid it was launched with
RTC_SOURCE = r'''
extern "C" __global__ void axpy(const float* x, const float* y,
                                float* out, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) out[i] = 2.0f * x[i] + y[i];
}
extern "C" __global__ void axpy_strided(const float* x, const float* y,
                                        float* out, long long n) {
    long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += step)
        out[i] = 2.0f * x[i] + y[i];
}
'''
GRID_SOURCE = r'''
extern "C" __global__ void grid_dims(float* out, long long n) {
    if (blockIdx.x + blockIdx.y + blockIdx.z + threadIdx.x == 0 && n >= 3) {
        out[0] = gridDim.x; out[1] = gridDim.y; out[2] = gridDim.z;
    }
}
'''
BROKEN_SOURCE = r'''
extern "C" __global__ void broken(const float* x, float* out, long long n) {
    out[0] = x[0] + not_declared_anywhere;
}
'''


def axpy_oracle(x, y):
    """What the rtc axpy must give, bit for bit: 2*x is exact, so both
    round once."""
    return 2 * x + y


def emit(obj):
    print(json.dumps(obj), flush=True)


def max_err(got, ref, atol, rtol):
    import torch
    got, ref = got.detach().float(), ref.detach().float()
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        raise AssertionError(f"max |err| {float(err.max())} beyond atol "
                             f"{atol} rtol {rtol}")
    return float(err.max())


def rtc_first_launch(torch):
    """Compile (or load from the on-disk cubin cache) RTC_SOURCE in a new
    module and launch its axpy once on 256 floats; returns (seconds,
    nvcc seconds).  The launch is not on the main path: phase_rtc
    zeroes the counts before it drives its own."""
    import mxnet_tpu_torch as mx
    s = time.perf_counter()
    mod = mx.rtc.CudaModule(RTC_SOURCE)
    x = mx.nd.ones((256,), ctx=mx.gpu(0))
    mod.get_kernel("axpy", num_inputs=2).launch([x, x], out_shape=x.shape)
    torch.cuda.synchronize()
    return time.perf_counter() - s, mod.compile_seconds


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_build(torch, rope_mod, pa_mod, fa_mod, lnr_mod):
    smi = nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()

    def timed(fn):
        s = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - s

    with ThreadPoolExecutor(5) as ex:     # one nvcc per source, at once
        pa = ex.submit(timed, pa_mod.build)
        fa = ex.submit(timed, fa_mod.build)
        ln = ex.submit(timed, lnr_mod.build)
        rp = ex.submit(timed, rope_mod.build)
        rc = ex.submit(rtc_first_launch, torch)
        (log, nvcc_s), pa_s = pa.result()
        (fa_log, fa_nvcc_s), fa_s = fa.result()
        (ln_log, ln_nvcc_s), ln_s = ln.result()
        (rope_log, rope_nvcc_s), rope_s = rp.result()
        rtc_cold_s, rtc_nvcc_s = rc.result()
    rtc_cached_s, rtc_cached_nvcc_s = rtc_first_launch(torch)
    if rtc_cached_nvcc_s != 0.0:
        raise AssertionError("the second rtc module did not find the "
                             "cubin on disk")

    def ptxas(text):
        return [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln or "Compiling" in ln]

    # the bf16 K1 / K2 / K3: registers and spills (ptxas); K1's wgmma
    # (HGMMA) and TMA loads (UTMALDG), K2 / K3's bf16 mma, in the SASS
    so = fa_mod._library()._name

    def kernel_table(marker):
        found = sass_mma_counts(so, marker)
        for key, regs in kernel_ptxas(fa_log, marker).items():
            found.setdefault(key, {}).update(regs)
        return found

    fwd = kernel_table("fa_fwd_wgmma_kernel")
    bad = {key: r for key, r in fwd.items() if r.get("spill_bytes")
           or not r.get("hgmma") or not r.get("utmaldg")}
    if len(fwd) != 2 or bad:
        raise AssertionError(f"bf16 K1 instantiations (head dims 64, 128) "
                             f"must hold wgmma and TMA loads and spill "
                             f"nothing: {fwd}")
    bwd = {}
    for marker in ("fa_bwd_dkdv_mma_kernel", "fa_bwd_dq_mma_kernel"):
        bwd.update(kernel_table(marker))
    bad = {key: r for key, r in bwd.items()
           if r.get("spill_bytes") or not r.get("hmma_bf16")}
    if len(bwd) != 8 or bad:
        raise AssertionError(f"bf16 K2 / K3 instantiations (tiles 32, 64 x "
                             f"head dims 64, 128) must hold bf16 mma and "
                             f"spill nothing: {bwd}")

    emit({"phase": "build", "gpu": smi,
          "seconds": round(time.perf_counter() - t0, 3),
          "paged_attention_nvcc_s": round(nvcc_s, 3),
          "paged_attention_s": round(pa_s, 3),
          "flash_attention_nvcc_s": round(fa_nvcc_s, 3),
          "flash_attention_s": round(fa_s, 3),
          "layernorm_residual_nvcc_s": round(ln_nvcc_s, 3),
          "layernorm_residual_s": round(ln_s, 3),
          "rope_nvcc_s": round(rope_nvcc_s, 3),
          "rope_s": round(rope_s, 3),
          "rope_ptxas": ptxas_summary(rope_log),
          "rtc_cold_s": round(rtc_cold_s, 3),
          "rtc_cold_nvcc_s": round(rtc_nvcc_s, 3),
          "rtc_cached_s": round(rtc_cached_s, 3),
          "ptxas": ptxas(log),
          "flash_fwd_bf16_kernels": fwd,
          "flash_fwd_ptxas_notes": [ln.strip() for ln in fa_log.splitlines()
                                    if "wgmma" in ln or "setmaxnreg" in ln],
          "flash_bwd_bf16_kernels": bwd,
          "layernorm_residual_ptxas": ptxas_summary(ln_log)})
    return smi


def _instantiation(marker, mangled):
    """``marker_<TILE>x<D>`` from a mangled ``marker<TILE, D>`` name."""
    import re
    return marker + "_" + "x".join(re.findall(r"Li(\d+)E", mangled)[:2])


def kernel_ptxas(text, marker):
    """Registers and spill bytes of each instantiation of the kernel
    ``marker`` in one -Xptxas -v log (empty when the build was found on
    disk and nvcc did not run)."""
    import re
    out, key = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            key = (_instantiation(marker, m.group(1))
                   if marker in m.group(1) else None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if key and m:
            out.setdefault(key, {})["spill_bytes"] = (int(m.group(1))
                                                      + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if key and m:
            out.setdefault(key, {})["registers"] = int(m.group(1))
    return out


def sass_mma_counts(so_path, marker):
    """HMMA instructions (all, and bf16 ones), HGMMA (wgmma) and UTMALDG
    (TMA loads) in each instantiation of the kernel ``marker``, from
    cuobjdump -sass of the built library."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", so_path], capture_output=True,
                          text=True, check=True).stdout
    out, key = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            key = (_instantiation(marker, m.group(1))
                   if marker in m.group(1) else None)
            if key:
                out[key] = {"hmma": 0, "hmma_bf16": 0, "hgmma": 0,
                            "utmaldg": 0}
        elif key and "HGMMA" in ln:
            out[key]["hgmma"] += 1
        elif key and "HMMA" in ln:
            out[key]["hmma"] += 1
            out[key]["hmma_bf16"] += "BF16" in ln
        elif key and "UTMALDG" in ln:
            out[key]["utmaldg"] += 1
    return out


def ptxas_summary(text):
    """Instantiations compiled, most registers used, and every line that
    reports a spill, of one -Xptxas -v log (K6 compiles 63 of them)."""
    import re
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
    spills = [ln.strip() for ln in text.splitlines()
              if re.search(r"[1-9]\d* bytes spill", ln)]
    return {"kernels": text.count("Compiling entry"),
            "max_registers": max(regs, default=None), "spills": spills}


def rope_case(torch, r, dtype, seed, pos_dtype=None):
    """x (r, HEADS, HEAD_DIM) and positions (r,) in [0, 4096), the first
    4095 and the last 0 (the tuner's largest position and the first)."""
    rng = onp.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(r, HEADS, HEAD_DIM) * 0.5).to(
        "cuda", dtype)
    pos = rng.randint(0, 4096, size=(r,))
    pos[0], pos[-1] = 4095, 0
    return x, torch.as_tensor(pos, dtype=pos_dtype or torch.int32,
                              device="cuda")


ROPE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def phase_rope_parity(torch, rope_mod):
    """K5 against its plain version: rope and rope_qk at the decode (8),
    verify (8 x 5) and prefill (128) rows, in fp32 and bf16, on int32
    and int64 positions, and at a scalar position; two rope_qk launches
    must give the same bits."""
    cases, err = [], 0.0
    for r in (SLOTS, SLOTS * (SPEC_K + 1), 128):
        for dtype in (torch.float32, torch.bfloat16):
            tol = ROPE_TOL[str(dtype).replace("torch.", "")]
            for pos_dtype in (torch.int32, torch.int64):
                q, pos = rope_case(torch, r, dtype, r, pos_dtype)
                k, _ = rope_case(torch, r, dtype, r + 1, pos_dtype)
                got = rope_mod.rope(q, pos)
                gq, gk = rope_mod.rope_qk(q, k, pos)
                aq, ak = rope_mod.rope_qk(q, k, pos)
                torch.cuda.synchronize()
                if not (torch.equal(gq, aq) and torch.equal(gk, ak)):
                    raise AssertionError(f"two rope_qk launches differ "
                                         f"(r {r}, {dtype}, {pos_dtype})")
                rq = rope_mod.rope_reference(q, pos)
                rk = rope_mod.rope_reference(k, pos)
                e = max(max_err(got, rq, tol, tol), max_err(gq, rq, tol, tol),
                        max_err(gk, rk, tol, tol))
                cases.append({
                    "r": r, "dtype": str(dtype), "positions": str(pos_dtype),
                    "max_abs_err": e,
                    "bitwise_equal_to_plain": bool(
                        torch.equal(got, rq) and torch.equal(gq, rq)
                        and torch.equal(gk, rk)),
                    "bitwise_repeatable": True})
                if dtype == torch.float32:
                    err = max(err, e)
    for last in (0, 4095):                        # a scalar position
        x, _ = rope_case(torch, SLOTS, torch.float32, seed=3)
        y, _ = rope_case(torch, SLOTS, torch.float32, seed=4)
        ref = rope_mod.rope_reference(x, last)
        e = max_err(rope_mod.rope(x, last), ref, 1e-5, 1e-5)
        gx, gy = rope_mod.rope_qk(x, y, last)
        e = max(e, max_err(gx, ref, 1e-5, 1e-5),
                max_err(gy, rope_mod.rope_reference(y, last), 1e-5, 1e-5))
        cases.append({"r": SLOTS, "dtype": str(torch.float32),
                      "position": last, "max_abs_err": e})
        err = max(err, e)
    emit({"phase": "parity_rope", "tolerance": ROPE_TOL, "cases": cases})
    return {"rope": err}


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
    out = {"phase": "parity", "paged_attention": []}
    errs = phase_rope_parity(torch, rope_mod)
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
    # lengths on either side of each partition's boundaries, and a full
    # slot; every case launched twice, the outputs bitwise equal
    for part in pa_mod._PARTITIONS:
        lengths = [0, 1, part - 1, part, part + 1, PAGES_PER_SLOT * PAGE,
                   2 * part + 17, 999]
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            args = pa_case(torch, lengths, dtype, seed=part + 7)
            first = pa_mod.paged_attention(*args, partition=part)
            again = pa_mod.paged_attention(*args, partition=part)
            torch.cuda.synchronize()
            e = max_err(first, pa_mod.paged_attention_reference(*args), tol,
                        tol)
            if bool(first[0].any()):
                raise AssertionError("length-0 slot did not give exact "
                                     "zeros")
            if not torch.equal(first, again):
                raise AssertionError(f"two launches differ (partition "
                                     f"{part}, {dtype})")
            out["paged_attention"].append(
                {"lengths": lengths, "dtype": str(dtype), "partition": part,
                 "max_abs_err": e, "bitwise_repeatable": True})
    emit(out)
    return errs


def lnr_case(torch, rows, f, x_dtype, r_dtype, seed):
    """x, residual (rows, F) in their dtypes and f32 gamma, beta, on the
    card from a numpy seed."""
    rng = onp.random.RandomState(seed)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=torch.float32).to(DEV, dtype)

    return (t(rng.randn(rows, f), x_dtype), t(rng.randn(rows, f), r_dtype),
            t(rng.rand(f) + 0.5), t(rng.randn(f) * 0.1))


def phase_lnr_parity(torch, lnr_mod):
    """K6 against its plain version: the nd path's shape on every
    rows-per-block config, mixed dtypes, F 100 (scalar loads), F 4096
    (a block per row), and 37 rows (the last block part-filled)."""
    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    tol = {f32: 1e-5, bf16: 2e-2, f16: 2e-2}
    cases = [(LNR_ROWS, DIM, x, x, rpb) for x in (f32, bf16, f16)
             for rpb in lnr_mod._ROWS_PER_BLOCK]
    cases += [(LNR_ROWS, DIM, f32, bf16, 8), (LNR_ROWS, DIM, bf16, f32, 8),
              (1000, 100, f32, f32, 8), (1000, 100, bf16, bf16, 4),
              (256, 4096, f32, f32, 8), (256, 4096, bf16, f16, 8),
              (37, DIM, f32, f32, 8), (37, DIM, bf16, bf16, 16)]
    rows, err = [], None
    for n, f, xd, rd, rpb in cases:
        x, r, g, b = lnr_case(torch, n, f, xd, rd, seed=n + f)
        got = lnr_mod._lnr_cuda(x, r, g, b, EPS, rpb)
        torch.cuda.synchronize()
        ref = lnr_mod.layer_norm_residual_reference(x, r, g, b, EPS)
        if got.dtype != xd or got.shape != x.shape:
            raise AssertionError(f"K6 gave {got.dtype} {tuple(got.shape)}")
        e = max_err(got, ref, tol[xd], tol[xd])
        rows.append({"rows": n, "f": f, "x": str(xd), "residual": str(rd),
                     "rows_per_block": rpb, "max_abs_err": e})
        if (n, f, xd, rd) == (LNR_ROWS, DIM, bf16, bf16):
            err = e if err is None else max(err, e)
    emit({"phase": "parity_layer_norm_residual",
          "tolerance": {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-2},
          "cases": rows})
    return {"layer_norm_residual": err}


def flash_case(torch, bh, sq, sk, d, dtype, seed):
    """q, k, v, dO as (BH, S, D) on the card, from a numpy seed."""
    rng = onp.random.RandomState(seed)

    def t(*shape):
        return torch.as_tensor(rng.randn(*shape),
                               dtype=torch.float32).to(DEV, dtype)

    return t(bh, sq, d), t(bh, sk, d), t(bh, sk, d), t(bh, sq, d)


def bf16_rounding_check(name, got, ref32):
    """|got - ref32| <= 2**-8 |ref32| + 1e-6 max|ref32|: a bf16 result
    must be the plain version's f32 value rounded once (half an ulp, at
    most 2**-8 of the value), give or take f32 sums taken in another
    order.  Returns the worst |err| / bound."""
    got = got.float()
    bound = 2.0 ** -8 * ref32.abs() + 1e-6 * float(ref32.abs().max())
    worst = float(((got - ref32).abs() / bound).max())
    if not worst <= 1.0:
        raise AssertionError(f"{name}: bf16 result beyond one rounding of "
                             f"the plain f32 value, worst |err| / bound "
                             f"{worst}")
    return worst


def bf16_ulps(torch, got, ref):
    """Worst |got - ref| in bf16 ulps of ref: the ulp of |ref|, floored
    at the ulp of 1e-2 max|ref| (the error of p's rounding is absolute,
    so values near zero would report it in ulps of nothing)."""
    ref = ref.float()
    mag = ref.abs().clamp_min(1e-2 * float(ref.abs().max()))
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(((got.float() - ref).abs() / ulp).max())


def flash_check(torch, fa_mod, case, causal, tile, tol_fwd, tol_lse,
                tol_grad):
    """K1 against the plain forward, and K2 / K3 against the plain
    backward on the plain forward's residuals; max |err| of each.  In
    bf16, K1's out also in bf16 ulps of the plain value, and K2 / K3
    against the plain f32 values before rounding
    (``bf16_rounding_check``)."""
    q, k, v, do = case
    scale = 1.0 / q.shape[-1] ** 0.5
    out, lse = fa_mod.flash_fwd(q, k, v, causal=causal, tile=tile)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa_mod.flash_forward_reference(q, k, v, causal, scale)
    errs = {"out": max_err(out, ref_out, tol_fwd, tol_fwd),
            "lse": max_err(lse, ref_lse, tol_lse, tol_lse)}
    if q.dtype == torch.bfloat16:
        errs["out_bf16_ulps"] = bf16_ulps(torch, out, ref_out)
    delta = fa_mod._delta(do, ref_out)
    dk, dv = fa_mod.flash_bwd_dkdv(q, k, v, do, ref_lse, delta,
                                   causal=causal, tile=tile)
    dq = fa_mod.flash_bwd_dq(q, k, v, do, ref_lse, delta, causal=causal,
                             tile=tile)
    torch.cuda.synchronize()
    rdk, rdv = fa_mod._dkdv_reference(q, k, v, do, ref_lse, delta, causal,
                                      scale)
    rdq = fa_mod._dq_reference(q, k, v, do, ref_lse, delta, causal, scale)
    for name, got, ref in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        errs[name] = max_err(got, ref, tol_grad, tol_grad)
    if q.dtype == torch.bfloat16:
        f32 = fa_mod._dkdv_f32(q, k, v, do, ref_lse, delta, causal, scale)
        f32 += (fa_mod._dq_f32(q, k, v, do, ref_lse, delta, causal, scale),)
        errs["rounding_err_over_bound"] = {
            name: bf16_rounding_check(name, got, ref) for name, got, ref in
            zip(("dk", "dv", "dq"), (dk, dv, dq), f32)}
    return errs


def phase_flash_parity(torch, fa_mod):
    """Flash attention K1 / K2 / K3 against their plain versions."""
    rows, errs = [], {}
    # (out, lse, gradients): a bf16 LSE is an f32 value, the same sums
    # taken in another order
    tols = {torch.bfloat16: (2e-2, 1e-4, 2e-2),
            torch.float32: (1e-4, 1e-4, 1e-3)}
    cases = [((TRAIN_BH, SEQ, SEQ, HEAD_DIM), True, (32, 64)),
             ((6, 100, 180, 64), False, (32, 64)),
             ((6, 257, 257, 64), True, (32, 64)),
             ((4, 300, 300, 128), True, (32, 64))]
    for shape, causal, tiles in cases:
        for dtype, (tf, tl, tg) in tols.items():
            case = flash_case(torch, *shape, dtype, seed=sum(shape))
            for tile in tiles:
                e = flash_check(torch, fa_mod, case, causal, tile, tf, tl,
                                tg)
                rows.append({"bh_sq_sk_d": shape, "causal": causal,
                             "dtype": str(dtype), "tile": tile,
                             "max_abs_err": e})
                if shape[1] == SEQ and dtype == torch.bfloat16 \
                        and tile == 64:
                    errs = {"flash_fwd": max(e["out"], e["lse"]),
                            "flash_bwd_dkdv": max(e["dk"], e["dv"]),
                            "flash_bwd_dq": e["dq"]}
            del case
    torch.cuda.empty_cache()
    emit({"phase": "parity_flash",
          "tolerance": {"bf16": 2e-2, "bf16_lse": 1e-4,
                        "fp32_forward": 1e-4, "fp32_grads": 1e-3,
                        "bf16_grads_vs_plain_f32":
                            "2**-8 |ref| + 1e-6 max|ref|"},
          "cases": rows})
    return errs


def train_model(torch, use_flash=True, seed=0):
    """The full-width training row's model on the card, initialized
    (Xavier, host generator seeded with ``seed``) and its deferred dims
    filled by a short forward."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
    net = TransformerLM(VOCAB, units=DIM, num_layers=LAYERS,
                        num_heads=HEADS, max_len=SEQ, tie_weights=True,
                        use_flash=use_flash)
    net.initialize(init=initializer.Xavier(), device=DEV,
                   generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net(torch.zeros((1, 8), dtype=torch.int32, device=DEV))
    return net


def train_batch(torch, seed=2):
    rng = onp.random.RandomState(seed)
    return tuple(torch.as_tensor(rng.randint(0, VOCAB, size=(BATCH, SEQ))
                                 .astype(onp.int32), device=DEV)
                 for _ in range(2))


def train_trainer(torch, net, **kw):
    """The training row's trainer (Adam lr 3e-4, bf16 compute) on ``net``."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer
    return SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="adam",
                       optimizer_params={"learning_rate": LR},
                       dtype="bfloat16", device=DEV, **kw)


def step_graph(trainer):
    """The one captured step executable of a trainer that has taken
    steps of one signature."""
    exes = [ex for sig, (ex, _) in trainer._exec.items()
            if sig[0] == "step"]
    if len(exes) != 1 or exes[0].graph is None:
        raise AssertionError(f"expected one captured step executable, got "
                             f"{len(exes)} (graphs: "
                             f"{[ex.graph is not None for ex in exes]})")
    return exes[0]


def phase_train(torch, fa_mod, smi):
    t0 = time.perf_counter()
    net = train_model(torch)
    trainer = train_trainer(torch, net)
    data, label = train_batch(torch)
    setup_s = time.perf_counter() - t0
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem = {"allocated_before_warmup": torch.cuda.memory_allocated(),
           "reserved_before_warmup": torch.cuda.memory_reserved()}
    w0 = time.perf_counter()
    losses = [float(trainer.step(data, label))]   # the warm step + capture
    warm_s = time.perf_counter() - w0
    step_graph(trainer)
    mem.update(max_allocated_warmup=torch.cuda.max_memory_allocated(),
               allocated_after_warmup=torch.cuda.memory_allocated(),
               reserved_after_warmup=torch.cuda.memory_reserved())
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*fns)
    step_ms = []
    for _ in range(5):
        s0 = time.perf_counter()
        losses.append(float(trainer.step(data, label)))  # float() syncs
        step_ms.append((time.perf_counter() - s0) * 1e3)
    s0 = time.perf_counter()
    window = trainer.run_steps(data, label, 4)
    losses += [float(x) for x in window.cpu()]
    window_ms = (time.perf_counter() - s0) * 1e3
    counts = {f.__name__: {"launches": f.launches,
                           "plain_calls": f.plain_calls} for f in fns}
    mem["max_allocated_replays"] = torch.cuda.max_memory_allocated()
    steps = 5 + 4
    for name, c in counts.items():
        if c["launches"] != LAYERS * steps or c["plain_calls"]:
            raise AssertionError(f"{name} did not train through its kernel"
                                 f" ({LAYERS} launches a step for {steps} "
                                 f"replayed steps): {c}")
    if trainer.compiles != 1:
        raise AssertionError(f"{trainer.compiles} captures for one "
                             f"signature")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses not finite and falling: "
                             f"{losses}")
    if abs(losses[0] - FIRST_LOSS) > 0.01:
        raise AssertionError(f"first loss {losses[0]} not within 0.01 of "
                             f"{FIRST_LOSS}")
    # host ms a step replayed against the same step eagerly (the function
    # the graph holds), in one process, in blocks of 10 taken in turns
    modes = {"replayed": lambda: float(trainer.step(data, label)),
             "eager": lambda: float(trainer._step_eager(data, label))}
    for fn in modes.values():
        fn()
    host = host_ms_blocks(modes, calls=10, rounds=2)
    GLUON_SPMD_HOST.update(host)
    med = host["replayed"]["median"]
    flat = torch.empty((TRAIN_BH, SEQ, HEAD_DIM), dtype=torch.bfloat16,
                       device="meta")
    tile = fa_mod._kernels.resolve(                  # the step's own lookup
        "flash_attention", *fa_mod._flash_signature(flat, flat, flat,
                                                    causal=True))["tile"]
    emit({"phase": "train", "gpu": smi,
          "model": {"vocab": VOCAB, "units": DIM, "layers": LAYERS,
                    "heads": HEADS, "max_len": SEQ, "tied": True,
                    "batch": BATCH, "seq": SEQ, "dtype": "bfloat16",
                    "optimizer": "adam", "lr": LR},
          "setup_s": round(setup_s, 3), "warmup_s": warm_s,
          "losses": losses, "step_ms": step_ms,
          "step_ms_median": sorted(step_ms)[len(step_ms) // 2],
          "host_ms": host, "run_steps_4_ms": window_ms,
          "tokens_per_s": BATCH * SEQ / (med / 1e3),
          "tokens_per_s_eager": BATCH * SEQ / (
              host["eager"]["median"] / 1e3),
          "tokens_per_s_run_steps": 4 * BATCH * SEQ / (window_ms / 1e3),
          "captures": trainer.compiles, "memory_bytes": mem,
          "counts": counts, "launches_per_step": LAYERS,
          "flash_tile": tile})
    return trainer, data, label, counts


def state_of(trainer):
    """Every master, then Adam's m and v, of a trainer, in order."""
    out = []
    for k in trainer._pkeys:
        out.append((k, trainer._params[k].data()))
        out += [(f"{k}:{s}", t) for s, t in zip("mv", trainer._opt_state[k])]
    return out


def differing(torch, a, b):
    """Names whose tensors differ bit for bit between two state_of lists."""
    return [ka for (ka, ta), (_, tb) in zip(a, b) if not torch.equal(ta, tb)]


def phase_train_replay_check(torch, fa_mod):
    """From the same weights and ids, a captured trainer against one
    stepping eagerly through the same function: one warm step each, then
    5 replays against 5 eager steps; losses, every master and Adam's m
    and v must be bitwise equal.  Then ``predict``'s replay against the
    eager forward, and an id out of range in a replayed step."""
    from mxnet_tpu_torch.base import MXNetError
    data, label = train_batch(torch)
    captured = train_trainer(torch, train_model(torch))
    eager = train_trainer(torch, train_model(torch))
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    start = differing(torch, state_of(captured), state_of(eager))
    if start:
        raise AssertionError(f"the two trainers start apart: {start[:4]}")
    losses_c = [float(captured.step(data, label))]          # warm
    losses_e = [float(eager._step_eager(data, label))]
    compiles = captured.compiles
    reset_counts(*fns)
    for _ in range(5):
        losses_c.append(float(captured.step(data, label)))
        losses_e.append(float(eager._step_eager(data, label)))
    torch.cuda.synchronize()
    eager_counts = {f.__name__: {"launches": f.launches,
                                 "plain_calls": f.plain_calls} for f in fns}
    reset_counts(*fns)
    for _ in range(5):
        captured.step(data, label)        # launch counts of replays alone
    torch.cuda.synchronize()
    replay_counts = {f.__name__: {"launches": f.launches,
                                  "plain_calls": f.plain_calls}
                     for f in fns}
    for _ in range(5):
        eager._step_eager(data, label)
    diff = differing(torch, state_of(captured), state_of(eager))
    if losses_c != losses_e or diff:
        raise AssertionError(f"captured and eager steps differ: losses "
                             f"{losses_c} vs {losses_e}; state "
                             f"{diff[:6]} ({len(diff)} tensors)")
    for name in eager_counts:
        for got, n in ((eager_counts[name], 2 * 5 * LAYERS),
                       (replay_counts[name], 5 * LAYERS)):
            if got != {"launches": n, "plain_calls": 0}:
                raise AssertionError(f"{name}: {got}, expected {n} launches"
                                     f" and no plain call")
    if captured.compiles != compiles or compiles != 1:
        raise AssertionError(f"captures moved: {compiles} -> "
                             f"{captured.compiles}")
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    first = captured.predict(data)                   # warm + capture
    replayed = captured.predict(data)
    plain = captured._predict_eager(data)
    if not (torch.equal(replayed, plain) and torch.equal(first, plain)):
        raise AssertionError("predict's replay differs from the eager "
                             "forward")
    if captured.compiles != 2:
        raise AssertionError(f"predict: {captured.compiles} captures")
    shape = list(replayed.shape)
    del first, replayed, plain
    bad = data.clone()
    bad[1, 5] = VOCAB
    captured.step(bad, label)                # replayed: clamped, recorded
    try:
        captured.step(data, label)
    except MXNetError as e:
        message = str(e)
    else:
        raise AssertionError("an id out of range did not raise")
    after = float(captured.step(data, label))
    torch.cuda.synchronize()
    if "must lie in" not in message or not onp.isfinite(after):
        raise AssertionError(f"bad-id raise {message!r}, then loss {after}")
    emit({"phase": "train_replay_check", "steps": "1 warm + 5",
          "losses_captured": losses_c, "losses_eager": losses_e,
          "losses_bitwise_equal": True,
          "state_tensors_bitwise_equal": len(state_of(captured)),
          "counts_eager_and_replayed": eager_counts,
          "counts_replayed": replay_counts, "captures": compiles,
          "predict": {"shape": shape, "dtype": "float32",
                      "bitwise_equal_to_eager": True},
          "bad_id": {"raised": message, "next_step_loss": after}})
    del captured
    gc.collect()
    torch.cuda.empty_cache()


def phase_train_variants(torch):
    """``remat=True`` and ``micro_batches=2`` at full width, 3 captured
    steps each (a warm step and 2 replays) from the plain trainer's
    weights: remat bitwise equal to plain (losses and every master);
    micro-batches' first loss within rtol 1e-5 of plain (the loss is the
    mean of two means) and the later ones within 2e-2.  Peak memory
    (``max_memory_allocated`` over the 3 steps, and the memory reserved
    after them, which holds the graph's pool; both above what was
    allocated and reserved before the trainer) for each."""
    data, label = train_batch(torch)
    rows, ref = {}, None
    for name, kw in (("plain", {}), ("remat", {"remat": True}),
                     ("micro_batches_2", {"micro_batches": 2})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
        trainer = train_trainer(torch, train_model(torch), **kw)
        losses = [float(trainer.step(data, label)) for _ in range(3)]
        step_graph(trainer)
        rows[name] = {
            "losses": losses,
            "max_allocated_bytes": torch.cuda.max_memory_allocated()
            - base[0],
            "reserved_bytes": torch.cuda.memory_reserved() - base[1]}
        masters = [p.data().cpu() for p in trainer._plist]
        del trainer
        if ref is None:
            ref = (losses, masters)
            continue
        if name == "remat":
            same = all(torch.equal(a, b) for a, b in zip(masters, ref[1]))
            if losses != ref[0] or not same:
                raise AssertionError(f"remat differs from plain: {losses} vs"
                                     f" {ref[0]}, masters equal {same}")
            rows[name]["bitwise_equal_to_plain"] = True
        else:
            first = abs(losses[0] - ref[0][0]) / abs(ref[0][0])
            later = max(abs(a - b) / abs(b)
                        for a, b in zip(losses[1:], ref[0][1:]))
            if first > 1e-5 or later > 2e-2:
                raise AssertionError(f"micro_batches=2 losses {losses} vs "
                                     f"plain {ref[0]}")
            rows[name].update(first_loss_rel_err=first,
                              later_losses_max_rel_err=later)
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_variants", "steps": 3,
          "tolerance": {"remat": "bitwise", "micro_first_rtol": 1e-5,
                        "micro_later_rtol": 2e-2},
          "variants": rows})


def phase_train_check(torch):
    """fp32 (TF32 off) flash vs dense: one forward and backward of the
    same weights.  Tolerances: loss rtol 1e-5; each gradient's max |err|
    within 1e-3 of its own max |value| (f32 sums in another order through
    eight layers)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    data, label = train_batch(torch, seed=3)
    flash = train_model(torch, use_flash=True)
    loss_fn = SoftmaxCrossEntropyLoss()

    def loss_and_grads(net):
        params = net.collect_params()
        out = net(data)
        loss = loss_fn(out, label).float().mean()
        grads = torch.autograd.grad(loss, [p.data()
                                           for p in params.values()])
        return float(loss.detach()), dict(zip(params, grads))

    loss_f, grads_f = loss_and_grads(flash)
    dense = train_model(torch, use_flash=False, seed=1)
    for name, p in dense.collect_params().items():
        p.set_data(flash.collect_params()[name].data().detach())
    del flash
    torch.cuda.empty_cache()
    loss_d, grads_d = loss_and_grads(dense)
    if abs(loss_f - loss_d) > 1e-5 * abs(loss_d):
        raise AssertionError(f"flash loss {loss_f} != dense {loss_d}")
    worst = 0.0
    for name, gd in grads_d.items():
        scale = float(gd.abs().max())
        err = float((grads_f[name] - gd).abs().max())
        if err > 1e-3 * scale:
            raise AssertionError(f"{name}: flash vs dense gradient max "
                                 f"|err| {err} beyond 1e-3 x {scale}")
        worst = max(worst, err / max(scale, 1e-30))
    emit({"phase": "train_check", "dtype": "float32", "tf32": False,
          "loss_flash": loss_f, "loss_dense": loss_d,
          "gradients": len(grads_d), "worst_grad_err_over_max": worst,
          "tolerance": {"loss_rtol": 1e-5, "grad_err_over_max": 1e-3}})
    del dense, grads_f, grads_d
    torch.cuda.empty_cache()


def nd_step(mx, arrays):
    """One recorded forward and backward of the nd path; returns y."""
    with mx.autograd.record():
        y = mx.nd.layer_norm_residual(*arrays)
        loss = (y * y).mean()
    loss.backward()
    return y


def phase_nd_path(torch, lnr_mod):
    """The imperative NDArray path at full width: mx.nd.array on gpu(0),
    attach_grad, record, layer_norm_residual (K6), (y*y).mean(),
    backward; in bf16 and fp32."""
    import mxnet_tpu_torch as mx
    rng = onp.random.RandomState(31)
    shape = (BATCH, SEQ, DIM)
    host = [rng.randn(*shape).astype(onp.float32),
            rng.randn(*shape).astype(onp.float32),
            (rng.rand(DIM) + 0.5).astype(onp.float32),
            (rng.randn(DIM) * 0.1).astype(onp.float32)]
    runs = {}
    for dtype in ("bfloat16", "float32"):
        arrays = [mx.nd.array(h, ctx=mx.gpu(0), dtype=dtype) for h in host]
        for a in arrays:
            a.attach_grad()
        nd_step(mx, arrays)                  # warm: config resolve, caches
        runs[dtype] = arrays
    mx.nd.waitall()
    fn = lnr_mod.layer_norm_residual
    reset_counts(fn)
    host_ms, outs = {}, {}
    for dtype, arrays in runs.items():      # the main path, counted
        t0 = time.perf_counter()
        for _ in range(ND_STEPS):
            outs[dtype] = nd_step(mx, arrays)
        mx.nd.waitall()
        host_ms[dtype] = (time.perf_counter() - t0) * 1e3 / ND_STEPS
    counts = {"launches": fn.launches, "plain_calls": fn.plain_calls}
    if counts != {"launches": 2 * ND_STEPS, "plain_calls": 0}:
        raise AssertionError(f"the nd path did not run K6 once per forward "
                             f"({2 * ND_STEPS} forwards): {counts}")
    out = {"phase": "nd_path", "shape": list(shape), "steps": ND_STEPS,
           "counts": counts, "dtypes": {}}
    for dtype, arrays in runs.items():
        # the reference: autograd of the plain version, the same loss
        ts = [a._data.detach().clone().requires_grad_() for a in arrays]
        ref_y = lnr_mod.layer_norm_residual_reference(*ts, EPS)
        ref_grads = torch.autograd.grad((ref_y * ref_y).mean(), ts)
        tol, gtol = (1e-5, 1e-4) if dtype == "float32" else (2e-2, 2e-2)
        y = outs[dtype]
        errs = {"y": max_err(y._data, ref_y, tol, tol)}
        for name, a, rg in zip(("x", "residual", "gamma", "beta"), arrays,
                               ref_grads):
            g, rg = a.grad._data.float(), rg.float()
            scale = float(rg.abs().max())
            err = float((g - rg).abs().max())
            if not bool(torch.isfinite(g).all()) or err > gtol * scale:
                raise AssertionError(f"{dtype} d{name}: max |err| {err} "
                                     f"beyond {gtol} x {scale}")
            errs[f"d{name}_over_max"] = err / max(scale, 1e-30)
        # the same step on tensors, straight through the kernel's
        # autograd.Function: what the registry funnel and NDArray add
        rpb = lnr_mod._kernels.resolve(
            "layer_norm_residual",
            *lnr_mod._lnr_signature(*ts))["rows_per_block"]

        def direct():
            yy = lnr_mod._LayerNormResidual.apply(*ts, EPS, rpb)
            torch.autograd.grad((yy * yy).mean(), ts)

        direct()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ND_STEPS):
            direct()
        torch.cuda.synchronize()
        direct_ms = (time.perf_counter() - t0) * 1e3 / ND_STEPS
        out["dtypes"][dtype] = {
            "host_ms_per_step": host_ms[dtype],
            "direct_autograd_function_ms": direct_ms,
            "funnel_overhead_ms": host_ms[dtype] - direct_ms,
            "errors": errs, "tolerance": tol,
            "grad_tolerance_over_max": gtol}
    emit(out)
    del runs, outs
    torch.cuda.empty_cache()
    return counts


def phase_rtc(torch):
    """mx.rtc on the card: axpy bitwise, an explicit grid honoured, a
    compile error at first launch, CPU arrays refused."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.base import MXNetError
    rng = onp.random.RandomState(41)
    shape = (BATCH, SEQ, DIM)
    x, y = (mx.nd.array(rng.randn(*shape).astype(onp.float32),
                        ctx=mx.gpu(0)) for _ in range(2))
    mod = mx.rtc.CudaModule(RTC_SOURCE)
    axpy = mod.get_kernel("axpy", num_inputs=2)
    strided = mod.get_kernel("axpy_strided", num_inputs=2)
    grid_k = mx.rtc.CudaModule(GRID_SOURCE).get_kernel("grid_dims",
                                                       num_inputs=0)
    small_grid = 4 * 132                      # < n / 256 = 32768 blocks
    mx.rtc.launches = 0
    out = axpy.launch([x, y], out_shape=x.shape, out_dtype=x.dtype)
    out2 = strided.launch([x, y], out_shape=x.shape, out_dtype="float32",
                          grid=small_grid)
    dims = grid_k.launch([], out_shape=(3,), grid=(5, 3, 2))
    mx.nd.waitall()
    counts = {"launches": mx.rtc.launches, "axpy": axpy.launches,
              "axpy_strided": strided.launches, "grid_dims": grid_k.launches}
    if counts != {"launches": 3, "axpy": 1, "axpy_strided": 1,
                  "grid_dims": 1}:
        raise AssertionError(f"rtc launch counts {counts}")
    oracle = axpy_oracle(x._data, y._data)
    if not (torch.equal(out._data, oracle) and torch.equal(out2._data,
                                                           oracle)):
        raise AssertionError("rtc axpy differs from 2*x + y")
    if dims.asnumpy().tolist() != [5.0, 3.0, 2.0]:
        raise AssertionError(f"grid (5, 3, 2) launched as {dims.asnumpy()}")
    broken = mx.rtc.CudaModule(BROKEN_SOURCE).get_kernel("broken")
    try:
        broken.launch([x], out_shape=(1,))
    except MXNetError as e:
        compile_error = [ln for ln in str(e).splitlines() if "error" in ln]
    else:
        raise AssertionError("a source that does not compile launched")
    cpu = mx.nd.ones((4,), ctx=mx.cpu())
    try:
        axpy.launch([cpu, cpu], out_shape=(4,))
    except MXNetError as e:
        cpu_error = str(e)
    else:
        raise AssertionError("rtc launched on CPU NDArrays")
    emit({"phase": "rtc", "shape": list(shape), "counts": counts,
          "axpy_bitwise": True, "strided_grid": small_grid,
          "grid_dims": dims.asnumpy().tolist(),
          "compile_error": compile_error, "cpu_error": cpu_error})
    return mod, counts


def nd_times(torch, lnr_mod, rtc_mod, nd_counts, rtc_counts, errs, smi):
    """K6 and rtc axpy at the nd path's shape: cold-L2 ms, plain ms,
    bound and one library call."""
    import torch.nn.functional as F
    import mxnet_tpu_torch as mx
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        x, r, g, b = lnr_case(torch, LNR_ROWS, DIM, dtype, dtype, seed=51)
        gl, bl = g.to(dtype), b.to(dtype)
        size = torch.finfo(dtype).bits // 8

        def kernel():
            return lnr_mod.layer_norm_residual(x, r, g, b)

        def library():
            return F.layer_norm(x + r, (DIM,), gl, bl, EPS)

        rows.append({
            "dtype": str(dtype),
            "ms": device_ms(torch, kernel),
            "plain_ms": device_ms(torch, lambda: lnr_mod.
                                  layer_norm_residual_reference(x, r, g, b)),
            "library_ms": device_ms(torch, library),
            # device time alone, and the host's cost of a call: the event
            # pair can take in a host call longer than the flush
            "profiler_ms": profiler_ms(torch, kernel, "lnr_"),
            "library_profiler_ms": profiler_ms(
                torch, library, ("add", "layer_norm", "LayerNorm",
                                 "RowwiseMoments"), required=False,
                per_call=True),
            "host_us_per_call": host_us_per_call(torch, kernel, 200),
            "library_host_us_per_call": host_us_per_call(torch, library, 200),
            "bytes": 3 * LNR_ROWS * DIM * size + 2 * DIM * 4,
            "ops": 10 * LNR_ROWS * DIM})
    xs, ys = (mx.nd.array(a, ctx=mx.gpu(0)) for a in onp.random.RandomState(
        61).randn(2, BATCH, SEQ, DIM).astype(onp.float32))
    axpy = rtc_mod.get_kernel("axpy", num_inputs=2)
    n = xs.size
    xt, yt = xs._data, ys._data

    def funnel():
        return axpy.launch([xs, ys], out_shape=xs.shape)

    def raw():      # the same cubin on the tensors, past the NDArray funnel
        return axpy._run((xt, yt), xt.shape, torch.float32, xt.device, None)

    def library():
        return torch.add(yt, xt, alpha=2)

    rtc_row = {
        "ms": device_ms(torch, funnel),
        "plain_ms": device_ms(torch, lambda: axpy_oracle(xt, yt)),
        "library_ms": device_ms(torch, library),
        "bytes": 3 * n * 4, "ops": 2 * n}
    # where the event gap to torch.add lies: the kernels' device times,
    # the same cubin without the funnel, and the host's cost of a call
    rtc_split = {
        "profiler_ms": profiler_ms(torch, funnel, "axpy"),
        "library_profiler_ms": profiler_ms(torch, library, "add",
                                           required=False),
        "raw_launch_ms": device_ms(torch, raw),
        "host_us_per_call": {
            "funnel": host_us_per_call(torch, funnel, 200),
            "raw_launch": host_us_per_call(torch, raw, 200),
            "library": host_us_per_call(torch, library, 200)}}
    kernels = []
    for name, route, src, repl, row, launches in (
            ("layer_norm_residual", "cuda",
             "mxnet_tpu_torch/csrc/layernorm_residual.cu",
             "mxnet_tpu/ops/layernorm_residual.py:43", rows[0],
             nd_counts["launches"]),
            ("rtc_axpy", "cuda", "mxnet_tpu_torch/rtc.py",
             "mxnet_tpu/rtc.py:40", dict(rtc_row, **rtc_split),
             rtc_counts["axpy"])):
        t_bytes = row["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = row["ops"] / FP32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": route, "source": src, "replaces": repl,
            "launches": launches, "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": row["library_ms"]})
    kernels[0]["profiler_ms"] = rows[0]["profiler_ms"]
    kernels[1]["profiler_ms"] = rtc_split["profiler_ms"]
    for row in rows:
        row["bound_ms"] = max(row["bytes"] / HBM_BYTES_PER_S,
                              row["ops"] / FP32_FLOPS) * 1e3
    emit({"phase": "times_nd", "gpu": smi,
          "layer_norm_residual": {"rows": LNR_ROWS, "f": DIM,
                                  "by_dtype": rows},
          "rtc_axpy": dict(rtc_row, n=n, **rtc_split),
          "library": "F.layer_norm(x + r, (F,), gamma, beta): two calls "
                     "for layer_norm_residual; torch.add(y, x, alpha=2) "
                     "for rtc_axpy",
          "kernels": [{k: r[k] for k in ("name", "ms", "profiler_ms",
                                         "plain_ms", "bound_ms",
                                         "library_ms")}
                      for r in kernels]})
    return kernels


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


def counted_call(torch, fns, call):
    """Launches and plain calls of each of ``fns`` in one ``call()``,
    counted apart from the main path (its counts must have been read)."""
    reset_counts(*fns)
    call()
    torch.cuda.synchronize()
    return {f.__name__: {"launches": f.launches,
                         "plain_calls": f.plain_calls} for f in fns}


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def replay_vs_eager(torch, pa_mod, eng, key, step):
    """``step()`` makes one public engine call whose last replay is exec
    key ``key``; then ``key``'s core runs eagerly on the same static
    inputs.  Its outputs and the live pages must equal the replay's bit
    for bit (the eager run rewrites the same rows), and every K4 scratch
    counter must be back at 0."""
    step()
    ex = eng._exec[key]
    if ex.graph is None:
        raise AssertionError(f"{key} holds no CUDA graph")
    torch.cuda.synchronize()
    replayed = [t.clone() for t in as_tuple(ex.outputs)]
    pages = eng.cache.pool.clone()
    eager = as_tuple(ex.eager())
    torch.cuda.synchronize()
    same_out = all(torch.equal(a, b) for a, b in zip(replayed, eager))
    same_pages = torch.equal(pages, eng.cache.pool)
    counters = sum(int(c.count_nonzero()) for _, c in
                   pa_mod._SCRATCH.values())
    if not (same_out and same_pages) or counters:
        raise AssertionError(f"{key}: replay and eager core differ (outputs "
                             f"equal {same_out}, live pages equal "
                             f"{same_pages}) or K4 counters left non-zero "
                             f"({counters})")
    return {"outputs": [t.tolist() for t in replayed],
            "outputs_bitwise_equal": True, "live_pages_bitwise_equal": True,
            "k4_counters_nonzero": counters}


def masked_grid(live):
    """The slot grid for a step over slots ``live`` (slot -> position):
    every other slot masked, at FAR_POSITION."""
    toks = onp.ones(SLOTS, onp.int32)
    pos = onp.full(SLOTS, FAR_POSITION, onp.int32)
    act = onp.zeros(SLOTS, bool)
    for s, p in live.items():
        pos[s], act[s] = p, True
    return toks, pos, act


def replay_checks(torch, pa_mod, eng):
    """Replays bitwise equal to the eager cores: a 128-token prefill
    chunk and a decode step on a plain engine, a verify on a speculative
    one, over two live slots and six masked ones."""
    rng = onp.random.RandomState(17)
    chunk = [int(t) for t in rng.randint(0, VOCAB, size=eng.prefill_chunk)]
    budget = 2 * eng.prefill_chunk
    eng.acquire_slot(0, budget)
    eng.acquire_slot(1, budget)
    eng.prefill_chunk_step(1, chunk[:40], 0)
    out = {"prefill_b128": replay_vs_eager(
        torch, pa_mod, eng, "prefill_b128",
        lambda: eng.prefill_chunk_step(0, chunk, 0))}
    toks, pos, act = masked_grid({0: len(chunk), 1: 40})
    if eng.spec_enabled:
        out["verify"] = replay_vs_eager(
            torch, pa_mod, eng, "verify",
            lambda: eng.spec_step(toks, pos, act))
    else:
        out["decode"] = replay_vs_eager(
            torch, pa_mod, eng, "decode",
            lambda: eng.decode_step(toks, pos, act))
    eng.release_slot(0)
    eng.release_slot(1)
    return out


def warm_engine(torch, srv, eng):
    """``srv.warmup(PREFILL_LENGTHS)``: every exec key captured ahead of
    traffic.  Returns what it took."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    keys = srv.warmup(PREFILL_LENGTHS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    missing = [k for k, ex in eng._exec.items() if ex.graph is None]
    if missing or sorted(keys) != eng.stats()["executables"]:
        raise AssertionError(f"warmup left keys without a graph: {missing}, "
                             f"{keys}")
    return {"keys": keys, "seconds": round(seconds, 3),
            "compiles": eng.compiles,
            "memory_allocated_bytes": torch.cuda.memory_allocated() - before,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


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
    warm = warm_engine(torch, srv, eng)
    stats_before = eng.stats()
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
    stats_after = eng.stats()
    if stats_after["compiles"] != stats_before["compiles"]:
        raise AssertionError(f"served traffic captured a graph: {stats_before}"
                             f" -> {stats_after}")
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
    # one prefill chunk and one decode step (replays): K5 once per layer
    # each (q and k in one launch), K4 once per layer of the decode step,
    # no plain call
    eng.acquire_slot(0, 2 * eng.prefill_chunk)
    chunk = list(range(1, eng.prefill_chunk + 1))
    toks, pos, act = masked_grid({0: eng.prefill_chunk})
    fns = (rope_mod.rope, pa_mod.paged_attention)
    per_call = {
        "prefill_chunk": counted_call(
            torch, fns, lambda: eng.prefill_chunk_step(0, chunk, 0)),
        "decode_step": counted_call(
            torch, fns, lambda: eng.decode_step(toks, pos, act))}
    eng.release_slot(0)
    want = {"prefill_chunk": (LAYERS, 0), "decode_step": (LAYERS, LAYERS)}
    if any(c != {"rope": {"launches": want[k][0], "plain_calls": 0},
                 "paged_attention": {"launches": want[k][1],
                                     "plain_calls": 0}}
           for k, c in per_call.items()):
        raise AssertionError(f"rope should launch once per layer of a "
                             f"decode step and a prefill chunk, paged "
                             f"attention once per layer of a decode step: "
                             f"{per_call}")
    replay = replay_checks(torch, pa_mod, eng)
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
          "warmup": warm, "engine_before_serving": stats_before,
          "engine_after_serving": stats_after, "counts": counts,
          "launches_per_call": per_call})
    emit({"phase": "replay_check", "engine": "plain", "checks": replay})
    return model, eng, prompts, outs, counts


def phase_spec(torch, rope_mod, pa_mod, model, prompts, outs):
    from mxnet_tpu_torch.serving import (DecodeEngine, DecodeModel,
                                         DecodeScheduler, ServingServer)
    draft = DecodeModel(VOCAB, dim=256, n_heads=4, n_layers=2, seed=7)
    eng = DecodeEngine(model, draft_model=draft, spec_k=SPEC_K,
                       max_slots=SLOTS, page_size=PAGE,
                       pages_per_slot=PAGES_PER_SLOT, num_pages=NUM_PAGES)
    sch = DecodeScheduler(eng)
    srv = ServingServer(decoder=sch)
    warm = warm_engine(torch, srv, eng)
    before = pa_mod.paged_attention.launches
    got, _lat, wall = serve_requests(srv, prompts[:4], 32, stagger_s=0.0)
    st = sch.stats()
    srv.stop()
    if got != outs[:4]:
        raise AssertionError("speculative output differs from plain path")
    if eng.compiles != warm["compiles"]:
        raise AssertionError(f"served speculative traffic captured a graph: "
                             f"{warm['compiles']} -> {eng.stats()}")
    if pa_mod.paged_attention.launches <= before:
        raise AssertionError("verify did not launch paged_attention")
    # one speculative step: the draft's k+1 chained steps launch K5 once
    # per draft layer each, verify once per target layer
    eng.acquire_slot(0, 2 * eng.prefill_chunk)
    eng.prefill_chunk_step(0, list(range(1, 9)), 0)
    toks, pos, act = masked_grid({0: 8})
    step = counted_call(torch, (rope_mod.rope,),
                        lambda: eng.spec_step(toks, pos, act))["rope"]
    eng.release_slot(0)
    draft_launches = (SPEC_K + 1) * draft.n_layers
    verify = dict(step, launches=step["launches"] - draft_launches)
    if verify != {"launches": LAYERS, "plain_calls": 0}:
        raise AssertionError(f"rope should launch once per layer of "
                             f"verify: spec step {step}, draft "
                             f"{draft_launches}")
    replay = replay_checks(torch, pa_mod, eng)
    emit({"phase": "spec", "requests": 4, "spec_k": SPEC_K,
          "rope_spec_step": step, "rope_verify": verify,
          "identical_to_plain": True, "wall_s": round(wall, 4),
          "spec_proposed": st["spec_proposed"],
          "spec_accepted": st["spec_accepted"],
          "paged_attention_launches": pa_mod.paged_attention.launches
          - before, "warmup": warm, "engine_after_serving": eng.stats()})
    emit({"phase": "replay_check", "engine": "speculative",
          "checks": replay})
    return eng


def device_ms(torch, fn, runs=50, clean=False):
    """Median device ms of one ``fn()`` with a cold L2: a 256 MiB write
    before each timed call evicts the 50 MB L2 (as the other layers'
    pages do between two calls in a decode step) and keeps the device
    busy while the host enqueues the call, so the event pair brackets
    device time, not host overhead.  The write leaves the L2 full of
    dirty lines, which the call's misses write back; ``clean`` reads the
    256 MiB instead, leaving clean lines."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(5):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(runs)]
    torch.cuda.synchronize()
    for a, b in pairs:
        if clean:
            flush.max()
        else:
            flush.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in pairs)[runs // 2]


def host_us_per_call(torch, fn, calls=1000):
    """Host µs of one call of ``fn``: a perf_counter over ``calls``
    back-to-back calls and one synchronise at the end.  The card runs
    behind the host for kernels this small, so this is what the host
    spends on a call: the wrapper's work and the launch."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / calls


def profiler_ms(torch, fn, name, runs=50, required=True, per_call=False):
    """Device ms of one launch of the kernel whose name holds ``name`` (a
    string, or a tuple of them), from torch.profiler over ``runs`` calls
    of ``fn``, each after the same L2 flush as ``device_ms`` (the flush is
    not counted); with ``per_call``, the device ms of one call of ``fn``
    in such kernels, however many it launches.  Without ``required`` a
    name the profile lacks gives None instead of failing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    names = (name,) if isinstance(name, str) else name
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and any(n in e.key for n in names)]
    if not hits:
        if not required:
            return None
        raise AssertionError(f"no device kernel named *{name}* in the "
                             f"profile")
    count = runs if per_call else sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def phase_times(torch, rope_mod, pa_mod, eng, prompts, counts, errs, smi):
    rows = []
    # the timer's floor: an empty kernel (a spin of 0 cycles) through the
    # same cold-L2 event pair
    floor_ms = device_ms(torch, lambda: torch.cuda._sleep(0))
    # rope at the decode shape (q or k of 8 slots: R=8, H=8, D=64), and
    # rope_qk rotating q and k of that shape in one launch
    x, pos = rope_case(torch, SLOTS, torch.float32, seed=11)
    x2, _ = rope_case(torch, SLOTS, torch.float32, seed=13)
    ms = device_ms(torch, lambda: rope_mod.rope(x, pos))
    prof_ms = {"rope": profiler_ms(torch, lambda: rope_mod.rope(x, pos),
                                   "rope_kernel")}
    plain = device_ms(torch, lambda: rope_mod.rope_reference(x, pos))
    rope_qk = {
        "ms": device_ms(torch, lambda: rope_mod.rope_qk(x, x2, pos)),
        "profiler_ms": profiler_ms(
            torch, lambda: rope_mod.rope_qk(x, x2, pos), "rope_kernel"),
        "plain_ms": device_ms(torch, lambda: (
            rope_mod.rope_reference(x, pos),
            rope_mod.rope_reference(x2, pos)))}
    host_us = {
        "rope": host_us_per_call(torch, lambda: rope_mod.rope(x, pos)),
        "rope_qk": host_us_per_call(
            torch, lambda: rope_mod.rope_qk(x, x2, pos)),
        # the same loop around one empty torch kernel: a launch through
        # PyTorch's own C++ path, for scale
        "empty_torch_kernel": host_us_per_call(
            torch, lambda: torch.cuda._sleep(0))}
    nbytes = 2 * x.numel() * 4 + pos.numel() * 4
    ops = 6 * x.numel() // 2 + 3 * SLOTS * HEAD_DIM // 2
    rope_qk["bound_ms"] = max((2 * nbytes - pos.numel() * 4)
                              / HBM_BYTES_PER_S, 2 * ops / FP32_FLOPS) * 1e3
    rows.append(("rope", "cuda", "mxnet_tpu_torch/csrc/rope.cu",
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
    prof_ms["paged_attention"] = profiler_ms(
        torch, lambda: pa_mod.paged_attention(q, kp, vp, tables, lens),
        "paged_attention_kernel")
    pa_clean_ms = device_ms(torch, lambda: pa_mod.paged_attention(
        q, kp, vp, tables, lens), clean=True)
    # every (partition, warps) config of the kernel at the same inputs
    configs = {f"partition{p}_warps{w}": device_ms(
        torch, lambda p=p, w=w: pa_mod.paged_attention(
            q, kp, vp, tables, lens, partition=p, warps=w))
        for p in pa_mod._PARTITIONS for w in pa_mod._WARPS}
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
    per_step = {"rope": {"decode_step": LAYERS,
                         "verify": LAYERS, "prefill_chunk": LAYERS},
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
    for row in kernels:
        row["profiler_ms"] = prof_ms[row["name"]]
    kernels[0]["host_us_per_call"] = host_us["rope"]
    cfg = pa_mod._kernels.resolve("paged_attention", *pa_mod._paged_signature(
        q, kp, vp, tables, lens))
    emit({"phase": "times", "gpu": smi, "paged_attention_lengths": lengths,
          "launches_per_step": per_step, "library_ms_null_reason": NO_LIBRARY,
          "timer_floor_ms": floor_ms,
          "rope_config": rope_mod._config(x, pos, 10000.0),
          "rope_qk": rope_qk, "rope_host_us_per_call": host_us,
          "paged_attention_config": cfg,
          "paged_attention_ms_clean_l2": pa_clean_ms,
          "paged_attention_ms_by_config": configs,
          "kernels": [{k: r[k] for k in ("name", "ms", "profiler_ms",
                                         "plain_ms", "bound_ms")}
                      for r in kernels]})
    return kernels


def flash_times(torch, fa_mod, train_counts, errs, smi):
    """K1 / K2 / K3 rows at the training shape (BH 64, S 2048, D 64,
    causal, bf16): cold-L2 ms, plain ms, bound and library ms."""
    import torch.nn.functional as F
    q, k, v, do = flash_case(torch, TRAIN_BH, SEQ, SEQ, HEAD_DIM,
                             torch.bfloat16, seed=21)
    scale = 1.0 / HEAD_DIM ** 0.5
    out, lse = fa_mod.flash_fwd(q, k, v, causal=True)
    delta = fa_mod._delta(do, out)
    as4 = [t.reshape(BATCH, HEADS, SEQ, HEAD_DIM).detach()
           .requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*as4, is_causal=True)
    do4 = do.reshape(BATCH, HEADS, SEQ, HEAD_DIM)
    pairs = TRAIN_BH * SEQ * (SEQ + 1) // 2      # causal (q, k) pairs
    prod = 2 * HEAD_DIM * pairs                  # flops of one product
    mat = TRAIN_BH * SEQ * HEAD_DIM * 2          # one bf16 (BH, S, D)
    vec = TRAIN_BH * SEQ * 4                     # one f32 (BH, S)
    lib_fwd = device_ms(torch, lambda: F.scaled_dot_product_attention(
        *as4, is_causal=True))
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        lib_out, as4, do4, retain_graph=True))
    # products counted in bf16 tensor-core passes (an f32 operand takes
    # three: hi + mid + lo), and as the f32-FMA kernels counted them (s in
    # bf16, the rest in f32), kept beside for the history
    specs = [
        ("flash_fwd", "mxnet_tpu/ops/attention.py:84",
         lambda: fa_mod.flash_fwd(q, k, v, causal=True),
         lambda: fa_mod.flash_forward_reference(q, k, v, True, scale),
         4 * mat + vec, 2, None, lib_fwd),
        ("flash_bwd_dkdv", "mxnet_tpu/ops/attention.py:255",
         lambda: fa_mod.flash_bwd_dkdv(q, k, v, do, lse, delta,
                                       causal=True),
         lambda: fa_mod._dkdv_reference(q, k, v, do, lse, delta, True,
                                        scale),
         6 * mat + 2 * vec, 8, 3, lib_bwd),
        ("flash_bwd_dq", "mxnet_tpu/ops/attention.py:307",
         lambda: fa_mod.flash_bwd_dq(q, k, v, do, lse, delta, causal=True),
         lambda: fa_mod._dq_reference(q, k, v, do, lse, delta, True, scale),
         5 * mat + 2 * vec, 5, 2, lib_bwd)]
    kernels = []
    for name, repl, kern, plain, nbytes, passes16, fma32, lib in specs:
        ms = device_ms(torch, kern)
        plain_ms = device_ms(torch, plain, runs=10)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = passes16 * prod / BF16_FLOPS * 1e3
        row = {
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
            "replaces": repl, "launches": train_counts[name]["launches"],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib}
        if fma32 is not None:
            row["bound_ms_f32_fma"] = max(t_bytes, (
                prod / BF16_FLOPS + fma32 * prod / FP32_FLOPS) * 1e3)
        else:       # K1: one exponential a score on the SMs' MUFU units
            row["bound_ms_exp"] = pairs / MUFU_EXP_PER_S * 1e3
        kernels.append(row)
    emit({"phase": "times_flash", "gpu": smi,
          "shape": {"bh": TRAIN_BH, "seq": SEQ, "head_dim": HEAD_DIM,
                    "causal": True, "dtype": "bfloat16", "tile": 64},
          "bf16_passes": {"flash_fwd": 2, "flash_bwd_dkdv": 8,
                          "flash_bwd_dq": 5},
          "launches_per_step": {k["name"]: LAYERS for k in kernels},
          "bound_rates": {"bf16_products_tflops": BF16_FLOPS / 1e12,
                          "f32_products_tflops": FP32_FLOPS / 1e12,
                          "bytes_tb_s": HBM_BYTES_PER_S / 1e12},
          "library": "scaled_dot_product_attention(is_causal=True): "
                     "forward for flash_fwd, its backward (dq, dk, dv "
                     "together) for flash_bwd_dkdv and flash_bwd_dq; that "
                     "backward rounds P and dS to bf16 (one pass), not "
                     "the reference's f32 products",
          "kernels": [{key: r[key] for key in ("name", "ms", "plain_ms",
                                               "bound_ms", "bound_ms_exp",
                                               "bound_ms_f32_fma",
                                               "library_ms") if key in r}
                      for r in kernels]})
    del as4, lib_out
    torch.cuda.empty_cache()
    return kernels


def kernel_rows(torch, fn, n):
    """torch.profiler over ``n`` calls of ``fn`` (each ending in a device
    sync): the host wall ms a call, and each device kernel's (ms a call,
    launches a call, name), largest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        wall = (time.perf_counter() - t0) * 1e3 / n
    return wall, sorted(((e.self_device_time_total / 1e3 / n, e.count / n,
                          e.key) for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA), reverse=True)


def profiled(torch, fn, n, count=None):
    """Host wall ms per call of ``fn`` (which ends in a device sync),
    device busy ms per call and the kernels by device time, from
    torch.profiler over ``n`` calls; with ``count`` (names), also the
    kernels per call in all (copies and memsets apart), the launches
    per call of the kernels whose names hold each name, and
    ``counts_whole``: whether those counted launches are each a
    multiple of ``n``, as they are for calls that each launch the same
    kernels unless the trace lost some of their events."""
    wall, kern = kernel_rows(torch, fn, n)
    busy = sum(k[0] for k in kern)
    top = [{"kernel": k[:90], "ms_per_call": ms, "launches_per_call": c}
           for ms, c, k in kern[:8]]
    if count is None:
        return wall, busy, top
    per = {name: sum(c for _, c, k in kern if name in k) for name in count}
    per["kernels"] = sum(c for _, c, k in kern
                         if not k.startswith(("Memcpy", "Memset")))
    per["counts_whole"] = all(round(per[name] * n) % n == 0
                              for name in count)
    return wall, busy, top, per


def profiled_whole(torch, fn, n, count, tries=3):
    """``profiled`` with ``count``, taken again while the trace lost
    events of a counted kernel (the profiler drops a few now and then:
    its launches over ``n`` identical calls are then no multiple of
    ``n``), at most ``tries`` times; counts a step are read from a trace
    that kept every counted launch.  Returns its result and the number
    of traces taken."""
    for attempt in range(1, tries + 1):
        out = profiled(torch, fn, n, count)
        if out[3]["counts_whole"]:
            return out + (attempt,)
    raise AssertionError(f"torch.profiler lost launches of {count} in each "
                         f"of {tries} traces of {n} calls: {out[3]}")


def host_ms_blocks(fns, calls=20, rounds=2):
    """Host ms per call of each of ``fns`` (name -> fn, each ending in a
    device sync), in blocks of ``calls`` taken in turns, ``rounds``
    times: every block, and the median of the blocks."""
    blocks = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            blocks[name].append((time.perf_counter() - t0) * 1e3 / calls)
    return {name: {"blocks": b, "median": sorted(b)[len(b) // 2]}
            for name, b in blocks.items()}


def phase_profile(torch, eng, spec_eng, prompts, smi):
    """Where one decode step, one 128-token prefill chunk and one
    speculative step spend their time at the serve shapes (8 active slots
    at the served lengths), replayed from their CUDA graphs and, in the
    same process, eager: the same cores run on the executables' static
    inputs."""
    lengths = [len(p) + 31 for p in prompts[:SLOTS]]
    for s, n in enumerate(lengths):
        eng.acquire_slot(s, max(n + 1, eng.prefill_chunk))
        spec_eng.acquire_slot(s, max(n + 1 + SPEC_K, eng.prefill_chunk))
    toks = onp.ones(SLOTS, onp.int32)
    pos = onp.asarray(lengths, onp.int32)
    act = onp.ones(SLOTS, bool)
    chunk = list(range(1, eng.prefill_chunk + 1))
    padded = onp.asarray(chunk, onp.int32)
    dec, pre = eng._exec["decode"], eng._exec["prefill_b128"]
    draft, verify = spec_eng._exec["draft"], spec_eng._exec["verify"]
    # each ends in its output's read-back, as the engine's calls do
    modes = {
        "decode_step": {
            "replayed": lambda: eng.decode_step(toks, pos, act),
            "eager": lambda: dec.eager(*eng._slot_args(
                toks, pos, act, eng.cache)).cpu()},
        "prefill_chunk_128": {
            "replayed": lambda: eng.prefill_chunk_step(0, chunk, 0),
            "eager": lambda: int(pre.eager(*eng._prefill_args(
                padded, 0, len(chunk), eng.cache, 0)))},
        "spec_step": {
            "replayed": lambda: spec_eng.spec_step(toks, pos, act),
            "eager": lambda: (
                draft.eager(*spec_eng._slot_args(toks, pos, act,
                                                 spec_eng.draft_cache)),
                [t.cpu() for t in verify.eager(
                    onp.asarray(pos, onp.int32), spec_eng.cache.tables,
                    act)])}}
    out = {"phase": "profile", "gpu": smi}
    for name, fns in modes.items():
        for fn in fns.values():
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        row = {"host_ms": host_ms_blocks(fns)}
        for mode, fn in fns.items():
            wall, busy, top, per, traces = profiled_whole(
                torch, fn, 20, ("paged_attention_kernel", "rope_kernel"))
            host = row["host_ms"][mode]["median"]
            row[mode] = {"host_ms": host, "profiled_host_ms": wall,
                         "device_busy_ms": busy,
                         "device_idle_share": 1 - busy / wall,
                         # the profiler lengthens the host's calls: the
                         # busy time over the unprofiled host ms beside
                         "device_idle_share_of_host_ms": 1 - busy / host,
                         "kernels_per_step": per["kernels"],
                         "paged_attention_kernels_per_step":
                             per["paged_attention_kernel"],
                         "rope_kernels_per_step": per["rope_kernel"],
                         "traces": traces, "top_kernels": top}
        out[name] = row
    # launches a step, by the device trace, in both modes: K4 once per
    # layer of a decode step (one per call) and of each of the draft's k+1
    # steps and verify's k+1 window columns; K5 once per layer of each pass
    draft_layers = spec_eng.draft.n_layers
    want = {"decode_step": (LAYERS, LAYERS),
            "prefill_chunk_128": (0, LAYERS),
            "spec_step": ((SPEC_K + 1) * (draft_layers + LAYERS),
                          (SPEC_K + 1) * draft_layers + LAYERS)}
    for name, (pa, rp) in want.items():
        for mode in ("replayed", "eager"):
            got = out[name][mode]
            if (got["paged_attention_kernels_per_step"],
                    got["rope_kernels_per_step"]) != (pa, rp):
                raise AssertionError(
                    f"{name} ({mode}) should launch {pa} paged attention and "
                    f"{rp} rope kernels a step by the device trace: {got}")
    for s in range(SLOTS):
        eng.release_slot(s)
        spec_eng.release_slot(s)
    out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)


def phase_profile_train(torch, trainer, data, label, smi):
    """Where one full-width bf16 training step spends its time, replayed
    from its CUDA graph and eager (the function the graph holds): host ms
    in blocks taken in turns, then torch.profiler's device busy ms, idle
    share, kernels a step and the flash kernels a step by the device
    trace (8 each in both modes)."""
    modes = {"replayed": lambda: float(trainer.step(data, label)),
             "eager": lambda: float(trainer._step_eager(data, label))}
    for fn in modes.values():
        fn()
    torch.cuda.synchronize()
    out = {"phase": "profile_train", "gpu": smi,
           "host_ms": host_ms_blocks(modes, calls=5, rounds=2)}
    names = ("fa_fwd", "fa_bwd_dkdv", "fa_bwd_dq")
    for mode, fn in modes.items():
        wall, busy, top, per, traces = profiled_whole(torch, fn, 3, names)
        host = out["host_ms"][mode]["median"]
        out[mode] = {"host_ms": host, "profiled_host_ms": wall,
                     "device_busy_ms": busy,
                     "device_idle_share": 1 - busy / wall,
                     "device_idle_share_of_host_ms": 1 - busy / host,
                     "kernels_per_step": per["kernels"],
                     "flash_kernels_per_step": {n: per[n] for n in names},
                     "traces": traces, "top_kernels": top}
        if any(per[n] != LAYERS for n in names):
            raise AssertionError(f"profile_train ({mode}): flash kernels a "
                                 f"step by the device trace {per}")
    emit(out)


def kernels_by_name(torch, fn, n=3):
    """Each device kernel's launches a call of ``fn``, by name, from a
    CUDA-only torch.profiler trace over ``n`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key[:120]] = out.get(e.key[:120], 0) + e.count / n
    return out


def train_ab_child(torch, tree):
    """One tree of ``--train-ab``, in a process of its own: that tree's
    ``chip_smoke`` and ``mxnet_tpu_torch`` (so an older checkout's
    trainer runs as it was), its training row, ``step`` and, where the
    tree has it, ``_step_eager``; prints one JSON line."""
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import attention as fa_mod
    from mxnet_tpu_torch.parallel import SPMDTrainer
    if not os.path.abspath(fa_mod.__file__).startswith(tree):
        raise AssertionError(f"imported {fa_mod.__file__}, not {tree}")
    fa_mod.build()
    out = {"tree": tree, "gpu": nvidia_smi()}
    trainer = SPMDTrainer(cs.train_model(torch), SoftmaxCrossEntropyLoss(),
                          optimizer="adam",
                          optimizer_params={"learning_rate": cs.LR},
                          dtype="bfloat16")
    data, label = cs.train_batch(torch)
    modes = {"step": lambda: float(trainer.step(data, label))}
    if hasattr(trainer, "_step_eager"):
        modes["eager"] = lambda: float(trainer._step_eager(data, label))
    for fn in modes.values():
        for _ in range(2):
            fn()

    def host_blocks():
        """5 blocks of 5 steps of each mode, the modes in turns."""
        blocks = {name: [] for name in modes}
        for _ in range(5):
            for name, fn in modes.items():
                t0 = time.perf_counter()
                for _ in range(5):
                    fn()
                blocks[name].append((time.perf_counter() - t0) * 1e3 / 5)
        return blocks

    blocks = host_blocks()                   # before the first profile
    for name, fn in modes.items():
        host = sorted(blocks[name])[2]
        wall, busy, _, per = cs.profiled(torch, fn, 3, ())
        out[name] = {"host_ms": host, "host_ms_blocks": blocks[name],
                     "profiled_host_ms": wall, "device_busy_ms": busy,
                     "device_idle_share": 1 - busy / wall,
                     "device_idle_share_of_host_ms": 1 - busy / host,
                     "kernels_per_step": per["kernels"],
                     "kernels_by_name": kernels_by_name(torch, fn)}
    for name, after in host_blocks().items():    # after the profiles
        out[name]["host_ms_after_profiles"] = sorted(after)[2]
        out[name]["host_ms_blocks_after_profiles"] = after
    print(json.dumps(out), flush=True)


def train_ab(trees):
    """``--train-ab``: each tree in turn, in a process of its own; the
    last line holds every tree's line."""
    results = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--train-ab-child",
             tree], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    print(json.dumps({"trees": results}), flush=True)
    return 0


# kernel names by kind, first match wins (convolutions before GEMMs:
# cuDNN's implicit-GEMM kernels hold "gemm" too)
KERNEL_KINDS = (
    ("layout_transpose", ("nchwToNhwc", "nhwcToNchw", "transpose",
                          "Transpose")),
    ("batch_norm", ("batch_norm", "batchnorm", "BatchNorm", "bn_fw",
                    "bn_bw")),
    ("conv", ("conv", "Conv", "fprop", "dgrad", "wgrad", "implicit",
              "cudnn")),
    ("gemm", ("gemm", "Gemm", "cublas", "nvjet")),
    ("pooling", ("pool", "Pool")),
    ("optimizer_foreach", ("multi_tensor", "foreach", "Foreach")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise", "Elementwise")),
    ("copy_memset", ("Memcpy", "Memset", "memcpy", "copy")))


def kernel_kind(name):
    for kind, marks in KERNEL_KINDS:
        if any(m in name for m in marks):
            return kind
    return "other"


def profiled_kinds(torch, fn, n, tries=3):
    """torch.profiler over ``n`` calls of ``fn`` (each ending in a device
    sync): host wall ms a call, device busy ms a call, kernels a call
    (copies and memsets apart), the device ms and launches a call of
    each kind of kernel (``KERNEL_KINDS``), and the top 12 kernels.  A
    trace that lost kernel events (kernels over ``n`` identical calls no
    multiple of ``n``) is taken again, at most ``tries`` times; the last
    is kept, ``counts_whole`` false, if none kept every event."""
    for attempt in range(1, tries + 1):
        wall, kern = kernel_rows(torch, fn, n)
        kernels = sum(c for _, c, k in kern
                      if not k.startswith(("Memcpy", "Memset")))
        if round(kernels * n) % n == 0:
            break
    busy = sum(k[0] for k in kern)
    kinds = {}
    for ms, c, name in kern:
        row = kinds.setdefault(kernel_kind(name), {"ms": 0.0, "launches": 0.0})
        row["ms"] += ms
        row["launches"] += c
    return {"profiled_host_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / wall if wall else None,
            "kernels_per_call": kernels, "traces": attempt,
            "counts_whole": round(kernels * n) % n == 0,
            "by_kind": dict(sorted(kinds.items(),
                                   key=lambda kv: -kv[1]["ms"])),
            "top_kernels": [{"kernel": k[:110], "kind": kernel_kind(k),
                             "ms_per_call": ms, "launches_per_call": c}
                            for ms, c, k in kern[:12]]}


def resnet_net(torch, device, classes=1000, thumbnail=False,
               image=None, seed=0):
    """ResNet-50 v1 as bench.py and ``__graft_entry__.entry()`` build it:
    Xavier weights from a host generator seeded with ``seed`` (the same
    weights on any device), deferred dims filled by one (1, 3, image,
    image) forward in eval mode on ``device``."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet
    image = image or RESNET_IMAGE
    net = get_resnet(1, 50, classes=classes, thumbnail=thumbnail)
    net.initialize(init=initializer.Xavier(), device=device,
                   generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net(torch.zeros((1, 3, image, image), device=device))
    return net


def resnet_trainer(torch, net, device=None, **kw):
    """The headline row's trainer on ``net``: SGD lr 0.05, momentum 0.9,
    wd 1e-4 (``dtype`` as given)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer
    return SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                       optimizer_params=dict(RESNET_SGD),
                       device=device or DEV, **kw)


def resnet_state(trainer):
    """name -> tensor: every master (the running statistics included),
    and the momentum of each parameter the optimizer updates."""
    out = {}
    for k, p in zip(trainer._pkeys, trainer._plist):
        out[k] = p.data()
        if p.grad_req != "null":
            out[k + ":momentum"] = trainer._opt_state[k][0]
    return out


def rel_l2(a, b):
    """||a - b|| / ||b|| in f64 on the host (0 when both are 0)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb else float((a - b).norm())


def phase_resnet_check(torch):
    """The ResNet path on the card against the port's own CPU path (which
    the CPU tests hold against the reference): entry()'s net, ResNet-50
    v1 thumbnail with 10 classes, Xavier weights (seed 0), a (8, 3, 32,
    32) batch and float labels from numpy seed 51, TF32 off.

    Eval logits in fp32.  Then three SGD steps (lr 0.05, momentum 0.9, wd
    1e-4) through ``SPMDTrainer`` (on the card the first is the warm step
    and the capture, the others replays) in fp32 and in fp64, on the card
    and on the CPU.  Each step starts every trainer from the CPU's fp64
    state (copied in place), so each step's comparison holds one step's
    error: at this lr a step of 8 images amplifies an fp32 rounding
    difference chaotically (the port's fp32 on the CPU left its fp64 by
    17% in the third free-running loss), so free-running trajectories
    part for reasons no tolerance tells from a fault.  Tolerances:

    * fp32 logits: max |err| <= 1e-4 max |ref|; losses rtol 1e-4; each
      running mean and variance within 1e-4 of its norm (L2);
    * fp32 masters and momenta: BatchNorm's backward amplifies rounding
      in channels whose batch variance is near zero (one fp32 step on
      the CPU leaves a momentum 1.6% of its norm from fp64), so they are
      held as a whole: the root mean square over tensors of each
      tensor's relative L2 error against the CPU's fp64 state, on the
      card, at most 10x the CPU's fp32 one plus 1e-6 (cuDNN's fp32
      algorithms round otherwise than the CPU's: 3.05x in one step of
      the first run; a tensor left unupdated would add ~0.08);
    * fp64, card against CPU: losses rtol 1e-6 (the loss mean is taken
      in f32, as the reference takes it), every master, momentum and
      running statistic within 1e-8 of its norm (L2)."""
    t0 = time.perf_counter()
    rng = onp.random.RandomState(51)
    x = rng.standard_normal((CHECK_BATCH, 3, CHECK_IMAGE, CHECK_IMAGE)
                            ).astype(onp.float32)
    y = rng.randint(0, 10, size=(CHECK_BATCH,)).astype(onp.float32)
    runs = {}
    for dev in (DEV, "cpu"):
        for dt in ("float32", "float64"):
            net = resnet_net(torch, dev, classes=10, thumbnail=True,
                             image=CHECK_IMAGE)
            if dt == "float64":
                net.cast("float64")
            runs[(dev, dt)] = (
                net, resnet_trainer(torch, net, device=dev),
                torch.as_tensor(x, device=dev, dtype=getattr(torch, dt)),
                torch.as_tensor(y, device=dev))
    truth_key = ("cpu", "float64")
    with torch.no_grad():
        logits = {dev: runs[(dev, "float32")][0](runs[(dev, "float32")][2])
                  .cpu() for dev in (DEV, "cpu")}
    scale = float(logits["cpu"].abs().max())
    logit_err = float((logits[DEV] - logits["cpu"]).abs().max())
    failures = []
    if not logit_err <= 1e-4 * scale:
        failures.append(f"eval logits card vs CPU: max |err| {logit_err} "
                        f"beyond 1e-4 x {scale}")
    steps = []
    for step in range(3):
        losses = {key: float(tr.step(d, l))
                  for key, (_, tr, d, l) in runs.items()}
        states = {key: resnet_state(tr) for key, (_, tr, _, _) in
                  runs.items()}
        truth = {k: t.detach().cpu() for k, t in states[truth_key].items()}
        aux = [k for k in truth if k.endswith(("running_mean",
                                               "running_var"))]
        learned = [k for k in truth if k not in aux]
        row = {"losses": {f"{d}_{t}": v for (d, t), v in losses.items()}}
        for dt, loss_tol in (("float32", 1e-4), ("float64", 1e-6)):
            a, b = losses[(DEV, dt)], losses[("cpu", dt)]
            if not abs(a - b) <= loss_tol * abs(b):
                failures.append(f"step {step} {dt} loss card {a} vs CPU {b}"
                                f" beyond rtol {loss_tol}")
        card32, cpu32 = states[(DEV, "float32")], states[("cpu", "float32")]
        aux_err = max(rel_l2(card32[k], cpu32[k]) for k in aux)
        if not aux_err <= 1e-4:
            failures.append(f"step {step}: fp32 running statistics card vs "
                            f"CPU {aux_err} beyond 1e-4")

        def rms(state):
            return float(onp.sqrt(onp.mean(
                [rel_l2(state[k], truth[k]) ** 2 for k in learned])))

        rms_card, rms_cpu = rms(card32), rms(cpu32)
        if not rms_card <= 10 * rms_cpu + 1e-6:
            failures.append(f"step {step}: fp32 masters and momenta "
                            f"{rms_card} from fp64 on the card, {rms_cpu} "
                            f"on the CPU")
        f64_err = max((rel_l2(states[(DEV, "float64")][k], truth[k]), k)
                      for k in truth)
        if not f64_err[0] <= 1e-8:
            failures.append(f"step {step}: fp64 card vs CPU {f64_err[1]} "
                            f"{f64_err[0]} beyond 1e-8")
        row.update(fp32_running_stats_rel_l2=aux_err,
                   fp32_rms_rel_l2_vs_fp64={"card": rms_card,
                                            "cpu": rms_cpu},
                   fp64_max_rel_l2=f64_err[0])
        steps.append(row)
        with torch.no_grad():                    # the next step's start
            for key, (_, tr, _, _) in runs.items():
                if key != truth_key:
                    for k, t in states[key].items():
                        t.copy_(truth[k])
    compiles = {f"{d}_{t}": tr.compiles for (d, t), (_, tr, _, _)
                in runs.items()}
    for dt in ("float32", "float64"):
        tr = runs[(DEV, dt)][1]
        if DEV == "cuda":
            step_graph(tr)
        if tr.compiles != 1:
            failures.append(f"{dt}: {tr.compiles} captures")
    emit({"phase": "resnet_check", "net": "resnet50_v1 thumbnail, 10 "
          "classes", "batch": [CHECK_BATCH, 3, CHECK_IMAGE, CHECK_IMAGE],
          "tf32": False, "sgd": RESNET_SGD,
          "eval_logits": {"max_abs_err": logit_err, "max_abs_ref": scale,
                          "tolerance": "1e-4 x max|ref|"},
          "steps": steps, "captures": compiles,
          "tolerance": {"loss_fp32_rtol": 1e-4, "loss_fp64_rtol": 1e-6,
                        "running_stats_fp32_rel_l2": 1e-4,
                        "fp32_rms_vs_fp64": "card <= 10 x cpu + 1e-6",
                        "fp64_rel_l2": 1e-8},
          "failures": failures, "phase_s": time.perf_counter() - t0})
    if failures:
        raise AssertionError(f"resnet_check: {failures}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()


def resnet_batch(torch, batch, seed=0):
    """bench.py's synthetic batch, made on the card: normal data and float
    labels in [0, 1000) from an explicit generator."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    data = torch.randn((batch, 3, RESNET_IMAGE, RESNET_IMAGE), generator=g,
                       device=DEV)
    label = torch.randint(0, 1000, (batch,), generator=g,
                          device=DEV).float()
    return data, label


def marginal(run, windows=None):
    """bench.py's ``_marginal``: seconds a unit from the slope between
    windows of n1 and n2 units (the least of ``reps`` runs of each, after
    one warm run of each), so that a constant cost a window cancels.
    Returns (slope s, least s of n1, least s of n2)."""
    n1, n2, reps = windows or WINDOWS
    run(n1)
    run(n2)

    def timed(n):
        t0 = time.perf_counter()
        run(n)
        return time.perf_counter() - t0

    t1 = min(timed(n1) for _ in range(reps))
    t2 = min(timed(n2) for _ in range(reps))
    return max((t2 - t1) / (n2 - n1), 1e-9), t1, t2


def resnet_rate(torch, trainer, data, label, losses):
    """img/s of ``run_steps`` by ``marginal``; every window's losses are
    appended to ``losses``."""
    def run(n):
        losses.extend(float(v) for v in trainer.run_steps(data, label,
                                                          n).cpu())

    slope, t1, t2 = marginal(run)
    batch = data.shape[0]
    return {"img_per_s": batch / slope, "step_ms": slope * 1e3,
            "tflop_per_s_bench_convention":
                RESNET_TRAIN_FLOPS * batch / slope / 1e12,
            "window_s": {str(WINDOWS[0]): t1, str(WINDOWS[1]): t2}}


def phase_resnet_train(torch, smi):
    """bench.py's headline row (``_train_bench``, :187-268) at full size:
    ResNet-50 v1, 1000 classes, Xavier (seed 0), 224 x 224, batch 256,
    ``dtype="bfloat16"``, SGD lr 0.05 momentum 0.9 wd 1e-4, data and
    float labels made on the card (generator seed 0).  The first ``step``
    is the warm step (cuDNN's algorithm search runs there) and the
    capture; img/s by ``marginal`` over ``run_steps`` windows of 4 and 24
    steps; losses finite and falling; host ms a step replayed against
    eager (``_step_eager``) in blocks of 5 taken in turns; torch.profiler
    over 3 steps of each; memory.  Then the replay check (two trainers
    from the same weights, a warm step and 3 replays against 4 eager
    steps, bitwise; cuDNN deterministic for it), and the fp32 row at
    batch 64 (TF32 off)."""
    t0 = time.perf_counter()
    net = resnet_net(torch, DEV)
    trainer = resnet_trainer(torch, net, dtype="bfloat16")
    data, label = resnet_batch(torch, RESNET_BATCH)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem = {"allocated_before_warmup": torch.cuda.memory_allocated(),
           "reserved_before_warmup": torch.cuda.memory_reserved()}
    w0 = time.perf_counter()
    losses = [float(trainer.step(data, label))]     # the warm step + capture
    warm_s = time.perf_counter() - w0
    step_graph(trainer)
    mem.update(max_allocated_warmup=torch.cuda.max_memory_allocated(),
               allocated_after_warmup=torch.cuda.memory_allocated(),
               reserved_after_warmup=torch.cuda.memory_reserved())
    torch.cuda.reset_peak_memory_stats()
    rate = resnet_rate(torch, trainer, data, label, losses)
    mem["max_allocated_replays"] = torch.cuda.max_memory_allocated()
    if trainer.compiles != 1:
        raise AssertionError(f"{trainer.compiles} captures for one "
                             f"signature")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"ResNet-50 losses not finite and falling: "
                             f"{losses}")
    modes = {"replayed": lambda: float(trainer.step(data, label)),
             "eager": lambda: float(trainer._step_eager(data, label))}
    for fn in modes.values():
        fn()
    host = host_ms_blocks(modes, calls=5, rounds=2)
    prof = {}
    for mode, fn in modes.items():
        prof[mode] = profiled_kinds(torch, fn, 3)
        h = host[mode]["median"]
        prof[mode]["host_ms"] = h
        prof[mode]["device_idle_share_of_host_ms"] = (
            1 - prof[mode]["device_busy_ms"] / h)
    mem["max_allocated_with_eager"] = torch.cuda.max_memory_allocated()
    emit({"phase": "resnet_train", "gpu": smi,
          "model": {"net": "resnet50_v1", "classes": 1000,
                    "image": RESNET_IMAGE, "batch": RESNET_BATCH,
                    "dtype": "bfloat16", "optimizer": "sgd", **RESNET_SGD,
                    "cudnn_benchmark": torch.backends.cudnn.benchmark},
          "setup_s": setup_s, "warmup_s": warm_s, **rate,
          "tflop_convention": "3 x 4.089 GFLOP an image (bench.py:76)",
          "losses_first_last": [losses[0], losses[-1]],
          "losses_steps": len(losses), "host_ms": host,
          "img_per_s_host_replayed": RESNET_BATCH / (
              host["replayed"]["median"] / 1e3),
          "img_per_s_host_eager": RESNET_BATCH / (
              host["eager"]["median"] / 1e3),
          "profile": prof, "memory_bytes": mem,
          "captures": trainer.compiles,
          "phase_s": time.perf_counter() - t0})
    del trainer, net, modes
    gc.collect()
    torch.cuda.empty_cache()
    resnet_replay_check(torch, data, label)
    del data, label
    gc.collect()
    torch.cuda.empty_cache()
    resnet_fp32_row(torch)


def resnet_replay_check(torch, data, label):
    """Two trainers from the same weights at the headline row's size: a
    warm step and 3 replays against 4 eager steps (``_step_eager``), with
    cuDNN restricted to deterministic algorithms (an algorithm that adds
    with atomics would part two eager runs too).  Losses, every master
    (the running statistics included) and every momentum bitwise equal."""
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        captured = resnet_trainer(torch, resnet_net(torch, DEV),
                                  dtype="bfloat16")
        eager = resnet_trainer(torch, resnet_net(torch, DEV),
                               dtype="bfloat16")
        start = [k for k, t in resnet_state(captured).items()
                 if not torch.equal(t, resnet_state(eager)[k])]
        if start:
            raise AssertionError(f"the two trainers start apart: "
                                 f"{start[:4]}")
        losses_c = [float(captured.step(data, label)) for _ in range(4)]
        losses_e = [float(eager._step_eager(data, label)) for _ in range(4)]
        step_graph(captured)
        a, b = resnet_state(captured), resnet_state(eager)
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        stats = [k for k in a if k.endswith(("running_mean",
                                             "running_var"))]
        moved = sum(not torch.equal(a[k], torch.full_like(
            a[k], 1.0 if k.endswith("running_var") else 0.0))
            for k in stats)
        if losses_c != losses_e or diff or captured.compiles != 1:
            raise AssertionError(f"captured and eager ResNet steps differ: "
                                 f"losses {losses_c} vs {losses_e}; state "
                                 f"{diff[:6]} ({len(diff)} tensors); "
                                 f"captures {captured.compiles}")
        if moved != len(stats):
            raise AssertionError(f"{len(stats) - moved} running statistics "
                                 f"never moved")
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"phase": "resnet_replay_check", "steps": "1 warm + 3 replays vs "
          "4 eager", "batch": RESNET_BATCH, "dtype": "bfloat16",
          "cudnn_deterministic": True, "losses_captured": losses_c,
          "losses_eager": losses_e, "bitwise_equal": True,
          "state_tensors": len(a), "running_statistics": len(stats),
          "phase_s": time.perf_counter() - t0})
    del captured, eager, a, b
    gc.collect()
    torch.cuda.empty_cache()


def resnet_fp32_row(torch):
    """bench.py's fp32 training row (batch 64, bench.py:46, :622): img/s
    by the same slope, TF32 off (as every fp32 number of this script)."""
    t0 = time.perf_counter()
    trainer = resnet_trainer(torch, resnet_net(torch, DEV))
    data, label = resnet_batch(torch, RESNET_FP32_BATCH)
    w0 = time.perf_counter()
    losses = [float(trainer.step(data, label))]
    warm_s = time.perf_counter() - w0
    step_graph(trainer)
    rate = resnet_rate(torch, trainer, data, label, losses)
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"fp32 ResNet-50 losses not finite and "
                             f"falling: {losses}")
    emit({"phase": "resnet_train_fp32", "batch": RESNET_FP32_BATCH,
          "dtype": "float32",
          "tf32": torch.backends.cudnn.allow_tf32
          or torch.backends.cuda.matmul.allow_tf32,
          "warmup_s": warm_s, **rate,
          "losses_first_last": [losses[0], losses[-1]],
          "phase_s": time.perf_counter() - t0})
    del trainer, data, label
    gc.collect()
    torch.cuda.empty_cache()


def phase_resnet_infer(torch, smi):
    """bench.py's ``_infer_bench`` (:270-341) at batch 128: the eval
    forward of ResNet-50 v1 (Xavier, seed 0) in fp32 (TF32 off) and in
    bf16 through ``net.cast("bfloat16")``, img/s by ``marginal`` over
    windows of 4 and 24 forwards (each window ends in one read-back of
    the summed logits, as bench.py's); torch.profiler over 3 forwards of
    each; the bf16 logits against the fp32 ones within 2e-2 of the
    largest."""
    t0 = time.perf_counter()
    net = resnet_net(torch, DEV)
    g = torch.Generator(device=DEV).manual_seed(0)
    x32 = torch.randn((RESNET_INFER_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE),
                      generator=g, device=DEV)
    rows, logits = {}, {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            net.cast("bfloat16")
        x = x32.to(getattr(torch, dtype))

        def forward():
            with torch.no_grad():
                return net(x)

        def run(n):
            acc = torch.zeros((), device=DEV)
            for _ in range(n):
                acc += forward().float().sum()
            float(acc)

        logits[dtype] = forward().float()
        slope, t1, t2 = marginal(run)
        prof = profiled_kinds(torch, lambda: float(
            forward().float().sum()), 3)
        rows[dtype] = {"img_per_s": RESNET_INFER_BATCH / slope,
                       "forward_ms": slope * 1e3,
                       "window_s": {str(WINDOWS[0]): t1,
                                    str(WINDOWS[1]): t2},
                       "profile": prof}
    scale = float(logits["float32"].abs().max())
    err = float((logits["bfloat16"] - logits["float32"]).abs().max())
    if not (torch.isfinite(logits["bfloat16"]).all() and
            err <= 2e-2 * scale):
        raise AssertionError(f"bf16 logits vs fp32: max |err| {err} beyond "
                             f"2e-2 x {scale}")
    emit({"phase": "resnet_infer", "gpu": smi, "batch": RESNET_INFER_BATCH,
          "image": RESNET_IMAGE, "tf32": False, "rows": rows,
          "bf16_vs_fp32_logits": {"max_abs_err": err, "max_abs_ref": scale,
                                  "tolerance": "2e-2 x max|ref|"},
          "phase_s": time.perf_counter() - t0})
    del net, x32, logits
    gc.collect()
    torch.cuda.empty_cache()


# -- the eager Gluon loop (slice 10) ---------------------------------------------

GLUON_STEPS = 10
GLUON_SPMD_HOST = {}    # phase_train's SPMDTrainer host ms, for gluon_train


def gluon_loop_step(mx, amp, net, loss_fn, trainer, x, y, batch,
                    scaled=True, poison=None):
    """One step of the eager Gluon loop: the forward and loss recorded,
    ``backward`` (through ``amp.scale_loss`` when ``scaled``), then
    ``trainer.step``; ``poison(net)`` runs right after the backward,
    inside ``scale_loss``.  Returns the per-sample loss (an NDArray)."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
        if scaled:
            with amp.scale_loss(loss, trainer) as s:
                s.backward()
                if poison is not None:
                    poison(net)
    if not scaled:
        loss.backward()
    trainer.step(batch)
    return loss


def optimizer_launches(torch, mx, amp, net, loss_fn, trainer, x, y,
                       batch):
    """``trainer.step`` alone (after a recorded forward and backward),
    with the fused step on and off (``MXNET_FUSED_STEP=0``): its host ms
    to the end of its device work (unprofiled, the median of 3 steps),
    and its kernels and device ms from a CUDA-only trace of one more."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def backward():
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
            with amp.scale_loss(loss, trainer) as s:
                s.backward()
        torch.cuda.synchronize()

    out = {}
    for mode, env in (("fused", "1"), ("per_parameter", "0")):
        os.environ["MXNET_FUSED_STEP"] = env
        try:
            hosts = []
            for _ in range(3):
                backward()
                t0 = time.perf_counter()
                trainer.step(batch)
                torch.cuda.synchronize()
                hosts.append((time.perf_counter() - t0) * 1e3)
            host = sorted(hosts)[1]
            backward()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                trainer.step(batch)
                torch.cuda.synchronize()
        finally:
            os.environ.pop("MXNET_FUSED_STEP", None)
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        out[mode] = {"kernels": sum(e.count for e in kern
                                    if not e.key.startswith(("Memcpy",
                                                             "Memset"))),
                     "device_ms": sum(e.self_device_time_total
                                      for e in kern) / 1e3,
                     "host_ms": host}
    return out


def phase_gluon_train(torch, fa_mod, smi):
    """The transformer row at full width (bench.py's _transformer_bench:
    vocab 32000, dim 512, 8 heads, 8 layers, batch 8 x 2048, int32 ids
    seed 2, Xavier weights seed 0) trained through the eager Gluon loop:
    ``amp.init("bfloat16")``, ``gluon.Trainer(..., "adam", lr 3e-4)``,
    ``amp.init_trainer`` and ``amp.scale_loss`` around ``backward``.  A
    warm step, then 10 steps with the launch counts zeroed just before
    and read just after: losses finite and falling, K1-K3 8 launches a
    step each and no plain version.  Host ms a step in blocks of 5,
    tokens/s, torch.profiler's device busy ms, idle share and kernels a
    step by kind, the optimizer's kernels a step (fused against
    MXNET_FUSED_STEP=0), peak memory; beside them, this process's
    SPMDTrainer host ms from ``train``.  Then one step with an inf written
    into a gradient inside ``scale_loss``: the scale halves, the clean
    steps reset and every gradient is zeroed."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    t0 = time.perf_counter()
    amp.init("bfloat16")
    try:
        net = train_model(torch)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": LR})
        amp.init_trainer(trainer)
        loss_fn = SoftmaxCrossEntropyLoss()
        ids, labels = train_batch(torch)
        x, y = mx.nd.array(ids), mx.nd.array(labels)

        def step():
            return float(gluon_loop_step(mx, amp, net, loss_fn, trainer, x,
                                         y, BATCH).mean().asscalar())

        fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        w0 = time.perf_counter()
        losses = [step()]                                   # the warm step
        warm_s = time.perf_counter() - w0
        torch.cuda.reset_peak_memory_stats()
        reset_counts(*fns)
        losses += [step() for _ in range(GLUON_STEPS)]
        torch.cuda.synchronize()
        counts = {f.__name__: {"launches": f.launches,
                               "plain_calls": f.plain_calls} for f in fns}
        peak = torch.cuda.max_memory_allocated()
        for name, c in counts.items():
            if c["launches"] != LAYERS * GLUON_STEPS or c["plain_calls"]:
                raise AssertionError(
                    f"gluon_train: {name} did not run its kernel {LAYERS} "
                    f"times a step over {GLUON_STEPS} steps: {c}")
        if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"gluon_train: losses not finite and "
                                 f"falling: {losses}")
        host = host_ms_blocks({"gluon": step}, calls=5, rounds=2)["gluon"]
        prof = profiled_kinds(torch, step, 3)
        prof["device_idle_share_of_host_ms"] = (
            1 - prof["device_busy_ms"] / host["median"])
        opt = optimizer_launches(torch, mx, amp, net, loss_fn, trainer, x, y,
                                 BATCH)
        # an overflow inside scale_loss
        scaler = trainer._amp_loss_scaler
        before = (scaler.loss_scale, scaler._unskipped)

        def poison(n):
            p = n.collect_params()["blocks.0.ffn1.weight"]
            p.grad()._data.view(-1)[0] = float("inf")

        with mx.autograd.record():
            loss = loss_fn(net(x), y)
            with amp.scale_loss(loss, trainer) as s:
                s.backward()
                poison(net)
        grads_zero = all(float(p.grad()._data.abs().sum()) == 0.0
                         for p in net.collect_params().values()
                         if p._grad is not None)
        after = (scaler.loss_scale, scaler._unskipped)
        trainer.step(BATCH)
        if not (after[0] == before[0] / 2 and after[1] == 0 and grads_zero
                and before[1] > 0):
            raise AssertionError(f"gluon_train: an overflow inside "
                                 f"scale_loss left scale/clean steps "
                                 f"{before} -> {after}, gradients zeroed "
                                 f"{grads_zero}")
    finally:
        amp.reset()
    med = host["median"]
    emit({"phase": "gluon_train", "gpu": smi,
          "model": {"vocab": VOCAB, "units": DIM, "layers": LAYERS,
                    "heads": HEADS, "batch": BATCH, "seq": SEQ,
                    "tied": True, "amp": "bfloat16", "optimizer": "adam",
                    "lr": LR, "loop": "autograd.record + scale_loss + "
                    "gluon.Trainer.step"},
          "warmup_s": warm_s, "losses": losses, "host_ms": host,
          "tokens_per_s": BATCH * SEQ / (med / 1e3),
          "profile": prof, "optimizer_step": opt,
          "counts": counts, "launches_per_step": LAYERS,
          "memory_bytes": {"max_allocated_steps": peak},
          "spmd_trainer_host_ms_same_process": GLUON_SPMD_HOST,
          "overflow": {"scale_before_after": [before[0], after[0]],
                       "clean_steps_before_after": [before[1], after[1]],
                       "gradients_zeroed": grads_zero},
          "phase_s": time.perf_counter() - t0})
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_gluon_resnet(torch, smi):
    """ResNet-50 through the eager Gluon loop as
    ``examples/gluon/image_classification.py:88-117`` runs it with
    ``--dtype bfloat16``, at bench.py's _train_bench width: ResNet-50 v1,
    1000 classes, Xavier (seed 0), 224 x 224, batch 256,
    ``amp.convert_model(net, "bfloat16")`` (bf16 parameters, no f32
    masters), bf16 data, ``gluon.Trainer(..., "sgd", lr 0.05, momentum
    0.9, wd 1e-4)``.  img/s by ``marginal`` over windows of 4 and 24
    steps (each ending in one read of the last loss), losses finite and
    falling, and device ms by kind (``profiled_kinds``)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    t0 = time.perf_counter()
    net = resnet_net(torch, DEV)
    amp.convert_model(net, "bfloat16")
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(RESNET_SGD))
    loss_fn = SoftmaxCrossEntropyLoss()
    data, label = resnet_batch(torch, RESNET_BATCH)
    x, y = mx.nd.array(data.to(torch.bfloat16)), mx.nd.array(label)
    losses = []

    def one():
        return gluon_loop_step(mx, amp, net, loss_fn, trainer, x, y,
                               RESNET_BATCH, scaled=False)

    def run(n):
        for _ in range(n):
            loss = one()
        losses.append(float(loss.mean().astype("float32").asscalar()))

    w0 = time.perf_counter()
    run(1)
    warm_s = time.perf_counter() - w0
    torch.cuda.reset_peak_memory_stats()
    slope, t1, t2 = marginal(run)
    peak = torch.cuda.max_memory_allocated()
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gluon_resnet: losses not finite and falling: "
                             f"{losses}")
    prof = profiled_kinds(torch, lambda: run(1), 3)
    emit({"phase": "gluon_resnet", "gpu": smi,
          "model": {"net": "resnet50_v1", "classes": 1000,
                    "image": RESNET_IMAGE, "batch": RESNET_BATCH,
                    "params": "bfloat16 (amp.convert_model)",
                    "optimizer": "sgd", **RESNET_SGD,
                    "cudnn_benchmark": torch.backends.cudnn.benchmark},
          "warmup_s": warm_s, "img_per_s": RESNET_BATCH / slope,
          "step_ms": slope * 1e3,
          "tflop_per_s_bench_convention":
              RESNET_TRAIN_FLOPS * RESNET_BATCH / slope / 1e12,
          "window_s": {str(WINDOWS[0]): t1, str(WINDOWS[1]): t2},
          "losses_first_last": [losses[0], losses[-1]],
          "profile": prof, "memory_bytes": {"max_allocated_steps": peak},
          "phase_s": time.perf_counter() - t0})
    del trainer, net, x, y, data, label
    gc.collect()
    torch.cuda.empty_cache()


GLUON_CHECK_TOL = {"weights_rel_l2": 1e-5, "running_stats_rel_l2": 1e-4}


def on_card(torch, mx, a):
    """An NDArray on the phases' device from a numpy array."""
    return mx.nd.array(torch.as_tensor(a, device=DEV))


def _named(trainer, net):
    """index in the gluon.Trainer -> parameter name."""
    ids = {id(p): k for k, p in net.collect_params().items()}
    return {i: ids[id(p)] for i, p in enumerate(trainer._params)}


def _gluon_vs_spmd(torch, mx, failures):
    """(a) one gluon.Trainer SGD-momentum step against one fp32
    SPMDTrainer step on the ResNet-50 thumbnail, from the same weights
    and batch (TF32 off)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    rng = onp.random.RandomState(51)
    xs = rng.standard_normal((CHECK_BATCH, 3, CHECK_IMAGE, CHECK_IMAGE)
                             ).astype(onp.float32)
    ys = rng.randint(0, 10, size=(CHECK_BATCH,)).astype(onp.float32)
    gnet = resnet_net(torch, DEV, classes=10, thumbnail=True,
                      image=CHECK_IMAGE)
    snet = resnet_net(torch, DEV, classes=10, thumbnail=True,
                      image=CHECK_IMAGE)
    trainer = mx.gluon.Trainer(gnet.collect_params(), "sgd",
                               dict(RESNET_SGD))
    loss = gluon_loop_step(mx, None, gnet, SoftmaxCrossEntropyLoss(),
                           trainer, on_card(torch, mx, xs),
                           on_card(torch, mx, ys), CHECK_BATCH,
                           scaled=False)
    spmd = resnet_trainer(torch, snet)
    spmd_loss = float(spmd.step(torch.as_tensor(xs, device=DEV),
                                torch.as_tensor(ys, device=DEV)))
    gloss = float(loss.mean().asscalar())
    gp, sp = gnet.collect_params(), snet.collect_params()
    aux = [k for k in gp if k.endswith(("running_mean", "running_var"))]
    w_err = max(rel_l2(gp[k].data(), sp[k].data()) for k in gp
                if k not in aux)
    a_err = max(rel_l2(gp[k].data(), sp[k].data()) for k in aux)
    names = _named(trainer, gnet)
    m_err = max(rel_l2(st[0]._data, spmd._opt_state[names[i]][0])
                for i, st in trainer._updaters[0].states.items())
    if not w_err <= GLUON_CHECK_TOL["weights_rel_l2"]:
        failures.append(f"(a) weights gluon vs SPMD {w_err}")
    if not a_err <= GLUON_CHECK_TOL["running_stats_rel_l2"]:
        failures.append(f"(a) running statistics gluon vs SPMD {a_err}")
    if not abs(gloss - spmd_loss) <= 1e-5 * abs(spmd_loss):
        failures.append(f"(a) loss gluon {gloss} vs SPMD {spmd_loss}")
    return {"loss_gluon": gloss, "loss_spmd": spmd_loss,
            "weights_max_rel_l2": w_err, "running_stats_max_rel_l2": a_err,
            "momenta_max_rel_l2": m_err}


def _fused_vs_per_parameter(torch, mx, failures, opt, params):
    """(b) three steps of the thumbnail: trainer A takes the fused step,
    trainer B (a second net from the same weights, handed A's gradients
    each step) the per-parameter one (``MXNET_FUSED_STEP=0``): weights
    and states bitwise equal.  (c) A's states through ``save_states`` /
    ``load_states`` into a third trainer: bitwise equal."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.optimizer import fused_step
    rng = onp.random.RandomState(52)
    xs = on_card(torch, mx, rng.standard_normal(
        (CHECK_BATCH, 3, CHECK_IMAGE, CHECK_IMAGE)).astype(onp.float32))
    ys = on_card(torch, mx, rng.randint(0, 10, size=(CHECK_BATCH,)
                                        ).astype(onp.float32))
    nets = [resnet_net(torch, DEV, classes=10, thumbnail=True,
                       image=CHECK_IMAGE) for _ in range(3)]
    trainers = [mx.gluon.Trainer(n.collect_params(), opt, dict(params))
                for n in nets]
    lf = SoftmaxCrossEntropyLoss()
    fused0 = fused_step.stats()["steps"]
    for _ in range(3):
        with mx.autograd.record():
            loss = lf(nets[0](xs), ys)
        loss.backward()
        with torch.no_grad():
            for pa, pb in zip(trainers[0]._params, trainers[1]._params):
                if pa._grad is not None:           # A's gradients
                    pb._grad._data = pa._grad._data.clone()
                elif pa.grad_req == "null":        # A's running stats
                    pb._data.copy_(pa._data)
        trainers[0].step(CHECK_BATCH)
        os.environ["MXNET_FUSED_STEP"] = "0"
        try:
            trainers[1].step(CHECK_BATCH)
        finally:
            os.environ.pop("MXNET_FUSED_STEP", None)
    fused = fused_step.stats()["steps"] - fused0
    differ = [k for k, pa, pb in zip(_named(trainers[0], nets[0]).values(),
                                     trainers[0]._params,
                                     trainers[1]._params)
              if not torch.equal(pa._data, pb._data)]
    sa, sb = trainers[0]._updaters[0].states, trainers[1]._updaters[0].states
    differ += [f"state {i}.{j}" for i in sa for j in range(len(sa[i]))
               if not torch.equal(sa[i][j]._data, sb[i][j]._data)]
    if differ or fused != 3:
        failures.append(f"(b) {opt}: fused ({fused} fused steps) against "
                        f"per-parameter differ in {differ[:5]}")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        f"gluon_check_{opt}.states")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    trainers[0].save_states(path)
    trainers[2].load_states(path)
    os.remove(path)
    sc = trainers[2]._updaters[0].states
    bad = [f"{i}.{j}" for i in sa for j in range(len(sa[i]))
           if not (sa[i][j]._data.dtype == sc[i][j]._data.dtype
                   and sa[i][j]._data.device == sc[i][j]._data.device
                   and torch.equal(sa[i][j]._data, sc[i][j]._data))]
    if bad or sorted(sa) != sorted(sc):
        failures.append(f"(c) {opt}: save/load states differ in {bad[:5]}")
    return {"fused_steps": fused, "tensors_differing": len(differ),
            "states_round_trip_differing": len(bad),
            "state_tensors": sum(len(v) for v in sa.values())}


def _spmd_amp_replays(torch, mx, failures):
    """(d) SPMDTrainer under ``amp.init("bfloat16")`` on a 3-layer MLP
    (1024 -> 2048 -> 2048 -> 1000, batch 256): a captured trainer (a warm
    step, then 4 replays) against one stepping eagerly (5 steps), the
    scale set to 2**10 on the host first: losses, masters, SGD momenta,
    scale, clean steps and skipped count bitwise equal.  Then a replayed
    step with an inf in the data (no capture: the same graph): masters
    and momenta bitwise unchanged, the scale halved, one step skipped."""
    from mxnet_tpu_torch import amp, initializer
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer
    amp.init("bfloat16")
    try:
        g = torch.Generator(device=DEV).manual_seed(3)
        data = torch.randn((256, 1024), generator=g, device=DEV)
        label = torch.randint(0, 1000, (256,), generator=g, device=DEV
                              ).float()
        pair = []
        for _ in range(2):
            net = nn.HybridSequential()
            net.add(nn.Dense(2048, activation="relu"),
                    nn.Dense(2048, activation="relu"), nn.Dense(1000))
            net.initialize(init=initializer.Xavier(), device=DEV,
                           generator=torch.Generator().manual_seed(4))
            with torch.no_grad():
                net(torch.zeros((1, 1024), device=DEV))
            tr = SPMDTrainer(net, SoftmaxCrossEntropyLoss(), "sgd",
                             {"learning_rate": 0.05, "momentum": 0.9},
                             device=DEV)
            tr._amp_scaler.loss_scale = 2.0 ** 10
            pair.append(tr)
        rep, eag = pair
        losses = [[float(rep.step(data, label)) for _ in range(5)],
                  [float(eag._step_eager(data, label)) for _ in range(5)]]
        step_graph(rep)

        def state(tr):
            out = {f"{k}": p.data() for k, p in zip(tr._pkeys, tr._plist)}
            out.update({f"{k}:mom": s[0] for k, s in tr._opt_state.items()
                        if s})
            return out

        sr, se = state(rep), state(eag)
        differ = [k for k in sr if not torch.equal(sr[k], se[k])]
        amp_r = [float(t) for t in rep._amp_state]
        amp_e = [float(t) for t in eag._amp_state]
        if losses[0] != losses[1] or differ or amp_r != amp_e or \
                rep._amp_scaler.state() != eag._amp_scaler.state():
            failures.append(f"(d) replays vs eager under AMP: losses "
                            f"{losses}, differing {differ[:5]}, amp state "
                            f"{amp_r} vs {amp_e}")
        before = {k: t.clone() for k, t in sr.items()}
        scale0 = amp_r[0]
        bad = data.clone()
        bad[0, 0] = float("inf")
        compiles = rep.compiles
        rep.step(bad, label)
        changed = [k for k in before if not torch.equal(before[k], sr[k])]
        scale1, good1, skipped1 = (float(t) for t in rep._amp_state)
        if changed or scale1 != scale0 / 2 or good1 != 0.0 or \
                skipped1 != 1.0 or rep.compiles != compiles:
            failures.append(f"(d) overflowing replay: changed {changed[:5]}"
                            f", scale {scale0} -> {scale1}, clean steps "
                            f"{good1}, skipped {skipped1}, captures "
                            f"{compiles} -> {rep.compiles}")
    finally:
        amp.reset()
    return {"losses": losses[0], "tensors_compared": len(sr),
            "amp_state": amp_r, "overflow": {"scale": [scale0, scale1],
                                             "skipped": skipped1,
                                             "masters_changed":
                                                 len(changed)}}


def phase_gluon_check(torch):
    """Correctness of the eager Gluon loop on the card, fp32 with TF32
    off except (d): (a) one gluon.Trainer step against one SPMDTrainer
    step; (b) the fused update bitwise equal to the per-parameter one
    over 3 steps, SGD momentum and Adam; (c) save_states / load_states
    bitwise; (d) SPMDTrainer under the AMP policy, replays bitwise equal
    to eager steps, and an overflowing replay leaving masters and states
    unchanged."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp
    t0 = time.perf_counter()
    failures = []
    out = {"phase": "gluon_check", "tf32": False,
           "tolerance": GLUON_CHECK_TOL}
    out["a_gluon_vs_spmd"] = _gluon_vs_spmd(torch, mx, failures)
    out["b_c_sgd"] = _fused_vs_per_parameter(
        torch, mx, failures, "sgd", RESNET_SGD)
    out["b_c_adam"] = _fused_vs_per_parameter(
        torch, mx, failures, "adam", {"learning_rate": 1e-3, "wd": 1e-4})
    out["d_spmd_amp"] = _spmd_amp_replays(torch, mx, failures)
    nan = [torch.ones(4, device=DEV), torch.ones(3, device=DEV)]
    nan[1][1] = float("nan")
    out["all_finite_sees_nan"] = not bool(amp.all_finite(nan))
    if not out["all_finite_sees_nan"]:
        failures.append("amp.all_finite missed a NaN on the card")
    out.update(failures=failures, phase_s=time.perf_counter() - t0)
    emit(out)
    if failures:
        raise AssertionError(f"gluon_check: {failures}")
    gc.collect()
    torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script measures the port on a GPU", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--train-ab-child"]:
        train_ab_child(torch, os.path.abspath(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--train-ab"]:
        return train_ab([os.path.abspath(t) for t in sys.argv[2:]])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mxnet_tpu_torch.ops import attention as fa_mod
    from mxnet_tpu_torch.ops import layernorm_residual as lnr_mod
    from mxnet_tpu_torch.ops import paged_attention as pa_mod
    from mxnet_tpu_torch.ops import rope as rope_mod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_build(torch, rope_mod, pa_mod, fa_mod, lnr_mod)
    errs = phase_parity(torch, rope_mod, pa_mod)
    errs.update(phase_lnr_parity(torch, lnr_mod))
    errs.update(phase_flash_parity(torch, fa_mod))
    model, eng, prompts, outs, counts = phase_serve(torch, rope_mod, pa_mod)
    spec_eng = phase_spec(torch, rope_mod, pa_mod, model, prompts, outs)
    phase_profile(torch, eng, spec_eng, prompts, smi)
    del spec_eng                              # out of the training peak
    gc.collect()
    torch.cuda.empty_cache()
    trainer, data, label, train_counts = phase_train(torch, fa_mod, smi)
    phase_train_replay_check(torch, fa_mod)
    phase_train_variants(torch)
    phase_train_check(torch)
    nd_counts = phase_nd_path(torch, lnr_mod)
    rtc_mod, rtc_counts = phase_rtc(torch)
    errs["rtc_axpy"] = 0.0                     # bitwise, checked in phase_rtc
    kernels = phase_times(torch, rope_mod, pa_mod, eng, prompts, counts,
                          errs, smi)
    kernels += flash_times(torch, fa_mod, train_counts, errs, smi)
    kernels += nd_times(torch, lnr_mod, rtc_mod, nd_counts, rtc_counts, errs,
                        smi)
    phase_profile_train(torch, trainer, data, label, smi)
    del trainer, data, label
    gc.collect()
    torch.cuda.empty_cache()
    # cuDNN picks each convolution's algorithm by timing the candidates at
    # a shape's first call (a signature's warm step, outside any capture);
    # decided once here for the ResNet path, as bench.py's XLA autotunes
    torch.backends.cudnn.benchmark = True
    phase_resnet_check(torch)
    phase_resnet_train(torch, smi)
    phase_resnet_infer(torch, smi)
    gluon_counts = phase_gluon_train(torch, fa_mod, smi)
    for row in kernels:                  # K1-K3 on the eager Gluon path
        if row["name"] in gluon_counts:
            row["launches_gluon_train"] = \
                gluon_counts[row["name"]]["launches"]
    phase_gluon_resnet(torch, smi)
    phase_gluon_check(torch)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
