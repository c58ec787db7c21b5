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
             DecodeScheduler → ServingServer (beside a small block for
             ``/predict``); ``srv.decoder.warmup`` captures one CUDA
             graph per exec key (decode, prefill_b16 .. prefill_b128),
             then ``generate`` answers 16 overlapping requests (each
             one's TTFT from its ``serving.request`` span, tracing on)
             and 2 short ones that must equal the dense greedy
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
18. ckpt   — checkpointing at full width, the flash kernels' counts
             zeroed just before and read just after (8 launches each a
             transformer step, K1 also once a layer for each
             model-building forward; no plain call): the training row's
             SPMDTrainer A takes 3 steps, ``save_checkpoint(block=False)``
             (the snapshot: one device copy and one copy to pinned memory
             behind the step), 3 steps with the save in flight, 3 after
             it; a fresh net and trainer B (other weights) load the
             checkpoint and take 6 steps bitwise equal to A's steps 4-9
             (losses, masters, Adam's m and v); the checkpoint loaded into
             A in place leaves ``compiles`` and the graph as they were and
             A's next step equals B's first.  Host ms a synced step with a
             save in flight and without one, in blocks taken in turns;
             bytes, leaves, snapshot_ms, save_ms, write GB/s, load ms and
             the staging's device and pinned bytes.  Then the eager Gluon
             loop (amp bf16, Adam): save_parameters + save_states after 3
             steps, a fresh net and trainer load them, 3 more steps bitwise
             equal to 3 uninterrupted ones; and ResNet-50 at bench width
             (batch 256, bf16, SGD momentum, cuDNN deterministic):
             run_steps(2), a blocking save, run_steps(2), a fresh trainer
             resumed bitwise, running statistics included.  The directory
             is a temporary one, removed at the end.

19. batch_serve — batch serving of bench.py's ResNet-50 v1 (224², 1000
             classes, Xavier seed 0, fp32, TF32 off, cuDNN deterministic)
             through ``ServingServer(net, engine_args, batcher_args)``:
             ``warmup([1, 2, 4, 8, 16, 32])`` captures 6 graphs; a closed
             loop of 32 client threads x 8 synchronous ``predict`` calls
             on fixed seeded images, in turns with the same stack at
             ``max_batch_size=1``: req/s, mean occupancy, p50/p95 ms,
             dispatches, padding waste, warm-up s and pool bytes.  No
             capture and no eager batch while serving; at least 3x the
             batch-1 baseline (serving_bench's gate); one ``POST
             /predict`` equal to ``predict``; the bucket-32 rows bitwise
             equal to the eager forward of the same batch and within
             1e-4 of the largest logit of a batch-1 forward.  Then
             ``net.cast("bfloat16")`` must drop the 6 graphs, and a
             device-committed (128, 3, 224, 224) bf16 batch through a
             bf16 engine's ``infer_batch`` (bitwise equal to the eager
             forward) is timed against the eager bf16 forward.
20. lm_serve — scoring: the training row's transformer LM (vocab 32000,
             units 512, 8 layers, 8 heads, tied weights, Xavier seed 0)
             cast to bf16 behind ``ServingServer`` with int32 ids,
             ``seq_axes=(0,)``, batch buckets (1, 8), ``max_sigs`` 16;
             ``warmup`` captures the 8 (batch, seq) buckets; 24 prompts
             of 33-512 tokens (``RandomState(1)``) from 8 client
             threads.  K1 must launch 8 times a dispatch (counted on
             replays) with no plain call; no capture while serving; each
             row within 2e-2 of its largest logit from the eager forward
             of its prompt alone; the (8, 512) replay bitwise equal to
             the eager forward of its input; an id out of range fails
             its batch and the next serves.  req/s, p50/p95 ms, tokens
             scored/s.
21. input_pipeline — the data layer feeding bench.py's rows, each run
             beside the same consumer fed from resident batches: (a) the
             transformer row, 20 steps from ``NDArrayIter`` through
             ``DevicePrefetcher(trainer)``, losses bitwise equal to 20
             host-fed steps, K1-K3 8 launches a fed step, no
             ``input.step_h2d``, tokens/s fed against resident in turns,
             then ``window=4`` into ``run_steps(4, per_step_data=True)``
             with no ``input.step_h2d``; (b) the ResNet-50 row from a
             DataLoader over 2560 seeded uint8 224 x 224 images
             (ToTensor + ImageNet Normalize in min(8, cpu_count) forked
             workers, shuffle, ``last_batch="discard"``,
             ``prefetch_to_device=trainer``, cuDNN deterministic): an
             epoch fed bitwise equal to the same epoch host-fed
             (``MXNET_DEVICE_PREFETCH=0``), img/s fed, resident and
             host-fed in turns, the input wait a step, which side sets
             the pace, a batch's host parts timed apart, and
             torch.profiler traces of 3 fed steps (the host-to-device
             copies must run on a side stream and overlap the step's
             kernels: their ms, GB/s and share); (d) the captured Gluon
             step fed by a DataLoader, 11 losses bitwise equal to
             resident batches, ``compiles`` 1.  (c), ResNet-50 from a
             JPEG ``ImageRecordIter``, is left out: the card's machine
             has no libjpeg to build the native pipeline against.

22. observability — the port's own account of itself: (a) the
             training row (bf16, captured ``SPMDTrainer``), 20 steps with
             ``MXNET_TELEMETRY_JSONL``, ``MXNET_TRACE=1``,
             ``MXNET_CLUSTER_DIR`` and ``MXNET_WATCHDOG_SEC`` set beside 20
             steps from the same weights with all of them off: losses
             bitwise equal, ``compiles`` no higher, every record with the
             reference's key set, no watchdog dump, no more syncs a step
             (``torch.cuda.set_sync_debug_mode("warn")``), host ms a step
             on against off in blocks taken in turns (at most 5% more);
             (b) ``profiler.start``/``stop`` over 3 replayed steps:
             ``device_op_table`` lists K1-K3 at 24 launches each (a trace
             that lost events taken again, at most 3 times), its total
             within 10% of the device busy time ``profile_train``'s way,
             the next record's ``device_ms``, ``dumps()``'s table; a cycle
             around a capture (``trainer.predict``'s first call); (c)
             ResNet-50 fp32 behind ``ServingServer``, 8 clients x 8 calls
             under a reachable objective (no incident) and an unreachable
             one (p95 <= 1 ms: a serving incident, shown at
             ``GET /incidents``), ``GET /metrics`` parsed, its request
             count equal to ``/varz``'s, a bucket's rows bitwise equal to
             the eager forward of their batch; (d) ``tracing.export`` of
             (a) with its ``step.spmd`` spans and rank metadata, and
             clustermon's aggregator over (a)'s spool: one rank, no
             straggler.
23. distributed — SPMD distribution on the card, one rank: a process
             group of one over NCCL (``parallel._dist``), then the
             training row (bf16, Adam 3e-4, batch 8 x 2048, 8 layers)
             through ``SPMDTrainer(mesh=make_mesh({"dp": -1, "sp": 1}),
             seq_axis=1)`` with ``TransformerLM(ring_mesh=mesh,
             sp_mode="ring_flash")`` at ZeRO stages 0, 1 and 3, each
             against the unmeshed trainer from the same weights in the
             same process: a warm step and 10 replays, losses within
             rtol 1e-2 (and whether bitwise equal), K1-K3 8 launches a
             replayed step through the ring path with no plain call, host
             ms replayed meshed against unmeshed in blocks taken in turns,
             peak memory, ``opt_state.bytes_per_device``, and the NCCL
             kernels a step by torch.profiler (the port elides a
             collective over one rank, as XLA does).  First, the
             ring-flash body of a 4-rank ring folded onto the card
             (``ring_flash_fold``, the rotation a local index) at the
             training row's attention shape (64 x 2048 x 64, bf16,
             causal): 10 launches each of K1-K3 (counts zeroed just
             before), output, LSE, dQ, dK and dV against unsharded
             flash attention and the plain version at parity_flash's
             bf16 tolerance, and its device ms beside the unsharded
             kernels'.  More than one rank on the one card is not run
             (``DIST_MULTI_RANK_ON_ONE_CARD``).
24. pipeline — the pipeline schedules and Mesh4DTrainer at the training
             row's widths (bf16 compute, f32 masters), the stage hop
             folded (every stage in this process, ``fold=True``): (a)
             1F1B, the 8 blocks as 4 stages of 2, 8 microbatches of 1 x
             2048, the embedding chained in front through the input
             gradient and a row scatter, MSE against a seeded f32 target,
             held against the same blocks in sequence under autograd (loss
             rtol 1e-2, every gradient and the input gradient within
             relative L2 1e-2), a second run bitwise equal, K1-K3's
             launches against the schedule's prediction (bubble slots
             compute nothing) with no plain call; (b) GPipe (4 stages,
             M 4) and the interleaved schedule (4 stages x 2 one-block
             virtual stages, M 4), forward then autograd's backward, at
             (a)'s tolerances; (c) peak memory over base of 1F1B and
             GPipe at M 8 and 16 (1F1B grows < 10% beyond its batch's
             own bytes, GPipe >= 1.6x); (d) Mesh4DTrainer on one rank over
             NCCL (``MeshPlan()``) with the training row as its stage
             function, SGD momentum 0.9 lr 0.05 under
             ``amp.init("bfloat16")``, against SPMDTrainer: 10 replayed
             steps within rtol 1e-2 (and whether bitwise), K1-K3 8
             launches a step, ``run_steps(4)`` one compile and one
             dispatch, no comm bytes on any axis, host ms in blocks taken
             in turns, and a checkpoint round trip bitwise.
25. kvstore — the distributed stores and the row-sparse path at the
             training row's widths, one rank over NCCL
             (``kvstore.dist.init_distributed``), the eager Gluon loop
             (``MXNET_CACHED_STEP=0``): (a) ``amp.init("bfloat16")``,
             Adam 3e-4, ``gluon.Trainer(kvstore="dist_sync")`` (the
             store's ZeRO-1 Adam, ``update_on_kvstore`` by default)
             against ``kvstore="device"`` from the same weights, a warm
             step and 10 steps each taken in turns: losses within rtol
             1e-3 (and whether bitwise), K1-K3 8 launches a dist_sync
             step (counts zeroed just before each, read just after) with
             no plain call, host ms of a synced step in blocks taken in
             turns, kernels and NCCL kernels a step (torch.profiler), and
             with ``MXNET_CACHED_STEP=1`` no capture (the store declines
             it); (b) 2-bit compression (threshold 0.5,
             ``update_on_kvstore=False``), 3 steps: every reduced gradient
             bitwise equal to the quantiser's torch ops on CPU copies of
             the gradient and the residual, the packed bytes against f32;
             (c) ``p3store_dist``: every write-grad parameter pushed from
             the grad-ready hook before ``backward`` returns, losses
             bitwise equal to (b)'s store without compression; (d) fp32,
             the row untied with its ``embed`` an
             ``nn.Embedding(32000, 512, sparse_grad=True)`` holding the
             tied table (the head a copy), one ``dist_sync`` step: the
             gradient row-sparse with nnz the batch's unique ids, the
             lazy Adam's touched rows within rtol 1e-5 (atol 1e-8) of the
             dense embedding's Adam step, untouched rows bitwise unchanged, a
             second run bitwise equal, and the update's device ms (lazy
             rows) against the dense Adam of the whole table; (e)
             ``ShardedEmbedding(32000, 512)`` over 2 in-process parameter
             servers: the batch's rows pulled onto the card, (d)'s
             gradient pushed (server-side lazy SGD), host ms of each, the
             sparse wire against the dense equivalent, a repeated batch
             served from the hot-row cache, and a checkpoint saved at 2
             shards restored bitwise at 3.
26. dp_resnet — the rest of distribution, one rank over NCCL
             (``make_mesh``): (a) bench.py's headline row as bench.py
             builds it, ``SPMDTrainer(..., mesh=make_mesh({"dp": -1}),
             dtype="bfloat16")`` on ResNet-50 v1 (1000 classes, 224²,
             batch 256, SGD lr 0.05 momentum 0.9 wd 1e-4, the weights of
             ``resnet_train``'s), against the unmeshed trainer from the
             same weights, cuDNN deterministic: a warm step and 10
             replays each, losses, masters, running statistics and
             momenta bitwise equal; img/s by bench.py's slope between
             ``run_steps`` windows of 4 and 24, the two trainers' windows
             taken in turns; NCCL kernels a step (torch.profiler) and
             peak memory; (b) the cross-rank BatchNorm body folded onto
             the card, ``ops.nn.sync_batch_norm`` with
             ``FoldedReducer(4)`` over 4 shards of the 256-image batch at
             ResNet-50's stem (256, 64, 112, 112) and last stage (256,
             2048, 7, 7), fp32 and bf16: the output, both running
             statistics' updates, dx, dγ and dβ against the unsplit
             ``batch_norm`` and a plain version in f64 (fp32: relative
             L2 1e-5, TF32 off; bf16: 1e-2 against the plain version in
             f32 on the same bf16 inputs), and the device ms of forward
             and backward folded against unsplit (torch.profiler's busy
             ms and kernels a call, and CUDA events with a cold L2); (c)
             the training row on ``make_mesh({"dp": -1, "tp": 1})`` with
             the embedding spec'd ``P("dp", None)`` and the FFN weights
             ``P(("dp", "tp"), None)``, at ZeRO 0 and 3, against the
             unmeshed trainer: a warm step and 10 replays, losses
             bitwise equal, K1-K3 8 launches a replayed step (counts
             zeroed just before, read just after) with no plain call.
27. vision_zoo — the rest of bench.py's parity grids (``bench.py:81-90``)
             and the randomness of a captured step, fp32 with TF32 off
             unless named.  Weights are Xavier from ``mx.random``'s host
             generator (``mx.random.seed`` before ``initialize``), data
             and float labels made on the card from a seeded generator.
             (a) ``TRAIN_PARITY_GRID`` as ``_train_bench`` runs it:
             Inception-v3 (batch 128, 299²) and AlexNet (batch 512,
             224²), ``get_model(name, classes=1000)``, ``SPMDTrainer``
             with SGD lr 0.05 momentum 0.9 wd 1e-4 on ``make_mesh({"dp":
             -1})`` (a group of one over NCCL); img/s by the slope
             between ``run_steps`` windows of 4 and 24; losses finite
             and falling; peak memory.  (b) randomness under capture, on
             AlexNet (batch 64, 224², both Dropouts in its classifier),
             cuDNN deterministic: a warm step and 3 replays bitwise
             equal to 4 ``_step_eager`` steps from the same
             ``mx.random`` state (losses, masters, momenta); a second
             captured trainer seeded alike repeats the first bitwise; at
             lr 0 (weights still) consecutive replays, and the steps of
             a ``run_steps`` window, give distinct losses (fresh masks);
             each Dropout's kept fraction (outputs kept over inputs
             non-zero, one eager step) within 5σ of 0.5; a checkpoint
             saved after the 4 steps and loaded after a fifth repeats the
             fifth bitwise; the eager Gluon loop's whole-step capture
             (``cached_step``, 4 steps) bitwise equal to the loop under
             ``MXNET_CACHED_STEP=0``, one capture, no break.  (c)
             ``INFER_PARITY_GRID`` as ``_infer_bench`` runs it:
             resnet152_v1 (128), inceptionv3 (128, 299²), vgg16 (64) and
             alexnet (256), each in fp32 and bf16 (``net.cast``), img/s
             by the slope between windows of 4 and 24 forwards; the bf16
             logits within 2e-2 of the largest fp32 logit.  (d)
             squeezenet1_1, densenet121 and mobilenet_v2_1_0 at batch 32,
             224²: the eval forward on the card against the same net on
             the CPU in f64 (relative L2 1e-4), and one training step
             each, its loss finite.
28. export — the symbol and deployment path, fp32 with TF32 off and
             cuDNN deterministic unless named.  (a) bench.py's
             ResNet-50 v1 (Xavier seed 0) hybridized on the card at
             batches 1, 8 and 128 and exported (``HybridBlock.export``),
             then ``net.cast("bfloat16")`` and again; the same net made
             on the CPU and exported there at batch 1.  A fresh process
             (``--export-child``, started once the first export is
             written, while the others are made) loads each export on the
             card
             (``SymbolBlock.imports``; the CPU's through
             ``move_to_device_pass``), checks the loaded parameters
             bitwise against the same net made there from the seed, and
             holds the imported forward against the hybridized one:
             fp32 within rtol 1e-5 (bitwise or not, printed), bf16
             within 1e-2 of the largest logit, the CPU's export within
             1e-5 of it; img/s at 128 by the slope between windows of 2
             and 8 forwards, imported and hybridized in turns; then
             ``ServingServer.predict`` over the imported fp32 block (its
             buckets the exported batches, 32 clients x 8 calls): req/s,
             occupancy, no capture or eager batch while serving, each
             row bitwise equal to the imported forward of a padded batch
             of its bucket.  (b) bench.py's transformer LM (vocab 32000,
             units 512, 8 layers, 8 heads, bf16) exported at (1, 512)
             and (8, 512) and imported there: logits within 2e-2 of the
             hybridized forward's largest, K1 8 launches a forward of
             the imported program (counts zeroed just before, read just
             after) and no plain call.  (c) in this process, while the
             other imports: ``mx.sym.trace`` of ResNet-50 fp32, then
             ``simple_bind`` at batch 64 on the card: the eval forward
             within rtol 1e-5 of the Gluon forward, two eval replays
             bitwise equal to the eager graph, the training forward and
             backward's gradients within relative L2 1e-5 of the Gluon
             net's autograd gradients in inference mode (the traced
             BatchNorm reads the running statistics), and
             ``save_checkpoint`` → ``load_checkpoint`` → bind bitwise.
29. rnn    — the recurrent family, fp32 with TF32 off.  (a) the ``RNN``
             op's torch call (cuDNN's RNN) against its plain step loop
             (``rnn_plain``), both on the card at the LM's widths (T 24,
             N 20, H = input 1500, 2 layers): lstm, gru, rnn_tanh,
             rnn_relu, bidirectional LSTM, LSTMP (P 500), ragged
             ``use_sequence_length`` (GRU bidirectional and LSTM, rows of
             length 0 and T), ``lstm_state_clip_*`` and dropout 0.65
             (the same ``mx.random`` state: the same masks on both
             paths): outputs, states and the gradients w.r.t. data,
             states and the flat vector within ``RNN_TOL`` (1e-4 of the
             largest); cuDNN RNN kernels by name in the op's trace and
             none in the loop's; device ms of both, and of the LM's LSTM
             on the flat vector's views against ``torch.nn.LSTM`` with
             flattened weights (the compaction's cost); CTC at (T 100,
             N 32, C 5000, L 20) against ``F.ctc_loss`` on the card and
             the same recursion on the CPU (loss 1e-5, gradient 1e-3,
             ``CTC_TOL``), with both times.  (b) the word-level LM of
             ``examples/gluon/word_language_model.py`` at its upstream
             large width (vocab 33278, emsize = nhid 1500, 2 layers,
             dropout 0.65, tied) on ``synth_corpus`` at that vocabulary
             (4 bptt windows an epoch), the example's loop (batch 20,
             bptt 24, SGD lr 20 through ``gluon.Trainer``, clip 2.0,
             truncated BPTT): 20 steps on the cuDNN path and 20 on the
             plain path from the same weights and generator state,
             losses within ``LM_TOL`` and falling; tokens/s of the eager
             step and of the hybridized forward at batch 20 (one graph,
             equal to the eager forward); cuDNN's RNN kernels a step by
             name from ``profiler.device_op_table``; the whole-step
             capture's state (captures, breaks, last reason).  (c) the
             reference's parameter names and shapes (seeded numpy)
             loaded by ``convert.load_collected_params`` into the LM on
             the card and on the CPU: logits within ``RNN_TOL``.
30. numpy  — the numpy front end.  (a) ViT-B/16 (``get_vit(224, 16,
             1000, units=768, num_layers=12, num_heads=12, ffn_ratio=4)``,
             Xavier seed 0) in bf16 through ``SPMDTrainer`` (Adam, lr
             1e-4) at batch 128 on images and labels drawn by
             ``mx.np.random`` on the card: the warm step and capture,
             then 4 replayed steps with K1-K5's counts zeroed just
             before and read just after (K1-K3 12 launches a step each,
             K4 / K5 none, no plain call), img/s by the slope between ``run_steps``
             windows of 2 and 8, losses finite and falling, peak memory,
             ``cost_analysis``'s flops beside the step's matmul flops,
             ``predict`` img/s at 128 by the same slope; the fp32 check
             (TF32 off): 3 steps with ``use_flash=True`` against
             ``use_flash=False`` from one state at batch 32
             (``NP_FP32_TOL``); before it, K1-K3 at the step's
             (1536, 197, 197, 64) non-causal, at the tile the kernel
             registry resolves for it, against their plain versions in
             bf16 and fp32 (``flash_check``, the parity phase's
             tolerances).  (b) the 2.0 user loop at batch 64, fp32:
             ``npx.set_np()``, the ``mx.np`` batch, ``autograd.record()``,
             ``-np.mean(npx.pick(npx.log_softmax(net(x)), y))``,
             ``gluon.Trainer.step``: an eager warm step, then 6 steps
             under the whole-step capture (``compiles`` 1, ``hits`` 5, no
             break, no fallback, outputs ``mx.np.ndarray``, K1-K3 12
             launches a step), 3 replays bitwise equal to 3
             ``MXNET_CACHED_STEP=0`` steps from the same state (cuDNN
             deterministic), host ms a step of both.  (c) every case of
             ``tests/torch_np_sweep.py`` (the CPU parity sweep: each
             ``mx.np`` function, ``np.linalg`` on cuSOLVER, ``np.fft`` on
             cuFFT, the samplers by moments, every ``_npi_`` /
             ``_linalg_`` / ``_random_pdf_`` op) on CUDA tensors against
             the same call on CPU tensors at the case's tolerance, every
             output on the card; the count of cases and each family's
             worst error.  (d) ``npx.rope`` (K5), ``npx.paged_attention``
             (K4) and ``npx.flash_attention`` (K1): one dispatch and one
             launch a call, no plain call, bitwise equal to the direct
             call, within ``NP_KERNEL_TOL`` of the plain version;
             ``npx.masked_softmax`` and the ``interleaved_matmul_*`` ops
             on the card against the CPU.

The line before the last is ``{"kernels": [...]}`` (K1-K7; K1-K3 also
carry ``launches_gluon_train``, ``launches_ckpt``,
``launches_input_pipeline``, ``launches_observability``,
``launches_distributed``, ``launches_ring_fold``, ``launches_pipeline``,
``launches_mesh4d``, ``launches_kvstore`` and ``launches_dp_resnet``,
K1
``launches_batch_serve`` and ``launches_export``; K1-K5
``launches_numpy``); the last is
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

    python3 chip_smoke.py --export-child DIR

is phase 28's importing process (it reads the exports in DIR and
prints one JSON line).

    python3 chip_smoke.py --gluon-ab TREE [TREE ...]

does the same for what the whole-step capture costs the loops it does
not capture: each TREE in a process of its own builds K1-K3 and K6 and
prints the host ms a step (5 or 4 blocks, the modes in turns, each
block ended by a sync) of the nd path's recorded K6 step and of
``gluon_train``'s eager loop (``amp.scale_loss``, Adam), under each
setting of ``MXNET_CACHED_STEP`` and ``MXNET_FUSED_STEP`` the tree has
(see ``gluon_ab_child``).  The last line is ``{"trees": [...]}``.
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
    losses += [float(x) for x in window._data.cpu()]
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
        out.append((k, trainer._params[k]._tensor()))
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
    first = captured.predict(data)._data             # warm + capture
    replayed = captured.predict(data)._data
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
        masters = [p._tensor().cpu() for p in trainer._plist]
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
        grads = torch.autograd.grad(loss, [p._tensor()
                                           for p in params.values()])
        return float(loss.detach()), dict(zip(params, grads))

    loss_f, grads_f = loss_and_grads(flash)
    dense = train_model(torch, use_flash=False, seed=1)
    for name, p in dense.collect_params().items():
        p.set_data(flash.collect_params()[name]._tensor().detach())
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
    """``srv.decoder.warmup(PREFILL_LENGTHS)``: every exec key captured
    ahead of traffic.  Returns what it took."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    keys = srv.decoder.warmup(PREFILL_LENGTHS)
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


def decode_server(decoder):
    """A server as the reference's decode tests build one: a small block
    for ``/predict`` (``ServingServer``'s first argument) beside the
    decoder for ``/generate``."""
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.serving import ServingServer
    net = nn.Sequential()
    net.add(nn.Dense(4, in_units=8))
    net.initialize(device=DEV)
    return ServingServer(net, engine_args={"example_shape": (8,),
                                           "dtype": "float32"},
                         decoder=decoder)


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(p / 100 * (len(xs) - 1))))]


def phase_serve(torch, rope_mod, pa_mod):
    from mxnet_tpu_torch import telemetry, tracing
    from mxnet_tpu_torch.serving import (DecodeEngine, DecodeModel,
                                         DecodeScheduler)
    t0 = time.perf_counter()
    model = DecodeModel(VOCAB, dim=DIM, n_heads=HEADS, n_layers=LAYERS,
                        mlp_ratio=MLP, seed=0)
    eng = DecodeEngine(model, max_slots=SLOTS, page_size=PAGE,
                       pages_per_slot=PAGES_PER_SLOT, num_pages=NUM_PAGES)
    srv = decode_server(DecodeScheduler(eng))
    setup_s = time.perf_counter() - t0
    warm = warm_engine(torch, srv, eng)
    stats_before = eng.stats()
    rng = onp.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(0, VOCAB,
                                             size=rng.randint(32, 1001))]
               for _ in range(16)]
    short = [[int(t) for t in rng.randint(0, VOCAB, size=n)]
             for n in (48, 128)]
    steps = StepRecords()
    telemetry.add_sink(steps)
    # each request's TTFT from its serving.request span
    tracing.clear()
    tracing.enable()
    reset_counts(rope_mod.rope, pa_mod.paged_attention)
    outs, lat, wall = serve_requests(srv, prompts, 32, stagger_s=0.05)
    spans = [e for e in tracing.recent(4096)
             if e["name"] == "serving.request"]
    tracing._env_default()
    telemetry.remove_sink(steps)
    short_outs = [srv.generate(p, max_new_tokens=16, timeout_ms=120000)
                  for p in short]
    torch.cuda.synchronize()
    counts = {f.__name__: {"launches": f.launches,
                           "plain_calls": f.plain_calls}
              for f in (rope_mod.rope, pa_mod.paged_attention)}
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
    ttft = [e["args"]["ttft_ms"] for e in spans
            if e["args"].get("ttft_ms") is not None]
    if len(ttft) != len(prompts):
        raise AssertionError(f"{len(ttft)} serving.request spans with a "
                             f"TTFT for {len(prompts)} requests")
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
                                         DecodeScheduler)
    draft = DecodeModel(VOCAB, dim=256, n_heads=4, n_layers=2, seed=7)
    eng = DecodeEngine(model, draft_model=draft, spec_k=SPEC_K,
                       max_slots=SLOTS, page_size=PAGE,
                       pages_per_slot=PAGES_PER_SLOT, num_pages=NUM_PAGES)
    sch = DecodeScheduler(eng)
    srv = decode_server(sch)
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


def gluon_ab_child(torch, tree):
    """One tree of ``--gluon-ab``, in a process of its own: that tree's
    ``chip_smoke`` and ``mxnet_tpu_torch``.  Host ms a step (blocks of
    steps ended by a sync, the modes in turns, medians) of the nd path's
    recorded step (``nd_step``, K6, bf16) and of ``gluon_train``'s eager
    Gluon loop (the transformer row, ``amp.scale_loss``, Adam), under
    each setting of ``MXNET_CACHED_STEP`` and ``MXNET_FUSED_STEP`` that
    tells the whole-step capture's cost on loops it does not capture:
    the nd step with no gluon Trainer alive, and with one alive that may
    capture; the Gluon loop observed and declined every step (the fused
    step off), breaking every step until the break latch, and after it.
    Prints one JSON line."""
    import importlib.util
    sys.path.insert(0, tree)
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import attention as fa_mod
    from mxnet_tpu_torch.ops import layernorm_residual as lnr_mod
    if not os.path.abspath(fa_mod.__file__).startswith(tree):
        raise AssertionError(f"imported {fa_mod.__file__}, not {tree}")
    fa_mod.build()
    lnr_mod.build()
    capture = importlib.util.find_spec("mxnet_tpu_torch.imperative") \
        is not None
    out = {"tree": tree, "gpu": nvidia_smi(), "has_cached_step": capture}
    off = {"MXNET_CACHED_STEP": "0"}

    def with_env(env, fn):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return fn()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def blocks(modes, calls, rounds=5):
        res = {name: [] for name in modes}
        for _ in range(rounds):
            for name, (env, fn) in modes.items():
                def block():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                    return (time.perf_counter() - t0) * 1e3 / calls
                res[name].append(with_env(env, block))
        return {name: {"median": sorted(v)[len(v) // 2], "blocks": v}
                for name, v in res.items()}

    rng = onp.random.RandomState(31)
    shape = (cs.BATCH, cs.SEQ, cs.DIM)
    host = [rng.randn(*shape).astype(onp.float32),
            rng.randn(*shape).astype(onp.float32),
            (rng.rand(cs.DIM) + 0.5).astype(onp.float32),
            (rng.randn(cs.DIM) * 0.1).astype(onp.float32)]
    arrays = [mx.nd.array(h, ctx=mx.gpu(0), dtype="bfloat16") for h in host]
    for a in arrays:
        a.attach_grad()

    def nd():
        cs.nd_step(mx, arrays)

    nd()
    nd_modes = {"nd": ({}, nd)}
    if capture:
        nd_modes["nd_cached_step_off"] = (off, nd)
    out["nd_no_trainer"] = blocks(nd_modes, cs.ND_STEPS)

    amp.init("bfloat16")
    net = cs.train_model(torch)
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": cs.LR})
    amp.init_trainer(trainer)
    loss_fn = SoftmaxCrossEntropyLoss()
    ids, labels = cs.train_batch(torch)
    x, y = mx.nd.array(ids), mx.nd.array(labels)

    def step():
        cs.gluon_loop_step(mx, amp, net, loss_fn, trainer, x, y, cs.BATCH)

    unfused = {"MXNET_FUSED_STEP": "0"}
    for env in (unfused, {}):
        with_env({**env, **off}, step)                # warm
    modes = {"unfused": (unfused, step)}
    if capture:
        modes = {"unfused_observed": (unfused, step),
                 "unfused_cached_step_off": ({**unfused, **off}, step)}
    out["gluon_unfused"] = blocks(modes, 5, rounds=4)
    if capture:
        from mxnet_tpu_torch.imperative import cached_step
        out["gluon_state_after_unfused"] = cached_step.trainer_state(trainer)
        # MXNET_CACHED_STEP at its default: each deferred step breaks at
        # scale_loss's overflow read until the latch
        times = []
        for _ in range(40):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        state = cached_step.trainer_state(trainer)
        n = state["breaks"]
        out["gluon_breaking"] = {"step_ms": times, "state": state,
                                 "median_of_breaking_steps":
                                 sorted(times[1:n + 1])[n // 2]}
        modes = {"latched": ({}, step), "cached_step_off": (off, step)}
    else:
        modes = {"eager": ({}, step)}
    out["gluon"] = blocks(modes, 5, rounds=4)
    amp.reset()
    # a second trainer, which may still capture: record() is observed
    small = mx.gluon.nn.Dense(1, in_units=4)
    small.initialize(ctx=mx.gpu(0))
    keep = mx.gluon.Trainer(small.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    modes = {"nd_trainer_alive": ({}, nd)}
    if capture:
        modes["nd_trainer_alive_cached_step_off"] = (off, nd)
    out["nd_trainer_alive"] = blocks(modes, cs.ND_STEPS)
    del keep
    print(json.dumps(out), flush=True)


def gluon_ab(trees):
    """``--gluon-ab``: each tree in turn, in a process of its own; the
    last line holds every tree's line."""
    results = []
    for tree in trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--gluon-ab-child",
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
        out[k] = p._tensor()
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
                                                          n)._data.cpu())

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
    # the eager loop, as measured since it was ported: scale_loss's host
    # read would break every captured step (gluon_capture checks that)
    os.environ["MXNET_CACHED_STEP"] = "0"
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
        os.environ.pop("MXNET_CACHED_STEP", None)
    med = host["median"]
    emit({"phase": "gluon_train", "gpu": smi,
          "model": {"vocab": VOCAB, "units": DIM, "layers": LAYERS,
                    "heads": HEADS, "batch": BATCH, "seq": SEQ,
                    "tied": True, "amp": "bfloat16", "optimizer": "adam",
                    "lr": LR, "loop": "autograd.record + scale_loss + "
                    "gluon.Trainer.step", "MXNET_CACHED_STEP": "0"},
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
    # BatchNorm's running statistics need real values inside record():
    # every deferred step breaks, as in the reference, and the loop stays
    # eager (until the breaks latch capture off)
    from mxnet_tpu_torch.imperative import cached_step
    capture = cached_step.trainer_state(trainer)
    if capture["breaks"] < 1 or capture["last_reason"] != \
            "host sync on a deferred array":
        raise AssertionError(f"gluon_resnet: the BatchNorm net did not "
                             f"break its captured steps: {capture}")
    emit({"phase": "gluon_resnet", "gpu": smi,
          "cached_step": capture,
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


GLUON_CAPTURE_STEPS = 10
GLUON_REPLAY_STEPS = 5


def gluon_snapshot(trainer):
    """Copies of a Gluon trainer's weights, optimizer states and update
    counts."""
    opt = trainer._optimizer
    return ([p._data.detach().clone() for p in trainer._params],
            {i: [s._data.clone() for s in st]
             for i, st in trainer._updaters[0].states.items()},
            (dict(opt._index_update_count), opt.num_update))


def gluon_restore(torch, trainer, snap):
    """A snapshot written back in place (a captured step keeps the
    addresses it was captured on)."""
    weights, states, (counts, num_update) = snap
    with torch.no_grad():
        for p, w in zip(trainer._params, weights):
            p._data.copy_(w)
        for i, st in trainer._updaters[0].states.items():
            for s, v in zip(st, states[i]):
                s._data.copy_(v)
    trainer._optimizer._index_update_count = dict(counts)
    trainer._optimizer.num_update = num_update


def gluon_differ(torch, trainer, snap):
    """(tensors of the trainer not bitwise equal to ``snap``'s, the
    largest absolute deviation)."""
    now = gluon_snapshot(trainer)
    pairs = list(zip(now[0], snap[0])) + [
        (a, b) for i in snap[1] for a, b in zip(now[1][i], snap[1][i])]
    bad = [n for n, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
    dev = max((float((pairs[n][0].float() - pairs[n][1].float()).abs()
                     .max()) for n in bad), default=0.0)
    return bad, dev


def gluon_capture_hybridize(torch, mx, smi):
    """``HybridBlock.hybridize`` on the card: the ResNet-50 of
    ``resnet_infer`` (Xavier seed 0) cast to bf16 (``net.cast``), batch
    128, eval mode.  With cuDNN restricted to deterministic algorithms
    (as ``resnet_replay_check``), the eager forward, the capturing call
    and a replay bitwise equal, one capture for the signature.  Then,
    captured again with cuDNN's free choice, img/s hybridized against
    eager (``marginal``, windows of 4 and 24 forwards, each ending in one
    read of the summed logits), in one process."""
    from mxnet_tpu_torch import telemetry
    net = resnet_net(torch, DEV)
    net.cast("bfloat16")
    g = torch.Generator(device=DEV).manual_seed(0)
    x = mx.nd.array(torch.randn((RESNET_INFER_BATCH, 3, RESNET_IMAGE,
                                 RESNET_IMAGE), generator=g,
                                device=DEV).to(torch.bfloat16))
    compiles = telemetry.counter("compile.cached_op.count")
    torch.backends.cudnn.deterministic = True
    try:
        eager = net(x)._data.clone()
        net.hybridize()
        c0 = compiles.value
        first = net(x)._data.clone()
        second = net(x)._data.clone()
        captures = compiles.value - c0
        graph = next(iter(net._cached_graphs.values())).exe.graph
        if not (torch.equal(first, eager) and torch.equal(second, eager)) \
                or captures != 1 or graph is None or \
                len(net._cached_graphs) != 1:
            raise AssertionError(
                f"gluon_capture: the hybridized ResNet-50 forward differs "
                f"from the eager one (max |d| "
                f"{float((second.float() - eager.float()).abs().max())}) "
                f"or captured {captures} times (graph {graph is not None})")
    finally:
        torch.backends.cudnn.deterministic = False
    rows = {}
    for mode in ("hybridized", "eager"):
        net.hybridize(mode == "hybridized")

        def run(n):
            acc = torch.zeros((), device=DEV)
            for _ in range(n):
                acc += net(x)._data.float().sum()
            float(acc)

        slope, t1, t2 = marginal(run)
        rows[mode] = {"img_per_s": RESNET_INFER_BATCH / slope,
                      "forward_ms": slope * 1e3,
                      "window_s": {str(WINDOWS[0]): t1,
                                   str(WINDOWS[1]): t2}}
    out = {"net": "resnet50_v1", "batch": RESNET_INFER_BATCH,
           "image": RESNET_IMAGE, "dtype": "bfloat16 (net.cast)",
           "bitwise_equal_eager": True, "captures": captures, **rows}
    del net, x, eager, first, second
    return out


def phase_gluon_capture(torch, fa_mod, smi):
    """The whole-step capture of the eager Gluon loop at full width: the
    training row (vocab 32000, dim 512, 8 heads, 8 layers, batch 8 x
    2048, the int32 ids of ``train_batch``, Xavier seed 0) through
    ``gluon.Trainer(..., "adam", lr 3e-4)`` under ``amp.init("bfloat16")``
    WITHOUT ``scale_loss`` (the path the reference captures).

    One eager warm step, then 10 steps with the counts zeroed just before
    and read just after: the first captures (``warmup_s`` and the graph
    pool's memory), 9 replay; ``compiles`` 1, ``hits`` 9, no break, no
    fallback, ``dispatch.count`` +1 a step, K1-K3 8 launches a step each
    and no plain call, losses finite and falling.  5 replays against 5
    ``MXNET_CACHED_STEP=0`` steps from the same weights, Adam state and
    counts: losses, weights and Adam's m and v bitwise.  Host ms a step
    captured against eager in blocks taken in turns, tokens/s, the
    profiler's device busy ms, idle share and kernels a step, peak
    memory, and this process's SPMDTrainer host ms.  An overflow (an inf
    written into a weight the graph reads) skips the update in the graph
    and halves the scale, with no new compile.  The fallback matrix: a
    loss read before ``step`` breaks with the reference's reason and
    gives the eager step; ``amp.scale_loss`` inside ``record()`` breaks
    (the reference raises there) and gives the eager step.  Then
    ``hybridize`` (:func:`gluon_capture_hybridize`), and a plain Block's
    branch (:func:`gluon_capture_plain_branch`)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, telemetry
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.imperative import cached_step
    t0 = time.perf_counter()
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    dispatch = telemetry.counter("dispatch.count")
    out = {"phase": "gluon_capture", "gpu": smi,
           "model": {"vocab": VOCAB, "units": DIM, "layers": LAYERS,
                     "heads": HEADS, "batch": BATCH, "seq": SEQ,
                     "tied": True, "amp": "bfloat16", "optimizer": "adam",
                     "lr": LR, "loop": "autograd.record + backward + "
                     "gluon.Trainer.step (no scale_loss)"}}
    failures = []
    amp.init("bfloat16")
    try:
        net = train_model(torch)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": LR})
        loss_fn = SoftmaxCrossEntropyLoss()
        ids, labels = train_batch(torch)
        x, y = mx.nd.array(ids), mx.nd.array(labels)

        def step(read=True):
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(BATCH)
            return float(loss.mean().asscalar()) if read else loss

        def eager_step():
            os.environ["MXNET_CACHED_STEP"] = "0"
            try:
                return step()
            finally:
                os.environ.pop("MXNET_CACHED_STEP", None)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        w0 = time.perf_counter()
        losses = [step()]                          # the eager warm step
        reserved0 = torch.cuda.memory_reserved()
        s0 = cached_step.stats()
        reset_counts(*fns)
        per_step = []
        for _ in range(GLUON_CAPTURE_STEPS):
            d0 = dispatch.value
            loss = step(read=False)
            per_step.append(dispatch.value - d0)
            if len(per_step) == 1:                 # the capturing step
                torch.cuda.synchronize()
                warm_s = time.perf_counter() - w0
                pool = torch.cuda.memory_reserved() - reserved0
            losses.append(float(loss.mean().asscalar()))
        torch.cuda.synchronize()
        counts = {f.__name__: {"launches": f.launches,
                               "plain_calls": f.plain_calls} for f in fns}
        s1 = cached_step.stats()
        stats = {k: s1[k] - s0[k]
                 for k in ("compiles", "hits", "graph_breaks", "fallbacks")}
        peak = torch.cuda.max_memory_allocated()
        want = {"compiles": 1, "hits": GLUON_CAPTURE_STEPS - 1,
                "graph_breaks": 0, "fallbacks": 0}
        if stats != want or per_step != [1] * GLUON_CAPTURE_STEPS:
            failures.append(f"counters {stats} (want {want}), dispatches "
                            f"a step {per_step}")
        for name, c in counts.items():
            if c != {"launches": LAYERS * GLUON_CAPTURE_STEPS,
                     "plain_calls": 0}:
                failures.append(f"{name} ran {c}: want {LAYERS} launches "
                                f"a step over {GLUON_CAPTURE_STEPS} steps")
        if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
            failures.append(f"losses not finite and falling: {losses}")
        exe = next(iter(next(iter(
            trainer._cached_step_state.cache.values())).execs.values()))[0]
        if exe.graph is None:
            failures.append("the cached step holds no CUDA graph")
        out.update({"warmup_s": warm_s, "graph_pool_reserved_bytes": pool,
                    "losses": losses, "counts": counts,
                    "launches_per_step": LAYERS, "cached_step": stats,
                    "dispatches_per_step": per_step})

        # replays against MXNET_CACHED_STEP=0 steps from the same state
        snap = gluon_snapshot(trainer)
        lc = [step() for _ in range(GLUON_REPLAY_STEPS)]
        captured = gluon_snapshot(trainer)
        gluon_restore(torch, trainer, snap)
        le = [eager_step() for _ in range(GLUON_REPLAY_STEPS)]
        bad, dev = gluon_differ(torch, trainer, captured)
        if lc != le or bad:
            failures.append(f"replays differ from MXNET_CACHED_STEP=0 "
                            f"steps: losses {lc} vs {le}; {len(bad)} "
                            f"tensors, max |d| {dev}")
        out["replay_check"] = {"steps": GLUON_REPLAY_STEPS,
                               "losses_captured": lc, "losses_eager": le,
                               "tensors_compared": len(snap[0]) + sum(
                                   len(v) for v in snap[1].values()),
                               "tensors_differing": len(bad),
                               "max_abs_deviation": dev,
                               "bitwise_equal": lc == le and not bad}

        # where a captured step's host time goes: the deferred forward
        # and backward, trainer.step to the replay's launch, then the
        # wait for the card (medians of 5 steps)
        parts = {"forward_ms": [], "backward_ms": [], "step_ms": [],
                 "wait_ms": []}
        for _ in range(5):
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            with mx.autograd.record():
                loss = loss_fn(net(x), y)
            t.append(time.perf_counter())
            loss.backward()
            t.append(time.perf_counter())
            trainer.step(BATCH)
            t.append(time.perf_counter())
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            for k, a, b in zip(parts, t, t[1:]):
                parts[k].append((b - a) * 1e3)
        out["host_breakdown_ms"] = {k: sorted(v)[2]
                                    for k, v in parts.items()}

        # timing, in one process
        host = host_ms_blocks({"captured": step, "eager": eager_step},
                              calls=5, rounds=2)
        # a loop that reads the loss once every 10 steps, captured and
        # eager in turns: the host may run ahead of the card
        def window(env, n=10):
            if env is not None:
                os.environ["MXNET_CACHED_STEP"] = env
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(n):
                    loss = step(read=False)
                float(loss.mean().asscalar())
                return (time.perf_counter() - t1) * 1e3 / n
            finally:
                os.environ.pop("MXNET_CACHED_STEP", None)

        loops = {"captured": [], "eager": []}
        for _ in range(2):
            loops["captured"].append(window(None))
            loops["eager"].append(window("0"))
        out["loop_ms"] = {k: {"windows": v, "min": min(v)}
                          for k, v in loops.items()}
        out["tokens_per_s_loop"] = {k: BATCH * SEQ / (min(v) / 1e3)
                                    for k, v in loops.items()}
        prof = profiled_kinds(torch, step, 3)
        prof["device_idle_share_of_host_ms"] = (
            1 - prof["device_busy_ms"] / host["captured"]["median"])
        prof_e = profiled_kinds(torch, eager_step, 3)
        prof_e["device_idle_share_of_host_ms"] = (
            1 - prof_e["device_busy_ms"] / host["eager"]["median"])
        out.update({"host_ms": host,
                    "tokens_per_s": BATCH * SEQ / (
                        host["captured"]["median"] / 1e3),
                    "tokens_per_s_eager": BATCH * SEQ / (
                        host["eager"]["median"] / 1e3),
                    "profile": prof, "profile_eager": prof_e,
                    "memory_bytes": {"max_allocated_steps": peak},
                    "spmd_trainer_host_ms_same_process": GLUON_SPMD_HOST})

        # an overflow in the graph: an inf in a weight it reads
        scaler = trainer._amp_loss_scaler
        scaler.loss_scale = 1024.0        # a power of two: exact
        step()
        snap = gluon_snapshot(trainer)
        c0 = cached_step.stats()["compiles"]
        sk0 = telemetry.counter("amp.skipped_updates").value
        pos = net.collect_params()["pos_embed"]._data
        keep = pos[0, 0].clone()
        with torch.no_grad():
            pos[0, 0] = float("inf")
        d0 = dispatch.value
        step(read=False)
        torch.cuda.synchronize()
        with torch.no_grad():
            pos[0, 0] = keep
        overflow = {"scale_before_after": [1024.0, scaler.loss_scale],
                    "compiles": cached_step.stats()["compiles"] - c0,
                    "dispatches": dispatch.value - d0,
                    "skipped_updates": telemetry.counter(
                        "amp.skipped_updates").value - sk0,
                    "tensors_changed": len(gluon_differ(torch, trainer,
                                                        snap)[0])}
        if overflow != {"scale_before_after": [1024.0, 512.0],
                        "compiles": 0, "dispatches": 1,
                        "skipped_updates": 1, "tensors_changed": 0}:
            failures.append(f"overflow not skipped in the graph: "
                            f"{overflow}")
        out["overflow"] = overflow

        # the fallback matrix: a host read before step, scale_loss
        # (scale_loss: two steps; the first meets the plain loop's
        # structure, which has no scaling op, breaks there and arms the
        # scaled loop's; the second breaks at the overflow check's read)
        matrix = {}
        for case, n in (("loss_read_before_step", 1), ("scale_loss", 2)):
            snap = gluon_snapshot(trainer)
            b0 = cached_step.trainer_state(trainer)["breaks"]
            results = []
            for env in ("1", "0"):
                gluon_restore(torch, trainer, snap)
                os.environ["MXNET_CACHED_STEP"] = env
                try:
                    for _ in range(n):
                        with mx.autograd.record():
                            loss = loss_fn(net(x), y)
                            if case == "scale_loss":
                                with amp.scale_loss(loss, trainer) as sl:
                                    sl.backward()
                        if case == "loss_read_before_step":
                            loss.backward()
                            read = loss.asnumpy()   # a host sync
                        trainer.step(BATCH)
                finally:
                    os.environ.pop("MXNET_CACHED_STEP", None)
                if env == "1":
                    state = cached_step.trainer_state(trainer)
                    results.append(gluon_snapshot(trainer))
            bad, dev = gluon_differ(torch, trainer, results[0])
            row = {"steps": n, "breaks": state["breaks"] - b0,
                   "last_reason": state["last_reason"],
                   "tensors_differing_from_eager": len(bad),
                   "max_abs_deviation": dev}
            if row["breaks"] != n or bad or row["last_reason"] != \
                    "host sync on a deferred array":
                failures.append(f"{case}: {row}")
            matrix[case] = row
        out["fallback_matrix"] = matrix
        out["loss_read_before_step"] = float(read.mean())
    finally:
        amp.reset()
    del trainer, net, x, y
    gc.collect()
    torch.cuda.empty_cache()
    out["hybridize"] = gluon_capture_hybridize(torch, mx, smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["plain_block_branch"] = gluon_capture_plain_branch(torch, mx,
                                                           failures)
    out["failures"] = failures
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    if failures:
        raise AssertionError(f"gluon_capture: {failures}")
    return counts


def gluon_capture_plain_branch(torch, mx, failures):
    """A plain Block whose forward takes a branch on a Python attribute
    (a tanh between its two Dense layers from step 4 on), 6 SGD steps on
    the card, captured and under ``MXNET_CACHED_STEP=0``, from the same
    weights and batch.  The plain forward runs at every step, so the
    flip is a divergence from the captured tape: one break with the
    reference's reason, a second capture for the new path, and the
    eager run's weights (bitwise, else within 1e-6).  A graph that held
    the whole forward would replay the old path."""
    from mxnet_tpu_torch.imperative import cached_step
    nn = mx.gluon.nn

    class Branchy(mx.gluon.Block):
        def __init__(self):
            super().__init__()
            self.a = nn.Dense(64, in_units=64, activation="relu")
            self.act = nn.Activation("tanh")
            self.out = nn.Dense(1, in_units=64)
            self.squash = False

        def forward(self, x):
            h = self.a(x)
            if self.squash:
                h = self.act(h)
            return self.out(h)

    x = on_card(torch, mx, onp.random.RandomState(61).standard_normal(
        (32, 64)).astype(onp.float32))

    def run(env):
        os.environ["MXNET_CACHED_STEP"] = env
        try:
            net = Branchy()
            mx.random.seed(0)       # both runs start from the same weights
            net.initialize(ctx=mx.gpu(0))
            trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": 0.01},
                                       kvstore=None)
            for i in range(6):
                net.squash = i >= 3
                with mx.autograd.record():
                    y = net(x)
                    loss = (y * y).sum()
                loss.backward()
                trainer.step(32)
            torch.cuda.synchronize()
            return ({k: p.data()._data.detach().clone()
                     for k, p in net.collect_params().items()},
                    cached_step.trainer_state(trainer))
        finally:
            os.environ.pop("MXNET_CACHED_STEP", None)

    got, state = run("1")
    want, _ = run("0")
    dev = max(float((got[k] - want[k]).abs().max()) for k in got)
    row = {"steps": 6, "squash_from_step": 4, "captures": state["captures"],
           "breaks": state["breaks"], "last_reason": state["last_reason"],
           "last_capture_error": state.get("last_error"),
           "bitwise_equal_eager": all(torch.equal(got[k], want[k])
                                      for k in got),
           "max_abs_deviation": dev, "tolerance": 1e-6}
    if (row["captures"], row["breaks"], row["last_reason"]) != \
            (2, 1, "op divergence from captured tape") or dev > 1e-6:
        failures.append(f"plain Block branch: {row}")
    return row


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
    w_err = max(rel_l2(gp[k]._tensor(), sp[k]._tensor()) for k in gp
                if k not in aux)
    a_err = max(rel_l2(gp[k]._tensor(), sp[k]._tensor()) for k in aux)
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
            out = {f"{k}": p._tensor() for k, p in zip(tr._pkeys, tr._plist)}
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


CKPT_STEPS = 3             # steps before a save, in flight, and after it


def ckpt_numbers(before):
    """What the checkpoint service recorded since ``before`` (a telemetry
    snapshot): bytes written, the last save's and snapshot's ms (writer
    thread and step path), the write rate."""
    from mxnet_tpu_torch import telemetry
    now = telemetry.snapshot("checkpoint.")
    save_ms = telemetry.histogram("checkpoint.save_ms").samples()[-1]
    nbytes = now["checkpoint.bytes"] - before["checkpoint.bytes"]
    return {"bytes": nbytes,
            "saves": now["checkpoint.saves"] - before["checkpoint.saves"],
            "failures": now["checkpoint.failures"]
            - before["checkpoint.failures"],
            "snapshot_ms": telemetry.histogram(
                "checkpoint.snapshot_ms").samples()[-1],
            "save_ms": save_ms,
            "write_gb_per_s": nbytes / (save_ms / 1e3) / 1e9}


def timed_load(torch, trainer, directory):
    """``load_checkpoint`` to the end of its device work: (meta, ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = trainer.load_checkpoint(directory)
    torch.cuda.synchronize()
    return meta, (time.perf_counter() - t0) * 1e3


def phase_ckpt(torch, fa_mod, smi):
    """Checkpointing at full width (phase 18): the training row's trainer
    A takes 3 steps, saves asynchronously (``save_checkpoint(block=
    False)``), takes 3 steps while the save is in flight, waits for it
    and takes 3 more.  A fresh net and trainer B (other weights) load the
    checkpoint and take 6 steps, bitwise equal to A's steps 4-9 (losses,
    masters, Adam's m and v); the checkpoint loaded into A itself after
    its steps leaves ``compiles`` as it was, and A's next step replays
    the old graph bitwise equal to B's first.  Host ms a step with a save
    in flight and without one, in blocks taken in turns.  Then ResNet-50
    at bench width (run_steps windows of 2, save, 2 more; the running
    statistics come back bitwise) and the eager Gluon loop on the
    transformer (save_parameters + Trainer.save_states, a fresh net and
    trainer, load_parameters + load_states, 3 more steps bitwise).  The
    flash kernels' counts are zeroed just before and read just after:
    8 launches each a transformer step and no plain call."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, checkpoint, telemetry
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    out = {"phase": "ckpt", "gpu": smi}
    try:
        data, label = train_batch(torch)
        a = train_trainer(torch, train_model(torch))
        reset_counts(*fns)
        steps = inits = 0

        def model(seed):
            nonlocal inits
            inits += 1                  # its (1, 8) forward launches K1
            return train_model(torch, seed=seed)

        def step(tr):
            nonlocal steps
            steps += 1
            s0 = time.perf_counter()
            loss = float(tr.step(data, label))          # float() syncs
            return loss, (time.perf_counter() - s0) * 1e3

        losses_a = [step(a)[0] for _ in range(CKPT_STEPS)]
        before = telemetry.snapshot("checkpoint.")
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        s0 = time.perf_counter()
        job = a.save_checkpoint(os.path.join(root, "lm"), block=False)
        call_ms = (time.perf_counter() - s0) * 1e3
        staging = torch.cuda.memory_allocated() - mem0
        in_flight = []
        for _ in range(CKPT_STEPS):
            loss, ms = step(a)
            losses_a.append(loss)
            in_flight.append({"ms": ms, "save_done": job.done()})
        checkpoint.wait_pending()
        job.result()
        lm = ckpt_numbers(before)
        losses_a += [step(a)[0] for _ in range(CKPT_STEPS)]
        leaves = len(job.snapshot.leaves)
        b = train_trainer(torch, model(1))
        meta, load_ms = timed_load(torch, b, os.path.join(root, "lm"))
        losses_b = [step(b)[0] for _ in range(2 * CKPT_STEPS)]
        diff = differing(torch, state_of(a), state_of(b))
        if losses_b != losses_a[CKPT_STEPS:] or diff or \
                meta["num_update"] != CKPT_STEPS:
            raise AssertionError(f"ckpt: the resumed trainer differs: "
                                 f"losses {losses_b} vs "
                                 f"{losses_a[CKPT_STEPS:]}; state "
                                 f"{diff[:6]} ({len(diff)} tensors); meta "
                                 f"{meta}")
        compiles, graph = a.compiles, step_graph(a)
        _, load_live_ms = timed_load(torch, a, os.path.join(root, "lm"))
        again = step(a)[0]
        if a.compiles != compiles or step_graph(a) is not graph or \
                again != losses_b[0]:
            raise AssertionError(f"ckpt: a load into the live trainer "
                                 f"moved compiles {compiles} -> "
                                 f"{a.compiles} or its next loss {again} "
                                 f"!= {losses_b[0]}")
        del b
        gc.collect()
        torch.cuda.empty_cache()
        # host ms a step with a save in flight and without one, in turns
        turns = {"save_in_flight": [], "no_save": []}
        for r in range(3):
            j = a.save_checkpoint(os.path.join(root, "turns"), block=False)
            turns["save_in_flight"] += [step(a)[1] for _ in range(2)]
            j.result()
            turns["no_save"] += [step(a)[1] for _ in range(2)]
        torch.cuda.synchronize()
        reused = telemetry.histogram("checkpoint.snapshot_ms").samples()[-3:]
        out["transformer"] = {
            "model": {"vocab": VOCAB, "units": DIM, "layers": LAYERS,
                      "heads": HEADS, "batch": BATCH, "seq": SEQ,
                      "dtype": "bfloat16", "optimizer": "adam"},
            "leaves": leaves, **lm, "save_call_ms": call_ms,
            "snapshot_ms_buffers_reused": reused,
            "staging_bytes_device": staging,
            "staging_bytes_pinned_host": checkpoint.staging_bytes(),
            "load_ms": load_ms, "load_into_live_trainer_ms": load_live_ms,
            "losses_a": losses_a, "losses_b": losses_b,
            "bitwise_equal": True, "state_tensors": len(state_of(a)),
            "compiles_unchanged_after_live_load": compiles,
            "step_ms_while_saving": in_flight,
            "step_ms_in_turns": {k: {"ms": v, "median":
                                     sorted(v)[len(v) // 2]}
                                 for k, v in turns.items()}}
        del a
        gc.collect()
        torch.cuda.empty_cache()
        # the eager Gluon loop on the transformer row
        amp.init("bfloat16")
        try:
            loss_fn = SoftmaxCrossEntropyLoss()
            x, y = mx.nd.array(data), mx.nd.array(label)

            def gluon(seed):
                net = model(seed)
                tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                      {"learning_rate": LR})
                amp.init_trainer(tr)
                return net, tr

            def gstep(net, tr):
                nonlocal steps
                steps += 1
                return float(gluon_loop_step(mx, amp, net, loss_fn, tr, x, y,
                                             BATCH).mean().asscalar())

            net1, tr1 = gluon(0)
            g1 = [gstep(net1, tr1) for _ in range(CKPT_STEPS)]
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            net1.save_parameters(os.path.join(root, "gluon.params"))
            tr1.save_states(os.path.join(root, "gluon.states"))
            gsave_ms = (time.perf_counter() - s0) * 1e3
            g1 += [gstep(net1, tr1) for _ in range(CKPT_STEPS)]
            net2, tr2 = gluon(1)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            net2.load_parameters(os.path.join(root, "gluon.params"))
            tr2.load_states(os.path.join(root, "gluon.states"))
            torch.cuda.synchronize()
            gload_ms = (time.perf_counter() - s0) * 1e3
            g2 = [gstep(net2, tr2) for _ in range(CKPT_STEPS)]
            p1, p2 = net1.collect_params(), net2.collect_params()
            gdiff = [k for k in p1 if not torch.equal(p1[k]._tensor(),
                                                      p2[k]._tensor())]
            if g2 != g1[CKPT_STEPS:] or gdiff:
                raise AssertionError(f"ckpt: the resumed Gluon loop "
                                     f"differs: losses {g2} vs "
                                     f"{g1[CKPT_STEPS:]}; parameters "
                                     f"{gdiff[:6]}")
        finally:
            amp.reset()
        torch.cuda.synchronize()
        counts = {f.__name__: {"launches": f.launches,
                               "plain_calls": f.plain_calls} for f in fns}
        for f in fns:
            n = steps + (inits if f is fa_mod.flash_fwd else 0)
            if counts[f.__name__] != {"launches": LAYERS * n,
                                      "plain_calls": 0}:
                raise AssertionError(
                    f"ckpt: {f.__name__} ran {counts[f.__name__]}, "
                    f"expected {LAYERS} launches a step for {steps} steps "
                    f"(and {inits} model-building forwards for K1), no "
                    f"plain call")
        out["gluon"] = {"losses_uninterrupted": g1, "losses_resumed": g2,
                        "bitwise_equal": True, "parameters": len(p1),
                        "save_parameters_and_states_ms": gsave_ms,
                        "load_parameters_and_states_ms": gload_ms}
        del net1, tr1, net2, tr2, x, y
        gc.collect()
        torch.cuda.empty_cache()
        out["counts"] = counts
        out["transformer_steps"] = steps
        out["model_building_forwards"] = inits
        out["resnet"] = ckpt_resnet(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    return counts


def ckpt_resnet(torch, root):
    """ResNet-50 at bench width (batch 256, bf16, SGD momentum): a
    run_steps window of 2, a blocking save, a window of 2 more; a fresh
    trainer (other weights) loads the checkpoint and runs a window of 2,
    bitwise equal (losses, masters with the running statistics,
    momenta; cuDNN deterministic)."""
    from mxnet_tpu_torch import telemetry
    torch.backends.cudnn.deterministic = True
    try:
        data, label = resnet_batch(torch, RESNET_BATCH)
        r1 = resnet_trainer(torch, resnet_net(torch, DEV), dtype="bfloat16")
        first = [float(v) for v in r1.run_steps(data, label, 2)._data.cpu()]
        before = telemetry.snapshot("checkpoint.")
        path = os.path.join(root, "resnet")
        torch.cuda.synchronize()
        s0 = time.perf_counter()
        r1.save_checkpoint(path)
        block_ms = (time.perf_counter() - s0) * 1e3
        numbers = ckpt_numbers(before)
        want = [float(v) for v in r1.run_steps(data, label, 2)._data.cpu()]
        state = {k: t.clone() for k, t in resnet_state(r1).items()}
        del r1
        gc.collect()
        torch.cuda.empty_cache()
        r2 = resnet_trainer(torch, resnet_net(torch, DEV, seed=1),
                            dtype="bfloat16")
        meta, load_ms = timed_load(torch, r2, path)
        got = [float(v) for v in r2.run_steps(data, label, 2)._data.cpu()]
        now = resnet_state(r2)
        diff = [k for k in state if not torch.equal(state[k], now[k])]
        stats = [k for k in state if k.endswith(("running_mean",
                                                 "running_var"))]
        if got != want or diff or meta["num_update"] != 2:
            raise AssertionError(f"ckpt: resumed ResNet-50 differs: losses "
                                 f"{got} vs {want}; state {diff[:6]} "
                                 f"({len(diff)} tensors)")
    finally:
        torch.backends.cudnn.deterministic = False
    del r2, state, now
    gc.collect()
    torch.cuda.empty_cache()
    return {"batch": RESNET_BATCH, "dtype": "bfloat16",
            "losses_first": first, "losses_uninterrupted": want,
            "losses_resumed": got, "bitwise_equal": True,
            "running_statistics": len(stats), **numbers,
            "blocking_save_ms": block_ms, "load_ms": load_ms}

# -- batch serving (slice 13) -------------------------------------------------

SERVE_CLIENTS, SERVE_CALLS = 32, 8       # benchmark/serving_bench.py's loop
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32)
LM_REQUESTS, LM_CLIENTS, LM_BATCH = 24, 8, 8
LM_SEQ_BUCKETS = (64, 128, 256, 512)


class ServingRecords:
    """Telemetry sink keeping the batcher's step records."""

    def __init__(self):
        self.records = []

    def emit(self, record):
        if record.get("source") == "serving.DynamicBatcher":
            self.records.append(record)


def serving_counts(telemetry):
    return {k: telemetry.counter(k).value for k in (
        "compile.serving.count", "serving.eager_batches",
        "serving.capture_failures", "serving.batches", "serving.requests")}


def counts_moved(before, after):
    return {k: after[k] - before[k] for k in before}


def closed_loop(predict, inputs, clients, calls):
    """``clients`` threads, each making ``calls`` synchronous ``predict``
    calls on its own fixed input; returns (per-request latency s, wall
    s)."""
    lat, errors = [], []

    def client(c):
        for _ in range(calls):
            t0 = time.perf_counter()
            try:
                predict(inputs[c % len(inputs)])
            except Exception as e:      # re-raised on the main thread
                errors.append(e)
                return
            lat.append(time.perf_counter() - t0)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t_start
    if errors:
        raise errors[0]
    if len(lat) != clients * calls:
        raise AssertionError(f"closed loop: {len(lat)} of "
                             f"{clients * calls} requests returned")
    return lat, wall


def loop_summary(lat, wall, records):
    sizes = [r["serving"]["batch_size"] for r in records]
    padded = [r["serving"]["padded_batch"] for r in records]
    return {"requests": len(lat), "wall_s": wall,
            "req_per_s": len(lat) / wall,
            "latency_ms_p50": pct(lat, 50) * 1e3,
            "latency_ms_p95": pct(lat, 95) * 1e3,
            "dispatches": len(records),
            "mean_occupancy": sum(sizes) / max(len(sizes), 1),
            "padding_waste": 1 - sum(sizes) / max(sum(padded), 1)}


def phase_batch_serve(torch, smi):
    """Batch serving of bench.py's ResNet-50 v1 (``_infer_bench``: 224²,
    1000 classes, Xavier seed 0, fp32, TF32 off) through
    ``ServingServer(net, engine_args, batcher_args)``: ``warmup`` captures
    one CUDA graph per batch bucket (1 .. 32); a closed loop of 32 client
    threads x 8 synchronous ``predict`` calls on fixed seeded images
    (``benchmark/serving_bench.py:94-140``) against the same stack with
    ``max_batch_size=1``, in turns; one ``POST /predict``.  cuDNN is
    restricted to deterministic algorithms, so that a replay and an eager
    forward of one batch can be held bitwise.  Then ``net.cast
    ("bfloat16")`` drops the graphs, and a device-committed (128, 3,
    224, 224) bf16 batch goes through ``infer_batch`` of a bf16 engine
    again and again, img/s beside the eager bf16 forward."""
    import urllib.request
    from mxnet_tpu_torch import autograd, telemetry
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.serving import InferenceEngine, ServingServer
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        net = resnet_net(torch, DEV)
        shape = (3, RESNET_IMAGE, RESNET_IMAGE)
        srv = ServingServer(net, engine_args={"example_shape": shape,
                                              "dtype": "float32"},
                            batcher_args={"max_batch_size": 32,
                                          "max_delay_ms": 2,
                                          "queue_depth": 1024})
        eng = srv.engine
        torch.cuda.synchronize()
        alloc0, res0 = torch.cuda.memory_allocated(), \
            torch.cuda.memory_reserved()
        w0 = time.perf_counter()
        tags = srv.warmup(list(SERVE_BUCKETS))
        torch.cuda.synchronize()
        warm = {"buckets": tags, "seconds": time.perf_counter() - w0,
                "pool_allocated_bytes": torch.cuda.memory_allocated()
                - alloc0,
                "reserved_bytes": torch.cuda.memory_reserved() - res0}
        graphs = [e.exe.graph for e in eng._compiled.values()
                  if e != "eager"]
        if len(graphs) != len(SERVE_BUCKETS) or None in graphs:
            raise AssertionError(f"batch_serve: warmup left {tags} with "
                                 f"graphs {graphs}")
        images = list(onp.random.RandomState(0).randn(
            SERVE_CLIENTS, *shape).astype(onp.float32))
        base = ServingServer(eng, batcher_args={"max_batch_size": 1,
                                                "max_delay_ms": 2,
                                                "queue_depth": 1024})
        rows = {"batched": [], "batch1": []}
        c0 = serving_counts(telemetry)
        for _ in range(2):                      # in turns
            for mode, s in (("batched", srv), ("batch1", base)):
                recs = ServingRecords()
                telemetry.add_sink(recs)
                lat, wall = closed_loop(
                    lambda x, s=s: s.predict(x, timeout_ms=120000),
                    images, SERVE_CLIENTS, SERVE_CALLS)
                telemetry.remove_sink(recs)
                rows[mode].append(loop_summary(lat, wall, recs.records))
        moved = counts_moved(c0, serving_counts(telemetry))
        base.stop()
        if moved["compile.serving.count"] or \
                moved["serving.eager_batches"] or \
                moved["serving.capture_failures"]:
            raise AssertionError(f"batch_serve: traffic captured or ran "
                                 f"eagerly: {moved}")
        rate = {m: sum(r["requests"] for r in rs) / sum(r["wall_s"]
                                                       for r in rs)
                for m, rs in rows.items()}
        speedup = rate["batched"] / rate["batch1"]
        if speedup < 3.0:
            raise AssertionError(f"batch_serve: closed-loop {rate} is "
                                 f"{speedup:.2f}x the batch-1 baseline, "
                                 f"under serving_bench's 3x gate")
        # one POST /predict against predict() of the same image (both a
        # batch of one)
        host, port = srv.start_http()
        body = json.dumps({"data": images[0].tolist()}).encode()
        req = urllib.request.Request(
            f"http://{host}:{port}/predict", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            http_out = onp.asarray(json.loads(resp.read())["output"],
                                   dtype=onp.float32)
        if not onp.array_equal(http_out, srv.predict(images[0])):
            raise AssertionError("batch_serve: POST /predict differs from "
                                 "predict")
        # the bucket-32 replay against the eager forward of that batch
        results, meta = eng.infer_batch(images)
        batch = torch.from_numpy(onp.stack(images)).to(DEV)
        with autograd.pause():
            eager = net(NDArray._wrap(batch))._data.cpu().numpy()
        served = onp.stack(results)
        if not (meta["compiled"] and meta["padded"] == SERVE_CLIENTS
                and onp.array_equal(served, eager)):
            raise AssertionError(
                f"batch_serve: bucket {meta} rows differ from the eager "
                f"forward of the same batch by "
                f"{float(onp.abs(served - eager).max())}")
        one_err = {}
        for i in (0, 7, 31):
            with torch.no_grad():
                alone = net(batch[i:i + 1])[0].cpu().numpy()
            err = float(onp.abs(served[i] - alone).max())
            one_err[i] = err
            if err > 1e-4 * float(onp.abs(alone).max()):
                raise AssertionError(f"batch_serve: row {i} {err} from its "
                                     f"batch-1 eager forward")
        srv.stop()
        # bf16: the cast replaces every parameter, so the f32 graphs drop
        drops0 = telemetry.counter("serving.bucket_drops").value
        net.cast("bfloat16")
        if eng.buckets() or telemetry.counter(
                "serving.bucket_drops").value - drops0 != len(SERVE_BUCKETS):
            raise AssertionError(f"batch_serve: the f32 graphs survived "
                                 f"net.cast: {eng.buckets()}")
        del srv, base, eng, graphs
        gc.collect()
        torch.cuda.empty_cache()
        eng16 = InferenceEngine(net, example_shape=shape, dtype="bfloat16")
        g = torch.Generator(device=DEV).manual_seed(0)
        x16 = torch.randn((RESNET_INFER_BATCH, *shape), generator=g,
                          device=DEV).to(torch.bfloat16)
        first, meta16 = eng16.infer_batch(x16)
        with torch.no_grad():
            eager16 = net(x16).float().cpu().numpy()
        if not (meta16["compiled"] and meta16["device_committed"] and
                onp.array_equal(onp.stack(first), eager16)):
            raise AssertionError(f"batch_serve: the bf16 bucket {meta16} "
                                 f"differs from the eager forward")

        def served_run(n):
            for _ in range(n):
                eng16.infer_batch(x16)

        def eager_run(n):
            for _ in range(n):
                with torch.no_grad():
                    net(x16).cpu()

        c16 = serving_counts(telemetry)
        bf16 = {}
        for mode, run in (("infer_batch", served_run),
                          ("eager_forward", eager_run)):
            slope, t1, t2 = marginal(run)
            bf16[mode] = {"img_per_s": RESNET_INFER_BATCH / slope,
                          "ms": slope * 1e3}
        moved16 = counts_moved(c16, serving_counts(telemetry))
        if moved16["compile.serving.count"] or \
                moved16["serving.capture_failures"]:
            raise AssertionError(f"batch_serve: bf16 traffic captured: "
                                 f"{moved16}")
    finally:
        torch.backends.cudnn.deterministic = False
    emit({"phase": "batch_serve", "gpu": smi, "model": "resnet50_v1",
          "image": RESNET_IMAGE, "dtype": "float32", "tf32": False,
          "cudnn_deterministic": True, "clients": SERVE_CLIENTS,
          "calls_per_client": SERVE_CALLS, "warmup": warm,
          "batched": rows["batched"], "batch1": rows["batch1"],
          "req_per_s": rate, "speedup": speedup, "gate": 3.0,
          "counts_while_serving": moved,
          "http_equals_predict": True, "bucket32_bitwise_eager": True,
          "batch1_rows_max_abs_err": one_err,
          "bf16": {"batch": RESNET_INFER_BATCH, "device_committed": True,
                   "f32_graphs_dropped": len(SERVE_BUCKETS),
                   "bitwise_eager": True, **bf16},
          "phase_s": time.perf_counter() - t0})
    del net, eng16, x16
    gc.collect()
    torch.cuda.empty_cache()


def phase_lm_serve(torch, fa_mod, smi):
    """Scoring through batch serving: bench.py's transformer LM (vocab
    32000, units 512, 8 layers, 8 heads, max_len 2048, tied weights,
    Xavier seed 0) cast to bf16, served with ``example_shape=(None,)``,
    int32 ids, ``seq_axes=(0,)``, batch buckets (1, 8) and ``max_sigs``
    16; ``warmup`` captures every (batch, seq) bucket the traffic meets.
    24 requests of 33-512 tokens (``RandomState(1)``) from 8 client
    threads, ``max_batch_size`` 8.  K1 must launch 8 times a dispatch,
    on replays, with no plain call; no capture while serving; each row
    within 2e-2 of its largest logit from the eager forward of the
    request alone at its own length; a replay bitwise equal to the eager
    forward of the same padded batch; an id out of range fails its own
    batch and the next one serves."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.serving import ServingServer
    t0 = time.perf_counter()
    net = train_model(torch)
    net.cast("bfloat16")
    srv = ServingServer(net, engine_args={
        "example_shape": (None,), "dtype": "int32", "seq_axes": (0,),
        "bucket_sizes": (1, LM_BATCH), "max_sigs": 16},
        batcher_args={"max_batch_size": LM_BATCH, "max_delay_ms": 2,
                      "queue_depth": 1024})
    eng = srv.engine
    w0 = time.perf_counter()
    tags = srv.warmup([((b, s), "int32") for b in (1, LM_BATCH)
                       for s in LM_SEQ_BUCKETS])
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - w0
    rng = onp.random.RandomState(1)
    lengths = rng.randint(33, 513, size=LM_REQUESTS)
    prompts = [rng.randint(0, VOCAB, size=n).astype(onp.int32)
               for n in lengths]
    served = [None] * LM_REQUESTS
    lat = [0.0] * LM_REQUESTS
    errors = []

    def client(c):
        for i in range(c, LM_REQUESTS, LM_CLIENTS):
            s0 = time.perf_counter()
            try:
                served[i] = srv.predict(prompts[i], timeout_ms=120000)
            except Exception as e:      # re-raised on the main thread
                errors.append(e)
                return
            lat[i] = time.perf_counter() - s0

    recs = ServingRecords()
    telemetry.add_sink(recs)
    c0 = serving_counts(telemetry)
    reset_counts(fa_mod.flash_fwd)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(LM_CLIENTS)]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    k1 = {"launches": fa_mod.flash_fwd.launches,
          "plain_calls": fa_mod.flash_fwd.plain_calls}
    telemetry.remove_sink(recs)
    moved = counts_moved(c0, serving_counts(telemetry))
    if errors:
        raise errors[0]
    dispatches = len(recs.records)
    if moved["compile.serving.count"] or moved["serving.eager_batches"] \
            or moved["serving.capture_failures"] or \
            not all(r["serving"]["compiled"] for r in recs.records):
        raise AssertionError(f"lm_serve: traffic captured or ran eagerly: "
                             f"{moved}")
    if k1 != {"launches": LAYERS * dispatches, "plain_calls": 0}:
        raise AssertionError(f"lm_serve: K1 ran {k1} over {dispatches} "
                             f"dispatches, expected {LAYERS} launches "
                             f"each and no plain call")
    errs = []
    for x, row in zip(prompts, served):
        with torch.no_grad():
            alone = net(torch.as_tensor(x[None], device=DEV))[0]
        alone = alone.float().cpu().numpy()
        err = float(onp.abs(row[:len(x)] - alone).max())
        scale = float(onp.abs(alone).max())
        errs.append(err / scale)
        if not (onp.isfinite(row).all() and err <= 2e-2 * scale):
            raise AssertionError(f"lm_serve: a {len(x)}-token row is "
                                 f"{err} from its own eager forward "
                                 f"(max |ref| {scale})")
    # a replay of the (8, 512) bucket against the eager forward of its
    # static input
    from mxnet_tpu_torch.amp import policy
    entry = eng._compiled[(((LM_BATCH, 512), "int32"),
                           policy.cache_token())]
    batch = onp.zeros((LM_BATCH, 512), onp.int32)
    for j, x in enumerate([p for p in prompts if len(p) > 256][:LM_BATCH]):
        batch[j, :len(x)] = x
    with eng._lock:
        replayed = [t.clone() for t in entry.exe(batch)[0]]
        eager = entry.exe.eager()[0]
    if not all(torch.equal(a, b) for a, b in zip(replayed, eager)):
        raise AssertionError("lm_serve: the (8, 512) replay differs from "
                             "the eager forward of its input")
    bad = prompts[0].copy()
    bad[3] = VOCAB + 7
    try:
        srv.predict(bad, timeout_ms=120000)
    except MXNetError as e:
        bad_error = str(e)
    else:
        raise AssertionError("lm_serve: an id out of range was served")
    after = srv.predict(prompts[1], timeout_ms=120000)
    if after.shape != served[1].shape or not onp.isfinite(after).all():
        raise AssertionError("lm_serve: the batch after the bad id failed")
    srv.stop()
    emit({"phase": "lm_serve", "gpu": smi,
          "model": {"vocab": VOCAB, "units": DIM, "layers": LAYERS,
                    "heads": HEADS, "max_len": SEQ, "dtype": "bfloat16"},
          "buckets": tags, "warmup_s": warm_s, "requests": LM_REQUESTS,
          "clients": LM_CLIENTS, "tokens_scored": int(lengths.sum()),
          "wall_s": wall, "req_per_s": LM_REQUESTS / wall,
          "tokens_scored_per_s": float(lengths.sum()) / wall,
          "latency_ms_p50": pct(lat, 50) * 1e3,
          "latency_ms_p95": pct(lat, 95) * 1e3,
          "dispatches": dispatches,
          "mean_occupancy": LM_REQUESTS / max(dispatches, 1),
          "k1": k1, "counts_while_serving": moved,
          "rows_max_rel_err": max(errs), "replay_bitwise_eager": True,
          "bad_id_error": bad_error, "phase_s": time.perf_counter() - t0})
    del srv, eng, net, entry, served
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_fwd": k1}


# the input_pipeline phase: bench.py's rows fed from the port's data layer
INPUT_STEPS = 20                  # (a) transformer steps fed a run
INPUT_WINDOW = 4                  # (a) run_steps(per_step_data) windows
INPUT_IMAGES = 2560               # (b) the image dataset (ten batches)
INPUT_GLUON_STEPS = 10            # (d) captured Gluon steps fed
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
INPUT_SEED = 14


def input_counters(telemetry):
    return {k: telemetry.counter(k).value
            for k in ("input.h2d_bytes", "input.step_h2d", "input.wait_ms")}


def input_delta(telemetry, before):
    now = input_counters(telemetry)
    return {k: now[k] - v for k, v in before.items()}


def trace_overlap(path):
    """From a torch.profiler chrome trace: the step's stream (the one with
    the most kernel time), the host-to-device copies on other streams,
    their ms, bytes and GB/s, and the ms of those copies that overlap a
    kernel of the step's stream, with the share of the copies' ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kern, copies = {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        stream = (e.get("args") or {}).get("stream")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        if cat == "kernel":
            kern.setdefault(stream, []).append((t0, t1))
        elif "memcpy" in cat and "HtoD" in e.get("name", ""):
            copies.append((stream, t0, t1,
                           int((e.get("args") or {}).get("bytes", 0))))
    step_stream = max(kern, key=lambda s: sum(b - a for a, b in kern[s]))
    spans = sorted(kern[step_stream])
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    side = [c for c in copies if c[0] != step_stream]
    overlap = 0.0
    for _, a, b, _ in side:
        for m0, m1 in merged:
            if m1 <= a:
                continue
            if m0 >= b:
                break
            overlap += min(b, m1) - max(a, m0)
    copy_us = sum(b - a for _, a, b, _ in side)
    nbytes = sum(c[3] for c in side)
    return {"step_stream": step_stream,
            "copy_streams": sorted({c[0] for c in side}),
            "h2d_copies_on_side_streams": len(side),
            "h2d_copies_on_step_stream": len(copies) - len(side),
            "h2d_ms": copy_us / 1e3, "h2d_bytes": nbytes,
            "h2d_gb_per_s": nbytes / (copy_us * 1e3) if copy_us else None,
            "overlap_ms": overlap / 1e3,
            "overlap_share": overlap / copy_us if copy_us else None,
            "step_stream_busy_ms": sum(b - a for a, b in merged) / 1e3,
            "trace_span_ms": (max(b for _, b in merged)
                              - min(a for a, _ in merged)) / 1e3}


def input_transformer(torch, fa_mod, telemetry, failures):
    """(a) bench.py's transformer row from ``NDArrayIter`` through
    ``DevicePrefetcher(trainer)``: 20 fed steps against 20 host-fed steps
    of a trainer from the same weights (losses bitwise), K1-K3 8 launches
    a fed step with no plain call and no ``input.step_h2d``; tokens/s fed
    against resident device batches in blocks taken in turns; then
    ``window=4`` into ``run_steps(4, per_step_data=True)``."""
    from mxnet_tpu_torch import io as mio
    from mxnet_tpu_torch.data import DevicePrefetcher
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    rng = onp.random.RandomState(INPUT_SEED)
    ids = rng.randint(0, VOCAB, (INPUT_STEPS * BATCH, SEQ)).astype(onp.int32)
    labels = rng.randint(0, VOCAB, (INPUT_STEPS * BATCH, SEQ)).astype(
        onp.int32)
    host_tr = train_trainer(torch, train_model(torch))
    host = []
    c0 = input_counters(telemetry)
    for i in range(INPUT_STEPS):
        sl = slice(i * BATCH, (i + 1) * BATCH)
        host.append(float(host_tr.step(ids[sl], labels[sl])))
    host_counts = input_delta(telemetry, c0)
    del host_tr
    gc.collect()
    torch.cuda.empty_cache()
    fed_tr = train_trainer(torch, train_model(torch))
    reset_counts(*fns)
    c0 = input_counters(telemetry)
    pf = DevicePrefetcher(mio.NDArrayIter(ids, labels, BATCH), fed_tr)
    fed = []
    for batch in pf:
        x, y = batch.data[0], batch.label[0]
        if x._data.device != fed_tr.device:
            failures.append(f"transformer: a batch on {x._data.device}")
        fed.append(float(fed_tr.step(x, y)))
    torch.cuda.synchronize()
    fed_counts = input_delta(telemetry, c0)
    counts = {f.__name__: {"launches": f.launches,
                           "plain_calls": f.plain_calls} for f in fns}
    side = [s for s in pf._stager._streams.values()
            if s != torch.cuda.current_stream()]
    if fed != host:
        failures.append(f"transformer: fed losses {fed} differ from "
                        f"host-fed {host}")
    if fed_counts["input.step_h2d"] != 0:
        failures.append(f"transformer: {fed_counts} step_h2d when fed")
    if host_counts["input.step_h2d"] != 2 * INPUT_STEPS:
        failures.append(f"transformer: host-fed counters {host_counts}")
    for name, c in counts.items():
        if c != {"launches": LAYERS * INPUT_STEPS, "plain_calls": 0}:
            failures.append(f"transformer: {name} {c}, want {LAYERS} "
                            f"launches a fed step")
    if not side:
        failures.append("transformer: no side stream made the copies")
    resident = [(torch.as_tensor(ids[i * BATCH:(i + 1) * BATCH],
                                 device=DEV),
                 torch.as_tensor(labels[i * BATCH:(i + 1) * BATCH],
                                 device=DEV)) for i in range(INPUT_STEPS)]

    def run_fed():
        pf.reset()
        last = None
        for batch in pf:
            last = fed_tr.step(batch.data[0], batch.label[0])
        float(last)

    def run_resident():
        last = None
        for x, y in resident:
            last = fed_tr.step(x, y)
        float(last)

    blocks = host_ms_blocks({"fed": run_fed, "resident": run_resident},
                            calls=1, rounds=3)
    tokens = INPUT_STEPS * BATCH * SEQ
    rate = {k: tokens / (v["median"] / 1e3) for k, v in blocks.items()}
    # whole windows into run_steps(per_step_data=True)
    c0 = input_counters(telemetry)
    wpf = DevicePrefetcher(mio.NDArrayIter(ids, labels, BATCH), fed_tr,
                           window=INPUT_WINDOW)
    windows = []
    for batch in wpf:
        if tuple(batch.data[0].shape) != (INPUT_WINDOW, BATCH, SEQ):
            failures.append(f"window shape {batch.data[0].shape}")
        windows.extend(float(v) for v in fed_tr.run_steps(
            batch.data[0], batch.label[0], INPUT_WINDOW,
            per_step_data=True)._data.cpu())
    window_counts = input_delta(telemetry, c0)
    if window_counts["input.step_h2d"] != 0 or len(windows) != INPUT_STEPS:
        failures.append(f"windows: {window_counts}, {len(windows)} steps")
    if not all(onp.isfinite(fed + windows)):
        failures.append("transformer: a loss is not finite")
    if fed_tr.compiles != 1:
        failures.append(f"transformer: {fed_tr.compiles} captures")
    out = {"steps": INPUT_STEPS, "batch": BATCH, "seq": SEQ,
           "source": "NDArrayIter over host int32 ids",
           "losses_bitwise_host_fed": fed == host,
           "losses_first_last": [fed[0], fed[-1]],
           "k1_k3_launches": counts, "fed_counters": fed_counts,
           "host_fed_counters": host_counts,
           "side_streams": len(side), "block_ms": blocks,
           "tokens_per_s": rate,
           "fed_over_resident": rate["fed"] / rate["resident"],
           "window": {"n_steps": INPUT_WINDOW, "windows":
                      INPUT_STEPS // INPUT_WINDOW, "counters": window_counts,
                      "losses_first_last": [windows[0], windows[-1]]},
           "captures": fed_tr.compiles}
    pf.close()
    wpf.close()
    del fed_tr, pf, wpf, resident
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def image_dataset(mx, images, labels):
    """(b)'s dataset: HWC uint8 host images through ToTensor and the
    ImageNet Normalize, as a user's loader runs them."""
    from mxnet_tpu_torch.gluon.data import ArrayDataset
    from mxnet_tpu_torch.gluon.data.vision import transforms
    return ArrayDataset(mx.io.host_nd(images), labels).transform_first(
        transforms.Compose([transforms.ToTensor(),
                            transforms.Normalize(IMAGENET_MEAN,
                                                 IMAGENET_STD)]))


def fed_epoch(torch, trainer, loader, telemetry, seed):
    """One epoch of ``trainer.step`` over ``loader`` with numpy's
    generator seeded (the shuffle): losses, the wall s from the first
    step's start to the last loss, the input wait a step (ms), and
    the counters' deltas."""
    onp.random.seed(seed)
    losses, waits, last = [], [], None
    c0 = input_counters(telemetry)
    w0 = telemetry.counter("input.wait_ms").value
    t_first = None
    for x, y in loader:
        w1 = telemetry.counter("input.wait_ms").value
        waits.append(w1 - w0)
        if t_first is None:
            t_first = time.perf_counter()
        last = trainer.step(x, y)
        losses.append(last)
        w0 = telemetry.counter("input.wait_ms").value
    losses = [float(v) for v in losses]
    wall = time.perf_counter() - t_first
    return {"losses": losses, "wall_s": wall, "wait_ms": waits,
            "counters": input_delta(telemetry, c0)}


def host_breakdown(torch, ds, batch):
    """Host ms of one batch's parts, each alone: the 256 samples'
    transforms and the workers' batchify in this process on one torch
    thread; the shared-memory hand-off (a worker's pack, the parent's
    unpack); ``ImageRecordIter``'s NHWC -> NCHW host copy; the
    prefetcher's copy into a pinned slot and the copy to the card
    (synced)."""
    from mxnet_tpu_torch.data.device_pipeline import _Stager
    from mxnet_tpu_torch.gluon.data import dataloader as dl
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        host = dl.default_mp_batchify_fn(
            [ds[i] for i in range(RESNET_BATCH)])
        t1 = time.perf_counter()
    finally:
        torch.set_num_threads(threads)
    packed = dl._shm_pack(host)
    t2 = time.perf_counter()
    dl._shm_unpack(packed)
    t3 = time.perf_counter()
    # ImageRecordIter's NHWC -> NCHW host copy of a batch (its native
    # pipeline fills NHWC float32): numpy alone, as io/native.py runs it
    nhwc = onp.ones((RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3),
                    onp.float32)
    t4 = time.perf_counter()
    onp.ascontiguousarray(onp.transpose(nhwc, (0, 3, 1, 2)))
    t5 = time.perf_counter()
    out = {"transforms_and_batchify_1_thread": (t1 - t0) * 1e3,
           "shm_pack": (t2 - t1) * 1e3, "shm_unpack": (t3 - t2) * 1e3,
           "nhwc_to_nchw_host_copy": (t5 - t4) * 1e3,
           "batch_bytes": batch._data.nbytes}
    if DEV == "cuda":
        stager = _Stager(2)
        t = batch._data
        work = [(t, torch.device(DEV), False)]
        stager.stage(work)                   # the slot's allocation
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        slot = stager._slot(torch.device(DEV), [t])
        slot[0][0].copy_(t)
        t5 = time.perf_counter()
        stager.stage(work)
        torch.cuda.synchronize()
        t6 = time.perf_counter()
        out.update(pinned_slot_copy=(t5 - t4) * 1e3,
                   stage_synced=(t6 - t5) * 1e3)
    return out


def profile_fed(torch, trainer, source):
    """torch.profiler over 3 steps fed by ``DevicePrefetcher(source,
    trainer)`` after 3 that fill its ring: ``trace_overlap`` of the
    trace, the profiled host ms, and the device's idle share (1 - the
    step stream's busy ms over them)."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.data import DevicePrefetcher
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "input_pipeline_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    pf = DevicePrefetcher(source, trainer)
    it = iter(pf)
    for _ in range(3):
        x, y = next(it)
        float(trainer.step(x, y))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            x, y = next(it)
            last = trainer.step(x, y)
        float(last)
        wall = (time.perf_counter() - t0) * 1e3
    pf.close()
    prof.export_chrome_trace(trace)
    ov = trace_overlap(trace)
    os.remove(trace)
    ov["profiled_wall_ms"] = wall
    ov["device_idle_share"] = 1 - ov["step_stream_busy_ms"] / wall
    return ov


def input_resnet(torch, mx, telemetry, smi, failures):
    """(b) bench.py's ResNet-50 row (224 x 224, bf16, batch 256, SGD
    momentum 0.9, wd 1e-4) fed from ``gluon.data``: 2560 seeded uint8
    images (385 MB on the host) through ToTensor + Normalize in
    ``min(8, cpu_count)`` forked workers (shared memory), ``shuffle``,
    ``last_batch="discard"``, ``prefetch_to_device=trainer``.  An epoch
    fed through the prefetcher against the same epoch host-fed
    (``MXNET_DEVICE_PREFETCH=0``) from the same state: losses bitwise
    (cuDNN deterministic).  Then in turns: fed, resident (one batch on
    the card, 10 steps) and host-fed epochs; img/s, input wait a step,
    and a torch.profiler trace of 3 fed steps (the copies' streams,
    GB/s and overlap with the step's kernels, the device's idle
    share)."""
    from mxnet_tpu_torch.gluon.data import DataLoader
    workers = min(8, os.cpu_count() or 1)
    g0 = time.perf_counter()
    rng = onp.random.RandomState(INPUT_SEED)
    images = rng.randint(0, 256, (INPUT_IMAGES, RESNET_IMAGE, RESNET_IMAGE,
                                  3), dtype=onp.uint8)
    labels = rng.randint(0, 1000, INPUT_IMAGES).astype(onp.float32)
    make_s = time.perf_counter() - g0
    ds = image_dataset(mx, images, labels)
    steps = INPUT_IMAGES // RESNET_BATCH
    torch.backends.cudnn.deterministic = True
    try:
        trainer = resnet_trainer(torch, resnet_net(torch, DEV),
                                 dtype="bfloat16")
        warm_x, warm_y = resnet_batch(torch, RESNET_BATCH)
        w0 = time.perf_counter()
        float(trainer.step(warm_x, warm_y))        # the capture
        warm_s = time.perf_counter() - w0
        loader = DataLoader(ds, batch_size=RESNET_BATCH, shuffle=True,
                            num_workers=workers, last_batch="discard",
                            prefetch_to_device=trainer, timeout=600)
        state = {k: t.detach().clone()
                 for k, t in resnet_state(trainer).items()}
        n0 = trainer.num_update
        fed = fed_epoch(torch, trainer, loader, telemetry, INPUT_SEED)
        after = resnet_state(trainer)
        with torch.no_grad():
            for k, t in state.items():
                after[k].copy_(t)
        trainer.num_update = trainer.optimizer.num_update = n0
        os.environ["MXNET_DEVICE_PREFETCH"] = "0"
        try:
            host = fed_epoch(torch, trainer, loader, telemetry, INPUT_SEED)
        finally:
            os.environ.pop("MXNET_DEVICE_PREFETCH")
        if fed["losses"] != host["losses"]:
            failures.append(f"resnet: fed losses {fed['losses']} differ "
                            f"from host-fed {host['losses']}")
        if fed["counters"]["input.step_h2d"] != 0 or \
                host["counters"]["input.step_h2d"] != 2 * steps:
            failures.append(f"resnet: counters fed {fed['counters']} host "
                            f"{host['counters']}")
        if len(fed["losses"]) != steps or not all(
                onp.isfinite(fed["losses"])):
            failures.append(f"resnet: losses {fed['losses']}")

        def resident():
            t0 = time.perf_counter()
            last = None
            for _ in range(steps):
                last = trainer.step(warm_x, warm_y)
            float(last)
            return {"wall_s": time.perf_counter() - t0}

        def host_fed():
            os.environ["MXNET_DEVICE_PREFETCH"] = "0"
            try:
                return fed_epoch(torch, trainer, loader, telemetry, 1)
            finally:
                os.environ.pop("MXNET_DEVICE_PREFETCH")

        modes = {"fed": lambda: fed_epoch(torch, trainer, loader, telemetry,
                                          1),
                 "resident": resident, "host_fed": host_fed}
        runs = {k: [] for k in modes}
        for _ in range(2):
            for k, fn in modes.items():
                runs[k].append(fn())
        img_s = {k: [steps * RESNET_BATCH / r["wall_s"] for r in v]
                 for k, v in runs.items()}
        waits = [w for r in runs["fed"] for w in r["wait_ms"][1:]]
        host_waits = [w for r in runs["host_fed"] for w in r["wait_ms"][1:]]
        # torch.profiler over 3 fed steps: from the loader, and from a
        # prefetcher over host batches already made (a source faster
        # than the step, so the ring is full and each copy runs beside
        # the step before it)
        ov = profile_fed(torch, trainer, loader)
        os.environ["MXNET_DEVICE_PREFETCH"] = "0"
        try:
            made = []
            for x, y in loader:
                made.append((x, y))
                if len(made) == 6:
                    break
        finally:
            os.environ.pop("MXNET_DEVICE_PREFETCH")
        # twice over: the producer runs ahead of the ring, so the profiled
        # steps' copies are those of later items
        ov_made = profile_fed(torch, trainer, made * 2)
        breakdown = host_breakdown(torch, ds, made[0][0])
        del made
        if not ov_made["h2d_copies_on_side_streams"] or \
                not ov_made["overlap_ms"] > 0:
            failures.append(f"resnet: host-to-device copies did not overlap "
                            f"the step on a side stream: {ov_made}")
        fed_rate = sorted(img_s["fed"])[-1]
        res_rate = sorted(img_s["resident"])[-1]
        out = {"images": INPUT_IMAGES, "image_shape": [RESNET_IMAGE,
                                                       RESNET_IMAGE, 3],
               "host_dataset_bytes": images.nbytes, "make_data_s": make_s,
               "workers": workers, "cpu_count": os.cpu_count(),
               "batch": RESNET_BATCH, "steps_an_epoch": steps,
               "transforms": "ToTensor, Normalize(ImageNet mean/std)",
               "cudnn_deterministic": True, "warmup_s": warm_s,
               "losses_bitwise_host_fed": fed["losses"] == host["losses"],
               "losses_first_last": [fed["losses"][0], fed["losses"][-1]],
               "fed_counters": fed["counters"],
               "host_fed_counters": host["counters"],
               "img_per_s": img_s,
               "fed_over_resident": fed_rate / res_rate,
               "input_wait_ms_a_step": {"p50": pct(waits, 50),
                                        "p95": pct(waits, 95),
                                        "max": max(waits)},
               "host_fed_input_wait_ms_a_step": {
                   "p50": pct(host_waits, 50), "p95": pct(host_waits, 95)},
               "host_breakdown_ms_a_batch": breakdown,
               "profile_3_steps_loader": ov,
               "profile_3_steps_made_batches": ov_made,
               "pace_set_by": ("device" if fed_rate >= 0.95 * res_rate
                               else "input")}
    finally:
        torch.backends.cudnn.deterministic = False
    del trainer, loader, ds, images, warm_x, warm_y, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def input_gluon_capture(torch, mx, failures):
    """(d) the captured Gluon transformer step (``amp.init("bfloat16")``,
    Adam, no ``scale_loss``) fed from ``DataLoader(prefetch_to_device=
    trainer)``: 1 + 10 steps against 1 + 10 steps on resident batches
    from the same weights; losses bitwise and ``compiles`` 1 each."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.imperative import cached_step
    n = INPUT_GLUON_STEPS + 1
    rng = onp.random.RandomState(INPUT_SEED + 1)
    ids = rng.randint(0, VOCAB, (n * BATCH, SEQ)).astype(onp.int32)
    labels = rng.randint(0, VOCAB, (n * BATCH, SEQ)).astype(onp.int32)
    results = {}
    amp.init("bfloat16")
    try:
        for mode in ("resident", "fed"):
            net = train_model(torch)
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": LR})
            loss_fn = SoftmaxCrossEntropyLoss()
            if mode == "fed":
                batches = DataLoader(ArrayDataset(ids, labels),
                                     batch_size=BATCH,
                                     prefetch_to_device=trainer, timeout=600)
            else:
                batches = [(mx.nd.array(ids[i * BATCH:(i + 1) * BATCH],
                                        dtype="int32"),
                            mx.nd.array(labels[i * BATCH:(i + 1) * BATCH],
                                        dtype="int32")) for i in range(n)]
            s0 = cached_step.stats()
            losses = []
            for x, y in batches:
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                trainer.step(BATCH)
                # read after step (a read before it breaks the capture),
                # and keep no loss alive: its graph would hold the
                # gradient accumulators across steps
                losses.append(float(loss.mean().asscalar()))
                del loss
            s1 = cached_step.stats()
            state = cached_step.trainer_state(trainer)
            results[mode] = {"losses": losses,
                             "compiles": s1["compiles"] - s0["compiles"],
                             "hits": s1["hits"] - s0["hits"],
                             "breaks": state["breaks"],
                             "last_reason": state["last_reason"]}
            del net, trainer, batches
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        amp.reset()
    fed, res = results["fed"], results["resident"]
    if fed["losses"] != res["losses"] or fed["compiles"] != 1 or \
            res["compiles"] != 1 or fed["hits"] != n - 2 or \
            res["hits"] != n - 2:
        failures.append(f"gluon capture fed {fed} resident {res}")
    return {"steps": n, "losses_bitwise_resident": fed["losses"] ==
            res["losses"],
            "counters": {mode: {k: v for k, v in r.items() if k != "losses"}
                         for mode, r in results.items()},
            "losses_first_last": [fed["losses"][0], fed["losses"][-1]]}


def phase_input_pipeline(torch, fa_mod, smi):
    """Phase 21: the input pipeline at bench.py's widths — (a) the
    transformer row through ``NDArrayIter`` and ``DevicePrefetcher``,
    (b) the ResNet-50 row through ``gluon.data``'s DataLoader with
    ``prefetch_to_device``, (d) the captured Gluon step fed by a
    DataLoader.  (c), ``ImageRecordIter``, is left out: the card's
    machine has no libjpeg to build the native pipeline against."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import telemetry
    t0 = time.perf_counter()
    failures = []
    out = {"phase": "input_pipeline", "gpu": smi,
           "cpu_count": os.cpu_count()}
    out["transformer"], counts = input_transformer(torch, fa_mod, telemetry,
                                                   failures)
    out["resnet"] = input_resnet(torch, mx, telemetry, smi, failures)
    out["gluon_capture"] = input_gluon_capture(torch, mx, failures)
    out["failures"] = failures
    out["phase_s"] = time.perf_counter() - t0
    emit(out)
    if failures:
        raise AssertionError(f"input_pipeline: {failures}")
    return counts


# the observability phase
OBS_STEPS = 20                    # (a) steps with everything on, and off
OBS_PROFILED = 3                  # (b) replayed steps in a profiler cycle
OBS_CLIENTS, OBS_CALLS = 8, 8     # (c) closed-loop serving
OBS_BUCKETS = (1, 2, 4, 8)
# the reference's step record (mxnet_tpu/telemetry.py:845-1023), key by
# key; ``amp``, ``moe`` and ``serving_slo`` join it only when active
OBS_RECORD_KEYS = {
    "step": None, "ts": None, "source": None, "rank": None, "world": None,
    "host_ms": None, "device_ms": None, "compiles": None,
    "compile_ms": None, "collective_bytes": None,
    "collective_split": {"reduce_scatter": None, "all_gather": None,
                         "allreduce": None,
                         "by_axis": {a: None for a in
                                     ("dp", "tp", "pp", "sp", "ep")}},
    "opt_state_bytes": None, "device_mem": None, "dispatches": None,
    "input_wait_ms": None, "h2d_bytes": None,
    "cached_step": {k: None for k in ("hits", "compiles", "fallbacks",
                                      "graph_breaks")},
    "checkpoint": {k: None for k in ("saves", "failures", "bytes",
                                     "gc_removed", "verify_passes",
                                     "verify_failures",
                                     "barrier_wait_ms")},
    "kernel": {k: None for k in ("cache_hits", "cache_misses", "tune_ms",
                                 "tune_measurements", "fallbacks")},
    "artifact": {k: None for k in ("hits", "misses", "saves", "bytes",
                                   "load_ms", "deserialize_failures")},
    "embedding": {k: None for k in ("rows_pulled", "rows_pushed",
                                    "sparse_bytes", "dense_equiv_bytes",
                                    "cache_hits", "cache_misses",
                                    "cache_evictions", "rows_spilled")},
    "critical_path": {k: None for k in ("input_wait", "h2d", "compile",
                                        "collective", "optimizer",
                                        "checkpoint", "compute")}}
OBS_DEVICE_MEM_KEYS = {"device", "bytes_in_use", "peak_bytes_in_use",
                       "bytes_limit"}
OBS_FLASH = ("fa_fwd", "fa_bwd_dkdv", "fa_bwd_dq")


def key_mismatch(rec, want, path=""):
    """The first place where ``rec``'s keys differ from ``want``'s
    (nested dicts compared key by key), or None."""
    if set(rec) != set(want):
        return (path or "record", sorted(set(rec) ^ set(want)))
    for k, sub in want.items():
        if sub is not None:
            bad = key_mismatch(rec[k], sub, f"{path}{k}.")
            if bad:
                return bad
    return None


def obs_env(on, root):
    """Every observability switch on (the JSONL sink, tracing, the
    cluster spool with rank 0's aggregator, the stall watchdog), or all
    of them off."""
    from mxnet_tpu_torch import tracing
    switches = {"MXNET_TELEMETRY_JSONL": os.path.join(root, "steps.jsonl"),
                "MXNET_TRACE": "1",
                "MXNET_CLUSTER_DIR": os.path.join(root, "cluster"),
                "MXNET_WATCHDOG_SEC": "10"}
    for k, v in switches.items():
        if on:
            os.environ[k] = v
        else:
            os.environ.pop(k, None)
    if not on:
        tracing.stop_watchdog()


def sync_count(torch, fn, n):
    """Synchronizing CUDA calls ``torch.cuda.set_sync_debug_mode("warn")``
    reports over ``n`` calls of ``fn``."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message).lower() for w in caught)


def flash_rows(table):
    """Launches and device us of K1-K3 in a device-op table, by the
    kernels' name stems."""
    return {stem: {"launches": sum(r["count"] for n, r in table.items()
                                   if stem in n),
                   "total_us": sum(r["total_us"] for n, r in table.items()
                                   if stem in n)}
            for stem in OBS_FLASH}


def obs_training(torch, fa_mod, root, failures):
    """(a): the same 20 steps with every switch on and with all off."""
    from mxnet_tpu_torch import telemetry, tracing
    data, label = train_batch(torch)
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    runs, trainers = {}, {}
    for mode in ("off", "on"):
        obs_env(mode == "on", root)
        dumps0 = telemetry.counter("watchdog.stall_dumps").value
        trainer = train_trainer(torch, train_model(torch))
        losses = [trainer.step(data, label)]      # the warm step + capture
        reset_counts(*fns)
        for _ in range(OBS_STEPS - 1):
            losses.append(trainer.step(data, label))
        torch.cuda.synchronize()
        runs[mode] = {
            "losses": [float(x) for x in losses],
            "compiles": trainer.compiles,
            "counts": {f.__name__: {"launches": f.launches,
                                    "plain_calls": f.plain_calls}
                       for f in fns},
            "watchdog_dumps": telemetry.counter(
                "watchdog.stall_dumps").value - dumps0}
        trainers[mode] = trainer
    on, off = runs["on"], runs["off"]
    if on["losses"] != off["losses"]:
        failures.append(f"(a) losses differ on/off: {on['losses']} "
                        f"{off['losses']}")
    if on["compiles"] > off["compiles"]:
        failures.append(f"(a) compiles {on['compiles']} on against "
                        f"{off['compiles']} off")
    for name, c in on["counts"].items():
        if c["launches"] != LAYERS * (OBS_STEPS - 1) or c["plain_calls"]:
            failures.append(f"(a) {name} {c} over {OBS_STEPS - 1} replays")
    if on["watchdog_dumps"]:
        failures.append(f"(a) {on['watchdog_dumps']} watchdog dumps")
    with open(os.path.join(root, "steps.jsonl")) as f:
        records = [json.loads(ln) for ln in f if ln.strip()]
    bad = [(r["step"], key_mismatch(r, OBS_RECORD_KEYS)) for r in records
           if key_mismatch(r, OBS_RECORD_KEYS)]
    bad += [(r["step"], "device_mem") for r in records
            if not r["device_mem"] or any(set(d) != OBS_DEVICE_MEM_KEYS
                                          for d in r["device_mem"])]
    if len(records) != OBS_STEPS or bad:
        failures.append(f"(a) {len(records)} records; key mismatches "
                        f"{bad[:3]}")
    # synchronizing calls over 5 replayed steps in each mode
    syncs = {}
    for mode in ("off", "on"):
        obs_env(mode == "on", root + "/sync")
        tr = trainers[mode]
        syncs[mode] = sync_count(torch, lambda: tr.step(data, label), 5)
    if syncs["on"] > syncs["off"]:
        failures.append(f"(a) syncs over 5 steps: {syncs}")
    # host ms a step (each ended by float(loss)) in blocks of 10 taken in
    # turns, the switches flipped between blocks (a spool of its own)
    blocks = {"off": [], "on": []}
    for _ in range(3):
        for mode in ("off", "on"):
            obs_env(mode == "on", root + "/blocks")
            tr = trainers[mode]
            float(tr.step(data, label))
            t0 = time.perf_counter()
            for _ in range(10):
                float(tr.step(data, label))
            blocks[mode].append((time.perf_counter() - t0) * 1e2)
    med = {m: sorted(b)[len(b) // 2] for m, b in blocks.items()}
    overhead = med["on"] / med["off"] - 1
    if overhead > 0.05:
        failures.append(f"(a) host ms a step {med}: {overhead:.2%} over")
    obs_env(False, root)
    cp = [r["critical_path"] for r in records[1:]]
    out = {"steps": OBS_STEPS, "losses_bitwise_equal":
           on["losses"] == off["losses"], "losses": on["losses"],
           "compiles": {"on": on["compiles"], "off": off["compiles"]},
           "counts": on["counts"], "records": len(records),
           "watchdog_dumps": on["watchdog_dumps"],
           "syncs_over_5_steps": syncs,
           "host_ms_blocks": blocks, "host_ms_median": med,
           "host_overhead": overhead,
           "record_host_ms": [r["host_ms"] for r in records],
           "record_dispatches": [r["dispatches"] for r in records],
           "record_compiles": [r["compiles"] for r in records],
           "record_device_mem": records[-1]["device_mem"],
           "critical_path_mean_ms": {
               k: sum(c[k] for c in cp) / len(cp) for k in cp[0]},
           "spans": tracing.span_count()}
    return out, trainers["on"], (data, label)


def obs_profiler(torch, trainer, batch, root, failures):
    """(b): a profiler cycle over 3 replayed steps, and one around a
    capture."""
    from mxnet_tpu_torch import kineto, profiler, telemetry
    data, label = batch
    obs_env(True, root + "/profiled")
    profiler.set_config(filename=os.path.join(root, "profile.json"))
    step = lambda: float(trainer.step(data, label))  # noqa: E731
    step()
    for attempt in range(1, 4):
        profiler.start()
        for _ in range(OBS_PROFILED):
            step()
        profiler.stop()
        table = profiler.device_op_table()
        flash = flash_rows(table)
        if all(r["launches"] == LAYERS * OBS_PROFILED
               for r in flash.values()):
            break
    step()                        # the record after the cycle
    device_ms = telemetry.last_record()["device_ms"]
    total_ms = kineto.device_total_ms(profiler.trace_dir())
    obs_env(False, root)
    if not table:
        failures.append("(b) the profiler cycle recorded no device event")
        return {"device_events": 0}
    if any(r["launches"] != LAYERS * OBS_PROFILED for r in flash.values()):
        failures.append(f"(b) K1-K3 launches in {attempt} cycles: {flash}")
    # the device busy ms a step the profile_train way (key_averages of a
    # torch.profiler run over the same 3 steps)
    _, busy, _ = profiled(torch, step, OBS_PROFILED)
    per_step = total_ms / OBS_PROFILED
    if abs(per_step - busy) > 0.1 * busy:
        failures.append(f"(b) device_total_ms a step {per_step} against "
                        f"busy {busy}")
    if device_ms is None or abs(device_ms - per_step) > 1e-6 * per_step:
        failures.append(f"(b) the next record's device_ms {device_ms}, "
                        f"the cycle's {per_step} a step")
    text = profiler.dumps()
    if "Device op statistics" not in text:
        failures.append("(b) dumps() has no device-op table")
    # a cycle around a capture: predict's first call captures its graph
    # with the session closed around it
    x = data[:2]
    profiler.start()
    pred = trainer.predict(x)._data.float().cpu()
    pred2 = trainer.predict(x)._data.float().cpu()
    profiler.stop()
    segments = kineto.cycle_files(profiler.trace_dir())
    eager = trainer._predict_eager(x).float().cpu()
    capture_ok = (len(segments) == 2 and bool(profiler.device_op_table())
                  and torch.equal(pred, eager) and torch.equal(pred2, eager))
    if not capture_ok:
        failures.append(f"(b) cycle around a capture: {len(segments)} "
                        f"segments, replays bitwise {torch.equal(pred, eager)}"
                        f" {torch.equal(pred2, eager)}")
    print(text.split("Trace spans")[0].rstrip())
    top = sorted(table.items(), key=lambda kv: -kv[1]["total_us"])[:8]
    return {"cycles": attempt, "flash": flash,
            "device_total_ms_per_step": per_step,
            "busy_ms_per_step_profile_train_way": busy,
            "record_device_ms": device_ms,
            "device_events": sum(r["count"] for r in table.values()),
            "kernel_names": len(table),
            "top": [{"name": n[:90], **r} for n, r in top],
            "capture_cycle_segments": len(segments),
            "capture_cycle_replays_bitwise_eager": capture_ok}


def obs_serving(torch, root, failures):
    """(c): ResNet-50 fp32 behind ServingServer under a reachable and an
    unreachable objective."""
    import urllib.request
    from mxnet_tpu_torch import autograd, clustermon, telemetry
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.serving import ServingServer, slo
    torch.backends.cudnn.deterministic = True
    net = resnet_net(torch, DEV)
    shape = (3, RESNET_IMAGE, RESNET_IMAGE)
    srv = ServingServer(net, engine_args={"example_shape": shape,
                                          "dtype": "float32"},
                        batcher_args={"max_batch_size": OBS_CLIENTS,
                                      "max_delay_ms": 2,
                                      "queue_depth": 256})
    srv.warmup(list(OBS_BUCKETS))
    host, port = srv.start_http()
    url = f"http://{host}:{port}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=60) as resp:
            return resp.read().decode()

    images = list(onp.random.RandomState(0).randn(
        OBS_CLIENTS, *shape).astype(onp.float32))
    out = {}
    try:
        for name, target in (("reachable", 60000.0), ("unreachable", 1.0)):
            slo.declare(latency_ms=target, percentile=95.0, window_s=2.4,
                        min_samples=8)
            lat, wall = closed_loop(
                lambda x: srv.predict(x, timeout_ms=120000), images,
                OBS_CLIENTS, OBS_CALLS)
            view = srv.sloz()
            inc = json.loads(get("/incidents"))
            serving = [i for i in inc["open"] + inc["recent"]
                       if i["cause"] in clustermon.SERVING_CAUSES]
            out[name] = {"latency_ms_p50": pct(lat, 50) * 1e3,
                         "latency_ms_p95": pct(lat, 95) * 1e3,
                         "req_per_s": len(lat) / wall,
                         "burning": view["burning"],
                         "burn_long": view["latency"]["burn_long"],
                         "burn_short": view["latency"]["burn_short"],
                         "serving_incidents": serving}
            if name == "reachable" and (serving or view["burning"]):
                failures.append(f"(c) reachable objective: {out[name]}")
            if name == "unreachable" and not serving:
                failures.append(f"(c) no serving incident under p95 <= 1 "
                                f"ms: {view}")
            if name == "unreachable":
                # a bucket's rows against the eager forward of their
                # batch, the objective still declared
                results, meta = srv.engine.infer_batch(images)
                batch = torch.from_numpy(onp.stack(images)).to(DEV)
                with autograd.pause():
                    eager = net(NDArray._wrap(batch))._data.cpu().numpy()
                bitwise = bool(meta["compiled"]) and onp.array_equal(
                    onp.stack(results), eager)
                if not bitwise:
                    failures.append(f"(c) bucket {meta} rows differ from "
                                    f"the eager forward")
            slo.undeclare()
        text = get("/metrics")
        parsed = clustermon.parse_prometheus_text(text)
        varz = json.loads(get("/varz"))
        metric_reqs = parsed["mxnet_serving_requests"][0][1]
        if metric_reqs != varz["serving.requests"]:
            failures.append(f"(c) /metrics requests {metric_reqs}, /varz "
                            f"{varz['serving.requests']}")
    finally:
        slo.undeclare()
        srv.stop()
        torch.backends.cudnn.deterministic = False
    out.update(metrics_samples=sum(len(v) for v in parsed.values()),
               metrics_requests=metric_reqs,
               varz_requests=varz["serving.requests"],
               rows_bitwise_eager=bitwise)
    del srv, net
    gc.collect()
    torch.cuda.empty_cache()
    return out


def obs_export(root, failures):
    """(d): the trace export of (a) and the aggregator over its spool."""
    from mxnet_tpu_torch import clustermon, tracing
    path = tracing.export(os.path.join(root, "trace.json"))
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"]
    steps = [e for e in evs if e.get("name") == "step.spmd"]
    meta = [e for e in evs if e.get("ph") == "M"
            and e.get("name") == "rank_world"]
    if not steps or not meta or meta[0]["args"] != {"rank": 0, "world": 1}:
        failures.append(f"(d) export: {len(steps)} step.spmd spans, "
                        f"metadata {meta}")
    agg = clustermon.ClusterAggregator(os.path.join(root, "cluster"),
                                       window=OBS_STEPS)
    view = agg.poll()
    if sorted(view["ranks"]) != [0] or view["straggler"] is not None \
            or view["joined_steps"] != OBS_STEPS:
        failures.append(f"(d) cluster view: ranks {sorted(view['ranks'])},"
                        f" straggler {view['straggler']}, joined "
                        f"{view['joined_steps']}")
    return {"events": len(evs), "step_spmd_spans": len(steps),
            "rank_world": meta[0]["args"] if meta else None,
            "cluster": {"ranks": sorted(view["ranks"]),
                        "joined_steps": view["joined_steps"],
                        "straggler": view["straggler"],
                        "host_ms_mean": view["ranks"].get(0, {}).get(
                            "host_ms_mean")}}


def phase_observability(torch, fa_mod, smi):
    """Phase 22: the port's observability on the card (see the module
    docstring)."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="obs_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    failures = []
    try:
        train, trainer, batch = obs_training(torch, fa_mod, root, failures)
        emit({"phase": "observability", "gpu": smi, "a_training": train})
        export = obs_export(root, failures)
        emit({"phase": "observability", "gpu": smi, "d_export": export})
        prof = obs_profiler(torch, trainer, batch, root, failures)
        emit({"phase": "observability", "gpu": smi, "b_profiler": prof})
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
        serving = obs_serving(torch, root, failures)
        emit({"phase": "observability", "gpu": smi, "c_serving": serving,
              "phase_s": time.perf_counter() - t0})
    finally:
        obs_env(False, root)
        from mxnet_tpu_torch import clustermon
        clustermon._on_cluster_dir(None)
        shutil.rmtree(root, ignore_errors=True)
    if failures:
        raise AssertionError(f"observability: {failures}")
    return train["counts"]


DIST_STAGES = (0, 1, 3)     # ZeRO stages of the meshed transformer row
DIST_STEPS = 10             # replayed steps a trainer, after its warm one
# Two ranks on the one card (tools/gloo_cuda_probe.py on the H100,
# PERF.md section 7): NCCL refuses every collective of a communicator
# that holds the device twice ("invalid usage"); gloo gives the right
# numbers for all_reduce, reduce_scatter_tensor, all_gather_into_tensor
# and all_to_all_single on CUDA tensors, but batch_isend_irecv, the
# ring's rotation, aborts a rank (its TCP pair writes from device
# memory: "writev ... Bad address").  So the phase runs one rank, and
# checks the multi-rank ring body folded onto the card instead.
DIST_MULTI_RANK_ON_ONE_CARD = False


def dist_lm(torch, mesh=None):
    """The training row's model (``train_model``'s weights, seed 0), with
    ring-flash attention over ``mesh``'s sp axis when given."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
    kw = {} if mesh is None else {"ring_mesh": mesh,
                                  "sp_mode": "ring_flash"}
    net = TransformerLM(VOCAB, units=DIM, num_layers=LAYERS,
                        num_heads=HEADS, max_len=SEQ, tie_weights=True,
                        **kw)
    net.initialize(init=initializer.Xavier(), device=DEV,
                   generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        net(torch.zeros((1, 8), dtype=torch.int32, device=DEV))
    return net


def dist_run(torch, fns, trainer, data, label, base):
    """A warm step (the capture), then DIST_STEPS replays with K1-K3's
    counts zeroed just before and read just after: the losses, the
    counts, and the peak memory of the replays above ``base`` (the bytes
    allocated before the trainer's model was built)."""
    losses = [float(trainer.step(data, label))]
    step_graph(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(*fns)
    losses += [float(trainer.step(data, label)) for _ in range(DIST_STEPS)]
    counts = {f.__name__: {"launches": f.launches,
                           "plain_calls": f.plain_calls} for f in fns}
    return losses, counts, torch.cuda.max_memory_allocated() - base


DIST_FOLD = 4               # sequence shards of the folded ring check


def dist_ring_fold(torch, fa_mod, fns, smi):
    """The ring-flash body of a DIST_FOLD-rank ring on the one card
    (``ring_attention.ring_flash_fold``: every rank in this process, the
    rotation a local index), at the training row's attention shape (BH
    64, S 2048, D 64, bf16, causal): K1 causal on the diagonal blocks
    and non-causal below, the LSE merge, K2/K3 per block with the global
    LSE and delta, dK/dV accumulated in f32 riding with their shards.
    K1-K3's counts are zeroed just before the call and read just after
    (10 launches each: 4 + 3 + 2 + 1 blocks).  Output, LSE, dQ, dK and
    dV are held against ``flash_attention`` (unsharded K1-K3) and the
    plain version on the same inputs, at the bf16 tolerance of
    ``parity_flash``."""
    from mxnet_tpu_torch.parallel.ring_attention import ring_flash_fold
    n = DIST_FOLD
    q, k, v, do = flash_case(torch, TRAIN_BH, SEQ, SEQ, HEAD_DIM,
                             torch.bfloat16, seed=16)
    scale = 1.0 / HEAD_DIM ** 0.5
    reset_counts(*fns)
    got = ring_flash_fold(q, k, v, n, causal=True, do=do)
    torch.cuda.synchronize()
    counts = {f.__name__: {"launches": f.launches,
                           "plain_calls": f.plain_calls} for f in fns}
    blocks = n * (n + 1) // 2
    failures = [f"ring fold: {name} launched {c['launches']} times "
                f"({c['plain_calls']} plain), expected {blocks}"
                for name, c in counts.items()
                if c["launches"] != blocks or c["plain_calls"]]
    # unsharded: K1 for out and LSE, K2/K3 on their residuals
    w_out, w_lse = fa_mod.flash_fwd(q, k, v, causal=True)
    w_delta = fa_mod._delta(do, w_out)
    w_dk, w_dv = fa_mod.flash_bwd_dkdv(q, k, v, do, w_lse, w_delta,
                                       causal=True)
    w_dq = fa_mod.flash_bwd_dq(q, k, v, do, w_lse, w_delta, causal=True)
    p_out, p_lse = fa_mod.flash_forward_reference(q, k, v, True, scale)
    p_dq, p_dk, p_dv = fa_mod.flash_backward_reference(
        q, k, v, p_out, p_lse, do, True, scale)
    torch.cuda.synchronize()
    names = ("out", "lse", "dq", "dk", "dv")
    tols = {"out": 2e-2, "lse": 1e-4, "dq": 2e-2, "dk": 2e-2, "dv": 2e-2}
    errs = {}
    for ref_name, refs in (("flash_attention", (w_out, w_lse, w_dq, w_dk,
                                                w_dv)),
                           ("plain", (p_out, p_lse, p_dq, p_dk, p_dv))):
        errs[ref_name] = {}
        for name, a, b in zip(names, got, refs):
            try:
                errs[ref_name][name] = max_err(a, b, tols[name], tols[name])
            except AssertionError as e:
                failures.append(f"ring fold {name} vs {ref_name}: {e}")
    fold_ms = device_ms(torch, lambda: ring_flash_fold(q, k, v, n,
                                                       causal=True, do=do),
                        runs=10)

    def whole():
        o, lse = fa_mod.flash_fwd(q, k, v, causal=True)
        delta = fa_mod._delta(do, o)
        fa_mod.flash_bwd_dkdv(q, k, v, do, lse, delta, causal=True)
        fa_mod.flash_bwd_dq(q, k, v, do, lse, delta, causal=True)

    whole_ms = device_ms(torch, whole, runs=10)
    row = {"phase": "distributed", "gpu": smi, "part": "ring_fold",
           "shards": n, "bh_s_d": [TRAIN_BH, SEQ, HEAD_DIM],
           "dtype": "bfloat16", "causal": True, "counts": counts,
           "blocks_expected": blocks, "tolerance": tols,
           "max_abs_err": errs, "fwd_bwd_ms": {"fold": fold_ms,
                                               "flash_attention": whole_ms}}
    emit(row)
    del q, k, v, do, got, p_out, p_lse, p_dq, p_dk, p_dv
    torch.cuda.empty_cache()
    return counts, failures


def phase_distributed(torch, fa_mod, smi):
    """Phase 23: SPMD distribution on the card (see the module docstring):
    the transformer row through ``SPMDTrainer(mesh=make_mesh({"dp": -1,
    "sp": 1}), seq_axis=1)`` with ring-flash attention, at each ZeRO
    stage, against the unmeshed trainer in the same process."""
    import torch.distributed as dist
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.parallel import _dist, make_mesh
    t0 = time.perf_counter()
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    data, label = train_batch(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    plain = train_trainer(torch, dist_lm(torch))
    plain_losses, plain_counts, plain_peak = dist_run(torch, fns, plain,
                                                      data, label, base)
    plain_fn = lambda: float(plain.step(data, label))  # noqa: E731
    plain_prof = profiled(torch, plain_fn, 5, count=("nccl",))
    mesh = make_mesh({"dp": -1, "sp": 1})
    group = {"backend": dist.get_backend(), "world": dist.get_world_size(),
             "device": str(_dist.device()), "mesh": dict(mesh.shape)}
    if group["backend"] != "nccl" or group["world"] != 1:
        raise AssertionError(f"distributed: expected a group of one over "
                             f"NCCL, got {group}")
    fold_counts, failures = dist_ring_fold(torch, fa_mod, fns, smi)
    rows = []
    for stage in DIST_STAGES:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        trainer = train_trainer(torch, dist_lm(torch, mesh), mesh=mesh,
                                seq_axis=1, zero_stage=stage)
        losses, counts, peak = dist_run(torch, fns, trainer, data, label,
                                        base)
        for name, c in counts.items():
            if c["launches"] != LAYERS * DIST_STEPS or c["plain_calls"]:
                failures.append(f"zero {stage}: {name} launched "
                                f"{c['launches']} times in {DIST_STEPS} "
                                f"replayed steps ({c['plain_calls']} plain)")
        got, want = onp.asarray(losses), onp.asarray(plain_losses)
        if not onp.allclose(got, want, rtol=1e-2, atol=0):
            failures.append(f"zero {stage}: losses {losses} not within "
                            f"rtol 1e-2 of the unmeshed {plain_losses}")
        modes = {"meshed": lambda: float(trainer.step(data, label)),
                 "unmeshed": plain_fn}
        host = host_ms_blocks(modes, calls=10, rounds=2)
        _, busy, _, nccl = profiled(torch, modes["meshed"], 5,
                                    count=("nccl",))
        rows.append({
            "zero_stage": stage, "losses": losses,
            "bitwise_equal_to_unmeshed": bool(onp.array_equal(got, want)),
            "max_rel_diff": float(onp.max(onp.abs(got - want)
                                          / onp.abs(want))),
            "launches_per_step": {k: v["launches"] / DIST_STEPS
                                  for k, v in counts.items()},
            "host_ms": host, "device_busy_ms": busy,
            "peak_bytes_replays_over_base": peak,
            "opt_state_bytes_per_device":
                telemetry.gauge("opt_state.bytes_per_device").value,
            "nccl_kernels_per_step": nccl["nccl"],
            "kernels_per_step": nccl["kernels"]})
        del trainer, modes
        gc.collect()
        torch.cuda.empty_cache()
        # what the trainer left allocated after it went
        rows[-1]["left_allocated_bytes"] = \
            torch.cuda.memory_allocated() - base
        emit({"phase": "distributed", "gpu": smi, "part": "a",
              **rows[-1]})
    emit({"phase": "distributed", "gpu": smi, "part": "a_summary",
          "group": group, "model": {"vocab": VOCAB, "units": DIM,
                                    "layers": LAYERS, "heads": HEADS,
                                    "batch": BATCH, "seq": SEQ,
                                    "dtype": "bfloat16", "optimizer": "adam",
                                    "lr": LR, "sp_mode": "ring_flash",
                                    "seq_axis": 1},
          "unmeshed_losses": plain_losses,
          "unmeshed_launches_per_step": {
              k: v["launches"] / DIST_STEPS for k, v in plain_counts.items()},
          "unmeshed_peak_bytes_replays_over_base": plain_peak,
          "unmeshed_device_busy_ms": plain_prof[1],
          "unmeshed_kernels_per_step": plain_prof[3]["kernels"],
          "unmeshed_nccl_kernels_per_step": plain_prof[3]["nccl"],
          "size_one_collectives": "elided (no NCCL kernel a step)"
          if all(r["nccl_kernels_per_step"] == 0 for r in rows)
          else "launched",
          "multi_rank_on_one_card": DIST_MULTI_RANK_ON_ONE_CARD,
          "phase_s": time.perf_counter() - t0})
    del plain, plain_fn
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    if failures:
        raise AssertionError(f"distributed: {failures}")
    return {k: {"launches": sum(r["launches_per_step"][k] for r in rows)
                * DIST_STEPS, "plain_calls": 0,
                "fold_launches": fold_counts[k]["launches"]} for k in
            ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")}


PIPE_STAGES = 4             # (a)-(c): the 8 blocks as 4 stages of 2
PIPE_M = 8                  # (a): microbatches of 1 x SEQ
PIPE_FILL_M = 4             # (b): GPipe's and the interleaved microbatches
PIPE_VIRTUAL = 2            # (b): virtual stages a rank (8 one-block stages)
PIPE_MEM_M = (8, 16)        # (c): 1F1B and GPipe at M 8 and 16, 1 x SEQ each
PIPE_TOL = 1e-2             # loss rtol; each gradient's relative L2
M4D_STEPS = 10              # (d): replayed steps a trainer, after its warm one
M4D_WINDOW = 4              # (d): run_steps window
M4D_SGD = {"learning_rate": 0.05, "momentum": 0.9}


def pipe_blocks(torch, net):
    """The training row's blocks as stacked leaves: each of a block's 12
    parameters stacked over the LAYERS blocks (f32 clones of the
    masters), and the two template blocks whose parameters a stage
    function overrides with a stage's (cast to bf16)."""
    plists = [list(b.collect_params().values()) for b in net.blocks]
    leaves = [torch.stack([pl[k]._tensor().detach() for pl in plists])
              .clone() for k in range(len(plists[0]))]
    return leaves, [net.blocks[0], net.blocks[1]], plists[:2]


def pipe_stage(torch, blocks, plists, n):
    """A stage of ``n`` blocks: ``stage(p, h)`` with each leaf of ``p``
    (n, ...) (``n`` = 1: a leaf is one block's), run through the template
    blocks in bf16."""
    from mxnet_tpu_torch.parallel.trainer import _params_as

    def stage(p, h):
        for j in range(n):
            ws = [(lf[j] if n > 1 else lf).to(torch.bfloat16) for lf in p]
            with _params_as(plists[j % 2], ws):
                h = blocks[j % 2](h)
        return h
    return stage


def pipe_mse(y, t):
    return ((y.float() - t) ** 2).mean()


def pipe_inputs(torch, net, batch, seed):
    """``batch`` x SEQ seeded ids, the (batch, SEQ, DIM) f32 target, and
    the bf16 embedded input (token rows plus positions) from ``net``'s
    masters."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, VOCAB, (batch, SEQ), generator=g).to(DEV)
    tgt = torch.randn((batch, SEQ, DIM), generator=g).to(DEV)
    emb = net.embed.weight._tensor().detach()
    pos = net.pos_embed._tensor().detach()[:SEQ]
    x = emb.to(torch.bfloat16)[ids] + pos.to(torch.bfloat16)
    return ids, tgt, x


def pipe_sequential(torch, net, leaves, blocks, plists, ids, tgt):
    """The same blocks in sequence over the whole batch under autograd:
    the loss and the gradients of the stacked leaves, the embedding, the
    positions and the embedded input."""
    ws = [lf.clone().requires_grad_() for lf in leaves]
    emb = net.embed.weight._tensor().detach().clone().requires_grad_()
    pos = net.pos_embed._tensor().detach().clone().requires_grad_()
    x = emb.to(torch.bfloat16)[ids] + pos[:SEQ].to(torch.bfloat16)
    x.retain_grad()
    stage = pipe_stage(torch, blocks, plists, 1)
    h = x
    for layer in range(LAYERS):
        h = stage([w[layer] for w in ws], h)
    loss = pipe_mse(h, tgt)
    loss.backward()
    return (float(loss.detach()), [w.grad for w in ws], emb.grad,
            pos.grad[:SEQ], x.grad)


def pipe_compare(name, got, want, failures):
    """Loss within rtol PIPE_TOL, each gradient within relative L2
    PIPE_TOL: the errors by name."""
    loss, grads, g_emb, g_pos, dx = got
    w_loss, w_grads, w_emb, w_pos, w_dx = want
    errs = {"loss_rel": abs(loss - w_loss) / abs(w_loss),
            "leaves_rel_l2": [rel_l2(g.reshape(w.shape), w)
                              for g, w in zip(grads, w_grads)],
            "embedding_rel_l2": rel_l2(g_emb, w_emb),
            "positions_rel_l2": rel_l2(g_pos, w_pos),
            "input_grad_rel_l2": rel_l2(dx, w_dx)}
    worst = max([errs["embedding_rel_l2"], errs["positions_rel_l2"],
                 errs["input_grad_rel_l2"]] + errs["leaves_rel_l2"])
    if errs["loss_rel"] > PIPE_TOL or not worst <= PIPE_TOL:
        failures.append(f"pipeline {name}: loss rel {errs['loss_rel']}, "
                        f"worst gradient rel L2 {worst} (tolerance "
                        f"{PIPE_TOL})")
    errs["worst_grad_rel_l2"] = worst
    return errs


def pipe_1f1b(torch, leaves, blocks, plists, ids, tgt, x, M):
    """One folded 1F1B step (S = PIPE_STAGES) with the embedding chained
    through the input gradient (rows scattered into the embedding's
    gradient, summed into the positions')."""
    from mxnet_tpu_torch.parallel import pipeline_value_and_grad_1f1b
    S = PIPE_STAGES
    per = LAYERS // S
    stacked = [lf.reshape((S, per) + tuple(lf.shape[1:])) for lf in leaves]
    loss, grads, dx = pipeline_value_and_grad_1f1b(
        pipe_stage(torch, blocks, plists, per), pipe_mse, stacked, x, tgt,
        None, M, batch_axis_name=None, return_input_grad=True, fold=True)
    # the row scatter a microbatch at a time: no f32 copy of the whole
    # batch's input gradient
    g_emb = torch.zeros((VOCAB, DIM), dtype=torch.float32, device=x.device)
    g_pos = torch.zeros((SEQ, DIM), dtype=torch.float32, device=x.device)
    for m in range(dx.shape[0]):
        g_emb.index_add_(0, ids[m], dx[m].float())
        g_pos += dx[m].float()
    return float(loss), list(grads), g_emb, g_pos, dx


def pipe_fill_drain(torch, net, leaves, blocks, plists, ids, tgt, kind):
    """GPipe (S = PIPE_STAGES, stages of 2 blocks) or the interleaved
    schedule (S = PIPE_STAGES, V = PIPE_VIRTUAL one-block virtual
    stages), folded, M = PIPE_FILL_M: forward, then backward by
    autograd from the embedding on."""
    from mxnet_tpu_torch import parallel as par
    S = PIPE_STAGES
    ws = [lf.clone().requires_grad_() for lf in leaves]
    emb = net.embed.weight._tensor().detach().clone().requires_grad_()
    pos = net.pos_embed._tensor().detach().clone().requires_grad_()
    x = emb.to(torch.bfloat16)[ids] + pos[:SEQ].to(torch.bfloat16)
    x.retain_grad()
    if kind == "gpipe":
        per = LAYERS // S
        out = par.pipeline_forward(
            pipe_stage(torch, blocks, plists, per),
            [w.reshape((S, per) + tuple(w.shape[1:])) for w in ws], x, None,
            PIPE_FILL_M, batch_axis_name=None, fold=True)
    else:
        out = par.pipeline_forward_interleaved(
            pipe_stage(torch, blocks, plists, 1), ws, x, None, PIPE_FILL_M,
            batch_axis_name=None, fold=True, n_stages=S)
    loss = pipe_mse(out, tgt)
    loss.backward()
    return (float(loss.detach()), [w.grad for w in ws], emb.grad,
            pos.grad[:SEQ], x.grad)


def pipe_peak(torch, fn):
    """Peak bytes allocated over the bytes allocated before ``fn()``
    (which makes its own batch)."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    io = fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, io


def pipe_memory(torch, net, leaves, blocks, plists, failures):
    """(c) peak memory over base of 1F1B and GPipe at M in PIPE_MEM_M,
    microbatches of 1 x SEQ."""
    rows = {}
    for M in PIPE_MEM_M:
        def one_f_one_b():
            ids, tgt, x = pipe_inputs(torch, net, M, seed=24)
            out = pipe_1f1b(torch, leaves, blocks, plists, ids, tgt, x, M)
            return x.nbytes + tgt.nbytes + out[4].nbytes

        def gpipe():
            from mxnet_tpu_torch import parallel as par
            ids, tgt, x = pipe_inputs(torch, net, M, seed=24)
            ws = [lf.clone().requires_grad_() for lf in leaves]
            S, per = PIPE_STAGES, LAYERS // PIPE_STAGES
            x.requires_grad_()
            out = par.pipeline_forward(
                pipe_stage(torch, blocks, plists, per),
                [w.reshape((S, per) + tuple(w.shape[1:])) for w in ws], x,
                None, M, batch_axis_name=None, fold=True)
            pipe_mse(out, tgt).backward()
            return x.nbytes + tgt.nbytes + x.grad.nbytes

        p1, io1 = pipe_peak(torch, one_f_one_b)
        pg, iog = pipe_peak(torch, gpipe)
        rows[M] = {"1f1b_peak_bytes": p1, "1f1b_batch_bytes": io1,
                   "gpipe_peak_bytes": pg, "gpipe_batch_bytes": iog}
    lo, hi = (rows[m] for m in PIPE_MEM_M)
    f_growth = (hi["1f1b_peak_bytes"] - hi["1f1b_batch_bytes"]) / (
        lo["1f1b_peak_bytes"] - lo["1f1b_batch_bytes"])
    g_growth = hi["gpipe_peak_bytes"] / lo["gpipe_peak_bytes"]
    if not f_growth < 1.1:
        failures.append(f"pipeline memory: 1F1B's peak beyond its batch "
                        f"grew {f_growth}x from M={PIPE_MEM_M[0]} to "
                        f"{PIPE_MEM_M[1]} (limit 1.1)")
    if not g_growth >= 1.6:
        failures.append(f"pipeline memory: GPipe's peak grew only "
                        f"{g_growth}x (expected >= 1.6)")
    return {"by_m": rows, "1f1b_growth_beyond_batch": f_growth,
            "gpipe_growth": g_growth}


def m4d_stage(torch, net):
    """The training row as a Mesh4DTrainer stage function: its
    parameters (in ``collect_params`` order) overridden by the step's."""
    from mxnet_tpu_torch.parallel.trainer import _params_as
    plist = list(net.collect_params().values())

    def stage(p, x):
        with _params_as(plist, p):
            return net(x)
    return stage, plist


def phase_mesh4d(torch, fns, smi, failures):
    """(d) Mesh4DTrainer on one rank over NCCL (``MeshPlan()``, the
    pp == 1 path) against SPMDTrainer, both SGD momentum 0.9 lr 0.05
    under ``amp.init("bfloat16")``, from the same weights and batch."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from mxnet_tpu_torch import amp, telemetry
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import (MeshPlan, Mesh4DTrainer,
                                          SPMDTrainer)
    data, label = train_batch(torch)
    amp.init("bfloat16")
    try:
        plan = MeshPlan()
        group = {"backend": dist.get_backend(),
                 "world": dist.get_world_size(), "plan": plan.describe()}
        if group["backend"] != "nccl" or group["world"] != 1:
            raise AssertionError(f"mesh4d: expected a group of one over "
                                 f"NCCL, got {group}")
        spmd = SPMDTrainer(train_model(torch), SoftmaxCrossEntropyLoss(),
                           optimizer="sgd", optimizer_params=M4D_SGD,
                           device=DEV)
        net = train_model(torch)
        stage, plist = m4d_stage(torch, net)
        ce = SoftmaxCrossEntropyLoss()

        def lm_loss(out, y):
            return ce(out, y).float().mean()

        tr = Mesh4DTrainer(plan, stage, lm_loss,
                           [p._tensor().detach() for p in plist],
                           learning_rate=M4D_SGD["learning_rate"],
                           momentum=M4D_SGD["momentum"])
        telemetry.reset("comm.")
        spmd_losses = [float(spmd.step(data, label))]
        losses = [float(tr.step(data, label))]
        spmd_losses += [float(spmd.step(data, label))
                        for _ in range(M4D_STEPS)]
        torch.cuda.synchronize()
        reset_counts(*fns)
        losses += [float(tr.step(data, label)) for _ in range(M4D_STEPS)]
        torch.cuda.synchronize()
        counts = {f.__name__: {"launches": f.launches,
                               "plain_calls": f.plain_calls} for f in fns}
        for name, c in counts.items():
            if c["launches"] != LAYERS * M4D_STEPS or c["plain_calls"]:
                failures.append(f"mesh4d: {name} launched {c['launches']} "
                                f"times in {M4D_STEPS} replayed steps "
                                f"({c['plain_calls']} plain)")
        got, want = onp.asarray(losses), onp.asarray(spmd_losses)
        if not (onp.isfinite(got).all()
                and onp.allclose(got, want, rtol=1e-2, atol=0)):
            failures.append(f"mesh4d: losses {losses} not within rtol 1e-2 "
                            f"of SPMDTrainer's {spmd_losses}")
        compiles_steps = tr.compiles
        tr.run_steps(data, label, M4D_WINDOW)        # warm run + capture
        compiles_window = tr.compiles
        d0 = telemetry.counter("dispatch.count").value
        window_counts = counted_call(
            torch, fns, lambda: tr.run_steps(data, label, M4D_WINDOW))
        dispatches = telemetry.counter("dispatch.count").value - d0
        if (compiles_steps, compiles_window, tr.compiles) != (1, 2, 2) \
                or dispatches != 1:
            failures.append(f"mesh4d: compiles {compiles_steps}/"
                            f"{compiles_window}/{tr.compiles}, dispatches "
                            f"{dispatches} for a replayed window")
        for name, c in window_counts.items():
            if c["launches"] != LAYERS * M4D_WINDOW or c["plain_calls"]:
                failures.append(f"mesh4d: {name} launched {c['launches']} "
                                f"times in a window of {M4D_WINDOW}")
        comm_bytes = {ax: telemetry.counter(f"comm.{ax}.bytes").value
                      for ax in ("pp", "dp", "ep", "sp", "tp")}
        if any(comm_bytes.values()):
            failures.append(f"mesh4d: comm bytes on one rank {comm_bytes}")
        modes = {"mesh4d": lambda: float(tr.step(data, label)),
                 "spmd": lambda: float(spmd.step(data, label))}
        host = host_ms_blocks(modes, calls=10, rounds=2)
        root = tempfile.mkdtemp(prefix="pipe_", dir=os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "build"))
        try:
            tr.save_checkpoint(root)
            back = Mesh4DTrainer(plan, stage, lm_loss,
                                 [p._tensor().detach() for p in plist],
                                 learning_rate=M4D_SGD["learning_rate"],
                                 momentum=M4D_SGD["momentum"])
            header = back.load_checkpoint(root)
            same = all(torch.equal(a, b) for a, b in zip(
                tr.gather_params() + tr.gather_momentum(),
                back.gather_params() + back.gather_momentum()))
            if not same or header["num_update"] != tr.num_update:
                failures.append("mesh4d: the checkpoint round trip is not "
                                "bitwise")
            del back
        finally:
            shutil.rmtree(root, ignore_errors=True)
        row = {"phase": "pipeline", "gpu": smi, "part": "d_mesh4d",
               "group": group, "losses": losses,
               "spmd_losses": spmd_losses,
               "bitwise_equal_to_spmd": bool(onp.array_equal(got, want)),
               "max_rel_diff": float(onp.max(onp.abs(got - want)
                                             / onp.abs(want))),
               "launches_per_step": {k: v["launches"] / M4D_STEPS
                                     for k, v in counts.items()},
               "window": {"n_steps": M4D_WINDOW, "compiles":
                          [compiles_steps, compiles_window, tr.compiles],
                          "dispatches": dispatches,
                          "launches": {k: v["launches"] for k, v in
                                       window_counts.items()}},
               "comm_bytes": comm_bytes, "host_ms": host,
               "state_bytes_per_device": tr.state_bytes_per_device(),
               "checkpoint_bitwise": same}
        emit(row)
        del tr, spmd, modes
    finally:
        amp.reset()
        gc.collect()
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return counts


def phase_pipeline(torch, fa_mod, smi):
    """Phase 24: the pipeline schedules and Mesh4DTrainer on the card (see
    the module docstring)."""
    t0 = time.perf_counter()
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    failures = []
    net = train_model(torch)
    leaves, blocks, plists = pipe_blocks(torch, net)
    ids, tgt, x = pipe_inputs(torch, net, BATCH, seed=24)
    want = pipe_sequential(torch, net, leaves, blocks, plists, ids, tgt)
    # (a) 1F1B, folded: counts zeroed just before the step, read just after
    torch.cuda.synchronize()
    reset_counts(*fns)
    got = pipe_1f1b(torch, leaves, blocks, plists, ids, tgt, x, PIPE_M)
    torch.cuda.synchronize()
    counts = {f.__name__: {"launches": f.launches,
                           "plain_calls": f.plain_calls} for f in fns}
    S, per = PIPE_STAGES, LAYERS // PIPE_STAGES
    expect = {"flash_fwd": ((S - 1) + S) * PIPE_M * per,
              "flash_bwd_dkdv": S * PIPE_M * per,
              "flash_bwd_dq": S * PIPE_M * per}
    for name, c in counts.items():
        if c["launches"] != expect[name] or c["plain_calls"]:
            failures.append(f"pipeline 1f1b: {name} launched "
                            f"{c['launches']} times ({c['plain_calls']} "
                            f"plain), predicted {expect[name]}")
    errs = {"1f1b": pipe_compare("1f1b", got, want, failures)}
    # the second runs, timed (host ms of a synced step)
    t1 = time.perf_counter()
    again = pipe_1f1b(torch, leaves, blocks, plists, ids, tgt, x, PIPE_M)
    torch.cuda.synchronize()
    f_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    pipe_sequential(torch, net, leaves, blocks, plists, ids, tgt)
    torch.cuda.synchronize()
    seq_ms = (time.perf_counter() - t1) * 1e3
    bitwise = (got[0] == again[0] and all(
        torch.equal(a, b) for a, b in zip(
            got[1] + [got[2], got[3], got[4]],
            again[1] + [again[2], again[3], again[4]])))
    if not bitwise:
        failures.append("pipeline 1f1b: a second run is not bitwise equal "
                        "to the first")
    del again, got
    # (b) GPipe and the interleaved schedule, folded
    fill = {}
    for kind in ("gpipe", "interleaved"):
        c = counted_call(torch, fns, lambda: fill.__setitem__(
            kind, pipe_fill_drain(torch, net, leaves, blocks, plists, ids,
                                  tgt, kind)))
        errs[kind] = pipe_compare(kind, fill.pop(kind), want, failures)
        errs[kind]["launches"] = {k: v["launches"] for k, v in c.items()}
        n = PIPE_FILL_M * LAYERS
        if any(v["launches"] != n or v["plain_calls"] for v in c.values()):
            failures.append(f"pipeline {kind}: launches {c}, predicted {n}"
                            f" each")
    del want
    # (c) the 1F1B memory property
    memory = pipe_memory(torch, net, leaves, blocks, plists, failures)
    emit({"phase": "pipeline", "gpu": smi, "part": "abc",
          "stages": S, "blocks_per_stage": per, "microbatches": PIPE_M,
          "microbatch": [1, SEQ], "dtype": "bfloat16 compute, f32 masters",
          "launches_1f1b": counts, "launches_predicted": expect,
          "bubble_slots_compute": False,
          "errors": errs, "tolerance": PIPE_TOL,
          "second_run_bitwise": bitwise,
          "host_ms": {"1f1b_step": f_ms, "sequential_step": seq_ms},
          "memory": memory})
    del net, leaves, blocks, plists, ids, tgt, x
    gc.collect()
    torch.cuda.empty_cache()
    # (d) Mesh4DTrainer
    m4d_counts = phase_mesh4d(torch, fns, smi, failures)
    emit({"phase": "pipeline", "gpu": smi, "part": "summary",
          "failures": failures, "phase_s": time.perf_counter() - t0})
    if failures:
        raise AssertionError(f"pipeline: {failures}")
    return {k: {"pipeline": counts[k]["launches"],
                "mesh4d": m4d_counts[k]["launches"]} for k in counts}


KV_STEPS = 10               # (a) eager steps a store, taken in turns
KV_CHECK_STEPS = 3          # (b), (c) steps a run
KV_TOL = 1e-3               # (a) loss rtol, dist_sync against device
KV_SPARSE_TOL = 1e-5        # (d) touched rows, lazy against dense Adam
KV_SPARSE_ATOL = 1e-8       # (d) beside it: weights of ~1e-2, steps ~3e-4
KV_SHARDS = 2               # (e) in-process parameter servers


def kv_step(mx, net, loss_fn, trainer, x, y, after_backward=None):
    """One eager Gluon step (forward and loss recorded, ``backward``,
    ``trainer.step``), the loss's mean read back (a synced step);
    ``after_backward(net)`` runs between the backward and the step."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    if after_backward is not None:
        after_backward(net)
    trainer.step(BATCH)
    return float(loss.mean().asscalar())


def kv_model(torch, sparse_grad=None, seed=0):
    """The training row's model (``train_model``'s weights); with
    ``sparse_grad`` set, untied: its ``embed`` an ``nn.Embedding(VOCAB,
    DIM, sparse_grad=...)`` holding the tied table and its head a copy
    of it, so the function is the tied row's."""
    tied = train_model(torch, seed=seed)
    if sparse_grad is None:
        return tied
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo import TransformerLM
    net = TransformerLM(VOCAB, units=DIM, num_layers=LAYERS,
                        num_heads=HEADS, max_len=SEQ, tie_weights=False)
    net.embed = nn.Embedding(VOCAB, DIM, sparse_grad=sparse_grad)
    net.initialize(init=initializer.Xavier(), device=DEV)
    with torch.no_grad():
        net(torch.zeros((1, 8), dtype=torch.int32, device=DEV))
    src = tied.collect_params()
    for k, p in net.collect_params().items():
        p.set_data(src["embed.weight" if k == "head.weight" else k]
                   ._tensor())
    del tied
    return net


def kv_dense_runs(torch, mx, loss_fn, x, y, kvstore, **kw):
    """KV_CHECK_STEPS eager steps of the row through ``gluon.Trainer
    (kvstore, update_on_kvstore=False, **kw)``: the losses, and for each
    step the gradients before ``step`` (CPU copies), the store's
    residuals before it (CPU copies) and the gradients after it (the
    reduced ones the update read)."""
    net = kv_model(torch)
    tr = mx.gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": LR}, kvstore=kvstore,
                          update_on_kvstore=False, **kw)
    # (store key, parameter): the trainer's keys are its parameters' places
    live = [(str(i), p) for i, p in enumerate(tr._params)
            if p._grad is not None]
    snaps, losses = [], []

    def before(n):
        comp = getattr(tr._kvstore, "_compression", None)
        res = {} if comp is None else {
            k: v.cpu() for k, v in comp._residuals.items()}
        snaps.append(([(k, p.grad()._data.cpu()) for k, p in live], res))

    for _ in range(KV_CHECK_STEPS):
        losses.append(kv_step(mx, net, loss_fn, tr, x, y, before))
        snaps[-1] += ([p.grad()._data.cpu() for _, p in live],)
    return net, tr, live, losses, snaps


def phase_kvstore(torch, fa_mod, smi):
    """Phase 25: the distributed stores and the row-sparse path on the
    card, on one rank over NCCL (see the module docstring)."""
    import torch.distributed as dist
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, telemetry
    from mxnet_tpu_torch.embedding import ShardedEmbedding
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.imperative import cached_step
    from mxnet_tpu_torch.kvstore import gradient_compression as gc2
    from mxnet_tpu_torch.kvstore.dist import init_distributed
    from mxnet_tpu_torch.kvstore.p3store import P3StoreDist
    from mxnet_tpu_torch.ndarray import sparse as sp
    from mxnet_tpu_torch.ops import optimizer_ops
    t0 = time.perf_counter()
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    failures = []
    init_distributed()                 # a group of one over NCCL
    group = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    if group != {"backend": "nccl", "world": 1}:
        raise AssertionError(f"kvstore: expected a group of one over NCCL, "
                             f"got {group}")
    loss_fn = SoftmaxCrossEntropyLoss()
    ids, labels = train_batch(torch)
    x, y = mx.nd.array(ids), mx.nd.array(labels)
    os.environ["MXNET_CACHED_STEP"] = "0"          # the eager loop
    amp.init("bfloat16")
    try:
        # (a) dist_sync (ZeRO Adam on the store) against device, in turns
        nets = {s: kv_model(torch) for s in ("dist_sync", "device")}
        trs = {s: mx.gluon.Trainer(nets[s].collect_params(), "adam",
                                   {"learning_rate": LR}, kvstore=s)
               for s in nets}
        steps = {s: (lambda s=s: kv_step(mx, nets[s], loss_fn, trs[s], x,
                                         y)) for s in nets}
        losses = {s: [steps[s]()] for s in nets}           # warm steps
        counts = {f.__name__: {"launches": 0, "plain_calls": 0}
                  for f in fns}
        torch.cuda.synchronize()
        for _ in range(KV_STEPS):
            c = counted_call(torch, fns, lambda: losses["dist_sync"].append(
                steps["dist_sync"]()))
            for k, v in c.items():
                counts[k]["launches"] += v["launches"]
                counts[k]["plain_calls"] += v["plain_calls"]
            losses["device"].append(steps["device"]())
        for name, c in counts.items():
            if c["launches"] != LAYERS * KV_STEPS or c["plain_calls"]:
                failures.append(f"kvstore (a): {name} launched "
                                f"{c['launches']} times in {KV_STEPS} "
                                f"steps ({c['plain_calls']} plain)")
        got, want = onp.asarray(losses["dist_sync"]), \
            onp.asarray(losses["device"])
        if not (onp.isfinite(got).all()
                and onp.allclose(got, want, rtol=KV_TOL, atol=0)):
            failures.append(f"kvstore (a): dist_sync losses {list(got)} "
                            f"not within rtol {KV_TOL} of device "
                            f"{list(want)}")
        host = host_ms_blocks(steps, calls=5, rounds=2)
        _, busy, _, per = profiled(torch, steps["dist_sync"], 3,
                                   count=("nccl",))
        os.environ["MXNET_CACHED_STEP"] = "1"
        for _ in range(2):
            steps["dist_sync"]()
        capture = cached_step.trainer_state(trs["dist_sync"])
        os.environ["MXNET_CACHED_STEP"] = "0"
        if capture["captures"] or capture["last_reason"] != \
                "kvstore configuration not capturable":
            failures.append(f"kvstore (a): dist_sync step captured or "
                            f"declined for another reason: {capture}")
        part_a = {
            "update_on_kvstore": trs["dist_sync"]._update_on_kvstore,
            "losses": losses, "bitwise_equal": bool(
                onp.array_equal(got, want)),
            "max_rel_diff": float(onp.max(onp.abs(got - want)
                                          / onp.abs(want))),
            "launches": counts,
            "launches_per_step": {k: v["launches"] / KV_STEPS
                                  for k, v in counts.items()},
            "host_ms": host, "device_busy_ms_dist_sync": busy,
            "kernels_per_step_dist_sync": per["kernels"],
            "nccl_kernels_per_step": per["nccl"],
            "capture": {"captures": capture["captures"],
                        "last_reason": capture["last_reason"]}}
        emit({"phase": "kvstore", "gpu": smi, "part": "a", **part_a})
        del nets, trs, steps
        gc.collect()
        torch.cuda.empty_cache()
        # (b) 2-bit compression, update_on_kvstore=False; and without
        thr = 0.5
        _, ctr, live, closs, csnaps = kv_dense_runs(
            torch, mx, loss_fn, x, y, "dist_sync",
            compression_params={"type": "2bit", "threshold": thr})
        bad = 0
        for grads, res, reduced in csnaps:
            for (k, g), r in zip(grads, reduced):
                prev = res.get(k, torch.zeros_like(g))
                q, _ = gc2._quantize_2bit(g, prev, torch.tensor(
                    thr, dtype=g.dtype))
                bad += int(not torch.equal(q, r))
        if bad:
            failures.append(f"kvstore (b): {bad} reduced gradients differ "
                            f"from the quantiser on CPU copies")
        sizes = dict(ctr._kvstore.last_compressed)
        del ctr, live, csnaps
        gc.collect()
        torch.cuda.empty_cache()
        _, ptr, plive, ploss, _ = kv_dense_runs(torch, mx, loss_fn, x, y,
                                                "dist_sync")
        del ptr, plive
        gc.collect()
        torch.cuda.empty_cache()
        # (c) p3store_dist: pushes from the grad-ready hook
        events = []
        orig = P3StoreDist.pushpull

        def spy(self, *a, **k):
            events.append("push")
            return orig(self, *a, **k)

        def backward_returned(n):
            events.append("backward returned")
        P3StoreDist.pushpull = spy
        try:
            net3 = kv_model(torch)
            tr3 = mx.gluon.Trainer(net3.collect_params(), "adam",
                                   {"learning_rate": LR},
                                   kvstore="p3store_dist")
            n_write = sum(1 for p in net3.collect_params().values()
                          if p._grad is not None and p.grad_req == "write")
            p3loss, early = [], []
            for i in range(KV_CHECK_STEPS):
                events.clear()
                p3loss.append(kv_step(mx, net3, loss_fn, tr3, x, y,
                                      backward_returned))
                early.append(events.index("backward returned"))
                # the hook is installed with the store, at the first step
                if i and (early[-1] != n_write
                          or len(events) != n_write + 1):
                    failures.append(
                        f"kvstore (c): {early[-1]} of {n_write} pushes "
                        f"before backward returned, {len(events) - 1} in "
                        f"all")
        finally:
            P3StoreDist.pushpull = orig
            mx.autograd.set_grad_ready_hook(None)
        if p3loss != ploss:
            failures.append(f"kvstore (c): p3 losses {p3loss} != dist_sync "
                            f"{ploss}")
        part_bc = {
            "compressed_losses": closs, "plain_losses": ploss,
            "p3_losses": p3loss, "p3_bitwise_plain": p3loss == ploss,
            "quantiser_mismatches": bad, "threshold": thr,
            "bytes_last_push": sizes,
            "packed_over_f32": sizes["packed_bytes"] / sizes["dense_bytes"],
            "p3_pushes_before_backward_returned": early,
            "write_grad_params": n_write,
            "p3_slice_threshold": tr3._kvstore._slice_threshold}
        emit({"phase": "kvstore", "gpu": smi, "part": "bc", **part_bc})
        del net3, tr3
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        amp.reset()
        os.environ.pop("MXNET_CACHED_STEP", None)
    # (d) fp32, the row's embed row-sparse, lazy Adam through dist_sync
    os.environ["MXNET_CACHED_STEP"] = "0"
    try:
        uniq = int(torch.unique(ids).numel())
        runs = {}
        for name, sg in (("sparse", True), ("sparse_again", True),
                         ("dense", False)):
            net = kv_model(torch, sparse_grad=sg)
            w0 = net.embed.weight._tensor().detach().clone()
            tr = mx.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": LR},
                                  kvstore="dist_sync")
            grab = {}

            def keep(n, grab=grab):
                g = n.embed.weight.grad()
                grab["grad"] = g if not sg else sp.RowSparseNDArray(
                    g.data.clone(), g.indices.clone(), g.shape)
            loss = kv_step(mx, net, loss_fn, tr, x, y, keep)
            runs[name] = {"loss": loss, "w0": w0, "grad": grab["grad"],
                          "w1": net.embed.weight._tensor().detach().clone()}
            del net, tr
            gc.collect()
            torch.cuda.empty_cache()
        g = runs["sparse"]["grad"]
        touched = g.indices.long()
        mask = torch.ones(VOCAB, dtype=torch.bool, device=DEV)
        mask[touched] = False
        w1s, w1d, w0 = runs["sparse"]["w1"], runs["dense"]["w1"], \
            runs["sparse"]["w0"]
        # elementwise relative error is meaningless where a step brings a
        # weight near 0 (cancellation): held as allclose, rtol KV_SPARSE_TOL
        # and atol KV_SPARSE_ATOL (~10 f32 ulps of the table's entries)
        diff = (w1s[touched] - w1d[touched]).abs()
        rows_err = float((diff / w1d[touched].abs().clamp_min(1e-30)).max())
        rows_abs = float(diff.max())
        rows_ok = bool(torch.allclose(w1s[touched], w1d[touched],
                                      rtol=KV_SPARSE_TOL,
                                      atol=KV_SPARSE_ATOL))
        step_max = float((w1d[touched] - w0[touched]).abs().max())
        untouched_same = bool(torch.equal(w1s[mask], w0[mask]))
        again = runs["sparse_again"]
        second_bitwise = bool(
            torch.equal(again["w1"], w1s)
            and torch.equal(again["grad"].data, g.data)
            and torch.equal(again["grad"].indices, g.indices))
        dense_rows = runs["dense"]["grad"]._data[touched]
        grad_rel = float(((g.data - dense_rows).abs().max()
                          / dense_rows.abs().max()))
        checks = {"nnz_is_unique_ids": g.nnz == uniq,
                  "touched_rows_within_tol": rows_ok,
                  "untouched_rows_bitwise": untouched_same,
                  "second_run_bitwise": second_bitwise,
                  "row_sparse_grad": isinstance(g, sp.RowSparseNDArray)}
        for k, ok in checks.items():
            if not ok:
                failures.append(f"kvstore (d): {k} failed (nnz {g.nnz}, "
                                f"unique {uniq}, touched rel {rows_err})")
        # the update alone: lazy rows against the dense table
        w = w0.clone()
        m, v = torch.zeros_like(w), torch.zeros_like(w)
        wn, mn, vn = (mx.nd.NDArray._wrap(t) for t in (w, m, v))
        statics = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                   "rescale_grad": 1.0 / BATCH}
        lazy_ms = device_ms(torch, lambda: sp.lazy_apply(
            "adam_update", LR, 0.0, wn, g, [mn, vn], statics))
        gd = g.todense()._data
        dense_ms = device_ms(torch, lambda: optimizer_ops.adam_update(
            w, gd, m, v, lr=LR, rescale_grad=1.0 / BATCH))
        part_d = {"dtype": "float32", "unique_ids": uniq, "nnz": g.nnz,
                  "vocab": VOCAB, "losses": {k: r["loss"]
                                             for k, r in runs.items()},
                  "touched_rows_max_rel_diff": rows_err,
                  "touched_rows_max_abs_diff": rows_abs,
                  "dense_step_max_abs": step_max,
                  "sparse_grad_vs_dense_rows_max_rel": grad_rel,
                  "checks": checks, "tolerance": {"rtol": KV_SPARSE_TOL,
                                                  "atol": KV_SPARSE_ATOL},
                  "update_device_ms": {"lazy_adam_rows": lazy_ms,
                                       "dense_adam_table": dense_ms}}
        emit({"phase": "kvstore", "gpu": smi, "part": "d", **part_d})
    finally:
        os.environ.pop("MXNET_CACHED_STEP", None)
    # (e) ShardedEmbedding over KV_SHARDS in-process servers
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "kv_ckpt")
    names = ("embedding.rows_pulled", "embedding.rows_pushed",
             "embedding.sparse_bytes", "embedding.dense_equiv_bytes",
             "embedding.cache_hits", "comm.sparse.bytes")
    before = {n: telemetry.counter(n).value for n in names}
    t1 = time.perf_counter()
    table = ShardedEmbedding("row", VOCAB, DIM, num_shards=KV_SHARDS,
                             seed=0, hot_rows=VOCAB)
    init_s = time.perf_counter() - t1
    try:
        table.set_optimizer(mx.optimizer.SGD(learning_rate=LR))
        flat = ids.reshape(-1)
        t1 = time.perf_counter()
        rows = table.pull_rows(flat, device=DEV)
        torch.cuda.synchronize()
        pull_ms = (time.perf_counter() - t1) * 1e3
        hits0 = telemetry.counter("embedding.cache_hits").value
        t1 = time.perf_counter()
        again = table.pull_rows(flat, device=DEV)
        torch.cuda.synchronize()
        hot_pull_ms = (time.perf_counter() - t1) * 1e3
        hits = telemetry.counter("embedding.cache_hits").value - hits0
        t1 = time.perf_counter()
        table.push_grad(g.indices, g.data)
        push_ms = (time.perf_counter() - t1) * 1e3
        if not (rows.is_cuda and torch.equal(rows, again)
                and rows.shape == (BATCH * SEQ, DIM) and hits == uniq):
            failures.append(f"kvstore (e): rows on {rows.device}, hits "
                            f"{hits} of {uniq}")
        moved = {n: telemetry.counter(n).value - before[n] for n in names}
        full = table.dump()
        t1 = time.perf_counter()
        table.save_checkpoint(root, block=True)
        save_s = time.perf_counter() - t1
        with ShardedEmbedding("row", VOCAB, DIM, num_shards=KV_SHARDS + 1,
                              seed=1) as other:
            t1 = time.perf_counter()
            other.load_checkpoint(root)
            load_s = time.perf_counter() - t1
            restored = bool(onp.array_equal(other.dump(), full))
        if not restored:
            failures.append("kvstore (e): the table saved at 2 shards did "
                            "not restore bitwise at 3")
    finally:
        table.close()
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    part_e = {"shards": KV_SHARDS, "table": [VOCAB, DIM],
              "init_s": init_s, "host_ms": {"pull_to_card": pull_ms,
                                            "pull_hot": hot_pull_ms,
                                            "push_rows": push_ms},
              "counters": moved,
              "wire_ratio": moved["embedding.sparse_bytes"]
              / moved["embedding.dense_equiv_bytes"],
              "cache_hits_repeated_batch": hits, "unique_ids": uniq,
              "checkpoint_s": {"save_2_shards": save_s,
                               "load_3_shards": load_s},
              "restored_bitwise_at_3": restored}
    emit({"phase": "kvstore", "gpu": smi, "part": "e", **part_e})
    emit({"phase": "kvstore", "gpu": smi, "part": "summary",
          "group": group, "failures": failures,
          "phase_s": time.perf_counter() - t0})
    del g, runs
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    if failures:
        raise AssertionError(f"kvstore: {failures}")
    return counts


DPR_STEPS = 10              # (a), (c): replays a trainer, after its warm step
DPR_SHARDS = 4              # (b): folded shards of the 256-image batch
DPR_BN_SHAPES = ((64, 112, 112), (2048, 7, 7))   # ResNet-50's stem, last
DPR_BN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}    # relative L2
DPR_STAGES = (0, 3)         # (c): ZeRO stages
DPR_REPS = 2                # (a): timed runs of each window, in turns


def dpr_rel_l2(torch, a, b):
    """||a - b|| / ||b|| in f64 on the card (``rel_l2`` without the host
    copies of the stem's 205M-element tensors)."""
    a, b = a.detach().double(), b.detach().double()
    nb = float(b.norm())
    return float((a - b).norm()) / nb if nb else float((a - b).norm())


def dpr_headline(torch, mesh, smi, failures):
    """Phase 26 (a): bench.py's meshed ResNet-50 row at one rank against
    the unmeshed trainer from the same weights, cuDNN deterministic (an
    algorithm that adds with atomics would part two runs of one
    trainer): bitwise state after a warm step and 10 replays, img/s by
    the slope in turns, NCCL kernels a step, peak memory."""
    t0 = time.perf_counter()
    data, label = resnet_batch(torch, RESNET_BATCH)
    torch.backends.cudnn.deterministic = True
    try:
        trainers = {
            "unmeshed": resnet_trainer(torch, resnet_net(torch, DEV),
                                       dtype="bfloat16"),
            "meshed": resnet_trainer(torch, resnet_net(torch, DEV),
                                     dtype="bfloat16", mesh=mesh)}
        losses, peak = {}, {}
        for name, tr in trainers.items():
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            losses[name] = [float(tr.step(data, label))
                            for _ in range(1 + DPR_STEPS)]
            step_graph(tr)
            peak[name] = torch.cuda.max_memory_allocated() - base
        a, b = (resnet_state(trainers[k]) for k in ("unmeshed", "meshed"))
        diff = [k for k in a if not torch.equal(a[k], b[k])]
        stats = [k for k in a if k.endswith(("running_mean", "running_var"))]
        bitwise = losses["unmeshed"] == losses["meshed"] and not diff
        if not bitwise:
            failures.append(f"(a) meshed ResNet-50 differs from the "
                            f"unmeshed: losses {losses}; state {diff[:6]} "
                            f"({len(diff)} tensors)")
        if not all(onp.isfinite(losses["meshed"])) or \
                not losses["meshed"][-1] < losses["meshed"][0]:
            failures.append(f"(a) losses not finite and falling: "
                            f"{losses['meshed']}")

        def window(tr):
            def run(n):
                tr.run_steps(data, label, n)._data.cpu()
            return run

        runs = {k: window(tr) for k, tr in trainers.items()}
        n1, n2, reps = WINDOWS[0], WINDOWS[1], DPR_REPS
        for run in runs.values():
            run(n1)
            run(n2)
        took = {k: {n1: [], n2: []} for k in runs}
        for _ in range(reps):
            for k, run in runs.items():
                for n in (n1, n2):
                    w0 = time.perf_counter()
                    run(n)
                    took[k][n].append(time.perf_counter() - w0)
        rate = {}
        for k, t in took.items():
            slope = max((min(t[n2]) - min(t[n1])) / (n2 - n1), 1e-9)
            rate[k] = {"img_per_s": RESNET_BATCH / slope,
                       "step_ms": slope * 1e3,
                       "window_s": {str(n1): min(t[n1]),
                                    str(n2): min(t[n2])}}
        prof = {}
        for k, tr in trainers.items():
            _, busy, _, per = profiled(
                torch, lambda tr=tr: float(tr.step(data, label)), 3,
                count=("nccl",))
            prof[k] = {"device_busy_ms": busy, "nccl_kernels_per_step":
                       per["nccl"], "kernels_per_step": per["kernels"]}
        if prof["meshed"]["nccl_kernels_per_step"]:
            failures.append(f"(a) {prof['meshed']['nccl_kernels_per_step']}"
                            f" NCCL kernels a step at one rank")
    finally:
        torch.backends.cudnn.deterministic = False
    row = {"phase": "dp_resnet", "gpu": smi, "part": "a",
           "model": {"net": "resnet50_v1", "classes": 1000,
                     "image": RESNET_IMAGE, "batch": RESNET_BATCH,
                     "dtype": "bfloat16", "optimizer": "sgd", **RESNET_SGD,
                     "mesh": dict(mesh.shape), "cudnn_deterministic": True},
           "steps": f"1 warm + {DPR_STEPS} replays each",
           "losses_first_last": {k: [v[0], v[-1]] for k, v in losses.items()},
           "bitwise_equal_to_unmeshed": bitwise,
           "state_tensors": len(a), "running_statistics": len(stats),
           "rate": rate, "meshed_over_unmeshed_img_per_s":
               rate["meshed"]["img_per_s"] / rate["unmeshed"]["img_per_s"],
           "profile": prof, "peak_bytes_over_base": peak,
           "phase_s": time.perf_counter() - t0}
    emit(row)
    del trainers, runs, a, b, data, label
    gc.collect()
    torch.cuda.empty_cache()
    return row


def dpr_bn_plain(torch, x, gamma, beta, dy, eps, acc):
    """BatchNorm's forward and backward in ``acc`` by autograd over torch
    ops: (out, mean, var, dx, dgamma, dbeta)."""
    x = x.to(acc).requires_grad_()
    g = gamma.to(acc).requires_grad_()
    b = beta.to(acc).requires_grad_()
    dims = [0, 2, 3]
    mean = x.mean(dim=dims)
    var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=dims)
    out = (x - mean.view(1, -1, 1, 1)) * torch.rsqrt(
        var + eps).view(1, -1, 1, 1) * g.view(1, -1, 1, 1) + \
        b.view(1, -1, 1, 1)
    dx, dg, db = torch.autograd.grad(out, [x, g, b], dy.to(acc))
    return out, mean, var, dx, dg, db


def dpr_folded_bn(torch, smi, failures):
    """Phase 26 (b): ``sync_batch_norm`` folded over DPR_SHARDS shards of
    the 256-image batch against the unsplit ``batch_norm`` and the plain
    version, at ResNet-50's stem and last stage, fp32 and bf16."""
    from mxnet_tpu_torch.ops.nn import batch_norm, sync_batch_norm
    from mxnet_tpu_torch.parallel.collectives import FoldedReducer
    t0 = time.perf_counter()
    k, eps, m = DPR_SHARDS, 1e-5, 0.9
    rows = []
    for c, h, w in DPR_BN_SHAPES:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            g = torch.Generator(device=DEV).manual_seed(c)
            shape = (RESNET_BATCH, c, h, w)
            x = (torch.randn(shape, generator=g, device=DEV) * 1.5 + 0.3).to(dt)
            dy = torch.randn(shape, generator=g, device=DEV).to(dt)
            gamma = (torch.rand(c, generator=g, device=DEV) + 0.5).to(dt)
            beta = torch.randn(c, generator=g, device=DEV).to(dt)

            def folded():
                xs = x.view((k, RESNET_BATCH // k) + shape[1:]) \
                    .detach().requires_grad_()
                ga = gamma.detach().requires_grad_()
                be = beta.detach().requires_grad_()
                out, mean, var = sync_batch_norm(
                    xs, ga, be, FoldedReducer(k), eps=eps, fix_gamma=False)
                dx, dg, db = torch.autograd.grad(out, [xs, ga, be],
                                                 dy.view(xs.shape))
                return out.reshape(shape), mean, var, dx.reshape(shape), \
                    dg, db

            def unsplit():
                xs = x.detach().requires_grad_()
                ga = gamma.detach().requires_grad_()
                be = beta.detach().requires_grad_()
                out, mean, var = batch_norm(
                    xs, ga, be, None, None, eps=eps, fix_gamma=False,
                    use_batch_stats=True)
                dx, dg, db = torch.autograd.grad(out, [xs, ga, be], dy)
                return out, mean, var, dx, dg, db

            def with_updates(res):
                # both running statistics' updates from (0, 1)
                out, mean, var, dx, dg, db = res
                return {"out": out, "running_mean": mean * (1 - m),
                        "running_var": m + var * (1 - m), "dx": dx,
                        "dgamma": dg, "dbeta": db}

            got = with_updates(folded())
            refs = {"unsplit": with_updates(unsplit()),
                    "plain": with_updates(dpr_bn_plain(
                        torch, x, gamma, beta, dy, eps,
                        torch.float64 if dtype == "float32"
                        else torch.float32))}
            tol = DPR_BN_TOL[dtype]
            errs = {}
            for ref_name, ref in refs.items():
                errs[ref_name] = {}
                for name, t in got.items():
                    e = dpr_rel_l2(torch, t, ref[name])
                    errs[ref_name][name] = e
                    if not e <= tol:
                        failures.append(f"(b) {shape} {dtype} {name} vs "
                                        f"{ref_name}: relative L2 {e} > "
                                        f"{tol}")
            del got, refs
            ms, events, kernels = {}, {}, {}
            for name, fn in (("folded", folded), ("unsplit", unsplit)):
                def call(fn=fn):
                    fn()
                    torch.cuda.synchronize()
                _, ms[name], _, per = profiled(torch, call, 5, count=())
                kernels[name] = per["kernels"]
                # CUDA events beside the profile: a trace that loses
                # kernel events reads short
                events[name] = device_ms(torch, fn, runs=10)
            rows.append({"shape": list(shape), "dtype": dtype, "shards": k,
                         "tolerance_rel_l2": tol, "rel_l2": errs,
                         "fwd_bwd_device_ms": ms,
                         "fwd_bwd_event_ms": events,
                         "kernels_per_call": kernels})
            del x, dy, gamma, beta
            gc.collect()
            torch.cuda.empty_cache()
    emit({"phase": "dp_resnet", "gpu": smi, "part": "b",
          "tf32": torch.backends.cudnn.allow_tf32
          or torch.backends.cuda.matmul.allow_tf32,
          "plain_version": "torch ops under autograd, f64 (fp32 inputs) "
                           "or f32 (bf16 inputs)", "cases": rows,
          "phase_s": time.perf_counter() - t0})
    return rows


def dpr_specs(torch, fa_mod, mesh, smi, failures):
    """Phase 26 (c): the training row with the embedding spec'd P("dp",
    None) and the FFN weights P(("dp", "tp"), None) at ZeRO 0 and 3,
    against the unmeshed trainer: losses bitwise, K1-K3 8 launches a
    replayed step, no plain call."""
    from mxnet_tpu_torch.parallel import PartitionSpec as P
    t0 = time.perf_counter()
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    data, label = train_batch(torch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    plain = train_trainer(torch, dist_lm(torch))
    plain_losses, _, _ = dist_run(torch, fns, plain, data, label, base)
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    rows, launched = [], {f.__name__: 0 for f in fns}
    for stage in DPR_STAGES:
        net = dist_lm(torch)
        specs = {}
        for key, p in net.collect_params().items():
            if key == "embed.weight":
                p.shard(P("dp", None))
            elif key.endswith(("ffn1.weight", "ffn2.weight")):
                p.shard(P(("dp", "tp"), None))
            else:
                continue
            specs[key] = repr(p._sharding)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        trainer = train_trainer(torch, net, mesh=mesh, zero_stage=stage)
        losses, counts, peak = dist_run(torch, fns, trainer, data, label,
                                        base)
        for name, c in counts.items():
            launched[name] += c["launches"]
            if c["launches"] != LAYERS * DPR_STEPS or c["plain_calls"]:
                failures.append(f"(c) zero {stage}: {name} launched "
                                f"{c['launches']} times in {DPR_STEPS} "
                                f"replayed steps ({c['plain_calls']} plain)")
        if losses != plain_losses:
            failures.append(f"(c) zero {stage}: losses {losses} differ from "
                            f"the unmeshed {plain_losses}")
        rows.append({"zero_stage": stage, "specs": len(specs),
                     "spec_examples": sorted(set(specs.values())),
                     "losses_first_last": [losses[0], losses[-1]],
                     "bitwise_equal_to_unmeshed": losses == plain_losses,
                     "launches_per_step": {k: v["launches"] / DPR_STEPS
                                           for k, v in counts.items()},
                     "peak_bytes_replays_over_base": peak})
        del trainer, net
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "dp_resnet", "gpu": smi, "part": "c",
          "mesh": dict(mesh.shape), "model": {"vocab": VOCAB, "units": DIM,
                                              "layers": LAYERS,
                                              "batch": BATCH, "seq": SEQ,
                                              "dtype": "bfloat16",
                                              "optimizer": "adam", "lr": LR},
          "unmeshed_losses_first_last": [plain_losses[0], plain_losses[-1]],
          "stages": rows, "phase_s": time.perf_counter() - t0})
    return launched


def phase_dp_resnet(torch, fa_mod, smi):
    """Phase 26: whole-batch BatchNorm over dp, parameter specs over
    every mesh axis (see the module docstring), on one rank over NCCL."""
    import torch.distributed as dist
    from mxnet_tpu_torch.parallel import make_mesh
    t0 = time.perf_counter()
    failures = []
    mesh = make_mesh({"dp": -1})           # a group of one over NCCL
    group = {"backend": dist.get_backend(), "world": dist.get_world_size()}
    if group != {"backend": "nccl", "world": 1}:
        raise AssertionError(f"dp_resnet: expected a group of one over "
                             f"NCCL, got {group}")
    try:
        dpr_headline(torch, mesh, smi, failures)
        dpr_folded_bn(torch, smi, failures)
        launched = dpr_specs(torch, fa_mod,
                             make_mesh({"dp": -1, "tp": 1}), smi, failures)
    finally:
        dist.destroy_process_group()
    emit({"phase": "dp_resnet", "gpu": smi, "part": "summary",
          "group": group, "failures": failures,
          "phase_s": time.perf_counter() - t0})
    if failures:
        raise AssertionError(f"dp_resnet: {failures}")
    return {k: {"launches": v} for k, v in launched.items()}


# -- the vision zoo (slice 20) ------------------------------------------------------

# bench.py's TRAIN_PARITY_GRID and INFER_PARITY_GRID (bench.py:81-90):
# (zoo name, batch, image); their V100 anchors are not this card's
ZOO_TRAIN = (("inceptionv3", 128, 299), ("alexnet", 512, 224))
ZOO_INFER = (("resnet152_v1", 128, 224), ("inceptionv3", 128, 299),
             ("vgg16", 64, 224), ("alexnet", 256, 224))
ZOO_PARITY = ("squeezenet1_1", "densenet121", "mobilenet_v2_1_0")
ZOO_PARITY_BATCH = 32
ZOO_RNG_BATCH = 64                # part (b): AlexNet at 224²


def zoo_net(torch, name, image, seed=0, device=None):
    """``get_model(name, classes=1000)``, Xavier weights from
    ``mx.random``'s host generator seeded with ``seed`` (the same
    weights on any device), deferred dims filled by one eval forward."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    device = device or DEV
    net = get_model(name, classes=1000)
    mx.random.seed(seed)
    net.initialize(init=mx.initializer.Xavier(), device=device)
    with torch.no_grad():
        net(torch.zeros((1, 3, image, image), device=device))
    return net


def zoo_batch(torch, batch, image, seed=0):
    g = torch.Generator(device=DEV).manual_seed(seed)
    data = torch.randn((batch, 3, image, image), generator=g, device=DEV)
    label = torch.randint(0, 1000, (batch,), generator=g,
                          device=DEV).float()
    return data, label


def zoo_trainer(torch, net, mesh=None, lr=None, wd=None):
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer
    opt = dict(RESNET_SGD)
    if lr is not None:
        opt["learning_rate"] = lr
    if wd is not None:
        opt["wd"] = wd
    kw = {"mesh": mesh} if mesh is not None else {"device": DEV}
    return SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="sgd",
                       optimizer_params=opt, **kw)


def zoo_train_rows(torch, mesh, smi):
    """(a): bench.py's training grid."""
    rows = {}
    for name, batch, image in ZOO_TRAIN:
        t0 = time.perf_counter()
        trainer = zoo_trainer(torch, zoo_net(torch, name, image), mesh)
        data, label = zoo_batch(torch, batch, image)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        w0 = time.perf_counter()
        losses = [float(trainer.step(data, label))]
        warm_s = time.perf_counter() - w0
        step_graph(trainer)

        def run(n):
            losses.extend(float(v) for v in
                          trainer.run_steps(data, label, n)._data.cpu())

        slope, t1, t2 = marginal(run)
        if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"vision_zoo {name}: losses not finite "
                                 f"and falling: {losses[:3]} ... "
                                 f"{losses[-3:]}")
        rows[name] = {"batch": batch, "image": image, "dtype": "float32",
                      "img_per_s": batch / slope, "step_ms": slope * 1e3,
                      "window_s": {str(WINDOWS[0]): t1,
                                   str(WINDOWS[1]): t2},
                      "warmup_s": warm_s, "captures": trainer.compiles,
                      "losses_first_last": [losses[0], losses[-1]],
                      "losses_steps": len(losses),
                      "max_allocated_bytes": torch.cuda.max_memory_allocated(),
                      "row_s": time.perf_counter() - t0}
        emit({"phase": "vision_zoo", "part": "train", "gpu": smi,
              "model": name, **rows[name]})
        del trainer, data, label
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def zoo_state(trainer):
    return {k: t.clone() for k, t in resnet_state(trainer).items()}


def kept_fractions(torch, trainer, net, data, label):
    """Each Dropout's kept fraction in one eager step: outputs kept over
    inputs non-zero, from forward hooks."""
    from mxnet_tpu_torch.gluon import nn
    seen = []

    def hook(block, inputs, out):
        nz = int((inputs[0] != 0).sum())
        seen.append((int((out != 0).sum()), nz))

    handles = [b.register_forward_hook(hook) for b in net.modules()
               if isinstance(b, nn.Dropout)]
    try:
        trainer._step_eager(data, label)
    finally:
        for h in handles:
            h.detach()
    return seen


def zoo_rng_checks(torch, smi, failures, tmpdir):
    """(b): randomness under capture on AlexNet."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.imperative import cached_step
    t0 = time.perf_counter()
    out = {}
    image, batch = 224, ZOO_RNG_BATCH
    data, label = zoo_batch(torch, batch, image, seed=1)
    torch.backends.cudnn.deterministic = True
    try:
        def fresh(lr=0.01, **kw):
            # lr 0.01: at bench.py's 0.05 AlexNet diverges within a few
            # steps of a small batch, and a NaN equals nothing
            return zoo_trainer(torch, zoo_net(torch, "alexnet", image,
                                              seed=1), lr=lr, **kw)

        captured, again, eager = fresh(), fresh(), fresh()
        runs = {}
        for key, tr, fn in (("captured", captured, "step"),
                            ("captured_again", again, "step"),
                            ("eager", eager, "_step_eager")):
            mx.random.seed(7)
            runs[key] = ([float(getattr(tr, fn)(data, label))
                          for _ in range(4)], zoo_state(tr))
        step_graph(captured)
        for key in ("eager", "captured_again"):
            diff = [k for k, t in runs["captured"][1].items()
                    if not torch.equal(t, runs[key][1][k])]
            same = runs["captured"][0] == runs[key][0] and not diff
            out[f"replay_vs_{key}_bitwise"] = same
            if not same:
                failures.append(f"captured vs {key}: losses "
                                f"{runs['captured'][0]} vs {runs[key][0]}, "
                                f"state {diff[:4]}")
        out["losses_captured"] = runs["captured"][0]
        # a checkpoint after the 4 steps, a fifth step, the load, the
        # fifth again: the same mask, so the same bits
        captured.save_checkpoint(tmpdir, block=True)
        fifth = float(captured.step(data, label))
        after = zoo_state(captured)
        mx.random.seed(99)
        captured.load_checkpoint(tmpdir)
        again5 = float(captured.step(data, label))
        diff = [k for k, t in zoo_state(captured).items()
                if not torch.equal(t, after[k])]
        out["checkpoint_resume_bitwise"] = again5 == fifth and not diff
        if not out["checkpoint_resume_bitwise"]:
            failures.append(f"checkpoint resume: {again5} vs {fifth}, "
                            f"state {diff[:4]}")
        if captured.compiles != 1:
            failures.append(f"{captured.compiles} captures for one "
                            f"signature")
        del captured, again, eager, runs, after
        gc.collect()
        # at lr 0 and wd 0 the weights stay: only the masks part losses
        still = fresh(lr=0.0, wd=0.0)
        steps = [float(still.step(data, label)) for _ in range(3)]
        window = [float(v) for v in still.run_steps(data, label, 3)
                  ._data.cpu()]
        out["lr0_losses"] = {"steps": steps, "run_steps": window}
        if len(set(steps + window)) != 6:
            failures.append(f"replays at lr 0 repeat a loss (a mask baked "
                            f"into the graph?): {steps} {window}")
        kept = kept_fractions(torch, still, still.net, data, label)
        out["dropout_kept"] = []
        for k, n in kept:
            frac, sigma = k / n, (0.25 / n) ** 0.5
            out["dropout_kept"].append({"kept": k, "inputs_non_zero": n,
                                        "fraction": frac, "sigma": sigma})
            if abs(frac - 0.5) > 5 * sigma:
                failures.append(f"Dropout kept {frac} of {n}, beyond 5σ "
                                f"({sigma}) of 0.5")
        if len(kept) != 2:
            failures.append(f"{len(kept)} Dropout calls in AlexNet's step")
        del still
        gc.collect()
        out["cached_step"] = zoo_cached_step(torch, mx, cached_step, data,
                                             label, failures)
    finally:
        torch.backends.cudnn.deterministic = False
    out["part_s"] = time.perf_counter() - t0
    emit({"phase": "vision_zoo", "part": "randomness", "gpu": smi,
          "model": "alexnet", "batch": batch, "image": image, **out})
    torch.cuda.empty_cache()
    return out


def zoo_cached_step(torch, mx, cached_step, data, label, failures):
    """The eager Gluon loop on AlexNet, 4 steps with the whole-step
    capture and 4 without, from the same weights and seed."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    x, y = mx.nd.array(data), mx.nd.array(label)
    loss_fn = SoftmaxCrossEntropyLoss()

    def run(env):
        os.environ["MXNET_CACHED_STEP"] = env
        try:
            net = zoo_net(torch, "alexnet", 224, seed=1)
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.01,
                                   "momentum": 0.9}, kvstore=None)
            mx.random.seed(5)
            for _ in range(4):
                with mx.autograd.record():
                    loss = loss_fn(net(x), y)
                loss.backward()
                tr.step(data.shape[0])
            torch.cuda.synchronize()
            return ({k: p.data()._data.detach().clone()
                     for k, p in net.collect_params().items()},
                    cached_step.trainer_state(tr))
        finally:
            os.environ.pop("MXNET_CACHED_STEP", None)

    got, state = run("1")
    want, _ = run("0")
    row = {"steps": 4, "captures": state["captures"],
           "breaks": state["breaks"], "last_reason": state["last_reason"],
           "bitwise_equal_eager": all(torch.equal(got[k], want[k])
                                      for k in got)}
    if not (row["bitwise_equal_eager"] and state["captures"] == 1
            and state["breaks"] == 0):
        failures.append(f"cached_step on AlexNet: {row}")
    return row


def zoo_infer_rows(torch, smi, failures):
    """(c): bench.py's inference grid, fp32 and bf16."""
    rows = {}
    for name, batch, image in ZOO_INFER:
        t0 = time.perf_counter()
        net = zoo_net(torch, name, image)
        g = torch.Generator(device=DEV).manual_seed(0)
        x32 = torch.randn((batch, 3, image, image), generator=g, device=DEV)
        row, logits = {}, {}
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
            row[dtype] = {"img_per_s": batch / slope,
                          "forward_ms": slope * 1e3,
                          "window_s": {str(WINDOWS[0]): t1,
                                       str(WINDOWS[1]): t2}}
        scale = float(logits["float32"].abs().max())
        err = float((logits["bfloat16"] - logits["float32"]).abs().max())
        ok = bool(torch.isfinite(logits["bfloat16"]).all()) and \
            err <= 2e-2 * scale
        if not ok:
            failures.append(f"{name}: bf16 logits vs fp32 max |err| {err} "
                            f"beyond 2e-2 x {scale}")
        rows[name] = {"batch": batch, "image": image, "rows": row,
                      "bf16_vs_fp32_logits": {"max_abs_err": err,
                                              "max_abs_ref": scale},
                      "row_s": time.perf_counter() - t0}
        emit({"phase": "vision_zoo", "part": "infer", "gpu": smi,
              "model": name, "tf32": False, **rows[name]})
        del net, x32, logits
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def zoo_parity(torch, smi, failures):
    """(d): three more families on the card against the CPU in f64, and
    one training step each."""
    rows = {}
    for name in ZOO_PARITY:
        t0 = time.perf_counter()
        net = zoo_net(torch, name, 224)
        host = zoo_net(torch, name, 224, device="cpu")
        host.cast("float64")
        g = torch.Generator(device=DEV).manual_seed(2)
        x = torch.randn((ZOO_PARITY_BATCH, 3, 224, 224), generator=g,
                        device=DEV)
        with torch.no_grad():
            got = net(x)
            want = host(x.double().cpu())
        err = rel_l2(got, want)
        if not (bool(torch.isfinite(got).all()) and err <= 1e-4):
            failures.append(f"{name}: card vs CPU f64 relative L2 {err}")
        trainer = zoo_trainer(torch, net)
        label = torch.randint(0, 1000, (ZOO_PARITY_BATCH,), generator=g,
                              device=DEV).float()
        loss = float(trainer.step(x, label))
        if not onp.isfinite(loss):
            failures.append(f"{name}: training step loss {loss}")
        rows[name] = {"batch": ZOO_PARITY_BATCH, "image": 224,
                      "card_vs_cpu_f64_rel_l2": err, "tolerance": 1e-4,
                      "step_loss": loss, "row_s": time.perf_counter() - t0}
        emit({"phase": "vision_zoo", "part": "parity", "gpu": smi,
              "model": name, **rows[name]})
        del net, host, trainer, x
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def phase_vision_zoo(torch, smi):
    """Phase 27: the rest of bench.py's parity grids and the randomness
    of a captured step (see the module docstring)."""
    import shutil
    import tempfile
    import torch.distributed as dist
    from mxnet_tpu_torch.parallel import make_mesh
    t0 = time.perf_counter()
    failures = []
    mesh = make_mesh({"dp": -1})           # a group of one over NCCL
    tmpdir = tempfile.mkdtemp(prefix="zoo_ckpt_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        train = zoo_train_rows(torch, mesh, smi)
        rng = zoo_rng_checks(torch, smi, failures, tmpdir)
        infer = zoo_infer_rows(torch, smi, failures)
        parity = zoo_parity(torch, smi, failures)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()
    emit({"phase": "vision_zoo", "part": "summary", "gpu": smi,
          "train_img_per_s": {k: v["img_per_s"] for k, v in train.items()},
          "infer_img_per_s": {k: {d: r["img_per_s"] for d, r in
                                  v["rows"].items()}
                              for k, v in infer.items()},
          "replay_vs_eager_bitwise": rng.get("replay_vs_eager_bitwise"),
          "parity_rel_l2": {k: v["card_vs_cpu_f64_rel_l2"]
                            for k, v in parity.items()},
          "failures": failures, "phase_s": time.perf_counter() - t0})
    if failures:
        raise AssertionError(f"vision_zoo: {failures}")


# -- phase 28: the symbol and deployment path ---------------------------------

EXPORT_BATCHES = (1, 8, 128)      # ResNet-50's exported signatures
EXPORT_LM_BATCHES = (1, 8)        # the LM's, at EXPORT_LM_SEQ tokens
EXPORT_LM_SEQ = 512
EXPORT_BIND_BATCH = 64            # (c): simple_bind of the traced graph
EXPORT_WINDOWS = (2, 8, 2)        # img/s at 128 by the slope


def export_inputs(batch, seed=7):
    """(batch, 3, 224, 224) images from a seeded host generator."""
    return onp.random.RandomState(seed).randn(
        batch, 3, RESNET_IMAGE, RESNET_IMAGE).astype(onp.float32)


def export_lm_ids(batch, seed=8):
    return onp.random.RandomState(seed).randint(
        0, VOCAB, (batch, EXPORT_LM_SEQ)).astype(onp.int32)


def export_files(root):
    """What the exporting process writes and the importing one reads."""
    return {name: (os.path.join(root, f"{name}-symbol.json"),
                   os.path.join(root, f"{name}-0000.params"))
            for name in ("r50_float32", "r50_bfloat16", "r50_cpu", "lm")}


def export_exports(torch, root, first_written=None):
    """The exporting side of (a) and (b): ResNet-50 hybridized on the
    card at each batch of EXPORT_BATCHES in fp32, then cast to bf16 and
    again, each exported; the same net made on the CPU and exported
    there at batch 1 (imported on the card through
    ``move_to_device_pass``); the LM in bf16 at (1, 512) and (8, 512).
    ``first_written()`` is called once the fp32 export is on disk.
    Returns the seconds each export took."""
    from mxnet_tpu_torch.ndarray import NDArray
    seconds = {}
    x = export_inputs(max(EXPORT_BATCHES))
    net = resnet_net(torch, DEV)
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            net.cast("bfloat16")
        net.hybridize()                   # drops the other type's graphs
        for b in EXPORT_BATCHES:
            xb = torch.as_tensor(x[:b], device=DEV).to(getattr(torch, dtype))
            net(NDArray._wrap(xb))
        torch.cuda.synchronize()
        t = time.perf_counter()
        net.export(os.path.join(root, f"r50_{dtype}"))
        seconds[f"r50_{dtype}"] = time.perf_counter() - t
        if dtype == "float32" and first_written is not None:
            first_written()
    del net
    cpu = resnet_net(torch, "cpu")
    cpu.hybridize()
    cpu(NDArray._wrap(torch.as_tensor(x[:1])))
    t = time.perf_counter()
    cpu.export(os.path.join(root, "r50_cpu"))
    seconds["r50_cpu"] = time.perf_counter() - t
    del cpu
    lm = train_model(torch)
    lm.cast("bfloat16")
    lm.hybridize()
    ids = export_lm_ids(max(EXPORT_LM_BATCHES))
    for b in EXPORT_LM_BATCHES:
        lm(NDArray._wrap(torch.as_tensor(ids[:b], device=DEV)))
    torch.cuda.synchronize()
    t = time.perf_counter()
    lm.export(os.path.join(root, "lm"))
    seconds["lm"] = time.perf_counter() - t
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return seconds


def export_ctx(mx):
    """The context of DEV (the card; the CPU in a rehearsal)."""
    return mx.gpu(0) if DEV == "cuda" else mx.cpu()


def export_wait(root, timeout=600):
    """Until the exporting process has written every export."""
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(root, "exports.done")):
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("export child: the exports never came")
        time.sleep(0.05)


def export_child(torch, root):
    """The importing side, in a fresh process (``--export-child ROOT``):
    each export loaded on the card with ``SymbolBlock.imports``, held
    against the hybridized forward of the same net made here from the
    same seed (its parameters first checked bitwise against the loaded
    ``.params``), timed against it in turns, served, and the LM's K1
    launches counted.  Prints one JSON line."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.deterministic = True
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.ops import attention as fa_mod
    files = export_files(root)
    out = {"load_s": {}}
    loaded = {}
    for name, (sym_file, param_file) in files.items():
        if name != "r50_float32":
            # the exporting process writes the rest while this one
            # starts and loads the first
            export_wait(root)
        t = time.perf_counter()
        loaded[name] = SymbolBlock.imports(sym_file, ["data"], param_file,
                                           ctx=export_ctx(mx))
        out["load_s"][name] = time.perf_counter() - t
    x = export_inputs(max(EXPORT_BATCHES))

    def same_params(net, blk):
        mine = net.collect_params()
        return all(torch.equal(mine[k]._data, p._data)
                   for k, p in blk.collect_params().items())

    def fwd(block, xb):
        with torch.no_grad():
            return block(NDArray._wrap(xb))._data

    net = resnet_net(torch, DEV)
    net.hybridize()
    # the CPU's export, moved to the card, against the card's forward
    x1 = torch.as_tensor(x[:1], device=DEV)
    hyb, imp = fwd(net, x1), fwd(loaded["r50_cpu"], x1)
    out["r50_cpu"] = {
        "params_bitwise": same_params(net, loaded["r50_cpu"]),
        "max_abs_err": float((hyb - imp).abs().max()),
        "largest_logit": float(hyb.abs().max()),
        "moved_to": str(loaded["r50_cpu"]._device)}
    rows = {}
    for dtype in ("float32", "bfloat16"):
        if dtype == "bfloat16":
            net.cast("bfloat16")
        net.hybridize()
        blk = loaded[f"r50_{dtype}"]
        row = {"params_bitwise": same_params(net, blk), "batches": {}}
        for b in EXPORT_BATCHES:
            xb = torch.as_tensor(x[:b], device=DEV).to(getattr(torch, dtype))
            hyb, imp = fwd(net, xb).float(), fwd(blk, xb).float()
            scale = float(hyb.abs().max())
            row["batches"][str(b)] = {
                "bitwise": bool(torch.equal(hyb, imp)),
                "max_abs_err": float((hyb - imp).abs().max()),
                "max_rel_err": float(((hyb - imp).abs()
                                      / hyb.abs().clamp_min(1e-30)).max()),
                "largest_logit": scale}
        xb = torch.as_tensor(x, device=DEV).to(getattr(torch, dtype))
        rates = {"hybridized": [], "imported": []}
        for _ in range(2):                              # in turns
            for mode, block in (("hybridized", net), ("imported", blk)):
                def run(n, block=block):
                    for _ in range(n):
                        fwd(block, xb)
                    torch.cuda.synchronize()
                slope, _, _ = marginal(run, EXPORT_WINDOWS)
                rates[mode].append(xb.shape[0] / slope)
        row["img_per_s_at_128"] = rates
        rows[dtype] = row
    del net
    out["r50"] = rows
    out["serve"] = export_child_serve(torch, loaded["r50_float32"], x)
    out["lm"] = export_child_lm(torch, fa_mod, loaded["lm"], fwd,
                                same_params)
    emit(out)


def export_child_serve(torch, blk, x):
    """``ServingServer.predict`` over the imported fp32 block: its
    buckets are the exported batch sizes; 32 client threads x 8 calls on
    32 seeded images; each served row bitwise against the imported
    forward of a padded batch of its bucket holding the image."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ndarray import NDArray
    from mxnet_tpu_torch.serving import ServingServer
    srv = ServingServer(blk, batcher_args={"max_batch_size": 32,
                                           "max_delay_ms": 2,
                                           "queue_depth": 1024})
    images = list(x[:SERVE_CLIENTS])
    srv.warmup(list(EXPORT_BATCHES))
    served = {}
    lock = threading.Lock()

    def predict(img):
        got = srv.predict(img, timeout_ms=120000)
        with lock:
            served.setdefault(id(img), []).append(onp.asarray(got))
        return got

    recs = ServingRecords()
    telemetry.add_sink(recs)
    c0 = serving_counts(telemetry)
    lat, wall = closed_loop(predict, images, SERVE_CLIENTS, SERVE_CALLS)
    telemetry.remove_sink(recs)
    moved = counts_moved(c0, serving_counts(telemetry))
    srv.stop()
    summary = loop_summary(lat, wall, recs.records)
    bad = 0
    for img in images:
        refs = []
        for b in EXPORT_BATCHES:
            pad = onp.zeros((b,) + img.shape, onp.float32)
            pad[0] = img
            with torch.no_grad():
                refs.append(blk(NDArray._wrap(torch.as_tensor(
                    pad, device=DEV)))._data[0].cpu().numpy())
        for row in served[id(img)]:
            if not any(onp.array_equal(row, r) for r in refs):
                bad += 1
    summary.update({"rows_not_bitwise": bad, "buckets": list(
        EXPORT_BATCHES), "captures_while_serving":
        moved["compile.serving.count"],
        "eager_batches": moved["serving.eager_batches"]})
    return summary


def export_child_lm(torch, fa_mod, blk, fwd, same_params):
    """The LM's import: within 2e-2 of the largest logit of the
    hybridized forward at each exported batch, and K1's launches in one
    imported forward (counts zeroed just before, read just after)."""
    net = train_model(torch)
    net.cast("bfloat16")
    net.hybridize()
    ids = export_lm_ids(max(EXPORT_LM_BATCHES))
    row = {"params_bitwise": same_params(net, blk), "batches": {}}
    for b in EXPORT_LM_BATCHES:
        t = torch.as_tensor(ids[:b], device=DEV)
        hyb, imp = fwd(net, t).float(), fwd(blk, t).float()
        scale = float(hyb.abs().max())
        row["batches"][str(b)] = {
            "max_abs_err_over_largest": float((hyb - imp).abs().max())
            / scale, "largest_logit": scale}
    t = torch.as_tensor(ids[:1], device=DEV)
    fwd(blk, t)
    torch.cuda.synchronize()
    fa_mod.flash_fwd.launches = fa_mod.flash_fwd.plain_calls = 0
    fwd(blk, t)
    torch.cuda.synchronize()
    row["k1_launches_a_forward"] = fa_mod.flash_fwd.launches
    row["k1_plain_calls"] = fa_mod.flash_fwd.plain_calls
    return row


def export_bind(torch, root, smi, failures):
    """(c): ``mx.sym.trace`` of ResNet-50 fp32 on the card, then
    ``simple_bind`` at batch 64: the eval forward against the Gluon
    forward (rtol 1e-5), two eval replays bitwise against the eager
    graph, the training forward and backward's gradients against the
    Gluon net's autograd ones in inference mode (the traced graph's
    BatchNorm reads the running statistics; relative L2 1e-5 each), and
    ``save_checkpoint`` → ``load_checkpoint`` → bind bitwise."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import NDArray
    net = resnet_net(torch, DEV)
    x = torch.as_tensor(export_inputs(EXPORT_BIND_BATCH, seed=9),
                        device=DEV)
    t = time.perf_counter()
    sym, args, aux = mx.sym.trace(net, NDArray._wrap(x))
    trace_s = time.perf_counter() - t
    t = time.perf_counter()
    with export_ctx(mx):
        ex = sym.simple_bind(data=tuple(x.shape))
    ex.copy_params_from(args, aux)
    bind_s = time.perf_counter() - t
    out = ex.forward(is_train=False, data=NDArray._wrap(x))[0]._data
    with torch.no_grad():
        gluon = net(x)
    fwd_err = float(((out - gluon).abs() / (gluon.abs() + 1e-5
                                             * gluon.abs().max())).max())
    if fwd_err > 1e-5:
        failures.append(f"bind eval forward rel err {fwd_err}")
    replays = [ex.forward(is_train=False)[0]._data.clone()
               for _ in range(2)]
    eager = ex.eager()[0]
    replay_bitwise = all(torch.equal(r, eager) for r in replays)
    if not replay_bitwise:
        failures.append("bind eval replays differ from the eager graph")
    if ex.compiles != 1:
        failures.append(f"bind captured {ex.compiles} signatures")
    cot = torch.as_tensor(onp.random.RandomState(10).randn(
        *out.shape).astype(onp.float32), device=DEV)
    ex.forward(is_train=True)
    ex.backward(NDArray._wrap(cot))
    params = net.collect_params()
    leaves = [p._data for k, p in params.items() if k in args]
    for v in leaves:
        v.grad = None
    with torch.enable_grad():
        for v in leaves:
            v.requires_grad_(True)
        with mx.autograd.predict_mode():
            y = net(x)
        grads = torch.autograd.grad((y * cot).sum(), leaves)
    worst = max(rel_l2(ex.grad_dict[k]._data, g)
                for k, g in zip([k for k in params if k in args], grads))
    if worst > 1e-5:
        failures.append(f"bind gradients rel L2 {worst}")
    prefix = os.path.join(root, "ckpt")
    mx.model.save_checkpoint(prefix, 1, sym, args, aux)
    with export_ctx(mx):
        sym2, args2, aux2 = mx.model.load_checkpoint(prefix, 1)
    ex2 = sym2.bind(args={**args2, "data": NDArray._wrap(x)},
                    aux_states=aux2)
    ckpt_bitwise = bool(torch.equal(ex2.forward()[0]._data, out))
    if not ckpt_bitwise:
        failures.append("checkpoint round trip not bitwise")
    return {"arguments": len(sym.list_arguments()),
            "aux_states": len(sym.list_auxiliary_states()),
            "trace_s": trace_s, "simple_bind_s": bind_s,
            "eval_max_rel_err": fwd_err,
            "eval_replays_bitwise": replay_bitwise,
            "grad_worst_rel_l2": worst, "checkpoint_bitwise": ckpt_bitwise,
            "gpu": smi}


def phase_export(torch, fa_mod, smi):
    """Phase 28: the symbol and deployment path (see the module
    docstring).  Returns K1's launches a forward of the imported LM."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    failures = []
    root = tempfile.mkdtemp(prefix="export_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    procs = []

    def start_child():
        # the importing process starts once the first export is written,
        # and loads it while this one writes the rest; (c) runs here
        # while it loads those (its timed part comes later)
        procs.append((time.perf_counter(), subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--export-child",
             root], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))

    try:
        export_s = export_exports(torch, root, start_child)
        open(os.path.join(root, "exports.done"), "w").close()
        emit({"phase": "export", "part": "exported", "gpu": smi,
              "export_s": export_s,
              "json_bytes": {k: os.path.getsize(v[0]) for k, v in
                             export_files(root).items()}})
        t, proc = procs[0]
        bind = export_bind(torch, root, smi, failures)
        stdout, stderr = proc.communicate(timeout=600)
        child_s = time.perf_counter() - t
        emit({"phase": "export", "part": "bind", **bind})
        if proc.returncode:
            raise AssertionError(f"export child failed:\n{stderr[-4000:]}")
        child = json.loads(stdout.strip().splitlines()[-1])
        export_gates(child, failures)
        emit({"phase": "export", "part": "imported", "gpu": smi,
              "child_s": child_s, **child})
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(root, ignore_errors=True)
        torch.backends.cudnn.deterministic = deterministic
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "export", "part": "summary", "gpu": smi,
          "failures": failures, "phase_s": time.perf_counter() - t0})
    if failures:
        raise AssertionError(f"export: {failures}")
    return {"flash_fwd": {
        "launches": child["lm"]["k1_launches_a_forward"]}}


def export_gates(child, failures):
    """(a) and (b)'s gates on what the importing process measured."""
    for dtype, row in child["r50"].items():
        if not row["params_bitwise"]:
            failures.append(f"r50 {dtype}: parameters differ")
        for b, r in row["batches"].items():
            if dtype == "float32" and r["max_rel_err"] > 1e-5 and \
                    r["max_abs_err"] > 1e-5 * r["largest_logit"]:
                failures.append(f"r50 fp32 batch {b}: {r}")
            if dtype == "bfloat16" and \
                    r["max_abs_err"] > 1e-2 * r["largest_logit"]:
                failures.append(f"r50 bf16 batch {b}: {r}")
    cpu = child["r50_cpu"]
    if not cpu["params_bitwise"] or \
            cpu["max_abs_err"] > 1e-5 * cpu["largest_logit"]:
        failures.append(f"r50 exported on the CPU: {cpu}")
    serve = child["serve"]
    if serve["rows_not_bitwise"] or serve["captures_while_serving"] or \
            serve["eager_batches"]:
        failures.append(f"serving the imported block: {serve}")
    lm = child["lm"]
    if not lm["params_bitwise"]:
        failures.append("lm: parameters differ")
    for b, r in lm["batches"].items():
        if r["max_abs_err_over_largest"] > 2e-2:
            failures.append(f"lm batch {b}: {r}")
    if lm["k1_launches_a_forward"] != LAYERS or lm["k1_plain_calls"]:
        failures.append(f"lm: K1 {lm['k1_launches_a_forward']} launches "
                        f"and {lm['k1_plain_calls']} plain calls a "
                        f"forward, want {LAYERS} and 0")


# -- phase 29: the recurrent family -------------------------------------------

RNN_T, RNN_N, RNN_H = 24, 20, 1500   # (a): the LM's bptt, batch and width
RNN_PROJ = 500                       # (a): LSTMP's H 1500 -> P 500
RNN_TOL = 1e-4                       # (a): cuDNN against the plain loop
RNN_CTC = (100, 32, 5000, 20)        # (a): CTC's T, N, C and L
# (a): CTC's loss and gradient against F.ctc_loss and the CPU: at a loss
# of ~800 the log-space exponents carry an f32 error of ~800·2^-23 ≈ 1e-4
# relative, which the gradients (exp of them) show
CTC_TOL = {"loss": 1e-5, "grad": 1e-3}
LM_VOCAB = 33278                     # (b): WikiText-2's vocabulary
LM_WIDTH, LM_LAYERS, LM_DROPOUT = 1500, 2, 0.65   # --emsize/--nhid 1500
LM_BATCH, LM_BPTT, LM_LR, LM_CLIP = 20, 24, 20.0, 2.0
LM_STEPS = 20                        # (b): steps on each path
LM_WINDOWS = 4                       # (b): bptt windows an epoch
LM_SEED = 0
LM_TOL = 1e-3                        # (b): loss rtol, cuDNN against plain
LM_INFER_CALLS = 50                  # (b): hybridized forwards timed


def synth_corpus(n_tokens, vocab, seed=0):
    """``examples/gluon/word_language_model.py:33``'s corpus (an order-2
    Markov chain over ``vocab`` tokens with 5% uniform noise), copied so
    that this script imports nothing of the reference package."""
    rng = onp.random.RandomState(seed)
    toks = onp.empty(n_tokens, onp.int64)
    toks[0], toks[1] = rng.randint(0, vocab, 2)
    noise = rng.rand(n_tokens) < 0.05
    for i in range(2, n_tokens):
        if noise[i]:
            toks[i] = rng.randint(0, vocab)
        else:
            toks[i] = (3 * toks[i - 1] + 5 * toks[i - 2] + 1) % vocab
    return toks


def batchify(tokens, batch_size):
    """The example's (T, N) time-major streams."""
    n = len(tokens) // batch_size
    return tokens[: n * batch_size].reshape(batch_size, n).T.copy()

def rnn_lm(vocab, embed=64, hidden=64, layers=2, dropout=0.2, tied=True):
    """The word-level LM of ``examples/gluon/word_language_model.py:58-88``
    on the port: Embedding -> Dropout -> ``rnn.LSTM`` (TNC) -> Dropout ->
    the decoder tied to the embedding through ``dot(..., transpose_b=
    True)`` (a ``Dense`` when untied).  ``forward(ids (T, N) int,
    states=None) -> (logits (T, N, vocab), [h, c])``."""
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn, rnn
    from mxnet_tpu_torch.ops import tensor as tensor_ops

    class RNNModel(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.tied = tied and embed == hidden
            self.embed = nn.Embedding(vocab, embed)
            self.drop = nn.Dropout(dropout)
            self.lstm = rnn.LSTM(hidden, num_layers=layers, layout="TNC",
                                 dropout=dropout)
            if not self.tied:
                self.decoder = nn.Dense(vocab, flatten=False)

        def forward(self, x, states=None):
            emb = self.drop(self.embed(x))
            if states is None:
                states = [torch.zeros(i["shape"], dtype=emb.dtype,
                                      device=emb.device)
                          for i in self.lstm.state_info(x.shape[1])]
            out, states = self.lstm(emb, states)
            out = self.drop(out)
            if self.tied:
                w = self.embed.weight._tensor()
                logits = tensor_ops.dot(out.reshape(-1, out.shape[-1]), w,
                                        transpose_b=True)
                logits = logits.reshape(out.shape[0], out.shape[1], -1)
            else:
                logits = self.decoder(out)
            return logits, states

        def begin_state(self, batch_size):
            return self.lstm.begin_state(batch_size)

    return RNNModel()


def rnn_lm_step(mx, net, loss_fn, trainer, x, y, states, batch, clip):
    """One step of the example's loop (``word_language_model.py:130-
    141``): detach the states by rewrapping them, forward and loss under
    ``record()``, backward, ``clip_global_norm`` over every gradient (a
    host float each step), ``trainer.step``.  Returns (loss NDArray,
    states, the pre-clip norm)."""
    from mxnet_tpu_torch.ndarray import NDArray
    if states is not None:
        states = [NDArray(s._data) for s in states]
    with mx.autograd.record():
        logits, states = net(x, states)
        loss = loss_fn(logits, y)
    loss.backward()
    norm = mx.gluon.utils.clip_global_norm(
        [p.grad() for p in net.collect_params().values()
         if p.grad_req != "null"], clip)
    trainer.step(batch)
    return loss, states, norm


def rel_err(a, b):
    """Largest ``|a − b| / (|b| + max|b|)`` (``test_torch_parity.close``'s
    measure), in f64 on the host."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    if b.numel() == 0:
        return 0.0
    scale = float(b.abs().max())
    return float(((a - b).abs() / (b.abs() + scale + 1e-300)).max())


def rnn_inputs(torch, mode, layers, bidir, proj, seed):
    """Seeded (x, flat, h0, c0 or None) on the card at the LM's widths,
    the flat vector at Xavier's scale of the LSTM's (6000, 1500)."""
    from mxnet_tpu_torch.ops import rnn as rnn_ops
    g = torch.Generator(device=DEV).manual_seed(seed)
    D = 2 if bidir else 1
    P = proj or RNN_H
    n = rnn_ops.rnn_param_size(mode, RNN_H, RNN_H, layers, bidir, proj)
    x = torch.randn(RNN_T, RNN_N, RNN_H, device=DEV, generator=g)
    flat = (torch.rand(n, device=DEV, generator=g) * 2 - 1) * 0.028
    h0 = 0.1 * torch.randn(layers * D, RNN_N, P, device=DEV, generator=g)
    c0 = (0.1 * torch.randn(layers * D, RNN_N, RNN_H, device=DEV,
                            generator=g) if mode == "lstm" else None)
    return [t for t in (x, flat, h0, c0) if t is not None]


def ragged_lengths(seed):
    """Seeded lengths in [0, T] for the batch: one row full, one empty."""
    lens = onp.random.RandomState(seed).randint(0, RNN_T + 1, RNN_N)
    lens[0], lens[-1] = RNN_T, 0
    return lens.tolist()


def rnn_case(torch, fn, inputs, extra, kw, cts=None):
    """``fn`` (``rnn`` or ``rnn_plain``) forward and backward: (outputs,
    gradients w.r.t. the float inputs, cotangents)."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    outs = fn(*ins, *extra, **kw)
    if cts is None:
        g = torch.Generator(device=DEV).manual_seed(99)
        cts = [torch.randn(o.shape, device=DEV, generator=g)
               for o in outs]
    grads = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(outs, cts)), ins)
    return [o.detach() for o in outs], list(grads), cts


def rnn_kernel_names(torch, fn):
    """Device kernels of one call of ``fn``, by name, and whether any is
    cuDNN's RNN (a name holding ``rnn`` or ``lstm``, any case)."""
    names = kernels_by_name(torch, fn, n=1)
    rnn_names = {k: v for k, v in names.items()
                 if "rnn" in k.lower() or "lstm" in k.lower()}
    return names, rnn_names


def rnn_parity(torch, smi, failures):
    """(a): every case cuDNN (``rnn``) against the plain loop
    (``rnn_plain``) on the card, fp32 with TF32 off."""
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.ops import rnn as rnn_ops
    cases = [("lstm", "lstm", 2, False, None, None, {}),
             ("gru", "gru", 2, False, None, None, {}),
             ("rnn_tanh", "rnn_tanh", 2, False, None, None, {}),
             ("rnn_relu", "rnn_relu", 2, False, None, None, {}),
             ("lstm_bidirectional", "lstm", 2, True, None, None, {}),
             ("lstmp", "lstm", 2, False, RNN_PROJ, None, {}),
             ("gru_bidirectional_lengths", "gru", 2, True, None,
              ragged_lengths(1), {}),
             ("lstm_lengths", "lstm", 2, False, None, ragged_lengths(2), {}),
             ("lstm_clip", "lstm", 2, True, None, None,
              dict(lstm_state_clip_min=-0.05, lstm_state_clip_max=0.05)),
             ("lstm_dropout", "lstm", 2, False, None, None, dict(p=0.65))]
    rows = {}
    for i, (name, mode, layers, bidir, proj, lengths, extra_kw) in \
            enumerate(cases):
        inputs = rnn_inputs(torch, mode, layers, bidir, proj, seed=100 + i)
        extra = ([torch.tensor(lengths, device=DEV)]
                 if lengths is not None else [])
        kw = dict(state_size=RNN_H, num_layers=layers, mode=mode,
                  bidirectional=bidir, state_outputs=True,
                  projection_size=proj,
                  use_sequence_length=lengths is not None, **extra_kw)
        mx_random.seed(7)
        f_out, f_grad, cts = rnn_case(torch, rnn_ops.rnn, inputs, extra, kw)
        mx_random.seed(7)
        p_out, p_grad, _ = rnn_case(torch, rnn_ops.rnn_plain, inputs, extra,
                                    kw, cts)
        err_out = max(rel_err(a, b) for a, b in zip(f_out, p_out))
        err_grad = max(rel_err(a, b) for a, b in zip(f_grad, p_grad))
        row = {"max_rel_err_outputs_states": err_out,
               "max_rel_err_grads": err_grad}
        if "p" in extra_kw:
            # the same generator state: the same masks on both paths
            row["zero_pattern_equal"] = bool(torch.equal(f_out[0] == 0,
                                                         p_out[0] == 0))
            if not row["zero_pattern_equal"]:
                failures.append(f"(a) {name}: dropout masks differ")
        if "lstm_state_clip_min" in extra_kw:
            row["c_max_abs"] = float(f_out[2].abs().max())
            if row["c_max_abs"] > 0.05 + 1e-7:
                failures.append(f"(a) {name}: c not clipped")
        if max(err_out, err_grad) > RNN_TOL or not all(
                torch.isfinite(t).all() for t in f_out + f_grad):
            failures.append(f"(a) {name}: rel err {err_out} / {err_grad} "
                            f"over {RNN_TOL}")
        ins = [t.detach().clone().requires_grad_(True) for t in inputs]

        def fused_call():
            outs = rnn_ops.rnn(*ins, *extra, **kw)
            torch.autograd.grad(sum((o * c).sum()
                                    for o, c in zip(outs, cts)), ins)

        def plain_call():
            outs = rnn_ops.rnn_plain(*ins, *extra, **kw)
            torch.autograd.grad(sum((o * c).sum()
                                    for o, c in zip(outs, cts)), ins)
        names, rnn_names = rnn_kernel_names(torch, fused_call)
        _, plain_rnn = rnn_kernel_names(torch, plain_call)
        if not rnn_names or plain_rnn:
            failures.append(f"(a) {name}: cuDNN RNN kernels {rnn_names} on "
                            f"the cuDNN path, {plain_rnn} on the plain one")
        row["cudnn_rnn_kernels"] = rnn_names
        row["fused_ms"] = device_ms(torch, fused_call, runs=10)
        row["plain_ms"] = device_ms(torch, plain_call, runs=10)
        rows[name] = row
        emit({"phase": "rnn", "part": "a", "case": name, "gpu": smi, **row})
    rows["lstm"]["compact_cost"] = rnn_compaction(torch, smi)
    return rows


def rnn_compaction(torch, smi):
    """The LM's LSTM forward and backward on views into the reference's
    flat layout (torch compacts them into cuDNN's buffer each call)
    against ``torch.nn.LSTM`` with its weights already in one buffer
    (``flatten_parameters``): device ms of each."""
    import warnings
    from mxnet_tpu_torch.ops import rnn as rnn_ops
    x, flat, h0, c0 = rnn_inputs(torch, "lstm", 2, False, None, seed=1)
    x.requires_grad_(True)
    flat.requires_grad_(True)
    kw = dict(state_size=RNN_H, num_layers=2, mode="lstm",
              state_outputs=True)
    lib = torch.nn.LSTM(RNN_H, RNN_H, num_layers=2).to(DEV)
    lib.flatten_parameters()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rnn_ops.rnn(x, flat, h0, c0, **kw)
    warned = [str(w.message)[:80] for w in caught
              if "contiguous" in str(w.message)]

    def ours():
        out = rnn_ops.rnn(x, flat, h0, c0, **kw)[0]
        torch.autograd.grad(out.sum(), [x, flat])

    def library():
        out = lib(x, (h0, c0))[0]
        torch.autograd.grad(out.sum(), [x] + list(lib.parameters()))
    row = {"views_ms": device_ms(torch, ours, runs=20),
           "flattened_library_ms": device_ms(torch, library, runs=20),
           "warning": warned[:1]}
    emit({"phase": "rnn", "part": "a", "case": "compaction", "gpu": smi,
          **row})
    return row


def ctc_parity(torch, smi, failures):
    """(a): CTC on the card (the reference's recursion in torch) against
    ``F.ctc_loss`` there (cuDNN's or torch's CUDA kernel) and against
    the same recursion on the CPU: loss and gradient."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import nn as nn_ops
    T, N, C, L = RNN_CTC
    g = torch.Generator(device=DEV).manual_seed(5)
    data = torch.randn(T, N, C, device=DEV, generator=g)
    rng = onp.random.RandomState(5)
    label = rng.randint(1, C, (N, L)).astype("f4")
    lens = rng.randint(L // 2, L + 1, N)
    for n in range(N):
        label[n, lens[n]:] = -1
    label_t = torch.from_numpy(label).to(DEV)
    x = data.clone().requires_grad_(True)
    ours = nn_ops.ctc_loss(x, label_t)
    g_ours, = torch.autograd.grad(ours.sum(), x)
    x2 = data.clone().requires_grad_(True)
    lib = F.ctc_loss(torch.log_softmax(x2, -1), label_t.clamp(min=0).long(),
                     torch.full((N,), T, dtype=torch.long),
                     torch.from_numpy(lens).long(), blank=0,
                     reduction="none")
    g_lib, = torch.autograd.grad(lib.sum(), x2)
    x3 = data.cpu().requires_grad_(True)
    cpu = nn_ops.ctc_loss(x3, label_t.cpu())
    g_cpu, = torch.autograd.grad(cpu.sum(), x3)
    row = {"vs_library_loss": rel_err(ours, lib),
           "vs_library_grad": rel_err(g_ours, g_lib),
           "vs_cpu_loss": rel_err(ours, cpu), "vs_cpu_grad": rel_err(g_ours,
                                                                    g_cpu)}
    if max(row["vs_library_loss"], row["vs_cpu_loss"]) > CTC_TOL["loss"] \
            or max(row["vs_library_grad"], row["vs_cpu_grad"]) > \
            CTC_TOL["grad"]:
        failures.append(f"(a) ctc: {row} over {CTC_TOL}")

    def ours_call():
        torch.autograd.grad(nn_ops.ctc_loss(x, label_t).sum(), x)

    def lib_call():
        out = F.ctc_loss(torch.log_softmax(x2, -1),
                         label_t.clamp(min=0).long(),
                         torch.full((N,), T, dtype=torch.long),
                         torch.from_numpy(lens).long(), reduction="none")
        torch.autograd.grad(out.sum(), x2)
    row["ms"] = device_ms(torch, ours_call, runs=10)
    row["library_ms"] = device_ms(torch, lib_call, runs=10)
    row["loss_mean"] = float(ours.detach().mean())
    emit({"phase": "rnn", "part": "a", "case": "ctc", "gpu": smi, **row})
    return row


LM_NAMES = ["embed.weight"] + [
    f"lstm.l{layer}_{k}" for layer in range(LM_LAYERS)
    for k in ("i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias")]


def lm_numpy_params(seed):
    """The LM's weights as the reference's ``{name: p.data().asnumpy()}``
    of ``examples/gluon/word_language_model.py``'s ``RNNModel`` (tied,
    2 layers at 1500) holds them: its names and shapes, Xavier-scaled
    values from a seeded numpy generator."""
    rng = onp.random.RandomState(seed)
    H = LM_WIDTH
    shapes = {"embed.weight": (LM_VOCAB, H)}
    for layer in range(LM_LAYERS):
        shapes[f"lstm.l{layer}_i2h_weight"] = (4 * H, H)
        shapes[f"lstm.l{layer}_h2h_weight"] = (4 * H, H)
        shapes[f"lstm.l{layer}_i2h_bias"] = (4 * H,)
        shapes[f"lstm.l{layer}_h2h_bias"] = (4 * H,)
    out = {}
    for name in LM_NAMES:
        shape = shapes[name]
        if name.endswith("bias"):
            out[name] = onp.zeros(shape, "f4")
        else:
            scale = (3.0 / ((shape[0] + shape[1]) / 2)) ** 0.5
            out[name] = rng.uniform(-scale, scale, shape).astype("f4")
    return out


def lm_run(torch, mx, cuda, path, params, data, smi):
    """20 steps of the example's loop on ``path`` (``"cudnn"``: the
    layer's torch call; ``"plain"``: its step loop) from ``params``, the
    generator seeded alike: losses, clip norms, tokens/s and the
    trainer's cached-step state."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.imperative import cached_step
    from mxnet_tpu_torch.ops import rnn as rnn_ops
    run_cells = rnn_ops.run_cells
    if path == "plain":
        rnn_ops.run_cells = rnn_ops.cells_plain
    try:
        net = rnn_lm(LM_VOCAB, LM_WIDTH, LM_WIDTH, LM_LAYERS, LM_DROPOUT)
        net.initialize(init=mx.initializer.Xavier(), device=DEV)
        net(torch.zeros(LM_BPTT, LM_BATCH, dtype=torch.int32,
                        device=DEV))
        convert.load_collected_params(net, params, device=DEV)
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": LM_LR})
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        mx.random.seed(LM_SEED + 1)
        losses, norms, states, t0 = [], [], None, None
        for step in range(LM_STEPS):
            if step == 5:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            t = (step % LM_WINDOWS) * LM_BPTT
            if step % LM_WINDOWS == 0:
                states = None                  # a new epoch
            x = mx.nd.array(data[t:t + LM_BPTT], ctx=cuda, dtype="int32")
            y = mx.nd.array(data[t + 1:t + 1 + LM_BPTT], ctx=cuda)
            loss, states, norm = rnn_lm_step(mx, net, loss_fn, trainer, x,
                                             y, states, LM_BATCH, LM_CLIP)
            losses.append(float(loss.asnumpy().mean()))
            norms.append(norm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tok_s = (LM_STEPS - 5) * LM_BPTT * LM_BATCH / wall
        return {"net": net, "trainer": trainer, "losses": losses,
                "norms": norms, "tokens_per_s": tok_s,
                "cached_step": cached_step.trainer_state(trainer),
                "loss_fn": loss_fn, "x": x, "y": y, "states": states}
    finally:
        rnn_ops.run_cells = run_cells


def lm_profile(torch, mx, run, root):
    """cuDNN's RNN kernels by name and count a step, from a profiler
    cycle over 2 steps (``profiler.device_op_table``)."""
    from mxnet_tpu_torch import profiler
    profiler.set_config(filename=os.path.join(root, "rnn_profile.json"))
    states = run["states"]
    rnn_lm_step(mx, run["net"], run["loss_fn"], run["trainer"], run["x"],
                run["y"], states, LM_BATCH, LM_CLIP)
    profiler.start()
    for _ in range(2):
        _, states, _ = rnn_lm_step(mx, run["net"], run["loss_fn"],
                                   run["trainer"], run["x"], run["y"],
                                   states, LM_BATCH, LM_CLIP)
    torch.cuda.synchronize()
    profiler.stop()
    table = profiler.device_op_table()
    per_step = {k[:100]: v["count"] / 2 for k, v in table.items()}
    rnn = {k: v for k, v in per_step.items()
           if "rnn" in k.lower() or "lstm" in k.lower()}
    return rnn, len(table), sum(per_step.values())


def lm_infer(torch, mx, net, data, cuda):
    """Tokens/s of the hybridized inference forward at batch 20 (one
    captured graph), and its logits against the eager forward's."""
    x = mx.nd.array(data[:LM_BPTT], ctx=cuda, dtype="int32")
    states = net.begin_state(LM_BATCH)
    eager, _ = net(x, states)
    net.hybridize()
    net(x, states)                              # the capture
    got, _ = net(x, states)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_INFER_CALLS):
        out, _ = net(x, states)
    out.asnumpy()
    wall = time.perf_counter() - t0
    graphs = len(net._cached_graphs)
    net.hybridize(False)
    return (LM_INFER_CALLS * LM_BPTT * LM_BATCH / wall,
            rel_err(got._data, eager._data), graphs)


def phase_rnn(torch, smi):
    """Phase 29: the recurrent family (see the module docstring)."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.amp import policy
    t0 = time.perf_counter()
    failures = []
    if policy.enabled() or torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        failures.append("the phase runs fp32: AMP or TF32 was left on")
    os.environ["MXNET_CACHED_STEP"] = "1"
    cuda = mx.gpu(0) if DEV == "cuda" else mx.cpu()
    root = tempfile.mkdtemp(prefix="rnn_", dir=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build"))
    try:
        parity = rnn_parity(torch, smi, failures)
        ctc = ctc_parity(torch, smi, failures)
        # (b) the word-level LM at full width
        toks = synth_corpus(LM_BATCH * (LM_WINDOWS * LM_BPTT + 1), LM_VOCAB,
                            seed=LM_SEED)
        data = batchify(toks, LM_BATCH)
        params = lm_numpy_params(LM_SEED)
        runs = {p: lm_run(torch, mx, cuda, p, params, data, smi)
                for p in ("cudnn", "plain")}
        a, b = runs["cudnn"]["losses"], runs["plain"]["losses"]
        loss_err = max(abs(u - v) / abs(v) for u, v in zip(a, b))
        falls = onp.mean(a[-LM_WINDOWS:]) < onp.mean(a[:LM_WINDOWS])
        if loss_err > LM_TOL or not falls or not onp.isfinite(a).all():
            failures.append(f"(b) losses cudnn {a} plain {b}: rel err "
                            f"{loss_err} (limit {LM_TOL}), falls {falls}")
        rnn_kernels, n_names, kernels_step = lm_profile(
            torch, mx, runs["cudnn"], root)
        if not rnn_kernels:
            failures.append("(b) no cuDNN RNN kernel in the step's trace")
        infer_tok_s, infer_err, graphs = lm_infer(
            torch, mx, runs["cudnn"]["net"], data, cuda)
        if infer_err > 1e-5 or graphs != 1:
            failures.append(f"(b) hybridized forward rel err {infer_err}, "
                            f"{graphs} graphs")
        emit({"phase": "rnn", "part": "b", "gpu": smi,
              "losses_cudnn": a, "losses_plain": b,
              "max_loss_rel_err": loss_err, "loss_falls": bool(falls),
              "clip_norms": runs["cudnn"]["norms"],
              "train_tokens_per_s": {p: r["tokens_per_s"]
                                     for p, r in runs.items()},
              "infer_tokens_per_s": infer_tok_s,
              "infer_vs_eager_rel_err": infer_err,
              "cudnn_rnn_kernels_a_step": rnn_kernels,
              "kernels_a_step": kernels_step,
              "cached_step": {p: r["cached_step"] for p, r in runs.items()}})
        # (c) the reference's weights by name, card against CPU
        net = runs["cudnn"]["net"]
        convert.load_collected_params(net, params, device=DEV)
        cpu_net = rnn_lm(LM_VOCAB, LM_WIDTH, LM_WIDTH, LM_LAYERS,
                         LM_DROPOUT)
        cpu_net.initialize(device="cpu")
        cpu_net(torch.zeros(LM_BPTT, LM_BATCH, dtype=torch.int32))
        convert.load_collected_params(cpu_net, params, device="cpu")
        ids = torch.from_numpy(data[:LM_BPTT].astype("int32"))
        with torch.no_grad():
            card = net(ids.to(DEV))[0]
            host = cpu_net(ids)[0]
        carried = rel_err(card, host)
        if carried > RNN_TOL or list(net.collect_params()) != LM_NAMES:
            failures.append(f"(c) card vs CPU logits rel err {carried}")
        del runs, net, cpu_net
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "rnn", "part": "summary", "gpu": smi,
          "parity": {k: [v["max_rel_err_outputs_states"],
                         v["max_rel_err_grads"]] for k, v in parity.items()},
          "lm_ms": {k: [v["fused_ms"], v["plain_ms"]]
                    for k, v in parity.items()},
          "ctc": ctc, "carried_rel_err": carried,
          "failures": failures, "phase_s": time.perf_counter() - t0})
    if failures:
        raise AssertionError(f"rnn: {failures}")


NP_VIT = dict(image_size=224, patch_size=16, classes=1000, units=768,
              num_layers=12, num_heads=12, ffn_ratio=4)   # ViT-B/16
NP_BATCH = 128                   # (a): bf16 training and predict
NP_LOOP_BATCH = 64               # (b): the 2.0 user loop
NP_FP32_BATCH = 32               # (a): the fp32 flash / dense check
NP_WINDOWS = (2, 8, 1)           # (a): run_steps windows (20 steps)
NP_LR = 1e-4
NP_SEED = 23
NP_LOOP_STEPS = 6                # (b): captured steps after the eager one
NP_REPLAY_STEPS = 3              # (b): replays against eager steps
NP_FP32_TOL = {"first_loss_rtol": 1e-5, "loss_rtol": 1e-4}
NP_KERNEL_TOL = {"rope": 1e-5, "paged_attention": 1e-4,
                 "flash_attention": 1e-4, "plain_ops": 1e-5}


def np_vit(torch, use_flash=True, seed=0):
    """ViT-B/16 on the card, Xavier from a host generator seeded with
    ``seed``, its deferred dims filled by a one-image forward."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import get_vit
    net = get_vit(**NP_VIT, use_flash=use_flash)
    net.initialize(init=initializer.Xavier(), device=DEV,
                   generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        net(torch.zeros((1, 3, NP_VIT["image_size"], NP_VIT["image_size"]),
                        device=DEV))
    return net


def np_batch(mx, batch, seed):
    """Images and float labels drawn by ``mx.np.random`` on the card."""
    mx.random.seed(seed)
    ctx = mx.gpu(0) if DEV == "cuda" else mx.cpu()
    size = NP_VIT["image_size"]
    data = mx.np.random.normal(0.0, 1.0, size=(batch, 3, size, size),
                               ctx=ctx)
    label = mx.np.random.randint(0, NP_VIT["classes"], size=(batch,),
                                 ctx=ctx).astype("float32")
    return data, label


def np_vit_flops(batch):
    """Matmul flops of a ViT-B/16 training step (forward and backward,
    3 x the forward): the blocks' four projections and the FFN, the
    attention's two products, the patch stem and the head."""
    c = NP_VIT
    n = (c["image_size"] // c["patch_size"]) ** 2 + 1
    e, f = c["units"], c["units"] * c["ffn_ratio"]
    block = 2 * n * (4 * e * e + 2 * e * f) + 2 * 2 * n * n * e
    stem = 2 * (n - 1) * e * 3 * c["patch_size"] ** 2
    head = 2 * e * c["classes"]
    return 3 * batch * (c["num_layers"] * block + stem + head)


def np_train(torch, mx, fa_mod, rope_mod, pa_mod, smi, failures):
    """(a) ViT-B/16 bf16 through SPMDTrainer at batch 128.  Counts K1-K3
    (12 launches a replayed step) and K4 / K5 (none: the ViT runs
    neither) over the same replayed steps."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    others = (rope_mod.rope, pa_mod.paged_attention)
    t0 = time.perf_counter()
    net = np_vit(torch)
    trainer = SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="adam",
                          optimizer_params={"learning_rate": NP_LR},
                          dtype="bfloat16", device=DEV)
    data, label = np_batch(mx, NP_BATCH, NP_SEED)
    on_card = type(data).__name__ == "ndarray" and \
        data._data.device.type == DEV
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w0 = time.perf_counter()
    losses = [float(trainer.step(data, label))]     # the warm step + capture
    warm_s = time.perf_counter() - w0
    step_graph(trainer)
    steps = 4
    reset_counts(*fns, *others)
    for _ in range(steps):
        losses.append(float(trainer.step(data, label)))
    torch.cuda.synchronize()
    counts = {f.__name__: {"launches": f.launches,
                           "plain_calls": f.plain_calls}
              for f in fns + others}
    layers = NP_VIT["num_layers"]
    for f in fns + others:
        want = layers * steps if f in fns else 0
        if counts[f.__name__] != {"launches": want, "plain_calls": 0}:
            failures.append(f"(a) {f.__name__} ran {counts[f.__name__]}: "
                            f"want {want} launches over {steps} replayed "
                            f"steps")

    def run(n):
        losses.extend(float(v) for v in
                      trainer.run_steps(data, label, n)._data.cpu())

    slope, t1, t2 = marginal(run, NP_WINDOWS)
    peak = torch.cuda.max_memory_allocated()
    if trainer.compiles != 1:
        failures.append(f"(a) {trainer.compiles} captures for one "
                        f"signature")
    if not on_card:
        failures.append("(a) the mx.np batch is not on the card")
    if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
        failures.append(f"(a) losses not finite and falling: {losses}")
    cost = trainer.cost_analysis(data, label)
    flops = np_vit_flops(NP_BATCH)

    def predict(n):
        for _ in range(n):
            out = trainer.predict(data)
        float(out._data[0, 0])

    # where a replayed step's device time goes, by kind of kernel
    prof = profiled_kinds(torch, lambda: float(trainer.step(data, label)),
                          3)
    p_slope, p1, p2 = marginal(predict, NP_WINDOWS)
    logits = trainer.predict(data)
    if tuple(logits.shape) != (NP_BATCH, NP_VIT["classes"]) or \
            not bool(torch.isfinite(logits._data).all()):
        failures.append("(a) predict's logits not finite of (128, 1000)")
    row = {"model": "vit_b16", **NP_VIT, "batch": NP_BATCH,
           "dtype": "bfloat16", "optimizer": "adam", "lr": NP_LR,
           "data": "mx.np.random on the card", "warmup_s": warm_s,
           "img_per_s": NP_BATCH / slope, "step_ms": slope * 1e3,
           "window_s": {str(NP_WINDOWS[0]): t1, str(NP_WINDOWS[1]): t2},
           "train_tflop_per_s": flops / slope / 1e12,
           "flops_a_step_matmul": flops,
           "cost_analysis_flops": cost.get("flops"),
           "cost_analysis_note": "torch's FlopCounterMode: K2 and K3 "
           "(ctypes launches) are not seen",
           "predict_img_per_s": NP_BATCH / p_slope,
           "predict_ms": p_slope * 1e3,
           "counts": counts, "launches_per_replayed_step": layers,
           "profile_replayed_step": prof,
           "peak_allocated_bytes": peak, "captures": trainer.compiles,
           "losses_first_last": [losses[0], losses[-1]],
           "losses_steps": len(losses),
           "row_s": time.perf_counter() - t0}
    emit({"phase": "numpy", "part": "a", "gpu": smi, **row})
    del trainer, net, data, label, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts, row


def np_fp32_check(torch, mx, failures):
    """(a) fp32, TF32 off: 3 steps of ``use_flash=True`` against
    ``use_flash=False`` from one state."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.parallel import SPMDTrainer
    data, label = np_batch(mx, NP_FP32_BATCH, NP_SEED + 1)
    runs = {}
    for flash in (True, False):
        net = np_vit(torch, use_flash=flash, seed=5)
        tr = SPMDTrainer(net, SoftmaxCrossEntropyLoss(), optimizer="adam",
                         optimizer_params={"learning_rate": NP_LR},
                         device=DEV)
        runs[flash] = [float(tr.step(data, label)) for _ in range(3)]
        del tr, net
        gc.collect()
        torch.cuda.empty_cache()
    a, b = runs[True], runs[False]
    rel = [abs(x - y) / abs(y) for x, y in zip(a, b)]
    if rel[0] > NP_FP32_TOL["first_loss_rtol"] or \
            max(rel) > NP_FP32_TOL["loss_rtol"]:
        failures.append(f"(a) fp32 flash {a} vs dense {b}: rel {rel}")
    return {"batch": NP_FP32_BATCH, "losses_flash": a, "losses_dense": b,
            "rel_err": rel, "tolerance": NP_FP32_TOL}


def np_user_loop(torch, mx, fa_mod, smi, failures):
    """(b) The 2.0 user loop, eager and under the whole-step capture."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.imperative import cached_step
    fns = (fa_mod.flash_fwd, fa_mod.flash_bwd_dkdv, fa_mod.flash_bwd_dq)
    mx.npx.set_np()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net = np_vit(torch, seed=7)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": NP_LR})
        x, y = np_batch(mx, NP_LOOP_BATCH, NP_SEED + 2)
        flavors = set()

        def step(read=True):
            with mx.autograd.record():
                out = net(x)
                loss = -mx.np.mean(mx.npx.pick(mx.npx.log_softmax(out), y))
            flavors.update((type(out).__name__, type(loss).__name__))
            loss.backward()
            trainer.step(1)
            return float(loss) if read else loss

        def eager_step():
            os.environ["MXNET_CACHED_STEP"] = "0"
            try:
                return step()
            finally:
                os.environ["MXNET_CACHED_STEP"] = "1"

        losses = [step()]                            # the eager warm step
        s0 = cached_step.stats()
        dispatch = telemetry.counter("dispatch.count")
        reset_counts(*fns)
        for _ in range(NP_LOOP_STEPS):
            losses.append(float(step(read=False)))
        torch.cuda.synchronize()
        counts = {f.__name__: {"launches": f.launches,
                               "plain_calls": f.plain_calls} for f in fns}
        s1 = cached_step.stats()
        stats = {k: s1[k] - s0[k]
                 for k in ("compiles", "hits", "graph_breaks", "fallbacks")}
        state = cached_step.trainer_state(trainer)
        want = {"compiles": 1, "hits": NP_LOOP_STEPS - 1, "graph_breaks": 0,
                "fallbacks": 0}
        if stats != want:
            failures.append(f"(b) cached step {stats} (want {want}); last "
                            f"reason {state.get('last_reason')}")
        if flavors != {"ndarray"}:
            failures.append(f"(b) outputs of the np loop are {flavors}")
        layers = NP_VIT["num_layers"]
        for name, c in counts.items():
            if c != {"launches": layers * NP_LOOP_STEPS, "plain_calls": 0}:
                failures.append(f"(b) {name} ran {c}")
        snap = gluon_snapshot(trainer)
        lc = [step() for _ in range(NP_REPLAY_STEPS)]
        captured = gluon_snapshot(trainer)
        gluon_restore(torch, trainer, snap)
        le = [eager_step() for _ in range(NP_REPLAY_STEPS)]
        bad, dev = gluon_differ(torch, trainer, captured)
        if lc != le or bad:
            failures.append(f"(b) captured losses {lc} vs eager {le}; "
                            f"{len(bad)} tensors differ, max |d| {dev}")
        if not all(onp.isfinite(losses)) or not losses[-1] < losses[0]:
            failures.append(f"(b) losses not finite and falling: {losses}")
        host = host_ms_blocks({"captured": step, "eager": eager_step},
                              calls=2, rounds=2)
        del dispatch
        out = {"batch": NP_LOOP_BATCH, "dtype": "float32",
               "loop": "npx.set_np, mx.np batch, autograd.record, "
               "-np.mean(npx.pick(npx.log_softmax(net(x)), y)), "
               "gluon.Trainer.step", "losses": losses,
               "cached_step": stats, "last_reason": state.get("last_reason"),
               "counts": counts, "output_flavor": sorted(flavors),
               "replay_check": {"losses_captured": lc, "losses_eager": le,
                                "tensors_differing": len(bad),
                                "bitwise_equal": lc == le and not bad},
               "host_ms": host,
               "img_per_s_host": {k: NP_LOOP_BATCH / (v["median"] / 1e3)
                                  for k, v in host.items()}}
        emit({"phase": "numpy", "part": "b", "gpu": smi, **out})
        del trainer, net, x, y
    finally:
        torch.backends.cudnn.deterministic = det
        mx.npx.reset_np()
        gc.collect()
        torch.cuda.empty_cache()
    return counts, out


def np_namespace(torch, mx, smi, failures):
    """(c) every case of the CPU parity sweep on CUDA tensors against the
    same call on CPU tensors; every output on the card."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import torch_np_sweep as S
    card = mx.gpu(0) if DEV == "cuda" else mx.cpu()

    def run(case, ctx):
        make = mx.np.array if case.array_kind == "np" else mx.nd.array
        S.seed_case(mx, case)
        with ctx:
            args = [make(a) if isinstance(a, onp.ndarray) else a
                    for a in case.args]
            out = case.call(mx, *args)
        flat = out if isinstance(out, (list, tuple)) else [out]
        devs = set()
        for o in flat:
            for x in (o if isinstance(o, (list, tuple)) else [o]):
                devs.add(x._data.device.type if hasattr(x, "_data")
                         else "host")
        return S.host(out), devs

    worst, off_card, bad = {}, [], []
    for case in S.CASES:
        want, _ = run(case, mx.cpu())
        got, devs = run(case, card)
        if devs != {DEV}:
            off_card.append((case.id, sorted(devs)))
        try:
            S.compare(case, got, want)
        except AssertionError as e:
            bad.append(f"{case.family}/{case.id}: {str(e)[:300]}")
        w = S.worst(case, got, want)
        worst[case.family] = max(worst.get(case.family, 0.0), w)
    if off_card:
        failures.append(f"(c) outputs off the card: {off_card}")
    if bad:
        failures.append(f"(c) {len(bad)} cases differ: {bad[:8]}")
    out = {"cases": len(S.CASES), "failed": len(bad),
           "outputs_off_card": off_card, "worst_abs_err_by_family": worst,
           "compare": "values and dtypes at each case's tolerance; "
           "factorizations by reconstruction, samplers by moments"}
    emit({"phase": "numpy", "part": "c", "gpu": smi, **out})
    return out


def np_kernel_names(torch, mx, fa_mod, rope_mod, pa_mod, smi, failures):
    """(d) K5, K4 and K1 through ``npx.rope``, ``npx.paged_attention``
    and ``npx.flash_attention``: one launch a call through the funnel, no
    plain call, bitwise equal to the direct call and within the kernels'
    tolerances of the plain versions; ``npx.masked_softmax`` and the
    ``interleaved_matmul_*`` ops on the card against the same ops on the
    CPU."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.ops import registry
    dispatch = telemetry.counter("dispatch.count")
    card = mx.gpu(0) if DEV == "cuda" else mx.cpu()
    r = onp.random.RandomState(NP_SEED)
    rows, counts = {}, {}

    def through(name, fn, call, direct, plain, tol):
        d0 = dispatch.value
        reset_counts(fn)
        out = call()
        torch.cuda.synchronize()
        c = {"launches": fn.launches, "plain_calls": fn.plain_calls}
        disp = dispatch.value - d0
        counts[fn.__name__] = c
        d = direct()
        torch.cuda.synchronize()
        same = torch.equal(out._data, d)
        err = float((out._data.float() - plain().float()).abs().max())
        rows[name] = {"counts": c, "dispatches": disp,
                      "bitwise_equal_direct": same, "max_abs_err": err,
                      "tolerance": tol}
        if c != {"launches": 1, "plain_calls": 0} or disp != 1 or \
                not same or not err <= tol:
            failures.append(f"(d) {name}: {rows[name]}")

    x = r.randn(8, 197, 12, 64).astype("float32")
    pos = onp.tile(onp.arange(197, dtype="int32"), (8, 1))
    with card:
        xa, pa_ = mx.np.array(x), mx.np.array(pos, dtype="int32")
    through("npx.rope", rope_mod.rope,
            lambda: mx.npx.rope(xa, pa_),
            lambda: rope_mod.rope(xa._data, pa_._data),
            lambda: rope_mod.rope_reference(xa._data, pa_._data),
            NP_KERNEL_TOL["rope"])
    slots, heads, d, page, pages = 8, 8, 64, 16, 64
    q = r.randn(slots, heads, d).astype("float32")
    kp = r.randn(pages * slots, page, heads, d).astype("float32")
    vp = r.randn(pages * slots, page, heads, d).astype("float32")
    tables = r.permutation(pages * slots).reshape(slots, pages).astype(
        "int32")
    lengths = r.randint(1, pages * page, size=slots).astype("int32")
    with card:
        pa_args = [mx.np.array(a, dtype=a.dtype) for a in (q, kp, vp, tables,
                                                           lengths)]
    raw = [a._data for a in pa_args]
    through("npx.paged_attention", pa_mod.paged_attention,
            lambda: mx.npx.paged_attention(*pa_args),
            lambda: pa_mod.paged_attention(*raw),
            lambda: pa_mod.paged_attention_reference(*raw),
            NP_KERNEL_TOL["paged_attention"])
    qkv = [r.randn(2, 12, 197, 64).astype("float32") for _ in range(3)]
    with card:
        fa_args = [mx.np.array(a) for a in qkv]
    raw = [a._data for a in fa_args]
    through("npx.flash_attention", fa_mod.flash_fwd,
            lambda: mx.npx.flash_attention(*fa_args),
            lambda: fa_mod.flash_attention(*raw),
            lambda: fa_mod.attention_reference(*raw),
            NP_KERNEL_TOL["flash_attention"])
    # the plain ops of the slice: the card against the CPU
    sa = r.randn(3, 2, 4 * 8 * 3).astype("float32")
    att = r.rand(2 * 4, 3, 3).astype("float32")
    xs = r.randn(6, 11).astype("float32")
    ms = (r.rand(6, 11) < 0.6).astype("float32")
    for name, arrays, params in (
            ("masked_softmax", (xs, ms), {}),
            ("masked_log_softmax", (xs, ms), {}),
            ("interleaved_matmul_selfatt_qk", (sa,), {"heads": 4}),
            ("interleaved_matmul_selfatt_valatt", (sa, att), {"heads": 4}),
            ("interleaved_matmul_encdec_qk", (sa[..., :32], sa[..., :64]),
             {"heads": 4}),
            ("interleaved_matmul_encdec_valatt", (sa[..., :64], att),
             {"heads": 4})):
        outs = {}
        for ctx in (card, mx.cpu()):
            with ctx:
                nds = [mx.np.array(a) for a in arrays]
            o = registry.invoke(name, nds, **params)
            outs[ctx.device_type] = o.asnumpy()
        a, b = outs[card.device_type], outs["cpu"]
        fin = onp.isfinite(b)
        err = float(onp.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0
        ok = (onp.isfinite(a) == fin).all() and \
            err <= NP_KERNEL_TOL["plain_ops"] * max(1.0, float(
                onp.abs(b[fin]).max()))
        rows[name] = {"max_abs_err_card_vs_cpu": err,
                      "tolerance": NP_KERNEL_TOL["plain_ops"]}
        if not ok:
            failures.append(f"(d) {name}: card vs CPU {err}")
    emit({"phase": "numpy", "part": "d", "gpu": smi, "calls": rows})
    return counts, rows


def phase_numpy(torch, fa_mod, rope_mod, pa_mod, smi):
    """Phase 30: the numpy front end (see the module docstring).  Returns
    the launches of K1-K5 on the phase's paths: K1-K3 over (a)'s
    replayed steps, K4 / K5 (and K1 again) through their npx names."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    failures = []
    os.environ["MXNET_CACHED_STEP"] = "1"
    # K1-K3 at the ViT-B/16 step's shape (batch x heads, 197 keys,
    # non-causal; bf16 K1's second 128-key stage masks keys 197-255) and
    # at the tile the kernel registry resolves for it, the one (a) runs
    bh = NP_BATCH * NP_VIT["num_heads"]
    vit_flash, tiles = {}, {}
    for dtype, (tf, tl, tg) in {torch.bfloat16: (2e-2, 1e-4, 2e-2),
                                torch.float32: (1e-4, 1e-4, 1e-3)}.items():
        case = flash_case(torch, bh, 197, 197, 64, dtype, seed=197)
        q, k, v, _ = case
        tile = fa_mod._resolve_tile(q, k, v, False, q.shape[-1] ** -0.5,
                                    None, None)
        tiles[str(dtype)] = tile
        vit_flash[str(dtype)] = flash_check(torch, fa_mod, case, False, tile,
                                            tf, tl, tg)
        del case, q, k, v
        torch.cuda.empty_cache()
    emit({"phase": "numpy", "part": "flash_197", "gpu": smi,
          "bh_sq_sk_d": [bh, 197, 197, 64], "causal": False,
          "tile_resolved": tiles, "max_abs_err": vit_flash})
    train_counts, train_row = np_train(torch, mx, fa_mod, rope_mod, pa_mod,
                                       smi, failures)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    if any(tf32):
        failures.append("(a) the fp32 check needs TF32 off")
    fp32 = np_fp32_check(torch, mx, failures)
    emit({"phase": "numpy", "part": "a_fp32", "gpu": smi, **fp32})
    loop_counts, loop = np_user_loop(torch, mx, fa_mod, smi, failures)
    ns = np_namespace(torch, mx, smi, failures)
    name_counts, names = np_kernel_names(torch, mx, fa_mod, rope_mod, pa_mod,
                                         smi, failures)
    counts = {k: {"launches": v["launches"]} for k, v in train_counts.items()}
    for k, v in name_counts.items():
        counts[k]["npx_launches"] = v["launches"]
    emit({"phase": "numpy", "part": "summary", "gpu": smi,
          "train_img_per_s": train_row["img_per_s"],
          "predict_img_per_s": train_row["predict_img_per_s"],
          "loop_bitwise": loop["replay_check"]["bitwise_equal"],
          "namespace_cases": ns["cases"], "counts": counts,
          "failures": failures, "phase_s": time.perf_counter() - t0})
    if failures:
        raise AssertionError(f"numpy: {failures}")
    return counts


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
    if sys.argv[1:2] == ["--gluon-ab-child"]:
        gluon_ab_child(torch, os.path.abspath(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--gluon-ab"]:
        return gluon_ab([os.path.abspath(t) for t in sys.argv[2:]])
    if sys.argv[1:2] == ["--export-child"]:
        export_child(torch, os.path.abspath(sys.argv[2]))
        return 0
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
    capture_counts = phase_gluon_capture(torch, fa_mod, smi)
    for row in kernels:                  # K1-K3 in the captured Gluon step
        if row["name"] in capture_counts:
            row["launches_gluon_capture"] = \
                capture_counts[row["name"]]["launches"]
    phase_gluon_resnet(torch, smi)
    phase_gluon_check(torch)
    ckpt_counts = phase_ckpt(torch, fa_mod, smi)
    for row in kernels:                  # K1-K3 in the checkpoint phase
        if row["name"] in ckpt_counts:
            row["launches_ckpt"] = ckpt_counts[row["name"]]["launches"]
    phase_batch_serve(torch, smi)
    serve_counts = phase_lm_serve(torch, fa_mod, smi)
    for row in kernels:                  # K1 in the LM's bucket graphs
        if row["name"] in serve_counts:
            row["launches_batch_serve"] = \
                serve_counts[row["name"]]["launches"]
    input_counts = phase_input_pipeline(torch, fa_mod, smi)
    for row in kernels:                  # K1-K3 on 20 prefetched steps
        if row["name"] in input_counts:
            row["launches_input_pipeline"] = \
                input_counts[row["name"]]["launches"]
    obs_counts = phase_observability(torch, fa_mod, smi)
    for row in kernels:                  # K1-K3 on 19 replays, all on
        if row["name"] in obs_counts:
            row["launches_observability"] = \
                obs_counts[row["name"]]["launches"]
    dist_counts = phase_distributed(torch, fa_mod, smi)
    for row in kernels:                  # K1-K3 through ring-flash, meshed
        if row["name"] in dist_counts:
            row["launches_distributed"] = \
                dist_counts[row["name"]]["launches"]
            row["launches_ring_fold"] = \
                dist_counts[row["name"]]["fold_launches"]
    pipe_counts = phase_pipeline(torch, fa_mod, smi)
    for row in kernels:                  # K1-K3 in 1F1B and Mesh4DTrainer
        if row["name"] in pipe_counts:
            row["launches_pipeline"] = pipe_counts[row["name"]]["pipeline"]
            row["launches_mesh4d"] = pipe_counts[row["name"]]["mesh4d"]
    kv_counts = phase_kvstore(torch, fa_mod, smi)
    for row in kernels:                  # K1-K3 in the dist_sync steps
        if row["name"] in kv_counts:
            row["launches_kvstore"] = kv_counts[row["name"]]["launches"]
    dpr_counts = phase_dp_resnet(torch, fa_mod, smi)
    for row in kernels:                  # K1-K3 with specs off tp, (c)
        if row["name"] in dpr_counts:
            row["launches_dp_resnet"] = dpr_counts[row["name"]]["launches"]
    phase_vision_zoo(torch, smi)
    export_counts = phase_export(torch, fa_mod, smi)
    for row in kernels:                  # K1 in the imported LM's forward
        if row["name"] in export_counts:
            row["launches_export"] = export_counts[row["name"]]["launches"]
    phase_rnn(torch, smi)
    np_counts = phase_numpy(torch, fa_mod, rope_mod, pa_mod, smi)
    for row in kernels:          # K1-K3 on ViT-B/16, K1/K4/K5 through npx
        if row["name"] in np_counts:
            row["launches_numpy"] = np_counts[row["name"]]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
