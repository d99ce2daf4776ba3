#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on the card, end to end.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure raises and exits non-zero; nothing is caught):

1. device — the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints them;
2. build — every kernel under ``bigdl_tpu_torch/kernels/csrc`` is built
   from source with nvcc (one process per source, all at once); the
   flash libraries' SASS (``cuobjdump -sass``) must show tf32
   tensor-core MMAs (``HMMA ... TF32``) in every float32 instance of
   K1's and K2's forwards and of the backward's dK/dV and dQ kernels
   (3xTF32), 16-bit m16n8k16 MMAs (``HMMA.16816``, BF16 or F16) with no
   TF32 HMMA in the bfloat16 and float16 instances of both forwards,
   and wgmma (``HGMMA``, BF16 or F16) with no TF32 HMMA and no
   HMMA.16816 in the 16-bit instances of the backward's dK/dV and dQ
   kernels;
3. kernels — each kernel's wrapper against its plain PyTorch version on
   the same inputs on the card, at its main path's shapes, then timed
   beside the plain version, one PyTorch library call computing the
   same function (a yardstick only; the port never calls it) and the
   card's bound for the work. Each kernel and its library call is timed
   twice: with CUDA events around the loop of calls (``ms``, the host's
   launch path included) and as the summed device durations of the
   kernels the calls launched, read by ``torch.profiler``
   (``device_ms``). The ragged decode kernel (K3) at the serving
   shapes in float32, bfloat16 and float16, at head_dim 20, 48 and
   256, in one split and at T = 8192 (two calls bitwise equal), and
   CUDA operands it does not take (float64, head_dim 264, int64
   lengths), through the decode dispatch: raised and counted
   ``reason=shape``, never as a kernel call; timed at the serving
   lengths, with every slot full, at ``[1, 8, 8192, 64]`` and four
   slots of ragged lengths up to 8192, each beside its split plan's
   variants in turns; the flash-attention forward and backward (K1) at the
   training shapes ``[16, 8, 512, 64]``, float32, bfloat16 and float16,
   causal, with and without the training batch's packed segment ids,
   plus ragged edge shapes; K1's forward in every dtype and its 16-bit
   backward's dK/dV and dQ kernels must have computed exactly the (query
   tile, key tile) pairs the training ids keep (they skip the tiles
   whose queries and keys share no segment id), and the 16-bit backward
   run twice there must give bitwise equal gradients; the blockwise
   flash-attention forward and backward (K2) at ragged edge shapes (S =
   1 to 1000, D = 16 to 128, causal and segments on and off,
   float32/bfloat16/float16) and at ``[1, 8, 2048,
   64]``, against K1's kernel at the long-context shape ``[1, 8, 8192,
   64]``; the backward run twice at ``[1, 8, 8192, 64]`` (K2) and at
   ``[16, 8, 512, 64]`` with segments (K1) must give bitwise equal
   gradients (no atomics); timed there and at ``[1, 8, 32768, 64]``
   beside K1, the SDPA yardstick (whose kernels are logged) and (at
   8192) the einsum path, and at ``[1, 8, 8192, 64]`` in bfloat16 and
   float16 (against K2's float32 kernel on the upcast inputs and
   against the plain version at the 16-bit contract, then timed beside
   SDPA in the same dtype and the plain version, bound at the 16-bit
   rate; the bfloat16 forward and backward are rows of the kernels
   line); then the attention
   layer's route for score matrices over 2 GiB (flash off, ``[1, 8,
   16384, 128]``) must launch K2 once and equal a direct call bitwise;
   the fused dequant int8 GEMM (K5) equal to its plain version bitwise
   at 60 edge shapes (M 1-300, N 1-1024, K 1-4100, across its tile and
   split-K choices, which are logged), at the int8 serving slice's
   classifier shape ``[64, 2048] x [1000, 2048]^T`` and at 4096^3, timed
   at the last two and at VGG-16's three classifier shapes (phase 15
   (e)) beside ``torch._int_mm``; the paged
   decode kernel (K4), through the dispatch function, equal bitwise to
   K3's kernel on identity and shuffled paged views of the same cache
   (page sizes 16, 64, 128; ``[16, 8, 512, 64]`` with the serving
   lengths in float32, bfloat16, float16 and at head_dim 48, and
   T = 8192) and timed beside it;
4. serving — ``GenerationService`` serving a ``TransformerLM`` at the
   generation bench width (vocab 8192, hidden 512, 6 layers, 8 heads,
   max_len 512; random weights from a seed) for 32 greedy and 4 seeded
   top-k requests of 32 new tokens each. Every kernel's launch count is
   set to 0 just before and read just after: the ragged decode kernel
   must have launched once per layer per decode step. The greedy
   streams of 4 prompts must equal a greedy full re-forward without a
   cache (which runs K1's forward), and every top-k token must lie in
   the top k of that re-forward's logits;
5. train — ``LocalOptimizer`` training a ``TransformerLM`` at the
   repository's training width (vocab 32000, hidden 512, 6 layers, 8
   heads, ffn 2048, seq 512, batch 16; random weights from a seed) with
   SGD at lr 0.1 on the train CLI's packed synthetic documents, for
   ``TRAIN_ITERS`` iterations. First, one step from the same weights
   and batch with flash switched off (the einsum path on the card) must
   give the kernel step's loss and parameters within 1e-5 and every
   parameter's gradient within ``TRAIN_GRAD_RTOL`` of that gradient's
   largest element (floored); the same step with a fault put into K1's backward
   (dK zeroed, or dQ 1% off) must go past that limit. Then the
   counts are set to 0 and the run must launch K1's forward and backward
   once per layer per iteration, with finite losses whose last 5 average
   below the first 5; tokens/s, ms per step and a profiled window of a
   few steps (device busy, idle share, top kernels) are printed;
6. long-context training — ``LocalOptimizer`` at ``bench.py``'s LONGCTX
   row (vocab 8192, hidden 512, 2 layers, 8 heads, seq 8192, batch 1,
   the train CLI's contiguous synthetic stream, SGD lr 0.1) for
   ``LC_ITERS`` iterations, every attention call routed to K2: the same
   one-step check against the einsum path, with the two faults now put
   into K2's backward; K2's forward and backward launched once per
   layer per iteration and K1 never; falling losses, step time by
   attention path and a profiled window; then one step at S = 32768
   (finite loss, peak device memory);
7. long-context serving — the same configuration behind
   ``GenerationService(slots=2, max_len=8192, prefill_rows=2,
   prefill_chunk=2048)``: one seeded 8184-token prompt prefilled in 4
   chunks, 8 greedy tokens equal to the unchunked service's and to a
   full re-forward through K2, the first token's logits within
   ``PREFILL_LOGITS_TOL`` of the unchunked prefill's, at most 2 programs
   a rung, K3 launched once per layer per decode step; TTFT both ways;
   then K3 against its plain version at T = 8192;
8. int8 serving — ``InferenceService(max_batch_size=64)`` serving
   ResNet-50 (ImageNet, 1000 classes, 224 x 224, random weights from
   seed 23) under two names: the float model, and its int8 rewrite
   calibrated on 2 seeded batches of 16 and certified by an
   ``AccuracyGate`` of 64 seeded rows (max_delta 0.02); a candidate
   calibrated on the batches x 1000 must be refused while the certified
   version keeps serving. A seeded burst of single-row and batch
   requests by both names: K5 launched once per int8 forward, served
   int8 rows bitwise the direct forward, int8 on and off bitwise equal,
   at most one program per rung, cuDNN TF32 off; images/s, latency
   percentiles and a profiled window of each;
9. LeNet-5 (``phase_lenet``) — the recipe's ``train.main`` and
   ``test.main`` at MNIST's size on synthetic rows, a separable task to
   a held-out Top1 of 0.95, 10 steps card against CPU within 1e-4 (a
   frozen ``fc2`` must fail it), the Evaluator and Predictor against the
   driver's validation, and a profiled window;
10. ResNet-50 training (``phase_resnet_train``, BASELINE config 3) — the
   ImageNet recipe's ``train.main`` at batch 256 on 1024 synthetic rows,
   2 epochs with a checkpoint at each epoch's end, then a second call
   with ``-e 3`` that must resume from the newest checkpoint (its neval
   printed) and take 4 steps; 4 epochs of one 64-row batch straight
   against 2, a resume and 2 more (parameters and BN statistics within
   1e-5, the last loss within 1e-5 relative; cuDNN's deterministic
   algorithms for these runs); a flipped byte in the newest checkpoint
   raises ``CheckpointCorrupt`` and a fresh run quarantines it and
   resumes from the one before; 3 steps at batch 4 card against CPU in
   float64 within 1e-4 (losses relative, parameters and BN statistics
   absolute; float32's own rounding on this problem is as large as the
   gap, so float32 is reported, not gated), one BN in evaluation mode
   must fail it; a profiled window of 10 steps at batch 256 (ms a step,
   idle share, busiest kernels, peak memory), checkpoint bytes and
   save / load seconds. No kernel of the ``kernels`` line may launch
   in phases 9 and 10;
11. precision (``phase_precision``) — (a) the training slice's
   TransformerLM under ``bf16_mixed``: one step with K1 in bfloat16
   against the einsum path in bfloat16 within ``PREC_*`` (faults in K1's
   backward must fail it), then ``PREC_ITERS`` iterations through
   ``LocalOptimizer.set_precision("bf16_mixed").set_steps_per_sync(8)``
   (each window one CUDA graph) with K1 launched once per layer per
   iteration through the replays, one graph per window shape, float32
   parameters at rest and falling losses, profiled at K = 1 and K = 8
   (K1's bfloat16 instances must show) beside the float32 step; (b)
   ``f16_mixed`` from ``DynamicLossScaler(init_scale=2**24,
   growth_interval=4)``, one window of 8 steps equal bitwise to the same
   steps one by one, each overflowing step leaving the parameters, the
   master and the momentum bitwise as they were, the at-rest float16
   parameters the master cast down, K1's float16 instances; (c) windowed
   (K = 8) against per-step, bitwise, for LeNet-5 under ``f16_mixed``
   (24 steps, a checkpoint every 12, the scaler backing off inside a
   window) and a 2-layer TransformerLM under ``bf16_mixed`` (16 steps):
   losses, parameters, buffers, scaler state, checkpoint names and trees;
   (d) LeNet-5's profiled step at K = 1 and K = 8; (e) ResNet-50 at
   batch 64, float32 against ``bf16_mixed``: images/s, idle share, peak
   memory, float32 BN statistics, falling losses;
12. optim (``phase_optim``) — (a) the training slice's TransformerLM
   under ``bf16_mixed`` with ``Adam(learning_rate=1e-3)``: one step
   with K1 against the einsum path at phase 11's limits (loss,
   gradients, Adam's first moment, ``t``, the parameters over the rate
   where the gradient's sign is fixed), which Adam with ``t`` not
   advanced must fail; ``OPT_STEPS`` iterations through
   ``LocalOptimizer`` in windows of 8 (CUDA graphs) and one by one,
   bitwise alike (losses, parameters, ``m``, ``v``, ``t`` = 16), K1's
   wrapper calls exact; a profiled window of 8: ms a step profiled and
   not, tokens/s, idle share, the foreach update's device time, K1's
   kernels once a layer and replayed step; (b) SGD, Adam, Adagrad,
   Adadelta, Adamax, RMSprop and Ftrl, 5 float32 LeNet-5 steps at batch
   128 on the card against the CPU within 1e-4 (Adam with ``t``
   advanced twice must fail); (c) SGD with
   ``SequentialSchedule().add(Warmup, 12).add(Poly(0.5, 40), 40)`` in
   windows of 8 across the warm-up, bitwise the per-step loop; (d)
   ``Plateau`` on the held-out Top1, validated every epoch: the window
   falls back per step with the driver's reason, the rate falls tenfold
   after the patience, as on the CPU; (e) ``LBFGS`` with strong-Wolfe,
   full batch over 60,000 synthetic rows, 20 iterations, falling, and 3
   iterations card against CPU in float64 within 1e-10; (f) a run of 12
   steps with a checkpoint every 4 whose dataset raises ``OSError`` once
   at step 6: one recovery, bitwise the uninterrupted run; a
   ``TypeError`` raises at once with no recovery. No kernel of the
   ``kernels`` line may launch in (b)-(f);
13. the LM slice (``phase_lm``) — (a) the training cell with the moe
   recipe's layout (4 experts, top 2, blocks 1, 3 and 5) under
   ``bf16_mixed`` with ``Adam(learning_rate=1e-3)`` and the load-balance
   term at 0.01: one step with K1 against the einsum path at phase 11's
   limits, the router's gradients included, with the einsum path's
   routing pinned to the kernel path's (the tokens a bfloat16 tie routes
   otherwise, and the unpinned differences, are logged); the term's
   weight 0 against 0.01 must move the router's gradient; 16 steps at
   K = 8 and K = 1 bitwise alike (losses, parameters, ``m``, ``v``,
   ``t``, the MoE buffers), K1's wrapper calls exact, falling losses,
   ``expert_frac`` summing to 1 in each MoE block; a profiled window of
   16 replayed steps (K1's bfloat16 kernels once a layer and step; ms a
   step profiled and not, tokens/s, idle share, peak memory against
   the dense model's) and one MoE layer's forward and backward device
   ms against the dense FFN's; (b) the dense training cell in float32
   at attention dropout 0.1: 16 steps at K = 8 (the graphs replay the
   step's generator) and K = 1 bitwise alike, no K1 wrapper call in
   training, another seed other losses, an evaluation forward calling
   K1 once a layer and equal bitwise to a dropout-0 model's, a drawn
   mask's keep fraction within 4 sigma of 0.9; and 2 layers with MoE,
   dropout and the untied head under bf16_mixed Adam, 16 steps at K = 8
   and K = 1 bitwise alike; (c) ``transformer.train
   -f`` on a seeded PTB-style corpus with ``--checkpoint --inputMode
   packed --moeExperts 4 --dropout 0.1 -e 2``, ``transformer.test`` on a
   snapshot of the result (perplexity within 1e-5 of exp of a direct
   mean NLL) and training resumed from it with ``--model`` /
   ``--state`` (its held-out perplexity below the snapshot's);
14. the rest of generation serving (``phase_fleet``) — (a) the serving
   width with ``prefix_cache_bytes = 256 MiB``: 8 greedy prompts cold,
   then again: 8 prefix hits, every hit stream equal to its cold stream,
   at most 3 programs a rung, K3 once a layer per decode step; TTFT and
   token_ms p50 cold and hit; (b) the long-context configuration with
   chunks of 2048 and the cache: a seeded 8184-token prompt A, then B
   sharing A's first 6144 tokens (a partial hit on A's first-chunk
   entry: 3 chunks prefilled, not 4), then the 6144-token head H as a
   request of its own, then D sharing it (a partial hit at 6144: 1
   chunk); B's and D's streams equal a service without the cache; (c)
   ``SpeculativeDecoder`` with the serving model as the target and a
   one-layer, 256-wide draft (head_dim 32), k = 4, 16 slots, the 16
   greedy prompts cut to 476 tokens, 32 new tokens: streams equal the
   target-only service's, seeded sampling repeats, at most 3 programs
   a rung for the target and 2 for the draft, K3 launched draft layers
   x draft decode steps (the verify runs the masked path); the target
   as its own draft accepts at least 0.99, every rejection logged with
   its top-2 gaps and within ``SPEC_TIE_GAP``; accept rate and tokens/s
   with speculation on and off; (d) the fault points ``fleet/verify``
   (raises typed, the next generate serves in full), ``serving/decode``
   (live streams fail ``WorkerDied``, the loop restarts and serves the
   same tokens) and ``fleet/route`` (raises at submit), 3 fires, 3
   counted; (e) ``build_replicas(2)`` at the serving width behind a
   ``FleetRouter``: a seeded burst of 24 requests through 1 and 2
   replicas (tokens/s), a stream held on r0 when r0 is killed rerouted
   to r1 and equal to the undisturbed stream, one ``ProcessReplica`` on
   the card serving its thread twin's tokens and failing typed after
   ``kill()``; the phase's wall time and peak device memory;
15. the image zoo (``phase_zoo``) — (a) one SGD step (lr 0.01, momentum
   0.9, weight decay 5e-4) in float64 at batch 2 of mean-subtracted
   pixel rows, card against CPU within ``ZOO_F64_TOL`` (loss relative,
   parameters absolute), dropout off, for ``Vgg_16``,
   ``Inception_v1_NoAuxClassifier``, ``Inception_v2_NoAuxClassifier``
   and ``AlexNet`` at their full input sizes; Inception v1 with one
   LRN's beta raised by 1e-3 must fail it; (b) ``tools.perf``'s
   ``prepare`` / ``measure`` for vgg16 at batch 64, inception_v1 and
   inception_v2 at 128 and alexnet at 128 (227 x 227), float32 and
   bf16_mixed, 3 warm-up and 10 timed steps: ms a step, images/s, the
   layer-shape TFLOP/s, peak memory, a profiled window's idle share;
   (c) ``Inception_v1_NoAuxClassifier`` (its ``Dropout(0.4)`` in the top
   ``Sequential``, which hands the step's generator on) at batch 32, 16
   steps at K = 8 (CUDA graphs) and K = 1 bitwise alike under cuDNN's
   deterministic algorithms, another seed other losses; (d)
   ``vgg.train --synthetic 1024 -b 112 -e 2`` with a checkpoint an
   epoch (random labels: finite losses, 2 checkpoints), then 8 epochs
   on a seeded learnable CIFAR-format folder (losses fall; held-out
   Top1 above 0.5 with BN's running statistics re-estimated over the
   training rows, the plain one reported); ``vgg.test --model`` scores
   each saved trained module at its last validation's Top1,
   ``inception.train --synthetic 256 -b 64 -e 1`` (finite losses),
   ``autoencoder.train --synthetic 6000 -b 150 -e 2`` (the MSE falls);
   no kernel of the ``kernels`` line may launch in (a)-(d); (e) int8
   VGG-16 at batch 64, the counts set to 0 around 2 int8 forwards: K5
   launched 3 a forward (fc6 ``[64, 25088] x [4096, 25088]``, fc7, fc8),
   and 3 K5 GEMM kernels in one profiled forward; each call's operands
   through K5 bitwise its plain version, a flipped weight byte not; the
   logits with K5 bitwise those with the kernels off, a flipped fc8
   byte not; rows ``int8_gemm_vgg16_fc6`` / ``_fc7`` / ``_fc8`` of the
   kernels line (their times from phase 3, L2-cold, beside K5's plain
   version and ``torch._int_mm`` + epilogue); int8-against-float top-1
   agreement printed, not gated;
16. long-context training in bf16_mixed (``phase_longctx_bf16``, run
   after phase 6) — the LONGCTX row through
   ``LocalOptimizer(...).set_precision("bf16_mixed")`` at K = 1, SGD lr
   0.1, phase 6's stream, ``LC_ITERS`` iterations: one step with K2 in
   bfloat16 against the einsum path (bfloat16 too) at phase 11's limits,
   which ``PREC_FAULTS`` put into K2's backward must fail; K2's forward
   and backward launched once a layer and iteration and K1 never;
   falling losses; ms a step and tokens/s; a profiled window whose K2
   kernels are all bfloat16 instances, once a layer and step (idle
   share, K2's device ms a step); then one bf16_mixed step at S = 32768
   with its peak memory. Its K2 launches are the bfloat16 rows'
   ``launches`` in the kernels line.

Float32 throughout phases 1–10, with TF32 off for matrix products (set
here) and for convolutions (PyTorch's default is on; the port's
convolution layers switch it off, and phase 8 checks that they did): the
tolerances below assume full float32. Phase 11 runs the precision
policies, with limits of their own; phase 12 (a) runs bf16_mixed at
phase 11's limits, (b)-(f) float32 (float64 for LBFGS's card-against-CPU
check); phase 13 (a) runs bf16_mixed at phase 11's limits, (b) and (c)
float32; phase 14 float32; phase 15 float64 in (a), float32 and
bf16_mixed in (b), float32 in (c)-(e); phase 16 bf16_mixed at phase
11's limits.

The line before the last is a JSON object ``{"kernels": [...]}`` with
each kernel's launches, error and times (``ms`` and ``device_ms``, and
``library_ms`` and ``library_device_ms``; K3's and K4's split plan;
every profiler window read for a ``device_ms``, with the SM clock
sampled while it ran);
the last line is
``{"ok": true, "device": {...}}``. Without a card, or run outside the
repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import math
import re
import subprocess
import sys
import threading
import time

import numpy as np

# ---- the serving slice (bench.py's GENERATION row) ----
VOCAB, HIDDEN, LAYERS, HEADS, FFN, MAX_LEN = 8192, 512, 6, 8, 2048, 512
SLOTS, PREFILL_ROWS, N_GREEDY, N_TOPK, MAX_NEW = 16, 4, 32, 4, 32
TOP_K, TEMPERATURE = 20, 0.8
HEAD_DIM = HIDDEN // HEADS

# ---- the training slice (tools/ceiling.py's TransformerLM row) ----
TRAIN_VOCAB, TRAIN_SEQ, TRAIN_BATCH = 32000, 512, 16
TRAIN_ITERS, TRAIN_LR, TRAIN_SYNTHETIC = 30, 0.1, 262144
PROFILE_STEPS = 3

# ---- the long-context slice (bench.py's LONGCTX row) ----
LC_VOCAB, LC_LAYERS, LC_SEQ, LC_SEQ_MAX = 8192, 2, 8192, 32768
LC_ITERS, LC_SYNTHETIC, LC_CHUNK, LC_NEW = 20, 300000, 2048, 8
LC_K6_SHAPE = (1, 8, 16384, 128)   # [B, H, S, D]: 8.6 GB of f32 scores

# ---- the int8 serving slice (bench.py's PRECISION row, serving leg) ----
RESNET_CLASSES, RESNET_DEPTH, RESNET_DATASET, IMAGE = 1000, 50, "ImageNet", 224
RESNET_SEED, SERVE_BATCH, CALIB_BATCHES, CALIB_ROWS = 23, 64, 2, 16
GATE_ROWS, GATE_DELTA = 64, 0.02
BURST_SINGLES, BURST_BATCHES, FULL_BATCHES, PROFILE_BATCHES = 16, 12, 8, 4

# ---- the LeNet-5 slice (BASELINE config 1, MNIST's size, synthetic) ----
LENET_ROWS, LENET_BATCH, LENET_LR, LENET_MOMENTUM = 60000, 128, 0.05, 0.9
#: the separable task: training and held-out rows, the Top1 it must
#: reach, and the epochs it may take
LENET_TRAIN_ROWS, LENET_HELD_ROWS, LENET_TOP1, LENET_EPOCHS = \
    2048, 1024, 0.95, 10
#: card against CPU: steps, and the limits on the losses (relative) and
#: the parameters (absolute)
LENET_PARITY_STEPS, LENET_LOSS_RTOL, LENET_PARAM_ATOL = 10, 1e-4, 1e-4
LENET_PROFILE_STEPS = 20

# ---- the ResNet-50 training slice (BASELINE config 3: ImageNet, batch 256,
# SGD lr 0.1, momentum 0.9, nesterov, weight decay 1e-4, EpochDecay) ----
RT_ROWS, RT_BATCH, RT_EPOCHS, RT_PROFILE_STEPS = 1024, 256, 2, 10
#: (b) resume against an uninterrupted run: one batch of rows (an epoch
#: a step), epochs, and the limits on parameters and BN statistics
#: (absolute) and the last loss (relative)
RT_RESUME_BATCH, RT_RESUME_EPOCHS = 64, 4
RT_RESUME_ATOL, RT_RESUME_LOSS_RTOL = 1e-5, 1e-5
#: (d) card against CPU: batch, steps, seed of the rows, and the limits
#: on the losses (relative) and parameters and BN statistics (absolute)
RT_PARITY_BATCH, RT_PARITY_STEPS, RT_PARITY_SEED = 4, 3, 24
RT_PARITY_LOSS_RTOL, RT_PARITY_ATOL = 1e-4, 1e-4

# ---- the precision slice (queue 1, item 5): precision policies and
# windows of steps as CUDA graphs, at the training slice's width ----
#: (a) bf16_mixed: iterations and steps a window through LocalOptimizer
PREC_ITERS, PREC_K = 30, 8
#: (a) one bf16_mixed step, kernel against the einsum path (bf16 too):
#: the loss (relative), the parameters after the update (the largest
#: difference over the step's largest update) and every gradient
#: (relative to its largest element, floored as in the train phase). bfloat16 keeps 8 bits (one rounding: 2^-9 relative);
#: K1 holds the bf16 contract of 1e-2; the einsum path rounds P and dP
#: to bfloat16 before its products and the softmax backward's
#: subtraction, which cancels, so its dQ and dK carry errors of a few
#: 1e-3 element-wise; summed over the 8192 tokens of a batch into a
#: weight gradient they shrink. 5e-2 allows 25 roundings; the faults
#: (dK zeroed, dQ 10% off) move a gradient by 1 and by 0.1 of itself.
#: The first SGD step's update is the rate times the float32 gradient,
#: so the parameters' ratio is at most the worst gradient's (its
#: denominator, the largest update of all, is no smaller): it holds the
#: update to the gradients' limit, in the update's own unit.
PREC_LOSS_RTOL, PREC_PARAM_RTOL, PREC_GRAD_RTOL = 1e-2, 5e-2, 5e-2
PREC_FAULTS = ("dK zeroed", "dQ 10% off")
#: (b) f16_mixed: one window of steps from this scaler (its first step
#: must overflow; every step that overflows is checked, and at least
#: one must apply), SGD with momentum
F16_ITERS, F16_SCALER = 8, {"init_scale": 2.0 ** 24, "growth_interval": 4}
F16_MOMENTUM = 0.9
#: (c) windowed against per-step, bitwise: LeNet-5 f16_mixed (steps, the
#: checkpoint interval, rows; a scaler that grows every 2 steps, so it
#: overflows and backs off again and again), TransformerLM bf16_mixed
WIN_LENET_STEPS, WIN_LENET_CKPT, WIN_LENET_ROWS = 24, 12, 4096
WIN_LENET_SCALER = {"init_scale": 2.0 ** 20, "growth_interval": 2}
WIN_LM_LAYERS, WIN_LM_STEPS = 2, 16
#: (e) ResNet-50 float32 against bf16_mixed: batch, profiled steps and
#: plain SGD's rate (one batch again and again, a fixed objective, at a
#: rate small enough that it falls; the recipe's lr 0.1 with nesterov
#: momentum diverges on one random batch)
RP_BATCH, RP_STEPS, RP_LR = 64, 5, 0.01

# ---- the optim slice (queue 1, item 6): the other OptimMethods and
# schedules, LBFGS, retry from checkpoint; Adam at the training width ----
#: (a) Adam under bf16_mixed: its rate, the steps of the windowed and
#: the per-step run, the steps a window (the one-step check holds phase
#: 11's limits, PREC_*)
ADAM_LR, OPT_STEPS, OPT_K = 1e-3, 16, 8
#: (b) each method on LeNet-5 (batch LENET_BATCH), card against CPU over
#: these steps within LENET_LOSS_RTOL / LENET_PARAM_ATOL, at the rates
#: their users train with
OPT_PARITY_STEPS = 5
OPT_METHODS = {
    "SGD": {"learning_rate": LENET_LR, "momentum": LENET_MOMENTUM},
    "Adam": {"learning_rate": 1e-3},
    "Adagrad": {"learning_rate": 1e-2, "weight_decay": 1e-3},
    "Adadelta": {},
    "Adamax": {},
    "RMSprop": {"learning_rate": 1e-3},
    "Ftrl": {"learning_rate": 0.1, "l1_regularization_strength": 1e-3,
             "l2_regularization_strength": 1e-3}}
#: (c) SGD with a warm-up then Poly, windows of OPT_K across the warm-up's
#: end: warm-up iterations and its delta, Poly's iterations, the steps
SCHED_WARMUP, SCHED_DELTA, SCHED_POLY, SCHED_STEPS = 12, 0.002, 40, 24
#: (d) Plateau on the held-out Top1 (mode max; an epsilon no Top1 can
#: beat, so every record after the first waits): batches an epoch,
#: epochs, patience, factor
PLATEAU_BATCHES, PLATEAU_EPOCHS, PLATEAU_PATIENCE, PLATEAU_FACTOR = \
    3, 4, 2, 0.1
#: (e) LBFGS with strong-Wolfe, full batch: rows (MNIST's training set)
#: and iterations in float32; rows, iterations and limit of the float64
#: card-against-CPU check (relative on f, absolute on the parameters)
LBFGS_ROWS, LBFGS_ITERS = 60000, 20
LBFGS_F64_ROWS, LBFGS_F64_ITERS, LBFGS_F64_TOL = 4096, 3, 1e-10
#: (f) retry: steps, checkpoint interval, the step whose batch raises
#: once, batches an epoch (checkpoint.4 then falls at an epoch's start)
RETRY_STEPS, RETRY_CKPT, RETRY_FAIL_AT, RETRY_BATCHES = 12, 4, 6, 3

# ---- the LM slice (queue 1, item 7): MoE blocks with the aux loss,
# dropout, the text CLIs; the training width ----
#: (a) the repo's moe recipe's layout (bigdl_tpu/tools/convergence.py:
#: 336-352: 4 experts, top-2, every 2nd block, Adam 1e-3) at the
#: training cell's width under bf16_mixed: steps of the windowed and
#: the per-step run, steps a window, the load-balance weight
MOE_EXPERTS, MOE_EVERY, MOE_STEPS, MOE_K, AUX_WEIGHT = 4, 2, 16, 8, 0.01
#: the aux fault: the router gradient's largest change from weight 0 to
#: AUX_WEIGHT must exceed this fraction of its largest element (a
#: rounding difference does not)
AUX_FAULT_MIN_FRACTION = 0.1
#: (b) the dense training cell in float32 at this attention dropout:
#: steps, steps a window, the run's seed and the other seed's steps
DROPOUT, DROP_STEPS, DROP_K, DROP_SEED, DROP_OTHER_STEPS = \
    0.1, 16, 8, 61, 2
#: (c) the CLIs on a seeded PTB-style corpus: words a line (range), the
#: vocabulary drawn from, train and test lines, and the width
CLI_LINE_WORDS, CLI_VOCAB, CLI_TRAIN_LINES, CLI_TEST_LINES = \
    (4, 20), 2000, 600, 200
CLI_WIDTH = ["--hiddenSize", "128", "--layers", "2", "--heads", "4",
             "--seqLen", "64", "-b", "8", "--vocabSize", "1000"]
#: the test CLI's perplexity against exp of a direct mean NLL (relative)
CLI_PPL_RTOL = 1e-5

# ---- the fleet slice (queue 1, item 8; bench.py's FLEET row) ----
#: (a) the prefix cache's budget (bench.py:731) and the prompts served
#: cold, then again
FLEET_PREFIX_BYTES, FLEET_HIT_PROMPTS = 256 << 20, 8
#: (b) the tokens two long prompts share (3 chunks of LC_CHUNK)
FLEET_SHARED = 6144
#: (c) the draft (bench.py:758-760: half the width, one layer, its own
#: seed) and the draft width (bench.py:774-776)
SPEC_K, SPEC_DRAFT_HIDDEN, SPEC_DRAFT_LAYERS, SPEC_DRAFT_SEED = 4, 256, 1, 13
#: the target as its own draft: the least accept rate, and the widest
#: verify top-2 gap a rejection may have (draft decode runs K3, verify
#: the masked path: only near-ties may disagree)
SPEC_SELF_ACCEPT, SPEC_TIE_GAP = 0.99, 1e-3
#: (e) the router's burst: requests (prompts of MAX_LEN // 4), new tokens
ROUTER_REQUESTS, ROUTER_NEW = 24, 8

# ---- the image zoo slice (queue 1, item 9; BASELINE.md:11's
# DistriOptimizerPerf models) ----
#: (a) one SGD step card against CPU in float64 at batch 2, each model at
#: its full input size (the weights' seed, the rows' seed): loss
#: relative and parameters absolute within ZOO_F64_TOL. The rows are
#: mean-subtracted pixel values (U[0, 255) - 128, the Caffe-era models'
#: input scale), where the LRNs act: at U[0, 1) a cross-map LRN with
#: alpha 1e-4 is the identity to 1e-8 and no check can see its beta
ZOO_PARITY = (("Vgg_16", 224), ("Inception_v1_NoAuxClassifier", 224),
              ("Inception_v2_NoAuxClassifier", 224), ("AlexNet", 227))
ZOO_PARITY_BATCH, ZOO_SEED, ZOO_ROWS_SEED = 2, 31, 32
#: float64 agrees to ~1e-12 on these steps; the planted fault (one LRN's
#: beta + 1e-3) moves Inception v1's loss by ~1e-5 relative and its
#: parameters by ~5e-6 (CPU runs of the port), under the 1e-4 a float32
#: check would need, so float64 is gated at 1e-8
ZOO_F64_TOL, ZOO_LRN_FAULT = 1e-8, 1e-3
#: (b) tools/perf at full width: model, batch; 3 warm-up and 10 timed
#: iterations in float32 and bf16_mixed, a profiled window of 5
ZOO_PERF = (("vgg16", 64), ("inception_v1", 128), ("inception_v2", 128),
            ("alexnet", 128))
ZOO_PERF_WARMUP, ZOO_PERF_ITERS, ZOO_PERF_PROFILE = 3, 10, 5
#: (c) dropout through the containers: Inception v1 without the aux heads
#: (its Dropout(0.4) in the top Sequential) at batch 32, steps, window,
#: seeds, the other seed's steps
ZOO_DROP_BATCH, ZOO_DROP_STEPS, ZOO_DROP_K = 32, 16, 8
ZOO_DROP_SEED, ZOO_DROP_OTHER_STEPS = 33, 2
#: (d) the recipes: vgg.train's rows, batch, epochs (``--synthetic``,
#: random labels); again on a learnable CIFAR-format folder. There the
#: evaluation-mode Top1 lags what the weights have learnt, in both
#: packages: BN's running statistics (momentum 0.1, from a variance of
#: 1) trail the batches' (after 20 steps a running variance was 12x the
#: rows' and the Top1 0.11; after 80 steps 0.39 on the CPU, 0.17 on the
#: card), so the trained module is scored again with its BN statistics
#: re-estimated over the training rows, which must pass
#: ZOO_VGG_MIN_TOP1 (chance is 0.1; 0.60 after 20 steps on the CPU);
#: inception.train's; autoencoder.train's
ZOO_VGG_RECIPE = (1024, 112, 2)
ZOO_VGG_LEARN, ZOO_VGG_MIN_TOP1 = (1024, 112, 8), 0.5
ZOO_INCEPTION_RECIPE = (256, 64, 1)
ZOO_AE_RECIPE = (6000, 150, 2)
#: (e) int8 VGG-16 at batch 64: K5 at fc6, fc7 and fc8, the int8
#: forwards counted, the operand sets fc6 is timed over (3 x 103 MB of
#: weights, past the 50 MB L2)
ZOO_INT8_BATCH, ZOO_INT8_FORWARDS, ZOO_INT8_SETS = 64, 2, 3
ZOO_FC_SHAPES = {"fc6": (64, 4096, 25088), "fc7": (64, 4096, 4096),
                 "fc8": (64, 1000, 4096)}

# ---- K5 and K4 shapes ----
INT8_EDGE_M, INT8_EDGE_N, INT8_EDGE_K = (1, 7, 64, 65, 300), \
    (1, 1000, 1024), (1, 3, 2048, 4100)
INT8_MAIN_SHAPE = (SERVE_BATCH, RESNET_CLASSES, 2048)   # (M, N, K)
INT8_BIG_SHAPE = (4096, 4096, 4096)     # BASELINE.md's int8 sweep
PAGE_SIZES = (16, 64, 128)

# ---- the card (NVIDIA's H100 SXM data sheet) ----
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
#: float32-accurate products on the tensor cores as 3xTF32 (three tf32
#: MMAs a product, of the 495 TFLOP/s dense TF32 rate): the arithmetic
#: of K1's and K2's forwards and of the backward they share
TF32X3_FLOPS_PER_S = 495e12 / 3
BF16_FLOPS_PER_S = 989e12        # bfloat16 on the tensor cores
INT8_OPS_PER_S = 1979e12         # int8 on the tensor cores, dense

#: kernel vs plain version on the same inputs: float32 absolute (the
#: JAX kernel contract's row); bfloat16 and float16 relative to max(1,
#: |plain|), i.e. about one rounding step of the output (the two round
#: the same float32 value after summing in another order)
RAGGED_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2e-3}
#: K1 vs its plain versions: the forward (O, lse) at the float32
#: contract's 1e-5 and the gradients at its 2e-4 (docs/kernels.md);
#: bfloat16 and float16 outputs relative to max(1, |plain|) as for K3,
#: about one rounding step of each (lse is float32 in every dtype and
#: keeps 1e-5)
FLASH_FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2e-3}
FLASH_BWD_TOL = {"float32": 2e-4, "bfloat16": 1e-2, "float16": 2e-3}
#: one training step, kernel vs einsum path: loss and every parameter
TRAIN_PARITY_TOL = 1e-5
#: the first token's logits, chunked vs single-shot prefill (float32;
#: two einsum paths over other chunkings of the same sums)
PREFILL_LOGITS_TOL = 1e-4
#: ... and every parameter's gradient, relative to the largest element of
#: the einsum path's gradient of that parameter, or to TRAIN_GRAD_FLOOR of
#: the largest gradient element in the model where that is larger (a key
#: bias's gradient is zero in exact arithmetic: it shifts a row of scores
#: by a constant, which the softmax takes out, so it holds only noise)
TRAIN_GRAD_RTOL = 1e-4
TRAIN_GRAD_FLOOR = 1e-2
#: a served float ResNet row against the direct forward of its request
#: alone, relative to the largest logit: cuDNN picks its algorithm by
#: batch size, so the two sum in other orders through 53 layers
F32_SERVE_RTOL = 1e-3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, n_inputs: int, rounds: int) -> float:
    """Mean device time of ``fn(i)`` with CUDA events, cycling over
    ``n_inputs`` input sets large enough together to leave the L2 cache
    cold for each call (as the decode step finds each layer's cache)."""
    import torch

    for i in range(n_inputs):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        for i in range(n_inputs):
            fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (rounds * n_inputs)


#: seconds a profiler window stays open before the first and after the
#: last kernel it times. Kernels that end close to a window's edge go
#: missing from it: on the H100, of windows closed right after a
#: synchronize 19 of 354 one-call windows lost all their kernels and 15
#: of 354 400-call windows lost up to 402 of 800; with 50 ms on each
#: side none of 708 lost any (:func:`probe_windows`, 240 s)
WINDOW_MARGIN_S = 0.05


def profiled(run, margin_s: float = WINDOW_MARGIN_S):
    """``torch.profiler`` (device activity) over one ``run()``, after a
    warm-up step of one small kernel, with ``margin_s`` of idle time
    between the window's edges and the calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        prof.step()
        time.sleep(margin_s)
        run()
        torch.cuda.synchronize()
        time.sleep(margin_s)
        prof.step()
    return prof


def probe_windows(seconds: float) -> dict:
    """Do profiler windows lose the kernels at their edges? For
    ``seconds``, times windows of 1 and of 400 calls (two small
    elementwise kernels a call) with no margin and with
    :data:`WINDOW_MARGIN_S`, prints each round's kernels missing from
    each case, and returns how many windows of each case came up short
    (``python3 -c "import chip_smoke; chip_smoke.probe_windows(240)"``
    on one card). Not part of the smoke run."""
    import torch

    x = torch.randn(256, 256, device="cuda")
    y = torch.randn(256, 256, device="cuda")

    def run(n):
        for _ in range(n):
            torch.add(x, y)
            torch.mul(x, y)

    cases = [(m, n) for m in (0.0, WINDOW_MARGIN_S) for n in (1, 400)]
    short = {f"margin {m} s, {n} calls": 0 for m, n in cases}
    rounds, t0 = 0, time.time()
    while time.time() - t0 < seconds:
        row = {"t": round(time.time() - t0, 1)}
        for m, n in cases:
            got = sum(count for _, count, _ in device_kernels(
                profiled(lambda: run(n), m)))
            row[f"margin {m} s, {n} calls"] = lost = 2 * n - got
            short[f"margin {m} s, {n} calls"] += lost > 0
        print(json.dumps(row), flush=True)
        rounds += 1
        run(2000)               # keep the card busy between rounds
        torch.cuda.synchronize()
    summary = {"device": torch.cuda.get_device_name(0), "rounds": rounds,
               "short windows": short}
    print(json.dumps(summary), flush=True)
    return summary


#: NVML, the library nvidia-smi reads the card with: ``(library, handle
#: of device 0, reasons function)`` once loaded, False where the driver's
#: library is missing
_NVML = None
NVML_CLOCK_SM = 1


def sm_clock():
    """``(SM clock in MHz, clock-event reasons bitmask)`` of card 0 from
    NVML, or None where NVML is missing. The reasons' bits say why the
    clock is below its maximum: 0x1 idle, 0x4 the power cap, 0x20 and
    0x40 thermal slowdown, 0x80 the power brake."""
    global _NVML
    if _NVML is None:
        _NVML = False
        with contextlib.suppress(OSError, AttributeError):
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            # the reasons' function, under its name since NVML 12.2 or
            # under the older one
            why = getattr(lib, "nvmlDeviceGetCurrentClocksEventReasons",
                          None)
            why = why or lib.nvmlDeviceGetCurrentClocksThrottleReasons
            handle = ctypes.c_void_p()
            if lib.nvmlInit_v2() == 0 and lib.nvmlDeviceGetHandleByIndex_v2(
                    0, ctypes.byref(handle)) == 0:
                _NVML = (lib, handle, why)
    if not _NVML:
        return None
    lib, handle, why = _NVML
    mhz, reasons = ctypes.c_uint(), ctypes.c_ulonglong()
    if lib.nvmlDeviceGetClockInfo(handle, NVML_CLOCK_SM, ctypes.byref(mhz)):
        return None
    why(handle, ctypes.byref(reasons))
    return mhz.value, reasons.value


@contextlib.contextmanager
def clock_samples(every_s: float = 0.005):
    """:func:`sm_clock` every ``every_s`` seconds on a thread while the
    block runs; yields the list the samples go to (empty without NVML)."""
    samples = []
    if sm_clock() is None:
        yield samples
        return
    stop = threading.Event()

    def sample():
        while not stop.wait(every_s):
            got = sm_clock()
            if got is not None:
                samples.append(got)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield samples
    finally:
        stop.set()
        thread.join()


#: device_ms's profiler windows: how many were read, how many were
#: retaken because they recorded fewer kernels than the calls launch,
#: how many rows read their pair of windows again because the two
#: disagreed, the largest spread of a pair that was kept and of one that
#: was read again (relative to the smaller window), and the rows timed by
#: CUDA-graph replays because a single call's windows showed no kernel,
#: and the rows whose single-call windows did not all count the same
WINDOWS = {"read": 0, "retaken": 0, "pairs read again": 0,
           "largest spread": 0.0, "largest spread read again": 0.0,
           "graph rows": 0, "singles disagreed": 0}
#: retakes of a window that lost kernels (each window's own); fresh pairs
#: read after a pair that disagreed; the largest spread of a kept pair
WINDOW_RETAKES, PAIR_RETAKES, WINDOW_SPREAD = 2, 2, 0.10
#: single-call windows whose median count is the kernels a call launches
SINGLES = 3
#: least device time (ms) a window times: a row of long calls repeats
#: its cycle until its window holds this much work, so that one call
#: that runs a few ms slow moves the window by a few percent (at 32768
#: tokens one K2 forward window of one call read 22.02 and the next
#: 25.50 ms on the H100) ...
WINDOW_MIN_MS = 100.0
#: ... unless that takes a window past this many kernels
WINDOW_MAX_KERNELS = 800


def _window(run):
    """``(device ms, kernels launched, SM clock samples, kernels)`` of
    one profiled ``run()`` (``kernels`` as :func:`device_kernels` lists
    them); the clock is sampled from the first call to the synchronize
    after the last."""
    import torch

    clocks = []

    def sampled():
        with clock_samples() as got:
            run()
            torch.cuda.synchronize()
        clocks.extend(got)

    kernels = device_kernels(profiled(sampled))
    return (sum(ms for ms, _, _ in kernels),
            sum(count for _, count, _ in kernels), clocks, kernels)


def device_ms(fn, n_inputs: int, rounds: int):
    """Mean device time of ``fn(i)`` over the same cycled, L2-cold calls
    as :func:`time_ms`, without the host's launch path: the durations of
    the kernels the calls launched, read from ``torch.profiler``
    (:func:`device_kernels`) and summed — a call of several kernels (a
    backward, split-K's two, a library call and its float epilogue)
    counts them all — over the calls.

    A profiler window can lose kernels, so each window's kernel count is
    held against the calls it timed, at the kernels one call launches:
    the median count of ``SINGLES`` untimed, profiled single calls, so
    that one single window that lost its kernels, or caught a kernel
    that is not the call's (one did: a library call of 4 kernels read 5,
    and every window of 240 calls then read 960 of "1200"), sets
    neither; singles that disagree are logged with their kernels. A window
    that recorded fewer is retaken, up to ``WINDOW_RETAKES`` times. Each
    window times at least ``WINDOW_MIN_MS`` of work where
    ``WINDOW_MAX_KERNELS`` allows, after two untimed cycles of the same
    calls that bring the card's clock to where this work holds it. A row
    reads a pair of windows and returns their median. A pair more than
    ``WINDOW_SPREAD`` apart is logged whole and a fresh pair read, up to
    ``PAIR_RETAKES`` times; the phase fails if the last pair still
    disagrees, or if a window still loses kernels. Every window's reading
    and the SM clock sampled while it ran (:func:`sm_clock`) are logged
    and returned. Where the profiler shows no device kernel at all, one
    cycle is captured as a CUDA graph and its replays are timed with
    events instead. Returns ``(ms, windows)``; ``windows`` says how the
    time was read and lists every pair of windows read."""
    import torch

    for i in range(n_inputs):
        fn(i)
    torch.cuda.synchronize()
    singles = [_window(lambda: fn(0)) for _ in range(SINGLES)]
    per_call = int(np.median([single[1] for single in singles]))
    if any(single[1] != per_call for single in singles):
        WINDOWS["singles disagreed"] += 1
        log("device_ms", f"single-call windows disagree, {per_call} "
                         f"kernels a call taken: " + json.dumps(
                             [[(n, key[:80]) for _, n, key in single[3]]
                              for single in singles]))
    if per_call > 0:
        call_ms = max(ms for ms, count, _, _ in singles
                      if count == per_call)
        reps = max(1, min(math.ceil(WINDOW_MIN_MS / (call_ms * rounds
                                                     * n_inputs)),
                          WINDOW_MAX_KERNELS // (per_call * rounds
                                                 * n_inputs)))
        calls = reps * rounds * n_inputs
        expected = per_call * calls
        lost = 0

        def cycle():
            for _ in range(reps * rounds):
                for i in range(n_inputs):
                    fn(i)

        def window():
            nonlocal lost
            total, launched, clocks, _ = _window(cycle)
            for _ in range(WINDOW_RETAKES):
                if launched >= expected:
                    break
                lost += 1
                total, launched, clocks, _ = _window(cycle)
            if launched < expected:
                raise RuntimeError(
                    f"device_ms: a profiler window recorded {launched} of "
                    f"the {expected} kernels its {calls} calls launched, "
                    f"after {WINDOW_RETAKES} retakes")
            reasons = 0
            for _, bits in clocks:
                reasons |= bits
            return {"ms": total / calls,
                    "sm_mhz": [min(m for m, _ in clocks),
                               max(m for m, _ in clocks)] if clocks
                    else "not sampled",
                    "clock_events": hex(reasons) if clocks
                    else "not sampled"}

        cycle()
        cycle()
        torch.cuda.synchronize()
        pairs = []
        for attempt in range(1 + PAIR_RETAKES):
            pair = [window(), window()]
            pairs.append(pair)
            times = [w["ms"] for w in pair]
            spread = (max(times) - min(times)) / min(times)
            log("device_ms", f"profiler, windows of {calls} calls: "
                             f"{json.dumps(pair)}, spread {spread:.2%}")
            if spread <= WINDOW_SPREAD or attempt == PAIR_RETAKES:
                break
            WINDOWS["pairs read again"] += 1
            WINDOWS["largest spread read again"] = max(
                WINDOWS["largest spread read again"], spread)
            log("device_ms", f"the pair is more than {WINDOW_SPREAD:.0%} "
                             f"apart: reading a fresh pair")
        WINDOWS["read"] += 2 * len(pairs) + lost
        WINDOWS["retaken"] += lost
        if spread > WINDOW_SPREAD:
            raise RuntimeError(
                f"device_ms: {len(pairs)} pairs of windows, the last still "
                f"more than {WINDOW_SPREAD:.0%} apart: {pairs}")
        WINDOWS["largest spread"] = max(WINDOWS["largest spread"], spread)
        return float(np.median(times)), {
            "by": "profiler", "calls": calls, "retaken_for_lost_kernels":
                lost, "pairs": pairs}
    WINDOWS["graph rows"] += 1
    log("device_ms", "a single call's profiler windows showed no kernel; "
                     "the next row is timed by CUDA-graph replays")
    return graph_ms(fn, n_inputs, rounds)


def graph_ms(fn, n_inputs: int, rounds: int):
    """Mean time of ``fn(i)`` over ``n_inputs`` cycled calls captured as
    one CUDA graph, its ``rounds`` replays timed with CUDA events (no
    host launch path): :func:`device_ms`'s reading where the profiler
    shows nothing. Returns ``(ms, {"by": "cuda graph replays"})``."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_inputs):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_inputs):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / (rounds * n_inputs),
            {"by": "cuda graph replays"})


def ragged_bound(lengths, t: int, itemsize: int, heads: int = HEADS,
                 d: int = HEAD_DIM):
    """Least time (ms) the card needs for one ragged-decode call: each
    valid K and V row read once, q read and the output written once,
    against 4 flops per valid cached element in float32."""
    n = np.clip(np.asarray(lengths, np.int64), 1, t)
    slots = len(n)
    rows = int(n.sum()) * heads
    nbytes = (rows * d * 2 * itemsize + 2 * slots * heads * d * itemsize
              + slots * 4)
    flops = rows * d * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_device():
    import torch

    # matrix products in full float32 (PyTorch's default, set
    # explicitly); convolutions are the int8 serving phase's check: the
    # port must switch cuDNN's TF32 default off itself
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind}; count {torch.cuda.device_count()}; torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}; "
                  f"matmul TF32 off")
    print(smi[0], flush=True)
    return kind, smi[0]


def phase_build():
    from bigdl_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log("build", f"{sorted(paths)} built in "
                 f"{time.perf_counter() - t0:.2f} s with "
                 f"{_build.nvcc_path()} {' '.join(_build.NVCC_FLAGS)}")
    for name in sorted(paths):
        # ptxas -v names each kernel instance, then its registers and
        # spills: one line per instance
        fn, lines = None, {}
        for line in _build.build_log(name).splitlines():
            m = re.search(r"(?:entry function|properties for) '?(\w+)", line)
            if m:
                fn = kernel_instance(m.group(1))
                continue
            line = line.split(":", 1)[-1].strip()
            if fn and ("registers" in line or "spill" in line):
                lines.setdefault(fn, []).append(line)
        for fn, info in sorted(lines.items()):
            log("build", f"{name}: {fn}: {'; '.join(info)}")
    check_mmas(paths)


#: the flash kernels by library, and the tensor-core MMAs (SASS
#: ``HMMA``, ``HGMMA``) their instances must show: in float32 every
#: kernel runs 3xTF32 (``HMMA ... TF32``); in bfloat16 and float16
#: "dtype" kernels run m16n8k16 on 16-bit operands (``HMMA.16816 ...
#: BF16``, or without ``BF16`` for float16) and "wgmma" kernels run
#: ``wgmma.mma_async`` (``HGMMA ... BF16``, or without ``BF16``), either
#: with no TF32 HMMA: both forwards on mma.sync, the backward both
#: libraries build (flash_common.cuh) on wgmma
FLASH_MMAS = {name: {fwd: "dtype", "flash_dkv_kernel": "wgmma",
                     "flash_dq_kernel": "wgmma"}
              for name, fwd in (
                  ("blockwise_flash_attention", "blockwise_fwd_kernel"),
                  ("flash_attention", "flash_fwd_kernel"))}


def check_mmas(paths) -> None:
    """Count the tensor-core MMAs (SASS ``HMMA`` and ``HGMMA``, by
    opcode) of each kernel instance in the flash libraries with
    ``cuobjdump -sass``, log them, and fail unless each instance of a
    ``FLASH_MMAS`` kernel runs the MMAs its dtype calls for: TF32 in
    float32; in bfloat16 and float16, m16n8k16 HMMAs ("dtype") or
    HGMMAs ("wgmma") of that dtype and no TF32 HMMA."""
    import os

    from bigdl_tpu_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    for name, kernels in sorted(FLASH_MMAS.items()):
        sass = subprocess.run([tool, "-sass", str(paths[name])],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = kernel_instance(m.group(1))
                counts.setdefault(fn, {})
                continue
            m = re.search(r"\b(H(?:G)?MMA\.\S+)", line)
            if fn and m:
                counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
        log("build", f"{name}: HMMA / HGMMA opcodes per kernel instance: "
                     + json.dumps(counts, sort_keys=True))
        seen, bad = set(), []
        for fn, ops in sorted(counts.items()):
            # an instance's name carries its namespace's mangled prefix
            kernel = next((k for k in kernels
                           if fn.split("<")[0].endswith(k)), None)
            if kernel is None:
                continue
            dtype = fn.split("<")[1].split(",")[0].rstrip(">")
            seen.add((kernel, dtype))
            tf32 = sum(n for op, n in ops.items() if "TF32" in op)
            k16 = {"bf16": sum(n for op, n in ops.items()
                               if "16816" in op and "BF16" in op),
                   "f16": sum(n for op, n in ops.items()
                              if "16816" in op and "BF16" not in op
                              and "TF32" not in op)}
            wg = {"bf16": sum(n for op, n in ops.items()
                              if op.startswith("HGMMA") and "BF16" in op),
                  "f16": sum(n for op, n in ops.items()
                             if op.startswith("HGMMA") and "BF16" not in op)}
            if dtype == "f32":
                ok = tf32 > 0
            elif kernels[kernel] == "wgmma":
                ok = wg[dtype] > 0 and tf32 == 0 and sum(wg.values()) \
                    == wg[dtype] and sum(k16.values()) == 0
            else:
                ok = k16[dtype] > 0 and tf32 == 0 and sum(k16.values()) \
                    == k16[dtype]
            log("build", f"{name}: {fn}: tf32 HMMA {tf32}, bf16 m16n8k16 "
                         f"{k16['bf16']}, f16 m16n8k16 {k16['f16']}, bf16 "
                         f"HGMMA {wg['bf16']}, f16 HGMMA {wg['f16']}"
                         f"{'' if ok else ' -- WRONG'}")
            if not ok:
                bad.append(fn)
        missing = sorted({(k, d) for k in kernels
                          for d in ("f32", "bf16", "f16")} - seen)
        if bad or missing:
            raise AssertionError(f"{name}: instances without the MMAs "
                                 f"their dtype calls for: {bad}; no "
                                 f"instance of {missing}")


def kernel_instance(mangled: str) -> str:
    """``flash_fwd_kernel<f32, 64>``, ``int8_gemm_kernel<128, 128>`` (or
    ``int8_splitk_reduce_kernel``) from a kernel's mangled name."""
    m = re.search(r"([A-Za-z]+(?:_[A-Za-z0-9]+)*_kernel)I"
                  r"(f|13__nv_bfloat16|6__half)(?:Li(\d+)E)?", mangled)
    if not m:
        m = re.search(r"\d([A-Za-z]\w*_kernel)I((?:Li\d+E)+)E", mangled)
        if m:
            return (f"{m.group(1)}<"
                    f"{', '.join(re.findall(r'Li(\d+)E', m.group(2)))}>")
        m = re.search(r"\d([A-Za-z]\w*_kernel)E", mangled)
        return m.group(1) if m else mangled
    dtype = {"f": "f32", "6__half": "f16"}.get(m.group(2), "bf16")
    return f"{m.group(1)}<{dtype}{', ' + m.group(3) if m.group(3) else ''}>"


def _check_ragged_case(label, q, k, v, lengths, plan=None):
    """K3 (under ``plan``, default its own) against its plain version on
    one input; fails past ``RAGGED_TOL``. Returns K3's output."""
    import torch

    from bigdl_tpu_torch.kernels.ragged_decode import (
        ragged_decode_attention, ragged_decode_attention_reference)

    out = ragged_decode_attention(q, k, v, lengths, plan=plan)
    ref = ragged_decode_attention_reference(q, k, v, lengths)
    torch.cuda.synchronize()
    name = str(q.dtype).split(".")[-1]
    err = _err(out, ref, q.dtype != torch.float32)
    tol = RAGGED_TOL[name]
    log("ragged_decode", f"{label} {name} {list(k.shape)}: checked error "
                         f"{err:.3e} (tolerance {tol})")
    if not err <= tol:
        raise AssertionError(f"ragged_decode {label} {name}: {err} > {tol}")
    return out


def check_ragged():
    """K3 against its plain version on the card: float32, bfloat16 and
    float16 at T = 128 and 512 (views of a 512-row cache, read in
    place), head_dim 20, 48 and 256 (off the kernel's head-dim tiles and
    its widest), one split (its merge-free path) and T = 8192; two calls
    on the same inputs must be bitwise equal."""
    import torch

    from bigdl_tpu_torch.kernels.ragged_decode import (
        decode_plan, ragged_decode_attention, sm_count)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # lengths mix 1, the plans' chunk edges (64, 96), the ring's stage
    # edges, the plain version's 128-row steps, T itself, values over T
    # and 0 (clamped)
    mixes = {128: [1, 2, 15, 16, 17, 63, 64, 65, 100, 127, 128, 129, 700,
                   0, 33, 96],
             512: [1, 16, 17, 95, 96, 97, 128, 129, 255, 256, 300, 480,
                   511, 512, 1000, 0]}

    def cache(d, t=MAX_LEN, slots=SLOTS):
        return (torch.randn((slots, HEADS, d), device=dev, generator=gen),
                torch.randn((slots, HEADS, t, d), device=dev, generator=gen),
                torch.randn((slots, HEADS, t, d), device=dev, generator=gen))

    q32, k32, v32 = cache(HEAD_DIM)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v = (x.to(dtype) for x in (q32, k32, v32))
        for t, mix in mixes.items():
            lengths = torch.tensor(mix, dtype=torch.int32, device=dev)
            ks, vs = k[:, :, :t], v[:, :, :t]     # views of the cache
            if t < MAX_LEN and ks.is_contiguous():
                raise AssertionError("the T < max_len view is contiguous")
            _check_ragged_case(f"T={t}", q, ks, vs, lengths)
    lengths = torch.tensor(mixes[128], dtype=torch.int32, device=dev)
    one = decode_plan(SLOTS, HEADS, 128, HEAD_DIM, 4, sms=1, blocks_per_sm=1)
    if one.splits != 1:
        raise AssertionError(f"{one} is not one split")
    _check_ragged_case(f"T=128 one split {tuple(one[:3])}", q32,
                       k32[:, :, :128], v32[:, :, :128], lengths, plan=one)

    lengths = torch.tensor(mixes[MAX_LEN], dtype=torch.int32, device=dev)
    for d, dtype in ((20, torch.float32), (48, torch.float32),
                     (256, torch.float32), (48, torch.bfloat16),
                     (20, torch.float16)):
        q, k, v = (x.to(dtype) for x in cache(d))
        _check_ragged_case(f"head_dim {d}", q, k, v, lengths)

    long_lengths = [1, 63, 64, 65, 127, 128, 129, 2047, 4097, 8184, 8192,
                    9000, 0, 5000, 7777, 300]
    q, k, v = cache(HEAD_DIM, LC_SEQ)
    lengths = torch.tensor(long_lengths, dtype=torch.int32, device=dev)
    first = _check_ragged_case(f"T={LC_SEQ}", q, k, v, lengths)
    again = ragged_decode_attention(q, k, v, lengths)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("two K3 calls on the same inputs differ")
    plan = decode_plan(SLOTS, HEADS, LC_SEQ, HEAD_DIM, 4, sm_count(dev))
    log("ragged_decode", f"two calls at T={LC_SEQ} (plan stage_keys, "
                         f"chunk, splits {tuple(plan[:3])}): bitwise equal")
    del q, k, v, first, again
    torch.cuda.empty_cache()


def phase_ragged_decode(main_lengths):
    """K3 against its plain version (:func:`check_ragged`), the decode
    dispatch's refusals on the card, then timed at the serving and the
    long-context shapes, and the split plan's variants timed in turns.
    Returns the kernels-line entry (launches filled in later)."""
    import torch

    from bigdl_tpu_torch.kernels.ragged_decode import ragged_decode_attention

    check_ragged()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    # CUDA operands K3 does not take (float64, head_dim 264, int64
    # lengths): the dispatch counts each reason=shape and raises, and
    # never counts a kernel call
    from bigdl_tpu_torch import kernels, telemetry

    refused = telemetry.counter("kernels/dispatch/reference")
    taken = telemetry.counter("kernels/dispatch/kernel")
    for dtype, d, len_dtype in ((torch.float64, HEAD_DIM, torch.int32),
                                (torch.float32, 264, torch.int32),
                                (torch.float32, HEAD_DIM, torch.int64)):
        q = torch.randn((SLOTS, HEADS, d), device=dev).to(dtype)
        k = torch.randn((SLOTS, HEADS, 64, d), device=dev).to(dtype)
        lengths = torch.full((SLOTS,), 64, dtype=len_dtype, device=dev)
        r0, t0 = (refused.value(op="decode", reason="shape"),
                  taken.value(op="decode"))
        launches0 = ragged_decode_attention.launches
        with kernels.use(kernels.KernelConfig.ported()):
            try:
                kernels.decode_attention(q, k, k, lengths)
                raised = False
            except ValueError:
                raised = True
        counted = (refused.value(op="decode", reason="shape") - r0,
                   taken.value(op="decode") - t0,
                   ragged_decode_attention.launches - launches0)
        log("ragged_decode", f"{dtype} head_dim {d} {len_dtype} lengths: "
                             f"raised {raised}; reason=shape, kernel, "
                             f"launches counted {counted}")
        if not raised or counted != (1, 0, 0):
            raise AssertionError(f"decode dispatch of operands K3 does not "
                                 f"take: raised {raised}, counted {counted}")

    # timing, L2-cold: distinct caches past the 50 MB L2 together, as
    # a decode step walks through its layers' caches. The serving rows
    # (8 caches, 268 MB), then the long-context rows: one slot at
    # T = 8192 (4 caches, 134 MB) and four slots of ragged lengths up to
    # T (2 caches, 268 MB). Then the split rule's variants, in turns on
    # the same caches.
    entry = None
    for label, slots, t, mix, n_sets in (
            ("main-path lengths", SLOTS, MAX_LEN, main_lengths, 8),
            ("every slot full", SLOTS, MAX_LEN, [MAX_LEN] * SLOTS, 8),
            ("long context", 1, LC_SEQ, [LC_SEQ - 8], 4),
            ("long context, 4 slots", 4, LC_SEQ, [2047, 4096, 6000, LC_SEQ],
             2)):
        sets = [tuple(torch.randn(shape, device=dev, generator=gen)
                      for shape in ((slots, HEADS, HEAD_DIM),
                                    (slots, HEADS, t, HEAD_DIM),
                                    (slots, HEADS, t, HEAD_DIM)))
                for _ in range(n_sets)]
        row = time_ragged(label, sets, mix, t)
        time_plans(label, sets, mix, t)
        del sets
        if entry is None:
            entry = {"name": "ragged_decode", "route": "cuda",
                     "source": "bigdl_tpu_torch/kernels/csrc/"
                               "ragged_decode.cu",
                     "replaces": "bigdl_tpu/kernels/ragged_decode.py:37",
                     "launches": None, "max_abs_err": row["max_abs_err"],
                     "ms": row["kernel_ms"],
                     "device_ms": row["kernel_device_ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"],
                     "library_device_ms": row["library_device_ms"],
                     "plan": row["plan"],
                     "device_ms_windows": row["device_ms_windows"],
                     "library_device_ms_windows":
                         row["library_device_ms_windows"]}
    torch.cuda.empty_cache()
    return entry


#: the split rule's variants timed beside it: the blocks a plan aims at
#: per SM (decode_plan's blocks_per_sm)
PLAN_BLOCKS_PER_SM = (2, 4, 8)


def time_plans(label, sets, mix, t):
    """K3's device time under each of :data:`PLAN_BLOCKS_PER_SM` on the
    same cycled ``sets``, in turns (a, b, c, c, b, a); logged, the rule's
    own plan marked."""
    import torch

    from bigdl_tpu_torch.kernels.ragged_decode import (
        decode_plan, ragged_decode_attention, sm_count)

    slots, heads, d = sets[0][0].shape
    lengths = torch.tensor(mix, dtype=torch.int32, device="cuda")
    rounds = max(2, 400 // len(sets))
    sms = sm_count(lengths.device)
    rule = decode_plan(slots, heads, t, d, 4, sms)
    plans = {}
    for per_sm in PLAN_BLOCKS_PER_SM:
        plan = decode_plan(slots, heads, t, d, 4, sms, blocks_per_sm=per_sm)
        plans[f"{per_sm} blocks/SM{' (the rule)' if plan == rule else ''}"
              ] = plan
    times = {name: [] for name in plans}
    for name in list(plans) + list(reversed(plans)):
        plan = plans[name]
        times[name].append(device_ms(lambda i: ragged_decode_attention(
            *sets[i], lengths, plan=plan), len(sets), rounds)[0])
    log("ragged_decode", json.dumps({
        "case": f"{label}: split plans, in turns", "T": t,
        "device_ms": {name: {"plan": list(plans[name][:3]),
                             "turns": times[name]} for name in plans}}))


def time_ragged(label, sets, mix, t):
    """One K3 timing row: the kernel (``ms`` and ``device_ms``), its
    plain version and the SDPA yardstick cycled over ``sets`` of
    ``(q, k, v)`` at ``lengths = mix``, beside the bound; logged and
    returned. Fails if the kernel leaves ``RAGGED_TOL`` of the plain
    version."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.kernels.ragged_decode import (
        decode_plan, ragged_decode_attention,
        ragged_decode_attention_reference, sm_count)

    n_sets = len(sets)
    dev = sets[0][0].device
    lengths = torch.tensor(mix, dtype=torch.int32, device=dev)
    mask = (torch.arange(t, device=dev)[None, :]
            < lengths.clamp(1, t)[:, None])[:, None, None, :]

    def kern(i):
        q, k, v = sets[i]
        return ragged_decode_attention(q, k[:, :, :t], v[:, :, :t], lengths)

    def plain(i):
        q, k, v = sets[i]
        return ragged_decode_attention_reference(q, k[:, :, :t],
                                                 v[:, :, :t], lengths)

    def library(i):
        q, k, v = sets[i]
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k[:, :, :t], v[:, :, :t],
            attn_mask=mask)[:, :, 0, :]

    err = (kern(0) - plain(0)).abs().max().item()
    lib_err = (library(0) - plain(0)).abs().max().item()
    rounds = max(2, 400 // n_sets)
    ms = time_ms(kern, n_sets, rounds=rounds)
    dev_ms, method = device_ms(kern, n_sets, rounds=rounds)
    # the split kernel and the merge, each summed over one cycle
    log_kernels("ragged_decode", f"{label}: K3 over {n_sets} calls",
                lambda: [kern(i) for i in range(n_sets)])
    plain_ms = time_ms(plain, n_sets, rounds=max(1, rounds // 5))
    library_ms = time_ms(library, n_sets, rounds=max(1, rounds // 2))
    library_dev_ms, library_windows = device_ms(
        library, n_sets, rounds=max(1, rounds // 2))
    slots, heads, d = sets[0][0].shape
    bound_ms, bound_by = ragged_bound(mix, t, 4, heads, d)
    plan = decode_plan(slots, heads, t, d, 4, sm_count(dev))
    row = {"case": label, "shape": list(sets[0][1].shape), "T": t,
           "lengths": list(map(int, mix)),
           "plan": dict(zip(("stage_keys", "chunk", "splits"), plan[:3])),
           "max_abs_err": err, "library_max_abs_err": lib_err,
           "kernel_ms": ms, "kernel_device_ms": dev_ms,
           "device_ms_windows": method, "plain_ms": plain_ms,
           "library_ms": library_ms, "library_device_ms": library_dev_ms,
           "library_device_ms_windows": library_windows,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "kernel_over_bound": ms / bound_ms,
           "kernel_device_over_bound": dev_ms / bound_ms}
    log("ragged_decode", json.dumps(row))
    if not err <= RAGGED_TOL["float32"]:
        raise AssertionError(f"ragged_decode timing inputs ({label}): {err}")
    return row


def greedy_reforward(model, prompt, n):
    """Greedy tokens from full forwards without a cache."""
    import torch

    toks = torch.tensor(prompt, dtype=torch.long, device=model.device)
    out = []
    with torch.no_grad():
        for _ in range(n):
            logits = model(toks[None])[0, -1]
            nxt = int(logits.argmax())
            out.append(nxt)
            toks = torch.cat([toks, toks.new_tensor([nxt])])
    return out


def topk_ok(model, prompt, sampled) -> bool:
    """Every sampled token lies in the top-k of the full forward's
    logits for its prefix (ties at the k-th value admitted)."""
    import torch

    seq = torch.tensor(list(prompt) + list(sampled), dtype=torch.long,
                       device=model.device)
    with torch.no_grad():
        logits = model(seq[None])[0]
    for i, tok in enumerate(sampled):
        row = logits[len(prompt) - 1 + i]
        kth = row.topk(TOP_K).values[-1]
        if not row[tok] >= kth - 1e-4:
            return False
    return True


def make_prompts():
    """The main path's requests: ``bench.py``'s seeded ragged greedy
    prompts (4..480 tokens) and short top-k prompts."""
    r = np.random.RandomState(12)
    greedy = [r.randint(1, VOCAB, r.randint(4, MAX_LEN - MAX_NEW))
              .astype(np.int32) for _ in range(N_GREEDY)]
    topk = [r.randint(1, VOCAB, r.randint(4, 64)).astype(np.int32)
            for _ in range(N_TOPK)]
    return greedy, topk


def device_kernels(prof):
    """``[(ms, launches, name)]`` of the device kernels and copies in a
    ``torch.profiler`` window, largest first."""
    from torch.autograd import DeviceType

    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
    return kernels


def profile_burst(svc, prompts) -> None:
    """Where a decode burst's time goes: the given prompts once more
    under ``torch.profiler``, reporting wall-clock, device time by
    kernel (summed over the window) and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = svc.device.type == "cuda"
    steps0 = svc.metrics("lm")["decode_steps"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        time.sleep(WINDOW_MARGIN_S)
        t0 = time.perf_counter()
        streams = [svc.generate("lm", p, max_new_tokens=MAX_NEW)
                   for p in prompts]
        for s in streams:
            s.result(timeout=600)
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(WINDOW_MARGIN_S)
    steps = svc.metrics("lm")["decode_steps"] - steps0
    kernels = device_kernels(prof)
    busy_ms = sum(k[0] for k in kernels)
    log("profile", json.dumps({
        "requests": len(prompts), "decode_steps": steps,
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels
        else "not measured",
        "wall_ms_per_decode_step": wall_ms / max(steps, 1)}))
    for ms, count, key in kernels[:10]:
        log("profile", f"{ms:9.3f} ms {count:6d}x  {key[:90]}")


def phase_main_path(counters, greedy, topk, device="cuda"):
    """GenerationService at the slice's width (on the card; ``device``
    lets a rehearsal run the same phase on the CPU). ``counters`` maps
    each kernel of the path to its wrapper (launch count attribute
    ``launches``). Returns the launches per kernel and the metrics."""
    import torch

    from bigdl_tpu_torch.generation import GenerationConfig, GenerationService
    from bigdl_tpu_torch.models import TransformerLM

    t0 = time.perf_counter()
    model = TransformerLM(vocab_size=VOCAB, hidden_size=HIDDEN,
                          num_layers=LAYERS, num_heads=HEADS, ffn_size=FFN,
                          max_len=MAX_LEN, device=device,
                          generator=torch.Generator().manual_seed(11))
    svc = GenerationService(config=GenerationConfig(
        slots=SLOTS, max_len=MAX_LEN, prefill_rows=PREFILL_ROWS,
        max_queue=256), device=device)
    try:
        svc.load("lm", model)
        log("main", f"model built and {svc.compile_count('lm')} programs "
                    f"warmed over {len(svc.ladder)} rungs in "
                    f"{time.perf_counter() - t0:.2f} s")
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        g_streams = [svc.generate("lm", p, max_new_tokens=MAX_NEW)
                     for p in greedy]
        k_streams = [svc.generate("lm", p, max_new_tokens=MAX_NEW,
                                  temperature=TEMPERATURE, top_k=TOP_K,
                                  seed=100 + i)
                     for i, p in enumerate(topk)]
        g_out = [list(map(int, s.result(timeout=600))) for s in g_streams]
        k_out = [list(map(int, s.result(timeout=600))) for s in k_streams]
        dt = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        m = svc.metrics("lm")
        profile_burst(svc, greedy[:SLOTS])
    finally:
        svc.shutdown()

    total = sum(map(len, g_out)) + sum(map(len, k_out))
    steps = int(m["decode_steps"])
    summary = {
        "requests": N_GREEDY + N_TOPK, "tokens": total,
        "seconds": dt, "tokens_per_sec": total / dt,
        "ttft_ms_p50": m.get("ttft_ms_p50"),
        "ttft_ms_p99": m.get("ttft_ms_p99"),
        "token_ms_p50": m.get("token_ms_p50"),
        "token_ms_p99": m.get("token_ms_p99"),
        "decode_steps": steps, "programs": int(m["compile_count"]),
        "ladder_rungs": len(svc.ladder), "launches": launches}
    log("main", json.dumps(summary))
    if total != (N_GREEDY + N_TOPK) * MAX_NEW:
        raise AssertionError(f"{total} tokens generated")
    if summary["programs"] > 2 * len(svc.ladder):
        raise AssertionError(f"{summary['programs']} programs > 2 x "
                             f"{len(svc.ladder)} rungs")
    if launches["ragged_decode"] != LAYERS * steps or steps == 0:
        raise AssertionError(f"ragged_decode launched "
                             f"{launches['ragged_decode']} times over "
                             f"{steps} decode steps x {LAYERS} layers")

    t0 = time.perf_counter()
    for i in range(4):
        want = greedy_reforward(model, greedy[i], MAX_NEW)
        if g_out[i] != want:
            raise AssertionError(f"prompt {i}: streamed {g_out[i]} != "
                                 f"full re-forward {want}")
    for i, p in enumerate(topk):
        if not topk_ok(model, p, k_out[i]):
            raise AssertionError(f"top-k stream {i} left the top "
                                 f"{TOP_K}: {k_out[i]}")
    log("main", f"greedy streams of 4 prompts equal the full re-forward; "
                f"{N_TOPK} top-{TOP_K} streams inside the top {TOP_K} "
                f"({time.perf_counter() - t0:.2f} s)")
    return launches, summary


def kept_pairs(seg, b: int, s: int, device) -> int:
    """(batch, query, key) triples a causal K1 call keeps: the work a
    bound may count (skipped, masked pairs cost the card nothing)."""
    import torch

    if seg is None:
        return b * s * (s + 1) // 2
    causal = torch.ones((s, s), dtype=torch.bool, device=device).tril()
    same = seg[:, :, None] == seg[:, None, :]
    return int((same & causal).sum())


def kept_tile_pairs(seg, s: int):
    """``(kept, all)`` causal (query tile, key tile) pairs of 64 x 64, one
    head: a pair is kept when some query and some key of it share a
    segment id (the diagonal always) — the tiles K1's forward computes."""
    import torch
    import torch.nn.functional as F

    b, n = seg.shape[0], -(-s // 64)
    pad = n * 64 - s
    q_ids = F.pad(seg, (0, pad), value=-1).view(b, n, 1, 64, 1)
    k_ids = F.pad(seg, (0, pad), value=-2).view(b, 1, n, 1, 64)
    share = (q_ids == k_ids).any(-1).any(-1)
    causal = torch.ones((n, n), dtype=torch.bool, device=seg.device).tril()
    diagonal = torch.eye(n, dtype=torch.bool, device=seg.device)
    kept = int(((share | diagonal) & causal).sum())
    return kept, b * n * (n + 1) // 2


def flash_bound(kept: int, shape, itemsize: int, segmented: bool,
                backward: bool, flops_per_s: float, parts: bool = False):
    """Least time (ms) the card needs for one K1 or K2 call: 4 * D flops
    per kept pair per head forward and 2.5x that backward, against q, k,
    v read and O, lse written (forward), or q, k, v, O, dO, lse read and
    dq, dk, dv written (backward), plus the segment ids. With ``parts``,
    the two times ``(bytes, operations)`` instead."""
    b, h, s, d = shape
    n = b * h * s * d
    flops = 4 * d * h * kept * (2.5 if backward else 1.0)
    nbytes = ((8 if backward else 4) * n * itemsize + b * h * s * 4
              + (b * s * 4 if segmented else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    if parts:
        return t_bytes, t_ops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _kernel_pair(kernel: str):
    """``(forward, forward_reference, backward, backward_reference)`` of
    K1 (``"flash_attention"``) or K2 (``"blockwise_flash_attention"``)."""
    import importlib

    fa = importlib.import_module("bigdl_tpu_torch.kernels.flash_attention")
    return tuple(getattr(fa, f"{kernel}_{part}") for part in (
        "forward", "forward_reference", "backward", "backward_reference"))


def _err(got, want, relative):
    diff = (got.float() - want.float()).abs()
    if relative:
        diff = diff / want.float().abs().clamp(min=1.0)
    return diff.max().item()


def _flash_errors(q, k, v, do, seg, causal, kernel="flash_attention"):
    """A flash kernel's forward and backward against their plain versions
    on the same inputs (the backward's from the kernel's own O and lse):
    max abs errors of O, lse, dq, dk, dv, each relative to max(1,
    |plain|) when the inputs are bfloat16 or float16."""
    import torch

    fwd, fwd_ref, bwd, bwd_ref = _kernel_pair(kernel)
    rel = q.dtype != torch.float32
    o, lse = fwd(q, k, v, seg, causal=causal)
    o_r, lse_r = fwd_ref(q, k, v, seg, causal=causal)
    grads = bwd(q, k, v, o, do, lse, seg, causal=causal)
    grads_r = bwd_ref(q, k, v, o, do, lse, seg, causal=causal)
    torch.cuda.synchronize()
    out = {"o": _err(o, o_r, rel), "lse": _err(lse, lse_r, False)}
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_r):
        out[name] = _err(g, w, rel)
    return out


def _check_flash(errs, dtype_name, label, phase="flash_attention"):
    fwd_tol, bwd_tol = FLASH_FWD_TOL[dtype_name], FLASH_BWD_TOL[dtype_name]
    log(phase, f"{label}: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tolerance o {fwd_tol}, lse {FLASH_FWD_TOL['float32']}, "
          f"grads {bwd_tol})")
    bad = [k for k, v in errs.items()
           if not v <= {"o": fwd_tol, "lse": FLASH_FWD_TOL["float32"]}
           .get(k, bwd_tol)]
    if bad:
        raise AssertionError(f"{phase} {label}: {bad} out of "
                             f"tolerance: {errs}")


def _views(gen, shape, dtype, n=3):
    """``n`` seeded [B, H, S, D] tensors on the card, as the attention
    layer hands them over: [B, S, H, D] -> [B, H, S, D] strided views."""
    import torch

    b, h, s, d = shape
    return [torch.randn((b, s, h, d), device="cuda", generator=gen)
            .to(dtype).transpose(1, 2) for _ in range(n)]


def _segments(gen, b, s):
    """Seeded sorted [B, S] int32 segment ids (1..3)."""
    import torch

    cuts = torch.randint(1, 4, (b, s), device="cuda", generator=gen)
    return cuts.sort(dim=1).values.to(torch.int32)


def phase_flash(train_seg):
    """K1 forward and backward against their plain versions at the
    training shapes (strided [B, S, H, D] -> [B, H, S, D] views, as the
    attention layer hands them over) and at ragged edge shapes, then
    timed. Returns the two kernels-line entries (launches filled in
    later)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.kernels.flash_attention import (
        flash_attention_backward, flash_attention_backward_reference,
        flash_attention_backward_tile_pairs, flash_attention_forward,
        flash_attention_forward_reference, flash_attention_forward_tile_pairs)
    from bigdl_tpu_torch.nn import dot_product_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    # ragged edges: S not a multiple of the 64-row tile, one-row tiles,
    # every tile width (16, 32, 64, 128) and head dims between them that
    # run zero-padded in the next (hidden 768 / 640 at 8 heads: 96, 80)
    for (b, h, s, d, causal, segd) in ((2, 3, 19, 64, True, True),
                                       (2, 2, 48, 32, False, True),
                                       (1, 2, 130, 64, True, False),
                                       (2, 1, 1, 16, True, False),
                                       (1, 2, 200, 128, False, True),
                                       (3, 2, 77, 16, True, True),
                                       (2, 8, 512, 96, True, True),
                                       (1, 3, 70, 80, False, True),
                                       (2, 2, 33, 8, True, False),
                                       (1, 2, 65, 100, True, True)):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v = _views(gen, (b, h, s, d), dtype)
            do = torch.randn((b, h, s, d), device=dev,
                             generator=gen).to(dtype)
            seg = _segments(gen, b, s) if segd else None
            name = str(dtype).split(".")[-1]
            _check_flash(_flash_errors(q, k, v, do, seg, causal), name,
                         f"{name} [{b},{h},{s},{d}] causal={causal} "
                         f"segments={segd}")

    shape = (TRAIN_BATCH, HEADS, TRAIN_SEQ, HEAD_DIM)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for seg in (None, train_seg):
            q, k, v = _views(gen, shape, dtype)
            do = torch.randn(shape, device=dev, generator=gen).to(dtype)
            name = str(dtype).split(".")[-1]
            _check_flash(_flash_errors(q, k, v, do, seg, True), name,
                         f"{name} {list(shape)} causal "
                         f"segments={seg is not None}")

    # K1's forward (every dtype) and its 16-bit backward's dK/dV and dQ
    # kernels compute only the tiles whose queries and keys share a
    # segment id: the pairs each counted against the ids' count; and the
    # 16-bit backward, run twice, gives bitwise equal gradients
    kept, causal_pairs = kept_tile_pairs(train_seg, TRAIN_SEQ)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[-1]
        q, k, v = _views(gen, shape, dtype)
        do = torch.randn(shape, device=dev, generator=gen).to(dtype)
        flash_attention_forward_tile_pairs()
        o, lse = flash_attention_forward(q, k, v, train_seg, causal=True)
        computed = {"forward": flash_attention_forward_tile_pairs()}
        if dtype != torch.float32:
            flash_attention_backward_tile_pairs()
            flash_attention_backward(q, k, v, o, do, lse, train_seg,
                                     causal=True)
            computed["dK/dV"], computed["dQ"] = \
                flash_attention_backward_tile_pairs()
        share = computed["forward"] / (HEADS * causal_pairs)
        log("flash_attention", f"{name} training rows {list(shape)}: "
                               f"tile pairs computed {computed} = {HEADS} "
                               f"heads x {computed['forward'] / HEADS:g} of "
                               f"{causal_pairs} causal pairs ({share:.4f}); "
                               f"the segment ids keep {kept}")
        if any(n != kept * HEADS for n in computed.values()):
            raise AssertionError(f"K1 {name} computed {computed} tile "
                                 f"pairs, the segment ids keep {kept} x "
                                 f"{HEADS}")
        if dtype != torch.float32:
            check_deterministic(flash_attention_backward, q, k, v, o, do,
                                lse, train_seg, f"K1 {name} backward",
                                phase="flash_attention")

    # timing: 3 input sets (q, k, v, O, dO: 252 MB in float32, past the
    # 50 MB L2), causal as in training
    entries = None
    for dtype, seg in ((torch.float32, train_seg), (torch.float32, None),
                       (torch.bfloat16, train_seg),
                       (torch.float16, train_seg)):
        n_sets = 3
        sets = [(_views(gen, shape, dtype),
                 torch.randn(shape, device=dev, generator=gen).to(dtype))
                for _ in range(n_sets)]
        outs = [flash_attention_forward(*qkv, seg, causal=True)
                for qkv, _ in sets]
        if seg is None:
            sdpa_kw = {"is_causal": True}
        else:
            causal_m = torch.ones((TRAIN_SEQ, TRAIN_SEQ), dtype=torch.bool,
                                  device=dev).tril()
            sdpa_kw = {"attn_mask": (causal_m & (
                seg[:, :, None] == seg[:, None, :]))[:, None]}
        graphs, einsum_graphs = [], []
        for (q, k, v), _ in sets:
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            graphs.append((leaves, F.scaled_dot_product_attention(
                *leaves, **sdpa_kw)))
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            einsum_graphs.append((leaves, dot_product_attention(
                *leaves, causal=True, segments=seg, use_flash=False)))

        def kern_f(i):
            return flash_attention_forward(*sets[i][0], seg, causal=True)

        def plain_f(i):
            return flash_attention_forward_reference(*sets[i][0], seg,
                                                     causal=True)

        def lib_f(i):
            return F.scaled_dot_product_attention(*sets[i][0], **sdpa_kw)

        def kern_b(i):
            (q, k, v), do = sets[i]
            o, lse = outs[i]
            return flash_attention_backward(q, k, v, o, do, lse, seg,
                                            causal=True)

        def plain_b(i):
            (q, k, v), do = sets[i]
            o, lse = outs[i]
            return flash_attention_backward_reference(q, k, v, o, do, lse,
                                                      seg, causal=True)

        def lib_b(i):
            leaves, out = graphs[i]
            return torch.autograd.grad(out, leaves, sets[i][1],
                                       retain_graph=True)

        def einsum_f(i):
            return dot_product_attention(*sets[i][0], causal=True,
                                         segments=seg, use_flash=False)

        def einsum_b(i):
            leaves, out = einsum_graphs[i]
            return torch.autograd.grad(out, leaves, sets[i][1],
                                       retain_graph=True)

        name = str(dtype).split(".")[-1]
        kept = kept_pairs(seg, TRAIN_BATCH, TRAIN_SEQ, dev)
        # float32: K1's forward and backward run 3xTF32; bfloat16 and
        # float16 run 16-bit MMAs
        peaks = ({"fwd": TF32X3_FLOPS_PER_S, "bwd": TF32X3_FLOPS_PER_S}
                 if dtype == torch.float32 else
                 {"fwd": BF16_FLOPS_PER_S, "bwd": BF16_FLOPS_PER_S})
        itemsize = torch.empty((), dtype=dtype).element_size()
        rel = dtype != torch.float32
        o_err = (kern_f(0)[0].float() - plain_f(0)[0].float()).abs()
        fwd_err = (o_err / plain_f(0)[0].float().abs().clamp(min=1.0)
                   if rel else o_err).max().item()
        lib_err = (lib_f(0).float() - plain_f(0)[0].float()).abs() \
            .max().item()
        bwd_err = max((g.float() - w.float()).abs().max().item()
                      for g, w in zip(kern_b(0), plain_b(0)))
        row = {}
        for kind, kern, plain, lib, einsum, backward, err in (
                ("fwd", kern_f, plain_f, lib_f, einsum_f, False, fwd_err),
                ("bwd", kern_b, plain_b, lib_b, einsum_b, True, bwd_err)):
            ms = time_ms(kern, n_sets, rounds=10)
            dev_ms, method = device_ms(kern, n_sets, rounds=10)
            plain_ms = time_ms(plain, n_sets, rounds=2)
            library_ms = time_ms(lib, n_sets, rounds=10)
            library_dev_ms, library_windows = device_ms(lib, n_sets,
                                                        rounds=10)
            einsum_ms = time_ms(einsum, n_sets, rounds=5)
            bound_ms, bound_by = flash_bound(kept, shape, itemsize,
                                             seg is not None, backward,
                                             peaks[kind])
            bytes_ms, ops_ms = flash_bound(kept, shape, itemsize,
                                           seg is not None, backward,
                                           peaks[kind], parts=True)
            row[kind] = {"name": f"flash_attention_{kind}", "route": "cuda",
                         "source": "bigdl_tpu_torch/kernels/csrc/"
                                   "flash_attention.cu",
                         "replaces": "bigdl_tpu/kernels/flash_attention.py:"
                                     + ("97" if backward else "65"),
                         "launches": None, "max_abs_err": err, "ms": ms,
                         "device_ms": dev_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": library_ms,
                         "library_device_ms": library_dev_ms,
                         "device_ms_windows": method,
                         "library_device_ms_windows": library_windows}
            log("flash_attention", json.dumps({
                "case": f"{kind} {name} {list(shape)} causal segments="
                        f"{seg is not None}", "kept_pairs": kept,
                "max_abs_err": err, "kernel_ms": ms,
                "kernel_device_ms": dev_ms, "device_ms_windows": method,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "library_device_ms": library_dev_ms,
                "library_device_ms_windows": library_windows,
                "einsum_path_ms": einsum_ms,
                "library": "F.scaled_dot_product_attention " + (
                    "backward (autograd.grad)" if backward else "forward"),
                "library_fwd_max_abs_err": lib_err, "bound_ms": bound_ms,
                "bound_by": bound_by, "bytes_bound_ms": bytes_ms,
                "ops_bound_ms": ops_ms, "kernel_over_bound": ms / bound_ms,
                "kernel_device_over_bound": dev_ms / bound_ms}))
        if entries is None:
            entries = row
    return entries["fwd"], entries["bwd"]


def train_corpus():
    """The training phase's packed synthetic documents, made as the
    train CLI's ``--synthetic N --inputMode packed`` makes them."""
    from bigdl_tpu_torch.models.transformer.train import synthetic_corpus

    return synthetic_corpus(TRAIN_SYNTHETIC, TRAIN_VOCAB, TRAIN_SEQ,
                            "packed", TRAIN_BATCH)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def step_differences(model, crit, batch, fault=None,
                     function="_FlashAttention", precision=None,
                     method=None, lr=TRAIN_LR):
    """One SGD step from the model's weights on ``batch`` with the flash
    kernels and with flash switched off (the einsum path on the card):
    the loss difference, the largest parameter difference after the
    update (also over the einsum step's largest update), and per
    parameter the largest gradient difference over the
    largest element of the einsum path's gradient (floored at
    ``TRAIN_GRAD_FLOOR`` of the model's largest). ``fault`` ("dK zeroed"
    or "dQ 1% off") is put into the gradients of the kernel's autograd
    ``function`` (K1's ``_FlashAttention`` or K2's
    ``_BlockwiseFlashAttention``) during the kernel step (the fault
    check). ``precision`` (a policy) runs both steps under it.
    ``method(path)`` ("kernel" or "einsum"), if given, makes each path's
    OptimMethod in place of SGD at ``TRAIN_LR``, ``lr`` the rate; the
    result then also holds each path's parameters and optimizer state
    after the step and the parameters before it (``after``,
    ``states``, ``start``). The model's weights are restored."""
    from bigdl_tpu_torch import kernels
    from bigdl_tpu_torch.optim import SGD, build_train_step

    start = _state(model)
    params = dict(model.named_parameters())
    results = []
    for path, cfg, step_fault in (
            ("kernel", kernels.KernelConfig.ported(), fault),
            ("einsum", kernels.KernelConfig(flash_attention=False,
                                            decode_attention=True), None)):
        model.load_state_dict(start)
        with kernels.use(cfg), _gradient_fault(step_fault, function):
            step = build_train_step(
                model, crit, method(path) if method
                else SGD(learning_rate=TRAIN_LR), precision=precision)
            loss = float(step(*batch, lr))
        results.append((loss, _state(model),
                        {k: p.grad.detach().clone()
                         for k, p in params.items()}, step.opt_state))
    model.load_state_dict(start)
    (loss_k, new_k, grad_k, state_k), (loss_e, new_e, grad_e, state_e) = \
        results
    floor = TRAIN_GRAD_FLOOR * max(g.abs().max().item()
                                   for g in grad_e.values())
    grad_rel = {k: ((grad_k[k] - grad_e[k]).abs().max()
                    / grad_e[k].abs().max().clamp(min=floor)).item()
                for k in grad_e}
    param_diff = max((new_k[k] - new_e[k]).abs().max().item()
                     for k in start)
    update_max = max((new_e[k] - start[k]).abs().max().item()
                      for k in params)
    out = {"loss_kernel": loss_k, "loss_einsum": loss_e,
           "loss_diff": abs(loss_k - loss_e),
           "loss_rel_diff": abs(loss_k - loss_e) / abs(loss_e),
           "param_diff": param_diff, "update_max": update_max,
           "param_rel_diff": param_diff / max(update_max, 1e-30),
           "grad_rel_diff": grad_rel}
    if method:
        out.update(start=start, after=(new_k, new_e),
                   states=(state_k, state_e))
    return out


def step_parity_holds(diffs) -> bool:
    return (diffs["loss_diff"] <= TRAIN_PARITY_TOL
            and diffs["param_diff"] <= TRAIN_PARITY_TOL
            and max(diffs["grad_rel_diff"].values()) <= TRAIN_GRAD_RTOL)


def bf16_step_holds(d) -> bool:
    """One bf16_mixed step against the einsum path within phase 11's
    limits (``PREC_*``)."""
    return (d["loss_rel_diff"] <= PREC_LOSS_RTOL
            and d["param_rel_diff"] <= PREC_PARAM_RTOL
            and max(d["grad_rel_diff"].values()) <= PREC_GRAD_RTOL)


def _log_bf16_step(phase, label, d) -> None:
    worst = max(d["grad_rel_diff"], key=d["grad_rel_diff"].get)
    log(phase, f"one bf16_mixed step, {label}: loss "
               f"{d['loss_kernel']:.6f} vs einsum path "
               f"{d['loss_einsum']:.6f} (relative "
               f"{d['loss_rel_diff']:.3e}, limit {PREC_LOSS_RTOL}), max "
               f"|param diff| {d['param_diff']:.3e} over the largest "
               f"update {d['update_max']:.3e}: {d['param_rel_diff']:.3e} "
               f"(limit {PREC_PARAM_RTOL}), worst gradient {worst} at "
               f"{d['grad_rel_diff'][worst]:.3e} of its largest element "
               f"(limit {PREC_GRAD_RTOL})")


def _log_step_diffs(label, diffs, phase="train") -> None:
    worst = max(diffs["grad_rel_diff"], key=diffs["grad_rel_diff"].get)
    log(phase, f"one step, {label}: loss {diffs['loss_kernel']:.6f} vs "
                 f"einsum path {diffs['loss_einsum']:.6f} (|diff| "
                 f"{diffs['loss_diff']:.3e}), max |param diff| "
                 f"{diffs['param_diff']:.3e} (tolerance "
                 f"{TRAIN_PARITY_TOL}), worst gradient {worst} at "
                 f"{diffs['grad_rel_diff'][worst]:.3e} of its largest "
                 f"element (tolerance {TRAIN_GRAD_RTOL})")


@contextlib.contextmanager
def _gradient_fault(fault, function):
    """Within the block, the flash kernel's autograd backward (the
    ``function`` class of ``kernels/flash_attention.py``) puts ``fault``
    into the gradients the kernel returns (None: no fault): ``"dK
    zeroed"``, or ``"dQ <p>% off"`` (dQ times 1 + p/100). The kernel
    still launches, and counts, as it does on the main path."""
    import importlib

    import torch

    if fault is None:
        yield
        return
    fn = getattr(importlib.import_module(
        "bigdl_tpu_torch.kernels.flash_attention"), function)
    real = fn.backward

    def backward(ctx, do):
        dq, dk, dv, *rest = real(ctx, do)
        if fault == "dK zeroed":
            dk = torch.zeros_like(dk)
        else:                                   # "dQ <p>% off"
            dq = dq * (1 + float(fault.split()[1].rstrip("%")) / 100)
        return (dq, dk, dv, *rest)

    fn.backward = staticmethod(backward)
    try:
        yield
    finally:
        fn.backward = staticmethod(real)


def profile_train(model, crit, batches, device, phase="train-profile",
                  lr=TRAIN_LR, method=None, precision=None,
                  detail=False) -> dict:
    """Where a training step's time goes: the steps of ``batches[1:]``
    (after one warm step) under ``torch.profiler``, reporting
    wall-clock, device time by kernel and the device's idle share.
    ``method`` is the OptimMethod (default plain SGD at ``lr``),
    ``precision`` a policy for the step. Returns the numbers, the
    busiest kernels under ``top``; with ``detail`` also every kernel
    under ``kernels``, the losses (the warm step's first) under
    ``losses`` and, the same steps run again with no profiler,
    ``unprofiled_ms_per_step`` (the profiler's own host cost stretches a
    host-bound window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.optim import SGD, build_train_step

    step = build_train_step(model, crit, method or SGD(learning_rate=lr),
                            precision=precision)
    losses = [float(step(*batches[0], lr))]       # warm
    on_card = device == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        time.sleep(WINDOW_MARGIN_S)
        t0 = time.perf_counter()
        for inp, tgt in batches[1:]:
            losses.append(float(step(inp, tgt, lr)))
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(WINDOW_MARGIN_S)
    kernels = device_kernels(prof)
    busy_ms = sum(k[0] for k in kernels)
    # more device time than wall time: the window lost or mis-timed
    # kernels (seen once in a ResNet-50 window of 10 steps, which held 7
    # steps' convolutions); its busy time measures nothing
    read = bool(kernels) and busy_ms <= wall_ms
    if kernels and not read:
        log(phase, f"the profiler window read {busy_ms:.1f} ms of device "
                   f"time in {wall_ms:.1f} ms of wall: not measured")
    numbers = {
        "steps": len(batches) - 1, "wall_ms": wall_ms,
        "wall_ms_per_step": wall_ms / (len(batches) - 1),
        "device_busy_ms": busy_ms if read else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if read
        else "not measured",
        "top": [[ms, count, key[:90]] for ms, count, key in kernels[:5]]}
    log(phase, json.dumps(numbers))
    for ms, count, key in kernels[:10]:
        log(phase, f"{ms:9.3f} ms {count:6d}x  {key[:90]}")
    if not detail:
        return numbers
    t0 = time.perf_counter()
    for inp, tgt in batches[1:]:
        float(step(inp, tgt, lr))
    if on_card:
        torch.cuda.synchronize()
    unprofiled = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    log(phase, f"the same steps with no profiler: {unprofiled:.3f} ms a step")
    return dict(numbers, kernels=kernels, losses=losses,
                unprofiled_ms_per_step=unprofiled)


def compare_attention_paths(model, crit, batch, device, phase="train"
                            ) -> None:
    """Wall time of a training step with the flash kernels and with flash
    switched off
    (the einsum path), in turns (kernel, einsum, einsum, kernel, ...), one
    batch throughout: the evidence a later change of the default reads."""
    import torch

    from bigdl_tpu_torch import kernels
    from bigdl_tpu_torch.optim import SGD, build_train_step

    step = build_train_step(model, crit, SGD(learning_rate=TRAIN_LR))
    configs = {"kernel": kernels.KernelConfig.ported(),
               "einsum": kernels.KernelConfig(flash_attention=False,
                                              decode_attention=True)}
    times = {name: [] for name in configs}
    for name in ("kernel", "einsum"):            # warm both paths
        with kernels.use(configs[name]):
            float(step(*batch, TRAIN_LR))
    for name in ("kernel", "einsum", "einsum", "kernel") * 2:
        with kernels.use(configs[name]):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(*batch, TRAIN_LR))
            times[name].append((time.perf_counter() - t0) * 1e3)
    log(phase, json.dumps({"step_ms_by_attention_path": times,
                             "median_ms": {k: float(np.median(v))
                                           for k, v in times.items()}}))


def phase_train(counters, corpus, device="cuda"):
    """LocalOptimizer at the training slice's width (on the card;
    ``device`` lets a rehearsal run the same phase on the CPU). Returns
    the launches per kernel and the metrics."""
    import torch

    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration

    x, y = corpus
    t0 = time.perf_counter()
    model = TransformerLM(vocab_size=TRAIN_VOCAB, hidden_size=HIDDEN,
                          num_layers=LAYERS, num_heads=HEADS, ffn_size=FFN,
                          max_len=TRAIN_SEQ, device=device,
                          generator=torch.Generator().manual_seed(21))
    crit = SequenceCrossEntropyCriterion(ignore_index=-1)

    def batch(i):
        rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        return ([torch.from_numpy(p[rows]).to(device) for p in x],
                torch.from_numpy(y[rows]).to(device))

    log("train", f"model built, {len(y)} packed rows of {TRAIN_SEQ} "
                 f"({float((x[1] > 0).mean()):.3f} real tokens) in "
                 f"{time.perf_counter() - t0:.2f} s")

    # one step from the same weights and batch: flash kernel vs einsum,
    # then the same with a fault in K1's backward, which must show
    diffs = step_differences(model, crit, batch(0))
    _log_step_diffs("kernel", diffs)
    if not step_parity_holds(diffs):
        raise AssertionError(f"kernel step differs from the einsum step: "
                             f"{diffs}")
    for fault in ("dK zeroed", "dQ 1% off"):
        diffs = step_differences(model, crit, batch(0), fault)
        _log_step_diffs(f"kernel with {fault}", diffs)
        if step_parity_holds(diffs):
            raise AssertionError(f"the one-step check misses a kernel "
                                 f"with {fault}: {diffs}")

    samples = [Sample([p[i] for p in x], y[i]) for i in range(len(y))]
    ds = DataSet.array(samples).transform(SampleToMiniBatch(TRAIN_BATCH))
    opt = LocalOptimizer(model, ds, crit, batch_size=TRAIN_BATCH)
    opt.set_optim_method(SGD(learning_rate=TRAIN_LR))
    opt.set_end_when(max_iteration(TRAIN_ITERS))
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    losses = [h["loss"] for h in opt.history]
    step_ms = sorted(h["seconds"] * 1e3 for h in opt.history[2:])
    median_ms = step_ms[len(step_ms) // 2]
    slab = TRAIN_BATCH * TRAIN_SEQ
    real = float((y[:TRAIN_ITERS * TRAIN_BATCH] != -1).sum()) / TRAIN_ITERS
    summary = {
        "iterations": len(losses), "seconds": wall,
        "ms_per_step_median": median_ms,
        "ms_per_step_first": opt.history[0]["seconds"] * 1e3,
        "tokens_per_sec": slab / (median_ms / 1e3),
        "real_tokens_per_sec": real / (median_ms / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_mean_first5": float(np.mean(losses[:5])),
        "loss_mean_last5": float(np.mean(losses[-5:])),
        "epoch": opt.driver_state["epoch"], "launches": launches}
    log("train", json.dumps(summary))
    summary["losses"] = losses
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_ITERS:
        raise AssertionError(f"losses: {losses}")
    if not summary["loss_mean_last5"] < summary["loss_mean_first5"]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        if launches[name] != LAYERS * TRAIN_ITERS:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"over {TRAIN_ITERS} iterations x "
                                 f"{LAYERS} layers")
    compare_attention_paths(model, crit, batch(TRAIN_ITERS), device)
    profile_train(model, crit, [batch(TRAIN_ITERS + i)
                                for i in range(PROFILE_STEPS + 1)], device)
    return launches, summary


def phase_blockwise():
    """K2 forward and backward against their plain versions at ragged
    edge shapes and at [1, 8, 2048, 64], against K1's kernel at the
    long-context shape [1, 8, 8192, 64] (the plain version is too slow
    there; K1 and K2 compute one function, so the K1/K2 routing switch is
    invisible to callers), then timed at [1, 8, 8192, 64] and
    [1, 8, 32768, 64] float32 causal beside K1's kernel, the SDPA
    yardstick, the einsum path (8192 only) and the bound; then its 16-bit
    instances (``time_blockwise16``). Returns the kernels-line entries:
    float32 forward and backward at 8192, then bfloat16's (launches
    filled in later)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.nn import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(3)
    # S = 1, 19, 77, 130, 200, 1000 (ragged tiles), D = 16, 64, 100, 128
    # (100 runs zero-padded in the 128 tile), causal and segments on and
    # off; segmented causal rows of a later segment see key tiles masked
    # whole before their own, so the carry starts at (-inf, 0, 0)
    for (b, h, s, d, causal, segd) in ((2, 1, 1, 16, True, False),
                                       (2, 3, 19, 64, True, True),
                                       (3, 2, 77, 100, True, True),
                                       (1, 2, 130, 64, False, False),
                                       (1, 2, 200, 128, False, True),
                                       (1, 2, 1000, 64, True, True),
                                       (2, 2, 200, 16, False, False),
                                       (1, 3, 130, 128, True, False)):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            q, k, v = _views(gen, (b, h, s, d), dtype)
            do = torch.randn((b, h, s, d), device="cuda",
                             generator=gen).to(dtype)
            seg = _segments(gen, b, s) if segd else None
            name = str(dtype).split(".")[-1]
            _check_flash(_flash_errors(q, k, v, do, seg, causal,
                                       "blockwise_flash_attention"), name,
                         f"{name} [{b},{h},{s},{d}] causal={causal} "
                         f"segments={segd}", phase="blockwise")
    shape = (1, HEADS, 2048, HEAD_DIM)
    q, k, v = _views(gen, shape, torch.float32)
    do = torch.randn(shape, device="cuda", generator=gen)
    _check_flash(_flash_errors(q, k, v, do, None, True,
                               "blockwise_flash_attention"), "float32",
                 f"float32 {list(shape)} causal", phase="blockwise")

    k2_fwd, k2_ref_f, k2_bwd, k2_ref_b = _kernel_pair(
        "blockwise_flash_attention")
    k1_fwd, _, k1_bwd, _ = _kernel_pair("flash_attention")
    shape = (1, HEADS, LC_SEQ, HEAD_DIM)
    q, k, v = _views(gen, shape, torch.float32)
    do = torch.randn(shape, device="cuda", generator=gen)
    o2, lse2 = k2_fwd(q, k, v, causal=True)
    o1, lse1 = k1_fwd(q, k, v, causal=True)
    g2 = k2_bwd(q, k, v, o2, do, lse2, causal=True)
    g1 = k1_bwd(q, k, v, o1, do, lse1, causal=True)
    torch.cuda.synchronize()
    errs = {"o": _err(o2, o1, False), "lse": _err(lse2, lse1, False)}
    errs.update({n: _err(a, b_, False)
                 for n, a, b_ in zip(("dq", "dk", "dv"), g2, g1)})
    _check_flash(errs, "float32", f"float32 {list(shape)} causal, against "
                                  f"K1's kernel", phase="blockwise")
    check_deterministic(k2_bwd, q, k, v, o2, do, lse2, None,
                        "K2 backward")
    del o1, lse1, g1, g2
    shape = (TRAIN_BATCH, HEADS, TRAIN_SEQ, HEAD_DIM)
    q, k, v = _views(gen, shape, torch.float32)
    do = torch.randn(shape, device="cuda", generator=gen)
    seg = _segments(gen, TRAIN_BATCH, TRAIN_SEQ)
    o1, lse1 = k1_fwd(q, k, v, seg, causal=True)
    check_deterministic(k1_bwd, q, k, v, o1, do, lse1, seg, "K1 backward")

    entries = {}
    for s in (LC_SEQ, LC_SEQ_MAX):
        shape = (1, HEADS, s, HEAD_DIM)
        # L2-cold: q, k, v, O, dO of one set are 84 MB at 8192, 336 MB at
        # 32768, past the 50 MB L2
        n_sets = 2 if s == LC_SEQ else 1
        sets = [(_views(gen, shape, torch.float32),
                 torch.randn(shape, device="cuda", generator=gen))
                for _ in range(n_sets)]
        outs = [k2_fwd(*qkv, causal=True) for qkv, _ in sets]
        outs1 = [k1_fwd(*qkv, causal=True) for qkv, _ in sets]
        graphs = []
        for (q, k, v), _ in sets:
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            graphs.append((leaves, F.scaled_dot_product_attention(
                *leaves, is_causal=True)))

        def fns(i, which):
            (q, k, v), do = sets[i]
            return {
                "k2_f": lambda: k2_fwd(q, k, v, causal=True),
                "k2_b": lambda: k2_bwd(q, k, v, outs[i][0], do, outs[i][1],
                                       causal=True),
                "k1_f": lambda: k1_fwd(q, k, v, causal=True),
                "k1_b": lambda: k1_bwd(q, k, v, outs1[i][0], do,
                                       outs1[i][1], causal=True),
                "plain_f": lambda: k2_ref_f(q, k, v, causal=True),
                "plain_b": lambda: k2_ref_b(q, k, v, outs[i][0], do,
                                            outs[i][1], causal=True),
                "lib_f": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True),
                "lib_b": lambda: torch.autograd.grad(
                    graphs[i][1], graphs[i][0], do, retain_graph=True),
            }[which]()

        def timed(which, rounds):
            return time_ms(lambda i: fns(i, which), n_sets, rounds)

        def device_timed(which, rounds):
            ms, row[f"{which}_device_ms_windows"] = device_ms(
                lambda i: fns(i, which), n_sets, rounds)
            return ms

        kept = kept_pairs(None, 1, s, "cuda")
        row = {"S": s, "kept_pairs": kept}
        for kind, backward in (("f", False), ("b", True)):
            rounds = 3 if s == LC_SEQ else 1
            row[f"k2_{kind}_ms"] = timed(f"k2_{kind}", rounds)
            row[f"k2_{kind}_device_ms"] = device_timed(f"k2_{kind}", rounds)
            row[f"k1_{kind}_ms"] = timed(f"k1_{kind}", rounds)
            row[f"sdpa_{kind}_ms"] = timed(f"lib_{kind}", rounds)
            row[f"sdpa_{kind}_device_ms"] = device_timed(f"lib_{kind}",
                                                         rounds)
            row[f"bound_{kind}_ms"], row[f"bound_{kind}_by"] = flash_bound(
                kept, shape, 4, False, backward, TF32X3_FLOPS_PER_S)
        if s == LC_SEQ:
            # the plain version (a Python loop over 128 x 128 tiles) and
            # the einsum path (2.1 GB of f32 scores per call) at 8192
            # only; the kernel against the plain version on these inputs
            # is the kernels line's error
            main_errs = _flash_errors(*sets[0][0], sets[0][1], None, True,
                                      "blockwise_flash_attention")
            _check_flash(main_errs, "float32", f"float32 {list(shape)} "
                         f"causal (the main path's shape)", "blockwise")
            log_kernels("blockwise", "SDPA yardstick's kernels",
                        lambda: (fns(0, "lib_f"), fns(0, "lib_b")))
            # one timed call each: every call of the plain version
            # launches tens of thousands of small kernels, and after a
            # few such storms an H100's profiler windows recorded none
            # of K2's (PERF.md)
            _, row["plain_f_ms"] = _timed_once(lambda: fns(0, "plain_f"))
            _, row["plain_b_ms"] = _timed_once(lambda: fns(0, "plain_b"))
            q, k, v = sets[0][0]
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            ein = dot_product_attention(*leaves, causal=True,
                                        use_flash=False)
            row["einsum_f_ms"] = time_ms(
                lambda i: dot_product_attention(q, k, v, causal=True,
                                                use_flash=False), 1, 2)
            row["einsum_b_ms"] = time_ms(
                lambda i: torch.autograd.grad(ein, leaves, sets[0][1],
                                              retain_graph=True), 1, 2)
            del ein, leaves
            for kind, backward in (("f", False), ("b", True)):
                entries[kind] = {
                    "name": "blockwise_flash_attention_"
                            + ("bwd" if backward else "fwd"),
                    "route": "cuda",
                    "source": "bigdl_tpu_torch/kernels/csrc/"
                              "blockwise_flash_attention.cu",
                    "replaces": "bigdl_tpu/kernels/flash_attention.py:"
                                + ("419" if backward else "305"),
                    "launches": None,
                    "max_abs_err": max(main_errs[n] for n in (
                        ("dq", "dk", "dv") if backward else ("o", "lse"))),
                    "ms": row[f"k2_{kind}_ms"],
                    "device_ms": row[f"k2_{kind}_device_ms"],
                    "plain_ms": row[f"plain_{kind}_ms"],
                    "bound_ms": row[f"bound_{kind}_ms"],
                    "bound_by": row[f"bound_{kind}_by"],
                    "library_ms": row[f"sdpa_{kind}_ms"],
                    "library_device_ms": row[f"sdpa_{kind}_device_ms"],
                    "device_ms_windows": row[f"k2_{kind}_device_ms_windows"],
                    "library_device_ms_windows":
                        row[f"lib_{kind}_device_ms_windows"]}
        log("blockwise", json.dumps(row))
        del sets, outs, outs1, graphs
        torch.cuda.empty_cache()
    return (entries["f"], entries["b"]) + time_blockwise16(gen)


def _timed_once(fn):
    """``(fn(), ms)``: one call timed with CUDA events (the host's launch
    path included), for a plain version that launches thousands of
    kernels a call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def time_blockwise16(gen):
    """K2's forward and backward in bfloat16 and float16 at the
    long-context shape [1, 8, 8192, 64], causal: against K2's float32
    kernel on the same (upcast) inputs at the 16-bit contract, the
    backward run twice bitwise equal (bfloat16 with segments too, where
    the forward and the backward must compute exactly the tile pairs the
    ids keep), then timed (``ms``, ``device_ms``) beside SDPA in the same
    dtype (a yardstick: the port never calls it), with the bound at the
    16-bit tensor-core rate and at the bytes. Last, after every profiled window
    (a window read after the plain version's storm of small kernels has
    recorded none of K2's on an H100), bfloat16 against the plain version
    on the same inputs, each way one call, timed. Returns the bfloat16
    forward's and backward's kernels-line entries (launches filled in by
    phase 16)."""
    import importlib

    import torch
    import torch.nn.functional as F

    fa = importlib.import_module("bigdl_tpu_torch.kernels.flash_attention")
    k2_fwd, k2_ref_f, k2_bwd, k2_ref_b = _kernel_pair(
        "blockwise_flash_attention")
    shape = (1, HEADS, LC_SEQ, HEAD_DIM)
    kept = kept_pairs(None, 1, LC_SEQ, "cuda")
    rows = {}
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[-1]
        # two sets of q, k, v, O, dO (42 MB each): L2-cold
        sets = [(_views(gen, shape, dtype),
                 torch.randn(shape, device="cuda", generator=gen).to(dtype))
                for _ in range(2)]
        outs = [k2_fwd(*qkv, causal=True) for qkv, _ in sets]
        (q, k, v), do = sets[0]
        wide = [x.float() for x in (q, k, v)]
        o32, lse32 = k2_fwd(*wide, causal=True)
        g16 = k2_bwd(q, k, v, outs[0][0], do, outs[0][1], causal=True)
        # the backward from the 16-bit forward's own O and lse, upcast:
        # only the arithmetic differs
        g32 = k2_bwd(*wide, outs[0][0].float(), do.float(), outs[0][1],
                     causal=True)
        torch.cuda.synchronize()
        errs = {"o": _err(outs[0][0], o32, True),
                "lse": _err(outs[0][1], lse32, False)}
        errs.update({n: _err(a, b, True)
                     for n, a, b in zip(("dq", "dk", "dv"), g16, g32)})
        _check_flash(errs, name, f"{name} {list(shape)} causal, against "
                                 f"K2's float32 kernel", "blockwise")
        del wide, o32, lse32, g16, g32
        check_deterministic(k2_bwd, q, k, v, outs[0][0], do, outs[0][1],
                            None, f"K2 {name} backward")
        if dtype == torch.bfloat16:
            # with segment ids, the forward and the backward's dK/dV and
            # dQ kernels (run twice) compute only the tile pairs the ids
            # keep
            seg = _segments(gen, 1, LC_SEQ)
            seg_kept, causal_pairs = kept_tile_pairs(seg, LC_SEQ)
            fa.blockwise_flash_attention_forward_tile_pairs()
            fa.blockwise_flash_attention_backward_tile_pairs()
            o_s, lse_s = k2_fwd(q, k, v, seg, causal=True)
            computed = {
                "forward": fa.blockwise_flash_attention_forward_tile_pairs()}
            check_deterministic(k2_bwd, q, k, v, o_s, do, lse_s, seg,
                                f"K2 {name} backward")
            computed["dK/dV x 2"], computed["dQ x 2"] = \
                fa.blockwise_flash_attention_backward_tile_pairs()
            log("blockwise", f"{name} {list(shape)} segments: tile pairs "
                             f"computed {computed}; the ids keep {HEADS} "
                             f"heads x {seg_kept} of {causal_pairs} causal "
                             f"pairs")
            if computed != {"forward": seg_kept * HEADS,
                            "dK/dV x 2": 2 * seg_kept * HEADS,
                            "dQ x 2": 2 * seg_kept * HEADS}:
                raise AssertionError(f"K2 {name} computed {computed} tile "
                                     f"pairs, the segment ids keep "
                                     f"{seg_kept} x {HEADS}")
            del o_s, lse_s
            main = (q, k, v, do) + tuple(outs[0])
        graphs = []
        for (q, k, v), _ in sets:
            leaves = [x.detach().requires_grad_() for x in (q, k, v)]
            graphs.append((leaves, F.scaled_dot_product_attention(
                *leaves, is_causal=True)))

        def fns(i, which):
            (q, k, v), do = sets[i]
            return {
                "k2_f": lambda: k2_fwd(q, k, v, causal=True),
                "k2_b": lambda: k2_bwd(q, k, v, outs[i][0], do, outs[i][1],
                                       causal=True),
                "lib_f": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True),
                "lib_b": lambda: torch.autograd.grad(
                    graphs[i][1], graphs[i][0], do, retain_graph=True),
            }[which]()

        row = rows[name] = {"dtype": name, "S": LC_SEQ, "kept_pairs": kept}
        for kind, backward in (("f", False), ("b", True)):
            for which in (f"k2_{kind}", f"lib_{kind}"):
                row[f"{which}_ms"] = time_ms(lambda i: fns(i, which), 2, 3)
                row[f"{which}_device_ms"], row[f"{which}_windows"] = \
                    device_ms(lambda i: fns(i, which), 2, 3)
            t_bytes, t_ops = flash_bound(kept, shape, 2, False, backward,
                                         BF16_FLOPS_PER_S, parts=True)
            row[f"bound_{kind}_bytes_ms"] = t_bytes
            row[f"bound_{kind}_ops_ms"] = t_ops
            row[f"k2_{kind}_over_sdpa"] = (row[f"k2_{kind}_device_ms"]
                                           / row[f"lib_{kind}_device_ms"])
        if dtype == torch.float16:
            log("blockwise", "16-bit " + json.dumps(row))
        del sets, outs, graphs
        torch.cuda.empty_cache()

    # bfloat16 against the plain version (a Python loop over 128 x 128
    # tiles), the kernel's O and lse from the rows' first set
    q, k, v, do, o, lse = main
    row = rows["bfloat16"]
    (o_r, lse_r), row["plain_f_ms"] = _timed_once(
        lambda: k2_ref_f(q, k, v, causal=True))
    grads_r, row["plain_b_ms"] = _timed_once(
        lambda: k2_ref_b(q, k, v, o, do, lse, causal=True))
    grads = k2_bwd(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    plain_errs = {"o": _err(o, o_r, True), "lse": _err(lse, lse_r, False)}
    plain_errs.update({n: _err(g, w, True) for n, g, w in
                       zip(("dq", "dk", "dv"), grads, grads_r)})
    _check_flash(plain_errs, "bfloat16", f"bfloat16 {list(shape)} causal, "
                                         f"against the plain version",
                 "blockwise")
    log("blockwise", "16-bit " + json.dumps(row))
    entries = {}
    for kind, backward in (("f", False), ("b", True)):
        t_bytes = row[f"bound_{kind}_bytes_ms"]
        t_ops = row[f"bound_{kind}_ops_ms"]
        entries[kind] = {
            "name": "blockwise_flash_attention_"
                    + ("bwd" if backward else "fwd") + "_bf16",
            "route": "cuda",
            "source": "bigdl_tpu_torch/kernels/csrc/"
                      + ("flash_common.cuh" if backward
                         else "blockwise_flash_attention.cu"),
            "replaces": "bigdl_tpu/kernels/flash_attention.py:"
                        + ("419" if backward else "305"),
            "launches": None,
            "max_abs_err": max(plain_errs[n] for n in (
                ("dq", "dk", "dv") if backward else ("o", "lse"))),
            "ms": row[f"k2_{kind}_ms"],
            "device_ms": row[f"k2_{kind}_device_ms"],
            "plain_ms": row[f"plain_{kind}_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": row[f"lib_{kind}_ms"],
            "library_device_ms": row[f"lib_{kind}_device_ms"],
            "device_ms_windows": row[f"k2_{kind}_windows"],
            "library_device_ms_windows": row[f"lib_{kind}_windows"]}
    del main, q, k, v, do, o, lse, o_r, lse_r, grads_r, grads
    torch.cuda.empty_cache()
    return entries["f"], entries["b"]


def log_kernels(phase: str, what: str, run) -> None:
    """Which kernels one profiled ``run()`` launches, with their device
    times (a yardstick's backend decides what arithmetic its times stand
    for; a kernel of two launches shows each)."""
    log(phase, f"{what} (ms, launches, name): "
        + json.dumps([(round(ms, 5), n, key[:120])
                      for ms, n, key in device_kernels(profiled(run))[:6]]))


def check_deterministic(bwd, q, k, v, o, do, lse, seg, label,
                        phase="blockwise") -> None:
    """The backward twice on the same inputs: dq, dk and dv must be
    bitwise equal (the kernels add in a fixed order, with no atomics)."""
    import torch

    first = bwd(q, k, v, o, do, lse, seg, causal=True)
    second = bwd(q, k, v, o, do, lse, seg, causal=True)
    torch.cuda.synchronize()
    same = {n: torch.equal(a, b) for n, a, b in zip(("dq", "dk", "dv"),
                                                   first, second)}
    log(phase, f"{label} run twice at {list(q.shape)} causal "
               f"segments={seg is not None}: bitwise equal {same}")
    if not all(same.values()):
        raise AssertionError(f"{label} is not deterministic: {same}")


def phase_k6_route():
    """The attention layer's route for score matrices over 2 GiB: with
    flash switched off, ``dot_product_attention`` at [1, 8, 16384, 128]
    float32 causal (8.6 GB of scores) must launch K2 once and equal a
    direct ``blockwise_flash_attention`` call bitwise."""
    import torch

    from bigdl_tpu_torch import kernels
    from bigdl_tpu_torch.kernels.flash_attention import (
        blockwise_flash_attention, blockwise_flash_attention_forward)
    from bigdl_tpu_torch.nn import dot_product_attention

    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = _views(gen, LC_K6_SHAPE, torch.float32)
    d = LC_K6_SHAPE[-1]
    before = blockwise_flash_attention_forward.launches
    with kernels.use(kernels.KernelConfig(flash_attention=False,
                                          decode_attention=True)):
        got = dot_product_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launched = blockwise_flash_attention_forward.launches - before
    want = blockwise_flash_attention(q, k, v, causal=True,
                                     sm_scale=1.0 / d ** 0.5)
    torch.cuda.synchronize()
    same = torch.equal(got, want)
    log("k6_route", f"flash off, {list(LC_K6_SHAPE)} float32 causal: K2 "
                    f"launched {launched} time(s) by dot_product_attention; "
                    f"bitwise equal to a direct call: {same}")
    if launched != 1 or not same:
        raise AssertionError(f"K6 route: {launched} K2 launches, bitwise "
                             f"equal {same}")


def longctx_model(max_len, device="cuda"):
    """The long-context configuration (bench.py's LONGCTX row): vocab
    8192, hidden 512, 2 layers, 8 heads, random weights from a seed."""
    import torch

    from bigdl_tpu_torch.models import TransformerLM

    return TransformerLM(vocab_size=LC_VOCAB, hidden_size=HIDDEN,
                         num_layers=LC_LAYERS, num_heads=HEADS,
                         ffn_size=FFN, max_len=max_len, device=device,
                         generator=torch.Generator().manual_seed(31))


def _longctx_optimize(model, crit, x, y, counters, phase,
                      precision=None):
    """``LocalOptimizer`` over the stream's windows (batch 1, SGD at
    ``TRAIN_LR``, ``LC_ITERS`` iterations, under the ``precision``
    preset if given), every kernel's count set to 0 just before: finite
    losses that fall, and K2's forward and backward launched once a layer
    and iteration and K1 never. Returns the launches and the numbers
    (ms a step, tokens/s, losses)."""
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration

    samples = [Sample(x[i], y[i]) for i in range(len(y))]
    ds = DataSet.array(samples).transform(SampleToMiniBatch(1))
    opt = LocalOptimizer(model, ds, crit, batch_size=1)
    opt.set_optim_method(SGD(learning_rate=TRAIN_LR))
    opt.set_end_when(max_iteration(LC_ITERS))
    if precision is not None:
        opt.set_precision(precision)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    losses = [h["loss"] for h in opt.history]
    step_ms = sorted(h["seconds"] * 1e3 for h in opt.history[2:])
    median_ms = step_ms[len(step_ms) // 2]
    summary = {
        "iterations": len(losses), "seconds": wall,
        "ms_per_step_median": median_ms,
        "ms_per_step_first": opt.history[0]["seconds"] * 1e3,
        "tokens_per_sec": LC_SEQ / (median_ms / 1e3),
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_mean_first5": float(np.mean(losses[:5])),
        "loss_mean_last5": float(np.mean(losses[-5:])),
        "launches": launches}
    log(phase, json.dumps(summary))
    if not all(np.isfinite(losses)) or len(losses) != LC_ITERS:
        raise AssertionError(f"{phase} losses: {losses}")
    if not summary["loss_mean_last5"] < summary["loss_mean_first5"]:
        raise AssertionError(f"{phase} loss did not fall: {losses}")
    for name, want in (("blockwise_flash_attention_fwd", LC_LAYERS),
                       ("blockwise_flash_attention_bwd", LC_LAYERS),
                       ("flash_attention_fwd", 0), ("flash_attention_bwd", 0)):
        if launches[name] != want * LC_ITERS:
            raise AssertionError(f"{phase}: {name} launched "
                                 f"{launches[name]} times over {LC_ITERS} "
                                 f"iterations x {LC_LAYERS} layers")
    return launches, summary


def _longctx_long_step(crit, counters, phase, device, precision=None):
    """One SGD step of the long-context configuration at S =
    ``LC_SEQ_MAX`` (under ``precision``, a policy, if given): a finite
    loss, K2 launched once a layer each way, and its peak device memory.
    Returns the numbers."""
    import torch

    from bigdl_tpu_torch.models.transformer.train import synthetic_corpus
    from bigdl_tpu_torch.optim import SGD, build_train_step

    xl, yl = synthetic_corpus(2 * LC_SEQ_MAX + 1, LC_VOCAB, LC_SEQ_MAX,
                              "contiguous", 1)
    model = longctx_model(LC_SEQ_MAX, device)
    step = build_train_step(model, crit, SGD(learning_rate=TRAIN_LR),
                            precision=precision)
    before = {name: fn.launches for name, fn in counters.items()}
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(step(torch.from_numpy(xl[:1]).to(device),
                      torch.from_numpy(yl[:1]).to(device), TRAIN_LR))
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else "not measured"
    k2 = {name: counters[name].launches - before[name]
          for name in ("blockwise_flash_attention_fwd",
                       "blockwise_flash_attention_bwd")}
    out = {"S": LC_SEQ_MAX, "loss": loss, "step_seconds_first": step_s,
           "peak_memory_bytes": peak, "k2_launches": k2}
    log(phase, json.dumps(out))
    if not np.isfinite(loss) or set(k2.values()) != {LC_LAYERS}:
        raise AssertionError(f"{phase}: S={LC_SEQ_MAX} step: loss {loss}, "
                             f"K2 launches {k2}")
    del model, step
    if on_card:
        torch.cuda.empty_cache()
    return out


def phase_longctx_train(counters, device="cuda"):
    """LocalOptimizer at the long-context configuration, S = 8192, batch
    1, on the train CLI's contiguous synthetic stream, SGD lr 0.1, for
    ``LC_ITERS`` iterations — every attention call through K2, checked
    against the einsum path in one step (with two faults put into K2's
    backward, which must show) — then one step at S = 32768. Returns the
    launches per kernel and the metrics."""
    import torch

    from bigdl_tpu_torch.kernels import flash_route
    from bigdl_tpu_torch.models.transformer.train import synthetic_corpus
    from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion

    t0 = time.perf_counter()
    x, y = synthetic_corpus(LC_SYNTHETIC, LC_VOCAB, LC_SEQ, "contiguous", 1)
    model = longctx_model(LC_SEQ, device)
    crit = SequenceCrossEntropyCriterion()

    def batch(i):
        return (torch.from_numpy(x[i:i + 1]).to(device),
                torch.from_numpy(y[i:i + 1]).to(device))

    qkv = torch.empty((1, HEADS, LC_SEQ, HEAD_DIM), device=device)
    route = flash_route(qkv, qkv, qkv)
    log("longctx-train", f"model built, {len(y)} windows of {LC_SEQ} in "
                         f"{time.perf_counter() - t0:.2f} s; attention "
                         f"operands route to {route}")
    if route != "K2":
        raise AssertionError(f"[1, {HEADS}, {LC_SEQ}, {HEAD_DIM}] routes "
                             f"to {route}")

    diffs = step_differences(model, crit, batch(0),
                             function="_BlockwiseFlashAttention")
    _log_step_diffs("K2", diffs, "longctx-train")
    if not step_parity_holds(diffs):
        raise AssertionError(f"K2 step differs from the einsum step: "
                             f"{diffs}")
    for fault in ("dK zeroed", "dQ 1% off"):
        diffs = step_differences(model, crit, batch(0), fault,
                                 "_BlockwiseFlashAttention")
        _log_step_diffs(f"K2 with {fault}", diffs, "longctx-train")
        if step_parity_holds(diffs):
            raise AssertionError(f"the one-step check misses K2 with "
                                 f"{fault}: {diffs}")

    launches, summary = _longctx_optimize(model, crit, x, y, counters,
                                          "longctx-train")
    compare_attention_paths(model, crit, batch(LC_ITERS), device,
                            "longctx-train")
    profile_train(model, crit, [batch(LC_ITERS + 1 + i)
                                for i in range(PROFILE_STEPS + 1)], device,
                  "longctx-profile")
    del model
    if device == "cuda":
        torch.cuda.empty_cache()
    # one step at S = 32768 (the einsum path's scores alone would take
    # 34 GB a layer there; it is not run)
    _longctx_long_step(crit, counters, "longctx-train", device)
    return launches, summary


#: K2's kernels as the profiler names them: the forward, and the
#: backward's delta, dK/dV and dQ kernels (K1 runs the same backward
#: kernel names: a window that reads these launches no K1)
K2_KERNELS = ("blockwise_fwd_kernel", "flash_delta_kernel",
              "flash_dkv_kernel", "flash_dq_kernel")


def phase_longctx_bf16(counters, device="cuda"):
    """Phase 16: bf16_mixed long-context training through K2 in
    bfloat16 — the LONGCTX row (``longctx_model(LC_SEQ)``) through
    ``LocalOptimizer(...).set_precision("bf16_mixed")``, SGD lr 0.1, on
    phase 6's contiguous synthetic stream for ``LC_ITERS`` iterations at
    K = 1. One step against the einsum path (bf16 too) at phase 11's
    limits, which ``PREC_FAULTS`` put into K2's backward must fail; K2's
    forward and backward launched once a layer and iteration and K1
    never; falling losses; a profiled window (idle share, K2's bfloat16
    kernels and their device ms a step); then one bf16_mixed step at S =
    32768 with its peak memory. Returns the launches and the numbers."""
    import torch

    from bigdl_tpu_torch.kernels import flash_route
    from bigdl_tpu_torch.models.transformer.train import synthetic_corpus
    from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion
    from bigdl_tpu_torch.precision import PrecisionPolicy

    phase = "longctx-bf16"
    t0 = time.perf_counter()
    on_card = device == "cuda"
    x, y = synthetic_corpus(LC_SYNTHETIC, LC_VOCAB, LC_SEQ, "contiguous", 1)
    model = longctx_model(LC_SEQ, device)
    crit = SequenceCrossEntropyCriterion()
    bf16 = PrecisionPolicy.bf16_mixed()

    def batch(i):
        return (torch.from_numpy(x[i:i + 1]).to(device),
                torch.from_numpy(y[i:i + 1]).to(device))

    qkv = torch.empty((1, HEADS, LC_SEQ, HEAD_DIM), device=device,
                      dtype=torch.bfloat16)
    route = flash_route(qkv, qkv, qkv)
    log(phase, f"model built in {time.perf_counter() - t0:.2f} s; bfloat16 "
               f"attention operands route to {route}")
    if route != "K2":
        raise AssertionError(f"bfloat16 [1, {HEADS}, {LC_SEQ}, {HEAD_DIM}] "
                             f"routes to {route}")

    summary = {}
    d = step_differences(model, crit, batch(0), precision=bf16,
                         function="_BlockwiseFlashAttention")
    _log_bf16_step(phase, "K2", d)
    summary["one_step"] = {k: d[k] for k in (
        "loss_kernel", "loss_einsum", "loss_rel_diff", "param_rel_diff")}
    summary["one_step"]["worst_grad_rel_diff"] = max(
        d["grad_rel_diff"].values())
    if not bf16_step_holds(d):
        raise AssertionError(f"bf16 K2 step differs from the einsum step: "
                             f"{d}")
    for fault in PREC_FAULTS:
        d = step_differences(model, crit, batch(0), fault, precision=bf16,
                             function="_BlockwiseFlashAttention")
        _log_bf16_step(phase, f"K2 with {fault}", d)
        summary["one_step"][f"worst_grad_rel_diff with {fault}"] = max(
            d["grad_rel_diff"].values())
        if bf16_step_holds(d):
            raise AssertionError(f"the bf16 one-step check misses K2 with "
                                 f"{fault}: {d}")

    launches, summary["run"] = _longctx_optimize(
        model, crit, x, y, counters, phase, precision="bf16_mixed")

    # where a step's time goes: K2's kernels must all be bfloat16
    # instances, once a layer and step
    prof = profile_train(model, crit, [batch(LC_ITERS + 1 + i)
                                       for i in range(PROFILE_STEPS + 1)],
                         device, f"{phase}-profile", precision=bf16,
                         detail=True)
    if on_card:
        steps = prof["steps"]
        k2 = [(ms, n, key) for ms, n, key in prof["kernels"]
              if any(name in key for name in K2_KERNELS)]
        wrong = [key for _, _, key in k2 if "__nv_bfloat16" not in key]
        counts = {name: _instances(k2, name) for name in K2_KERNELS}
        prof_k2 = {"k2_device_ms_per_step": sum(ms for ms, _, _ in k2)
                   / steps,
                   "k2_fwd_device_ms_per_step": sum(
                       ms for ms, _, key in k2 if K2_KERNELS[0] in key)
                   / steps,
                   "k2_bwd_device_ms_per_step": sum(
                       ms for ms, _, key in k2 if K2_KERNELS[0] not in key)
                   / steps,
                   "k2_kernel_counts": counts}
        log(phase, json.dumps(prof_k2))
        summary["profile"] = dict(
            prof_k2, idle_share=prof["device_idle_share"],
            wall_ms_per_step=prof["wall_ms_per_step"],
            unprofiled_ms_per_step=prof["unprofiled_ms_per_step"])
        if wrong or set(counts.values()) != {LC_LAYERS * steps}:
            raise AssertionError(f"K2 in the bf16_mixed window: kernels "
                                 f"{counts} over {steps} steps x "
                                 f"{LC_LAYERS} layers; not bfloat16: "
                                 f"{wrong}")
    del model
    if on_card:
        torch.cuda.empty_cache()
    summary["long"] = _longctx_long_step(crit, counters, phase, device,
                                         precision=bf16)
    return launches, summary


def _serve_long(model, prompt, chunk, device, counters):
    """The long prompt through a fresh ``GenerationService`` with
    ``prefill_chunk=chunk``: greedy tokens, metrics (with each kernel's
    launches, counted from 0 after the warm-up), the first token's
    logits from the service's engine on a fresh cache, and the ladder."""
    from bigdl_tpu_torch.generation import (GenerationConfig,
                                            GenerationService, KVCache)

    svc = GenerationService(config=GenerationConfig(
        slots=2, max_len=LC_SEQ, prefill_rows=2, prefill_chunk=chunk),
        device=device)
    try:
        svc.load("lm", model)
        for fn in counters.values():
            fn.launches = 0
        stream = svc.generate("lm", prompt, max_new_tokens=LC_NEW)
        tokens = list(map(int, stream.result(timeout=600)))
        m = svc.metrics("lm")
        m["launches"] = {name: fn.launches for name, fn in counters.items()}
        m["ttft_ms"] = stream.ttft_ms
        kv = KVCache.for_model(model, 2, LC_SEQ)
        first, _ = svc.engine.prefill(svc.registry.current("lm"), kv,
                                      [prompt], [0])
        return tokens, m, first[0], len(svc.ladder)
    finally:
        svc.shutdown()


def phase_longctx_serve(counters, device="cuda"):
    """Chunked-prefill serving at the long-context configuration: one
    seeded prompt of ``LC_SEQ - LC_NEW`` tokens through
    ``GenerationService(prefill_chunk=2048)`` (4 chunks into the 8192
    rung), 8 greedy new tokens, against the same service unchunked and a
    greedy full re-forward (through K2); then K3 against its plain
    version at T = 8192. Returns the launches and the metrics."""
    import torch

    from bigdl_tpu_torch.kernels.ragged_decode import (
        ragged_decode_attention, ragged_decode_attention_reference)

    model = longctx_model(LC_SEQ, device)
    prompt = np.random.RandomState(44).randint(
        1, LC_VOCAB, LC_SEQ - LC_NEW).astype(np.int32)
    tokens, m, first, rungs = _serve_long(model, prompt, LC_CHUNK, device,
                                          counters)
    launches = m["launches"]
    tokens_1, m_1, first_1, _ = _serve_long(model, prompt, None, device,
                                            counters)
    want = greedy_reforward(model, prompt, LC_NEW)
    logits_diff = float(np.abs(first - first_1).max())
    steps = int(m["decode_steps"])
    summary = {"prompt_tokens": len(prompt), "new_tokens": LC_NEW,
               "prefill_chunks": m["prefill_chunks"],
               "prefill_chunks_unchunked": m_1["prefill_chunks"],
               "ttft_ms_chunked": m["ttft_ms"],
               "ttft_ms_unchunked": m_1["ttft_ms"],
               "programs": int(m["compile_count"]), "ladder_rungs": rungs,
               "decode_steps": steps,
               "first_token_logits_max_abs_diff": logits_diff,
               "tokens": tokens, "launches": launches}
    log("longctx-serve", json.dumps(summary))
    if m["prefill_chunks"] != LC_SEQ // LC_CHUNK:
        raise AssertionError(f"{m['prefill_chunks']} prefill chunks")
    if summary["programs"] > 2 * rungs:
        raise AssertionError(f"{summary['programs']} programs > 2 x "
                             f"{rungs} rungs")
    if not tokens == tokens_1 == want:
        raise AssertionError(f"chunked {tokens}, unchunked {tokens_1}, "
                             f"re-forward {want}")
    if not logits_diff <= PREFILL_LOGITS_TOL:
        raise AssertionError(f"first-token logits differ by {logits_diff}")
    if launches["ragged_decode"] != LC_LAYERS * steps or steps == 0:
        raise AssertionError(f"ragged_decode launched "
                             f"{launches['ragged_decode']} times over "
                             f"{steps} decode steps x {LC_LAYERS} layers")
    log("longctx-serve", "greedy tokens equal the unchunked service's and "
                         "the full re-forward's")

    if device == "cuda":
        gen = torch.Generator(device="cuda").manual_seed(5)
        lengths = [1, LC_CHUNK - 1, LC_CHUNK, LC_SEQ - 1, LC_SEQ]
        n = len(lengths)
        q = torch.randn((n, HEADS, HEAD_DIM), device="cuda", generator=gen)
        k, v = (torch.randn((n, HEADS, LC_SEQ, HEAD_DIM), device="cuda",
                            generator=gen) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        err = _err(ragged_decode_attention(q, k, v, lens),
                   ragged_decode_attention_reference(q, k, v, lens), False)
        log("longctx-serve", f"ragged_decode T={LC_SEQ} lengths {lengths}: "
                             f"max|kernel-plain| = {err:.3e} (tolerance "
                             f"{RAGGED_TOL['float32']})")
        if not err <= RAGGED_TOL["float32"]:
            raise AssertionError(f"ragged_decode at T={LC_SEQ}: {err}")
    return launches, summary


# ---- K5: the fused dequant int8 GEMM ----

def int8_bound(m: int, n: int, k: int):
    """Least time (ms) the card needs for one fused int8 GEMM: x_q and
    w_q read once, the two scale vectors read and the float32 output
    written once, against 2 * M * N * K int8 operations at the dense
    int8 tensor-core peak."""
    nbytes = m * k + n * k + 4 * (m + n) + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _int8_operands(gen, m, n, k):
    import torch

    x = torch.randint(-127, 128, (m, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device="cuda",
                      generator=gen)
    xs = torch.rand(m, device="cuda", generator=gen) * 0.1 + 1e-3
    ws = torch.rand(n, device="cuda", generator=gen) * 0.1 + 1e-3
    return x, w, xs, ws


def phase_int8_gemm():
    """K5 against its plain version, bitwise (``torch.equal``), at edge
    shapes (M 1-300, N 1-1024, K 1-4100: ragged tiles, K not a multiple
    of 4 or 16) and at the main path's ``[64, 2048] x [1000, 2048]^T``
    and 4096^3; then timed L2-cold at those two and at VGG-16's three
    classifier shapes (``ZOO_FC_SHAPES``, phase 15 (e)) beside the plain
    version, ``torch._int_mm`` plus the same epilogue (the library
    yardstick) and the bound. Returns the kernels-line entry at the main
    path's shape and the ``int8_gemm_vgg16_*`` rows, by fc (launches
    filled in later)."""
    import torch

    from bigdl_tpu_torch.kernels.int8_gemm import (gemm_plan, int8_gemm,
                                                   int8_gemm_reference)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = 0
    plans = {}
    for m in INT8_EDGE_M:
        for n in INT8_EDGE_N:
            for k in INT8_EDGE_K:
                ops = _int8_operands(gen, m, n, k)
                got, want = int8_gemm(*ops), int8_gemm_reference(*ops)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    err = (got - want).abs().max().item()
                    raise AssertionError(f"int8_gemm [{m},{k}]x[{n},{k}]: "
                                         f"not bitwise the plain version "
                                         f"(max diff {err})")
                cases += 1
                plan = gemm_plan(m, n, k, sms)
                plans.setdefault(f"tile {plan.tile} splits {plan.splits}",
                                 []).append(f"{m}x{n}x{k}")
    log("int8_gemm", f"{cases} edge shapes (M {INT8_EDGE_M}, N "
                     f"{INT8_EDGE_N}, K {INT8_EDGE_K}): kernel bitwise "
                     f"equal to the plain version")
    # the shapes that cross the split-K choice (M x N x K by plan)
    log("int8_gemm", f"plans on {sms} SMs: " + json.dumps(
        {key: [x for x in shapes if x.split("x")[1] == "1000"
               and x.split("x")[2] in ("2048", "4100")]
         for key, shapes in sorted(plans.items())}))

    def library(x, w, xs, ws):
        return torch._int_mm(x, w.t()).float() * xs[:, None] * ws[None, :]

    # L2-cold: together the sets exceed the 50 MB L2 (32 x 2.2 MB of
    # operands at the main shape; 3 x 100 MB at 4096^3 and at fc6)
    timed = {}
    for (m, n, k), n_sets in ((INT8_MAIN_SHAPE, 32), (INT8_BIG_SHAPE, 3)) \
            + tuple((shape, ZOO_INT8_SETS if fc == "fc6" else 12)
                    for fc, shape in ZOO_FC_SHAPES.items()):
        sets = [_int8_operands(gen, m, n, k) for _ in range(n_sets)]
        got = int8_gemm(*sets[0])
        want = int8_gemm_reference(*sets[0])
        lib = library(*sets[0])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8_gemm [{m},{k}]x[{n},{k}]: not "
                                 f"bitwise the plain version")
        err = (got - want).abs().max().item()
        plan = gemm_plan(m, n, k, sms)
        row = {"M": m, "N": n, "K": k, "tile": plan.tile,
               "splits": plan.splits, "k_steps_per_split": plan.steps,
               "grid": list(plan.grid), "bitwise_equal": True,
               "max_abs_err": err,
               "library_bitwise_equal": bool(torch.equal(lib, want)),
               "kernel_ms": time_ms(lambda i: int8_gemm(*sets[i]),
                                    n_sets, 20),
               "plain_ms": time_ms(lambda i: int8_gemm_reference(*sets[i]),
                                   n_sets, 5),
               "library_ms": time_ms(lambda i: library(*sets[i]), n_sets,
                                     20)}
        row["kernel_device_ms"], row["device_ms_windows"] = device_ms(
            lambda i: int8_gemm(*sets[i]), n_sets, 20)
        row["library_device_ms"], row["library_device_ms_windows"] = \
            device_ms(lambda i: library(*sets[i]), n_sets, 20)
        log_kernels("int8_gemm", f"[{m},{k}]x[{n},{k}] kernel",
                    lambda: int8_gemm(*sets[1]))
        log_kernels("int8_gemm", f"[{m},{k}]x[{n},{k}] library",
                    lambda: library(*sets[1]))
        row["bound_ms"], row["bound_by"] = int8_bound(m, n, k)
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
        row["kernel_device_over_bound"] = (row["kernel_device_ms"]
                                           / row["bound_ms"])
        row["kernel_device_over_library_device"] = (
            row["kernel_device_ms"] / row["library_device_ms"])
        row["kernel_device_tops"] = (2 * m * n * k / row["kernel_device_ms"]
                                     / 1e9)
        log("int8_gemm", json.dumps(row))
        timed[(m, n, k)] = row
        del sets
        torch.cuda.empty_cache()

    def line_row(name, row):
        return {"name": name, "route": "cuda",
                "source": "bigdl_tpu_torch/kernels/csrc/int8_gemm.cu",
                "replaces": "bigdl_tpu/kernels/int8_gemm.py:39",
                "launches": None, "max_abs_err": row["max_abs_err"],
                "shape": [row["M"], row["N"], row["K"]],
                "tile": row["tile"], "splits": row["splits"],
                "k_steps_per_split": row["k_steps_per_split"],
                "ms": row["kernel_ms"], "device_ms": row["kernel_device_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                "library_device_ms": row["library_device_ms"],
                "device_over_bound": row["kernel_device_over_bound"],
                "device_over_library":
                    row["kernel_device_over_library_device"],
                "device_ms_windows": row["device_ms_windows"],
                "library_device_ms_windows":
                    row["library_device_ms_windows"]}

    return (line_row("int8_gemm", timed[INT8_MAIN_SHAPE]),
            {fc: line_row(f"int8_gemm_vgg16_{fc}", timed[shape])
             for fc, shape in ZOO_FC_SHAPES.items()})


# ---- K4: paged decode ----

def _shuffled_pages(gen, k_pages, v_pages, table):
    """The same paged view with the pool's pages permuted and the table
    renumbered to follow them."""
    import torch

    perm = torch.randperm(k_pages.shape[0], device="cuda", generator=gen)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device="cuda")
    return (k_pages[inv], v_pages[inv],
            perm[table.long()].to(torch.int32).contiguous())


def check_paged(main_lengths):
    """K4, through the dispatch function, against K3's kernel bitwise
    (``torch.equal``) on identity and shuffled paged views of the same
    cache: page sizes 16, 64 and 128 at ``[16, 8, 512, 64]`` with the
    serving lengths and at T = 8192 (float32), page 64 in bfloat16 and
    float16, and head_dim 48 (pages 16 and 128); and against its plain
    version within ``RAGGED_TOL`` on the shuffled views."""
    import torch

    from bigdl_tpu_torch import kernels
    from bigdl_tpu_torch.kernels.paged_decode import (
        paged_decode_attention, paged_decode_attention_reference,
        paged_view)
    from bigdl_tpu_torch.kernels.ragged_decode import ragged_decode_attention

    gen = torch.Generator(device="cuda").manual_seed(7)
    long_lengths = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 2047, 4097,
                    8191, 8192, 9000, 0]
    launches0 = paged_decode_attention.launches
    checks = 0
    for t, lengths, dtype, d, pages in (
            (MAX_LEN, main_lengths, torch.float32, HEAD_DIM, PAGE_SIZES),
            (MAX_LEN, main_lengths, torch.bfloat16, HEAD_DIM, (64,)),
            (MAX_LEN, main_lengths, torch.float16, HEAD_DIM, (64,)),
            (MAX_LEN, main_lengths, torch.float32, 48, (16, 128)),
            (LC_SEQ, long_lengths, torch.float32, HEAD_DIM, PAGE_SIZES)):
        q = torch.randn((SLOTS, HEADS, d), device="cuda",
                        generator=gen).to(dtype)
        k, v = (torch.randn((SLOTS, HEADS, t, d), device="cuda",
                            generator=gen).to(dtype) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        ref = ragged_decode_attention(q, k, v, lens)
        name = f"{str(dtype).split('.')[-1]} head_dim {d}"
        for page in pages:
            view = paged_view(k, v, page)
            for label, (kp, vp, table) in (
                    ("identity", view),
                    ("shuffled", _shuffled_pages(gen, *view))):
                got = kernels.paged_decode_attention(q, kp, vp, table, lens)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    diff = (got.float() - ref.float()).abs().max().item()
                    raise AssertionError(
                        f"paged_decode {name} T={t} page={page} {label}: "
                        f"not bitwise K3's kernel (max diff {diff})")
                checks += 1
                if label == "shuffled":
                    plain = paged_decode_attention_reference(q, kp, vp,
                                                             table, lens)
                    tol = RAGGED_TOL[str(dtype).split(".")[-1]]
                    err = _err(got, plain, dtype != torch.float32)
                    log("paged_decode", f"{name} T={t} page={page} "
                                        f"shuffled: bitwise K3's kernel; "
                                        f"checked error against the plain "
                                        f"version {err:.3e} (tolerance "
                                        f"{tol})")
                    if not err <= tol:
                        raise AssertionError(f"paged_decode {name} T={t} "
                                             f"page={page}: {err}")
        del k, v
    log("paged_decode", f"{checks} paged views (identity and shuffled, "
                        f"page sizes {list(PAGE_SIZES)}): K4 bitwise "
                        f"equal to K3's kernel; "
                        f"{paged_decode_attention.launches - launches0} "
                        f"K4 calls")
    torch.cuda.empty_cache()


def phase_paged_decode(main_lengths):
    """K4 against K3's kernel (:func:`check_paged`); then timed L2-cold
    at the serving shape beside K3 on the same cache and the plain
    version. K4 has no main-path call site (in neither package), so its
    launches on a main path are 0. Returns the kernels-line entry at
    page size 16 (launches filled in later)."""
    import torch

    from bigdl_tpu_torch.kernels.paged_decode import (
        paged_decode_attention, paged_decode_attention_reference,
        paged_view)
    from bigdl_tpu_torch.kernels.ragged_decode import (
        decode_plan, ragged_decode_attention, sm_count)

    check_paged(main_lengths)
    gen = torch.Generator(device="cuda").manual_seed(8)

    # timing: 8 caches (268 MB together, past the 50 MB L2), the serving
    # lengths, K4 over each page size beside K3 on the same caches
    n_sets, t = 8, MAX_LEN
    sets = [(torch.randn((SLOTS, HEADS, HEAD_DIM), device="cuda",
                         generator=gen),
             torch.randn((SLOTS, HEADS, t, HEAD_DIM), device="cuda",
                         generator=gen),
             torch.randn((SLOTS, HEADS, t, HEAD_DIM), device="cuda",
                         generator=gen)) for _ in range(n_sets)]
    lens = torch.tensor(main_lengths, dtype=torch.int32, device="cuda")
    k3_ms = time_ms(lambda i: ragged_decode_attention(
        sets[i][0], sets[i][1], sets[i][2], lens), n_sets, 50)
    k3_device_ms, _ = device_ms(lambda i: ragged_decode_attention(
        sets[i][0], sets[i][1], sets[i][2], lens), n_sets, 50)
    # K3's plan at T = pages_per_slot * page_size, for every page size
    plan = dict(zip(("stage_keys", "chunk", "splits"), decode_plan(
        SLOTS, HEADS, t, HEAD_DIM, 4, sm_count(lens.device))[:3]))
    entry = None
    for page in PAGE_SIZES:
        views = [(q,) + paged_view(k, v, page) for q, k, v in sets]
        err = (paged_decode_attention(*views[0], lens)
               - paged_decode_attention_reference(*views[0], lens)) \
            .abs().max().item()
        row = {"page_size": page, "T": t, "lengths": list(main_lengths),
               "plan": plan, "max_abs_err": err,
               "kernel_ms": time_ms(lambda i: paged_decode_attention(
                   *views[i], lens), n_sets, 50),
               "plain_ms": time_ms(lambda i: paged_decode_attention_reference(
                   *views[i], lens), n_sets, 3),
               "k3_kernel_ms": k3_ms, "k3_kernel_device_ms": k3_device_ms}
        row["kernel_device_ms"], row["device_ms_windows"] = device_ms(
            lambda i: paged_decode_attention(*views[i], lens), n_sets, 50)
        row["bound_ms"], row["bound_by"] = ragged_bound(main_lengths, t, 4)
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        log("paged_decode", json.dumps(row))
        if not err <= RAGGED_TOL["float32"]:
            raise AssertionError(f"paged_decode timing inputs: {err}")
        if entry is None:
            entry = {"name": "paged_decode", "route": "cuda",
                     "source": "bigdl_tpu_torch/kernels/csrc/"
                               "paged_decode.cu",
                     "replaces": "bigdl_tpu/kernels/paged_decode.py:78",
                     "launches": None, "max_abs_err": err,
                     "ms": row["kernel_ms"],
                     "device_ms": row["kernel_device_ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": None,
                     "library_device_ms": None, "plan": plan,
                     "device_ms_windows": row["device_ms_windows"]}
        del views
    del sets
    torch.cuda.empty_cache()
    return entry


# ---- the int8 serving slice: calibrated ResNet-50 behind InferenceService

def _images(r, n):
    return r.rand(n, 3, IMAGE, IMAGE).astype(np.float32)


def profile_serving(svc, name, batches, device) -> None:
    """Where a serving window's time goes: full batches through
    ``predict_batch`` under ``torch.profiler`` — wall clock, device time
    by kernel and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = device == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        time.sleep(WINDOW_MARGIN_S)
        t0 = time.perf_counter()
        for x in batches:
            svc.predict_batch(name, x)
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(WINDOW_MARGIN_S)
    kernels_ = device_kernels(prof)
    busy_ms = sum(k[0] for k in kernels_)
    log("int8-serve-profile", json.dumps({
        "model": name, "batches": len(batches),
        "rows": sum(len(x) for x in batches), "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if kernels_ else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels_
        else "not measured"}))
    for ms, count, key in kernels_[:12]:
        log("int8-serve-profile", f"{name}: {ms:9.3f} ms {count:6d}x  "
                                  f"{key[:90]}")


def _burst(svc, name, singles, batches):
    """Every request at once, then every result: ``[(x, rows)]`` in
    submission order, the wall seconds and the service's metrics."""
    t0 = time.perf_counter()
    futs = [(x[None], svc.predict_async(name, x)) for x in singles]
    futs += [(x, svc.predict_batch_async(name, x)) for x in batches]
    out = []
    for x, f in futs:
        rows = f.result(timeout=600)
        out.append((x, rows[None] if rows.ndim == 1 else rows))
    return out, time.perf_counter() - t0, svc.metrics(name)


def phase_int8_serve(counters, device="cuda"):
    """The slice's main path: ResNet-50 (ImageNet, 1000 classes, seed 23,
    float32) behind ``InferenceService(max_batch_size=64)``, served by
    two names — the float model, and its int8 rewrite calibrated on 2
    seeded batches of 16 and certified by an ``AccuracyGate`` of 64
    seeded rows (max_delta 0.02). A poisoned candidate (the calibration
    batches x 1000) must be refused with ``AccuracyGateError`` while the
    certified version keeps serving. Then the kernel counts are set to 0
    and a seeded burst of single-row and batch requests is served by
    both names; K5 must have launched once per int8 forward (a hook
    counts the forwards that reach the QuantizedLinear), each served
    int8 row must equal the quantized model's direct forward of its
    request bitwise, int8 on and off must agree bitwise, at most one
    program per rung, and cuDNN's TF32 must be off (the port switches
    it off; PyTorch's default is on). Returns the launches and the
    numbers."""
    import torch

    from bigdl_tpu_torch import kernels, telemetry
    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.nn.quantized import QuantizedLinear
    from bigdl_tpu_torch.precision import AccuracyGate, AccuracyGateError
    from bigdl_tpu_torch.serving import InferenceService, ServingConfig

    # PyTorch's default: float32 convolutions in TF32 on Hopper. The
    # port's convolution layers must switch it off themselves.
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    model = ResNet(RESNET_CLASSES, depth=RESNET_DEPTH,
                   dataset=RESNET_DATASET, device=device,
                   generator=torch.Generator().manual_seed(RESNET_SEED))
    model.eval()
    r = np.random.RandomState(RESNET_SEED + 1)
    calib = [_images(r, CALIB_ROWS) for _ in range(CALIB_BATCHES)]
    gate_rows = _images(r, GATE_ROWS)
    svc = InferenceService(config=ServingConfig(max_batch_size=SERVE_BATCH),
                           device=device)
    shape = (3, IMAGE, IMAGE)
    f32, i8 = "resnet_f32", "resnet_int8"
    try:
        svc.load(f32, model, warmup_shape=shape)
        t_f32 = time.perf_counter() - t0
        tf32_off = not torch.backends.cudnn.allow_tf32
        t0 = time.perf_counter()
        honest = svc.load(i8, model, quantize=True, calibration=calib,
                          accuracy_gate=AccuracyGate(gate_rows,
                                                     max_delta=GATE_DELTA),
                          warmup_shape=shape)
        t_i8 = time.perf_counter() - t0
        gauge = telemetry.gauge("serving/precision/accuracy_delta")
        delta = gauge.value(model=i8)
        log("int8-serve", f"float model loaded and {len(svc.ladder)} rungs "
                          f"warmed in {t_f32:.2f} s; int8 rewrite "
                          f"calibrated, gated and warmed in {t_i8:.2f} s; "
                          f"honest gate delta {delta} (bound {GATE_DELTA}); "
                          f"cuDNN TF32 off: {tf32_off}")
        qmodel = honest.model
        qlinear = [m for m in qmodel.modules()
                   if isinstance(m, QuantizedLinear)]
        forwards = [0]

        def count(module, args):
            forwards[0] += 1

        hooks = [m.register_forward_pre_hook(count) for m in qlinear]
        rb = np.random.RandomState(RESNET_SEED + 2)
        singles = [_images(rb, 1)[0] for _ in range(BURST_SINGLES)]
        batches = [_images(rb, int(n)) for n in
                   rb.randint(1, SERVE_BATCH + 1, BURST_BATCHES)]
        rows = len(singles) + sum(len(x) for x in batches)
        for fn in counters.values():
            fn.launches = 0
        served_i8, dt_i8, m_i8 = _burst(svc, i8, singles, batches)
        served_f32, dt_f32, m_f32 = _burst(svc, f32, singles, batches)
        launches = {name: fn.launches for name, fn in counters.items()}
        i8_forwards = forwards[0]
        for h in hooks:
            h.remove()

        probe = _images(r, 3)
        before = svc.predict_batch(i8, probe)
        try:
            svc.load(i8, model, quantize=True,
                     calibration=[b * 1000.0 for b in calib],
                     accuracy_gate=AccuracyGate(gate_rows,
                                                max_delta=GATE_DELTA),
                     warmup_shape=shape)
            refused = False
        except AccuracyGateError:
            refused = True
        poisoned_delta = gauge.value(model=i8)
        after = svc.predict_batch(i8, probe)
        log("int8-serve", f"poisoned candidate (calibration x 1000): "
                          f"refused {refused}, gate delta {poisoned_delta}; "
                          f"versions {svc.registry.versions(i8)}; the "
                          f"certified version answers as before: "
                          f"{bool(np.array_equal(before, after))}")
        if device == "cuda" and not tf32_off:
            raise AssertionError("cuDNN TF32 is still on after the float "
                                 "model ran")
        if not refused or svc.registry.current(i8) is not honest \
                or svc.registry.versions(i8) != [honest.version] \
                or not np.array_equal(before, after):
            raise AssertionError("the poisoned candidate was not refused "
                                 "cleanly")

        full = [_images(rb, SERVE_BATCH) for _ in range(FULL_BATCHES)]
        rates = {}
        for name in (f32, i8):
            svc.predict_batch(name, full[0])
            t0 = time.perf_counter()
            for x in full:
                svc.predict_batch(name, x)
            rates[name] = len(full) * SERVE_BATCH / (
                time.perf_counter() - t0)
        profile_serving(svc, i8, full[:PROFILE_BATCHES], device)
        profile_serving(svc, f32, full[:PROFILE_BATCHES], device)

        # checks: each served int8 request bitwise the direct forward of
        # its rows alone; int8 on and off; float rows near the direct
        # forward; programs per rung
        with torch.inference_mode():
            def direct(mdl, x):
                return mdl(torch.from_numpy(x).to(device)).cpu().numpy()

            for x, got in served_i8:
                if not np.array_equal(got, direct(qmodel, x)):
                    raise AssertionError(f"a served int8 request of "
                                         f"{len(x)} rows is not bitwise "
                                         f"the direct forward")
            x = full[0]
            on = direct(qmodel, x)
            with kernels.use(kernels.KernelConfig(int8_matmul=False)):
                off = direct(qmodel, x)
            f_direct = direct(model, x)
            f32_err = max(float(np.abs(got - direct(model, xx)).max())
                          for xx, got in served_f32[-4:])
        scale = float(np.abs(f_direct).max())
        i8_vs_f32 = float(np.abs(on - f_direct).max()) / scale
        agree = float((on.argmax(1) == f_direct.argmax(1)).mean())
        programs = {name: svc.compile_count(name) for name in (f32, i8)}
    finally:
        svc.shutdown()

    summary = {
        "model": f"ResNet-{RESNET_DEPTH} {RESNET_DATASET} "
                 f"{RESNET_CLASSES} classes, {IMAGE}x{IMAGE}",
        "requests_per_model": len(singles) + len(batches),
        "rows_per_model": rows,
        "f32_burst_images_per_sec": rows / dt_f32,
        "int8_burst_images_per_sec": rows / dt_i8,
        "f32_full_batch_images_per_sec": rates[f32],
        "int8_full_batch_images_per_sec": rates[i8],
        "f32_latency_ms_p50": m_f32.get("latency_ms_p50"),
        "f32_latency_ms_p99": m_f32.get("latency_ms_p99"),
        "int8_latency_ms_p50": m_i8.get("latency_ms_p50"),
        "int8_latency_ms_p99": m_i8.get("latency_ms_p99"),
        "int8_batches": m_i8["batch_count"], "f32_batches":
            m_f32["batch_count"], "int8_batch_fill": m_i8["batch_fill"],
        "int8_forwards_reaching_quantized_linear": i8_forwards,
        "gate_delta": delta, "poisoned_gate_delta": poisoned_delta,
        "int8_vs_f32_max_rel_diff": i8_vs_f32,
        "int8_vs_f32_top1_agreement": agree,
        "f32_distinct_top1_classes": int(len(set(f_direct.argmax(1)))),
        "f32_served_vs_direct_max_abs_diff": f32_err,
        "f32_logit_scale": scale,
        "programs": programs, "ladder_rungs": len(svc.ladder),
        "launches": launches}
    log("int8-serve", json.dumps(summary))
    if not np.array_equal(on, off):
        raise AssertionError("int8 on and int8 off differ")
    if not (np.isfinite(on).all() and on.shape == (SERVE_BATCH,
                                                   RESNET_CLASSES)):
        raise AssertionError(f"int8 outputs {on.shape}, finite "
                             f"{np.isfinite(on).all()}")
    if max(programs.values()) > len(svc.ladder):
        raise AssertionError(f"{programs} programs > {len(svc.ladder)} "
                             f"rungs")
    if launches["int8_gemm"] != i8_forwards or i8_forwards \
            != m_i8["batch_count"] or i8_forwards == 0:
        raise AssertionError(f"int8_gemm launched {launches['int8_gemm']} "
                             f"times for {i8_forwards} forwards through "
                             f"the QuantizedLinear over "
                             f"{m_i8['batch_count']} batches")
    if not f32_err <= F32_SERVE_RTOL * scale:
        raise AssertionError(f"served float rows {f32_err} from the direct "
                             f"forward (logit scale {scale})")
    log("int8-serve", "served int8 rows bitwise the direct forward; int8 "
                      "on == off bitwise; K5 launched once per int8 "
                      "forward")
    return launches, summary


def separable_digits(n: int, seed: int):
    """A seeded 10-class task of 28 x 28 rows anyone can learn: uniform
    noise in [-0.25, 0.25) with a bright 7 x 5 patch (+2) at the class's
    own place on a 2 x 5 grid. Returns ``(images [n, 1, 28, 28], 1-based
    float labels)``. (LeNet-5 from seeds 43-45 on the CPU reached a
    held-out Top1 of 0.95 in 4 to 6 epochs at lr 0.05, momentum 0.9.)"""
    r = np.random.RandomState(seed)
    y = r.randint(0, 10, n)
    x = (r.rand(n, 1, 28, 28) * 0.5 - 0.25).astype(np.float32)
    for c in range(10):
        top, left = 3 + (c // 5) * 14, 1 + (c % 5) * 5
        x[y == c, 0, top:top + 7, left:left + 5] += 2.0
    return x, (y + 1).astype(np.float32)


def _run_cli(phase, main, argv):
    """``main(argv)`` with its standard output captured and echoed:
    ``(returned value, printed text)``."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = main(argv)
    for line in buf.getvalue().splitlines():
        log(phase, line)
    return value, buf.getvalue()


def _lenet_steps(model, batches, device):
    """Losses of SGD steps (``LENET_LR``, momentum) over ``batches`` on
    ``device``, through the driver's step."""
    import torch

    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, build_train_step

    step = build_train_step(model, ClassNLLCriterion(), SGD(
        learning_rate=LENET_LR, momentum=LENET_MOMENTUM))
    return [float(step(torch.from_numpy(x).to(device),
                       torch.from_numpy(y).to(device), LENET_LR))
            for x, y in batches]


def _max_param_diff(a, b) -> float:
    from bigdl_tpu_torch.convert import flatten_params
    fa, fb = flatten_params(a), flatten_params(b)
    return max(float(np.abs(fa[k] - fb[k]).max()) for k in fa)


def phase_lenet(counters, device="cuda"):
    """The LeNet-5 slice (BASELINE config 1) on ``device``: (a) the
    recipe's own entry points at MNIST's size on synthetic rows, (b) a
    separable task learnt to a held-out Top1 of ``LENET_TOP1``, (c) the
    card against the CPU from the same parameters and batches, with a
    frozen ``fc2`` as the fault the check must catch, (d) the Evaluator
    and the Predictor against the driver's validation, (e) a profiled
    window of training steps. No kernel of the ``kernels`` line is on
    this path: the counts are set to 0 before (a) and must read 0 after.
    Returns the launches and the numbers."""
    import torch

    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.models._cli import arrays_to_dataset
    from bigdl_tpu_torch.models.lenet import test as lenet_test
    from bigdl_tpu_torch.models.lenet import train as lenet_train
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (SGD, Evaluator, LocalOptimizer, Loss,
                                       Predictor, Top1Accuracy, every_epoch,
                                       max_epoch, max_score)
    from bigdl_tpu_torch.utils.engine import full_float32

    full_float32()
    summary = {}
    # (a) the recipe's entry points, validation every epoch
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    model, out = _run_cli("lenet-train", lenet_train.main, [
        "--synthetic", str(LENET_ROWS), "-b", str(LENET_BATCH), "-e", "1",
        "--device", device])
    summary["train_cli_s"] = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    loss = float(re.search(r"final loss: (\S+)", out).group(1))
    scores = dict(re.findall(r"(\w+) ([0-9.]+)", re.search(
        r"validation: (.*)", out).group(1)))
    summary.update(final_loss=loss, images_per_s=float(re.search(
        r"throughput: (\S+) images/s", out).group(1)),
        val_top1=float(scores["Top1Accuracy"]),
        val_top5=float(scores["Top5Accuracy"]))
    results, _ = _run_cli("lenet-test", lenet_test.main, [
        "--synthetic", str(LENET_ROWS), "-b", str(LENET_BATCH),
        "--device", device])
    summary["test_top1"] = results["Top1Accuracy"].result()[0]
    summary["test_top5"] = results["Top5Accuracy"].result()[0]
    if not (np.isfinite(loss) and next(model.parameters()).device.type
            == device and results["Top1Accuracy"].result()[1]
            == LENET_ROWS):
        raise AssertionError(f"LeNet recipe: {summary}")
    if any(launches.values()):
        raise AssertionError(f"a kernel of the kernels line launched on "
                             f"the LeNet path: {launches}")

    # (b) a separable task, validation every epoch until max_score
    x, y = separable_digits(LENET_TRAIN_ROWS, seed=41)
    hx, hy = separable_digits(LENET_HELD_ROWS, seed=42)
    model = LeNet5(10, device=device,
                   generator=torch.Generator().manual_seed(43))
    opt = LocalOptimizer(model, arrays_to_dataset(x, y, LENET_BATCH),
                         ClassNLLCriterion(), batch_size=LENET_BATCH)
    opt.set_optim_method(SGD(learning_rate=LENET_LR,
                             momentum=LENET_MOMENTUM))
    held = arrays_to_dataset(hx, hy, LENET_BATCH)
    opt.set_validation(every_epoch(), held, [Top1Accuracy(), Loss()])
    opt.set_end_when(max_score(LENET_TOP1).or_(max_epoch(LENET_EPOCHS)))
    opt.optimize()
    top1 = opt.driver_state["score"]
    summary.update(learn_top1=top1, learn_epochs=len(opt.validation_history),
                   learn_history=opt.validation_history)
    log("lenet-learn", json.dumps(opt.validation_history))
    if not top1 >= LENET_TOP1:
        raise AssertionError(f"held-out Top1 {top1} < {LENET_TOP1} after "
                             f"{len(opt.validation_history)} epochs")

    # (d) the Evaluator and the Predictor on the same held-out rows
    ev = Evaluator(model).test(held, [Top1Accuracy()], LENET_BATCH)
    rows = Predictor(model).predict(held, LENET_BATCH)
    classes = Predictor(model).predict_class(held, LENET_BATCH)
    if ev["Top1Accuracy"].result()[0] != top1:
        raise AssertionError(f"Evaluator Top1 {ev['Top1Accuracy']} != the "
                             f"driver's last validation {top1}")
    if classes != [int(np.argmax(r)) + 1 for r in rows] \
            or len(rows) != LENET_HELD_ROWS:
        raise AssertionError("predict_class is not the argmax of predict")
    log("lenet-learn", f"held-out Top1 {top1} in "
                       f"{len(opt.validation_history)} epochs; Evaluator "
                       f"and Predictor agree with the driver")

    # (c) the card against the CPU, and a frozen fc2 the check must catch
    batches = [(x[i * LENET_BATCH:(i + 1) * LENET_BATCH],
                y[i * LENET_BATCH:(i + 1) * LENET_BATCH])
               for i in range(LENET_PARITY_STEPS)]
    start = LeNet5(10, device=device,
                   generator=torch.Generator().manual_seed(44))
    params = start.get_parameters()
    reference = LeNet5(10, device="cpu").set_parameters(params)
    want = _lenet_steps(reference, batches, "cpu")
    runs = {}
    for label in ("as is", "fc2 frozen"):
        m = LeNet5(10, device=device).set_parameters(params)
        if label == "fc2 frozen":
            m.find("fc2").freeze()
        got = _lenet_steps(m, batches, device)
        loss_err = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        param_err = _max_param_diff(m.get_parameters(),
                                    reference.get_parameters())
        runs[label] = (loss_err, param_err, m)
        log("lenet-parity", f"{label}: losses {loss_err:.3e} relative, "
                            f"parameters {param_err:.3e} from the CPU's")
    loss_err, param_err, _ = runs["as is"]
    if not (loss_err <= LENET_LOSS_RTOL and param_err <= LENET_PARAM_ATOL):
        raise AssertionError(f"card vs CPU: losses {loss_err}, parameters "
                             f"{param_err}")
    _, frozen_err, frozen = runs["fc2 frozen"]
    fc2 = frozen.find("fc2").get_parameters()
    if frozen_err <= LENET_PARAM_ATOL:
        raise AssertionError(f"the frozen-fc2 fault passed the parameter "
                             f"check ({frozen_err})")
    if not all(np.array_equal(fc2[k], params["10"][k]) for k in fc2):
        raise AssertionError("a frozen fc2 moved")
    summary.update(parity_loss_rtol=loss_err, parity_param_atol=param_err,
                   frozen_fault_param_diff=frozen_err,
                   cudnn_tf32=torch.backends.cudnn.allow_tf32)
    if torch.backends.cudnn.allow_tf32:
        raise AssertionError("cuDNN TF32 is on")

    # (e) where a step's time goes
    px, py = separable_digits(LENET_BATCH * (LENET_PROFILE_STEPS + 1),
                              seed=45)
    prof_batches = [(torch.from_numpy(px[i::LENET_PROFILE_STEPS + 1])
                     .to(device),
                     torch.from_numpy(py[i::LENET_PROFILE_STEPS + 1])
                     .to(device))
                    for i in range(LENET_PROFILE_STEPS + 1)]
    prof = profile_train(model, ClassNLLCriterion(), prof_batches, device,
                         phase="lenet-profile", lr=LENET_LR)
    summary["profile"] = dict(prof, images_per_s=LENET_BATCH * 1e3
                              / prof["wall_ms_per_step"])
    summary["launches"] = launches
    log("lenet", json.dumps(summary))
    return launches, summary


def _recipe_sgd():
    """The ImageNet recipe's SGD (``resnet.train``): lr 0.1, momentum
    0.9, nesterov, weight decay 1e-4, ``EpochDecay(imagenet_decay)``."""
    from bigdl_tpu_torch.models.resnet.train import imagenet_decay
    from bigdl_tpu_torch.optim import SGD, EpochDecay

    return SGD(learning_rate=0.1, weight_decay=1e-4, momentum=0.9,
               dampening=0.0, nesterov=True,
               learning_rate_schedule=EpochDecay(imagenet_decay))


def _resnet50(device, dtype=None):
    """The recipe's ResNet-50 (ImageNet, 1000 classes, its weight seed)
    on ``device``, in ``dtype`` if given."""
    import torch

    from bigdl_tpu_torch.models import ResNet
    from bigdl_tpu_torch.models.resnet.train import _WEIGHT_SEED

    model = ResNet(RESNET_CLASSES, depth=50, dataset="ImageNet",
                   device=device,
                   generator=torch.Generator().manual_seed(_WEIGHT_SEED))
    return model if dtype is None else model.to(dtype)


def _resnet_steps(batches, device, dtype, fault=False):
    """``RT_PARITY_STEPS`` steps of the recipe's SGD from the recipe's
    weights on ``batches``, in ``dtype`` on ``device``; ``fault`` sets
    one BN (layer1's first 1x1 block's) to evaluation mode after the
    step is built. Returns the losses, params and BN state."""
    import torch

    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import build_train_step

    model, method = _resnet50(device, dtype), _recipe_sgd()
    step = build_train_step(model, CrossEntropyCriterion(), method)
    if fault:
        model[4][0][0][0][1].evaluate()
    losses = []
    for x, y in batches:
        lr = method.update_hyper_parameter()
        losses.append(float(step(torch.from_numpy(x).to(device, dtype),
                                 torch.from_numpy(y).to(device, dtype), lr)))
    return losses, model.get_parameters(), model.get_state()


def _resnet_parity(want, got):
    """(largest relative loss difference, largest absolute parameter or
    BN-statistic difference) of two ``_resnet_steps`` results."""
    loss = max(abs(g - w) / abs(w) for g, w in zip(got[0], want[0]))
    return loss, max(_max_param_diff(got[1], want[1]),
                     _max_param_diff(got[2], want[2]))


def phase_resnet_train(counters, device="cuda"):
    """The ResNet-50 training slice (BASELINE config 3) on ``device``:
    (a) the ImageNet recipe at full width, ``-e 2`` with checkpoints,
    then ``-e 3`` resuming from the newest; (b) a resumed run against an
    uninterrupted one; (c) a corrupt checkpoint caught and quarantined;
    (d) the card against the CPU, with one BN in evaluation mode as the
    fault the check must catch; (e) a profiled window of training
    steps. No kernel of the ``kernels`` line is on this path: the counts
    are set to 0 first and must read 0 at the end. Returns the launches
    and the numbers."""
    import os
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.dataset import DataSet, MiniBatch
    from bigdl_tpu_torch.models.resnet import train as resnet_train
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import LocalOptimizer, every_epoch, max_epoch
    from bigdl_tpu_torch.utils.engine import full_float32
    from bigdl_tpu_torch.utils.serialization import (
        CheckpointCorrupt, list_complete_checkpoints, load_checkpoint)

    full_float32()
    for fn in counters.values():
        fn.launches = 0
    saves = telemetry.histogram("train/checkpoint/save_s")
    loads = telemetry.histogram("train/checkpoint/load_s")
    summary = {}
    root = tempfile.mkdtemp(prefix="chip-smoke-resnet-")
    try:
        # (a) the recipe: 2 epochs of 4 steps, a checkpoint at each
        # epoch's end; then -e 3 resumes from the newest and takes 4 more
        ck = os.path.join(root, "recipe")
        argv = ["--dataset", "imagenet", "--depth", "50", "--synthetic",
                str(RT_ROWS), "-b", str(RT_BATCH), "--checkpoint", ck,
                "--device", device]
        n_saves, n_loads = saves.count(), loads.count()
        calls = []
        for epochs in (RT_EPOCHS, RT_EPOCHS + 1):
            t0 = time.perf_counter()
            model, out = _run_cli("resnet-train", resnet_train.main,
                                  argv + ["-e", str(epochs)])
            resumed = re.search(r"resumed from (\S+) at neval (\d+)", out)
            calls.append({
                "epochs": epochs, "seconds": time.perf_counter() - t0,
                "final_loss": float(re.search(r"final loss: (\S+)",
                                              out).group(1)),
                "images_per_s": float(re.search(
                    r"throughput: (\S+) images/s", out).group(1)),
                "steps": int(re.search(r"over (\d+) steps", out).group(1)),
                "resumed_from": resumed and [resumed.group(1),
                                             int(resumed.group(2))]})
        per_epoch = RT_ROWS // RT_BATCH
        names = sorted(os.listdir(ck))
        summary["recipe"] = calls
        if not (calls[0]["resumed_from"] is None
                and calls[0]["steps"] == RT_EPOCHS * per_epoch
                and calls[1]["resumed_from"] is not None
                and calls[1]["resumed_from"][0].endswith(
                    f"checkpoint.{RT_EPOCHS * per_epoch + 1}")
                and calls[1]["resumed_from"][1] == RT_EPOCHS * per_epoch + 1
                and calls[1]["steps"] == per_epoch
                and names == sorted(f"checkpoint.{e * per_epoch + 1}"
                                    for e in range(1, RT_EPOCHS + 2))
                and all(np.isfinite(c["final_loss"]) for c in calls)
                and next(model.parameters()).device.type == device):
            raise AssertionError(f"ResNet-50 recipe: {calls}, {names}")
        newest = os.path.join(ck, names[-1])
        summary["checkpoint"] = {
            "bytes": sum(os.path.getsize(os.path.join(newest, f))
                         for f in os.listdir(newest)),
            "save_s": saves.samples()[-(saves.count() - n_saves):],
            "load_s": loads.samples()[-(loads.count() - n_loads):]}
        del model
        log("resnet-train", json.dumps(summary))

        # (b) resumed against uninterrupted: 64 rows as one MiniBatch,
        # so each epoch is one step over the rows in one order; cuDNN's
        # deterministic algorithms, so two runs over the same state agree
        r = np.random.RandomState(0)
        rows = MiniBatch(
            r.rand(RT_RESUME_BATCH, 3, IMAGE, IMAGE).astype(np.float32),
            r.randint(1, RESNET_CLASSES + 1,
                      RT_RESUME_BATCH).astype(np.float32))

        def run(ckdir, epochs):
            opt = LocalOptimizer(_resnet50(device), DataSet.array([rows]),
                                 CrossEntropyCriterion(),
                                 batch_size=RT_RESUME_BATCH)
            opt.set_optim_method(_recipe_sgd())
            opt.set_checkpoint(ckdir, every_epoch())
            opt.set_end_when(max_epoch(epochs))
            opt.optimize()
            return opt

        torch.backends.cudnn.deterministic = True
        try:
            straight = run(os.path.join(root, "straight"), RT_RESUME_EPOCHS)
            resumed_dir = os.path.join(root, "resumed")
            run(resumed_dir, RT_RESUME_EPOCHS // 2)
            resumed = run(resumed_dir, RT_RESUME_EPOCHS)
        finally:
            torch.backends.cudnn.deterministic = False
        param_err = _max_param_diff(resumed.model.get_parameters(),
                                    straight.model.get_parameters())
        state_err = _max_param_diff(resumed.model.get_state(),
                                    straight.model.get_state())
        loss_err = abs(resumed.history[-1]["loss"]
                       - straight.history[-1]["loss"]) \
            / abs(straight.history[-1]["loss"])
        summary["resume"] = {
            "losses_straight": [h["loss"] for h in straight.history],
            "losses_resumed": [h["loss"] for h in resumed.history],
            "resumed_from": resumed.resumed_from,
            "param_diff": param_err, "bn_state_diff": state_err,
            "last_loss_rel_diff": loss_err}
        log("resnet-resume", json.dumps(summary["resume"]))
        if not (resumed.resumed_from["neval"] == RT_RESUME_EPOCHS // 2 + 1
                and len(resumed.history) == RT_RESUME_EPOCHS // 2
                and param_err <= RT_RESUME_ATOL
                and state_err <= RT_RESUME_ATOL
                and loss_err <= RT_RESUME_LOSS_RTOL):
            raise AssertionError(f"resumed != uninterrupted: "
                                 f"{summary['resume']}")
        del straight, resumed

        # (c) one flipped byte in the newest checkpoint's params.npz; a
        # fresh run must quarantine it and resume from the one before
        complete = list_complete_checkpoints(resumed_dir)
        newest, previous = complete[-1][1], complete[-2]
        npz = os.path.join(newest, "params.npz")
        with open(npz, "r+b") as f:
            f.seek(os.path.getsize(npz) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        try:
            load_checkpoint(newest)
        except CheckpointCorrupt as e:
            log("resnet-corrupt", f"load_checkpoint raised: {e}")
        else:
            raise AssertionError("a flipped byte passed load_checkpoint")
        again = run(resumed_dir, RT_RESUME_EPOCHS + 1)
        left = sorted(os.listdir(resumed_dir))
        summary["corrupt"] = {"resumed_from": again.resumed_from,
                              "dirs": left}
        log("resnet-corrupt", json.dumps(summary["corrupt"]))
        if not (again.resumed_from["path"] == previous[1]
                and again.resumed_from["neval"] == previous[0][0]
                and any(n.startswith(os.path.basename(newest)
                                     + ".corrupt-") for n in left)):
            raise AssertionError(f"corrupt checkpoint: {summary['corrupt']}")
        del again

        # (d) the card against the CPU, in float64 (gated) and float32
        # (reported: float32's own rounding on this problem, CPU float32
        # against CPU float64, is of the same size as their gap)
        r = np.random.RandomState(RT_PARITY_SEED)
        batches = [(r.rand(RT_PARITY_BATCH, 3, IMAGE, IMAGE)
                    .astype(np.float32),
                    r.randint(1, RESNET_CLASSES + 1, RT_PARITY_BATCH)
                    .astype(np.float32)) for _ in range(RT_PARITY_STEPS)]
        cpu64 = _resnet_steps(batches, "cpu", torch.float64)
        cpu32 = _resnet_steps(batches, "cpu", torch.float32)
        card64 = _resnet_steps(batches, device, torch.float64)
        card32 = _resnet_steps(batches, device, torch.float32)
        fault64 = _resnet_steps(batches, device, torch.float64, fault=True)
        parity = {
            "float64": _resnet_parity(cpu64, card64),
            "float64, one BN in evaluation mode": _resnet_parity(cpu64,
                                                                 fault64),
            "float32": _resnet_parity(cpu32, card32),
            "cpu float32 against cpu float64": _resnet_parity(cpu64, cpu32),
            "losses": {"cpu64": cpu64[0], "card64": card64[0],
                       "cpu32": cpu32[0], "card32": card32[0],
                       "fault64": fault64[0]}}
        summary["parity"] = parity
        log("resnet-parity", json.dumps(parity))
        loss_err, param_err = parity["float64"]
        if not (loss_err <= RT_PARITY_LOSS_RTOL
                and param_err <= RT_PARITY_ATOL):
            raise AssertionError(f"card vs CPU: {parity['float64']}")
        loss_err, param_err = parity["float64, one BN in evaluation mode"]
        if loss_err <= RT_PARITY_LOSS_RTOL and param_err <= RT_PARITY_ATOL:
            raise AssertionError("the BN-in-evaluation-mode fault passed "
                                 "the card-vs-CPU check")
        summary["cudnn_tf32"] = torch.backends.cudnn.allow_tf32
        if torch.backends.cudnn.allow_tf32:
            raise AssertionError("cuDNN TF32 is on")

        # (e) where a step's time goes, the batches already on the card
        g = torch.Generator(device=device).manual_seed(RESNET_SEED)
        prof_batches = [
            (torch.rand((RT_BATCH, 3, IMAGE, IMAGE), generator=g,
                        device=device),
             torch.randint(1, RESNET_CLASSES + 1, (RT_BATCH,), generator=g,
                           device=device).float())
            for _ in range(RT_PROFILE_STEPS + 1)]
        on_card = device == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        prof = profile_train(_resnet50(device), CrossEntropyCriterion(),
                             prof_batches, device,
                             phase="resnet-profile", method=_recipe_sgd())
        summary["profile"] = dict(
            prof, images_per_s=RT_BATCH * 1e3 / prof["wall_ms_per_step"],
            max_memory_allocated=torch.cuda.max_memory_allocated()
            if on_card else "not measured")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    summary["launches"] = launches
    log("resnet", json.dumps(summary))
    if any(launches.values()):
        raise AssertionError(f"a kernel of the kernels line launched on "
                             f"the ResNet training path: {launches}")
    return launches, summary


def _train_model(device, layers=None, **kw):
    """The training slice's TransformerLM (its weight seed) on
    ``device``, ``layers`` deep (default ``LAYERS``); ``kw`` goes to the
    constructor (MoE blocks, dropout)."""
    import torch

    from bigdl_tpu_torch.models import TransformerLM

    return TransformerLM(vocab_size=TRAIN_VOCAB, hidden_size=HIDDEN,
                         num_layers=layers or LAYERS, num_heads=HEADS,
                         ffn_size=FFN,
                         max_len=TRAIN_SEQ, device=device,
                         generator=torch.Generator().manual_seed(21), **kw)


def _corpus_batch(corpus, i, device):
    """Batch ``i`` of the packed corpus on ``device``: three planes and
    the targets."""
    import torch

    x, y = corpus
    rows = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
    return ([torch.from_numpy(p[rows]).to(device) for p in x],
            torch.from_numpy(y[rows]).to(device))


def _stack(batches):
    """``[(input, target)]`` of device batches -> one stacked window
    ``(xs, ys)`` (``[K, B, ...]``; a list input stacks plane by plane)."""
    import torch

    xs = [b[0] for b in batches]
    if isinstance(xs[0], (list, tuple)):
        xs = [torch.stack(planes) for planes in zip(*xs)]
    else:
        xs = torch.stack(xs)
    return xs, torch.stack([b[1] for b in batches])


def _has_instance(kernels, name: str, dtype: str) -> bool:
    """Whether a profiler window ran an instance of kernel ``name`` in
    ``dtype`` (``__nv_bfloat16``, ``__half``, ``float``)."""
    return any(name in key and dtype in key for _, _, key in kernels)


def _instances(kernels, name: str) -> int:
    """How many instances of kernel ``name`` a profiler window ran."""
    return sum(count for _, count, key in kernels if name in key)


def _window_calls(window, steps: int, on_card: bool) -> int:
    """The calls a kernel wrapper on every step's path gets in a run of
    ``steps`` steps that all ran in ``window`` (None: one by one): on
    the card one warm-up step and the K captured steps for each window
    shape (a replay calls no wrapper), on the CPU every step."""
    if window is None or not on_card:
        return steps
    return sum(1 + k for k, _ in window.shapes)


def profile_window(window, stacked, lrs, device, phase) -> dict:
    """Where a window's time goes: ``window`` (``make_host_window``'s)
    called
    once to capture it, then ``len(stacked)`` windows under
    ``torch.profiler`` (wall-clock, device time by kernel, idle share).
    ``stacked`` is ``[(xs, ys)]`` on the device. The same windows run
    again with no profiler give ``unprofiled_ms_per_step``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for xs, ys in stacked:
        window(xs, ys, lrs[:len(ys)]).tolist()          # capture, warm
    steps = sum(len(ys) for _, ys in stacked)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_MARGIN_S)
        t0 = time.perf_counter()
        losses = [window(xs, ys, lrs[:len(ys)]).tolist()
                  for xs, ys in stacked]
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(WINDOW_MARGIN_S)
    kernels = device_kernels(prof)
    busy_ms = sum(k[0] for k in kernels)
    read = bool(kernels) and busy_ms <= wall_ms
    numbers = {
        "windows": len(stacked), "steps": steps, "wall_ms": wall_ms,
        "wall_ms_per_step": wall_ms / steps,
        "device_busy_ms": busy_ms if read else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if read
        else "not measured",
        "top": [[ms, count, key[:90]] for ms, count, key in kernels[:5]]}
    log(phase, json.dumps(numbers))
    for ms, count, key in kernels[:10]:
        log(phase, f"{ms:9.3f} ms {count:6d}x  {key[:90]}")
    t0 = time.perf_counter()
    for xs, ys in stacked:
        window(xs, ys, lrs[:len(ys)]).tolist()
    torch.cuda.synchronize(device)
    unprofiled = (time.perf_counter() - t0) * 1e3 / steps
    log(phase, f"the same windows with no profiler: {unprofiled:.3f} ms a "
               f"step")
    return dict(numbers, kernels=kernels, losses=losses,
                unprofiled_ms_per_step=unprofiled)


#: K1's kernels, each launched once a layer and step
K1_KERNELS = ("flash_fwd_kernel", "flash_dkv_kernel", "flash_dq_kernel")


def profile_k1_replays(window, stacked, lrs, device, phase):
    """:func:`profile_window` over ``window``'s replays of ``stacked``,
    read until K1's kernels ran exactly once a layer and replayed step
    (the replays call no wrapper, so the profiler counts them): a window
    that lost kernels at its edge is read again, up to twice; more
    kernels than that fail at once. Returns the numbers and the
    counts."""
    for _ in range(3):
        prof = profile_window(window, stacked, lrs, device, phase)
        ran = {name: _instances(prof["kernels"], name)
               for name in K1_KERNELS}
        want = LAYERS * prof["steps"]
        log(phase, f"K1 kernels in {prof['steps']} profiled replayed "
                   f"steps: {ran} (want {want} each)")
        if any(n > want for n in ran.values()):
            raise AssertionError(f"K1 kernels ran {ran} times in "
                                 f"{prof['steps']} replayed steps x "
                                 f"{LAYERS} layers")
        if all(n == want for n in ran.values()):
            return prof, ran
    raise AssertionError(f"K1 kernels ran {ran} times in {prof['steps']} "
                         f"replayed steps x {LAYERS} layers, three windows "
                         f"read")


def _snapshot(tensors):
    return [t.detach().clone() for t in tensors]


def _bitwise(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _windowed_run(build, k, root):
    """One run of ``build(k, ckdir)`` (a configured LocalOptimizer):
    returns what (c) compares — losses, the final parameters and buffers,
    the scaler state, the checkpoint names and trees, and the window's
    graph and shape counts."""
    import os

    from bigdl_tpu_torch.precision import SCALER_KEY
    from bigdl_tpu_torch.utils.serialization import load_checkpoint

    ckdir = os.path.join(root, f"k{k}")
    opt = build(k, ckdir)
    model = opt.optimize()
    names = sorted(os.listdir(ckdir)) if os.path.isdir(ckdir) else []
    trees = [load_checkpoint(os.path.join(ckdir, n)) for n in names]
    ss = opt.train_step.opt_state.get(SCALER_KEY, {})
    return {"losses": [h["loss"] for h in opt.history],
            "params": _snapshot(model.parameters()),
            "buffers": _snapshot(model.buffers()),
            "scaler": _snapshot(ss[key] for key in sorted(ss)),
            "checkpoints": names, "trees": trees,
            "graphs": opt.window.captures if opt.window else 0,
            "shapes": len(opt.window.shapes) if opt.window else 0,
            "window": opt.window}


def _trees_bitwise(a, b) -> bool:
    from bigdl_tpu_torch.convert import flatten_params

    def flat(tree, prefix=""):
        out = {}
        for key, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{key}."))
            else:
                out[prefix + key] = np.asarray(v)
        return out
    fa, fb = flat(a), flat(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and fa[k].tobytes() == fb[k].tobytes()
        for k in fa)


def phase_precision(counters, corpus, f32_train, device="cuda"):
    """The precision slice (queue 1, item 5) on ``device``: (a)
    bf16_mixed TransformerLM at the training width through K1 in
    bfloat16 — one step against the einsum path (and with faults in K1's
    backward, which must fail it), then ``PREC_ITERS`` iterations through
    ``LocalOptimizer.set_precision("bf16_mixed").set_steps_per_sync(8)``
    (K1's wrapper calls exact: a warm-up and the captured steps for each
    graph), profiled at K = 1 and K = 8 beside the float32 step
    (``f32_train``, phase_train's summary), K1's kernels in the profiled
    replays exactly one per layer and step; (b) f16_mixed, one window of
    ``F16_ITERS`` steps (its first must overflow) against the same steps
    one by one; (c) windowed
    against
    per-step, bitwise, for LeNet-5 under f16_mixed and a 2-layer
    TransformerLM under bf16_mixed; (d) LeNet-5's host-bound step at K =
    1 and K = 8; (e) ResNet-50 at batch 64, float32 against bf16_mixed.
    Returns K1's launches on (a)'s and (b)'s paths and the numbers."""
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.models._cli import arrays_to_dataset
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, CrossEntropyCriterion,
                                    SequenceCrossEntropyCriterion)
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer, Trigger,
                                       build_train_step, make_host_window,
                                       max_iteration, seed_precision,
                                       several_iteration)
    from bigdl_tpu_torch.precision import (MASTER_KEY, SCALER_KEY,
                                           DynamicLossScaler,
                                           PrecisionPolicy)

    x, y = corpus
    bf16, f16 = PrecisionPolicy.bf16_mixed(), PrecisionPolicy.f16_mixed()
    crit = SequenceCrossEntropyCriterion(ignore_index=-1)
    on_card = device == "cuda"
    summary = {}
    k1 = ("flash_attention_fwd", "flash_attention_bwd")

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def k1_launches():
        return {name: counters[name].launches for name in k1}

    # (a) one bf16 step, K1 against the einsum path, then with faults
    model = _train_model(device)
    batch0 = _corpus_batch(corpus, 0, device)
    diffs = step_differences(model, crit, batch0, precision=bf16)

    _log_bf16_step("precision", "kernel", diffs)
    summary["one_step"] = {k: diffs[k] for k in (
        "loss_kernel", "loss_einsum", "loss_rel_diff", "param_diff",
        "update_max", "param_rel_diff")}
    summary["one_step"]["worst_grad_rel_diff"] = max(
        diffs["grad_rel_diff"].values())
    if not bf16_step_holds(diffs):
        raise AssertionError(f"bf16 kernel step differs from the einsum "
                             f"step: {diffs}")
    for fault in PREC_FAULTS:
        d = step_differences(model, crit, batch0, fault, precision=bf16)
        _log_bf16_step("precision", f"kernel with {fault}", d)
        summary["one_step"][f"worst_grad_rel_diff with {fault}"] = max(
            d["grad_rel_diff"].values())
        if bf16_step_holds(d):
            raise AssertionError(f"the bf16 one-step check misses a kernel "
                                 f"with {fault}: {d}")

    # (a) PREC_ITERS iterations, bf16_mixed, windows of PREC_K steps
    samples = [Sample([p[i] for p in x], y[i]) for i in range(len(y))]
    ds = DataSet.array(samples).transform(SampleToMiniBatch(TRAIN_BATCH))
    opt = LocalOptimizer(model, ds, crit, batch_size=TRAIN_BATCH)
    opt.set_optim_method(SGD(learning_rate=TRAIN_LR))
    opt.set_end_when(max_iteration(PREC_ITERS))
    opt.set_precision("bf16_mixed").set_steps_per_sync(PREC_K)
    reset()
    t0 = time.perf_counter()
    opt.optimize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    losses = [h["loss"] for h in opt.history]
    f32_losses = f32_train["losses"]
    gap = [abs(a - b) for a, b in zip(losses, f32_losses)]
    window_ms = sorted(h["seconds"] * 1e3 for h in opt.history[PREC_K:])
    a = {"iterations": len(losses), "seconds": wall,
         "ms_per_step_median_k8": window_ms[len(window_ms) // 2],
         "graphs": opt.window.captures, "shapes": len(opt.window.shapes),
         "loss_first": losses[0], "loss_last": losses[-1],
         "loss_mean_first5": float(np.mean(losses[:5])),
         "loss_mean_last5": float(np.mean(losses[-5:])),
         "bf16_vs_f32_loss_gap_max": max(gap),
         "bf16_vs_f32_loss_gap_mean": float(np.mean(gap)),
         "launches": launches}
    log("precision", json.dumps(a))
    summary["bf16_run"] = a
    if not all(np.isfinite(losses)) or len(losses) != PREC_ITERS:
        raise AssertionError(f"bf16 losses: {losses}")
    if not a["loss_mean_last5"] < a["loss_mean_first5"]:
        raise AssertionError(f"bf16 loss did not fall: {losses}")
    calls = LAYERS * _window_calls(opt.window, PREC_ITERS, on_card)
    for name in k1:
        if launches[name] != calls:
            raise AssertionError(f"{name} called {launches[name]} times over "
                                 f"{PREC_ITERS} windowed iterations x "
                                 f"{LAYERS} layers, not {calls}")
    if not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError("bf16_mixed parameters are not float32 at rest")
    if on_card and a["graphs"] != a["shapes"]:
        raise AssertionError(f"{a['graphs']} graphs for {a['shapes']} "
                             f"window shapes")
    a_launches = k1_launches()
    # the same iterations one step a sync, from the same weights: the
    # step's wall time with no profiler, and whether the losses match
    opt1 = LocalOptimizer(_train_model(device), ds, crit,
                          batch_size=TRAIN_BATCH)
    opt1.set_optim_method(SGD(learning_rate=TRAIN_LR))
    opt1.set_end_when(max_iteration(PREC_ITERS))
    opt1.set_precision("bf16_mixed").optimize()
    k1_ms = sorted(h["seconds"] * 1e3 for h in opt1.history[2:])
    a.update(ms_per_step_median_k1=k1_ms[len(k1_ms) // 2],
             k1_losses_equal_k8=[h["loss"] for h in opt1.history] == losses)
    log("precision", f"the same {PREC_ITERS} iterations at K = 1: median "
                     f"{a['ms_per_step_median_k1']:.3f} ms a step, losses "
                     f"bitwise the K = {PREC_K} run's: "
                     f"{a['k1_losses_equal_k8']}")
    del opt1

    # (a) profiles: bf16 at K = 1, then windows of PREC_K
    # the corpus holds 32 full batches: the profiles take them from the
    # start again
    prof_batches = [_corpus_batch(corpus, i, device)
                    for i in range(2 * PREC_K + 1)]
    k1_prof = profile_train(model, crit, prof_batches[:PROFILE_STEPS + 1],
                            device, phase="precision-profile-k1",
                            precision=bf16, detail=True)
    step = build_train_step(model, crit, SGD(learning_rate=TRAIN_LR),
                            precision=bf16)
    k8_window, k8_prof = make_host_window(step), None
    if on_card:
        k8_prof, a["k1_kernels_in_profiled_replays"] = profile_k1_replays(
            k8_window,
            [_stack(prof_batches[1 + i * PREC_K:1 + (i + 1) * PREC_K])
             for i in range(2)], [TRAIN_LR] * PREC_K, device,
            "precision-profile-k8")
    slab = TRAIN_BATCH * TRAIN_SEQ
    summary["bf16_profile"] = {
        "k1_ms_per_step": k1_prof["wall_ms_per_step"],
        "k1_tokens_per_s": slab * 1e3 / k1_prof["wall_ms_per_step"],
        "k1_idle_share": k1_prof["device_idle_share"],
        "k1_unprofiled_ms_per_step": k1_prof["unprofiled_ms_per_step"],
        "k8_ms_per_step": k8_prof and k8_prof["wall_ms_per_step"],
        "k8_tokens_per_s": k8_prof and slab * 1e3
        / k8_prof["wall_ms_per_step"],
        "k8_idle_share": k8_prof and k8_prof["device_idle_share"],
        "k8_unprofiled_ms_per_step": k8_prof
        and k8_prof["unprofiled_ms_per_step"],
        "f32_ms_per_step_median": f32_train["ms_per_step_median"],
        "f32_tokens_per_s": f32_train["tokens_per_sec"]}
    log("precision", json.dumps(summary["bf16_profile"]))
    if on_card:
        for name in K1_KERNELS:
            for prof in (k1_prof, k8_prof):
                if not _has_instance(prof["kernels"], name,
                                     "__nv_bfloat16"):
                    raise AssertionError(f"no bfloat16 {name} in the "
                                         f"bf16_mixed profile")
    del model, opt, step, k8_window, k8_prof

    # (b) f16_mixed: one window whose first step overflows, against the
    # same steps one by one from the same state
    model = _train_model(device)
    step = build_train_step(model, crit, SGD(learning_rate=TRAIN_LR,
                                             momentum=F16_MOMENTUM),
                            precision=f16,
                            loss_scaler=DynamicLossScaler(**F16_SCALER))
    seed_precision(step)
    params = list(model.parameters())
    master, moment = step.opt_state[MASTER_KEY], step.opt_state["v"]
    ss = step.opt_state[SCALER_KEY]
    state = [*params, *master, *moment, *(ss[k] for k in sorted(ss))]
    start = _snapshot(state)
    batches = [_corpus_batch(corpus, i, device) for i in range(F16_ITERS)]
    window = make_host_window(step)
    reset()
    w_losses = window(*_stack(batches), [TRAIN_LR] * F16_ITERS).tolist()
    b_launches = k1_launches()
    after_window = _snapshot(state)
    with torch.no_grad():
        for t, v in zip(state, start):
            t.copy_(v)
    lr_t = torch.full((), TRAIN_LR, device=device)
    # the same steps one by one: each step that overflows (skipped rises)
    # must leave the parameters, the master and the momentum bitwise as
    # they were and halve the scale; each other step must move them
    p_losses, skipped, scales, kept_by_skip, moved = [], [], [], [], []
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        for inp, tgt in batches:
            before = _snapshot([*params, *master, *moment])
            scale0, skipped0 = float(ss["scale"]), int(ss["skipped"])
            p_losses.append(float(step(inp, tgt, lr_t)))
            skipped.append(int(ss["skipped"]))
            scales.append(float(ss["scale"]))
            same = _bitwise(_snapshot([*params, *master, *moment]), before)
            if skipped[-1] > skipped0:
                kept_by_skip.append(same and scales[-1] == scale0 / 2)
            else:
                moved.append(not same)
    f16_kernels = device_kernels(prof) if on_card else []
    b = {"window_losses": w_losses, "per_step_losses": p_losses,
         "skipped_after_each_step": skipped, "scale_after_each_step": scales,
         "skipped_steps_left_state_unchanged": kept_by_skip,
         "applied_steps_moved_state": moved,
         "window_equals_per_step": w_losses == p_losses
         and _bitwise(after_window, _snapshot(state)),
         "at_rest_is_master_cast_down": _bitwise(
             _snapshot(params), [m.to(torch.float16) for m in master]),
         "launches": b_launches}
    b["first_step_overflowed"] = skipped[0] == 1
    log("precision-f16", json.dumps(b))
    summary["f16"] = b
    if not (b["first_step_overflowed"] and all(kept_by_skip)):
        raise AssertionError(f"the first f16 step did not overflow, or a "
                             f"skipped step changed the state or did not "
                             f"halve the scale: {b}")
    if not (moved and all(moved)):
        raise AssertionError(f"no f16 step of the window applied, or an "
                             f"applied one changed nothing: {b}")
    if not (b["window_equals_per_step"] and b["at_rest_is_master_cast_down"]
            and all(np.isfinite(w_losses))):
        raise AssertionError(f"f16 window: {b}")
    calls = LAYERS * _window_calls(window, F16_ITERS, on_card)
    for name in k1:
        if b_launches[name] != calls:
            raise AssertionError(f"{name} called {b_launches[name]} times "
                                 f"in a window of {F16_ITERS} steps x "
                                 f"{LAYERS} layers, not {calls}")
    if on_card:
        for name in ("flash_fwd_kernel", "flash_dkv_kernel",
                     "flash_dq_kernel"):
            if not _has_instance(f16_kernels, name, "__half"):
                raise AssertionError(f"no float16 {name} ran")
    # the window's pace: one more call on the same shapes (a replay of
    # its graph on the card; the state moves on, nothing below reads it)
    t0 = time.perf_counter()
    window(*_stack(batches), [TRAIN_LR] * F16_ITERS).tolist()
    b["window_replay_ms_per_step"] = ((time.perf_counter() - t0) * 1e3
                                      / F16_ITERS)
    log("precision-f16", f"one more window of {F16_ITERS} steps: "
                         f"{b['window_replay_ms_per_step']:.3f} ms a step")
    del model, step, window, state, start, after_window

    # (c) windowed against per-step, bitwise
    root = tempfile.mkdtemp(prefix="chip-smoke-precision-")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        lx, ly = separable_digits(WIN_LENET_ROWS, seed=46)
        seen = {}

        def lenet(k, ckdir):
            from bigdl_tpu_torch.utils.random import RandomGenerator
            RandomGenerator.set_seed(47)
            record = seen.setdefault(k, [])
            gauge = telemetry.gauge("train/precision/skipped_steps")

            def end(s):
                record.append((s["neval"], gauge.value()))
                return s["neval"] > WIN_LENET_STEPS

            opt = LocalOptimizer(
                LeNet5(10, device=device,
                       generator=torch.Generator().manual_seed(1)),
                arrays_to_dataset(lx, ly, LENET_BATCH), ClassNLLCriterion(),
                batch_size=LENET_BATCH)
            opt.set_optim_method(SGD(learning_rate=LENET_LR,
                                     momentum=LENET_MOMENTUM))
            opt.set_end_when(Trigger(
                end, depends_on=frozenset({"neval"}),
                peek=lambda s: s["neval"] > WIN_LENET_STEPS))
            opt.set_checkpoint(ckdir, several_iteration(WIN_LENET_CKPT))
            opt.set_precision("f16_mixed",
                              DynamicLossScaler(**WIN_LENET_SCALER))
            return opt.set_steps_per_sync(k)

        def lm(k, ckdir):
            opt = LocalOptimizer(_train_model(device, WIN_LM_LAYERS), ds,
                                 crit, batch_size=TRAIN_BATCH)
            opt.set_optim_method(SGD(learning_rate=TRAIN_LR))
            opt.set_end_when(max_iteration(WIN_LM_STEPS))
            opt.set_precision("bf16_mixed")
            return opt.set_steps_per_sync(k)

        c = {}
        for name, build, layers in (("lenet_f16", lenet, 0),
                                    ("transformer_bf16", lm, WIN_LM_LAYERS)):
            runs = {}
            for k in (1, PREC_K):
                reset()
                runs[k] = _windowed_run(build, k, f"{root}/{name}")
                runs[k]["k1"] = k1_launches()
            one, many = runs[1], runs[PREC_K]
            row = {"losses_equal": one["losses"] == many["losses"],
                   "params_equal": _bitwise(one["params"], many["params"]),
                   "buffers_equal": _bitwise(one["buffers"],
                                             many["buffers"]),
                   "scaler_equal": _bitwise(one["scaler"], many["scaler"]),
                   "checkpoints": [one["checkpoints"],
                                   many["checkpoints"]],
                   "checkpoint_trees_equal": all(
                       _trees_bitwise(ta[part], tb[part])
                       for ta, tb in zip(one["trees"], many["trees"])
                       for part in ("params", "opt_state", "model_state")),
                   "graphs": many["graphs"], "shapes": many["shapes"],
                   "k1_launches": [one["k1"], many["k1"]],
                   "loss_last": one["losses"][-1]}
            if name == "lenet_f16":
                # the end trigger runs before every step (K = 1) or
                # window (K = 8), after the last one's sync: (neval,
                # skipped so far) at each
                rec = seen[1]
                skips = [n for (n, v), (_, w) in zip(rec, rec[1:]) if w > v]
                firsts = [n for n, _ in seen[PREC_K][:-1]]
                row["skipped_steps"] = skips
                row["window_first_steps"] = firsts
                row["skips_inside_a_window"] = [n for n in skips
                                                if n not in firsts]
            log("precision-windowed", f"{name}: {json.dumps(row)}")
            c[name] = row
            ok = (row["losses_equal"] and row["params_equal"]
                  and row["buffers_equal"] and row["scaler_equal"]
                  and row["checkpoints"][0] == row["checkpoints"][1]
                  and row["checkpoint_trees_equal"]
                  and (not on_card or row["graphs"] == row["shapes"]))
            if not ok:
                raise AssertionError(f"{name}: windowed != per-step: {row}")
            want = [layers * _window_calls(r["window"], WIN_LM_STEPS,
                                           on_card) for r in (one, many)]
            if layers and [[r["k1"][n] for n in k1] for r in (one, many)] \
                    != [[w, w] for w in want]:
                raise AssertionError(f"{name}: K1 calls {row}, not {want}")
            if name == "lenet_f16" and not row["skips_inside_a_window"]:
                raise AssertionError(f"lenet_f16: the scaler never backed "
                                     f"off inside a window: {row}")
        summary["windowed"] = c
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)

    # (d) LeNet-5's host-bound step at K = 1 and K = PREC_K (float32)
    px, py = separable_digits(LENET_BATCH * (LENET_PROFILE_STEPS + 1),
                              seed=45)
    lenet_batches = [(torch.from_numpy(px[i::LENET_PROFILE_STEPS + 1])
                      .to(device),
                      torch.from_numpy(py[i::LENET_PROFILE_STEPS + 1])
                      .to(device))
                     for i in range(LENET_PROFILE_STEPS + 1)]
    lenet = LeNet5(10, device=device,
                   generator=torch.Generator().manual_seed(1))
    d1 = profile_train(lenet, ClassNLLCriterion(), lenet_batches, device,
                       phase="precision-lenet-k1", lr=LENET_LR, detail=True)
    d = {"k1_ms_per_step": d1["wall_ms_per_step"],
         "k1_idle_share": d1["device_idle_share"],
         "k1_unprofiled_ms_per_step": d1["unprofiled_ms_per_step"]}
    if on_card:
        step = build_train_step(lenet, ClassNLLCriterion(),
                                SGD(learning_rate=LENET_LR))
        chunks = [lenet_batches[1 + i:1 + i + PREC_K]
                  for i in range(0, LENET_PROFILE_STEPS, PREC_K)]
        d8 = profile_window(make_host_window(step),
                            [_stack(ch) for ch in chunks],
                            [LENET_LR] * PREC_K, device,
                            "precision-lenet-k8")
        d.update(k8_ms_per_step=d8["wall_ms_per_step"],
                 k8_idle_share=d8["device_idle_share"],
                 k8_unprofiled_ms_per_step=d8["unprofiled_ms_per_step"])
    log("precision-lenet", json.dumps(d))
    summary["lenet_host_bound"] = d

    # (e) ResNet-50 at batch RP_BATCH: float32 against bf16_mixed
    g = torch.Generator(device=device).manual_seed(RESNET_SEED)
    one_batch = (torch.rand((RP_BATCH, 3, IMAGE, IMAGE), generator=g,
                            device=device),
                 torch.randint(1, RESNET_CLASSES + 1, (RP_BATCH,),
                               generator=g, device=device).float())
    e = {}
    for name, policy in (("float32", None), ("bf16_mixed", bf16)):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        resnet = _resnet50(device)
        prof = profile_train(resnet, CrossEntropyCriterion(),
                             [one_batch] * (RP_STEPS + 1), device,
                             phase=f"precision-resnet-{name}", lr=RP_LR,
                             precision=policy, detail=True)
        e[name] = {
            "ms_per_step": prof["wall_ms_per_step"],
            "images_per_s": RP_BATCH * 1e3 / prof["wall_ms_per_step"],
            "idle_share": prof["device_idle_share"],
            "unprofiled_ms_per_step": prof["unprofiled_ms_per_step"],
            "unprofiled_images_per_s": RP_BATCH * 1e3
            / prof["unprofiled_ms_per_step"],
            "peak_memory_bytes": torch.cuda.max_memory_allocated()
            if on_card else "not measured",
            "losses": prof["losses"],
            "bn_statistics": sorted({str(b.dtype).split(".")[-1]
                                     for b in resnet.buffers()})}
        del resnet
        losses = prof["losses"]
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"ResNet-50 {name} losses: {losses}")
        if e[name]["bn_statistics"] != ["float32"]:
            raise AssertionError(f"ResNet-50 {name} BN statistics: "
                                 f"{e[name]['bn_statistics']}")
    log("precision-resnet", json.dumps(e))
    summary["resnet50"] = e
    launches = {"bf16_mixed": a_launches, "f16_mixed": b_launches}
    summary["k1_launches"] = launches
    return launches, summary


def _adam_fault(fault):
    """An Adam whose step count is faulted: ``"t not advanced"`` (each
    step corrected as step 0: infinite corrections) or ``"t advanced
    twice"`` (each step corrected as the next one)."""
    from bigdl_tpu_torch.optim import Adam

    class FaultyAdam(Adam):
        def update(self, grads, state, params, lr):
            state["t"].add_(-1 if fault == "t not advanced" else 1)
            super().update(grads, state, params, lr)

    return FaultyAdam(learning_rate=ADAM_LR)


def adam_step_holds(d, label):
    """The one-step check of a bf16_mixed Adam step, kernel path against
    the einsum path (``step_differences(method=...)``), at phase 11's
    limits: the loss (relative), every gradient and Adam's first moment
    ``m`` (each relative to its largest element, floored as the
    gradients are), ``t`` 1 on both paths, and the parameters over the
    rate where the first moment is above twice the gradient limit. Adam's
    first update is about ``lr * sign(g)``, so an element whose gradient
    lies within the two paths' rounding of 0 (the key bias's, 0 in exact
    arithmetic) may step either way: the parameters are held where the
    gradient's sign is fixed. Returns the numbers and whether they
    hold."""
    import torch

    (sk, se), (ak, ae) = d["states"], d["after"]
    floor = TRAIN_GRAD_FLOOR * max(float(m.abs().max()) for m in se["m"])
    m_rel, p_rel = 0.0, 0.0
    names = list(d["grad_rel_diff"])
    for name, mk, me in zip(names, sk["m"], se["m"]):
        scale = max(float(me.abs().max()), floor)
        m_rel = max(m_rel, float((mk - me).abs().max()) / scale)
        fixed = me.abs() > 2 * PREC_GRAD_RTOL * scale
        diff = (ak[name] - ae[name]).abs()[fixed]
        if diff.numel():
            p_rel = max(p_rel, float(diff.max()) / ADAM_LR)
    if not all(bool(torch.isfinite(t).all()) for t in ak.values()):
        p_rel = float("nan")        # compares False: fails the check
    out = {"loss_rel_diff": d["loss_rel_diff"],
           "worst_grad_rel_diff": max(d["grad_rel_diff"].values()),
           "m_rel_diff": m_rel, "param_diff_over_lr": p_rel,
           "t": [int(sk["t"]), int(se["t"])],
           "update_max_over_lr": d["update_max"] / ADAM_LR}
    ok = (out["loss_rel_diff"] <= PREC_LOSS_RTOL
          and out["worst_grad_rel_diff"] <= PREC_GRAD_RTOL
          and m_rel <= PREC_GRAD_RTOL and p_rel <= PREC_PARAM_RTOL
          and out["t"] == [1, 1])
    log("optim", f"one bf16_mixed Adam step, {label}: {json.dumps(out)} "
                 f"(limits: loss {PREC_LOSS_RTOL}, gradients and m "
                 f"{PREC_GRAD_RTOL}, parameters {PREC_PARAM_RTOL} of the "
                 f"rate, t [1, 1]): {'holds' if ok else 'fails'}")
    return out, ok


def _method_steps(name, params, batches, device, method=None):
    """``OPT_PARITY_STEPS`` float32 LeNet-5 steps with OptimMethod
    ``name`` (``OPT_METHODS``' settings; ``method`` in its place) on
    ``device`` from ``params``: the losses and the parameters after."""
    import torch

    from bigdl_tpu_torch import optim
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion

    model = LeNet5(10, device=device).set_parameters(params)
    method = method or getattr(optim, name)(**OPT_METHODS[name])
    step = optim.build_train_step(model, ClassNLLCriterion(), method)
    lr = torch.zeros((), device=device)
    losses = []
    for x, y in batches:
        lr.fill_(method.update_hyper_parameter())
        losses.append(float(step(torch.from_numpy(x).to(device),
                                 torch.from_numpy(y).to(device), lr)))
    return losses, model.get_parameters()


class _FailOnce:
    """A dataset that raises ``exc`` once, when the run pulls its
    ``at``-th batch (counted over the whole run)."""

    def __init__(self, base, at, exc):
        self.base, self.at, self.exc, self.pulled = base, at, exc, 0

    def size(self):
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()
        return self

    def data(self, train):
        for batch in self.base.data(train):
            self.pulled += 1
            if self.pulled == self.at and self.exc is not None:
                exc, self.exc = self.exc, None
                raise exc
            yield batch


def phase_optim(counters, corpus, sgd_bf16, device="cuda"):
    """The optim slice (queue 1, item 6) on ``device``: (a) the training
    slice's TransformerLM under bf16_mixed with Adam — one step against
    the einsum path (``adam_step_holds``; Adam with ``t`` not advanced
    must fail it), ``OPT_STEPS`` iterations through ``LocalOptimizer``
    at K = ``OPT_K`` and at K = 1 bitwise alike (losses, parameters,
    ``m``, ``v``, ``t``) with K1's wrapper calls exact, then a profiled
    window of ``OPT_K`` (ms a step profiled and not, tokens/s, idle
    share, the update's device time, K1's kernels once a layer and
    replayed step) beside phase 11's SGD step (``sgd_bf16``); (b) each
    OptimMethod on LeNet-5, card against CPU, with Adam's ``t`` advanced
    twice as the fault; (c) a warm-up then Poly across windows, bitwise
    the per-step loop; (d) Plateau on the held-out Top1 (the window
    falls back per step; the rate drops after the patience); (e) LBFGS
    with strong-Wolfe over 60,000 rows, and card against CPU in float64;
    (f) retry from the newest checkpoint after an injected ``OSError``,
    bitwise the uninterrupted run, and a ``TypeError`` failing at once.
    No kernel of the ``kernels`` line may launch in (b)-(f). Returns
    K1's launches on (a)'s path and the numbers."""
    import logging
    import os
    import shutil
    import tempfile

    import torch

    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.models import LeNet5
    from bigdl_tpu_torch.models._cli import arrays_to_dataset
    from bigdl_tpu_torch.nn import (ClassNLLCriterion,
                                    SequenceCrossEntropyCriterion)
    from bigdl_tpu_torch.optim import (LBFGS, SGD, Adam, LocalOptimizer,
                                       Plateau, Poly, SequentialSchedule,
                                       Top1Accuracy, Warmup,
                                       build_train_step, every_epoch,
                                       make_host_window, max_iteration,
                                       several_iteration)
    from bigdl_tpu_torch.precision import PrecisionPolicy
    from bigdl_tpu_torch.utils.engine import full_float32
    from bigdl_tpu_torch.utils.random import RandomGenerator

    x, y = corpus
    on_card = device == "cuda"
    crit = SequenceCrossEntropyCriterion(ignore_index=-1)
    bf16 = PrecisionPolicy.bf16_mixed()
    summary = {}
    k1 = ("flash_attention_fwd", "flash_attention_bwd")

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    # (a) one Adam step, K1 against the einsum path, then with a fault
    model = _train_model(device)
    batch0 = _corpus_batch(corpus, 0, device)
    a_one = {}
    for label, fault in (("kernel", None), ("t not advanced",
                                            "t not advanced")):
        d = step_differences(
            model, crit, batch0, precision=bf16, lr=ADAM_LR,
            method=lambda path: _adam_fault(fault)
            if fault and path == "kernel" else Adam(learning_rate=ADAM_LR))
        a_one[label], ok = adam_step_holds(d, label)
        del d
        if ok != (fault is None):
            raise AssertionError(f"the Adam one-step check "
                                 f"{'fails' if fault is None else 'misses'}"
                                 f" {label}: {a_one[label]}")
    summary["one_step"] = a_one
    del model

    # (a) OPT_STEPS iterations, bf16_mixed Adam, at K = OPT_K and K = 1
    samples = [Sample([p[i] for p in x], y[i]) for i in range(len(y))]
    ds = DataSet.array(samples).transform(SampleToMiniBatch(TRAIN_BATCH))
    runs = {}
    for k in (OPT_K, 1):
        opt = LocalOptimizer(_train_model(device), ds, crit,
                             batch_size=TRAIN_BATCH)
        opt.set_optim_method(Adam(learning_rate=ADAM_LR))
        opt.set_end_when(max_iteration(OPT_STEPS))
        opt.set_precision("bf16_mixed").set_steps_per_sync(k)
        reset()
        t0 = time.perf_counter()
        opt.optimize()
        st = opt.train_step.opt_state
        runs[k] = {"seconds": time.perf_counter() - t0,
                   "losses": [h["loss"] for h in opt.history],
                   "params": _snapshot(opt.model.parameters()),
                   "state": _snapshot([*st["m"], *st["v"], st["t"]]),
                   "t": int(st["t"]), "launches": launches(),
                   "window": opt.window,
                   "graphs": opt.window.captures if opt.window else 0}
        del opt, st
    many, one = runs[OPT_K], runs[1]
    a = {"steps": OPT_STEPS, "k": OPT_K,
         "losses_equal": many["losses"] == one["losses"],
         "params_equal": _bitwise(many["params"], one["params"]),
         "m_v_t_equal": _bitwise(many["state"], one["state"]),
         "t": [many["t"], one["t"]], "graphs": many["graphs"],
         "shapes": len(many["window"].shapes),
         "loss_first": many["losses"][0], "loss_last": many["losses"][-1],
         "seconds": [many["seconds"], one["seconds"]],
         "k1_launches": [{n: r["launches"][n] for n in k1}
                         for r in (many, one)]}
    log("optim", json.dumps(a))
    if not (a["losses_equal"] and a["params_equal"] and a["m_v_t_equal"]
            and a["t"] == [OPT_STEPS, OPT_STEPS]
            and all(np.isfinite(many["losses"]))):
        raise AssertionError(f"Adam at K = {OPT_K} != per step: {a}")
    if on_card and a["graphs"] != a["shapes"]:
        raise AssertionError(f"{a['graphs']} graphs for {a['shapes']} "
                             f"window shapes")
    for r, window in ((many, many["window"]), (one, None)):
        want = LAYERS * _window_calls(window, OPT_STEPS, on_card)
        if any(r["launches"][n] != want for n in k1):
            raise AssertionError(f"K1 called {r['launches']} times, not "
                                 f"{want}")
    a_launches = {n: many["launches"][n] for n in k1}
    del runs, many, one

    # (a) where the Adam step's time goes: windows of OPT_K, profiled
    model = _train_model(device)
    step = build_train_step(model, crit, Adam(learning_rate=ADAM_LR),
                            precision=bf16)
    window = make_host_window(step)
    stacked = [_stack([_corpus_batch(corpus, 1 + i * OPT_K + j, device)
                       for j in range(OPT_K)]) for i in range(2)]
    slab = TRAIN_BATCH * TRAIN_SEQ
    if on_card:
        # (a graph window is the card's: the CPU runs its steps one by
        # one, and there is no device time to read)
        prof, ran = profile_k1_replays(window, stacked, [ADAM_LR] * OPT_K,
                                       device, "optim-profile-k8")
        busy = prof["device_busy_ms"]
        # the update's torch._foreach_* ops run as multi_tensor_apply
        # kernels
        update_ms = sum(ms for ms, _, key in prof["kernels"]
                        if "multi_tensor_apply" in key) / prof["steps"]
        a_prof = {
            "ms_per_step": prof["wall_ms_per_step"],
            "unprofiled_ms_per_step": prof["unprofiled_ms_per_step"],
            "tokens_per_s": slab * 1e3 / prof["wall_ms_per_step"],
            "unprofiled_tokens_per_s": slab * 1e3
            / prof["unprofiled_ms_per_step"],
            "idle_share": prof["device_idle_share"],
            "device_busy_ms_per_step": busy / prof["steps"]
            if isinstance(busy, float) else busy,
            "update_device_ms_per_step": update_ms,
            "update_kernels": [[ms, n, key[:90]] for ms, n, key
                               in prof["kernels"]
                               if "multi_tensor_apply" in key][:6],
            "k1_kernels_in_profiled_replays": ran,
            "sgd_bf16_k8": sgd_bf16}
        log("optim", json.dumps(a_prof))
        summary["adam_profile"] = a_prof
        if not update_ms > 0:
            raise AssertionError("no foreach update kernel in the Adam "
                                 "step's profile")
    summary["adam_windows"] = a
    del model, step, window, stacked

    # (b)-(f) LeNet-5: no kernel of the kernels line on these paths
    full_float32()
    reset()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    root = tempfile.mkdtemp(prefix="chip-smoke-optim-")
    try:
        # (b) each method, card against the CPU; Adam with t advanced
        # twice as the fault
        lx, ly = separable_digits(LENET_BATCH * OPT_PARITY_STEPS, seed=48)
        batches = [(lx[i::OPT_PARITY_STEPS], ly[i::OPT_PARITY_STEPS])
                   for i in range(OPT_PARITY_STEPS)]
        params = LeNet5(10, device="cpu", generator=torch.Generator()
                        .manual_seed(49)).get_parameters()
        b = {}
        for name in list(OPT_METHODS) + ["Adam, t advanced twice"]:
            fault = name.startswith("Adam,")
            cpu_name = "Adam" if fault else name
            want_l, want_p = _method_steps(cpu_name, params, batches, "cpu")
            got_l, got_p = _method_steps(
                cpu_name, params, batches, device,
                _adam_fault("t advanced twice") if fault else None)
            row = {"loss_rel": max(abs(g - w) / abs(w)
                                   for g, w in zip(got_l, want_l)),
                   "param_abs": _max_param_diff(got_p, want_p),
                   "loss_last": got_l[-1]}
            row["holds"] = (row["loss_rel"] <= LENET_LOSS_RTOL
                            and row["param_abs"] <= LENET_PARAM_ATOL)
            b[name] = row
            log("optim-methods", f"{name}: {json.dumps(row)}")
            if row["holds"] == fault:
                raise AssertionError(f"card vs CPU, {name}: {row} (limits "
                                     f"{LENET_LOSS_RTOL} relative, "
                                     f"{LENET_PARAM_ATOL})")
        summary["methods_card_vs_cpu"] = b

        # (c) SGD with a warm-up then Poly, windows across the warm-up
        cx, cy = separable_digits(LENET_BATCH * SCHED_STEPS, seed=50)

        def sched_run(k):
            RandomGenerator.set_seed(51)
            opt = LocalOptimizer(
                LeNet5(10, device=device).set_parameters(params),
                arrays_to_dataset(cx, cy, LENET_BATCH), ClassNLLCriterion(),
                batch_size=LENET_BATCH)
            opt.set_optim_method(SGD(
                learning_rate=LENET_LR, momentum=LENET_MOMENTUM,
                learning_rate_schedule=SequentialSchedule()
                .add(Warmup(SCHED_DELTA), SCHED_WARMUP)
                .add(Poly(0.5, SCHED_POLY), SCHED_POLY)))
            opt.set_end_when(max_iteration(SCHED_STEPS))
            opt.set_steps_per_sync(k)
            opt.optimize()
            return opt
        s8, s1 = sched_run(OPT_K), sched_run(1)
        c = {"lrs": [h["lr"] for h in s8.history],
             "lrs_equal": [h["lr"] for h in s8.history]
             == [h["lr"] for h in s1.history],
             "losses_equal": [h["loss"] for h in s8.history]
             == [h["loss"] for h in s1.history],
             "params_equal": _bitwise(_snapshot(s8.model.parameters()),
                                      _snapshot(s1.model.parameters())),
             "graphs": s8.window.captures if s8.window else 0}
        log("optim-schedule", json.dumps(c))
        summary["schedule_windows"] = c
        if not (c["lrs_equal"] and c["losses_equal"] and c["params_equal"]
                and s8.window is not None
                and len(set(c["lrs"][:SCHED_WARMUP])) == SCHED_WARMUP):
            raise AssertionError(f"warm-up then Poly at K = {OPT_K} != per "
                                 f"step: {c}")
        del s8, s1

        # (d) Plateau on the held-out Top1, card and CPU
        px, py = separable_digits(LENET_BATCH * PLATEAU_BATCHES, seed=52)
        hx, hy = separable_digits(2 * LENET_BATCH, seed=53)

        def plateau_run(dev, record):
            RandomGenerator.set_seed(54)
            opt = LocalOptimizer(
                LeNet5(10, device=dev).set_parameters(params),
                arrays_to_dataset(px, py, LENET_BATCH), ClassNLLCriterion(),
                batch_size=LENET_BATCH)
            opt.set_optim_method(SGD(
                learning_rate=LENET_LR, learning_rate_schedule=Plateau(
                    factor=PLATEAU_FACTOR, patience=PLATEAU_PATIENCE,
                    mode="max", epsilon=2.0)))
            opt.set_validation(every_epoch(),
                               arrays_to_dataset(hx, hy, LENET_BATCH),
                               [Top1Accuracy()])
            opt.set_end_when(max_iteration(PLATEAU_BATCHES
                                           * PLATEAU_EPOCHS))
            opt.set_steps_per_sync(OPT_K)
            handler = logging.Handler()
            handler.emit = lambda r: record.append(r.getMessage())
            lg = logging.getLogger("bigdl_tpu_torch.optim.optimizer")
            level = lg.level
            lg.setLevel(logging.INFO)
            lg.addHandler(handler)
            try:
                opt.optimize()
            finally:
                lg.removeHandler(handler)
                lg.setLevel(level)
            return opt
        logs = {"card": [], "cpu": []}
        pc, pcpu = plateau_run(device, logs["card"]), \
            plateau_run("cpu", logs["cpu"])
        why = [m for m in logs["card"] if "Plateau" in m]
        lrs = [h["lr"] for h in pc.history]
        drop = 1 + PLATEAU_BATCHES * (PLATEAU_PATIENCE + 1)
        d = {"lrs": lrs, "lrs_equal_cpu": lrs == [h["lr"] for h
                                                    in pcpu.history],
             "loss_rel": max(abs(g["loss"] - w["loss"]) / abs(w["loss"])
                             for g, w in zip(pc.history, pcpu.history)),
             "param_abs": _max_param_diff(pc.model.get_parameters(),
                                          pcpu.model.get_parameters()),
             "validations": pc.validation_history,
             "window": pc.window is not None, "fallback_log": why[:1]}
        log("optim-plateau", json.dumps(d))
        summary["plateau"] = d
        if not (why and not d["window"] and d["lrs_equal_cpu"]
                and all(lr == LENET_LR for lr in lrs[:drop - 1])
                and all(lr == LENET_LR * PLATEAU_FACTOR
                        for lr in lrs[drop - 1:])
                and d["loss_rel"] <= LENET_LOSS_RTOL
                and d["param_abs"] <= LENET_PARAM_ATOL):
            raise AssertionError(f"Plateau: {d}")
        del pc, pcpu

        # (e) LBFGS with strong-Wolfe, full batch
        e = {}
        fx, fy = separable_digits(LBFGS_ROWS, seed=55)

        def lbfgs_run(dev, dtype, rows, iters):
            model = LeNet5(10, device=dev).set_parameters(params).to(dtype)
            crit_ = ClassNLLCriterion()
            inp = torch.from_numpy(fx[:rows]).to(dev, dtype)
            tgt = torch.from_numpy(fy[:rows]).to(dev)
            evals = []

            def feval(p):
                leaves = {k: v.detach().requires_grad_()
                          for k, v in p.items()}
                loss = crit_(torch.func.functional_call(model, leaves,
                                                        (inp,)), tgt)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                evals.append(1)
                return loss.detach(), dict(zip(leaves, grads))

            x0 = {k: v.detach().clone()
                  for k, v in model.named_parameters()}
            t0 = time.perf_counter()
            out, hist = LBFGS(max_iter=iters,
                              max_eval=2 * iters).optimize(feval, x0)
            if dev == "cuda":
                torch.cuda.synchronize()
            return out, hist, len(evals), time.perf_counter() - t0

        _, hist, n_evals, secs = lbfgs_run(device, torch.float32,
                                           LBFGS_ROWS, LBFGS_ITERS)
        e["f32"] = {"rows": LBFGS_ROWS, "iterations": len(hist) - 1,
                    "evaluations": n_evals, "seconds": secs,
                    "ms_per_evaluation": secs * 1e3 / n_evals,
                    "f_history": hist,
                    "input_bytes": LBFGS_ROWS * 28 * 28 * 4}
        log("optim-lbfgs", json.dumps(e["f32"]))
        if not (all(np.isfinite(hist)) and hist[-1] < 0.5 * hist[0]
                and all(b <= a for a, b in zip(hist, hist[1:]))):
            raise AssertionError(f"LBFGS f history: {hist}")
        got, g_hist, _, _ = lbfgs_run(device, torch.float64,
                                      LBFGS_F64_ROWS, LBFGS_F64_ITERS)
        want, w_hist, _, _ = lbfgs_run("cpu", torch.float64,
                                       LBFGS_F64_ROWS, LBFGS_F64_ITERS)
        e["f64"] = {"f_history_card": g_hist, "f_history_cpu": w_hist,
                    "f_rel": max(abs(a - b) / abs(b)
                                 for a, b in zip(g_hist, w_hist)),
                    "param_abs": max(float((got[k].cpu() - want[k])
                                           .abs().max()) for k in want)}
        log("optim-lbfgs", json.dumps(e["f64"]))
        summary["lbfgs"] = e
        if not (len(g_hist) == len(w_hist)
                and e["f64"]["f_rel"] <= LBFGS_F64_TOL
                and e["f64"]["param_abs"] <= LBFGS_F64_TOL):
            raise AssertionError(f"LBFGS float64, card vs CPU: {e['f64']}")

        # (f) retry from the newest checkpoint
        rx, ry = separable_digits(LENET_BATCH * RETRY_BATCHES, seed=56)
        recoveries = telemetry.counter("train/optimizer/recoveries")

        def retry_run(ckdir, exc=None):
            RandomGenerator.set_seed(57)
            opt = LocalOptimizer(
                LeNet5(10, device=device).set_parameters(params),
                _FailOnce(arrays_to_dataset(rx, ry, LENET_BATCH),
                          RETRY_FAIL_AT, exc), ClassNLLCriterion(),
                batch_size=LENET_BATCH)
            opt.set_optim_method(Adam(learning_rate=ADAM_LR))
            opt.set_end_when(max_iteration(RETRY_STEPS))
            opt.set_checkpoint(os.path.join(root, ckdir),
                               several_iteration(RETRY_CKPT))
            opt.retry_interval_s = 0.01
            return opt
        straight = retry_run("straight")
        straight.optimize()
        before = recoveries.value()
        retried = retry_run("retried", OSError("injected: disk blip"))
        retried.optimize()
        f = {"recoveries": recoveries.value() - before,
             "resumed_from": os.path.basename(
                 retried.resumed_from["path"]),
             "params_equal": _bitwise(
                 _snapshot(retried.model.parameters()),
                 _snapshot(straight.model.parameters())),
             "losses_equal": [h["loss"] for h in retried.history]
             == [h["loss"] for h in straight.history],
             "t": int(retried.train_step.opt_state["t"])}
        fatal = retry_run("fatal", TypeError("injected: bad batch"))
        before = recoveries.value()
        try:
            fatal.optimize()
            f["fatal"] = "did not raise"
        except TypeError as err:
            f["fatal"] = f"raised at neval {fatal.driver_state['neval']}: " \
                         f"{err}"
        f["fatal_recoveries"] = recoveries.value() - before
        log("optim-retry", json.dumps(f))
        summary["retry"] = f
        if not (f["recoveries"] == 1 and f["params_equal"]
                and f["losses_equal"] and f["t"] == RETRY_STEPS
                and f["fatal"].startswith("raised at neval "
                                          f"{RETRY_FAIL_AT}")
                and f["fatal_recoveries"] == 0):
            raise AssertionError(f"retry: {f}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(root, ignore_errors=True)
    lenet_launches = launches()
    if any(lenet_launches.values()):
        raise AssertionError(f"a kernel of the kernels line launched on "
                             f"(b)-(f)'s paths: {lenet_launches}")
    summary["k1_launches"] = a_launches
    return a_launches, summary


@contextlib.contextmanager
def _pinned_routing(layers: int):
    """Within the block, ``torch.topk`` (called only by the MoE layers in
    a train step) records the routing of the first forward's ``layers``
    calls and hands it to every later forward: the values gathered at
    the recorded indices (``topk``'s gradient is the same scatter), so
    a second path routes every token as the first did. Yields a list
    that gets, for each replayed call, the number of tokens whose own
    top-k set differs from the recorded one (the routing flips the pin
    took out)."""
    import torch

    real = torch.topk
    record, flips = [], []

    def topk(x, k, dim=-1, *args, **kw):
        got = real(x, k, dim, *args, **kw)
        if len(record) < layers:
            record.append(got[1])
            return got
        idx = record[len(flips) % layers]
        flips.append(int((got[1].sort(dim)[0] != idx.sort(dim)[0])
                         .any(dim).sum()))
        return x.gather(dim, idx), idx

    torch.topk = topk
    try:
        yield flips
    finally:
        torch.topk = real


def _write_ptb(folder, seed):
    """A seeded PTB-style ``train.txt`` and ``test.txt`` under
    ``folder``: lines of ``CLI_LINE_WORDS`` words drawn from a Zipf law
    over ``CLI_VOCAB`` words (PTB's files are one tokenized sentence a
    line)."""
    import os

    r = np.random.RandomState(seed)
    words = np.asarray([f"w{i}" for i in range(CLI_VOCAB)])
    p = 1.0 / np.arange(1, CLI_VOCAB + 1)
    p /= p.sum()
    for name, lines in (("train.txt", CLI_TRAIN_LINES),
                        ("test.txt", CLI_TEST_LINES)):
        with open(os.path.join(folder, name), "w") as f:
            for _ in range(lines):
                n = r.randint(*CLI_LINE_WORDS)
                f.write(" ".join(r.choice(words, n, p=p)) + "\n")


def _layer_device_ms(layer, x, device, phase, label, iters=10):
    """Device ms of one forward and backward of ``layer`` on ``x`` (the
    summed kernel durations of ``iters`` calls under ``torch.profiler``,
    over ``iters``), after two warm calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    g = torch.randn_like(x)

    def run():
        layer(x).backward(g)
    for _ in range(2):
        run()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(WINDOW_MARGIN_S)
        for _ in range(iters):
            run()
        torch.cuda.synchronize(device)
        time.sleep(WINDOW_MARGIN_S)
    kernels = device_kernels(prof)
    ms = sum(k[0] for k in kernels) / iters
    log(phase, f"{label}: {ms:.4f} device ms a forward and backward; "
               f"busiest: " + json.dumps([[round(k[0] / iters, 4), k[1],
                                           k[2][:70]] for k in kernels[:4]]))
    return ms


def phase_lm(counters, corpus, device="cuda"):
    """The LM slice (queue 1, item 7) on ``device``: (a) the training
    width with the moe recipe's layout (``MOE_EXPERTS`` experts, top 2,
    every ``MOE_EVERY``-th block) under bf16_mixed with Adam — one step
    on K1 against the einsum path at phase 11's limits (the router's
    gradients included); the load-balance weight 0 against
    ``AUX_WEIGHT`` (the router's gradient must move by more than
    ``AUX_FAULT_MIN_FRACTION`` of its largest element: a dropped aux
    term fails); ``MOE_STEPS`` steps through ``LocalOptimizer`` at K =
    ``MOE_K`` and K = 1 bitwise alike (losses, parameters, ``m``,
    ``v``, ``t``, the MoE buffers), K1's wrapper calls exact, falling
    losses, ``expert_frac`` summing to 1 in each MoE block; a profiled
    window of 16 replayed steps (K1's bfloat16 kernels once a layer and
    step; ms a step profiled and not, tokens/s, idle share, peak memory
    against the dense model's), and the MoE layer's forward and backward
    device ms against the dense FFN's; (b) the dense training cell in
    float32 at attention dropout ``DROPOUT``: ``DROP_STEPS`` steps at K
    = ``DROP_K`` (the graphs replay the step's generator) and K = 1
    bitwise alike, no K1 wrapper call in training, another seed other
    losses, an evaluation forward calling K1 once a layer and equal
    bitwise to a dropout-0 model's, a drawn mask's keep fraction within
    4 sigma of ``1 - DROPOUT``, and every option at once (MoE, dropout,
    the untied head; 2 layers, bf16_mixed Adam) at K = ``DROP_K`` and
    K = 1 bitwise alike; (c) the text CLIs on a seeded
    PTB-style corpus: ``transformer.train -f --checkpoint --inputMode
    packed --moeExperts 4 --dropout 0.1 -e 2``, ``transformer.test`` on
    a snapshot of the result (its perplexity within ``CLI_PPL_RTOL`` of
    exp of a direct mean NLL), and training resumed with ``--model`` /
    ``--state`` (its held-out perplexity below the snapshot's). Returns
    K1's launches on (a)'s path and the numbers."""
    import copy
    import math
    import os
    import pickle
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.dataset import (DataSet, Dictionary, Sample,
                                         SampleToMiniBatch, ptb_arrays,
                                         read_words)
    from bigdl_tpu_torch.models.transformer import test as lm_test
    from bigdl_tpu_torch.models.transformer import train as lm_train
    from bigdl_tpu_torch.nn import MoE, SequenceCrossEntropyCriterion
    from bigdl_tpu_torch.nn.dropout import keep_mask
    from bigdl_tpu_torch.optim import (SGD, Adam, LocalOptimizer,
                                       build_train_step, make_host_window,
                                       max_iteration)
    from bigdl_tpu_torch.precision import PrecisionPolicy
    from bigdl_tpu_torch.utils.engine import full_float32
    from bigdl_tpu_torch.utils.random import RandomGenerator
    from bigdl_tpu_torch.utils.serialization import (find_latest_checkpoint,
                                                     load_checkpoint,
                                                     load_module,
                                                     save_module)

    x, y = corpus
    on_card = device == "cuda"
    crit = SequenceCrossEntropyCriterion(ignore_index=-1)
    bf16 = PrecisionPolicy.bf16_mixed()
    summary = {}
    k1 = ("flash_attention_fwd", "flash_attention_bwd")
    moe_blocks = [i for i in range(LAYERS) if i % MOE_EVERY == MOE_EVERY - 1]
    slab = TRAIN_BATCH * TRAIN_SEQ

    def reset():
        for fn in counters.values():
            fn.launches = 0

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    def moe_model():
        return _train_model(device, moe_experts=MOE_EXPERTS,
                            moe_every=MOE_EVERY)

    def moes(model):
        return [model.get_submodule(f"block_{i}.mlp") for i in moe_blocks]

    samples = [Sample([p[i] for p in x], y[i]) for i in range(len(y))]
    ds = DataSet.array(samples).transform(SampleToMiniBatch(TRAIN_BATCH))

    # (a) one bf16 Adam step, K1 against the einsum path. A bfloat16
    # probability ties its neighbours often enough that the two paths'
    # last-bit differences route a few tokens to another expert, which
    # moves the experts' and the router's gradients by more than the
    # limits; the check pins the einsum path to the kernel path's
    # routing, and reports the flips and the unpinned differences
    model = moe_model()
    if not all(isinstance(m, MoE) for m in moes(model)):
        raise AssertionError(f"blocks {moe_blocks} are not MoE blocks")
    batch0 = _corpus_batch(corpus, 0, device)

    def one_step():
        return step_differences(
            model, crit, batch0, precision=bf16, lr=ADAM_LR,
            method=lambda path: Adam(learning_rate=ADAM_LR))
    with _pinned_routing(len(moe_blocks)) as flips:
        d = one_step()
    one, ok = adam_step_holds(d, "MoE model, kernel, routing pinned")
    one["router_grad_rel_diff"] = {k: v for k, v in
                                   d["grad_rel_diff"].items()
                                   if k.endswith(".router")}
    free = one_step()
    one["routing_flips_pinned"] = flips
    one["unpinned"] = {
        "loss_rel_diff": free["loss_rel_diff"],
        "worst_grad_rel_diff": max(free["grad_rel_diff"].values()),
        "router_grad_rel_diff": {k: v for k, v in
                                 free["grad_rel_diff"].items()
                                 if k.endswith(".router")}}
    log("lm-moe", f"one step against the einsum path, router gradients "
                  f"(routing pinned): "
                  f"{json.dumps(one['router_grad_rel_diff'])} (limit "
                  f"{PREC_GRAD_RTOL}); tokens routed otherwise by the "
                  f"einsum path, a layer: {flips} of {slab}; unpinned: "
                  f"{json.dumps(one['unpinned'])}")
    del d, free
    if not ok or len(one["router_grad_rel_diff"]) != len(moe_blocks) \
            or len(flips) != len(moe_blocks):
        raise AssertionError(f"the MoE one-step check fails: {one}")
    summary["one_step"] = one

    # (a) the load-balance term in the objective: weight 0 against 0.01
    start = _state(model)
    aux = {}
    for w in (0.0, AUX_WEIGHT):
        model.load_state_dict(start)
        step = build_train_step(model, crit, Adam(learning_rate=ADAM_LR),
                                precision=bf16, aux_loss_weight=w)
        loss = float(step(*batch0, ADAM_LR))
        aux[w] = (loss, [m.router.grad.detach().clone()
                         for m in moes(model)])
    model.load_state_dict(start)
    fault = {"loss": [aux[0.0][0], aux[AUX_WEIGHT][0]],
             "router_grad_max_diff": max(
                 float((a - b).abs().max())
                 for a, b in zip(aux[0.0][1], aux[AUX_WEIGHT][1])),
             "router_grad_max": max(float(g.abs().max())
                                    for g in aux[AUX_WEIGHT][1])}
    log("lm-moe", f"aux weight 0 against {AUX_WEIGHT}: "
                  f"{json.dumps(fault)}")
    if not (fault["loss"][0] == fault["loss"][1]
            and fault["router_grad_max_diff"]
            > AUX_FAULT_MIN_FRACTION * fault["router_grad_max"]):
        raise AssertionError(f"the load-balance term does not reach the "
                             f"router: {fault}")
    summary["aux_fault"] = fault
    del model, start, aux, step

    # (a) MOE_STEPS steps at K = MOE_K and K = 1
    runs = {}
    for k in (MOE_K, 1):
        opt = LocalOptimizer(moe_model(), ds, crit, batch_size=TRAIN_BATCH)
        opt.set_optim_method(Adam(learning_rate=ADAM_LR))
        opt.set_end_when(max_iteration(MOE_STEPS))
        opt.set_precision("bf16_mixed").set_steps_per_sync(k)
        RandomGenerator.set_seed(DROP_SEED)
        reset()
        t0 = time.perf_counter()
        opt.optimize()
        st = opt.train_step.opt_state
        runs[k] = {"seconds": time.perf_counter() - t0,
                   "losses": [h["loss"] for h in opt.history],
                   "params": _snapshot(opt.model.parameters()),
                   "state": _snapshot([*st["m"], *st["v"], st["t"]]),
                   "buffers": _snapshot(opt.model.buffers()),
                   "frac_sums": [float(m.expert_frac.sum())
                                 for m in moes(opt.model)],
                   "aux": [float(m.get_buffer("__bigdl_aux_loss__"))
                           for m in moes(opt.model)],
                   "t": int(st["t"]), "launches": launches(),
                   "window": opt.window,
                   "graphs": opt.window.captures if opt.window else 0}
        del opt, st
    many, one_by_one = runs[MOE_K], runs[1]
    a = {"steps": MOE_STEPS, "k": MOE_K,
         "losses_equal": many["losses"] == one_by_one["losses"],
         "params_equal": _bitwise(many["params"], one_by_one["params"]),
         "m_v_t_equal": _bitwise(many["state"], one_by_one["state"]),
         "moe_buffers_equal": _bitwise(many["buffers"],
                                       one_by_one["buffers"]),
         "t": [many["t"], one_by_one["t"]], "graphs": many["graphs"],
         "shapes": len(many["window"].shapes),
         "loss_first": many["losses"][0], "loss_last": many["losses"][-1],
         "expert_frac_sums": many["frac_sums"], "aux_last": many["aux"],
         "seconds": [many["seconds"], one_by_one["seconds"]],
         "k1_launches": [{n: r["launches"][n] for n in k1}
                         for r in (many, one_by_one)]}
    log("lm-moe", json.dumps(a))
    if not (a["losses_equal"] and a["params_equal"] and a["m_v_t_equal"]
            and a["moe_buffers_equal"]
            and a["t"] == [MOE_STEPS, MOE_STEPS]
            and all(np.isfinite(many["losses"]))
            and a["loss_last"] < a["loss_first"]
            and all(abs(f - 1.0) <= 1e-6 for f in a["expert_frac_sums"])):
        raise AssertionError(f"MoE at K = {MOE_K} against per step: {a}")
    if on_card and a["graphs"] != a["shapes"]:
        raise AssertionError(f"{a['graphs']} graphs for {a['shapes']} "
                             f"window shapes")
    for r, window in ((many, many["window"]), (one_by_one, None)):
        want = LAYERS * _window_calls(window, MOE_STEPS, on_card)
        if any(r["launches"][n] != want for n in k1):
            raise AssertionError(f"K1 called {r['launches']} times, not "
                                 f"{want}")
    moe_launches = {n: many["launches"][n] for n in k1}
    summary["moe_windows"] = a
    del runs, many, one_by_one

    # (a) where the MoE step's time goes: 2 windows of MOE_K, profiled
    if on_card:
        stacked = [_stack([_corpus_batch(corpus, 1 + i * MOE_K + j, device)
                           for j in range(MOE_K)]) for i in range(2)]
        peaks = {}
        for name, build in (("dense", lambda: _train_model(device)),
                            ("moe", moe_model)):
            model = build()
            window = make_host_window(build_train_step(
                model, crit, Adam(learning_rate=ADAM_LR), precision=bf16))
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
            if name == "moe":
                prof, ran = profile_k1_replays(window, stacked,
                                               [ADAM_LR] * MOE_K, device,
                                               "lm-moe-profile")
            else:
                for xs, ys in stacked:
                    window(xs, ys, [ADAM_LR] * MOE_K).tolist()
            peaks[name] = torch.cuda.max_memory_allocated(device)
            window.close()
            del window
        bf16_instances = {n: _has_instance(prof["kernels"], n,
                                           "__nv_bfloat16")
                          for n in K1_KERNELS}
        moe_layer = copy.deepcopy(moes(model)[0]).to(torch.bfloat16)
        ffn_layer = copy.deepcopy(model.block_0.mlp).to(torch.bfloat16)
        h = torch.randn((TRAIN_BATCH, TRAIN_SEQ, HIDDEN), device=device,
                        dtype=torch.bfloat16, requires_grad=True)
        moe_ms = _layer_device_ms(moe_layer, h, device, "lm-moe",
                                  "one MoE layer (4 experts, dense "
                                  "dispatch)")
        ffn_ms = _layer_device_ms(ffn_layer, h, device, "lm-moe",
                                  "one dense FFN layer")
        busy = prof["device_busy_ms"]
        a_prof = {
            "ms_per_step": prof["wall_ms_per_step"],
            "unprofiled_ms_per_step": prof["unprofiled_ms_per_step"],
            "tokens_per_s": slab * 1e3 / prof["wall_ms_per_step"],
            "unprofiled_tokens_per_s": slab * 1e3
            / prof["unprofiled_ms_per_step"],
            "idle_share": prof["device_idle_share"],
            "device_busy_ms_per_step": busy / prof["steps"]
            if isinstance(busy, float) else busy,
            "moe_layer_device_ms": moe_ms, "dense_ffn_device_ms": ffn_ms,
            "moe_layers_extra_device_ms_per_step":
                len(moe_blocks) * (moe_ms - ffn_ms),
            "peak_bytes": peaks["moe"], "dense_peak_bytes": peaks["dense"],
            "peak_rise_bytes": peaks["moe"] - peaks["dense"],
            "k1_kernels_in_profiled_replays": ran,
            "k1_bf16_instances": bf16_instances}
        log("lm-moe", json.dumps(a_prof))
        if not all(bf16_instances.values()):
            raise AssertionError(f"K1's bfloat16 kernels missing from the "
                                 f"MoE step's replays: {bf16_instances}")
        summary["moe_profile"] = a_prof
        del model, moe_layer, ffn_layer, h, stacked

    # (b) dropout in the dense float32 cell
    full_float32()

    def drop_run(k, seed, steps):
        RandomGenerator.set_seed(seed)
        opt = LocalOptimizer(_train_model(device, dropout=DROPOUT), ds,
                             crit, batch_size=TRAIN_BATCH)
        opt.set_optim_method(SGD(learning_rate=TRAIN_LR))
        opt.set_end_when(max_iteration(steps))
        opt.set_steps_per_sync(k)
        reset()
        t0 = time.perf_counter()
        opt.optimize()
        return {"seconds": time.perf_counter() - t0,
                "losses": [h["loss"] for h in opt.history],
                "step_ms": [h["seconds"] * 1e3 for h in opt.history],
                "params": _snapshot(opt.model.parameters()),
                "launches": launches(),
                "graphs": opt.window.captures if opt.window else 0,
                "shapes": len(opt.window.shapes) if opt.window else 0}
    w = drop_run(DROP_K, DROP_SEED, DROP_STEPS)
    p = drop_run(1, DROP_SEED, DROP_STEPS)
    o = drop_run(1, DROP_SEED + 1, DROP_OTHER_STEPS)
    model = _train_model(device, dropout=DROPOUT).evaluate()
    plain = _train_model(device).evaluate()
    plain.load_state_dict(model.state_dict())
    inp = _corpus_batch(corpus, 0, device)[0]
    reset()
    with torch.inference_mode():
        got = model(inp)
    eval_launches = launches()
    with torch.inference_mode():
        want = plain(inp)
    gen = torch.Generator(device=device).manual_seed(DROP_SEED)
    mask = keep_mask((TRAIN_BATCH, HEADS, TRAIN_SEQ, TRAIN_SEQ), DROPOUT,
                     gen)
    sigma = math.sqrt(DROPOUT * (1 - DROPOUT) / mask.numel())
    b = {"steps": DROP_STEPS, "k": DROP_K,
         "losses_equal": w["losses"] == p["losses"],
         "params_equal": _bitwise(w["params"], p["params"]),
         "graphs": w["graphs"], "shapes": w["shapes"],
         "training_k1_launches": [{n: r["launches"][n] for n in k1}
                                  for r in (w, p, o)],
         "other_seed_losses": o["losses"],
         "same_seed_losses": p["losses"][:DROP_OTHER_STEPS],
         "loss_first": p["losses"][0], "loss_last": p["losses"][-1],
         # the last window's wall over its steps (the first holds the
         # capture), and the per-step run's median
         "ms_per_step": {"k8_last_window": w["step_ms"][-1],
                         "k1_median": float(np.median(p["step_ms"]))},
         "seconds": [w["seconds"], p["seconds"]],
         "eval_k1_launches": {n: eval_launches[n] for n in k1},
         "eval_logits_equal_dropout_0": bool(torch.equal(got, want)),
         "keep_fraction": float(mask.float().mean()),
         "keep_fraction_sigma": sigma}
    log("lm-dropout", json.dumps(b))
    if not (b["losses_equal"] and b["params_equal"]
            and all(np.isfinite(p["losses"]))
            and all(r[n] == 0 for r in b["training_k1_launches"]
                    for n in k1)
            and b["other_seed_losses"] != b["same_seed_losses"]
            and b["eval_k1_launches"] == {k1[0]: LAYERS, k1[1]: 0}
            and b["eval_logits_equal_dropout_0"]
            and abs(b["keep_fraction"] - (1 - DROPOUT)) <= 4 * sigma):
        raise AssertionError(f"dropout: {b}")
    if on_card and b["graphs"] != b["shapes"]:
        raise AssertionError(f"{b['graphs']} graphs for {b['shapes']} "
                             f"window shapes")
    summary["dropout"] = b
    del model, plain, got, want, mask, w, p, o

    # (b) every option at once: MoE, dropout and the untied head, 2
    # layers under bf16_mixed Adam, windows of DROP_K against per step
    def all_options_run(k):
        RandomGenerator.set_seed(DROP_SEED)
        opt = LocalOptimizer(
            _train_model(device, layers=2, moe_experts=MOE_EXPERTS,
                         moe_every=MOE_EVERY, dropout=DROPOUT,
                         tie_embeddings=False), ds, crit,
            batch_size=TRAIN_BATCH)
        opt.set_optim_method(Adam(learning_rate=ADAM_LR))
        opt.set_end_when(max_iteration(DROP_K * 2))
        opt.set_precision("bf16_mixed").set_steps_per_sync(k)
        reset()
        opt.optimize()
        return ([h["loss"] for h in opt.history],
                _snapshot([*opt.model.parameters(), *opt.model.buffers()]),
                {n: launches()[n] for n in k1})
    (lw, tw, kw), (lp, tp, kp) = all_options_run(DROP_K), all_options_run(1)
    ab = {"steps": len(lp), "losses_equal": lw == lp,
          "state_equal": _bitwise(tw, tp), "k1_launches": [kw, kp],
          "loss_first": lp[0], "loss_last": lp[-1]}
    log("lm-dropout", f"MoE + dropout + untied head, 2 layers, "
                      f"bf16_mixed Adam, K = {DROP_K} against 1: "
                      f"{json.dumps(ab)}")
    if not (ab["losses_equal"] and ab["state_equal"]
            and all(np.isfinite(lp))
            and all(r[n] == 0 for r in (kw, kp) for n in k1)):
        raise AssertionError(f"every option at once: {ab}")
    summary["all_options"] = ab
    del tw, tp

    # (c) the text CLIs on a seeded corpus
    root = tempfile.mkdtemp(prefix="chip-smoke-lm-")
    try:
        data, ck = os.path.join(root, "ptb"), os.path.join(root, "ck")
        os.makedirs(data)
        _write_ptb(data, seed=62)
        flags = ["--inputMode", "packed", "--moeExperts", str(MOE_EXPERTS),
                 "--dropout", str(DROPOUT), "--device", device] + CLI_WIDTH
        t0 = time.perf_counter()
        trained, out = _run_cli("lm-cli", lm_train.main,
                                ["-f", data, "--checkpoint", ck, "-e", "2"]
                                + flags)
        train_s = time.perf_counter() - t0
        snap = os.path.join(root, "snapshot")
        save_module(snap, trained)
        seq, bs = int(CLI_WIDTH[CLI_WIDTH.index("--seqLen") + 1]), \
            int(CLI_WIDTH[CLI_WIDTH.index("-b") + 1])
        ppl, test_out = _run_cli(
            "lm-cli", lm_test.main,
            ["-f", data, "--model", snap, "--dictionary",
             os.path.join(ck, "dictionary.json"), "--seqLen", str(seq),
             "-b", str(bs), "--device", device])
        # the direct mean NLL over the test CLI's windows, in float64
        d = Dictionary.load(os.path.join(ck, "dictionary.json"))
        stream = [d.get_index(word) for word in
                  read_words(os.path.join(data, "test.txt"))]
        tx, ty = ptb_arrays(stream, bs, seq)

        def direct_perplexity(model):
            total, count = 0.0, 0
            with torch.inference_mode():
                for i in range(0, len(tx) - len(tx) % bs, bs):
                    xb = torch.from_numpy(
                        (tx[i:i + bs] - 1).astype(np.int64)).to(device)
                    yb = torch.from_numpy(
                        (ty[i:i + bs] - 1).astype(np.int64)).to(device)
                    logits = model(xb).double()
                    total += float(F.cross_entropy(
                        logits.reshape(-1, logits.shape[-1]),
                        yb.reshape(-1), reduction="sum"))
                    count += yb.numel()
            return math.exp(total / count), count
        direct, count = direct_perplexity(
            load_module(snap, device=device).evaluate())
        latest = find_latest_checkpoint(ck)
        state = os.path.join(root, "state.pkl")
        with open(state, "wb") as f:
            pickle.dump(load_checkpoint(latest)["optim_host_state"], f)
        resumed, resumed_out = _run_cli(
            "lm-cli", lm_train.main,
            ["-f", data, "--model", snap, "--state", state, "-e", "1"]
            + flags)

        def final_loss(text):
            return float(text.split("final loss:")[1].split()[0])
        c = {"train_seconds": train_s,
             "checkpoints": sorted(os.listdir(ck)),
             "final_loss": final_loss(out),
             "perplexity": ppl, "direct_perplexity": direct,
             "perplexity_rel_diff": abs(ppl - direct) / direct,
             "tokens": count,
             "resumed_final_loss": final_loss(resumed_out),
             # a step's loss is one batch's, under dropout; the
             # held-out perplexity says whether training went on from
             # the snapshot (a fresh model's first epoch is far above)
             "resumed_perplexity": direct_perplexity(
                 resumed.evaluate())[0],
             "resumed_is_moe": isinstance(
                 resumed.get_submodule("block_1.mlp"), MoE),
             "resumed_device": str(next(resumed.parameters()).device)}
        log("lm-cli", json.dumps(c))
        if not ("dictionary.json" in c["checkpoints"]
                and any(n.startswith("checkpoint.")
                        for n in c["checkpoints"])
                and np.isfinite(c["final_loss"])
                and np.isfinite(c["resumed_final_loss"])
                and c["perplexity_rel_diff"] <= CLI_PPL_RTOL
                and c["resumed_is_moe"]
                and c["resumed_device"].startswith(device)
                and c["resumed_perplexity"] < c["direct_perplexity"]):
            raise AssertionError(f"the LM CLIs: {c}")
        summary["cli"] = c
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["k1_launches"] = moe_launches
    return moe_launches, summary


# ---- phase 14: the rest of generation serving (queue 1, item 8) ----

def _p50(values):
    return float(np.percentile(np.asarray(values, np.float64), 50)) \
        if len(values) else float("nan")


def _serve_all(svc, prompts, max_new, **kw):
    """Submit every prompt at once; their token lists, TTFTs and wall
    seconds."""
    t0 = time.perf_counter()
    streams = [svc.generate("lm", p, max_new_tokens=max_new, **kw)
               for p in prompts]
    out = [list(map(int, s.result(timeout=600))) for s in streams]
    return out, [s.ttft_ms for s in streams], time.perf_counter() - t0


def _token_ms(svc):
    return svc.metrics_registry.histogram(
        "serving/generation/token_ms").samples(model="lm")


def _fleet_prefix(counters, model, greedy, device):
    """(a) full-prompt hits at the serving width: ``FLEET_HIT_PROMPTS``
    greedy prompts cold, then again; returns the leg's summary."""
    from bigdl_tpu_torch.generation import GenerationConfig, GenerationService

    svc = GenerationService(config=GenerationConfig(
        slots=SLOTS, max_len=MAX_LEN, prefill_rows=PREFILL_ROWS,
        prefix_cache_bytes=FLEET_PREFIX_BYTES), device=device)
    prompts = greedy[:FLEET_HIT_PROMPTS]
    try:
        svc.load("lm", model)
        # one request first: the decode thread's first call pays its
        # own CUDA set-up (a cuBLAS handle a thread), not a cold prefill
        _serve_all(svc, [np.arange(1, 4, dtype=np.int32)], 2)
        steps0 = svc.metrics("lm")["decode_steps"]
        for fn in counters.values():
            fn.launches = 0
        cold, cold_ttft, _ = _serve_all(svc, prompts, MAX_NEW)
        n_cold = len(_token_ms(svc))
        hit, hit_ttft, _ = _serve_all(svc, prompts, MAX_NEW)
        token_ms = _token_ms(svc)
        launches = {n: fn.launches for n, fn in counters.items()}
        m = svc.metrics("lm")
        with svc.engine._lock:
            keys = [k for ks in svc.engine._keys.values() for k in ks]
    finally:
        svc.shutdown()
    per_rung = {}
    for k in keys:
        per_rung.setdefault(k[-1], set()).add(k[-2])
    steps = int(m["decode_steps"] - steps0)
    out = {"prompts": len(prompts), "prefix_hits": m["prefix_hits"],
           "prefix_misses": m["prefix_misses"],
           "prefix_entries": m["prefix_entries"],
           "ttft_ms_p50_cold": _p50(cold_ttft),
           "ttft_ms_p50_hit": _p50(hit_ttft),
           "token_ms_p50_cold": _p50(token_ms[:n_cold]),
           "token_ms_p50_hit": _p50(token_ms[n_cold:]),
           "programs_per_rung_max": max(map(len, per_rung.values())),
           "decode_steps": steps,
           "ragged_decode_launches": launches["ragged_decode"]}
    log("fleet", "(a) " + json.dumps(out))
    if m["prefix_hits"] != len(prompts) \
            or m["prefix_misses"] != len(prompts) + 1:
        raise AssertionError(f"{m['prefix_hits']} prefix hits and "
                             f"{m['prefix_misses']} misses, want "
                             f"{len(prompts)} and {len(prompts) + 1}")
    bad = [i for i in range(len(prompts)) if hit[i] != cold[i]]
    if bad:
        raise AssertionError(f"hit streams {bad} differ from their cold "
                             f"streams")
    if out["programs_per_rung_max"] > 3:
        raise AssertionError(f"programs per rung: {per_rung}")
    if launches["ragged_decode"] != LAYERS * steps or steps == 0:
        raise AssertionError(f"ragged_decode launched "
                             f"{launches['ragged_decode']} times over "
                             f"{steps} decode steps x {LAYERS} layers")
    return out


def _fleet_partial(device):
    """(b) chunk-boundary partial hits at the long-context configuration
    (chunks of ``LC_CHUNK``): A, then B sharing A's first
    ``FLEET_SHARED`` tokens, which partial-hits A's first-chunk entry
    (the loop stores a prompt's first chunk, as the JAX package's does)
    and prefills 3 chunks; then the shared head H as a request of its
    own (its full entry keys the head), and D sharing the head, which
    partial-hits at ``FLEET_SHARED`` and prefills 1 chunk. B and D
    against a service without the cache."""
    from bigdl_tpu_torch.generation import GenerationConfig, GenerationService

    model = longctx_model(LC_SEQ, device)
    r = np.random.RandomState(45)
    a = r.randint(1, LC_VOCAB, LC_SEQ - LC_NEW).astype(np.int32)
    tail = LC_SEQ - LC_NEW - FLEET_SHARED
    b, d = (np.concatenate([a[:FLEET_SHARED],
                            r.randint(1, LC_VOCAB, tail)]).astype(np.int32)
            for _ in range(2))
    head = a[:FLEET_SHARED]

    def service(prefix_bytes):
        svc = GenerationService(config=GenerationConfig(
            slots=2, max_len=LC_SEQ, prefill_rows=2, prefill_chunk=LC_CHUNK,
            prefix_cache_bytes=prefix_bytes), device=device)
        svc.load("lm", model)
        return svc

    rows = {}
    svc = service(FLEET_PREFIX_BYTES)
    try:
        partial = svc.metrics_registry.counter("fleet/prefix/partial_hits")
        for name, prompt in (("A", a), ("B", b), ("H", head), ("D", d)):
            c0 = svc.metrics("lm")["prefill_chunks"]
            p0 = partial.value(model="lm")
            s = svc.generate("lm", prompt, max_new_tokens=LC_NEW)
            rows[name] = {"tokens": list(map(int, s.result(timeout=600))),
                          "ttft_ms": s.ttft_ms,
                          "prefill_chunks":
                              svc.metrics("lm")["prefill_chunks"] - c0,
                          "partial_hits": partial.value(model="lm") - p0}
        entries = svc.metrics("lm")["prefix_entries"]
    finally:
        svc.shutdown()
    cold = service(0)
    try:
        for name, prompt in (("B", b), ("D", d)):
            s = cold.generate("lm", prompt, max_new_tokens=LC_NEW)
            rows[name]["cold_tokens"] = list(map(int,
                                                 s.result(timeout=600)))
            rows[name]["cold_ttft_ms"] = s.ttft_ms
            rows[name]["cold_prefill_chunks"] = \
                cold.metrics("lm")["prefill_chunks"]
    finally:
        cold.shutdown()
    log("fleet", "(b) " + json.dumps({"entries": entries, "rows": rows}))
    want = {"A": (4, 0), "B": (3, 1), "H": (2, 1), "D": (1, 1)}
    got = {n: (row["prefill_chunks"], row["partial_hits"])
           for n, row in rows.items()}
    if got != want:
        raise AssertionError(f"(prefill chunks, partial hits) {got}, "
                             f"want {want}")
    for name in ("B", "D"):
        if rows[name]["tokens"] != rows[name]["cold_tokens"]:
            raise AssertionError(f"{name}: partial-hit stream "
                                 f"{rows[name]['tokens']} != cold "
                                 f"{rows[name]['cold_tokens']}")
    del model
    return {f"{n}_{k}": rows[n][k] for n in ("B", "D")
            for k in ("ttft_ms", "cold_ttft_ms", "prefill_chunks")}


class _SpecRecorder:
    """Wraps a decoder's engine calls to keep each verify step's active
    mask, the draft's logits of its ``k`` decode steps and the verify
    logits, so every rejection can be logged with its top-2 gaps."""

    def __init__(self, dec):
        self.steps, self._draft = [], []
        self._decode, self._verify = dec.engine.decode, dec.engine.verify
        self._dec = dec
        dec.engine.decode, dec.engine.verify = self.decode, self.verify

    def decode(self, servable, kv, tokens, positions, active):
        out = self._decode(servable, kv, tokens, positions, active)
        if servable is self._dec.draft:
            self._draft.append(out[0])
        return out

    def verify(self, servable, kv, tokens, positions, active):
        out = self._verify(servable, kv, tokens, positions, active)
        k = tokens.shape[1]
        self.steps.append((active.copy(), self._draft[-k:], out[0]))
        return out

    def rejections(self):
        """``[(step, slot, position, verify gap, draft gap)]``: the
        first disagreement of each slot's proposals in each step, with
        each side's logit gap between its own and the other's choice."""
        out = []
        for t, (active, drows, vlog) in enumerate(self.steps):
            for s in np.flatnonzero(active):
                for j, drow in enumerate(drows):
                    d, c = int(np.argmax(drow[s])), int(np.argmax(vlog[s, j]))
                    if d != c:
                        out.append((t, int(s), j,
                                    float(vlog[s, j, c] - vlog[s, j, d]),
                                    float(drow[s][d] - drow[s][c])))
                        break
        return out


def _fleet_speculative(counters, model, greedy, device):
    """(c) speculative decoding: the serving model as the target, a
    ``SPEC_DRAFT_HIDDEN``-wide ``SPEC_DRAFT_LAYERS``-layer draft of its
    own seed (head_dim 32), ``SpeculativeConfig(k=SPEC_K,
    slots=SLOTS, max_len=MAX_LEN)``, the 16 greedy prompts cut to leave
    room for ``MAX_NEW + SPEC_K``; then the target as its own draft.
    Returns the leg's summary and the weak-draft decoder."""
    import torch

    from bigdl_tpu_torch import telemetry
    from bigdl_tpu_torch.fleet import SpeculativeConfig, SpeculativeDecoder
    from bigdl_tpu_torch.generation import (GenerationConfig,
                                            GenerationService,
                                            SamplingParams)
    from bigdl_tpu_torch.models import TransformerLM

    prompts = [p[:MAX_LEN - MAX_NEW - SPEC_K] for p in greedy[:SLOTS]]
    plain = GenerationService(config=GenerationConfig(
        slots=SLOTS, max_len=MAX_LEN, prefill_rows=PREFILL_ROWS),
        device=device)
    try:
        plain.load("lm", model)
        _serve_all(plain, prompts[:1], 2)  # the decode thread's set-up
        want, _, off_s = _serve_all(plain, prompts, MAX_NEW)
    finally:
        plain.shutdown()
    draft = TransformerLM(vocab_size=VOCAB, hidden_size=SPEC_DRAFT_HIDDEN,
                          num_layers=SPEC_DRAFT_LAYERS, num_heads=HEADS,
                          max_len=MAX_LEN, device=device,
                          generator=torch.Generator().manual_seed(
                              SPEC_DRAFT_SEED)).eval()
    cfg = SpeculativeConfig(k=SPEC_K, slots=SLOTS, max_len=MAX_LEN,
                            prefill_rows=PREFILL_ROWS)
    dec = SpeculativeDecoder(model, draft, cfg,
                             metrics=telemetry.MetricsRegistry(),
                             device=device)
    dec.generate(prompts[:2], max_new_tokens=2)  # builds the programs
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs, stats = dec.generate(prompts, max_new_tokens=MAX_NEW)
    on_s = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    got = [list(map(int, o)) for o in outs]
    sp = SamplingParams(temperature=TEMPERATURE, top_k=TOP_K, seed=7)
    sampled = [[list(map(int, o)) for o in dec.generate(
        prompts, max_new_tokens=MAX_NEW, sampling=sp)[0]]
        for _ in range(2)]
    with dec.engine._lock:
        keys = {sv: list(ks) for sv, ks in dec.engine._keys.items()}
    kinds = {}
    for sv, ks in keys.items():
        for k in ks:
            kinds.setdefault((sv, k[-1]), set()).add(k[-2])
    over = {f"{sv}@{b}": sorted(v) for (sv, b), v in kinds.items()
            if len(v) > (3 if sv == dec.target.key else 2)}
    same = SpeculativeDecoder(model, model, cfg,
                              metrics=telemetry.MetricsRegistry(),
                              device=device)
    rec = _SpecRecorder(same)
    _, self_stats = same.generate(prompts, max_new_tokens=MAX_NEW)
    rejections = rec.rejections()
    tokens = sum(map(len, got))
    out = {"prompts": len(prompts), "k": SPEC_K,
           "accept_rate": stats["accept_rate"],
           "macro_steps": stats["macro_steps"],
           "tokens_per_sec_on": tokens / on_s,
           "tokens_per_sec_off": sum(map(len, want)) / off_s,
           "self_draft_accept_rate": self_stats["accept_rate"],
           "self_draft_rejections": len(rejections),
           "programs_target": dec.engine.compile_count(dec.target),
           "programs_draft": dec.engine.compile_count(dec.draft),
           "ragged_decode_launches": launches["ragged_decode"]}
    log("fleet", "(c) " + json.dumps(out))
    for t, s, j, vgap, dgap in rejections:
        log("fleet", f"(c) self-draft rejection: verify step {t}, slot "
                     f"{s}, position {j}: verify top-2 gap {vgap:.3e}, "
                     f"draft top-2 gap {dgap:.3e}")
    bad = [i for i in range(len(prompts)) if got[i] != want[i]]
    if bad:
        raise AssertionError(f"speculative streams {bad} differ from the "
                             f"target-only streams")
    if sampled[0] != sampled[1]:
        raise AssertionError("seeded speculative sampling is not "
                             "repeatable")
    if over:
        raise AssertionError(f"program kinds over the bound: {over}")
    draft_steps = stats["macro_steps"] * SPEC_K
    if launches["ragged_decode"] != SPEC_DRAFT_LAYERS * draft_steps:
        raise AssertionError(f"ragged_decode launched "
                             f"{launches['ragged_decode']} times over "
                             f"{draft_steps} draft decode steps x "
                             f"{SPEC_DRAFT_LAYERS} layers")
    if not self_stats["accept_rate"] >= SPEC_SELF_ACCEPT:
        raise AssertionError(f"self-draft accept rate "
                             f"{self_stats['accept_rate']}")
    wide = [r for r in rejections if r[3] > SPEC_TIE_GAP]
    if wide:
        raise AssertionError(f"self-draft rejections past a near-tie "
                             f"({SPEC_TIE_GAP}): {wide}")
    return out, dec


def _fleet_router(model_args, device):
    """(e) replicas behind the router: a seeded burst through one and
    two replicas; a stream held on r0 when r0 dies, rerouted; a process
    replica against its thread twin. Returns the summary and the
    2-replica router (still serving)."""
    from bigdl_tpu_torch import faults, telemetry
    from bigdl_tpu_torch.fleet import FleetRouter, ProcessReplica, build_replicas
    from bigdl_tpu_torch.serving import WorkerDied

    metrics = telemetry.MetricsRegistry()
    reps = build_replicas(2, slots=SLOTS, max_len=MAX_LEN, max_queue=64,
                          metrics=metrics, device=device, **model_args)
    r = np.random.RandomState(46)
    burst = [r.randint(1, VOCAB, MAX_LEN // 4).astype(np.int32)
             for _ in range(ROUTER_REQUESTS)]
    for rep in reps:  # each decode thread's CUDA set-up
        rep.submit(burst[0], max_new_tokens=2).result(timeout=600)

    def run_burst(router):
        t0 = time.perf_counter()
        streams = [router.submit(p, max_new_tokens=ROUTER_NEW)
                   for p in burst]
        toks = sum(len(s.result(timeout=600)) for s in streams)
        return toks / (time.perf_counter() - t0), sorted(
            {s._replica.name for s in streams})

    out = {}
    for n in (1, 2):
        router = FleetRouter(reps[:n], metrics=metrics)
        out[f"tokens_per_sec_{n}_replica"], out[f"placed_{n}_replica"] = \
            run_burst(router)
    # the same 2-replica burst with a 0.2 ms interpreter switch interval:
    # a probe of how much the decode threads wait on each other for the
    # interpreter lock (5 ms by default)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(2e-4)
    try:
        out["tokens_per_sec_2_replica_switch_0.2ms"], _ = run_burst(router)
    finally:
        sys.setswitchinterval(interval)
    prompt = burst[0]
    ref = list(map(int, router.submit(prompt, max_new_tokens=ROUTER_NEW)
                   .result(timeout=600)))
    with faults.armed("serving/decode=delay:25,times:1000000"):
        router._sessions["held"] = "r0"
        held = router.submit(prompt, session="held",
                             max_new_tokens=ROUTER_NEW)
        held.first(timeout=600)
        reps[0].kill()
        rerouted = list(map(int, held.result(timeout=600)))
    out["rerouted_to"] = held._replica.name
    out["router"] = router.metrics()
    if rerouted != ref or held._replica.name != "r1":
        raise AssertionError(f"rerouted stream {rerouted} on "
                             f"{held._replica.name} != {ref}")
    if (out["router"]["evictions"], out["router"]["reroutes"]) != (1, 1):
        raise AssertionError(f"router metrics {out['router']}")

    spec = dict(seed=11, vocab_size=model_args["vocab"],
                hidden_size=model_args["hidden"],
                num_layers=model_args["layers"],
                num_heads=model_args["heads"], max_len=MAX_LEN)
    twin = build_replicas(1, slots=2, max_len=MAX_LEN, metrics=metrics,
                          device=device, **model_args)[0]
    t0 = time.perf_counter()
    proc = ProcessReplica("p0", spec, slots=2, max_len=MAX_LEN,
                          device=device)
    out["process_replica_start_s"] = time.perf_counter() - t0
    try:
        want = list(map(int, twin.submit(prompt, max_new_tokens=ROUTER_NEW)
                        .result(timeout=600)))
        got = list(map(int, proc.submit(prompt, max_new_tokens=ROUTER_NEW)
                       .result(timeout=600)))
        if got != want:
            raise AssertionError(f"process replica {got} != thread twin "
                                 f"{want}")
        # as many new tokens as the cache holds: the kill lands long
        # before the stream could finish
        doomed = proc.submit(prompt, max_new_tokens=MAX_LEN - len(prompt)
                             - 1)
        proc.kill()
        try:
            doomed.result(timeout=60)
            raise AssertionError("a killed process replica's stream "
                                 "finished")
        except WorkerDied:
            pass
        try:
            proc.submit(prompt, max_new_tokens=2)
            raise AssertionError("a killed process replica took a request")
        except WorkerDied:
            pass
    finally:
        twin.shutdown()
        proc.shutdown(drain=False)
    log("fleet", "(e) " + json.dumps(out))
    return out, router


def phase_fleet(counters, greedy, device="cuda"):
    """The rest of generation serving (queue 1, item 8) on ``device``:
    (a) full-prompt prefix hits, (b) chunk-boundary partial hits at the
    long-context configuration, (c) speculative decoding, (d) the fault
    points ``fleet/verify``, ``serving/decode`` and ``fleet/route``,
    (e) replicas behind the router (module docstring, phase 14). Returns
    the summary."""
    import torch

    from bigdl_tpu_torch import faults, telemetry
    from bigdl_tpu_torch.generation import GenerationConfig, GenerationService
    from bigdl_tpu_torch.models import TransformerLM
    from bigdl_tpu_torch.serving import WorkerDied

    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    # the serving model's weights (seed 11; build_replicas and the
    # process worker take the default FFN width, 4 x hidden = FFN)
    model_args = dict(vocab=VOCAB, hidden=HIDDEN, layers=LAYERS,
                      heads=HEADS, seed=11)
    model = TransformerLM(vocab_size=VOCAB, hidden_size=HIDDEN,
                          num_layers=LAYERS, num_heads=HEADS, ffn_size=FFN,
                          max_len=MAX_LEN, device=device,
                          generator=torch.Generator().manual_seed(11)).eval()
    summary = {"prefix": _fleet_prefix(counters, model, greedy, device),
               "partial": _fleet_partial(device)}
    summary["speculative"], dec = _fleet_speculative(counters, model,
                                                     greedy, device)
    summary["router"], router = _fleet_router(model_args, device)

    # (d) fault points: each fires once and surfaces typed
    injected = telemetry.counter("faults/point/injected")
    before = injected.total()
    fires = 0
    prompts = [p[:MAX_LEN - MAX_NEW - SPEC_K] for p in greedy[:4]]
    with faults.armed("fleet/verify=nth:1,raise:RuntimeError") as sched:
        try:
            dec.generate(prompts, max_new_tokens=MAX_NEW)
            raise AssertionError("fleet/verify fault did not raise")
        except RuntimeError as e:
            if "injected fault" not in str(e):
                raise
    fires += sched.total_fired()
    outs, _ = dec.generate(prompts, max_new_tokens=MAX_NEW)
    if [len(o) for o in outs] != [MAX_NEW] * len(prompts):
        raise AssertionError("the generate after a verify fault was cut")
    svc = GenerationService(config=GenerationConfig(
        slots=SLOTS, max_len=MAX_LEN, prefill_rows=PREFILL_ROWS),
        device=device)
    try:
        svc.load("lm", model)
        want, _, _ = _serve_all(svc, prompts, MAX_NEW)
        with faults.armed("serving/decode=nth:3,raise:RuntimeError") as sched:
            streams = [svc.generate("lm", p, max_new_tokens=MAX_NEW)
                       for p in prompts]
            died = 0
            for s in streams:
                try:
                    s.result(timeout=600)
                except WorkerDied:
                    died += 1
        fires += sched.total_fired()
        again, _, _ = _serve_all(svc, prompts, MAX_NEW)
        restarts = svc.metrics("lm")["worker_restarts"]
    finally:
        svc.shutdown()
    if died != len(prompts) or restarts != 1 or again != want:
        raise AssertionError(f"serving/decode: {died} streams died of "
                             f"{len(prompts)}, {restarts} restarts, "
                             f"served again equal: {again == want}")
    with faults.armed("fleet/route=nth:1,raise:OSError") as sched:
        try:
            router.submit(prompts[0], max_new_tokens=2)
            raise AssertionError("fleet/route fault did not raise")
        except OSError as e:
            if "injected fault" not in str(e):
                raise
    fires += sched.total_fired()
    router.shutdown()
    counted = injected.total() - before
    summary["faults"] = {"fires": fires, "injected_counter": counted,
                         "decode_streams_died": died,
                         "worker_restarts": restarts}
    log("fleet", "(d) " + json.dumps(summary["faults"]))
    if fires != 3 or counted != 3:
        raise AssertionError(f"{fires} faults fired, {counted} counted; "
                             f"want 3")
    summary["wall_s"] = time.perf_counter() - t_phase
    summary["max_memory_allocated"] = \
        torch.cuda.max_memory_allocated() if on_card else "not measured"
    log("fleet", f"phase wall {summary['wall_s']:.1f} s, "
                 f"max_memory_allocated {summary['max_memory_allocated']}")
    return summary


# ---- the image zoo ----

def _zoo_model(name, device, dtype=None, seed=ZOO_SEED, **kw):
    """A zoo model of the port (1000 classes) from ``seed`` on
    ``device``, in ``dtype`` if given."""
    import torch

    from bigdl_tpu_torch import models

    model = getattr(models, name)(1000, device=device,
                                  generator=torch.Generator().manual_seed(
                                      seed), **kw)
    return model if dtype is None else model.to(dtype)


def _zoo_step(name, side, device, fault=False):
    """One SGD step (lr 0.01, momentum 0.9, weight decay 5e-4) of
    ``name`` in float64 on ``device`` at batch ``ZOO_PARITY_BATCH`` of
    mean-subtracted pixel rows, dropout off (``p = 0``); ``fault`` adds
    ``ZOO_LRN_FAULT`` to the first cross-map LRN's beta. Returns the
    loss and the parameters."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.optim import SGD, build_train_step

    model = _zoo_model(name, device, torch.float64)
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.set_p(0.0)
    step = build_train_step(model, nn.ClassNLLCriterion(), SGD(
        learning_rate=0.01, momentum=0.9, weight_decay=5e-4))
    if fault:
        lrn = next(m for m in model.modules()
                   if isinstance(m, nn.SpatialCrossMapLRN))
        lrn.beta += ZOO_LRN_FAULT
    r = np.random.RandomState(ZOO_ROWS_SEED)
    x = r.rand(ZOO_PARITY_BATCH, 3, side, side) * 255.0 - 128.0
    y = r.randint(1, 1001, ZOO_PARITY_BATCH).astype(np.float64)
    loss = float(step(torch.from_numpy(x).to(device, torch.float64),
                      torch.from_numpy(y).to(device), 0.01))
    return loss, model.get_parameters()


def _zoo_gap(want, got):
    """(relative loss difference, largest absolute parameter
    difference) of two ``_zoo_step`` results."""
    return (abs(got[0] - want[0]) / abs(want[0]),
            _max_param_diff(got[1], want[1]))


def _zoo_parity(device):
    """(a): each model's float64 step on the card against the CPU, and
    Inception v1's with the LRN fault, which must fail the check."""
    out = {}
    for name, side in ZOO_PARITY:
        cpu = _zoo_step(name, side, "cpu")
        gap = _zoo_gap(cpu, _zoo_step(name, side, device))
        out[name] = {"loss_rel": gap[0], "param_abs": gap[1],
                     "loss": cpu[0]}
        if name.startswith("Inception_v1"):
            fault = _zoo_gap(cpu, _zoo_step(name, side, device, fault=True))
            out["lrn_fault"] = {"loss_rel": fault[0], "param_abs": fault[1]}
        log("zoo", f"(a) {name}: " + json.dumps(out[name]))
    log("zoo", "(a) LRN beta fault: " + json.dumps(out["lrn_fault"]))
    bad = {k: v for k, v in out.items() if k != "lrn_fault" and not (
        v["loss_rel"] <= ZOO_F64_TOL and v["param_abs"] <= ZOO_F64_TOL)}
    if bad:
        raise AssertionError(f"zoo card vs CPU in float64: {bad}")
    f = out["lrn_fault"]
    if f["loss_rel"] <= ZOO_F64_TOL and f["param_abs"] <= ZOO_F64_TOL:
        raise AssertionError(f"the LRN beta fault passed the card-vs-CPU "
                             f"check: {f}")
    return out


def _device_union_ms(prof) -> float:
    """The device's busy time in a ``torch.profiler`` window: the union of
    its kernels' and copies' intervals (kernels of cuDNN's side streams
    overlap, so their summed durations can pass the wall time)."""
    from torch.autograd import DeviceType

    spans = sorted((ev.time_range.start, ev.time_range.end)
                   for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _zoo_perf(device):
    """(b): ``tools.perf`` at full width, float32 and bf16_mixed, through
    its own ``parse_args`` / ``prepare`` / ``measure`` (what its ``main``
    runs): the median, images/s, the analytic TFLOP/s and the peak
    memory of its timed iterations, then a profiled window of the same
    iteration for the idle share (1 - the union of the device's busy
    intervals over the wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.tools import perf
    from bigdl_tpu_torch.utils import engine

    on_card = device == "cuda"
    rows = []
    for model, batch in ZOO_PERF:
        for prec in (["--dtype", "f32"], ["--precision", "bf16_mixed"]):
            args = perf.parse_args([
                "--model", model, "--batch-size", str(batch), "--warmup",
                str(ZOO_PERF_WARMUP), "--iterations", str(ZOO_PERF_ITERS),
                "--device", device] + prec)
            saved = engine.compute_dtype()
            if args.precision is None:
                engine.set_compute_dtype(torch.float32)
            try:
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                runner = perf.prepare(args)
                tail, _ = _run_cli("zoo-perf",
                                   lambda _: perf.measure(runner, args), [])
                peak = torch.cuda.max_memory_allocated() if on_card \
                    else "not measured"
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if on_card else [])
                with profile(activities=acts) as prof:
                    time.sleep(WINDOW_MARGIN_S)
                    t0 = time.perf_counter()
                    for _ in range(ZOO_PERF_PROFILE):
                        out = runner.run()
                    float(out.float().sum())
                    wall_ms = (time.perf_counter() - t0) * 1e3
                    time.sleep(WINDOW_MARGIN_S)
            finally:
                engine.set_compute_dtype(saved)
            kernels = device_kernels(prof)
            busy = _device_union_ms(prof)
            read = bool(kernels) and busy <= wall_ms
            row = {"model": model, "batch": batch, "dtype": tail["dtype"],
                   "ms_per_step": tail["median_s"] * 1e3,
                   "images_per_s": tail["rate"],
                   "tflops_analytic": tail["achieved_tflops"],
                   "gflop_per_step": tail["flops_per_iteration"] / 1e9,
                   "max_memory_allocated": peak,
                   "profiled_ms_per_step": wall_ms / ZOO_PERF_PROFILE,
                   "device_busy_ms_per_step": busy / ZOO_PERF_PROFILE
                   if read else "not measured",
                   "kernel_ms_per_step_summed":
                       sum(k[0] for k in kernels) / ZOO_PERF_PROFILE,
                   "idle_share": (1 - busy / wall_ms) if read
                   else "not measured",
                   "top": [[ms, n, key[:70]] for ms, n, key in kernels[:4]]}
            log("zoo", "(b) " + json.dumps(row))
            rows.append(row)
            del runner, out
            if on_card:
                torch.cuda.empty_cache()
    return rows


class _Recorded:
    """Records the LocalOptimizers a recipe's main builds (their
    ``history`` holds the losses)."""

    def __init__(self):
        self.opts = []

    @contextlib.contextmanager
    def patched(self):
        from bigdl_tpu_torch import optim

        base = optim.LocalOptimizer
        record = self.opts

        class Recorded(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                record.append(self)

        optim.LocalOptimizer = Recorded
        try:
            yield self
        finally:
            optim.LocalOptimizer = base


def _falls(losses) -> bool:
    n = max(1, len(losses) // 4)
    return float(np.mean(losses[-n:])) < float(np.mean(losses[:n]))


def _zoo_dropout(device):
    """(c): Inception v1 (no aux heads; Dropout(0.4) in its top
    Sequential) at batch ``ZOO_DROP_BATCH``: K = 8 windows bitwise the
    per-step run, another seed other losses."""
    import torch

    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models._cli import arrays_to_dataset
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, max_iteration
    from bigdl_tpu_torch.tools.synthetic import image_batch
    from bigdl_tpu_torch.utils.random import RandomGenerator

    imgs, lbls = image_batch(ZOO_DROP_BATCH * ZOO_DROP_K, (3, 224, 224),
                             1000, seed=ZOO_DROP_SEED)

    def run(k, seed, steps):
        RandomGenerator.set_seed(seed)
        # a dataset of its own: a run's epochs advance its shuffle
        opt = LocalOptimizer(
            _zoo_model("Inception_v1_NoAuxClassifier", device),
            arrays_to_dataset(imgs, lbls, ZOO_DROP_BATCH),
            nn.ClassNLLCriterion(), batch_size=ZOO_DROP_BATCH)
        opt.set_optim_method(SGD(learning_rate=0.01, momentum=0.9))
        opt.set_end_when(max_iteration(steps))
        opt.set_steps_per_sync(k)
        t0 = time.perf_counter()
        opt.optimize()
        return {"seconds": time.perf_counter() - t0,
                "losses": [h["loss"] for h in opt.history],
                "params": _snapshot(opt.model.parameters()),
                "generator": opt.train_step.generator is not None,
                "graphs": opt.window.captures if opt.window else 0}

    deterministic = torch.backends.cudnn.deterministic
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        w = run(ZOO_DROP_K, ZOO_DROP_SEED, ZOO_DROP_STEPS)
        p = run(1, ZOO_DROP_SEED, ZOO_DROP_STEPS)
        o = run(1, ZOO_DROP_SEED + 1, ZOO_DROP_OTHER_STEPS)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        torch.backends.cudnn.benchmark = benchmark
    out = {"steps": ZOO_DROP_STEPS, "k": ZOO_DROP_K,
           "losses_equal": w["losses"] == p["losses"],
           "params_equal": _bitwise(w["params"], p["params"]),
           "generator": w["generator"] and p["generator"],
           "graphs": w["graphs"], "losses": p["losses"],
           "other_seed_losses": o["losses"],
           "seconds_k8": w["seconds"], "seconds_k1": p["seconds"]}
    log("zoo", "(c) " + json.dumps(out))
    if not (out["losses_equal"] and out["params_equal"]
            and out["generator"]):
        raise AssertionError(f"dropout through containers: K = "
                             f"{ZOO_DROP_K} is not bitwise K = 1: {out}")
    if device == "cuda" and w["graphs"] < 1:
        raise AssertionError("the K = 8 run captured no CUDA graph")
    if o["losses"] == p["losses"][:ZOO_DROP_OTHER_STEPS]:
        raise AssertionError("another seed drew the same dropout masks")
    if not all(math.isfinite(v) for v in p["losses"]):
        raise AssertionError(f"non-finite losses: {p['losses']}")
    return out


def _write_separable_cifar(folder: str, n_train: int, n_test: int,
                           seed: int) -> None:
    """A seeded 10-class task in CIFAR-10's binary format under
    ``folder`` (``data_batch_1..5.bin``, ``test_batch.bin``): pixels
    uniform in [100, 156) with an 8 x 6 patch of 255 at the class's own
    place on a 2 x 5 grid, in every channel. Random labels (what
    ``--synthetic`` draws) leave nothing to learn in a few steps; on
    this task VggForCifar10's training loss falls within an epoch (its
    evaluation-mode Top1 lags: ``ZOO_VGG_LEARN``)."""
    import os

    r = np.random.RandomState(seed)

    def records(n):
        y = r.randint(0, 10, n)
        x = r.randint(100, 156, (n, 3, 32, 32)).astype(np.uint8)
        for c in range(10):
            top, left = 4 + (c // 5) * 14, 1 + (c % 5) * 6
            x[y == c, :, top:top + 8, left:left + 6] = 255
        return np.concatenate([y.astype(np.uint8)[:, None],
                               x.reshape(n, -1)], axis=1).tobytes()

    per = -(-n_train // 5)
    for i in range(5):
        with open(os.path.join(folder, f"data_batch_{i + 1}.bin"),
                  "wb") as f:
            f.write(records(min(per, n_train - i * per)))
    with open(os.path.join(folder, "test_batch.bin"), "wb") as f:
        f.write(records(n_test))


def _bn_reestimated_top1(model, folder: str, bs: int, device) -> float:
    """Held-out Top1 of the trained ``model`` in evaluation mode after
    each BN layer's running statistics are re-estimated as the mean of
    its batch statistics over the training rows (the layer's own update
    at momentum ``1 / (k + 1)`` for batch k), the weights untouched: a
    fault in the evaluation path scores low here, statistics that only
    trail the weights do not."""
    import torch

    from bigdl_tpu_torch.models._cli import cifar10_arrays
    from bigdl_tpu_torch.nn import BatchNormalization

    bns = [m for m in model.modules() if isinstance(m, BatchNormalization)]
    kept = [b.momentum for b in bns]
    model.evaluate()
    for b in bns:
        b.train()
    x, _ = cifar10_arrays(folder, True)
    with torch.inference_mode():
        for k, i in enumerate(range(0, len(x), bs)):
            for b in bns:
                b.momentum = 1.0 / (k + 1)
            model(torch.from_numpy(x[i:i + bs]).to(device))
        for b, m in zip(bns, kept):
            b.momentum = m
        model.evaluate()
        x, y = cifar10_arrays(folder, False)
        hits = sum(int((model(torch.from_numpy(x[i:i + bs]).to(device))
                        .argmax(1).cpu() == torch.from_numpy(
                            y[i:i + bs]).long() - 1).sum())
                   for i in range(0, len(x), bs))
    return hits / len(x)


def _zoo_recipes(device):
    """(d): vgg.train (dropout, BN) as a ``--synthetic`` run with a
    checkpoint an epoch (random labels: the losses are reported, not
    gated) and on a learnable CIFAR-format folder (the losses must fall,
    and the held-out Top1 with BN's statistics re-estimated pass
    ``ZOO_VGG_MIN_TOP1``); vgg.test on each saved trained module must
    score its last validation's Top1; inception.train;
    autoencoder.train (its MSE falls)."""
    import os
    import shutil
    import tempfile

    from bigdl_tpu_torch.models.autoencoder import train as ae_train
    from bigdl_tpu_torch.models.inception import train as inception_train
    from bigdl_tpu_torch.models.vgg import test as vgg_test
    from bigdl_tpu_torch.models.vgg import train as vgg_train
    from bigdl_tpu_torch.utils.serialization import save_module

    out = {}
    root = tempfile.mkdtemp(prefix="zoo-")
    try:
        data = os.path.join(root, "cifar")
        os.makedirs(data)
        _write_separable_cifar(data, ZOO_VGG_LEARN[0], ZOO_VGG_LEARN[0],
                               ZOO_SEED)
        for label, source, (rows, bs, epochs) in (
                ("synthetic", ["--synthetic", str(ZOO_VGG_RECIPE[0])],
                 ZOO_VGG_RECIPE),
                ("separable", ["-f", data], ZOO_VGG_LEARN)):
            ck = os.path.join(root, f"vgg-{label}")
            flags = ["--checkpoint", ck] if label == "synthetic" else []
            with _Recorded().patched() as rec:
                t0 = time.perf_counter()
                model, _ = _run_cli("zoo-vgg", vgg_train.main, source + [
                    "-b", str(bs), "-e", str(epochs), "--device",
                    device] + flags)
                seconds = time.perf_counter() - t0
            opt = rec.opts[-1]
            losses = [h["loss"] for h in opt.history]
            saved = os.path.join(root, f"vgg-module-{label}")
            save_module(saved, model.evaluate())
            scores, _ = _run_cli("zoo-vgg", vgg_test.main, source + [
                "-b", str(bs), "--model", saved, "--device", device])
            out[f"vgg_{label}"] = {
                "steps": len(losses), "loss_first": losses[0],
                "loss_last": losses[-1], "falls": _falls(losses),
                "finite": all(math.isfinite(v) for v in losses),
                "checkpoints": sorted(os.listdir(ck)) if flags else [],
                "validation": opt.validation_history[-1],
                "test_top1": scores["Top1Accuracy"].result()[0],
                "seconds": seconds}
            if label == "separable":
                out["vgg_separable"]["top1_bn_reestimated"] = \
                    _bn_reestimated_top1(model, data, bs, device)
        rows, bs, epochs = ZOO_INCEPTION_RECIPE
        with _Recorded().patched() as rec:
            _run_cli("zoo-inception", inception_train.main, [
                "--synthetic", str(rows), "-b", str(bs), "-e", str(epochs),
                "--device", device])
        losses = [h["loss"] for h in rec.opts[-1].history]
        out["inception"] = {"steps": len(losses), "losses": losses}
        rows, bs, epochs = ZOO_AE_RECIPE
        with _Recorded().patched() as rec:
            _run_cli("zoo-autoencoder", ae_train.main, [
                "--synthetic", str(rows), "-b", str(bs), "-e", str(epochs),
                "--device", device])
        losses = [h["loss"] for h in rec.opts[-1].history]
        out["autoencoder"] = {"steps": len(losses), "loss_first": losses[0],
                              "loss_last": losses[-1],
                              "falls": _falls(losses)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("zoo", "(d) " + json.dumps(out))
    for label in ("synthetic", "separable"):
        v = out[f"vgg_{label}"]
        held = v["finite"] and (
            v["test_top1"] == v["validation"]["Top1Accuracy"])
        if label == "synthetic":
            held = held and len(v["checkpoints"]) == ZOO_VGG_RECIPE[2]
        else:
            held = held and v["falls"] and (
                v["top1_bn_reestimated"] > ZOO_VGG_MIN_TOP1)
        if not held:
            raise AssertionError(f"vgg.train ({label}): {v}")
    if not all(math.isfinite(x) for x in out["inception"]["losses"]):
        raise AssertionError(f"inception.train: {out['inception']}")
    if not out["autoencoder"]["falls"]:
        raise AssertionError(f"autoencoder.train: the MSE did not fall: "
                             f"{out['autoencoder']}")
    return out


def _flip_byte(w, j: int):
    """A copy of int8 ``w`` with the byte at ``[0, j]`` flipped."""
    import torch

    out = w.clone()
    out[0, j] = (out[0, j].view(torch.uint8) ^ 0x40).view(torch.int8)
    return out


def _zoo_int8(counters, k5_rows, device):
    """(e): int8 VGG-16 at batch ``ZOO_INT8_BATCH`` — the main path: the
    counts are set to 0, ``ZOO_INT8_FORWARDS`` int8 forwards run, K5
    must have launched 3 a forward; the profiler counts one forward's
    K5 kernels; each recorded call bitwise the plain version, a flipped
    weight byte not; logits with K5 bitwise those with the kernels off,
    a flipped fc8 byte not. ``k5_rows`` (by fc: phase 3's timed rows at
    these shapes) get this run's launches and errors. Returns the
    kernels-line rows and the numbers."""
    import sys as _sys

    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch import kernels
    from bigdl_tpu_torch.nn.quantized import QuantizedLinear, quantize
    from bigdl_tpu_torch.tools.synthetic import image_batch

    k5 = _sys.modules["bigdl_tpu_torch.kernels.int8_gemm"]
    gemm, reference = k5.int8_gemm, k5.int8_gemm_reference
    model = _zoo_model("Vgg_16", device).evaluate()
    q = quantize(model)
    x = torch.from_numpy(image_batch(ZOO_INT8_BATCH, (3, 224, 224), 1000,
                                     seed=ZOO_SEED)[0]).to(device)
    # the dispatch's operands, recorded where QuantizedLinear calls it
    # (K5's own name stays: its wrapper counts through it)
    dispatch = kernels.int8_matmul
    calls = []

    def recording(x_q, w_q, x_scale, w_scale, bias=None):
        calls.append((x_q, w_q, x_scale, w_scale))
        return dispatch(x_q, w_q, x_scale, w_scale, bias)

    kernels.int8_matmul = recording
    try:
        with torch.inference_mode():
            float(q(x).sum())                      # warm
            calls.clear()
            for fn in counters.values():
                fn.launches = 0
            for _ in range(ZOO_INT8_FORWARDS):
                logits = q(x)
            torch.cuda.synchronize() if device == "cuda" else None
            launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        kernels.int8_matmul = dispatch
    shapes = [(a[0].shape[0], a[1].shape[0], a[0].shape[1]) for a in calls]
    per_shape = {fc: shapes.count(s) for fc, s in ZOO_FC_SHAPES.items()}
    out = {"launches": launches, "calls_by_shape": per_shape,
           "forwards": ZOO_INT8_FORWARDS}
    on_card = device == "cuda"
    if on_card and launches["int8_gemm"] != 3 * ZOO_INT8_FORWARDS:
        raise AssertionError(f"K5 launched {launches['int8_gemm']} times "
                             f"in {ZOO_INT8_FORWARDS} int8 forwards")
    if any(n != ZOO_INT8_FORWARDS for n in per_shape.values()):
        raise AssertionError(f"K5 calls by shape: {per_shape}")
    others = {n: v for n, v in launches.items() if n != "int8_gemm" and v}
    if others:
        raise AssertionError(f"int8 VGG-16 launched {others}")

    # the profiler's count of one forward's K5 kernels
    if on_card:
        for attempt in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(WINDOW_MARGIN_S)
                with torch.inference_mode():
                    float(q(x).sum())
                torch.cuda.synchronize()
                time.sleep(WINDOW_MARGIN_S)
            found = {key: n for _, n, key in device_kernels(prof)
                     if "int8_gemm_kernel" in key
                     or "int8_splitk_reduce" in key}
            gemms = sum(n for key, n in found.items()
                        if "int8_gemm_kernel" in key)
            if gemms >= 3:
                break
        out["profiled_k5_kernels"] = {k[:80]: n for k, n in found.items()}
        out["profiled_k5_gemms"] = gemms
        if gemms != 3:
            raise AssertionError(f"the profiler counted {gemms} K5 GEMM "
                                 f"kernels in one int8 forward: {found}")

    # each recorded call's operands: the kernel bitwise its plain version
    by_fc = {}
    for fc, shape in ZOO_FC_SHAPES.items():
        args = calls[shapes.index(shape)]
        got, want = gemm(*args), reference(*args)
        j = int(args[0][0].abs().argmax())
        flipped = gemm(args[0], _flip_byte(args[1], j), *args[2:])
        if on_card:
            torch.cuda.synchronize()
        by_fc[fc] = {"bitwise": bool(torch.equal(got, want)),
                     "flipped_byte_differs": not torch.equal(flipped, want),
                     "max_abs_err": float((got - want).abs().max())}
    out["bitwise"] = by_fc
    if not all(v["bitwise"] and v["flipped_byte_differs"]
               for v in by_fc.values()):
        raise AssertionError(f"K5 at VGG-16's classifier: {by_fc}")

    # int8 on == off, a flipped fc8 byte not; int8 against float top-1
    with torch.inference_mode():
        on = q(x)
        with kernels.use(kernels.KernelConfig.off()):
            off = q(x)
        # the byte meets row 0's largest input to fc8 (an fc6 or fc7
        # byte may feed a unit the Threshold then zeroes)
        fc8 = [m for m in q.modules() if isinstance(m, QuantizedLinear)][-1]
        j = int(calls[shapes.index(ZOO_FC_SHAPES["fc8"])][0][0].abs()
                .argmax())
        kept = fc8.weight_q.clone()
        fc8.weight_q.copy_(_flip_byte(kept, j))
        faulty = q(x)
        fc8.weight_q.copy_(kept)
        agree = float((model(x).argmax(1) == on.argmax(1)).float().mean())
    out["on_equals_off"] = bool(torch.equal(on, off))
    out["flipped_fc8_byte_differs"] = not torch.equal(faulty, off)
    out["top1_agreement_int8_vs_float"] = agree
    if not (out["on_equals_off"] and out["flipped_fc8_byte_differs"]):
        raise AssertionError(f"int8 VGG-16 logits, kernels on vs off: "
                             f"{out}")

    rows = []
    for fc, row in k5_rows.items():
        row.update(launches=per_shape[fc],
                   max_abs_err=by_fc[fc]["max_abs_err"])
        log("zoo", "(e) " + json.dumps(
            {k: v for k, v in row.items() if "windows" not in k}))
        rows.append(row)
    log("zoo", "(e) " + json.dumps(out))
    return rows, out


def phase_zoo(counters, k5_rows, device="cuda"):
    """The classic image zoo (queue 1, item 9) on ``device``: (a) card
    against CPU in float64 with an LRN fault, (b) tools/perf throughput
    at full width, (c) dropout through containers windowed, (d) the
    recipes, (e) int8 VGG-16 through K5 (module docstring, phase 15).
    Returns the kernels-line rows of K5 at VGG-16's classifier
    (``k5_rows``, phase 3's timings, with (e)'s launches and errors)
    and the summary."""
    import torch

    on_card = device == "cuda"
    t_phase = time.perf_counter()
    for fn in counters.values():
        fn.launches = 0
    summary = {"parity": _zoo_parity(device)}
    summary["perf"] = _zoo_perf(device)
    summary["dropout"] = _zoo_dropout(device)
    summary["recipes"] = _zoo_recipes(device)
    training = {name: fn.launches for name, fn in counters.items()}
    if any(training.values()):
        raise AssertionError(f"a kernel of the kernels line launched in "
                             f"the zoo's training: {training}")
    rows, summary["int8"] = _zoo_int8(counters, k5_rows, device)
    summary["wall_s"] = time.perf_counter() - t_phase
    summary["max_memory_allocated"] = \
        torch.cuda.max_memory_allocated() if on_card else "not measured"
    log("zoo", f"phase wall {summary['wall_s']:.1f} s")
    return rows, summary


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on a CUDA card", file=sys.stderr)
        return 1
    from bigdl_tpu_torch.kernels.flash_attention import (
        blockwise_flash_attention_backward, blockwise_flash_attention_forward,
        flash_attention_backward, flash_attention_forward)
    from bigdl_tpu_torch.kernels.int8_gemm import int8_gemm
    from bigdl_tpu_torch.kernels.paged_decode import paged_decode_attention
    from bigdl_tpu_torch.kernels.ragged_decode import ragged_decode_attention

    kind, _ = phase_device()
    phase_build()
    greedy, topk = make_prompts()
    # the main path's steady state: the first 16 prompts' lengths,
    # half-way through their 32 new tokens
    main_lengths = [len(p) + MAX_NEW // 2 for p in greedy[:SLOTS]]
    ragged = phase_ragged_decode(main_lengths)
    corpus = train_corpus()
    train_seg = torch.from_numpy(corpus[0][1][:TRAIN_BATCH]).cuda()
    flash_fwd, flash_bwd = phase_flash(train_seg)
    blockwise_fwd, blockwise_bwd, bf16_fwd, bf16_bwd = phase_blockwise()
    phase_k6_route()
    int8, k5_vgg_rows = phase_int8_gemm()
    paged = phase_paged_decode(main_lengths)
    counters = {"ragged_decode": ragged_decode_attention,
                "flash_attention_fwd": flash_attention_forward,
                "flash_attention_bwd": flash_attention_backward,
                "blockwise_flash_attention_fwd":
                    blockwise_flash_attention_forward,
                "blockwise_flash_attention_bwd":
                    blockwise_flash_attention_backward,
                "int8_gemm": int8_gemm,
                "paged_decode": paged_decode_attention}
    serve_launches, _ = phase_main_path(counters, greedy, topk)
    train_launches, train_summary = phase_train(counters, corpus)
    longctx_launches, _ = phase_longctx_train(counters)
    bf16_launches, _ = phase_longctx_bf16(counters)
    longserve_launches, _ = phase_longctx_serve(counters)
    int8_launches, _ = phase_int8_serve(counters)
    lenet_launches, _ = phase_lenet(counters)
    resnet_launches, _ = phase_resnet_train(counters)
    _, prec_summary = phase_precision(counters, corpus, train_summary)
    bf16 = prec_summary["bf16_profile"]
    phase_optim(counters, corpus, {
        "ms_per_step": bf16["k8_ms_per_step"],
        "unprofiled_ms_per_step": bf16["k8_unprofiled_ms_per_step"],
        "idle_share": bf16["k8_idle_share"]})
    phase_lm(counters, corpus)
    phase_fleet(counters, greedy)
    zoo_rows, _ = phase_zoo(counters, k5_vgg_rows)
    ragged["launches"] = serve_launches["ragged_decode"]
    flash_fwd["launches"] = train_launches["flash_attention_fwd"]
    flash_bwd["launches"] = train_launches["flash_attention_bwd"]
    blockwise_fwd["launches"] = \
        longctx_launches["blockwise_flash_attention_fwd"]
    blockwise_bwd["launches"] = \
        longctx_launches["blockwise_flash_attention_bwd"]
    bf16_fwd["launches"] = bf16_launches["blockwise_flash_attention_fwd"]
    bf16_bwd["launches"] = bf16_launches["blockwise_flash_attention_bwd"]
    int8["launches"] = int8_launches["int8_gemm"]
    # K4 has no main-path call site in either package: no path of this
    # run launches it (its phase drove it through the dispatch function)
    paged["launches"] = max(launches["paged_decode"] for launches in (
        serve_launches, train_launches, longctx_launches, bf16_launches,
        longserve_launches, int8_launches, lenet_launches,
        resnet_launches))
    log("device_ms", f"{WINDOWS['read']} profiler windows read, "
                     f"{WINDOWS['retaken']} retaken for lost kernels; "
                     f"{WINDOWS['pairs read again']} pairs read again for "
                     f"a spread above {WINDOW_SPREAD:.0%} (largest "
                     f"{WINDOWS['largest spread read again']:.2%}); "
                     f"largest spread of a kept pair "
                     f"{WINDOWS['largest spread']:.2%}; "
                     f"{WINDOWS['graph rows']} rows timed by graph "
                     f"replays; {WINDOWS['singles disagreed']} rows whose "
                     f"single-call windows disagreed")
    print(json.dumps({"kernels": [ragged, flash_fwd, flash_bwd,
                                  blockwise_fwd, blockwise_bwd, bf16_fwd,
                                  bf16_bwd, int8, paged] + zoo_rows}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
