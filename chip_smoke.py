#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on the card, end to end.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases (any failure raises and exits non-zero; nothing is caught):

1. device — the card's name, and its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints them;
2. build — every kernel under ``bigdl_tpu_torch/kernels/csrc`` is built
   from source with nvcc (one process per source, all at once);
3. kernels — each kernel's wrapper against its plain PyTorch version on
   the same inputs on the card, at its main path's shapes, then timed
   beside the plain version, one PyTorch library call computing the
   same function (a yardstick only; the port never calls it) and the
   card's bound for the work. The ragged decode kernel (K3) at the
   serving shapes; the flash-attention forward and backward (K1) at the
   training shapes ``[16, 8, 512, 64]``, float32 and bfloat16, causal,
   with and without the training batch's packed segment ids, plus ragged
   edge shapes; the blockwise flash-attention forward and backward (K2)
   at ragged edge shapes (S = 1 to 1000, D = 16 to 128, causal and
   segments on and off, float32/bfloat16/float16) and at ``[1, 8, 2048,
   64]``, against K1's kernel at the long-context shape ``[1, 8, 8192,
   64]``, and timed there and at ``[1, 8, 32768, 64]`` beside K1, the
   SDPA yardstick and (at 8192) the einsum path; then the attention
   layer's route for score matrices over 2 GiB (flash off, ``[1, 8,
   16384, 128]``) must launch K2 once and equal a direct call bitwise;
   the fused dequant int8 GEMM (K5) equal to its plain version bitwise
   at 60 edge shapes (M 1-300, N 1-1024, K 1-4100), at the int8 serving
   slice's classifier shape ``[64, 2048] x [1000, 2048]^T`` and at
   4096^3, timed at the last two beside ``torch._int_mm``; the paged
   decode kernel (K4), through the dispatch function, equal bitwise to
   K3's kernel on identity and shuffled paged views of the same cache
   (page sizes 16, 64, 128; ``[16, 8, 512, 64]`` with the serving
   lengths and T = 8192) and timed beside it;
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
   percentiles and a profiled window of each.

Float32 throughout, with TF32 off for matrix products (set here) and for
convolutions (PyTorch's default is on; the port's convolution layers
switch it off, and phase 8 checks that they did): the tolerances below
assume full float32.

The line before the last is a JSON object ``{"kernels": [...]}`` with
each kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``. Without a card, or run outside the
repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
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

# ---- K5 and K4 shapes ----
INT8_EDGE_M, INT8_EDGE_N, INT8_EDGE_K = (1, 7, 64, 65, 300), \
    (1, 1000, 1024), (1, 3, 2048, 4100)
INT8_MAIN_SHAPE = (SERVE_BATCH, RESNET_CLASSES, 2048)   # (M, N, K)
INT8_BIG_SHAPE = (4096, 4096, 4096)     # BASELINE.md's int8 sweep
PAGE_SIZES = (16, 64, 128)

# ---- the card (NVIDIA's H100 SXM data sheet) ----
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12        # bfloat16 on the tensor cores
INT8_OPS_PER_S = 1979e12         # int8 on the tensor cores, dense

#: kernel vs plain version on the same inputs: float32 absolute (the
#: JAX kernel contract's row); bfloat16 relative to max(1, |plain|),
#: i.e. about one bf16 rounding step of the output (the two round the
#: same float32 value after summing in another order)
RAGGED_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
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


def ragged_bound(lengths, t: int, itemsize: int):
    """Least time (ms) the card needs for one ragged-decode call: each
    valid K and V row read once, q read and the output written once,
    against 4 flops per valid cached element in float32."""
    n = np.clip(np.asarray(lengths, np.int64), 1, t)
    rows = int(n.sum()) * HEADS
    nbytes = (rows * HEAD_DIM * 2 * itemsize
              + 2 * SLOTS * HEADS * HEAD_DIM * itemsize + SLOTS * 4)
    flops = rows * HEAD_DIM * 4
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


def kernel_instance(mangled: str) -> str:
    """``flash_fwd_kernel<f32, 64>`` (or ``int8_gemm_kernel``) from a
    kernel's mangled name."""
    m = re.search(r"([A-Za-z]+(?:_[A-Za-z0-9]+)*_kernel)I"
                  r"(f|13__nv_bfloat16|6__half)(?:Li(\d+)E)?", mangled)
    if not m:
        m = re.search(r"\d([A-Za-z]\w*_kernel)E", mangled)
        return m.group(1) if m else mangled
    dtype = {"f": "f32", "6__half": "f16"}.get(m.group(2), "bf16")
    return f"{m.group(1)}<{dtype}{', ' + m.group(3) if m.group(3) else ''}>"


def phase_ragged_decode(main_lengths):
    """K3 against its plain version at the slice's shapes, then timed.
    Returns the kernels-line entry (launches filled in later)."""
    import torch
    import torch.nn.functional as F

    from bigdl_tpu_torch.kernels.ragged_decode import (
        ragged_decode_attention, ragged_decode_attention_reference)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q32 = torch.randn((SLOTS, HEADS, HEAD_DIM), device=dev, generator=gen)
    k32 = torch.randn((SLOTS, HEADS, MAX_LEN, HEAD_DIM), device=dev,
                      generator=gen)
    v32 = torch.randn((SLOTS, HEADS, MAX_LEN, HEAD_DIM), device=dev,
                      generator=gen)
    # lengths mix 1, the kernel's 16-key and the plain version's
    # 128-row step edges, T itself, values over T and 0 (clamped)
    mixes = {128: [1, 2, 15, 16, 17, 63, 64, 65, 100, 127, 128, 129, 700,
                   0, 33, 96],
             512: [1, 16, 17, 127, 128, 129, 255, 256, 257, 300, 480, 511,
                   512, 513, 1000, 0]}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dtype) for x in (q32, k32, v32))
        for t, mix in mixes.items():
            lengths = torch.tensor(mix, dtype=torch.int32, device=dev)
            ks, vs = k[:, :, :t], v[:, :, :t]     # views of the cache
            if t < MAX_LEN and ks.is_contiguous():
                raise AssertionError("the T < max_len view is contiguous")
            out = ragged_decode_attention(q, ks, vs, lengths)
            ref = ragged_decode_attention_reference(q, ks, vs, lengths)
            torch.cuda.synchronize()
            diff = (out.float() - ref.float()).abs()
            name = str(dtype).split(".")[-1]
            if dtype == torch.float32:
                err = diff.max().item()
            else:
                err = (diff / ref.float().abs().clamp(min=1.0)).max().item()
            tol = RAGGED_TOL[name]
            log("ragged_decode", f"{name} T={t} max|kernel-plain| = "
                                 f"{diff.max().item():.3e}, checked error "
                                 f"{err:.3e} (tolerance {tol})")
            if not err <= tol:
                raise AssertionError(f"ragged_decode {name} T={t}: "
                                     f"{err} > {tol}")

    # timing: 8 distinct caches (268 MB together, past the 50 MB L2),
    # like the 6 layers' caches a decode step walks through
    n_sets, t = 8, MAX_LEN
    sets = [(torch.randn((SLOTS, HEADS, HEAD_DIM), device=dev,
                         generator=gen),
             torch.randn((SLOTS, HEADS, MAX_LEN, HEAD_DIM), device=dev,
                         generator=gen),
             torch.randn((SLOTS, HEADS, MAX_LEN, HEAD_DIM), device=dev,
                         generator=gen)) for _ in range(n_sets)]
    entry = None
    for label, mix in (("main-path lengths", main_lengths),
                       ("every slot full", [t] * SLOTS)):
        lengths = torch.tensor(mix, dtype=torch.int32, device=dev)
        mask = (torch.arange(t, device=dev)[None, :]
                < lengths.clamp(1, t)[:, None])[:, None, None, :]

        def kern(i):
            q, k, v = sets[i]
            return ragged_decode_attention(q, k[:, :, :t], v[:, :, :t],
                                           lengths)

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
        ms = time_ms(kern, n_sets, rounds=50)
        plain_ms = time_ms(plain, n_sets, rounds=10)
        library_ms = time_ms(library, n_sets, rounds=20)
        bound_ms, bound_by = ragged_bound(mix, t, 4)
        log("ragged_decode", json.dumps({
            "case": label, "T": t, "lengths": list(map(int, mix)),
            "max_abs_err": err, "library_max_abs_err": lib_err,
            "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "kernel_over_bound": ms / bound_ms}))
        if not err <= RAGGED_TOL["float32"]:
            raise AssertionError(f"ragged_decode timing inputs: {err}")
        if entry is None:
            entry = {"name": "ragged_decode", "route": "cuda",
                     "source": "bigdl_tpu_torch/kernels/csrc/"
                               "ragged_decode.cu",
                     "replaces": "bigdl_tpu/kernels/ragged_decode.py:37",
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}
    return entry


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
        t0 = time.perf_counter()
        streams = [svc.generate("lm", p, max_new_tokens=MAX_NEW)
                   for p in prompts]
        for s in streams:
            s.result(timeout=600)
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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


def flash_bound(kept: int, shape, itemsize: int, segmented: bool,
                backward: bool, flops_per_s: float):
    """Least time (ms) the card needs for one K1 or K2 call: 4 * D flops
    per kept pair per head forward and 2.5x that backward, against q, k,
    v read and O, lse written (forward), or q, k, v, O, dO, lse read and
    dq, dk, dv written (backward), plus the segment ids."""
    b, h, s, d = shape
    n = b * h * s * d
    flops = 4 * d * h * kept * (2.5 if backward else 1.0)
    nbytes = ((8 if backward else 4) * n * itemsize + b * h * s * 4
              + (b * s * 4 if segmented else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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
        flash_attention_forward, flash_attention_forward_reference)
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
    for dtype in (torch.float32, torch.bfloat16):
        for seg in (None, train_seg):
            q, k, v = _views(gen, shape, dtype)
            do = torch.randn(shape, device=dev, generator=gen).to(dtype)
            name = str(dtype).split(".")[-1]
            _check_flash(_flash_errors(q, k, v, do, seg, True), name,
                         f"{name} {list(shape)} causal "
                         f"segments={seg is not None}")

    # timing: 3 input sets (q, k, v, O, dO: 252 MB in float32, past the
    # 50 MB L2), causal as in training
    entries = None
    for dtype, seg in ((torch.float32, train_seg), (torch.float32, None),
                       (torch.bfloat16, train_seg)):
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
        peak = F32_FLOPS_PER_S if dtype == torch.float32 \
            else BF16_FLOPS_PER_S
        itemsize = torch.empty((), dtype=dtype).element_size()
        rel = dtype == torch.bfloat16
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
            plain_ms = time_ms(plain, n_sets, rounds=2)
            library_ms = time_ms(lib, n_sets, rounds=10)
            einsum_ms = time_ms(einsum, n_sets, rounds=5)
            bound_ms, bound_by = flash_bound(kept, shape, itemsize,
                                             seg is not None, backward, peak)
            row[kind] = {"name": f"flash_attention_{kind}", "route": "cuda",
                         "source": "bigdl_tpu_torch/kernels/csrc/"
                                   "flash_attention.cu",
                         "replaces": "bigdl_tpu/kernels/flash_attention.py:"
                                     + ("97" if backward else "65"),
                         "launches": None, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms}
            log("flash_attention", json.dumps({
                "case": f"{kind} {name} {list(shape)} causal segments="
                        f"{seg is not None}", "kept_pairs": kept,
                "max_abs_err": err, "kernel_ms": ms, "plain_ms": plain_ms,
                "library_ms": library_ms, "einsum_path_ms": einsum_ms,
                "library": "F.scaled_dot_product_attention " + (
                    "backward (autograd.grad)" if backward else "forward"),
                "library_fwd_max_abs_err": lib_err, "bound_ms": bound_ms,
                "bound_by": bound_by, "kernel_over_bound": ms / bound_ms}))
        if entries is None:
            entries = row
    return entries["fwd"], entries["bwd"]


def train_corpus():
    """The training phase's packed synthetic documents, made as the
    train CLI's ``--synthetic N --inputMode packed`` makes them."""
    from bigdl_tpu_torch.models.transformer_train import synthetic_corpus

    return synthetic_corpus(TRAIN_SYNTHETIC, TRAIN_VOCAB, TRAIN_SEQ,
                            "packed", TRAIN_BATCH)


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def step_differences(model, crit, batch, fault=None,
                     function="_FlashAttention"):
    """One SGD step from the model's weights on ``batch`` with the flash
    kernels and with flash switched off (the einsum path on the card):
    the loss difference, the largest parameter difference after the
    update, and per parameter the largest gradient difference over the
    largest element of the einsum path's gradient (floored at
    ``TRAIN_GRAD_FLOOR`` of the model's largest). ``fault`` ("dK zeroed"
    or "dQ 1% off") is put into the gradients of the kernel's autograd
    ``function`` (K1's ``_FlashAttention`` or K2's
    ``_BlockwiseFlashAttention``) during the kernel step (the fault
    check). The model's weights are restored."""
    from bigdl_tpu_torch import kernels
    from bigdl_tpu_torch.optim import SGD, build_train_step

    start = _state(model)
    params = dict(model.named_parameters())
    results = []
    for cfg, step_fault in ((kernels.KernelConfig.ported(), fault),
                            (kernels.KernelConfig(flash_attention=False,
                                                  decode_attention=True),
                             None)):
        model.load_state_dict(start)
        with kernels.use(cfg), _gradient_fault(step_fault, function):
            step = build_train_step(model, crit, SGD(learning_rate=TRAIN_LR))
            loss = float(step(*batch, TRAIN_LR))
        results.append((loss, _state(model),
                        {k: p.grad.detach().clone()
                         for k, p in params.items()}))
    model.load_state_dict(start)
    (loss_k, new_k, grad_k), (loss_e, new_e, grad_e) = results
    floor = TRAIN_GRAD_FLOOR * max(g.abs().max().item()
                                   for g in grad_e.values())
    grad_rel = {k: ((grad_k[k] - grad_e[k]).abs().max()
                    / grad_e[k].abs().max().clamp(min=floor)).item()
                for k in grad_e}
    return {"loss_kernel": loss_k, "loss_einsum": loss_e,
            "loss_diff": abs(loss_k - loss_e),
            "param_diff": max((new_k[k] - new_e[k]).abs().max().item()
                              for k in start),
            "grad_rel_diff": grad_rel}


def step_parity_holds(diffs) -> bool:
    return (diffs["loss_diff"] <= TRAIN_PARITY_TOL
            and diffs["param_diff"] <= TRAIN_PARITY_TOL
            and max(diffs["grad_rel_diff"].values()) <= TRAIN_GRAD_RTOL)


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
    into the gradients the kernel returns (None: no fault). The kernel
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
        else:
            dq = dq * 1.01
        return (dq, dk, dv, *rest)

    fn.backward = staticmethod(backward)
    try:
        yield
    finally:
        fn.backward = staticmethod(real)


def profile_train(model, crit, batches, device, phase="train-profile"
                  ) -> None:
    """Where a training step's time goes: ``PROFILE_STEPS`` steps under
    ``torch.profiler``, reporting wall-clock, device time by kernel and
    the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.optim import SGD, build_train_step

    step = build_train_step(model, crit, SGD(learning_rate=TRAIN_LR))
    float(step(*batches[0], TRAIN_LR))            # warm
    on_card = device == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if on_card else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for inp, tgt in batches[1:]:
            float(step(inp, tgt, TRAIN_LR))
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(k[0] for k in kernels)
    log(phase, json.dumps({
        "steps": len(batches) - 1, "wall_ms": wall_ms,
        "wall_ms_per_step": wall_ms / (len(batches) - 1),
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_idle_share": (1 - busy_ms / wall_ms) if kernels
        else "not measured"}))
    for ms, count, key in kernels[:10]:
        log(phase, f"{ms:9.3f} ms {count:6d}x  {key[:90]}")


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
    yardstick, the einsum path (8192 only) and the bound. Returns the two
    kernels-line entries at 8192 (launches filled in later)."""
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

        kept = kept_pairs(None, 1, s, "cuda")
        row = {"S": s, "kept_pairs": kept}
        for kind, backward in (("f", False), ("b", True)):
            rounds = 3 if s == LC_SEQ else 1
            row[f"k2_{kind}_ms"] = timed(f"k2_{kind}", rounds)
            row[f"k1_{kind}_ms"] = timed(f"k1_{kind}", rounds)
            row[f"sdpa_{kind}_ms"] = timed(f"lib_{kind}", rounds)
            row[f"bound_{kind}_ms"], row[f"bound_{kind}_by"] = flash_bound(
                kept, shape, 4, False, backward, F32_FLOPS_PER_S)
        if s == LC_SEQ:
            # the plain version (a Python loop over 128 x 128 tiles) and
            # the einsum path (2.1 GB of f32 scores per call) at 8192
            # only; the kernel against the plain version on these inputs
            # is the kernels line's error
            main_errs = _flash_errors(*sets[0][0], sets[0][1], None, True,
                                      "blockwise_flash_attention")
            _check_flash(main_errs, "float32", f"float32 {list(shape)} "
                         f"causal (the main path's shape)", "blockwise")
            row["plain_f_ms"] = time_ms(lambda i: fns(0, "plain_f"), 1, 1)
            row["plain_b_ms"] = time_ms(lambda i: fns(0, "plain_b"), 1, 1)
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
                    "plain_ms": row[f"plain_{kind}_ms"],
                    "bound_ms": row[f"bound_{kind}_ms"],
                    "bound_by": row[f"bound_{kind}_by"],
                    "library_ms": row[f"sdpa_{kind}_ms"]}
        log("blockwise", json.dumps(row))
        del sets, outs, outs1, graphs
        torch.cuda.empty_cache()
    return entries["f"], entries["b"]


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


def phase_longctx_train(counters, device="cuda"):
    """LocalOptimizer at the long-context configuration, S = 8192, batch
    1, on the train CLI's contiguous synthetic stream, SGD lr 0.1, for
    ``LC_ITERS`` iterations — every attention call through K2, checked
    against the einsum path in one step (with two faults put into K2's
    backward, which must show) — then one step at S = 32768. Returns the
    launches per kernel and the metrics."""
    import torch

    from bigdl_tpu_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_tpu_torch.kernels import flash_route
    from bigdl_tpu_torch.models.transformer_train import synthetic_corpus
    from bigdl_tpu_torch.nn import SequenceCrossEntropyCriterion
    from bigdl_tpu_torch.optim import (SGD, LocalOptimizer,
                                       build_train_step, max_iteration)

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

    samples = [Sample(x[i], y[i]) for i in range(len(y))]
    ds = DataSet.array(samples).transform(SampleToMiniBatch(1))
    opt = LocalOptimizer(model, ds, crit, batch_size=1)
    opt.set_optim_method(SGD(learning_rate=TRAIN_LR))
    opt.set_end_when(max_iteration(LC_ITERS))
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
    log("longctx-train", json.dumps(summary))
    if not all(np.isfinite(losses)) or len(losses) != LC_ITERS:
        raise AssertionError(f"losses: {losses}")
    if not summary["loss_mean_last5"] < summary["loss_mean_first5"]:
        raise AssertionError(f"loss did not fall: {losses}")
    for name, want in (("blockwise_flash_attention_fwd", LC_LAYERS),
                       ("blockwise_flash_attention_bwd", LC_LAYERS),
                       ("flash_attention_fwd", 0), ("flash_attention_bwd", 0)):
        if launches[name] != want * LC_ITERS:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"over {LC_ITERS} iterations x "
                                 f"{LC_LAYERS} layers")
    compare_attention_paths(model, crit, batch(LC_ITERS), device,
                            "longctx-train")
    profile_train(model, crit, [batch(LC_ITERS + 1 + i)
                                for i in range(PROFILE_STEPS + 1)], device,
                  "longctx-profile")
    del model, opt, ds, samples
    if device == "cuda":
        torch.cuda.empty_cache()

    # one step at S = 32768 (the einsum path's scores alone would take
    # 34 GB a layer there; it is not run)
    xl, yl = synthetic_corpus(2 * LC_SEQ_MAX + 1, LC_VOCAB, LC_SEQ_MAX,
                              "contiguous", 1)
    model = longctx_model(LC_SEQ_MAX, device)
    step = build_train_step(model, crit, SGD(learning_rate=TRAIN_LR))
    before = {name: fn.launches for name, fn in counters.items()}
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss = float(step(torch.from_numpy(xl[:1]).to(device),
                      torch.from_numpy(yl[:1]).to(device), TRAIN_LR))
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" \
        else "not measured"
    k2 = {name: counters[name].launches - before[name]
          for name in ("blockwise_flash_attention_fwd",
                       "blockwise_flash_attention_bwd")}
    log("longctx-train", json.dumps({
        "S": LC_SEQ_MAX, "loss": loss, "step_seconds_first": step_s,
        "peak_memory_bytes": peak, "k2_launches": k2}))
    if not np.isfinite(loss) or set(k2.values()) != {LC_LAYERS}:
        raise AssertionError(f"S={LC_SEQ_MAX} step: loss {loss}, K2 "
                             f"launches {k2}")
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
    and 4096^3; then timed L2-cold at those two beside the plain
    version, ``torch._int_mm`` plus the same epilogue (the library
    yardstick) and the bound. Returns the kernels-line entry at the main
    path's shape (launches filled in later)."""
    import torch

    from bigdl_tpu_torch.kernels.int8_gemm import (int8_gemm,
                                                   int8_gemm_reference)

    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = 0
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
    log("int8_gemm", f"{cases} edge shapes (M {INT8_EDGE_M}, N "
                     f"{INT8_EDGE_N}, K {INT8_EDGE_K}): kernel bitwise "
                     f"equal to the plain version")

    def library(x, w, xs, ws):
        return torch._int_mm(x, w.t()).float() * xs[:, None] * ws[None, :]

    entry = None
    for (m, n, k), n_sets in ((INT8_MAIN_SHAPE, 32), (INT8_BIG_SHAPE, 3)):
        # L2-cold: together the sets exceed the 50 MB L2 (32 x 2.2 MB of
        # operands at the main shape; 3 x 100 MB at 4096^3)
        sets = [_int8_operands(gen, m, n, k) for _ in range(n_sets)]
        got = int8_gemm(*sets[0])
        want = int8_gemm_reference(*sets[0])
        lib = library(*sets[0])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"int8_gemm [{m},{k}]x[{n},{k}]: not "
                                 f"bitwise the plain version")
        err = (got - want).abs().max().item()
        row = {"M": m, "N": n, "K": k, "bitwise_equal": True,
               "max_abs_err": err,
               "library_bitwise_equal": bool(torch.equal(lib, want)),
               "kernel_ms": time_ms(lambda i: int8_gemm(*sets[i]),
                                    n_sets, 20),
               "plain_ms": time_ms(lambda i: int8_gemm_reference(*sets[i]),
                                   n_sets, 5),
               "library_ms": time_ms(lambda i: library(*sets[i]), n_sets,
                                     20)}
        row["bound_ms"], row["bound_by"] = int8_bound(m, n, k)
        row["kernel_over_bound"] = row["kernel_ms"] / row["bound_ms"]
        row["kernel_over_library"] = row["kernel_ms"] / row["library_ms"]
        row["kernel_tops"] = 2 * m * n * k / row["kernel_ms"] / 1e9
        log("int8_gemm", json.dumps(row))
        if entry is None:
            entry = {"name": "int8_gemm", "route": "cuda",
                     "source": "bigdl_tpu_torch/kernels/csrc/int8_gemm.cu",
                     "replaces": "bigdl_tpu/kernels/int8_gemm.py:39",
                     "launches": None, "max_abs_err": err,
                     "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]}
        del sets
        torch.cuda.empty_cache()
    return entry


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


def phase_paged_decode(main_lengths):
    """K4, through the dispatch function, against K3's kernel bitwise
    (``torch.equal``) on identity and shuffled paged views of the same
    cache, at page sizes 16, 64 and 128, at ``[16, 8, 512, 64]`` with
    the serving lengths and at T = 8192 (float32; bfloat16 at 512), and
    against its plain version within ``RAGGED_TOL``; then timed L2-cold
    at the serving shape beside K3 on the same cache and the plain
    version. K4 has no main-path call site (in neither package), so its
    launches on a main path are 0. Returns the kernels-line entry at
    page size 16 (launches filled in later)."""
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
    for t, lengths, dtype in ((MAX_LEN, main_lengths, torch.float32),
                              (MAX_LEN, main_lengths, torch.bfloat16),
                              (LC_SEQ, long_lengths, torch.float32)):
        q = torch.randn((SLOTS, HEADS, HEAD_DIM), device="cuda",
                        generator=gen).to(dtype)
        k, v = (torch.randn((SLOTS, HEADS, t, HEAD_DIM), device="cuda",
                            generator=gen).to(dtype) for _ in range(2))
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        ref = ragged_decode_attention(q, k, v, lens)
        name = str(dtype).split(".")[-1]
        pages = PAGE_SIZES if dtype == torch.float32 else (64,)
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
                if dtype == torch.float32 and label == "shuffled":
                    plain = paged_decode_attention_reference(q, kp, vp,
                                                             table, lens)
                    err = (got - plain).abs().max().item()
                    log("paged_decode", f"{name} T={t} page={page} "
                                        f"shuffled: bitwise K3's kernel; "
                                        f"max|kernel-plain| = {err:.3e} "
                                        f"(tolerance "
                                        f"{RAGGED_TOL['float32']})")
                    if not err <= RAGGED_TOL["float32"]:
                        raise AssertionError(f"paged_decode T={t} "
                                             f"page={page}: {err}")
        del k, v
    log("paged_decode", f"{checks} paged views (identity and shuffled, "
                        f"page sizes {list(PAGE_SIZES)}): K4 bitwise "
                        f"equal to K3's kernel; "
                        f"{paged_decode_attention.launches - launches0} "
                        f"K4 launches")

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
    entry = None
    for page in PAGE_SIZES:
        views = [(q,) + paged_view(k, v, page) for q, k, v in sets]
        err = (paged_decode_attention(*views[0], lens)
               - paged_decode_attention_reference(*views[0], lens)) \
            .abs().max().item()
        row = {"page_size": page, "T": t, "lengths": list(main_lengths),
               "max_abs_err": err,
               "kernel_ms": time_ms(lambda i: paged_decode_attention(
                   *views[i], lens), n_sets, 50),
               "plain_ms": time_ms(lambda i: paged_decode_attention_reference(
                   *views[i], lens), n_sets, 3),
               "k3_kernel_ms": k3_ms}
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
                     "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"], "library_ms": None}
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
        t0 = time.perf_counter()
        for x in batches:
            svc.predict_batch(name, x)
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
    blockwise_fwd, blockwise_bwd = phase_blockwise()
    phase_k6_route()
    int8 = phase_int8_gemm()
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
    train_launches, _ = phase_train(counters, corpus)
    longctx_launches, _ = phase_longctx_train(counters)
    longserve_launches, _ = phase_longctx_serve(counters)
    int8_launches, _ = phase_int8_serve(counters)
    ragged["launches"] = serve_launches["ragged_decode"]
    flash_fwd["launches"] = train_launches["flash_attention_fwd"]
    flash_bwd["launches"] = train_launches["flash_attention_bwd"]
    blockwise_fwd["launches"] = \
        longctx_launches["blockwise_flash_attention_fwd"]
    blockwise_bwd["launches"] = \
        longctx_launches["blockwise_flash_attention_bwd"]
    int8["launches"] = int8_launches["int8_gemm"]
    # K4 has no main-path call site in either package: no path of this
    # run launches it (its phase drove it through the dispatch function)
    paged["launches"] = max(launches["paged_decode"] for launches in (
        serve_launches, train_launches, longctx_launches,
        longserve_launches, int8_launches))
    print(json.dumps({"kernels": [ragged, flash_fwd, flash_bwd,
                                  blockwise_fwd, blockwise_bwd, int8,
                                  paged]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
