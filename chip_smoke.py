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
   the same inputs on the card, at the serving slice's shapes, then
   timed beside the plain version, one PyTorch library call computing
   the same function (a yardstick only; the port never calls it) and
   the card's bound for the work;
4. main path — ``GenerationService`` serving a ``TransformerLM`` at the
   generation bench width (vocab 8192, hidden 512, 6 layers, 8 heads,
   max_len 512; random weights from a seed) for 32 greedy and 4 seeded
   top-k requests of 32 new tokens each. Every kernel's launch count is
   set to 0 just before and read just after: the ragged decode kernel
   must have launched once per layer per decode step. The greedy
   streams of 4 prompts must equal a greedy full re-forward without a
   cache, and every top-k token must lie in the top k of that
   re-forward's logits.

Float32 throughout, with TF32 switched off for matrix products and
convolutions: the tolerances below assume full float32.

The line before the last is a JSON object ``{"kernels": [...]}`` with
each kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``. Without a card, or run outside the
repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# ---- the serving slice (bench.py's GENERATION row) ----
VOCAB, HIDDEN, LAYERS, HEADS, FFN, MAX_LEN = 8192, 512, 6, 8, 2048, 512
SLOTS, PREFILL_ROWS, N_GREEDY, N_TOPK, MAX_NEW = 16, 4, 32, 4, 32
TOP_K, TEMPERATURE = 20, 0.8
HEAD_DIM = HIDDEN // HEADS

# ---- the card (NVIDIA's H100 SXM data sheet) ----
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12          # float32 outside the tensor cores

#: kernel vs plain version on the same inputs: float32 absolute (the
#: JAX kernel contract's row); bfloat16 relative to max(1, |plain|),
#: i.e. about one bf16 rounding step of the output (the two round the
#: same float32 value after summing in another order)
RAGGED_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{kind}; count {torch.cuda.device_count()}; torch "
                  f"{torch.__version__}, CUDA {torch.version.cuda}; "
                  f"TF32 off")
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
        seen = []    # one line per distinct template instance profile
        for line in _build.build_log(name).splitlines():
            line = line.split(":", 1)[-1].strip()
            if ("registers" in line or "spill" in line) \
                    and line not in seen:
                seen.append(line)
                log("build", f"{name}: {line}")


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


def profile_burst(svc, prompts) -> None:
    """Where a decode burst's time goes: the given prompts once more
    under ``torch.profiler``, reporting wall-clock, device time by
    kernel (summed over the window) and the device's idle share."""
    import torch
    from torch.autograd import DeviceType
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
    kernels = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        kernels.append((us / 1e3, ev.count, ev.key))
    kernels.sort(reverse=True)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on a CUDA card", file=sys.stderr)
        return 1
    from bigdl_tpu_torch.kernels.ragged_decode import ragged_decode_attention

    kind, _ = phase_device()
    phase_build()
    greedy, topk = make_prompts()
    # the main path's steady state: the first 16 prompts' lengths,
    # half-way through their 32 new tokens
    main_lengths = [len(p) + MAX_NEW // 2 for p in greedy[:SLOTS]]
    entry = phase_ragged_decode(main_lengths)
    counters = {"ragged_decode": ragged_decode_attention}
    launches, _ = phase_main_path(counters, greedy, topk)
    entry["launches"] = launches["ragged_decode"]
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
