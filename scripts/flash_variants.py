"""Time variants of K1's CUDA source against each other on one card, in
turns, on the same inputs.

Each argument is a directory holding a copy of
``bigdl_tpu_torch/kernels/csrc`` (``DIR/csrc/flash_attention.cu`` and its
header), edited as the variant needs. The script builds every variant
with nvcc at once, binds each library with ctypes, checks each against
the tree's own kernel (the wrapper's build) at the training shape
``[16, 8, 512, 64]``, causal, with the training batch's packed segment
ids, in bfloat16 and float16, and then times each variant's forward and
backward with CUDA events around 60 calls over 3 input sets (past the
50 MB L2), in the order a, b, ..., ..., b, a twice. It prints ptxas's
registers and spills of the 16-bit D = 64 instances, the largest
differences from the tree's kernel, and each variant's median ms.

    python3 scripts/flash_variants.py _smoke_checkout/a _smoke_checkout/b

Needs a CUDA card and nvcc; run from the repository root.
"""
import ctypes
import importlib
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as smoke  # noqa: E402
from bigdl_tpu_torch.kernels import _build  # noqa: E402

fa = importlib.import_module("bigdl_tpu_torch.kernels.flash_attention")
SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16"}
CALLS = 60


def build(dirs):
    """``{dir: (library, ptxas lines of the 16-bit D = 64 instances)}``."""
    nvcc = _build.nvcc_path()
    procs = {d: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", f"{d}/lib.so",
         f"{d}/csrc/flash_attention.cu"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for d in dirs}
    libs = {}
    for d, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{d}: nvcc failed\n{err[-3000:]}")
        lib = ctypes.CDLL(f"{d}/lib.so")
        p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for suffix in SUFFIX.values():
            getattr(lib, f"bigdl_flash_fwd_{suffix}").argtypes = (
                [p] * 6 + [i32] * 4 + [p, i32, f32, i32, p])
            getattr(lib, f"bigdl_flash_bwd_{suffix}").argtypes = (
                [p] * 11 + [i32] * 4 + [p, i32, f32, i32, p])
        lines, fn = [], None
        for line in err.splitlines():
            if "Function properties for" in line:
                fn = smoke.kernel_instance(line.split("for")[-1].strip())
            elif fn and "16, 64>" in fn and ("Used" in line
                                              or "spill" in line):
                lines.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
        libs[d] = (lib, lines)
    return libs


def main(dirs) -> None:
    libs = build(dirs)
    for d, (_, lines) in libs.items():
        print(d, json.dumps(lines), flush=True)
    corpus = smoke.train_corpus()
    seg = torch.from_numpy(corpus[0][1][:smoke.TRAIN_BATCH]).cuda().to(
        torch.int32)
    shape = (smoke.TRAIN_BATCH, smoke.HEADS, smoke.TRAIN_SEQ, smoke.HEAD_DIM)
    b, h, s, d = shape
    scale = 1 / math.sqrt(d)
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    medians = {}
    for dtype, suffix in SUFFIX.items():
        sets = [(*smoke._views(gen, shape, dtype),
                 torch.randn(shape, device="cuda", generator=gen).to(dtype))
                for _ in range(3)]
        fwd_ref = [fa.flash_attention_forward(q, k, v, seg, causal=True)
                   for q, k, v, _ in sets]
        bwd_ref = [fa.flash_attention_backward(q, k, v, o, do, lse, seg,
                                               causal=True)
                   for (q, k, v, do), (o, lse) in zip(sets, fwd_ref)]

        def fwd(lib, i):
            q, k, v, _ = sets[i]
            o = torch.empty(shape, dtype=dtype, device="cuda")
            lse = torch.empty((b, h, s), device="cuda")
            assert getattr(lib, f"bigdl_flash_fwd_{suffix}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                o.data_ptr(), lse.data_ptr(), b, h, s, d,
                fa._strides(q, k, v), 1, scale, 0, stream) == 0
            return o, lse

        def bwd(lib, i):
            q, k, v, do = sets[i]
            o, lse = fwd_ref[i]
            grads = [torch.empty(shape, dtype=dtype, device="cuda")
                     for _ in range(3)]
            delta = torch.empty((b, h, s), device="cuda")
            assert getattr(lib, f"bigdl_flash_bwd_{suffix}")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), seg.data_ptr(),
                *[g.data_ptr() for g in grads], delta.data_ptr(), b, h, s,
                d, fa._strides(q, k, v, o, do), 1, scale, 0, stream) == 0
            return grads

        def timed(fn, lib):
            for i in range(6):
                fn(lib, i % 3)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(True), torch.cuda.Event(True)
            start.record()
            for i in range(CALLS):
                fn(lib, i % 3)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / CALLS

        for name, (lib, _) in libs.items():
            o, lse = fwd(lib, 0)
            grads = bwd(lib, 0)
            torch.cuda.synchronize()
            errs = {"o": smoke._err(o, fwd_ref[0][0], True),
                    "lse": smoke._err(lse, fwd_ref[0][1], False)}
            errs.update({n: smoke._err(g, w, True) for n, g, w in
                         zip(("dq", "dk", "dv"), grads, bwd_ref[0])})
            print(suffix, name, "largest difference from the tree's kernel",
                  json.dumps(errs), flush=True)
        order = (list(libs) + list(libs)[::-1]) * 2
        for kind, fn in (("fwd", fwd), ("bwd", bwd)):
            for name in order:
                medians.setdefault(f"{suffix} {kind} {name}", []).append(
                    timed(fn, libs[name][0]))
    for key, times in medians.items():
        times = sorted(times)
        print(key, "ms median", round((times[1] + times[2]) / 2, 5), "all",
              [round(t, 5) for t in times], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
