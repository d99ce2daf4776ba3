"""One case of tests/test_torch_flash_emulated.py, in its own process (a
hung emulation cannot stall the suite): the g++-built K1 and K2 libraries
(``lib<source>.so`` in LIB_DIR) against the port's plain versions on the
same seeded inputs, forward (O, lse) and backward (dq, dk, dv). Prints
one JSON object of the largest errors.

    python _flash_emulation_worker.py LIB_DIR B H S D CAUSAL SEGMENTS DTYPE
"""
import ctypes
import importlib
import json
import math
import sys

import numpy as np
import torch

fa = importlib.import_module("bigdl_tpu_torch.kernels.flash_attention")

SUFFIX = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}
SOURCES = {"flash_attention": ("bigdl_flash",
                               fa.flash_attention_forward_reference,
                               fa.flash_attention_backward_reference),
           "blockwise_flash_attention": (
               "bigdl_blockwise",
               fa.blockwise_flash_attention_forward_reference,
               fa.blockwise_flash_attention_backward_reference)}


def bind(lib_dir, source, prefix, suffix):
    lib = ctypes.CDLL(f"{lib_dir}/lib{source}.so")
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = getattr(lib, f"{prefix}_fwd_{suffix}")
    fwd.argtypes = [p] * 6 + [i32] * 4 + [p, i32, f32, i32, p]
    bwd = getattr(lib, f"{prefix}_bwd_{suffix}")
    bwd.argtypes = [p] * 11 + [i32] * 4 + [p, i32, f32, i32, p]
    fwd.restype = bwd.restype = i32
    return fwd, bwd


def ptr(x):
    return None if x is None else x.data_ptr()


def err(got, want, relative):
    diff = (got.float() - want.float()).abs()
    if relative:
        diff = diff / want.float().abs().clamp(min=1.0)
    return diff.max().item()


def main(lib_dir, b, h, s, d, causal, segmented, dtype_name):
    dtype = getattr(torch, dtype_name)
    rng = np.random.default_rng(b * 1000 + s * 10 + d)
    # q, k, v as the attention layer hands them over: [B, S, H, D] ->
    # [B, H, S, D] strided views
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                .astype(np.float32)).to(dtype).transpose(1, 2)
               for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((b, h, s, d))
                          .astype(np.float32)).to(dtype)
    seg = (torch.from_numpy(np.sort(rng.integers(1, 4, (b, s)), axis=1)
                            .astype(np.int32)) if segmented else None)
    scale = 1.0 / math.sqrt(d)
    rel = dtype != torch.float32
    out = {}
    for source, (prefix, fwd_ref, bwd_ref) in SOURCES.items():
        fwd, bwd = bind(lib_dir, source, prefix, SUFFIX[dtype_name])
        o = torch.empty((b, h, s, d), dtype=dtype)
        lse = torch.empty((b, h, s))
        assert fwd(ptr(q), ptr(k), ptr(v), ptr(seg), ptr(o), ptr(lse), b, h,
                   s, d, fa._strides(q, k, v), int(causal), scale, 0,
                   None) == 0
        grads = [torch.full((b, h, s, d), float("nan"), dtype=dtype)
                 for _ in range(3)]
        delta = torch.empty((b, h, s))
        assert bwd(ptr(q), ptr(k), ptr(v), ptr(o), ptr(do), ptr(lse),
                   ptr(seg), *map(ptr, grads), ptr(delta), b, h, s, d,
                   fa._strides(q, k, v, o, do), int(causal), scale, 0,
                   None) == 0
        o_r, lse_r = fwd_ref(q, k, v, seg, causal=causal, sm_scale=scale)
        grads_r = bwd_ref(q, k, v, o, do, lse, seg, causal=causal,
                          sm_scale=scale)
        finite = torch.isfinite(lse_r)
        errs = {"o": err(o, o_r, rel),
                "lse": err(lse[finite], lse_r[finite], False),
                "lse_inf_mismatch": int((torch.isfinite(lse) != finite)
                                        .sum())}
        errs.update({n: err(g, w, rel) for n, g, w in
                     zip(("dq", "dk", "dv"), grads, grads_r)})
        out[source] = errs
    print(json.dumps(out))


if __name__ == "__main__":
    lib_dir, *nums, dtype_name = sys.argv[1:]
    b, h, s, d, causal, segmented = map(int, nums)
    main(lib_dir, b, h, s, d, bool(causal), bool(segmented), dtype_name)
