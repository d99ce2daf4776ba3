"""One case of tests/test_torch_flash_emulated.py, in its own process (a
hung emulation cannot stall the suite): the g++-built K1 and K2 libraries
(``lib<source>.so`` in LIB_DIR) against the port's plain versions on the
same seeded inputs, forward (O, lse) and backward (dq, dk, dv). SEGMENTS
is 0 (none), 1 (sorted random ids 1-3) or 2 (packed documents of 20-90
rows, then pad id 0, as the packed training rows are). For each source
it also reports the (query tile, key tile) pairs its forward computed
(K1's in every dtype, K2's 16-bit forward's), the pairs its 16-bit
backward's dK/dV and dQ kernels computed (the float32 kernels count
none), and the pairs the segment ids keep. Prints one JSON object.

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


def packed_segments(rng, b, s):
    """Documents of 20-90 rows numbered from 1, the last 15% pad id 0."""
    seg = np.zeros((b, s), np.int32)
    for row in seg:
        pos, doc = 0, 1
        while pos < s * 0.85:
            n = int(rng.integers(20, 91))
            row[pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
        row[int(s * 0.85):] = 0
    return seg


def kept_tile_pairs(seg, b, h, s, causal):
    """(query tile, key tile) pairs of 64 a K1 forward computes: under
    causal the tiles up to the diagonal, and with segment ids only those
    where some query and key share an id (the diagonal always)."""
    n = -(-s // 64)
    total = 0
    for row in range(b):
        for i in range(n):
            for j in range(i + 1 if causal else n):
                total += (seg is None or (causal and j == i)
                          or np.intersect1d(
                              seg[row, i * 64:(i + 1) * 64],
                              seg[row, j * 64:(j + 1) * 64]).size > 0)
    return total * h


def ptr(x):
    return None if x is None else x.data_ptr()


def err(got, want, relative):
    diff = (got.float() - want.float()).abs()
    if relative:
        diff = diff / want.float().abs().clamp(min=1.0)
    return diff.max().item()


def inputs(b, h, s, d, segmented, dtype):
    """The case's seeded ``(q, k, v, dO, segment ids or None)``: q, k, v
    as the attention layer hands them over, [B, S, H, D] -> [B, H, S, D]
    strided views."""
    rng = np.random.default_rng(b * 1000 + s * 10 + d)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d))
                                .astype(np.float32)).to(dtype).transpose(1, 2)
               for _ in range(3))
    do = torch.from_numpy(rng.standard_normal((b, h, s, d))
                          .astype(np.float32)).to(dtype)
    seg = None
    if segmented == 1:
        seg = torch.from_numpy(np.sort(rng.integers(1, 4, (b, s)), axis=1)
                               .astype(np.int32))
    elif segmented == 2:
        seg = torch.from_numpy(packed_segments(rng, b, s))
    return q, k, v, do, seg


def main(lib_dir, b, h, s, d, causal, segmented, dtype_name):
    dtype = getattr(torch, dtype_name)
    q, k, v, do, seg = inputs(b, h, s, d, segmented, dtype)
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
        lib = ctypes.CDLL(f"{lib_dir}/lib{source}.so")
        pairs = ctypes.c_ulonglong(0)
        assert getattr(lib, f"{prefix}_tile_pairs")(
            0, ctypes.byref(pairs)) == 0
        errs["tile_pairs"] = pairs.value
        bwd_pairs = (ctypes.c_ulonglong * 2)()
        assert getattr(lib, f"{prefix}_bwd_tile_pairs")(0, bwd_pairs) == 0
        errs["dkv_tile_pairs"], errs["dq_tile_pairs"] = bwd_pairs
        errs["kept_tile_pairs"] = kept_tile_pairs(
            None if seg is None else seg.numpy(), b, h, s, causal)
        errs["all_tile_pairs"] = kept_tile_pairs(None, b, h, s, causal)
        out[source] = errs
    print(json.dumps(out))


if __name__ == "__main__":
    # the plain versions on one thread: on 8, K1's plain lse came out
    # 3.2e-5 to 4.7e-5 off now and then, while the kernels agreed with
    # each other to 1e-6 (cause unknown; the file's
    # test_plain_versions_on_eight_threads_match_float64 holds the
    # plain versions on 8 threads to float64)
    torch.set_num_threads(1)
    lib_dir, *nums, dtype_name = sys.argv[1:]
    b, h, s, d, causal, segmented = map(int, nums)
    main(lib_dir, b, h, s, d, bool(causal), segmented, dtype_name)
