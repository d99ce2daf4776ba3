"""One case of tests/test_torch_decode_emulated.py, in its own process (a
hung emulation cannot stall the suite): the g++-built K3 and K4
libraries (``libragged_decode.so``, ``libpaged_decode.so`` in LIB_DIR)
on seeded ``[SLOTS, H, T, D]`` caches in DTYPE at LENGTHS, split as
``decode_plan(..., SMS)`` splits them. OFFSET > 0 starts K and V that
many elements into their buffers. Reports K3's error against the port's
plain version, whether two K3 calls are bitwise equal, and for each of
PAGES whether K4 on the identity and on a shuffled paged view of the
same cache is bitwise K3's result. Prints one JSON object.

    python _decode_emulation_worker.py LIB_DIR SLOTS H T D DTYPE OFFSET \\
        SMS LENGTHS PAGES        (LENGTHS, PAGES comma-separated)
"""
import ctypes
import json
import math
import sys

import numpy as np
import torch

from bigdl_tpu_torch.kernels.paged_decode import paged_view
from bigdl_tpu_torch.kernels.ragged_decode import (
    decode_plan, ragged_decode_attention_reference)

SUFFIX = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}


def bind(lib_dir, suffix):
    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
    ragged = getattr(ctypes.CDLL(f"{lib_dir}/libragged_decode.so"),
                     f"bigdl_ragged_decode_{suffix}")
    ragged.argtypes = [p] * 6 + [i32] * 7 + [i64] * 10 + [f32, i32, p]
    paged = getattr(ctypes.CDLL(f"{lib_dir}/libpaged_decode.so"),
                    f"bigdl_paged_decode_{suffix}")
    paged.argtypes = [p] * 7 + [i32] * 8 + [i64] * 10 + [f32, i32, p]
    ragged.restype = paged.restype = i32
    return ragged, paged


def scratch(plan, slots, h, d):
    """Partials filled with NaN, so a read of one never written shows."""
    if plan.splits == 1:
        return None
    return torch.full((slots, h, plan.splits, d + 2), float("nan"))


def shuffled(rng, k_pages, v_pages, table):
    """The same paged view with the pool's pages permuted and the table
    renumbered to follow them."""
    perm = torch.from_numpy(rng.permutation(k_pages.shape[0]))
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel())
    return (k_pages[inv], v_pages[inv],
            perm[table.long()].to(torch.int32).contiguous())


def main(lib_dir, slots, h, t, d, dtype_name, offset, sms, lengths, pages):
    dtype = getattr(torch, dtype_name)
    ragged, paged = bind(lib_dir, SUFFIX[dtype_name])
    rng = np.random.default_rng(slots * 1009 + t * 31 + d)
    q = torch.from_numpy(rng.standard_normal((slots, h, d))
                         .astype(np.float32)).to(dtype)

    def cache():
        flat = torch.from_numpy(rng.standard_normal(slots * h * t * d + offset)
                                .astype(np.float32)).to(dtype)
        return flat[offset:].view(slots, h, t, d)

    k, v = cache(), cache()
    lens = torch.tensor(lengths, dtype=torch.int32)
    plan = decode_plan(slots, h, t, d, q.element_size(), sms)
    scale = 1.0 / math.sqrt(d)

    def run_k3():
        out = torch.full((slots, h, d), float("nan")).to(dtype)
        part = scratch(plan, slots, h, d)
        rc = ragged(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    lens.data_ptr(), out.data_ptr(),
                    None if part is None else part.data_ptr(),
                    slots, h, t, d, plan.stage_keys, plan.chunk, plan.splits,
                    q.stride(0), q.stride(1), *k.stride()[:3],
                    *v.stride()[:3], out.stride(0), out.stride(1), scale, 0,
                    None)
        return rc, out

    def run_k4(kp, vp, table):
        out = torch.full((slots, h, d), float("nan")).to(dtype)
        part = scratch(plan, slots, h, d)
        rc = paged(q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                   table.data_ptr(), lens.data_ptr(), out.data_ptr(),
                   None if part is None else part.data_ptr(),
                   slots, h, table.shape[1], kp.shape[2], d, plan.stage_keys,
                   plan.chunk, plan.splits, q.stride(0), q.stride(1),
                   *kp.stride()[:3], *vp.stride()[:3], out.stride(0),
                   out.stride(1), scale, 0, None)
        return rc, out

    rc, got = run_k3()
    rc2, again = run_k3()
    want = ragged_decode_attention_reference(q, k, v, lens, scale)
    diff = (got.float() - want.float()).abs()
    if dtype != torch.float32:
        diff = diff / want.float().abs().clamp(min=1.0)
    paged_equal = {}
    for page in pages:
        view = paged_view(k, v, page)
        for label, (kp, vp, table) in (("identity", view),
                                       ("shuffled", shuffled(rng, *view))):
            rc_p, out = run_k4(kp, vp, table)
            paged_equal[f"{page}/{label}"] = rc_p == 0 and bool(
                torch.equal(out, got))
    print(json.dumps({"rc": [rc, rc2], "plan": list(plan[:3]),
                      "err": float(diff.nan_to_num(float("inf")).max()),
                      "repeat_equal": bool(torch.equal(got, again)),
                      "paged_equal": paged_equal}))


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0], *map(int, a[1:5]), a[5], int(a[6]), int(a[7]),
         [int(x) for x in a[8].split(",")],
         [int(x) for x in a[9].split(",") if x])
