"""One case of tests/test_torch_int8_emulated.py, in its own process (a
hung emulation cannot stall the suite): the g++-built K5 library
(``libint8_gemm.so`` in LIB_DIR) against the port's plain version on the
same seeded operands, split as ``gemm_plan(M, N, K, SMS)`` splits it.
OFFSET > 0 starts x_q that many bytes into its buffer (rows not 16-byte
aligned). Prints one JSON object.

    python _int8_emulation_worker.py LIB_DIR M N K SMS OFFSET
"""
import ctypes
import json
import sys

import numpy as np
import torch

from bigdl_tpu_torch.kernels.int8_gemm import gemm_plan, int8_gemm_reference


def main(lib_dir, m, n, k, sms, offset):
    lib = ctypes.CDLL(f"{lib_dir}/libint8_gemm.so")
    p, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.bigdl_int8_gemm
    fn.argtypes = [p] * 6 + [i32] * 6 + [p]
    fn.restype = i32
    rng = np.random.default_rng(m * 10007 + n * 101 + k)
    buf = torch.from_numpy(rng.integers(-127, 128, m * k + offset)
                           .astype(np.int8))
    x = buf[offset:].view(m, k)
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    xs = torch.from_numpy(rng.random(m).astype(np.float32) * 0.1 + 1e-3)
    ws = torch.from_numpy(rng.random(n).astype(np.float32) * 0.1 + 1e-3)
    plan = gemm_plan(m, n, k, sms)
    out = torch.full((m, n), float("nan"))
    partials = (torch.full((plan.splits, m, n), -(2 ** 31), dtype=torch.int32)
                if plan.splits > 1 else None)
    rc = fn(x.data_ptr(), w.data_ptr(), xs.data_ptr(), ws.data_ptr(),
            out.data_ptr(), None if partials is None else partials.data_ptr(),
            m, n, k, plan.tile, plan.splits, 0, None)
    want = int8_gemm_reference(x, w, xs, ws)
    print(json.dumps({"rc": rc, "tile": plan.tile, "splits": plan.splits,
                      "equal": bool(torch.equal(out, want)),
                      "max_diff": float((out - want).abs().nan_to_num(
                          float("inf")).max())}))


if __name__ == "__main__":
    main(sys.argv[1], *map(int, sys.argv[2:]))
