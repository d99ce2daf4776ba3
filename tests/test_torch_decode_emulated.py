"""The decode kernels' CUDA sources (K3 ``kernels/csrc/ragged_decode.cu``
and K4 ``paged_decode.cu``, over ``decode_common.cuh``), run on the CPU.

No card or nvcc is here, so this file compiles them with g++ against
``_cuda_emulation.h`` (``_emulated_cuda.py`` has the rewrites): each
CUDA thread a fiber, the warp shuffles emulated, ``cp.async`` as a
plain copy. So the split plan (``decode_plan``), the blocks' key
chunks, the cp.async ring and its wrap, the 16-byte and the element
copy paths, the zero-filled rows and columns, the warps' and the
splits' merges and K4's staged table slice run as written. Each K3
result is held to the port's plain version at ``chip_smoke.py``'s
``RAGGED_TOL`` (float32 absolute; bfloat16 and float16 relative to
max(1, |plain|) at 1e-2 and 2e-3), two K3 calls must be bitwise equal,
and K4 on identity and shuffled paged views must be bitwise K3's result
(``torch.equal``), as on the card. What the emulation cannot show:
timing, and a wrong ``cp.async`` wait count (its copies land at once).
Each case runs in its own process under a time limit.
"""
import json
import os
import subprocess
import sys

import pytest

from _emulated_cuda import HERE, build

SOURCES = ("ragged_decode", "paged_decode")
#: inline-PTX helpers of decode_common.cuh and the emulation's stand-in
EMULATED = {
    "void cp_async16(": "emu_copy(dst, src, true, 16);",
    "void cp_async_commit()": "",
    "void cp_async_wait()": "",
}
TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2e-3}
CASE_SECONDS = 300


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    """``libragged_decode.so`` and ``libpaged_decode.so`` built with g++
    into a temporary directory (one compiler process each)."""
    files = {"decode_common.cuh": EMULATED}
    files.update({f"{name}.cu": {} for name in SOURCES})
    return build(tmp_path_factory.mktemp("decode_emulated"), files, SOURCES)


@pytest.mark.parametrize(
    "slots,h,t,d,dtype,offset,sms,lengths,pages,splits", [
        # four splits of 64 keys: lengths 1, a chunk edge, T, 0 and
        # past T (both clamped)
        (6, 2, 256, 64, "float32", 0, 8, "1,64,65,256,0,300", "16,64", 4),
        (4, 2, 100, 32, "float32", 0, 1, "100,37,3,0", "", 1),  # one split
        (4, 2, 192, 48, "bfloat16", 0, 8, "1,64,150,500", "16", 3),
        # 40-byte rows from an odd offset: the element copy path; pages
        # of 16 and 7 rows
        (3, 2, 112, 20, "float16", 3, 4, "5,64,112", "16,7", 2),
        (4, 2, 112, 64, "float32", 0, 16, "1,57,112,200", "16,7", 2),
        # 10 stages a chunk through the ring of 3
        (2, 1, 1024, 64, "float32", 0, 1, "1000,700", "64", 4),
        # head_dim 256 in float32: 8-key stages, two keys a warp
        (1, 1, 512, 256, "float32", 0, 1, "500", "", 8),
    ])
def test_decode_kernels_emulated(emulated_libs, slots, h, t, d, dtype,
                                 offset, sms, lengths, pages, splits):
    proc = subprocess.run(
        [sys.executable, str(HERE / "_decode_emulation_worker.py"),
         str(emulated_libs), *map(str, (slots, h, t, d)), dtype,
         str(offset), str(sms), lengths, pages],
        capture_output=True, text=True, timeout=CASE_SECONDS,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(HERE.parent), os.environ.get("PYTHONPATH", "")])})
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["rc"] == [0, 0], got
    assert got["plan"][2] == splits, got
    assert got["err"] <= TOL[dtype], got
    assert got["repeat_equal"], got
    expected = {f"{p}/{label}" for p in pages.split(",") if p
                for label in ("identity", "shuffled")}
    assert set(got["paged_equal"]) == expected, got
    assert all(got["paged_equal"].values()), got
