"""K5's CUDA source (``kernels/csrc/int8_gemm.cu``), run on the CPU.

No card or nvcc is here, so this file compiles the kernel with g++
against ``_cuda_emulation.h`` (``_emulated_cuda.py`` has the rewrites):
each CUDA thread a fiber, ``mma.sync.m16n8k32`` s8 and ``ldmatrix`` of
byte rows emulated from the PTX fragment layouts, ``cp.async`` as a
plain copy. The kernel uses no ``wgmma`` or TMA, so every instruction
path of it runs here: both block tiles, the cp.async rings and the byte
path (K not a multiple of 16, an unaligned x_q), split-K with its
partial sums and second kernel, ragged M/N/K. Each result must be
bitwise (``torch.equal``) the port's plain version, as on the card.
What the emulation cannot show: timing, and a wrong ``cp.async`` wait
count (its copies land at once). Each case runs in its own process
under a time limit.
"""
import json
import os
import subprocess
import sys

import pytest

from _emulated_cuda import HERE, build

#: inline-PTX helpers of int8_gemm.cu and the emulation's stand-in
EMULATED = {
    "void mma_s8(": "emu_mma_s8(d, a, b);",
    "void ldmatrix_x4(": "emu_ldmatrix_x4(x, row);",
    "void cp_async16(": "emu_copy(dst, src, in, 16);",
    "void cp_async_commit()": "",
    "void cp_async_wait()": "",
}
CASE_SECONDS = 300


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    """``libint8_gemm.so`` built with g++ into a temporary directory."""
    return build(tmp_path_factory.mktemp("int8_emulated"),
                 {"int8_gemm.cu": EMULATED}, ("int8_gemm",))


@pytest.mark.parametrize("m,n,k,sms,offset,tile,splits", [
    (70, 37, 200, 1, 0, 128, 1),    # 128 tile, ragged M/N, K % 16 = 8
    (33, 70, 160, 1, 0, 64, 1),     # 64 tile, cp.async ring, 2.5 steps
    (33, 70, 160, 1, 1, 64, 1),     # unaligned x_q: byte path
    (5, 40, 512, 132, 0, 64, 8),    # split-K, one step a split
    (130, 72, 300, 132, 0, 128, 3),  # split-K on the byte path
    (20, 24, 4100, 8, 0, 64, 9),    # uneven split: the last run 1 step
    (1, 1, 1, 132, 0, 64, 1),
])
def test_int8_kernel_emulated_bitwise_plain(emulated_lib, m, n, k, sms,
                                            offset, tile, splits):
    proc = subprocess.run(
        [sys.executable, str(HERE / "_int8_emulation_worker.py"),
         str(emulated_lib), *map(str, (m, n, k, sms, offset))],
        capture_output=True, text=True, timeout=CASE_SECONDS,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(HERE.parent), os.environ.get("PYTHONPATH", "")])})
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (got["rc"], got["tile"], got["splits"]) == (0, tile, splits)
    assert got["equal"], got
