"""The flash-attention kernels' CUDA sources, run on the CPU.

No card or nvcc is here, so this file compiles the port's own
``kernels/csrc/flash_attention.cu`` and ``blockwise_flash_attention.cu``
(with ``flash_common.cuh``) with g++ against ``_cuda_emulation.h``: each
CUDA thread a std::thread, mma.sync, ldmatrix and the warp shuffles
emulated from the PTX fragment layouts, cp.async as a plain copy. The
only rewrites are mechanical: the inline-PTX helpers' bodies become the
emulation's calls, ``kernel<<<...>>>(...)`` an ``emu_launch``, and
``extern __shared__`` a pointer to the block's buffer. So the kernels'
index arithmetic, fragment layouts, masking, edge tiles, the cp.async
ring and the 3xTF32 split run as written, and are held to the port's
plain versions at ``chip_smoke.py``'s tolerances (1e-5 for O and lse,
2e-4 for the float32 gradients; bfloat16 and float16 relative to
max(1, |plain|) at 1e-2 and 2e-3). Timing and the hardware's own
rounding inside an MMA are the card's to show (``chip_smoke.py``).
Each case runs in its own process under a time limit.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "bigdl_tpu_torch" / "kernels" / "csrc"
SOURCES = ("flash_attention", "blockwise_flash_attention")
#: inline-PTX helpers of flash_common.cuh and the emulation's stand-in
EMULATED = {
    "void mma_tf32(": "emu_mma(c, a, b);",
    "void ldmatrix_x4(": "emu_ldmatrix_x4(x, row);",
    "void cp_async16(": "emu_copy(dst, src, in, 16);",
    "void cp_async4(": "emu_copy(dst, src, in, 4);",
    "void cp_async_commit()": "",
    "void cp_async_wait()": "",
}
FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2e-3}
BWD_TOL = {"float32": 2e-4, "bfloat16": 1e-2, "float16": 2e-3}
CASE_SECONDS = 300


def _replace_body(src: str, signature: str, body: str) -> str:
    start = src.index("{", src.index(signature))
    depth = 0
    for end in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            return src[:start] + "{ " + body + " }" + src[end + 1:]
    raise ValueError(f"unbalanced body of {signature}")


def _emulated_source(text: str, header: bool) -> str:
    text = re.sub(r"//[^\n]*", "", text)
    if header:
        for signature, body in EMULATED.items():
            text = _replace_body(text, signature, body)
    text = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?float (\w+)\[\];",
                  r"float* \1 = emu_smem;", text)
    return re.sub(r"([\w:]+(?:<[\w\s,]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);",
                  r"emu_launch(\1, \2, \3);", text, flags=re.S)


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    """``lib<source>.so`` of both sources, built with g++ into a
    temporary directory (one compiler process each, in parallel)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("g++ is not installed: the emulated kernels need it")
    out = tmp_path_factory.mktemp("flash_emulated")
    (out / "flash_common.cuh").write_text(_emulated_source(
        (CSRC / "flash_common.cuh").read_text(), header=True))
    for name in ("cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h",
                 "math_constants.h"):
        (out / name).write_text("#pragma once\n")
    for name in SOURCES:
        (out / f"{name}.cu").write_text(_emulated_source(
            (CSRC / f"{name}.cu").read_text(), header=False))

    def build(name):
        return subprocess.run(
            [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
             "-include", str(HERE / "_cuda_emulation.h"), f"-I{out}",
             "-x", "c++", str(out / f"{name}.cu"), "-o",
             str(out / f"lib{name}.so")], capture_output=True, text=True,
            timeout=600)

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        for proc in pool.map(build, SOURCES):
            assert proc.returncode == 0, proc.stderr[-4000:]
    return out


@pytest.mark.parametrize("b,h,s,d,causal,segmented,dtype", [
    (2, 3, 19, 64, True, True, "float32"),     # one ragged tile
    (1, 1, 130, 64, False, False, "float32"),  # three tiles: the ring
    (1, 1, 77, 100, True, True, "float32"),    # D = 128, padded columns
    (2, 2, 33, 8, True, False, "bfloat16"),    # D = 16, converting stage
    (1, 1, 70, 80, False, True, "float16"),
    (1, 1, 65, 3, True, False, "float32"),     # 4-byte cp.async
])
def test_flash_kernels_emulated_match_plain(emulated_libs, b, h, s, d,
                                            causal, segmented, dtype):
    proc = subprocess.run(
        [sys.executable, str(HERE / "_flash_emulation_worker.py"),
         str(emulated_libs), *map(str, (b, h, s, d, int(causal),
                                        int(segmented))), dtype],
        capture_output=True, text=True, timeout=CASE_SECONDS,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            [str(HERE.parent), os.environ.get("PYTHONPATH", "")])})
    assert proc.returncode == 0, proc.stderr[-4000:]
    errors = json.loads(proc.stdout.strip().splitlines()[-1])
    for source, errs in errors.items():
        limits = {"o": FWD_TOL[dtype], "lse": FWD_TOL["float32"],
                  "lse_inf_mismatch": 0, "dq": BWD_TOL[dtype],
                  "dk": BWD_TOL[dtype], "dv": BWD_TOL[dtype]}
        assert all(errs[n] <= limits[n] for n in limits), (source, errs)
