"""The flash-attention kernels' CUDA sources, run on the CPU.

No card or nvcc is here, so this file compiles the port's own
``kernels/csrc/flash_attention.cu`` and ``blockwise_flash_attention.cu``
(with ``flash_common.cuh``) with g++ against ``_cuda_emulation.h``: each
CUDA thread a fiber, mma.sync, ldmatrix, the warp shuffles and
``__syncthreads_or`` emulated from the PTX and CUDA definitions,
cp.async as a plain copy (``_emulated_cuda.py`` has the mechanical
rewrites). So the kernels' index arithmetic, fragment layouts, masking,
edge tiles, the cp.async rings, the float32 kernels' 3xTF32 split, the
16-bit kernels' m16n8k16 products (ldmatrix plain and transposed, p and
dS split into hi + lo in the input dtype, the plain-load staging path
where rows are not 16-byte aligned) and the segment-aware tile skipping
of K1's forward and of the 16-bit backward run as written, and are held
to the port's plain versions at ``chip_smoke.py``'s tolerances (1e-5
for O and lse, 2e-4 for the float32 gradients; bfloat16 and float16
relative to max(1, |plain|) at 1e-2 and 2e-3). K1's forward and the
16-bit backward's dK/dV and dQ kernels must also have computed exactly
the (query tile, key tile) pairs that the segment ids keep, and on
packed documents fewer than all. Timing and the hardware's own rounding
inside an MMA are the card's to show (``chip_smoke.py``). Each case runs
in its own process under a time limit. Alone:
``python -m pytest tests/test_torch_flash_emulated.py -q``.
"""
import json
import os
import subprocess
import sys

import pytest

from _emulated_cuda import HERE, build

SOURCES = ("flash_attention", "blockwise_flash_attention")
#: inline-PTX helpers of flash_common.cuh and the emulation's stand-in
EMULATED = {
    "void mma_tf32(": "emu_mma(c, a, b);",
    "void ldmatrix_x4(": "emu_ldmatrix_x4(x, row);",
    "void cp_async16(": "emu_copy(dst, src, in, 16);",
    "void cp_async4(": "emu_copy(dst, src, in, 4);",
    "void cp_async_commit()": "",
    "void cp_async_wait()": "",
    "void mma_bf16(": "emu_mma16<__nv_bfloat16>(c, a, b);",
    "void mma_f16(": "emu_mma16<__half>(c, a, b);",
    "uint32_t pack_bf16x2(": "return emu_pack16<__nv_bfloat16>(lo, hi);",
    "uint32_t pack_f16x2(": "return emu_pack16<__half>(lo, hi);",
    "void ldsm_x4(": "emu_ldmatrix_x4(x, row);",
    "void ldsm_x4_trans(": "emu_ldmatrix_x4_trans(x, row);",
    "float exp2_ftz(": "return emu_exp2_ftz(x);",
}
FWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2, "float16": 2e-3}
BWD_TOL = {"float32": 2e-4, "bfloat16": 1e-2, "float16": 2e-3}
CASE_SECONDS = 300


@pytest.fixture(scope="module")
def emulated_libs(tmp_path_factory):
    """``lib<source>.so`` of both sources, built with g++ into a
    temporary directory (one compiler process each, in parallel)."""
    files = {"flash_common.cuh": EMULATED}
    files.update({f"{name}.cu": {} for name in SOURCES})
    return build(tmp_path_factory.mktemp("flash_emulated"), files, SOURCES)


@pytest.mark.parametrize("b,h,s,d,causal,segmented,dtype", [
    (2, 3, 19, 64, True, True, "float32"),     # one ragged tile
    (1, 1, 130, 64, False, False, "float32"),  # three tiles: the ring
    (1, 1, 77, 100, True, True, "float32"),    # D = 128, padded columns
    (2, 2, 33, 8, True, False, "bfloat16"),    # D = 16, converting stage
    (1, 1, 70, 80, False, True, "float16"),
    (1, 1, 65, 3, True, False, "float32"),     # 4-byte cp.async
    # packed documents: K1's forward skips whole key tiles of other
    # segments (and the pad's), causal and not
    (1, 1, 300, 32, True, "packed", "float32"),
    (1, 1, 260, 16, False, "packed", "float32"),
    (1, 1, 200, 128, True, "packed", "float32"),   # skipping at D = 128
    (1, 1, 200, 64, True, "packed", "bfloat16"),   # skipping in bfloat16
    # the 16-bit kernels (m16n8k16, ldmatrix.trans, p and dS split into
    # hi + lo) at each tile width, both dtypes; their backward skips
    # tiles too. Ragged S, a head_dim that runs zero-padded, and d = 3
    # and 100 (no 16-byte rows: the plain-load staging path).
    (1, 2, 200, 16, True, "packed", "bfloat16"),
    (2, 1, 70, 16, False, False, "float16"),
    (1, 1, 150, 32, False, "packed", "float16"),
    (1, 2, 64, 24, True, True, "bfloat16"),
    (1, 1, 256, 64, True, "packed", "float16"),
    (1, 1, 260, 64, False, "packed", "bfloat16"),
    (1, 1, 130, 128, True, "packed", "bfloat16"),
    (1, 1, 190, 128, False, True, "float16"),
    (2, 1, 100, 3, True, False, "bfloat16"),
    (1, 1, 150, 100, True, "packed", "float16"),
])
def test_flash_kernels_emulated_match_plain(emulated_libs, b, h, s, d,
                                            causal, segmented, dtype):
    mode = {False: 0, True: 1, "packed": 2}[segmented]
    proc = subprocess.run(
        [sys.executable, str(HERE / "_flash_emulation_worker.py"),
         str(emulated_libs), *map(str, (b, h, s, d, int(causal), mode)),
         dtype],
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
    k1 = errors["flash_attention"]
    # K1's forward, and the 16-bit backward's dK/dV and dQ kernels,
    # computed exactly the tile pairs the ids keep (the float32 backward
    # computes every causal pair and counts none)
    bwd_pairs = k1["kept_tile_pairs"] if dtype != "float32" else 0
    assert k1["tile_pairs"] == k1["kept_tile_pairs"], k1
    assert k1["dkv_tile_pairs"] == k1["dq_tile_pairs"] == bwd_pairs, k1
    if segmented == "packed":
        assert k1["kept_tile_pairs"] < k1["all_tile_pairs"], k1
