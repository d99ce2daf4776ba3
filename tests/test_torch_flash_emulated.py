"""The flash-attention kernels' CUDA sources, run on the CPU.

No card or nvcc is here, so this file compiles the port's own
``kernels/csrc/flash_attention.cu`` and ``blockwise_flash_attention.cu``
(with ``flash_common.cuh``) with g++ against ``_cuda_emulation.h``: each
CUDA thread a fiber, mma.sync, wgmma, ldmatrix, the warp shuffles and
``__syncthreads_or`` emulated from the PTX and CUDA definitions,
cp.async as a plain copy (``_emulated_cuda.py`` has the mechanical
rewrites). So the kernels' index arithmetic, fragment layouts, masking,
edge tiles, the cp.async rings, the float32 kernels' 3xTF32 split, the
16-bit forwards' m16n8k16 products (ldmatrix plain and transposed, P
split into hi + lo in the input dtype, the plain-load staging path where
rows are not 16-byte aligned), the 16-bit backward's wgmma products (K1
and K2 launch the same kernels: swizzled tiles read through matrix
descriptors, which the emulation decodes, and p and dS split into hi +
lo as the register operand) and the segment-aware tile skipping run as
written, and are held to the port's plain versions at
``chip_smoke.py``'s tolerances (1e-5 for O and lse, 2e-4 for the
float32 gradients; bfloat16 and float16 relative to max(1, |plain|) at
1e-2 and 2e-3). K1's forward, K2's 16-bit forward (one walk with the
online-softmax carry over a ring of three) and the 16-bit backward's
dK/dV and dQ kernels must also have computed exactly the (query tile,
key tile) pairs that the segment ids keep, and on packed documents
fewer than all. Timing and the hardware's own rounding inside an MMA
are the card's to show (``chip_smoke.py``). Each case runs in its own
process under a time limit. Alone:
``python -m pytest tests/test_torch_flash_emulated.py -q``.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

import _flash_emulation_worker as worker
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
    "void wgmma_ss(": "emu_wgmma_ss<T, N, TransA, TransB>(d, desc_a, desc_b, "
                      "accumulate);",
    "void wgmma_rs(": "emu_wgmma_rs<T, N, TransB>(d, a, desc_b, accumulate);",
    "void wgmma_fence()": "",
    "void wgmma_commit()": "",
    "void wgmma_wait()": "",
    "void fence_async_shared()": "",
    "void fence_operands(": "",
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
    # K2's 16-bit ring of three wrapping (6 key tiles), causal and not
    (1, 1, 330, 64, True, False, "float16"),
    (1, 1, 400, 32, False, "packed", "bfloat16"),
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
        # the whole JSON line, both sources: pytest would cut a dict's
        # repr
        assert all(errs[n] <= limits[n] for n in limits), \
            f"{source}: {json.dumps(errors)}"
    for source, errs in errors.items():
        # the forward (K1's in every dtype, K2's 16-bit one) and the
        # 16-bit backward's dK/dV and dQ kernels computed exactly the
        # tile pairs the ids keep (the float32 kernels of K2 and the
        # float32 backward count none)
        kept = errs["kept_tile_pairs"]
        fwd_pairs = kept if source == "flash_attention" or dtype != \
            "float32" else 0
        bwd_pairs = kept if dtype != "float32" else 0
        assert errs["tile_pairs"] == fwd_pairs, \
            f"{source}: {json.dumps(errs)}"
        assert errs["dkv_tile_pairs"] == errs["dq_tile_pairs"] == \
            bwd_pairs, f"{source}: {json.dumps(errs)}"
        if segmented == "packed":
            assert kept < errs["all_tile_pairs"], \
                f"{source}: {json.dumps(errs)}"


@pytest.mark.parametrize("b,h,s,d,causal,segmented,dtype", [
    (1, 1, 330, 64, True, False, "float16"),
    (1, 1, 256, 64, True, "packed", "float16"),
    (1, 1, 150, 32, False, "packed", "float16"),
    (1, 1, 400, 32, False, "packed", "bfloat16"),
])
def test_plain_versions_on_eight_threads_match_float64(b, h, s, d, causal,
                                                      segmented, dtype):
    """The worker runs the plain versions on one thread. On 8, K1's plain
    lse came out 3.2e-5 to 4.7e-5 off in these cases now and then, with
    cause unknown: here both plain forwards, three calls each on 8
    threads, are held to a float64 computation of the same attention
    (lse within 1e-5, O at the dtype's contract)."""
    mode = {False: 0, True: 1, "packed": 2}[segmented]
    q, k, v, _, seg = worker.inputs(b, h, s, d, mode, getattr(torch, dtype))
    scale = 1.0 / d ** 0.5
    keep = torch.ones((s, s), dtype=torch.bool)
    keep = (keep.tril() if causal else keep)[None, None]
    if seg is not None:
        keep = keep & (seg[:, None, :, None] == seg[:, None, None, :])
    scores = (q.double() * scale) @ k.double().transpose(-1, -2)
    lse64 = torch.logsumexp(scores.masked_fill(~keep, float("-inf")), -1)
    o64 = torch.exp(scores - lse64[..., None]).where(keep, 0.0) @ v.double()
    threads = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        for _, (prefix, fwd_ref, _) in worker.SOURCES.items():
            for _ in range(3):
                o, lse = fwd_ref(q, k, v, seg, causal=causal,
                                 sm_scale=scale)
                errs = {"o": worker.err(o, o64, True),
                        "lse": worker.err(lse, lse64, False)}
                assert errs["o"] <= FWD_TOL[dtype] and \
                    errs["lse"] <= FWD_TOL["float32"], f"{prefix}: {errs}"
    finally:
        torch.set_num_threads(threads)
