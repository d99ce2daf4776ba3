"""Fused dequant int8 GEMM — the BigQuant story's serving kernel
(counterpart of ``bigdl_tpu.kernels.int8_gemm``).

``out = (x_q [M, K] int8 @ w_q [N, K] int8 ^T) * x_scale[M] * w_scale[N]``
in float32: int8 products, int32 accumulation, and the dequant
epilogue fused so the int32 accumulator never goes to device memory.
The kernel is CUDA C++ for Hopper (``csrc/int8_gemm.cu``; its header
note has the design and the bound); :func:`int8_gemm_reference` is its
plain PyTorch version — the exact integer product of
:mod:`bigdl_tpu_torch.ops.quant` followed by the same epilogue.

**Bitwise contract:** integer accumulation is exact in any order and
the epilogue multiplies in the plain version's order, so the kernel is
equal (``torch.equal``) to dequantize-then-matmul at every shape. The
bias add stays outside, in the dispatch layer's one add.

**Every shape.** The JAX dispatch takes its kernel only at ``M % 256 ==
N % 256 == 0`` and ``K % 512 == 0`` on a compiled backend, a gate that
fits the TPU's matrix unit and not the card: at ResNet-50's classifier
(``M <= 64``, ``N = 1000``, ``K = 2048``) it would decline, so the
kernel would never run. The port carries no such gate: the kernel masks
its edge tiles and takes any ``M, N, K >= 1``, as the JAX package's
interpret mode does.

:func:`int8_gemm` runs the plain version for tensors on the CPU, and
launches the kernel for CUDA tensors or raises: there is no fallback
from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import torch

from bigdl_tpu_torch.ops.quant import int8_matmul

__all__ = ["GemmPlan", "cuda_unsupported", "gemm_plan", "int8_gemm",
           "int8_gemm_reference"]

#: the kernel's block tiles by their rows (its ``tile`` argument): rows,
#: columns and the bytes of K a pipeline stage holds (split-K splits at
#: whole stages); ``csrc/int8_gemm.cu``'s SmallTile and LargeTile
_TILES = {64: (64, 64, 64), 128: (128, 256, 128)}
#: the kernel's grid rows: ceil(M / 128) blocks past 64 rows, at most
#: 65535
_MAX_ROWS = 65535 * 128


class GemmPlan(NamedTuple):
    """How one K5 call runs: block tiles of ``tile`` rows (64 x 64 for
    M <= 64, else 128 x 256), K split into ``splits`` runs of ``steps``
    stages, on a ``grid`` of (N tiles, M tiles, splits) blocks."""
    tile: int
    splits: int
    steps: int
    grid: tuple


def gemm_plan(m: int, n: int, k: int, sms: int = 132) -> GemmPlan:
    """The block tile and the K split of an ``[M, K] x [N, K]^T`` call
    on a card of ``sms`` SMs: the output tiles alone when they give
    every SM a block (or K is one stage), else K split into runs of
    whole stages, enough runs that tiles x runs >= ``sms``."""
    tile = 64 if m <= 64 else 128
    rows, cols, stage = _TILES[tile]
    grid_n, grid_m = -(-n // cols), -(-m // rows)
    total = -(-k // stage)
    splits = 1
    if grid_n * grid_m < sms and total > 1:
        want = -(-sms // (grid_n * grid_m))
        steps = max(1, total // want)
        splits = -(-total // steps)
    steps = -(-total // splits)
    return GemmPlan(tile, splits, steps, (grid_n, grid_m, splits))


def int8_gemm_reference(x_q, w_q, x_scale, w_scale):
    """Plain PyTorch fused dequant GEMM: the exact int32 product
    ``x_q @ w_q^T`` times ``x_scale [M]`` (per row) times ``w_scale
    [N]`` (per column), float32, in that order."""
    acc = int8_matmul(x_q, w_q)
    return (acc.float() * x_scale.reshape(-1, 1).float()
            * w_scale.reshape(1, -1).float())


def _check_shapes(x_q, w_q, x_scale, w_scale) -> None:
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"int8_gemm takes x_q [M, K] and w_q [N, K], got "
                         f"{tuple(x_q.shape)} / {tuple(w_q.shape)}")
    m, n = x_q.shape[0], w_q.shape[0]
    if x_scale.numel() != m or w_scale.numel() != n:
        raise ValueError(f"int8_gemm scales must have M={m} / N={n} "
                         f"elements, got {tuple(x_scale.shape)} / "
                         f"{tuple(w_scale.shape)}")


def cuda_unsupported(x_q, w_q, x_scale, w_scale) -> Optional[str]:
    """Why the CUDA kernel does not take these operands (None when it
    does): int8 ``[M, K]`` / ``[N, K]`` contiguous, float32 contiguous
    scales, one device, ``K >= 1`` and at most ``65535 * 128`` rows."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        return f"x_q/w_q must be int8, got {x_q.dtype}/{w_q.dtype}"
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        return (f"scales must be float32, got {x_scale.dtype}/"
                f"{w_scale.dtype}")
    for name, t in (("x_q", x_q), ("w_q", w_q), ("x_scale", x_scale),
                    ("w_scale", w_scale)):
        if t.device != x_q.device:
            return f"{name} is on {t.device}, x_q on {x_q.device}"
        if not t.is_contiguous():
            return f"{name} must be contiguous (strides {t.stride()})"
    if x_q.shape[1] < 1:
        return "K must be >= 1"
    if x_q.shape[0] > _MAX_ROWS:
        return f"M={x_q.shape[0]} exceeds the grid's {_MAX_ROWS} rows"
    return None


_lib_lock = threading.Lock()
_launch_lock = threading.Lock()
_lib = None


def _library():
    """The built kernel library with its ctypes signature (built from
    ``csrc/int8_gemm.cu`` at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from bigdl_tpu_torch.kernels import _build

            lib = _build.load("int8_gemm")
            p, i32 = ctypes.c_void_p, ctypes.c_int
            lib.bigdl_int8_gemm.argtypes = [p, p, p, p, p, p, i32, i32,
                                            i32, i32, i32, i32, p]
            lib.bigdl_int8_gemm.restype = i32
            lib.bigdl_cuda_error_string.argtypes = [i32]
            lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def int8_gemm(x_q, w_q, x_scale, w_scale):
    """Fused int8 GEMM + dequant: ``x_q [M, K] int8``, ``w_q [N, K]
    int8``, per-row ``x_scale [M]`` and per-channel ``w_scale [N]``
    float32 → ``[M, N]`` float32 (module docstring has the contract).

    CPU tensors run :func:`int8_gemm_reference`. CUDA tensors launch
    the kernel on the calling thread's current stream (split K as
    :func:`gemm_plan` says, with split-K's partial sums in scratch
    allocated for the call), or raise ValueError on operands it does not
    take (:func:`cuda_unsupported`); each launch adds one to
    ``int8_gemm.launches``."""
    _check_shapes(x_q, w_q, x_scale, w_scale)
    if x_q.device.type == "cpu":
        return int8_gemm_reference(x_q, w_q, x_scale, w_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cuda or cpu, not "
                         f"{x_q.device}")
    why = cuda_unsupported(x_q, w_q, x_scale, w_scale)
    if why is not None:
        raise ValueError(f"int8_gemm kernel: {why}")
    m, k = x_q.shape
    n = w_q.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x_q.device)
    if m == 0 or n == 0:
        return out
    plan = gemm_plan(m, n, k, torch.cuda.get_device_properties(
        x_q.device).multi_processor_count)
    # split-K's int32 partial sums: scratch of this call, on the current
    # stream (nothing is kept across calls)
    partials = (torch.empty((plan.splits, m, n), dtype=torch.int32,
                            device=x_q.device) if plan.splits > 1 else None)
    lib = _library()
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    rc = lib.bigdl_int8_gemm(x_q.data_ptr(), w_q.data_ptr(),
                             x_scale.data_ptr(), w_scale.data_ptr(),
                             out.data_ptr(),
                             None if partials is None
                             else partials.data_ptr(),
                             m, n, k, plan.tile, plan.splits,
                             x_q.device.index, stream)
    if rc != 0:
        msg = lib.bigdl_cuda_error_string(rc).decode()
        raise RuntimeError(f"int8_gemm kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    with _launch_lock:
        int8_gemm.launches += 1
    return out


#: kernel launches so far (plain-version calls on the CPU do not count)
int8_gemm.launches = 0
