"""Ragged decode attention — read only ``lengths[i]`` valid KV rows per
slot (counterpart of ``bigdl_tpu.kernels.ragged_decode``).

One decode token per slot attends its slot's cache slice ``[T, D]``
per head, but only the first ``clamp(lengths[slot], 1, T)`` rows: a
slot 17 tokens into a 512 bucket reads 17 rows, not 512. The kernel is
CUDA C++ for Hopper (``csrc/ragged_decode.cu``; its header note has the
design and the byte bound); :func:`ragged_decode_attention_reference`
is its plain PyTorch version — the online-softmax recurrence of the
TPU kernel over ``block_k`` tiles.

:func:`ragged_decode_attention` runs the plain version for a tensor on
the CPU, and launches the kernel for a CUDA tensor or raises: there is
no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from bigdl_tpu_torch.kernels.common import fit_block

__all__ = ["ragged_decode_attention", "ragged_decode_attention_reference"]

_NEG_INF = float("-inf")


def ragged_decode_attention_reference(q, k, v, lengths,
                                      sm_scale: Optional[float] = None,
                                      block_k: int = 128):
    """Plain PyTorch ragged decode: ``q [slots, H, D]``, ``k``/``v``
    ``[slots, H, T, D]``, ``lengths [slots]`` (clamped into ``[1, T]``)
    → ``[slots, H, D]`` in ``q.dtype``, computed in float32.

    The TPU kernel's recurrence: q is scaled first, key tiles of
    ``block_k`` rows update an online-softmax carry, masked scores are
    ``-inf`` with ``p = 0``. Every slot walks every tile here (no
    per-slot loop bound, so no host sync); a tile past a slot's length
    is an exact no-op for it (``alpha = 1``, ``p = 0``)."""
    slots, h, t, d = k.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bk = fit_block(t, block_k)
    n = lengths.to(device=k.device, dtype=torch.int64).clamp(1, t)
    qs = q.float() * sm_scale
    m = torch.full((slots, h, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((slots, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((slots, h, d), dtype=torch.float32, device=q.device)
    cols = torch.arange(bk, device=k.device)
    for i in range(t // bk):
        kb = k[:, :, i * bk:(i + 1) * bk, :].float()
        vb = v[:, :, i * bk:(i + 1) * bk, :].float()
        valid = (i * bk + cols)[None, None, :] < n[:, None, None]
        s = torch.einsum("shd,shkd->shk", qs, kb)
        s = s.masked_fill(~valid, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # first tile: m = -inf and column 0 is always valid, so alpha
        # is an exact 0 and the zero carry drops out
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("shk,shkd->shd", p, vb)
        m = m_new
    return (acc / l).to(q.dtype)


_lib_lock = threading.Lock()
_launch_lock = threading.Lock()
_lib = None

_CUDA_DTYPES = (torch.float32, torch.bfloat16)


def _library():
    """The built kernel library with its ctypes signatures (built from
    ``csrc/ragged_decode.cu`` at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from bigdl_tpu_torch.kernels import _build

            lib = _build.load("ragged_decode")
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            for fn in (lib.bigdl_ragged_decode_f32,
                       lib.bigdl_ragged_decode_bf16):
                fn.argtypes = [p, p, p, p, p, i32, i32, i32, i32,
                               i64, i64, i64, i64, i64, i64, i64, i64,
                               i64, i64, ctypes.c_float, i32, p]
                fn.restype = i32
            lib.bigdl_cuda_error_string.argtypes = [i32]
            lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_cuda_operands(q, k, v, lengths) -> None:
    d = k.shape[-1]
    if q.dtype not in _CUDA_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"ragged_decode kernel takes float32 or bfloat16 "
                        f"q/k/v of one dtype, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if d % 32 or not 32 <= d <= 256:
        raise ValueError(f"ragged_decode kernel needs head_dim a multiple "
                         f"of 32 in [32, 256], got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous "
                             f"(stride {x.stride(-1)})")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or lengths.stride(0) != 1:
        raise ValueError(f"lengths must be a contiguous int32 tensor on "
                         f"{q.device}, got {lengths.dtype} on "
                         f"{lengths.device}")


def ragged_decode_attention(q, k, v, lengths, *,
                            sm_scale: Optional[float] = None,
                            block_k: int = 128):
    """One decode step of attention over ragged KV: ``q [slots, H, D]``,
    ``k``/``v`` ``[slots, H, T, D]`` (any strides with a contiguous last
    dimension — the cache view is read in place), ``lengths [slots]``
    int32 valid rows per slot, clamped into ``[1, T]``. Returns
    ``[slots, H, D]`` in ``q.dtype``.

    CPU tensors run :func:`ragged_decode_attention_reference`
    (``block_k`` sets its tiling). CUDA tensors launch the kernel on the
    calling thread's current stream, or raise on what it does not take;
    each launch adds one to ``ragged_decode_attention.launches``."""
    slots, h, t, d = k.shape
    if q.shape != (slots, h, d):
        raise ValueError(f"q {tuple(q.shape)} does not match cache "
                         f"[{slots},{h},{t},{d}]")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return ragged_decode_attention_reference(q, k, v, lengths,
                                                 sm_scale, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_decode runs on cuda or cpu, not "
                         f"{q.device}")
    _check_cuda_operands(q, k, v, lengths)
    out = torch.empty((slots, h, d), dtype=q.dtype, device=q.device)
    if slots == 0 or h == 0:
        return out
    lib = _library()
    fn = (lib.bigdl_ragged_decode_f32 if q.dtype == torch.float32
          else lib.bigdl_ragged_decode_bf16)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), slots, h, t, d,
            q.stride(0), q.stride(1),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1),
            float(sm_scale), q.device.index, stream)
    if rc != 0:
        msg = lib.bigdl_cuda_error_string(rc).decode()
        raise RuntimeError(f"ragged_decode kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    with _launch_lock:
        ragged_decode_attention.launches += 1
    return out


#: kernel launches so far (plain-version calls on the CPU do not count)
ragged_decode_attention.launches = 0
