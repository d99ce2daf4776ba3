"""Paged ragged decode — per-slot KV read through a page table
(counterpart of ``bigdl_tpu.kernels.paged_decode``).

The pools are ``k_pages`` / ``v_pages [num_pages, H, page_size, D]``;
``page_table [slots, pages_per_slot]`` holds each slot's physical page
ids in sequence order; ``lengths [slots]`` is the ragged bound of the
contiguous kernel (K3), clamped into ``[1, pages_per_slot *
page_size]``. Pages past a slot's length are never read.

The kernel (``csrc/paged_decode.cu``) is K3's with its row address
made a template parameter, run under K3's plan (:func:`~bigdl_tpu_torch.
kernels.ragged_decode.decode_plan` at ``t_len = pages_per_slot *
page_size``), so on a paged view of a cache it is bitwise equal to K3's
kernel for any page size and any table.
:func:`paged_decode_attention_reference` is its plain PyTorch version:
it walks the table page by page, each page one online-softmax tile, as
the TPU kernel does (so at ``page_size == block_k`` it is K3's plain
version, tile for tile).

:func:`paged_view` builds the ``(k_pages, v_pages, table)`` triple from
a contiguous ``[slots, H, T, D]`` cache slice — the bridge the tests
and ``chip_smoke.py`` use; no production path of either package calls
paged decode yet.

:func:`paged_decode_attention` runs the plain version for a tensor on
the CPU, and launches the kernel for a CUDA tensor or raises.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from bigdl_tpu_torch.kernels.ragged_decode import decode_plan, sm_count

__all__ = ["paged_decode_attention", "paged_decode_attention_reference",
           "paged_plan", "paged_view"]

_NEG_INF = float("-inf")


def paged_view(k, v, page_size: int):
    """Reshape one contiguous ``[slots, H, T, D]`` cache slice into a
    ``(k_pages, v_pages, page_table)`` paged triple: page ``j`` of slot
    ``s`` is rows ``[j * page_size, (j + 1) * page_size)`` and the
    identity table maps it to pool id ``s * (T // page_size) + j``.
    ``page_size`` must divide ``T``."""
    slots, h, t, d = k.shape
    if t % page_size:
        raise ValueError(f"page_size={page_size} must divide the cache "
                         f"time axis T={t}")
    pages_per_slot = t // page_size

    def pool(x):
        x = x.reshape(slots, h, pages_per_slot, page_size, d)
        return x.permute(0, 2, 1, 3, 4).reshape(
            slots * pages_per_slot, h, page_size, d)

    table = torch.arange(slots * pages_per_slot, dtype=torch.int32,
                         device=k.device).reshape(slots, pages_per_slot)
    return pool(k), pool(v), table


def _check(q, k_pages, v_pages, page_table, lengths) -> None:
    if q.ndim != 3 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"paged decode takes q [slots, H, D] and pools "
                         f"[pages, H, P, D] of one shape, got "
                         f"{tuple(q.shape)} / {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    slots, h, d = q.shape
    if (k_pages.shape[1], k_pages.shape[3]) != (h, d):
        raise ValueError(f"page pools {tuple(k_pages.shape)} do not match "
                         f"q [{slots},{h},{d}]")
    if page_table.ndim != 2 or page_table.shape[0] != slots:
        raise ValueError(f"page_table {tuple(page_table.shape)} does not "
                         f"match {slots} slots")
    if lengths.shape != (slots,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be "
                         f"[slots] = ({slots},)")


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     lengths,
                                     sm_scale: Optional[float] = None):
    """Plain PyTorch paged decode → ``[slots, H, D]`` in ``q.dtype``,
    computed in float32: the TPU kernel's recurrence, one page per
    online-softmax tile, in table order. Every slot walks every page
    here (no per-slot loop bound, so no host sync); a page at or past a
    slot's length is an exact no-op for it (``alpha = 1``, ``p = 0``,
    its rows zeroed), and its table entry is clamped, never trusted."""
    slots, h, d = q.shape
    num_pages, _, page, _ = k_pages.shape
    pps = page_table.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    n = lengths.to(device=q.device, dtype=torch.int64).clamp(1, pps * page)
    table = page_table.to(device=q.device, dtype=torch.int64)
    qs = q.float() * sm_scale
    m = torch.full((slots, h, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((slots, h, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((slots, h, d), dtype=torch.float32, device=q.device)
    cols = torch.arange(page, device=q.device)
    for j in range(pps):
        live = j * page < n                                  # [slots]
        ids = torch.where(live, table[:, j], 0).clamp(0, num_pages - 1)
        valid = (j * page + cols)[None, None, :] < n[:, None, None]
        kb = k_pages[ids].float()                            # [s, H, P, D]
        vb = v_pages[ids].float().masked_fill(~valid[..., None], 0.0)
        s = torch.einsum("shd,shkd->shk", qs, kb)
        s = s.masked_fill(~valid, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        # page 0 column 0 is always valid, so alpha is an exact 0 on the
        # first page and the zero carry drops out
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("shk,shkd->shd", p, vb)
        m = m_new
    return (acc / l).to(q.dtype)


_lib_lock = threading.Lock()
_launch_lock = threading.Lock()
_lib = None

_CUDA_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}


def _library():
    """The built kernel library with its ctypes signatures (built from
    ``csrc/paged_decode.cu`` at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from bigdl_tpu_torch.kernels import _build

            lib = _build.load("paged_decode")
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            for suffix in _CUDA_DTYPES.values():
                fn = getattr(lib, f"bigdl_paged_decode_{suffix}")
                fn.argtypes = [p] * 7 + [i32] * 8 + [i64] * 10 + [
                    ctypes.c_float, i32, p]
                fn.restype = i32
            lib.bigdl_cuda_error_string.argtypes = [i32]
            lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def cuda_unsupported(q, k_pages, v_pages, page_table, lengths
                     ) -> Optional[str]:
    """Why the CUDA kernel does not take these operands (None when it
    does): float32, bfloat16 or float16 q and pools of one dtype,
    head_dim 1 to 256, contiguous last dimensions, contiguous int32
    table and lengths, one device."""
    d = q.shape[-1]
    if q.dtype not in _CUDA_DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        return (f"takes float32, bfloat16 or float16 q/k/v of one dtype, "
                f"got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if not 1 <= d <= 256:
        return f"needs head_dim in [1, 256], got {d}"
    for name, x in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if x.device != q.device:
            return f"{name} is on {x.device}, q on {q.device}"
        if x.stride(-1) != 1:
            return (f"{name}'s last dimension must be contiguous (stride "
                    f"{x.stride(-1)})")
    for name, x in (("page_table", page_table), ("lengths", lengths)):
        if x.device != q.device or x.dtype != torch.int32 \
                or not x.is_contiguous():
            return (f"{name} must be a contiguous int32 tensor on "
                    f"{q.device}, got {x.dtype} on {x.device}")
    if page_table.shape[1] * k_pages.shape[2] > 2 ** 31 - 1:
        return "pages_per_slot * page_size must fit in int32"
    return None


def paged_plan(q, k_pages, page_table, sms: int):
    """K4's split plan: K3's :func:`~bigdl_tpu_torch.kernels.
    ragged_decode.decode_plan` at ``t_len = pages_per_slot *
    page_size``, never a function of the page size itself, so K4 splits
    a paged view's keys exactly as K3 splits the contiguous cache."""
    slots, h, d = q.shape
    return decode_plan(slots, h, page_table.shape[1] * k_pages.shape[2], d,
                       q.element_size(), sms)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           sm_scale: Optional[float] = None):
    """One decode step of attention over PAGED KV: ``q [slots, H, D]``,
    ``k_pages`` / ``v_pages [num_pages, H, page_size, D]`` (any strides
    with a contiguous last dimension), ``page_table [slots,
    pages_per_slot]`` int32 page ids, ``lengths [slots]`` int32 valid
    rows per slot. Returns ``[slots, H, D]`` in ``q.dtype``.

    CPU tensors run :func:`paged_decode_attention_reference`. CUDA
    tensors launch the kernel on the calling thread's current stream
    under K3's plan, or raise on what it does not take
    (:func:`cuda_unsupported`); each call adds one to
    ``paged_decode_attention.launches`` (the split kernel and its merge
    count as one). Table entries of the pages a slot reads must lie in
    ``[0, num_pages)``; the kernel does not check them."""
    _check(q, k_pages, v_pages, page_table, lengths)
    slots, h, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages,
                                                page_table, lengths,
                                                sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cuda or cpu, not "
                         f"{q.device}")
    why = cuda_unsupported(q, k_pages, v_pages, page_table, lengths)
    if why is not None:
        raise ValueError(f"paged_decode kernel {why}")
    out = torch.empty((slots, h, d), dtype=q.dtype, device=q.device)
    pps, page = page_table.shape[1], k_pages.shape[2]
    if slots == 0 or h == 0 or pps * page == 0:
        return out
    plan = paged_plan(q, k_pages, page_table, sm_count(q.device))
    partials = (torch.empty((slots, h, plan.splits, d + 2),
                            dtype=torch.float32, device=q.device)
                if plan.splits > 1 else None)
    lib = _library()
    fn = getattr(lib, f"bigdl_paged_decode_{_CUDA_DTYPES[q.dtype]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            None if partials is None else partials.data_ptr(),
            slots, h, pps, page, d, plan.stage_keys, plan.chunk,
            plan.splits,
            q.stride(0), q.stride(1),
            k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
            v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
            out.stride(0), out.stride(1),
            float(sm_scale), q.device.index, stream)
    if rc != 0:
        msg = lib.bigdl_cuda_error_string(rc).decode()
        raise RuntimeError(f"paged_decode kernel launch failed: {msg} "
                           f"(cudaError {rc})")
    with _launch_lock:
        paged_decode_attention.launches += 1
    return out


#: kernel calls so far (plain-version calls on the CPU do not count)
paged_decode_attention.launches = 0
