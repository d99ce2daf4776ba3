"""Full-row flash attention for training, forward and backward
(counterpart of ``bigdl_tpu.kernels.flash_attention.flash_attention``,
the K1 kernel pair).

Each query row is reduced over its whole key row — the row max first,
then exp-sum-accumulate, no online rescaling — so masked lanes are exact
zeros in every sum, as in the TPU kernel. The forward returns O and the
float32 log-sum-exp; the backward recomputes p from it. The kernels are
CUDA C++ for Hopper (``csrc/flash_attention.cu``; its header note has the
design and the bound). Beside them are their plain PyTorch versions,
:func:`flash_attention_forward_reference` and
:func:`flash_attention_backward_reference`, which follow the TPU
kernel's arithmetic (q scaled before the product, masked scores -inf,
p = 0 on masked lanes and where lse is not finite), one ``block_q``
query tile at a time as the TPU grid does.

:func:`flash_attention` is differentiable (a ``torch.autograd.Function``
that saves q, k, v, O, lse and the segment ids). The wrappers
:func:`flash_attention_forward` and :func:`flash_attention_backward`
run the plain versions for tensors on the CPU, and launch the kernels
for CUDA tensors or raise: there is no fallback from the card to the
plain version. Each kernel launch adds one to its wrapper's
``launches``; one backward launch runs three CUDA kernels (delta, dK/dV,
dQ) on the current stream.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from bigdl_tpu_torch.kernels.common import fit_block

__all__ = ["cuda_unsupported", "flash_attention", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_attention_forward",
           "flash_attention_forward_reference"]

_NEG_INF = float("-inf")
#: input dtypes of the CUDA kernels, by the suffix of their C entry points
_CUDA_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}
#: the widest head_dim the CUDA kernels take: a backward block's float32
#: tiles at 128 columns take 166 KB of the 227 KB of shared memory
_CUDA_MAX_HEAD_DIM = 128
#: the grid's second axis runs over batch x heads
_CUDA_MAX_BATCH_HEADS = 65535


def _keep_mask(rows, s: int, causal: bool, segment_ids, device):
    """The TPU kernel's keep-mask (``_mask_for``) for the query rows
    ``rows`` (a 1-D index tensor): ``[B or 1, 1, len(rows), s]`` bool,
    or None when nothing masks."""
    mask = None
    if causal:
        cols = torch.arange(s, device=device)
        mask = (cols[None, :] <= rows[:, None])[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(device=device, dtype=torch.int32)
        same = (seg[:, rows][:, :, None] == seg[:, None, :])[:, None]
        mask = same if mask is None else mask & same
    return mask


def flash_attention_forward_reference(q, k, v, segment_ids=None, *,
                                      causal: bool = False,
                                      sm_scale: Optional[float] = None,
                                      block_q: int = 128):
    """Plain PyTorch K1 forward over ``[B, H, S, D]`` q/k/v: returns
    ``(O in q.dtype, lse [B, H, S] float32)``, computed in float32 one
    ``block_q`` query tile at a time. A fully masked row gives O = 0 and
    lse = -inf."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bq = fit_block(s, block_q)
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for i in range(s // bq):
        sl = slice(i * bq, (i + 1) * bq)
        qt = q[:, :, sl].float() * sm_scale
        scores = torch.einsum("bhqd,bhkd->bhqk", qt, kf)
        mask = _keep_mask(torch.arange(i * bq, (i + 1) * bq,
                                       device=q.device),
                          s, causal, segment_ids, q.device)
        if mask is not None:
            scores = scores.masked_fill(~mask, _NEG_INF)
        m = scores.amax(dim=-1, keepdim=True)
        # exp(-inf - -inf) is nan on a fully masked row: the where()
        # zeroes every masked lane exactly
        p = torch.exp(scores - m)
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bhqk,bhkd->bhqd", p, vf)
        out[:, :, sl] = torch.where(l > 0, acc / l, 0.0).to(q.dtype)
        lse[:, :, sl] = torch.where(l[..., 0] > 0,
                                    m[..., 0] + torch.log(l[..., 0]),
                                    _NEG_INF)
    return out, lse


def flash_attention_backward_reference(q, k, v, o, do, lse,
                                       segment_ids=None, *,
                                       causal: bool = False,
                                       sm_scale: Optional[float] = None,
                                       block_q: int = 128):
    """Plain PyTorch K1 backward: ``(dq, dk, dv)`` in the input dtypes
    from q, k, v, the forward's O, the output gradient dO and lse.
    p is recomputed from lse, ``dS = p * (dP - rowsum(dO * O)) *
    scale``, ``dQ = dS . K``, ``dK = dS^T . q`` (q unscaled) and
    ``dV = p^T . dO``, with dK / dV accumulated over ``block_q`` query
    tiles in order, as the TPU kernel carries them."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bq = fit_block(s, block_q)
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i in range(s // bq):
        sl = slice(i * bq, (i + 1) * bq)
        qt = q[:, :, sl].float()
        dot = do[:, :, sl].float()
        ot = o[:, :, sl].float()
        lt = lse[:, :, sl]
        scores = torch.einsum("bhqd,bhkd->bhqk", qt * sm_scale, kf)
        mask = _keep_mask(torch.arange(i * bq, (i + 1) * bq,
                                       device=q.device),
                          s, causal, segment_ids, q.device)
        if mask is not None:
            scores = scores.masked_fill(~mask, _NEG_INF)
        p = torch.exp(scores - lt[..., None])
        if mask is not None:
            p = torch.where(mask, p, 0.0)
        p = torch.where(torch.isfinite(lt)[..., None], p, 0.0)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dot)
        dp = torch.einsum("bhqd,bhkd->bhqk", dot, vf)
        delta = (dot * ot).sum(dim=-1, keepdim=True)
        ds = p * (dp - delta) * sm_scale
        dq[:, :, sl] = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qt)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_lib_lock = threading.Lock()
_launch_lock = threading.Lock()
_lib = None


def _library():
    """The built kernel library with its ctypes signatures (built from
    ``csrc/flash_attention.cu`` at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from bigdl_tpu_torch.kernels import _build

            lib = _build.load("flash_attention")
            p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            for suffix in _CUDA_DTYPES.values():
                fn = getattr(lib, f"bigdl_flash_fwd_{suffix}")
                fn.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, p,
                               i32, f32, i32, p]
                fn.restype = i32
                fn = getattr(lib, f"bigdl_flash_bwd_{suffix}")
                fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i32, i32,
                               i32, i32, p, i32, f32, i32, p]
                fn.restype = i32
            lib.bigdl_flash_error_string.argtypes = [i32]
            lib.bigdl_flash_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _rows_contiguous(x):
    """``x`` itself when its last dimension is contiguous (any other
    strides are read in place), else a contiguous copy."""
    return x if x.stride(-1) == 1 else x.contiguous()


def cuda_unsupported(shape, dtype) -> Optional[str]:
    """Why the CUDA kernels do not take ``[B, H, S, D]`` operands of this
    shape and dtype, or None when they do. The plain versions, which
    CPU tensors run, take any of them."""
    if dtype not in _CUDA_DTYPES:
        return (f"the flash_attention kernel takes float32, bfloat16 or "
                f"float16, not {dtype}")
    if not 1 <= shape[-1] <= _CUDA_MAX_HEAD_DIM:
        return (f"the flash_attention kernel takes head_dim 1 to "
                f"{_CUDA_MAX_HEAD_DIM}, not {shape[-1]}")
    if shape[0] * shape[1] > _CUDA_MAX_BATCH_HEADS:
        return (f"the flash_attention kernel takes at most "
                f"{_CUDA_MAX_BATCH_HEADS} batch x heads, not "
                f"{shape[0] * shape[1]}")
    return None


def _check_cuda_operands(tensors, shape, dtype, device) -> None:
    why = cuda_unsupported(shape, dtype)
    if dtype not in _CUDA_DTYPES:
        raise TypeError(why)
    if why is not None:
        raise ValueError(why)
    for name, x in tensors.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(x.shape)} does not match "
                             f"{tuple(shape)}")
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, q on {device}")


def _cuda_segments(segment_ids, b: int, s: int, device):
    if segment_ids is None:
        return None
    if tuple(segment_ids.shape) != (b, s):
        raise ValueError(f"segment_ids {tuple(segment_ids.shape)} must be "
                         f"[B, S] = {(b, s)}")
    if segment_ids.device != device:
        raise ValueError(f"segment_ids are on {segment_ids.device}, q on "
                         f"{device}")
    return segment_ids.to(torch.int32).contiguous()


def _strides(*tensors):
    flat = [st for x in tensors for st in x.stride()[:3]]
    flat += [0] * (15 - len(flat))
    return (ctypes.c_int64 * 15)(*flat)


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.bigdl_flash_error_string(rc).decode()
        raise RuntimeError(f"flash_attention {what} kernel launch failed: "
                           f"{msg} (cudaError {rc})")


def _device_of(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return q.device.type


def flash_attention_forward(q, k, v, segment_ids=None, *,
                            causal: bool = False,
                            sm_scale: Optional[float] = None,
                            block_q: int = 128):
    """K1 forward: ``(O, lse)`` for ``[B, H, S, D]`` q/k/v and optional
    ``[B, S]`` segment ids. CPU tensors run
    :func:`flash_attention_forward_reference` (``block_q`` sets its
    tiling); CUDA tensors launch the kernel on the current stream (any
    strides with a contiguous last dimension are read in place) or
    raise. Each launch adds one to ``flash_attention_forward.launches``.
    """
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if _device_of(q) == "cpu":
        return flash_attention_forward_reference(
            q, k, v, segment_ids, causal=causal, sm_scale=sm_scale,
            block_q=block_q)
    _check_cuda_operands({"k": k, "v": v}, q.shape, q.dtype, q.device)
    q, k, v = (_rows_contiguous(x) for x in (q, k, v))
    seg = _cuda_segments(segment_ids, b, s, q.device)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _library()
    fn = getattr(lib, f"bigdl_flash_fwd_{_CUDA_DTYPES[q.dtype]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, s, d, _strides(q, k, v),
            int(bool(causal)), float(sm_scale), q.device.index, stream)
    _raise_on(rc, lib, "forward")
    with _launch_lock:
        flash_attention_forward.launches += 1
    return out, lse


def flash_attention_backward(q, k, v, o, do, lse, segment_ids=None, *,
                             causal: bool = False,
                             sm_scale: Optional[float] = None,
                             block_q: int = 128):
    """K1 backward: ``(dq, dk, dv)`` in the input dtypes. CPU tensors
    run :func:`flash_attention_backward_reference`; CUDA tensors launch
    the three backward kernels on the current stream or raise. Each
    launch adds one to ``flash_attention_backward.launches``."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if _device_of(q) == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, do, lse, segment_ids, causal=causal,
            sm_scale=sm_scale, block_q=block_q)
    _check_cuda_operands({"k": k, "v": v, "o": o, "do": do}, q.shape,
                         q.dtype, q.device)
    if tuple(lse.shape) != (b, h, s) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 [B, H, S] = {(b, h, s)}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    q, k, v, o, do = (_rows_contiguous(x) for x in (q, k, v, o, do))
    lse = lse.contiguous()
    seg = _cuda_segments(segment_ids, b, s, q.device)
    dq = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    if dq.numel() == 0:
        return dq, dk, dv
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _library()
    fn = getattr(lib, f"bigdl_flash_bwd_{_CUDA_DTYPES[q.dtype]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(),
            None if seg is None else seg.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            b, h, s, d, _strides(q, k, v, o, do), int(bool(causal)),
            float(sm_scale), q.device.index, stream)
    _raise_on(rc, lib, "backward")
    with _launch_lock:
        flash_attention_backward.launches += 1
    return dq, dk, dv


#: kernel launches so far (plain-version calls on the CPU do not count)
flash_attention_forward.launches = 0
flash_attention_backward.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale, block_q):
        out, lse = flash_attention_forward(
            q, k, v, segment_ids, causal=causal, sm_scale=sm_scale,
            block_q=block_q)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.sm_scale, ctx.block_q = causal, sm_scale, block_q
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, do, lse, segment_ids, causal=ctx.causal,
            sm_scale=ctx.sm_scale, block_q=ctx.block_q)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, segment_ids=None, *, causal: bool = False,
                    sm_scale: Optional[float] = None, block_q: int = 128):
    """Differentiable full-row flash attention over ``[B, H, S, D]``
    q/k/v; ``segment_ids`` is the packed slab's ``[B, S]`` int32 plane
    (queries attend same-segment keys only, ANDed with ``causal``).
    Returns O in q's dtype. Use through
    :func:`bigdl_tpu_torch.kernels.attention`, which owns eligibility
    and routing."""
    if q.ndim != 4:
        raise ValueError(f"flash_attention wants [B,H,S,D], got "
                         f"{tuple(q.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal),
                                 float(sm_scale), int(block_q))
