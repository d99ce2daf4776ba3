"""Flash attention for training, forward and backward: the full-row
kernel pair K1 and the blockwise long-context pair K2 (counterparts of
``bigdl_tpu.kernels.flash_attention.flash_attention`` and
``.blockwise_flash_attention``, kept in one module as there).

K1 reduces each query row over its whole key row — the row max first,
then exp-sum-accumulate, no online rescaling — so masked lanes are exact
zeros in every sum, as in the TPU kernel. K2 tiles the key axis as well
and carries an online-softmax ``(m, l, acc)`` per query tile, rescaled
by ``exp(m_old - m_new)`` at each key tile, so no working set grows with
S; the dispatch layer routes shapes past the working-set budget to it.
Both forwards return O and the float32 log-sum-exp, and both backwards
recompute p from it. The kernels are CUDA C++ for Hopper
(``csrc/flash_attention.cu`` and ``csrc/blockwise_flash_attention.cu``
over the shared ``csrc/flash_common.cuh``, which holds the tile code and
the one backward both use; the header notes have the design and the
bound). float32 operands run their tile products in 3xTF32 on the
tensor cores (float32 accuracy); bfloat16 and float16 operands run
16-bit products with float32 sums — ``mma.sync`` m16n8k16 in both
forwards, ``wgmma`` m64nNk16 in the backward — p and dS split into hi +
lo in the input dtype where they are an operand, within the dtype's
tolerance of the plain version rather than bitwise. K1's forward in
every dtype, K2's 16-bit forward and the 16-bit backward skip the 64 x
64 tile pairs whose queries and keys share no segment id;
:func:`flash_attention_forward_tile_pairs`,
:func:`flash_attention_backward_tile_pairs` and their
``blockwise_`` twins read what they computed. Beside them are their
plain PyTorch versions
(``*_forward_reference`` / ``*_backward_reference``), which follow the
TPU kernels' arithmetic: q scaled before the product, masked scores
-inf, p = 0 on masked lanes and where lse (or, in K2's forward, the
running max) is not finite, one ``block_q`` query tile (and, in K2,
``block_k`` key tile) at a time as the TPU grid does.

:func:`flash_attention` and :func:`blockwise_flash_attention` are
differentiable (each a ``torch.autograd.Function`` that saves q, k, v,
O, lse and the segment ids). The wrappers run the plain versions for
tensors on the CPU, and launch the kernels for CUDA tensors or raise:
there is no fallback from the card to the plain version. Each kernel
launch adds one to its wrapper's ``launches``; one backward launch runs
three CUDA kernels (delta, dK/dV, dQ) on the current stream.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional

import torch

from bigdl_tpu_torch.kernels.common import fit_block

__all__ = ["blockwise_flash_attention", "blockwise_flash_attention_backward",
           "blockwise_flash_attention_backward_reference",
           "blockwise_flash_attention_backward_tile_pairs",
           "blockwise_flash_attention_forward",
           "blockwise_flash_attention_forward_reference",
           "blockwise_flash_attention_forward_tile_pairs", "cuda_unsupported",
           "flash_attention", "flash_attention_backward",
           "flash_attention_backward_reference", "flash_attention_forward",
           "flash_attention_backward_tile_pairs",
           "flash_attention_forward_reference",
           "flash_attention_forward_tile_pairs"]

_NEG_INF = float("-inf")
#: input dtypes of the CUDA kernels, by the suffix of their C entry points
_CUDA_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}
#: the widest head_dim the CUDA kernels take: a backward block's float32
#: tiles at 128 columns take 200 KB of the 227 KB of shared memory
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
_libs = {}


def _library(source: str, prefix: str):
    """The kernel library built from ``csrc/<source>.cu`` (at first
    use), with the ctypes signatures of its ``<prefix>_*`` entry
    points."""
    with _lib_lock:
        lib = _libs.get(source)
        if lib is None:
            from bigdl_tpu_torch.kernels import _build

            lib = _build.load(source)
            p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            for suffix in _CUDA_DTYPES.values():
                fn = getattr(lib, f"{prefix}_fwd_{suffix}")
                fn.argtypes = [p, p, p, p, p, p, i32, i32, i32, i32, p,
                               i32, f32, i32, p]
                fn.restype = i32
                fn = getattr(lib, f"{prefix}_bwd_{suffix}")
                fn.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i32, i32,
                               i32, i32, p, i32, f32, i32, p]
                fn.restype = i32
            err = getattr(lib, f"{prefix}_error_string")
            err.argtypes = [i32]
            err.restype = ctypes.c_char_p
            for what in ("tile_pairs", "bwd_tile_pairs"):
                fn = getattr(lib, f"{prefix}_{what}")
                fn.argtypes = [i32, ctypes.POINTER(ctypes.c_ulonglong)]
                fn.restype = i32
            lib = _libs[source] = lib
        return lib


def _rows_contiguous(x):
    """``x`` itself when its last dimension is contiguous (any other
    strides are read in place), else a contiguous copy."""
    return x if x.stride(-1) == 1 else x.contiguous()


def cuda_unsupported(shape, dtype) -> Optional[str]:
    """Why the CUDA kernels (K1 and K2 take the same operands) do not
    take ``[B, H, S, D]`` operands of this shape and dtype, or None when
    they do. The plain versions, which CPU tensors run, take any of
    them."""
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


def _raise_on(rc: int, lib, prefix: str, what: str) -> None:
    if rc != 0:
        msg = getattr(lib, f"{prefix}_error_string")(rc).decode()
        raise RuntimeError(f"{prefix} {what} kernel launch failed: {msg} "
                           f"(cudaError {rc})")


def _device_of(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return q.device.type


def _launch_forward(source: str, prefix: str, q, k, v, segment_ids,
                    causal: bool, sm_scale: float):
    """One forward launch of ``csrc/<source>.cu`` on the current stream:
    checks the operands (raising on what the kernel does not take),
    allocates O and lse, and raises if the launch fails."""
    b, h, s, d = q.shape
    _check_cuda_operands({"k": k, "v": v}, q.shape, q.dtype, q.device)
    q, k, v = (_rows_contiguous(x) for x in (q, k, v))
    seg = _cuda_segments(segment_ids, b, s, q.device)
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = _library(source, prefix)
    fn = getattr(lib, f"{prefix}_fwd_{_CUDA_DTYPES[q.dtype]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if seg is None else seg.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, s, d, _strides(q, k, v),
            int(bool(causal)), float(sm_scale), q.device.index, stream)
    _raise_on(rc, lib, prefix, "forward")
    return out, lse


def _launch_backward(source: str, prefix: str, q, k, v, o, do, lse,
                     segment_ids, causal: bool, sm_scale: float):
    """One backward launch (delta, dK/dV and dQ kernels) of
    ``csrc/<source>.cu`` on the current stream; raises if it fails."""
    b, h, s, d = q.shape
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
    lib = _library(source, prefix)
    fn = getattr(lib, f"{prefix}_bwd_{_CUDA_DTYPES[q.dtype]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(),
            None if seg is None else seg.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            b, h, s, d, _strides(q, k, v, o, do), int(bool(causal)),
            float(sm_scale), q.device.index, stream)
    _raise_on(rc, lib, prefix, "backward")
    return dq, dk, dv


def _count(fn) -> None:
    with _launch_lock:
        fn.launches += 1


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
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _device_of(q) == "cpu":
        return flash_attention_forward_reference(
            q, k, v, segment_ids, causal=causal, sm_scale=sm_scale,
            block_q=block_q)
    out = _launch_forward("flash_attention", "bigdl_flash", q, k, v,
                          segment_ids, causal, sm_scale)
    _count(flash_attention_forward)
    return out


def flash_attention_backward(q, k, v, o, do, lse, segment_ids=None, *,
                             causal: bool = False,
                             sm_scale: Optional[float] = None,
                             block_q: int = 128):
    """K1 backward: ``(dq, dk, dv)`` in the input dtypes. CPU tensors
    run :func:`flash_attention_backward_reference`; CUDA tensors launch
    the three backward kernels on the current stream or raise. Each
    launch adds one to ``flash_attention_backward.launches``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _device_of(q) == "cpu":
        return flash_attention_backward_reference(
            q, k, v, o, do, lse, segment_ids, causal=causal,
            sm_scale=sm_scale, block_q=block_q)
    grads = _launch_backward("flash_attention", "bigdl_flash", q, k, v, o,
                             do, lse, segment_ids, causal, sm_scale)
    _count(flash_attention_backward)
    return grads


#: kernel launches so far (plain-version calls on the CPU do not count)
flash_attention_forward.launches = 0
flash_attention_backward.launches = 0


def _tile_pairs(source: str, prefix: str, what: str, n: int, device):
    """Read (and zero) ``n`` tile-pair counters of a kernel library on
    the card ``device`` (default: the current one)."""
    index = torch.device("cuda" if device is None else device).index
    if index is None:
        index = torch.cuda.current_device()
    lib = _library(source, prefix)
    pairs = (ctypes.c_ulonglong * n)()
    rc = getattr(lib, f"{prefix}_{what}")(index, pairs)
    _raise_on(rc, lib, prefix, what.replace("_", " "))
    return tuple(pairs)


def flash_attention_forward_tile_pairs(device=None) -> int:
    """The (query tile, key tile) pairs of 64 x 64 that K1's forward
    kernel has computed on the card ``device`` (default: the current
    one) since the last call; the count restarts at 0. With segment ids
    the kernel skips the key tiles that share no id with a query tile,
    so this is the record that it did (CPU calls compute no tiles).
    Synchronises the device."""
    return _tile_pairs("flash_attention", "bigdl_flash", "tile_pairs", 1,
                       device)[0]


def flash_attention_backward_tile_pairs(device=None) -> tuple:
    """``(dkv, dq)``: the (query tile, key tile) pairs of 64 x 64 that
    K1's bfloat16 / float16 backward kernels (dK/dV and dQ) have computed
    on the card ``device`` (default: the current one) since the last
    call; both counts restart at 0. Like the forward, they skip the
    tiles whose queries and keys share no segment id, so these are the
    record that they did; the float32 backward computes every causal
    pair and counts none. Synchronises the device."""
    return _tile_pairs("flash_attention", "bigdl_flash", "bwd_tile_pairs",
                       2, device)


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


# ------------------------------------------------------------------ K2

def _tile_keep(i0: int, bq: int, j0: int, bk: int, causal: bool,
               segment_ids, device):
    """The TPU kernel's tile keep-mask (``_tile_mask``) for query rows
    ``i0 .. i0+bq-1`` against keys ``j0 .. j0+bk-1``: ``[B or 1, 1, bq,
    bk]`` bool, or None when nothing masks."""
    mask = None
    if causal:
        rows = torch.arange(i0, i0 + bq, device=device)
        cols = torch.arange(j0, j0 + bk, device=device)
        mask = (cols[None, :] <= rows[:, None])[None, None]
    if segment_ids is not None:
        seg = segment_ids.to(device=device, dtype=torch.int32)
        same = (seg[:, i0:i0 + bq, None] == seg[:, None, j0:j0 + bk])[:, None]
        mask = same if mask is None else mask & same
    return mask


def _tile_live(i0: int, bq: int, j0: int, causal: bool) -> bool:
    """Whether key tile ``j0`` holds any key the query tile ``i0`` may
    see: under causal, tiles strictly right of its last row are masked
    whole and skipped."""
    return not causal or j0 <= i0 + bq - 1


def _online_update(m, l, acc, scores, keep, vt):
    """One key tile of the forward carry (``_bw_fwd_kernel``'s step):
    ``(m, l, acc)`` rescaled by ``exp(m_old - m_new)`` and the tile's
    ``p = exp(s - m_new)`` added. ``m_new`` is -inf only while every
    lane so far is masked; then p = 0 and alpha = 0, so a fully masked
    row keeps an exact ``(-inf, 0, 0)`` carry and never a NaN."""
    if keep is not None:
        scores = scores.masked_fill(~keep, _NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    p = torch.exp(scores - m_new)
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    p = torch.where(torch.isfinite(m_new), p, 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vt)
    return m_new, l, acc


def _finish(m, l, acc):
    """O (float32) and lse from a row's final carry: ``acc / l`` and
    ``m + log l``; ``l = 0`` (a fully masked row) gives O = 0 and
    lse = -inf."""
    out = torch.where(l > 0, acc / l, 0.0)
    lse = torch.where(l[..., 0] > 0, m[..., 0] + torch.log(l[..., 0]),
                      _NEG_INF)
    return out, lse


def blockwise_flash_attention_forward_reference(
        q, k, v, segment_ids=None, *, causal: bool = False,
        sm_scale: Optional[float] = None, block_q: int = 128,
        block_k: int = 128):
    """Plain PyTorch K2 forward over ``[B, H, S, D]`` q/k/v: returns
    ``(O in q.dtype, lse [B, H, S] float32)``. Walks ``block_q`` query
    tiles against ``block_k`` key tiles (each shrunk to a divisor of S)
    with the TPU kernel's online-softmax carry, in float32, skipping key
    tiles right of the query tile under causal."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bq, bk = fit_block(s, block_q), fit_block(s, block_k)
    kf, vf = k.float(), v.float()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    for i0 in range(0, s, bq):
        qt = q[:, :, i0:i0 + bq].float() * sm_scale
        m = torch.full((b, h, bq, 1), _NEG_INF, device=q.device)
        l = torch.zeros((b, h, bq, 1), device=q.device)
        acc = torch.zeros((b, h, bq, d), device=q.device)
        for j0 in range(0, s, bk):
            if not _tile_live(i0, bq, j0, causal):
                continue
            scores = torch.einsum("bhqd,bhkd->bhqk", qt,
                                  kf[:, :, j0:j0 + bk])
            keep = _tile_keep(i0, bq, j0, bk, causal, segment_ids, q.device)
            m, l, acc = _online_update(m, l, acc, scores, keep,
                                       vf[:, :, j0:j0 + bk])
        o, lse_t = _finish(m, l, acc)
        out[:, :, i0:i0 + bq] = o.to(q.dtype)
        lse[:, :, i0:i0 + bq] = lse_t
    return out, lse


def _tile_grads(qt, kt, vt, dot, delta, lt, keep, sm_scale):
    """p and dS of one (query tile, key tile) pair, from the saved lse
    (the TPU kernel's two backward bodies compute the same): ``p =
    exp(s - lse)`` (0 on masked lanes and where lse is not finite) and
    ``dS = p * (dO . V^T - delta) * scale``."""
    scores = torch.einsum("bhqd,bhkd->bhqk", qt * sm_scale, kt)
    if keep is not None:
        scores = scores.masked_fill(~keep, _NEG_INF)
    p = torch.exp(scores - lt[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    p = torch.where(torch.isfinite(lt)[..., None], p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dot, vt)
    return p, p * (dp - delta) * sm_scale


def blockwise_flash_attention_backward_reference(
        q, k, v, o, do, lse, segment_ids=None, *, causal: bool = False,
        sm_scale: Optional[float] = None, block_q: int = 128,
        block_k: int = 128):
    """Plain PyTorch K2 backward: ``(dq, dk, dv)`` in the input dtypes,
    the TPU kernel's two passes from the saved lse — dQ per query tile
    with the key tiles streaming (``_bw_dq_kernel``), then dK/dV per key
    tile with the query tiles streaming (``_bw_dkv_kernel``), each
    accumulated in float32 in that order. ``delta = rowsum(dO * O)`` is
    taken once per query tile."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    bq, bk = fit_block(s, block_q), fit_block(s, block_k)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)     # [B,H,S,1]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)

    def pair(i0, j0):
        qs, ks = slice(i0, i0 + bq), slice(j0, j0 + bk)
        keep = _tile_keep(i0, bq, j0, bk, causal, segment_ids, q.device)
        return _tile_grads(qf[:, :, qs], kf[:, :, ks], vf[:, :, ks],
                           dof[:, :, qs], delta[:, :, qs], lse[:, :, qs],
                           keep, sm_scale)

    for i0 in range(0, s, bq):                  # pass 1: dQ
        for j0 in range(0, s, bk):
            if _tile_live(i0, bq, j0, causal):
                _, ds = pair(i0, j0)
                dq[:, :, i0:i0 + bq] += torch.einsum(
                    "bhqk,bhkd->bhqd", ds, kf[:, :, j0:j0 + bk])
    for j0 in range(0, s, bk):                  # pass 2: dK, dV
        for i0 in range(0, s, bq):
            if _tile_live(i0, bq, j0, causal):
                p, ds = pair(i0, j0)
                dv[:, :, j0:j0 + bk] += torch.einsum(
                    "bhqk,bhqd->bhkd", p, dof[:, :, i0:i0 + bq])
                dk[:, :, j0:j0 + bk] += torch.einsum(
                    "bhqk,bhqd->bhkd", ds, qf[:, :, i0:i0 + bq])
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def blockwise_flash_attention_forward(q, k, v, segment_ids=None, *,
                                      causal: bool = False,
                                      sm_scale: Optional[float] = None,
                                      block_q: int = 128,
                                      block_k: int = 128):
    """K2 forward: ``(O, lse)`` for ``[B, H, S, D]`` q/k/v and optional
    ``[B, S]`` segment ids. CPU tensors run
    :func:`blockwise_flash_attention_forward_reference` with
    ``block_q`` / ``block_k`` tiles; CUDA tensors launch the kernel
    (``csrc/blockwise_flash_attention.cu``, whose tiles are 64 x 64
    whatever ``block_q`` / ``block_k`` say: those are the TPU kernel's
    VMEM choices) on the current stream, or raise. Each launch adds one
    to ``blockwise_flash_attention_forward.launches``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _device_of(q) == "cpu":
        return blockwise_flash_attention_forward_reference(
            q, k, v, segment_ids, causal=causal, sm_scale=sm_scale,
            block_q=block_q, block_k=block_k)
    out = _launch_forward("blockwise_flash_attention", "bigdl_blockwise",
                          q, k, v, segment_ids, causal, sm_scale)
    _count(blockwise_flash_attention_forward)
    return out


def blockwise_flash_attention_backward(q, k, v, o, do, lse,
                                       segment_ids=None, *,
                                       causal: bool = False,
                                       sm_scale: Optional[float] = None,
                                       block_q: int = 128,
                                       block_k: int = 128):
    """K2 backward: ``(dq, dk, dv)`` in the input dtypes. CPU tensors
    run :func:`blockwise_flash_attention_backward_reference`; CUDA
    tensors launch the backward kernels (delta, dK/dV, dQ; 64 x 64
    tiles) on the current stream or raise. Each launch adds one to
    ``blockwise_flash_attention_backward.launches``."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if _device_of(q) == "cpu":
        return blockwise_flash_attention_backward_reference(
            q, k, v, o, do, lse, segment_ids, causal=causal,
            sm_scale=sm_scale, block_q=block_q, block_k=block_k)
    grads = _launch_backward("blockwise_flash_attention", "bigdl_blockwise",
                             q, k, v, o, do, lse, segment_ids, causal,
                             sm_scale)
    _count(blockwise_flash_attention_backward)
    return grads


#: kernel launches so far (plain-version calls on the CPU do not count)
blockwise_flash_attention_forward.launches = 0
blockwise_flash_attention_backward.launches = 0


def blockwise_flash_attention_forward_tile_pairs(device=None) -> int:
    """The (query tile, key tile) pairs of 64 x 64 that K2's bfloat16 /
    float16 forward kernel has computed on the card ``device`` since the
    last call (the count restarts at 0): it skips the key tiles that
    share no segment id with a query tile, as K1's forward does; the
    float32 kernel counts none. Synchronises the device."""
    return _tile_pairs("blockwise_flash_attention", "bigdl_blockwise",
                       "tile_pairs", 1, device)[0]


def blockwise_flash_attention_backward_tile_pairs(device=None) -> tuple:
    """``(dkv, dq)``: the pairs K2's bfloat16 / float16 backward kernels
    (dK/dV and dQ, on wgmma) have computed on the card ``device`` since
    the last call; both restart at 0; the float32 backward counts none.
    Synchronises the device."""
    return _tile_pairs("blockwise_flash_attention", "bigdl_blockwise",
                       "bwd_tile_pairs", 2, device)


class _BlockwiseFlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale, block_q,
                block_k):
        out, lse = blockwise_flash_attention_forward(
            q, k, v, segment_ids, causal=causal, sm_scale=sm_scale,
            block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.block_q, ctx.block_k = block_q, block_k
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, segment_ids = ctx.saved_tensors
        dq, dk, dv = blockwise_flash_attention_backward(
            q, k, v, out, do, lse, segment_ids, causal=ctx.causal,
            sm_scale=ctx.sm_scale, block_q=ctx.block_q,
            block_k=ctx.block_k)
        return dq, dk, dv, None, None, None, None, None


def blockwise_flash_attention(q, k, v, segment_ids=None, *,
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              block_q: int = 128, block_k: int = 128):
    """Differentiable blockwise (online-softmax) flash attention over
    ``[B, H, S, D]`` q/k/v — the long-context form, with the key axis
    tiled as well, so no tile's working set grows with S. ``segment_ids``
    is the packed slab's ``[B, S]`` int32 plane (ANDed with
    ``causal``). Returns O in q's dtype. ``block_q`` / ``block_k`` tile
    the plain version (CPU tensors); the CUDA kernel's tiles are 64 x 64.
    Use through :func:`bigdl_tpu_torch.kernels.attention`, which owns
    the K1/K2 routing."""
    if q.ndim != 4:
        raise ValueError(f"blockwise_flash_attention wants [B,H,S,D], got "
                         f"{tuple(q.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _BlockwiseFlashAttention.apply(
        q, k, v, segment_ids, bool(causal), float(sm_scale), int(block_q),
        int(block_k))
