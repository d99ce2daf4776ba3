"""Ragged decode attention — read only ``lengths[i]`` valid KV rows per
slot (counterpart of ``bigdl_tpu.kernels.ragged_decode``).

One decode token per slot attends its slot's cache slice ``[T, D]``
per head, but only the first ``clamp(lengths[slot], 1, T)`` rows: a
slot 17 tokens into a 512 bucket reads 17 rows, not 512. The kernel is
CUDA C++ for Hopper (``csrc/ragged_decode.cu`` over
``csrc/decode_common.cuh``, whose header note has the design and the
byte bound): the keys of a (slot, head) are split across blocks as
:func:`decode_plan` says, and a second kernel merges the blocks'
partials. :func:`ragged_decode_attention_reference` is its plain
PyTorch version — the online-softmax recurrence of the TPU kernel over
``block_k`` tiles.

:func:`ragged_decode_attention` runs the plain version for a tensor on
the CPU, and launches the kernel for a CUDA tensor or raises: there is
no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Optional

import torch

from bigdl_tpu_torch.kernels.common import fit_block

__all__ = ["DecodePlan", "cuda_unsupported", "decode_plan",
           "ragged_decode_attention", "ragged_decode_attention_reference",
           "sm_count", "stage_keys"]

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


#: bytes of one tensor's rows a ring stage holds, and its most keys
#: (``csrc/decode_common.cuh``'s kStageBytes and Tile)
_STAGE_BYTES, _STAGE_MAX = 8192, 64
#: the least keys a block owns, the most splits of a (slot, head) (the
#: merge's length), and the blocks a plan gives each SM where T allows:
#: on an H100, 8 timed faster than 4 and 2 at the serving lengths
_MIN_CHUNK, _MAX_SPLITS, _BLOCKS_PER_SM = 64, 64, 8


class DecodePlan(NamedTuple):
    """How one K3 / K4 call splits its keys: block ``(slot, head,
    split)`` owns keys ``[split * chunk, (split + 1) * chunk)``, streamed
    in ring stages of ``stage_keys`` rows; ``grid`` is ``(slots, heads,
    splits)``. With ``splits > 1`` a second kernel merges the partials."""
    stage_keys: int
    chunk: int
    splits: int
    grid: tuple


def stage_keys(head_dim: int, itemsize: int) -> int:
    """Keys a ring stage holds for ``head_dim`` of ``itemsize`` bytes:
    8 KB of one tensor's rows at the kernel's head-dim tile (32, 64, 128
    or 256), at most 64 keys."""
    tile = next(t for t in (32, 64, 128, 256) if head_dim <= t or t == 256)
    return min(_STAGE_MAX, _STAGE_BYTES // (tile * itemsize))


@functools.lru_cache(maxsize=256)
def decode_plan(slots: int, heads: int, t_len: int, head_dim: int,
                itemsize: int, sms: int = 132, *,
                blocks_per_sm: int = _BLOCKS_PER_SM) -> DecodePlan:
    """The key split of a decode call on a card of ``sms`` SMs: chunks
    of whole ring stages, at least 64 keys, short enough that ``slots *
    heads * splits >= blocks_per_sm * sms`` where ``t_len`` allows, at
    most 64 splits. A function of the shapes only — never of the lengths
    (a device tensor: reading it would sync the decode loop) nor of a
    page size (K4 plans as K3 at ``t_len = pages_per_slot * page_size``,
    which keeps the two bitwise equal)."""
    sk = stage_keys(head_dim, itemsize)
    want = -(-blocks_per_sm * sms // max(1, slots * heads))
    if want == 1:
        chunk = -(-t_len // sk) * sk
    else:
        # the longest chunk that still gives ceil(t_len / chunk) >= want
        chunk = (t_len - 1) // (want - 1) // sk * sk
    chunk = max(chunk, _MIN_CHUNK, sk)
    if -(-t_len // chunk) > _MAX_SPLITS:
        per_split = -(-t_len // _MAX_SPLITS)
        chunk = -(-per_split // sk) * sk
    splits = -(-t_len // chunk)
    return DecodePlan(sk, chunk, splits, (slots, heads, splits))


_lib_lock = threading.Lock()
_launch_lock = threading.Lock()
_lib = None
#: multiprocessor count by device index, read once
_sms = {}

_CUDA_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16"}


def sm_count(device) -> int:
    """The multiprocessor count of a CUDA ``device``, cached."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


def _library():
    """The built kernel library with its ctypes signatures (built from
    ``csrc/ragged_decode.cu`` at first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            from bigdl_tpu_torch.kernels import _build

            lib = _build.load("ragged_decode")
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            for suffix in _CUDA_DTYPES.values():
                fn = getattr(lib, f"bigdl_ragged_decode_{suffix}")
                fn.argtypes = [p] * 6 + [i32] * 7 + [i64] * 10 + [
                    ctypes.c_float, i32, p]
                fn.restype = i32
            lib.bigdl_cuda_error_string.argtypes = [i32]
            lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def cuda_unsupported(q, k, v, lengths) -> Optional[str]:
    """Why the CUDA kernel does not take these operands (None when it
    does): float32, bfloat16 or float16 q/k/v of one dtype, head_dim 1
    to 256, T >= 1, contiguous last dimensions, contiguous int32
    lengths, one device."""
    d = k.shape[-1]
    if q.dtype not in _CUDA_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return (f"takes float32, bfloat16 or float16 q/k/v of one dtype, "
                f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if not 1 <= d <= 256:
        return f"needs head_dim in [1, 256], got {d}"
    if k.shape[2] < 1:
        return "needs a cache of T >= 1 rows"
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            return f"{name} is on {x.device}, q on {q.device}"
        if x.stride(-1) != 1:
            return (f"{name}'s last dimension must be contiguous (stride "
                    f"{x.stride(-1)})")
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or lengths.stride(0) != 1:
        return (f"lengths must be a contiguous int32 tensor on "
                f"{q.device}, got {lengths.dtype} on {lengths.device}")
    return None


def _check_cuda_operands(q, k, v, lengths) -> None:
    why = cuda_unsupported(q, k, v, lengths)
    if why is not None:
        raise ValueError(f"ragged_decode kernel {why}")


def ragged_decode_attention(q, k, v, lengths, *,
                            sm_scale: Optional[float] = None,
                            block_k: int = 128,
                            plan: Optional[DecodePlan] = None):
    """One decode step of attention over ragged KV: ``q [slots, H, D]``,
    ``k``/``v`` ``[slots, H, T, D]`` (any strides with a contiguous last
    dimension — the cache view is read in place), ``lengths [slots]``
    int32 valid rows per slot, clamped into ``[1, T]``. Returns
    ``[slots, H, D]`` in ``q.dtype``.

    CPU tensors run :func:`ragged_decode_attention_reference`
    (``block_k`` sets its tiling). CUDA tensors launch the kernel on the
    calling thread's current stream — its keys split as ``plan`` says
    (default :func:`decode_plan` of these shapes on this card), with the
    partials in scratch allocated for the call — or raise ValueError on
    what it does not take (:func:`cuda_unsupported`); each call adds one
    to ``ragged_decode_attention.launches`` (the split kernel and its
    merge count as one)."""
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
    if plan is None:
        plan = decode_plan(slots, h, t, d, q.element_size(),
                           sm_count(q.device))
    # the splits' partials (m, l, acc[d]): scratch of this call, on the
    # current stream (nothing is kept across calls)
    partials = (torch.empty((slots, h, plan.splits, d + 2),
                            dtype=torch.float32, device=q.device)
                if plan.splits > 1 else None)
    lib = _library()
    fn = getattr(lib, f"bigdl_ragged_decode_{_CUDA_DTYPES[q.dtype]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), None if partials is None else partials.data_ptr(),
            slots, h, t, d, plan.stage_keys, plan.chunk, plan.splits,
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


#: kernel calls so far (plain-version calls on the CPU do not count)
ragged_decode_attention.launches = 0
