"""The kernel dispatch layer — every hand-written kernel enters here
(counterpart of ``bigdl_tpu.kernels.dispatch``).

Routing follows the JAX package: the active
:class:`~bigdl_tpu_torch.kernels.config.KernelConfig` and the operands'
shapes decide, and a decline returns ``None`` so the caller runs its
einsum path. What differs is what a decline may be on the card:

- ``reason=config`` — the config switched the op off. The einsum path
  runs: the JAX package's kernels-off configuration, chosen explicitly.
- ``reason=vmem`` — flash past the working-set budget with
  ``long_context=False``: the einsum path runs, as in the JAX package.
- ``reason=shape`` — operands the kernel does not take (on a CUDA
  tensor, also a dtype or head_dim the CUDA kernel is not built for). On
  a CUDA tensor this raises; only a CPU tensor declines to the einsum
  path, on the JAX package's own conditions (decode: ``k`` not of rank
  4, ``q`` not ``k``'s shape without T, or a q/k/v dtype that is not
  floating). Operands the JAX package's kernel fails on too (decode: a
  ``v`` of another shape than ``k``, ``lengths`` not ``[slots]``) raise
  on every device.

A CUDA tensor that is routed to a kernel launches it or the call raises;
the plain PyTorch versions run only for tensors on the CPU (inside each
kernel's wrapper). Flash routes to the full-row kernel K1 inside the
working-set budget and to the blockwise kernel K2 past it (with
``long_context=True``), on the CPU and on the card alike. Decode routes
to K3 (:func:`decode_attention`) or, through a page table, to K4
(:func:`paged_decode_attention`); int8 to K5 (:func:`int8_matmul`) at
every shape — the JAX package's TPU alignment gate (``M % 256``,
``N % 256``, ``K % 512``) is not carried over (see
:mod:`bigdl_tpu_torch.kernels.int8_gemm`). Every decision is counted:
``kernels/dispatch/kernel`` (label ``op=flash|decode|int8``) and
``kernels/dispatch/reference`` (labels ``op=`` and
``reason=config|shape|vmem``), in
:data:`bigdl_tpu_torch.telemetry.REGISTRY`.
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.kernels import config as _config
from bigdl_tpu_torch.kernels import int8_gemm as _int8
from bigdl_tpu_torch.kernels import paged_decode as _paged
from bigdl_tpu_torch.kernels import ragged_decode as _ragged
from bigdl_tpu_torch.kernels.common import fit_block
from bigdl_tpu_torch.kernels.flash_attention import (
    blockwise_flash_attention, cuda_unsupported, flash_attention)

__all__ = ["attention", "decode_attention", "flash_route", "int8_matmul",
           "paged_decode_attention"]

_C_KERNEL = telemetry.counter(
    "kernels/dispatch/kernel",
    "calls routed to a hand-written kernel (label op=flash|decode|int8)")
_C_REFERENCE = telemetry.counter(
    "kernels/dispatch/reference",
    "calls declined to the einsum path (labels op=flash|decode|int8, "
    "reason=config|shape|vmem)")

#: flash routes: the full-row kernel, the blockwise long-context kernel,
#: or a decline with its reason
ROUTE_K1, ROUTE_K2 = "K1", "K2"


def _declined(op: str, reason: str) -> None:
    _C_REFERENCE.inc(op=op, reason=reason)


def _taken(op: str) -> None:
    _C_KERNEL.inc(op=op)


def _flash_vmem_bytes(q, block_q: int) -> int:
    """The JAX package's working-set estimate of one flash program (the
    backward's, which dominates): K and V at the input dtype and as f32,
    the dK/dV accumulators, four f32 ``[block_q, S]`` strips and four
    f32 ``[block_q, D]`` tiles. The port keeps the estimate and its
    budget so that one config routes the same shapes to K1 or K2 in both
    packages."""
    s, d = q.shape[-2], q.shape[-1]
    bq = fit_block(s, block_q)
    kv_inputs = 2 * s * d * q.dtype.itemsize
    kv_f32 = 2 * s * d * 4
    scratch = 2 * s * d * 4
    strips = 4 * bq * s * 4
    tiles = 4 * bq * d * 4
    return kv_inputs + kv_f32 + scratch + strips + tiles


def flash_route(q, k, v, config: Optional[_config.KernelConfig] = None
                ) -> str:
    """Where :func:`attention` sends these operands under ``config``
    (None: the active one): ``"K1"``, ``"K2"``, or the reason of a
    decline — ``"config"``, ``"shape"`` or ``"vmem"``. CPU tensors
    route as the JAX package routes them; CUDA tensors the CUDA kernel
    does not take (:func:`cuda_unsupported`) route to ``"shape"``."""
    cfg = _config.get_config() if config is None else config
    if not cfg.flash_attention:
        return "config"
    if (q.ndim != 4 or k.shape != q.shape or v.shape != q.shape
            or not all(x.dtype.is_floating_point for x in (q, k, v))):
        return "shape"
    if q.device.type == "cuda" and (
            cuda_unsupported(q.shape, q.dtype)
            or k.dtype != q.dtype or v.dtype != q.dtype):
        return "shape"
    if _flash_vmem_bytes(q, cfg.block_q) > cfg.resolve_vmem_budget():
        return ROUTE_K2 if cfg.long_context else "vmem"
    return ROUTE_K1


def attention(q, k, v, *, causal: bool = False, segment_ids=None,
              sm_scale: Optional[float] = None):
    """Flash-attention dispatch for ``[B, H, S, D]`` q/k/v with optional
    ``[B, S]`` segment ids. Returns the K1 result, or past the
    working-set budget the K2 result (:func:`flash_route`; the config's
    ``block_q`` / ``block_k`` tile the plain versions), or **None** when
    the config or (on the CPU) the shapes decline, telling the caller
    to run its einsum path. On a CUDA tensor a shape decline raises
    ValueError."""
    cfg = _config.get_config()
    route = flash_route(q, k, v, cfg)
    if route not in (ROUTE_K1, ROUTE_K2):
        _declined("flash", route)
        if route == "shape" and q.device.type == "cuda":
            why = (cuda_unsupported(q.shape, q.dtype) if q.ndim == 4
                   else None)
            raise ValueError(
                f"flash attention takes [B, H, S, D] q/k/v of one shape "
                f"and a floating dtype, got {tuple(q.shape)} / "
                f"{tuple(k.shape)} / {tuple(v.shape)} ({q.dtype}/"
                f"{k.dtype}/{v.dtype}){'; ' + why if why else ''}; switch "
                f"flash off in the KernelConfig to run the einsum path")
        return None
    _taken("flash")
    if route == ROUTE_K2:
        return blockwise_flash_attention(
            q, k, v, segment_ids, causal=causal, sm_scale=sm_scale,
            block_q=cfg.block_q, block_k=cfg.block_k)
    return flash_attention(q, k, v, segment_ids, causal=causal,
                           sm_scale=sm_scale, block_q=cfg.block_q)


def decode_attention(q, k, v, lengths, *,
                     sm_scale: Optional[float] = None):
    """Ragged-decode dispatch: ``q [slots, H, D]`` (one token per slot),
    ``k``/``v`` ``[slots, H, T, D]`` cache slices, ``lengths [slots]``
    int32 valid-KV rows per slot. Returns the kernel's result, or
    **None** when the config switches decode off, or when on the CPU the
    operands fail the JAX package's own test (``k`` not of rank 4, ``q``
    not ``[slots, H, D]`` of ``k``, a q/k/v dtype that is not floating;
    counted ``reason=shape``): the caller's length-masked einsum path
    runs. Mixed floating dtypes run the plain version on the CPU, which
    computes in float32, as the TPU kernel does. Raises ValueError,
    after counting ``reason=shape`` and never as a kernel call, where
    the JAX package's kernel fails too (``v`` not ``k``'s shape,
    ``lengths`` not ``[slots]``) and, on a CUDA tensor, on every operand
    the CUDA kernel does not take (:func:`~bigdl_tpu_torch.kernels.
    ragged_decode.cuda_unsupported`)."""
    if not _config.enabled("decode"):
        _declined("decode", "config")
        return None
    if (k.ndim != 4 or q.shape != k.shape[:2] + k.shape[3:]
            or not all(x.dtype.is_floating_point for x in (q, k, v))):
        _declined("decode", "shape")
        if q.device.type != "cpu":
            raise ValueError(
                f"decode takes q [slots, H, D] and k [slots, H, T, D] of "
                f"floating dtypes, got {tuple(q.shape)} / {tuple(k.shape)} "
                f"({q.dtype}/{k.dtype}/{v.dtype}); switch decode off in "
                f"the KernelConfig to run the einsum path")
        return None
    if v.shape != k.shape or lengths.shape != (k.shape[0],):
        _declined("decode", "shape")
        raise ValueError(f"decode takes v of k's shape {tuple(k.shape)} and "
                         f"lengths [slots] = ({k.shape[0]},), got "
                         f"{tuple(v.shape)} / {tuple(lengths.shape)}")
    if q.device.type == "cuda":
        why = _ragged.cuda_unsupported(q, k, v, lengths)
        if why is not None:
            _declined("decode", "shape")
            raise ValueError(f"ragged_decode kernel {why}")
    _taken("decode")
    return _ragged.ragged_decode_attention(
        q, k, v, lengths, sm_scale=sm_scale,
        block_k=_config.get_config().block_k)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths, *,
                           sm_scale: Optional[float] = None):
    """Paged ragged-decode dispatch: ``q [slots, H, D]`` one token per
    slot, ``k_pages`` / ``v_pages [num_pages, H, page_size, D]`` pools,
    ``page_table [slots, pages_per_slot]`` page ids, ``lengths`` the
    ragged bound. Returns K4's result
    (:mod:`bigdl_tpu_torch.kernels.paged_decode`) when decode is
    enabled and the shapes qualify, else **None** (the caller gathers
    its contiguous view and runs its own path): ``reason=config``, or
    ``reason=shape`` for operands of the wrong rank, heads, head_dim,
    table rows or a non-floating dtype — which on a CUDA tensor raises
    ValueError instead."""
    if not _config.enabled("decode"):
        _declined("decode", "config")
        return None
    if (k_pages.ndim != 4 or v_pages.shape != k_pages.shape
            or q.ndim != 3
            or tuple(q.shape[1:]) != (k_pages.shape[1], k_pages.shape[3])
            or page_table.ndim != 2
            or page_table.shape[0] != q.shape[0]
            or lengths.shape != (q.shape[0],)
            or not all(x.dtype.is_floating_point
                       for x in (q, k_pages, v_pages))):
        _declined("decode", "shape")
        if q.device.type == "cuda":
            raise ValueError(
                f"paged decode takes q [slots, H, D], pools [pages, H, P, "
                f"D] of one shape, a [slots, pages_per_slot] table and "
                f"[slots] lengths, got {tuple(q.shape)} / "
                f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)} / "
                f"{tuple(page_table.shape)} / {tuple(lengths.shape)}")
        return None
    if q.device.type == "cuda":
        why = _paged.cuda_unsupported(q, k_pages, v_pages, page_table,
                                      lengths)
        if why is not None:
            _declined("decode", "shape")
            raise ValueError(f"paged_decode kernel {why}")
    _taken("decode")
    return _paged.paged_decode_attention(q, k_pages, v_pages, page_table,
                                         lengths, sm_scale=sm_scale)


def int8_matmul(x_q, w_q, x_scale, w_scale, bias=None):
    """Fused dequant-int8-GEMM dispatch: ``x_q [M, K] int8 @ w_q [N, K]
    int8 ^T`` rescaled by ``x_scale`` (per row, or one calibrated scalar
    broadcast to the rows) and per-channel ``w_scale``. Returns K5's
    result — with ``bias`` added OUTSIDE the kernel, in this one add, so
    the path stays bitwise equal to dequantize-then-matmul — when
    ``int8`` is enabled, else **None** (the caller runs
    ``ops.quant.quantized_linear``). Every int8 shape is taken (no
    alignment gate, module docstring). Operands of the wrong rank or
    sizes are ``reason=shape``: None on the CPU; on a CUDA tensor, and
    for CUDA operands the kernel does not take (strided, non-int8),
    ValueError."""
    if not _config.enabled("int8"):
        _declined("int8", "config")
        return None
    m = x_q.shape[0] if x_q.ndim == 2 else -1
    if not hasattr(x_scale, "numel"):
        x_scale = torch.tensor(x_scale, dtype=torch.float32)
    if (x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[1]
            or x_scale.numel() not in (1, m)
            or w_scale.numel() != w_q.shape[0]):
        _declined("int8", "shape")
        if x_q.device.type == "cuda":
            raise ValueError(
                f"int8_matmul takes x_q [M, K], w_q [N, K], x_scale [M] or "
                f"a scalar and w_scale [N], got {tuple(x_q.shape)} / "
                f"{tuple(w_q.shape)} / {tuple(x_scale.shape)} / "
                f"{tuple(w_scale.shape)}")
        return None
    xs = x_scale.to(device=x_q.device, dtype=torch.float32) \
        .reshape(-1, 1).expand(m, 1).reshape(m).contiguous()
    if x_q.device.type == "cuda":
        why = _int8.cuda_unsupported(x_q, w_q, xs, w_scale)
        if why is not None:
            _declined("int8", "shape")
            raise ValueError(f"int8_gemm kernel: {why}")
    _taken("int8")
    out = _int8.int8_gemm(x_q, w_q, xs, w_scale)
    if bias is not None:
        # the ONE bias add both paths share (docs/kernels.md)
        out = out + bias.reshape(1, -1).float()
    return out
