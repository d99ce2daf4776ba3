"""Int8 quantized GEMM/conv primitives — the BigQuant equivalent
(counterpart of ``bigdl_tpu.ops.quant``).

Quantization scheme (BigQuant's symmetric max-abs, as in the JAX
package):

- weights: per-output-channel symmetric int8, ``scale = max|w_row| /
  127``;
- activations: per-sample symmetric int8 at run time, or one calibrated
  per-tensor scale (``precision/calibrate.py``).

Every step computes in float32 in the JAX package's order, and
``torch.round`` rounds half to even as ``jnp.round`` does, so weights,
scales and int8 activations come out bitwise equal to the JAX
package's.

The integer product is exact: ``torch._int_mm`` where its shape rules
hold (more than 16 rows, the depth and the width multiples of 8; the
depth is padded with zeros, which adds nothing), else a float64
product cast back to int32 (every partial sum of int8 products is an
integer far below 2**53). A float32 product would not do: ``127**2 * K``
passes 2**24 once K > 1040.

PyTorch has no int8 convolution on the card, and a float32 convolution
is not exact at ResNet's depths (``K = 3*3*512 = 4608``), so
:func:`quantized_conv2d` is im2col: quantize the zero-padded float input
with the per-sample scale, gather its windows into ``[B*L, C*kh*kw]``
int8 rows (the column order of ``F.unfold``), take the exact integer
product above and apply the epilogue ``acc * x_scale * w_scale`` in that
order. Quantizing before the gather gives exactly the unfold-then-
quantize result — padding zeros quantize to 0, and an element's int8
value does not depend on the window that reads it — while moving a
byte per window element instead of a float's four and launching one
gather per convolution (``F.unfold`` launches one im2col per sample).
The JAX package leaves this convolution to XLA (no Pallas kernel), so
the port leaves the product to the library too; it never routes
through the int8 GEMM kernel (K5).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["int8_matmul", "quantize_symmetric", "quantize_with_scale",
           "quantized_conv2d", "quantized_linear", "scale_from_amax"]


def scale_from_amax(amax, eps: float = 1e-12):
    """The ONE symmetric int8 scale rule: ``scale = max(|x|) / 127``
    in float32. Weight quantization, dynamic activation quantization
    and offline calibration all derive their scales here."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    return torch.clamp_min(amax, eps) / 127.0


def quantize_with_scale(x, scale):
    """Quantize ``x`` to int8 with a precomputed ``scale`` (dynamic or
    calibrated): ``clip(round(x / scale), -127, 127)``."""
    return torch.round(x / scale).clamp_(-127, 127).to(torch.int8)


def quantize_symmetric(x, axis: int, eps: float = 1e-12):
    """Symmetric max-abs int8 quantization along all dims except
    ``axis``. Returns ``(q, scale)`` with ``x ~= q * scale``, ``q``
    int8 and ``scale`` shaped like ``x`` reduced to ``axis`` (kept
    dims)."""
    x = torch.as_tensor(x)
    dims = tuple(i for i in range(x.ndim) if i != axis % max(x.ndim, 1))
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs()
    scale = scale_from_amax(amax, eps)
    return quantize_with_scale(x, scale), scale


def _int_mm_ok(m: int, k: int, n: int) -> bool:
    """Whether ``torch._int_mm`` takes ``[m, k] @ [k, n]`` once k is
    padded to a multiple of 8 (its shape rules on the card)."""
    return m > 16 and n % 8 == 0 and k >= 1


def int8_matmul(x_q, w_q):
    """``x_q [M, K] int8 @ w_q [N, K] int8 ^T -> [M, N] int32``, exact
    (module docstring: ``torch._int_mm`` or a float64 product)."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if _int_mm_ok(m, k, n):
        pad = -k % 8
        if pad:
            x_q = F.pad(x_q, (0, pad))
            w_q = F.pad(w_q, (0, pad))
        return torch._int_mm(x_q.contiguous(), w_q.contiguous().t())
    return (x_q.double() @ w_q.double().t()).to(torch.int32)


def quantized_linear(x, w_q, w_scale, bias=None,
                     out_dtype=torch.float32, x_scale=None):
    """Full mixed-precision FC: per-row activation quantization, exact
    int8 GEMM, float32 rescale (BigQuant MixPrecisionGEMM semantics).

    ``x_scale=None`` estimates the activation scale per row; a
    CALIBRATED scalar ``x_scale`` skips the per-request amax."""
    x = x.float()
    if x_scale is None:
        x_q, x_scale = quantize_symmetric(x, axis=0)    # [M, 1] rows
    else:
        x_scale = torch.as_tensor(x_scale, dtype=torch.float32,
                                  device=x.device).reshape(1, 1)
        x_q = quantize_with_scale(x, x_scale)
    acc = int8_matmul(x_q, w_q)
    out = acc.float() * x_scale * w_scale.reshape(1, -1)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return out.to(out_dtype)


def quantized_conv2d(x, w_q, w_scale, bias=None, *,
                     stride: Tuple[int, int],
                     padding: Sequence[Tuple[int, int]],
                     n_group: int = 1, out_dtype=torch.float32,
                     x_scale=None):
    """Quantized NCHW conv as im2col (module docstring): ``x [B, Cin,
    H, W]`` float, ``w_q [Cout, Cin/g, kh, kw]`` int8, ``w_scale
    [Cout]``; ``stride = (sh, sw)`` and ``padding = [(top, bottom),
    (left, right)]`` as the JAX package takes them. A calibrated scalar
    ``x_scale`` replaces the per-sample estimate."""
    x = x.float()
    b, cin, _, _ = x.shape
    cout, cin_g, kh, kw = w_q.shape
    if cin != cin_g * n_group or cout % n_group:
        raise ValueError(f"input channels {cin} / weight {tuple(w_q.shape)}"
                         f" do not match n_group={n_group}")
    (pt, pb), (pl, pr) = padding
    if x_scale is None:
        x_scale = scale_from_amax(x.abs().amax(dim=(1, 2, 3), keepdim=True))
    else:
        x_scale = torch.as_tensor(x_scale, dtype=torch.float32,
                                  device=x.device).reshape(1, 1, 1, 1)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb))      # a negative pad crops
    x_q = quantize_with_scale(x, x_scale)                 # [B, C, Hp, Wp]
    ho = (x_q.shape[2] - kh) // stride[0] + 1
    wo = (x_q.shape[3] - kw) // stride[1] + 1
    # [B, C, Ho, Wo, kh, kw] windows (a view) -> rows ordered (C, kh, kw)
    win = x_q.unfold(2, kh, stride[0]).unfold(3, kw, stride[1])
    rows = win.permute(0, 2, 3, 1, 4, 5).reshape(b * ho * wo, cin * kh * kw)
    kg, ng = cin_g * kh * kw, cout // n_group
    w2 = w_q.reshape(cout, kg)
    acc = torch.cat([int8_matmul(rows[:, g * kg:(g + 1) * kg],
                                 w2[g * ng:(g + 1) * ng])
                     for g in range(n_group)], dim=1) if n_group > 1 \
        else int8_matmul(rows, w2)                        # [B*L, Cout]
    acc = acc.reshape(b, ho * wo, cout)
    out = acc.float() * x_scale.reshape(-1, 1, 1) * w_scale.reshape(1, 1, -1)
    if bias is not None:
        out = out + bias.reshape(1, 1, -1)
    out = out.transpose(1, 2).reshape(b, cout, ho, wo)
    return out.to(out_dtype).contiguous()
