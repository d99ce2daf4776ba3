"""Pooling layers (counterpart of ``bigdl_tpu.nn.pool``; BigDL
nn/SpatialMaxPooling.scala, nn/SpatialAveragePooling.scala).

Output sizes follow the reference's Torch rules in floor and ceil mode
(:func:`_pool_pads`, the JAX package's); each pool pads explicitly —
``-inf`` for max, zeros for average — and then runs PyTorch's unpadded
window op, so the windows are the JAX package's ``reduce_window``
windows exactly.
"""
from __future__ import annotations

import math

import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module

__all__ = ["SpatialAveragePooling", "SpatialMaxPooling"]


def _pool_pads(in_size: int, k: int, d: int, pad: int, ceil_mode: bool):
    """``(out, (lo, hi))``: the padding producing Torch's output size."""
    if ceil_mode:
        out = int(math.ceil(float(in_size - k + 2 * pad) / d)) + 1
    else:
        out = int(math.floor(float(in_size - k + 2 * pad) / d)) + 1
    if pad > 0 and (out - 1) * d >= in_size + pad:
        out -= 1  # Torch rule: last window must start inside the padded input
    needed = (out - 1) * d + k - in_size - pad
    return out, (pad, max(needed, pad))


def _padded(x, kh, kw, dh, dw, pad_h, pad_w, ceil_mode, value):
    _, (t, b) = _pool_pads(x.shape[2], kh, dh, pad_h, ceil_mode)
    _, (left, r) = _pool_pads(x.shape[3], kw, dw, pad_w, ceil_mode)
    if t or b or left or r:
        x = F.pad(x, (left, r, t, b), value=value)
    return x


class SpatialMaxPooling(Module):
    """2-D max pool over NCHW (nn/SpatialMaxPooling.scala); ``ceil()``
    / ``floor()`` pick the output-size mode."""

    def __init__(self, kw: int, kh: int, dw: int = None, dh: int = None,
                 pad_w: int = 0, pad_h: int = 0):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.ceil_mode = False

    def ceil(self) -> "SpatialMaxPooling":
        self.ceil_mode = True
        return self

    def floor(self) -> "SpatialMaxPooling":
        self.ceil_mode = False
        return self

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        x = _padded(x, self.kh, self.kw, self.dh, self.dw, self.pad_h,
                    self.pad_w, self.ceil_mode, float("-inf"))
        y = F.max_pool2d(x, (self.kh, self.kw), (self.dh, self.dw))
        return y[0] if squeeze else y


class SpatialAveragePooling(Module):
    """2-D average pool (nn/SpatialAveragePooling.scala).

    ``count_include_pad`` matches the JAX package: padded zeros, the
    ceil-mode overhang included, count in the divisor (``kh * kw``)
    when True (the default); otherwise the divisor is the number of
    real elements in the window. ``divide=False`` returns the window
    sums; ``global_pooling`` pools the whole plane."""

    def __init__(self, kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 global_pooling: bool = False,
                 ceil_mode: bool = False, count_include_pad: bool = True,
                 divide: bool = True):
        super().__init__()
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.global_pooling = global_pooling
        self.ceil_mode = ceil_mode
        self.count_include_pad = count_include_pad
        self.divide = divide

    def ceil(self) -> "SpatialAveragePooling":
        self.ceil_mode = True
        return self

    def _sum(self, x, kh, kw):
        x = _padded(x, kh, kw, self.dh, self.dw, self.pad_h, self.pad_w,
                    self.ceil_mode, 0.0)
        return F.avg_pool2d(x, (kh, kw), (self.dh, self.dw),
                            divisor_override=1)

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        kh, kw = self.kh, self.kw
        if self.global_pooling:
            kh, kw = x.shape[2], x.shape[3]
        summed = self._sum(x, kh, kw)
        if not self.divide:
            y = summed
        elif self.count_include_pad:
            y = summed / (kh * kw)
        else:
            y = summed / self._sum(x.new_ones((1, 1) + x.shape[2:]), kh, kw)
        return y[0] if squeeze else y
