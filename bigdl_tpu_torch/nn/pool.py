"""Pooling layers (counterpart of ``bigdl_tpu.nn.pool``; BigDL
nn/SpatialMaxPooling.scala et al.): spatial max and average, temporal
and volumetric max, and Fast R-CNN's region-of-interest max pooling.

Output sizes follow the reference's Torch rules in floor and ceil mode
(:func:`_pool_pads`, the JAX package's); each pool pads explicitly —
``-inf`` for max, zeros for average — and then runs PyTorch's unpadded
window op, so the windows are the JAX package's ``reduce_window``
windows exactly, whatever the pad (PyTorch's own padding stops at half
the kernel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module

__all__ = ["RoiPooling", "SpatialAveragePooling", "SpatialMaxPooling",
           "TemporalMaxPooling", "VolumetricMaxPooling"]

#: elements of one chunk of RoiPooling's gathered windows
#: (rois x bins x window x planes)
ROI_CHUNK_ELEMENTS = 1 << 25


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


class TemporalMaxPooling(Module):
    """1-D max pool over the time axis of ``[B, T, F]`` (or ``[T, F]``)
    (nn/TemporalMaxPooling.scala): windows of ``k_w`` every ``d_w``
    (default ``k_w``), no padding."""

    def __init__(self, k_w: int, d_w: int = None):
        super().__init__()
        self.k_w = k_w
        self.d_w = d_w if d_w is not None else k_w

    def forward(self, x):
        squeeze = x.ndim == 2
        if squeeze:
            x = x[None]
        y = F.max_pool1d(x.transpose(1, 2), self.k_w, self.d_w)
        y = y.transpose(1, 2)
        return y[0] if squeeze else y


class VolumetricMaxPooling(Module):
    """3-D max pool over ``[B, C, D, H, W]``
    (nn/VolumetricMaxPooling.scala); each pad is ``-inf`` on both sides,
    any size, and the output size is the floor rule's."""

    def __init__(self, kt: int, kw: int, kh: int,
                 dt: int = None, dw: int = None, dh: int = None,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0):
        super().__init__()
        self.kt, self.kw, self.kh = kt, kw, kh
        self.dt = dt if dt is not None else kt
        self.dw = dw if dw is not None else kw
        self.dh = dh if dh is not None else kh
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h

    def forward(self, x):
        squeeze = x.ndim == 4
        if squeeze:
            x = x[None]
        pads = (self.pad_w, self.pad_w, self.pad_h, self.pad_h,
                self.pad_t, self.pad_t)
        if any(pads):
            x = F.pad(x, pads, value=float("-inf"))
        y = F.max_pool3d(x, (self.kt, self.kh, self.kw),
                         (self.dt, self.dh, self.dw))
        return y[0] if squeeze else y


def _bin_bounds(lo, size, bins: int, extent: int):
    """``(start, end)`` ``[R, bins]`` int64 of each roi's bins along one
    axis, clipped to ``[0, extent]``: ``floor(i * size / bins) + lo`` to
    ``ceil((i + 1) * size / bins) + lo``, in the rois' dtype as the JAX
    package computes them."""
    step = size / bins
    i = torch.arange(bins, dtype=lo.dtype, device=lo.device)
    start = torch.floor(i * step[:, None]) + lo[:, None]
    end = torch.ceil((i + 1) * step[:, None]) + lo[:, None]
    return (start.clamp(0, extent).long(), end.clamp(0, extent).long())


def _window_index(start, end, width: int, extent: int):
    """``(index, inside)`` ``[R, bins, width]``: each bin's positions
    from ``start``, clamped into ``[0, extent)``, and whether each lies
    before ``end``."""
    idx = start[..., None] + torch.arange(width, device=start.device)
    return idx.clamp(max=extent - 1), idx < end[..., None]


class RoiPooling(Module):
    """Region-of-interest max pooling (nn/RoiPooling.scala). Input: a
    table ``(features [N, C, H, W], rois [R, 5])``, each roi ``(batch
    index, x1, y1, x2, y2)`` in input pixels; output ``[R, C, pooled_h,
    pooled_w]``.

    As in the JAX package: corners ``round(coordinate * spatial_scale)``
    (half to even), the roi at least 1 x 1, bin ``i`` of ``n`` spanning
    ``floor(i * size / n)`` to ``ceil((i + 1) * size / n)`` from the
    corner, clipped to the map; an empty bin gives 0; the gradient of a
    window's maximum is spread evenly over its ties (``jnp.max``'s).

    The JAX package masks the whole ``[C, H, W]`` map once per bin and
    roi. Here each bin's window is gathered (``[R, bins, window, C]``,
    the window as tall and wide as the largest bin), masked to its bin
    and reduced, rois in chunks of ``ROI_CHUNK_ELEMENTS``. The bounds
    are read on the host once a call."""

    def __init__(self, pooled_w: int, pooled_h: int, spatial_scale: float):
        super().__init__()
        self.pooled_w = pooled_w
        self.pooled_h = pooled_h
        self.spatial_scale = spatial_scale

    def forward(self, input):
        data, rois = list(input)[:2]
        rois = torch.as_tensor(rois, device=data.device)
        n, c, h, w = data.shape
        corners = torch.round(rois[:, 1:5] * self.spatial_scale)
        x1, y1, x2, y2 = corners.unbind(1)
        hs, he = _bin_bounds(y1, (y2 - y1 + 1.0).clamp(min=1.0),
                             self.pooled_h, h)
        ws, we = _bin_bounds(x1, (x2 - x1 + 1.0).clamp(min=1.0),
                             self.pooled_w, w)
        kh = max(int((he - hs).max()), 1)
        kw = max(int((we - ws).max()), 1)
        rows, row_in = _window_index(hs, he, kh, h)
        cols, col_in = _window_index(ws, we, kw, w)
        batch = rois[:, 0].to(torch.int32).long()
        batch = torch.where(batch < 0, batch + n, batch).clamp(0, n - 1)
        per_roi = self.pooled_h * kh * self.pooled_w * kw * c
        chunk = max(1, ROI_CHUNK_ELEMENTS // max(per_roi, 1))
        outs = []
        for r0 in range(0, rois.shape[0], chunk):
            sl = slice(r0, r0 + chunk)
            b = batch[sl][:, None, None, None, None]
            r = rows[sl][:, :, :, None, None]
            q = cols[sl][:, None, None, :, :]
            # [R, ph, kh, pw, kw, C]: the advanced indices' axes first
            win = data[b, :, r, q]
            inside = (row_in[sl][:, :, :, None, None]
                      & col_in[sl][:, None, None, :, :])[..., None]
            v = torch.where(inside, win, float("-inf")).amax(dim=(2, 4))
            outs.append(torch.where(torch.isfinite(v), v, 0.0))
        out = torch.cat(outs) if outs else data.new_zeros(
            (0, self.pooled_h, self.pooled_w, c))
        return out.permute(0, 3, 1, 2)
