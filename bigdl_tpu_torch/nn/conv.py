"""Convolution family (counterpart of ``bigdl_tpu.nn.conv``; BigDL
nn/SpatialConvolution.scala et al.): plain, shared, dilated, transposed
(full), temporal, volumetric and connection-table convolutions.

NCHW (NCDHW) activations and OIHW weights, as in the JAX package, so a
weight carries over with no transpose; a transposed convolution's
weight is Torch's ``[in, out / groups, kh, kw]``. The product is
PyTorch's float32 convolution (cuDNN on the card), as the JAX package
leaves it to XLA, in full float32: the layer switches cuDNN's TF32
default off before its first run on the card
(:func:`bigdl_tpu_torch.utils.engine.full_float32`).

A negative pad crops, as the JAX package's ``lax.conv_general_dilated``
reads it: the input loses that many rows or columns on each side, and
the convolution pads that side with nothing.

A transposed convolution runs unpadded and then crops ``pad`` from each
side and adds ``adj`` zero rows at the far end (:func:`_full_conv`):
the JAX package's padding ``(k - 1 - pad, k - 1 - pad + adj)`` of the
dilated input, for every ``pad`` and ``adj``, where PyTorch's
``output_padding`` must stay below the stride.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform)
from bigdl_tpu_torch.nn.module import Module, weight_penalty
from bigdl_tpu_torch.utils.engine import full_float32

__all__ = ["SpatialConvolution", "SpatialConvolutionMap",
           "SpatialDilatedConvolution", "SpatialFullConvolution",
           "SpatialShareConvolution", "TemporalConvolution",
           "VolumetricConvolution", "VolumetricFullConvolution",
           "crop_negative_padding"]


def crop_negative_padding(x, pad_h: int, pad_w: int):
    """``(x, pad_h, pad_w)`` with a negative pad applied as a crop of
    ``x`` (NCHW) on both sides of its dimension and returned as 0: what
    ``lax.conv_general_dilated`` does with a negative pad."""
    if pad_h >= 0 and pad_w >= 0:
        return x, pad_h, pad_w
    ch, cw = min(pad_h, 0), min(pad_w, 0)
    return F.pad(x, (cw, cw, ch, ch)), max(pad_h, 0), max(pad_w, 0)


class SpatialConvolution(Module):
    """2-D convolution over NCHW input (nn/SpatialConvolution.scala).

    Args follow the reference: ``(n_input_plane, n_output_plane,
    kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h, n_group)``.
    Weight and bias default to ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``.
    ``propagate_back=False`` detaches the input (no data gradient), as
    on the stem conv fed by raw images. A negative pad crops the input
    (module docstring). ``w_regularizer`` /
    ``b_regularizer`` add their penalties to
    :meth:`regularization_loss`. Parameters are built on the CPU from
    ``generator``; move the module after."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 with_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if n_input_plane % n_group or n_output_plane % n_group:
            raise ValueError(f"planes {n_input_plane}/{n_output_plane} do "
                             f"not divide into {n_group} groups")
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        self.n_group = n_group
        self.propagate_back = propagate_back
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        fan_in = n_input_plane // n_group * kernel_h * kernel_w
        fan_out = n_output_plane // n_group * kernel_h * kernel_w
        default = _DefaultConvInit()
        w_init = init_weight or default
        self.weight = nn.Parameter(w_init(
            (n_output_plane, n_input_plane // n_group, kernel_h, kernel_w),
            fan_in, fan_out, generator))
        self.bias = nn.Parameter((init_bias or default)(
            (n_output_plane,), fan_in, fan_out, generator)) \
            if with_bias else None

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if not self.propagate_back:
            x = x.detach()
        if x.is_cuda:
            full_float32()
        x, pad_h, pad_w = crop_negative_padding(x, self.pad_h, self.pad_w)
        y = F.conv2d(x, self.weight, None, (self.stride_h, self.stride_w),
                     (pad_h, pad_w), 1, self.n_group)
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1)
        return y[0] if squeeze else y

    def regularization_loss(self):
        return weight_penalty(self)


class SpatialShareConvolution(SpatialConvolution):
    """nn/SpatialShareConvolution.scala: the same arithmetic as
    :class:`SpatialConvolution` (the reference's buffer sharing has no
    counterpart here)."""


class SpatialDilatedConvolution(SpatialConvolution):
    """Atrous convolution (nn/SpatialDilatedConvolution.scala): the
    kernel's taps ``dilation`` apart; one group, the weight and bias
    drawn as :class:`SpatialConvolution`'s."""

    def __init__(self, n_input_plane: int, n_output_plane: int, kw: int,
                 kh: int, dw: int = 1, dh: int = 1, pad_w: int = 0,
                 pad_h: int = 0, dilation_w: int = 1, dilation_h: int = 1,
                 w_regularizer=None, b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_input_plane, n_output_plane, kw, kh, dw, dh,
                         pad_w, pad_h, 1, w_regularizer=w_regularizer,
                         b_regularizer=b_regularizer, generator=generator)
        self.dilation_w = dilation_w
        self.dilation_h = dilation_h

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if x.is_cuda:
            full_float32()
        x, pad_h, pad_w = crop_negative_padding(x, self.pad_h, self.pad_w)
        y = F.conv2d(x, self.weight, None, (self.stride_h, self.stride_w),
                     (pad_h, pad_w), (self.dilation_h, self.dilation_w))
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1)
        return y[0] if squeeze else y


def _full_conv(x, weight, stride, pads, adjs, groups: int = 1):
    """The transposed convolution of ``x`` (``[B, C, *spatial]``) as the
    JAX package computes it: the unpadded transposed product, then
    ``pad`` cropped from each side of every spatial axis and ``adj``
    zeros appended at its far end (the module docstring)."""
    conv = F.conv_transpose2d if x.ndim == 4 else F.conv_transpose3d
    y = conv(x, weight, None, stride, 0, 0, groups)
    edges = []
    for p, a in zip(reversed(pads), reversed(adjs)):
        edges += [-p, a - p]
    return F.pad(y, edges) if any(edges) else y


class SpatialFullConvolution(Module):
    """Transposed convolution (nn/SpatialFullConvolution.scala):
    ``out = (in - 1) * stride - 2 * pad + kernel + adj``, any ``adj``
    (:func:`_full_conv`). The weight is ``[in, out / n_group, kh, kw]``;
    weight and bias are ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` with
    ``fan_in = out / n_group * kh * kw``, drawn in that order. Groups
    split the input and output planes alike, as the JAX package's
    regrouped kernel does."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kw: int, kh: int, dw: int = 1, dh: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 w_regularizer=None, b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kw, self.kh = kw, kh
        self.dw, self.dh = dw, dh
        self.pad_w, self.pad_h = pad_w, pad_h
        self.adj_w, self.adj_h = adj_w, adj_h
        self.n_group = n_group
        self.with_bias = not no_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        fan_in = n_output_plane // n_group * kh * kw
        init = _DefaultConvInit()
        self.weight = nn.Parameter(init(
            (n_input_plane, n_output_plane // n_group, kh, kw), fan_in,
            fan_in, generator))
        self.bias = nn.Parameter(init((n_output_plane,), fan_in, fan_in,
                                      generator)) if self.with_bias else None

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if x.is_cuda:
            full_float32()
        y = _full_conv(x, self.weight, (self.dh, self.dw),
                       (self.pad_h, self.pad_w), (self.adj_h, self.adj_w),
                       self.n_group)
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1)
        return y[0] if squeeze else y

    def regularization_loss(self):
        return weight_penalty(self)


class TemporalConvolution(Module):
    """1-D convolution over ``[B, T, input_frame_size]`` (or ``[T,
    input_frame_size]``, the batch of one dropped again) to ``[B, T',
    output_frame_size]``, ``T' = (T - kernel_w) // stride_w + 1``: no
    padding (nn/TemporalConvolution.scala). The weight is ``[out, in,
    kernel_w]`` as in the JAX package; weight and bias default to
    ``U(-1/sqrt(in * kernel_w), ...)``. Parameters are built on the CPU
    from ``generator``."""

    def __init__(self, input_frame_size: int, output_frame_size: int,
                 kernel_w: int, stride_w: int = 1,
                 w_regularizer=None, b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_frame_size = input_frame_size
        self.output_frame_size = output_frame_size
        self.kernel_w = kernel_w
        self.stride_w = stride_w
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        fan_in = input_frame_size * kernel_w
        init = _DefaultConvInit()
        self.weight = nn.Parameter(init(
            (output_frame_size, input_frame_size, kernel_w), fan_in,
            output_frame_size * kernel_w, generator))
        self.bias = nn.Parameter(init((output_frame_size,), fan_in,
                                      output_frame_size * kernel_w,
                                      generator))

    def forward(self, x):
        squeeze = x.ndim == 2
        if squeeze:
            x = x[None]
        if x.is_cuda:
            full_float32()
        y = F.conv1d(x.transpose(1, 2), self.weight, None, self.stride_w)
        y = y.transpose(1, 2) + self.bias
        return y[0] if squeeze else y

    def regularization_loss(self):
        return weight_penalty(self)


class VolumetricConvolution(Module):
    """3-D convolution over ``[B, C, D, H, W]``
    (nn/VolumetricConvolution.scala); weight ``[out, in, kt, kh, kw]``,
    weight and bias ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``.
    ``w_regularizer`` / ``b_regularizer`` are kept and, as in the JAX
    package, add no penalty."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kt: int, kw: int, kh: int,
                 dt: int = 1, dw: int = 1, dh: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 with_bias: bool = True,
                 w_regularizer=None, b_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kt, self.kw, self.kh = kt, kw, kh
        self.dt, self.dw, self.dh = dt, dw, dh
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.with_bias = with_bias
        self.w_regularizer = w_regularizer
        self.b_regularizer = b_regularizer
        fan_in = n_input_plane * kt * kh * kw
        init = _DefaultConvInit()
        self.weight = nn.Parameter(init(
            (n_output_plane, n_input_plane, kt, kh, kw), fan_in, fan_in,
            generator))
        self.bias = nn.Parameter(init((n_output_plane,), fan_in, fan_in,
                                      generator)) if with_bias else None

    def forward(self, x):
        squeeze = x.ndim == 4
        if squeeze:
            x = x[None]
        if x.is_cuda:
            full_float32()
        y = F.conv3d(x, self.weight, None, (self.dt, self.dh, self.dw),
                     (self.pad_t, self.pad_h, self.pad_w))
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1, 1)
        return y[0] if squeeze else y


class VolumetricFullConvolution(Module):
    """3-D transposed convolution (nn/VolumetricFullConvolution.scala),
    any ``adj`` (:func:`_full_conv`). The weight is ``[in, out, kt, kh,
    kw]``, ``fan_in = out * kt * kh * kw``: as in the JAX package,
    ``n_group`` is accepted and ignored."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kt: int, kw: int, kh: int,
                 dt: int = 1, dw: int = 1, dh: int = 1,
                 pad_t: int = 0, pad_w: int = 0, pad_h: int = 0,
                 adj_t: int = 0, adj_w: int = 0, adj_h: int = 0,
                 n_group: int = 1, no_bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_input_plane = n_input_plane
        self.n_output_plane = n_output_plane
        self.kt, self.kw, self.kh = kt, kw, kh
        self.dt, self.dw, self.dh = dt, dw, dh
        self.pad_t, self.pad_w, self.pad_h = pad_t, pad_w, pad_h
        self.adj_t, self.adj_w, self.adj_h = adj_t, adj_w, adj_h
        self.with_bias = not no_bias
        fan_in = n_output_plane * kt * kh * kw
        init = _DefaultConvInit()
        self.weight = nn.Parameter(init(
            (n_input_plane, n_output_plane, kt, kh, kw), fan_in, fan_in,
            generator))
        self.bias = nn.Parameter(init((n_output_plane,), fan_in, fan_in,
                                      generator)) if self.with_bias else None

    def forward(self, x):
        squeeze = x.ndim == 4
        if squeeze:
            x = x[None]
        if x.is_cuda:
            full_float32()
        y = _full_conv(x, self.weight, (self.dt, self.dh, self.dw),
                       (self.pad_t, self.pad_h, self.pad_w),
                       (self.adj_t, self.adj_h, self.adj_w))
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1, 1)
        return y[0] if squeeze else y


class SpatialConvolutionMap(Module):
    """Convolution with an explicit input-to-output connection table
    (nn/SpatialConvolutionMap.scala, LeNet-5's partial connectivity):
    ``conn_table`` is ``[n_connections, 2]`` of 1-based ``(input plane,
    output plane)``. A full convolution whose ``[out, in, kh, kw]``
    weight is multiplied by the table's 0/1 mask, so an unconnected
    entry takes no part and gets a zero gradient. Weight and bias are
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, ``fan_in`` the most
    connections of one output times ``kh * kw``."""

    def __init__(self, conn_table, kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        table = np.asarray(conn_table, np.int64)
        self.conn_table = table
        self.n_input_plane = int(table[:, 0].max())
        self.n_output_plane = int(table[:, 1].max())
        self.kernel_w, self.kernel_h = kernel_w, kernel_h
        self.stride_w, self.stride_h = stride_w, stride_h
        self.pad_w, self.pad_h = pad_w, pad_h
        mask = np.zeros((self.n_output_plane, self.n_input_plane, 1, 1),
                        np.float32)
        for i, o in table:
            mask[int(o) - 1, int(i) - 1, 0, 0] = 1.0
        self._mask = torch.from_numpy(mask)
        fan_in = max(1, int(mask.sum(axis=(1, 2, 3)).max())) \
            * kernel_h * kernel_w
        init = _DefaultConvInit()
        self.weight = nn.Parameter(init(
            (self.n_output_plane, self.n_input_plane, kernel_h, kernel_w),
            fan_in, fan_in, generator))
        self.bias = nn.Parameter(init((self.n_output_plane,), fan_in,
                                      fan_in, generator))

    def forward(self, x):
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        if x.is_cuda:
            full_float32()
        x, pad_h, pad_w = crop_negative_padding(x, self.pad_h, self.pad_w)
        w = self.weight * self._mask.to(x.device)
        y = F.conv2d(x, w, None, (self.stride_h, self.stride_w),
                     (pad_h, pad_w))
        y = y + self.bias.reshape(1, -1, 1, 1)
        return y[0] if squeeze else y


class _DefaultConvInit(InitializationMethod):
    """The reference conv ``reset()``: ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))``, weight and bias alike."""

    def __call__(self, shape, fan_in, fan_out, generator=None):
        stdv = 1.0 / math.sqrt(fan_in)
        return RandomUniform(-stdv, stdv)(shape, fan_in, fan_out, generator)
