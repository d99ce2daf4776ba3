"""Convolution (counterpart of ``bigdl_tpu.nn.conv``; BigDL
nn/SpatialConvolution.scala).

NCHW activations and OIHW weights, as in the JAX package, so a weight
carries over with no transpose. The product is PyTorch's float32
convolution (cuDNN on the card), as the JAX package leaves it to XLA,
in full float32: the layer switches cuDNN's TF32 default off before its
first run on the card (:func:`bigdl_tpu_torch.utils.engine.
full_float32`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform)
from bigdl_tpu_torch.utils.engine import full_float32

__all__ = ["SpatialConvolution"]


class SpatialConvolution(nn.Module):
    """2-D convolution over NCHW input (nn/SpatialConvolution.scala).

    Args follow the reference: ``(n_input_plane, n_output_plane,
    kernel_w, kernel_h, stride_w, stride_h, pad_w, pad_h, n_group)``.
    Weight and bias default to ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``.
    ``propagate_back=False`` detaches the input (no data gradient), as
    on the stem conv fed by raw images. Parameters are built on the
    CPU from ``generator``; move the module after."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 kernel_w: int, kernel_h: int,
                 stride_w: int = 1, stride_h: int = 1,
                 pad_w: int = 0, pad_h: int = 0,
                 n_group: int = 1, propagate_back: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 with_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pad_w < 0 or pad_h < 0:
            raise NotImplementedError(
                f"SpatialConvolution pad ({pad_w}, {pad_h}): negative "
                f"(SAME) padding is not ported")
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
        y = F.conv2d(x, self.weight, None, (self.stride_h, self.stride_w),
                     (self.pad_h, self.pad_w), 1, self.n_group)
        if self.bias is not None:
            y = y + self.bias.reshape(1, -1, 1, 1)
        return y[0] if squeeze else y


class _DefaultConvInit(InitializationMethod):
    """The reference conv ``reset()``: ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))``, weight and bias alike."""

    def __call__(self, shape, fan_in, fan_out, generator=None):
        stdv = 1.0 / math.sqrt(fan_in)
        return RandomUniform(-stdv, stdv)(shape, fan_in, fan_out, generator)
