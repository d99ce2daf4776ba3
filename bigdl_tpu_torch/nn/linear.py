"""Linear layers (counterpart of ``bigdl_tpu.nn.linear``; BigDL
nn/{Linear,MulConstant}.scala)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.nn.initialization import (InitializationMethod,
                                               RandomUniform)

__all__ = ["Linear", "MulConstant"]


class Linear(nn.Module):
    """Fully-connected layer ``y = x W^T + b`` (nn/Linear.scala). The
    weight is stored ``[out, in]`` as in Torch and the JAX package;
    both default to ``U(-1/sqrt(in), 1/sqrt(in))``. Parameters are
    built on the CPU from ``generator``; move the module after."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        w_init = init_weight or RandomUniform()
        b_init = init_bias or RandomUniform()
        self.weight = nn.Parameter(w_init((output_size, input_size),
                                          input_size, output_size,
                                          generator))
        self.bias = nn.Parameter(b_init((output_size,), input_size,
                                        output_size, generator)) \
            if with_bias else None

    def forward(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        y = x @ self.weight.T
        if self.bias is not None:
            y = y + self.bias
        return y[0] if squeeze else y


class MulConstant(nn.Module):
    """``x * scalar`` (nn/MulConstant.scala; ``ip`` is accepted and
    ignored, as in the JAX package)."""

    def __init__(self, scalar: float, ip: bool = False):
        super().__init__()
        self.scalar = scalar

    def forward(self, x):
        return x * self.scalar
