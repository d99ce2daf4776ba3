"""Normalization layers (counterpart of ``bigdl_tpu.nn.norm``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.nn.initialization import InitializationMethod
from bigdl_tpu_torch.utils.engine import default_dtype

__all__ = ["BatchNormalization", "LayerNorm", "SpatialBatchNormalization"]


class LayerNorm(nn.Module):
    """Layer normalization over the last dim.

    Statistics are taken in float32 with the population variance; the
    normalized value is cast back to the input dtype *before* the
    affine, so activations stay in their compute dtype (the JAX
    package's order, kept so the two agree in bf16 too)."""

    def __init__(self, hidden_size: int, eps: float = 1e-5):
        super().__init__()
        self.hidden_size = hidden_size
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(hidden_size, dtype=default_dtype()))
        self.bias = nn.Parameter(
            torch.zeros(hidden_size, dtype=default_dtype()))

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = x32.var(dim=-1, keepdim=True, unbiased=False)
        y = ((x32 - mu) * torch.rsqrt(var + self.eps)).to(x.dtype)
        return y * self.weight + self.bias


class BatchNormalization(nn.Module):
    """Batch norm over ``(B, F)`` (nn/BatchNormalization.scala), and over
    ``(B, C, H, W)`` as :class:`SpatialBatchNormalization` — the same
    code: the feature axis is 1 (0 for a 1-D input).

    The JAX package's state ``{running_mean, running_var}`` is a pair of
    buffers here. Evaluation mode normalizes with them in the JAX
    package's order: ``(x - mean) * rsqrt(var + eps)``, then ``* weight
    + bias``. Training mode (batch statistics and the running update)
    comes with the ResNet-50 training step and raises until then. The
    weight defaults to ``U(0, 1)`` and the bias to zeros, as in the
    reference's ``reset()``; parameters are built on the CPU from
    ``generator``."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 init_weight: Optional[InitializationMethod] = None,
                 init_bias: Optional[InitializationMethod] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        dt = default_dtype()
        if affine:
            w = (init_weight((n_output,), n_output, n_output, generator)
                 if init_weight is not None else
                 torch.rand((n_output,), dtype=dt, generator=generator))
            b = (init_bias((n_output,), n_output, n_output, generator)
                 if init_bias is not None else
                 torch.zeros((n_output,), dtype=dt))
            self.weight = nn.Parameter(w)
            self.bias = nn.Parameter(b)
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean",
                             torch.zeros((n_output,), dtype=dt))
        self.register_buffer("running_var", torch.ones((n_output,), dtype=dt))

    def _reshape(self, v, ndim: int):
        shape = [1] * ndim
        shape[1 if ndim > 1 else 0] = self.n_output
        return v.reshape(shape)

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNormalization training mode (batch statistics and "
                "the running-average update) is not ported yet; call "
                ".eval() to normalize with the running statistics")
        ndim = x.ndim
        inv = torch.rsqrt(self.running_var + self.eps)
        y = (x - self._reshape(self.running_mean, ndim)) \
            * self._reshape(inv, ndim)
        if self.affine:
            y = y * self._reshape(self.weight, ndim) \
                + self._reshape(self.bias, ndim)
        return y


class SpatialBatchNormalization(BatchNormalization):
    """BN over ``(B, C, H, W)`` (nn/SpatialBatchNormalization.scala) —
    the same code: the reduction axes follow the input's rank."""
