"""Normalization layers (counterpart of ``bigdl_tpu.nn.norm``)."""
from __future__ import annotations

import torch
from torch import nn

from bigdl_tpu_torch.utils.engine import default_dtype

__all__ = ["LayerNorm"]


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
