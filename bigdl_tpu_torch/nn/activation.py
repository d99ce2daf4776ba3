"""Activations (counterpart of ``bigdl_tpu.nn.activation``: ReLU and
Identity so far)."""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

__all__ = ["Identity", "ReLU"]


class ReLU(nn.Module):
    """nn/ReLU.scala (the ``ip`` flag is accepted and ignored, as in the
    JAX package)."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, x):
        return F.relu(x)


class Identity(nn.Module):
    """nn/Identity.scala"""

    def forward(self, x):
        return x
