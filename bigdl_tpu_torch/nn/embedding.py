"""Embedding layers (counterpart of ``bigdl_tpu.nn.embedding``; BigDL
nn/LookupTable.scala)."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.engine import default_dtype

__all__ = ["LookupTable"]


class LookupTable(Module):
    """Embedding lookup (nn/LookupTable.scala): ids are 1-based, as in
    the reference, and may be floats (truncated to an integer, as the
    JAX package casts them); id 0 reads the last row, as the JAX
    package's ``take`` wraps -1, and an id above ``n_index`` raises
    (the JAX package reads NaN there).

    ``max_norm`` scales the weight the forward reads by
    ``min(1, max_norm / norm)`` row by row, ``norm`` the rows'
    ``norm_type`` norm; the weight itself is not written, so the
    gradient flows through the scale (``F.embedding(max_norm=)``
    renormalizes in place: another function). ``padding_value``'s row
    (1-based) is zeroed at init. Rows are drawn standard normal on the
    CPU from ``generator``."""

    def __init__(self, n_index: int, n_output: int,
                 padding_value: float = 0.0, max_norm: float = math.inf,
                 norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False,
                 w_regularizer=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_index = n_index
        self.n_output = n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.w_regularizer = w_regularizer
        w = torch.randn((n_index, n_output), generator=generator,
                        dtype=default_dtype())
        if padding_value != 0.0:
            w[int(padding_value) - 1] = 0.0
        self.weight = nn.Parameter(w)

    def forward(self, ids):
        w = self.weight
        if self.max_norm != math.inf:
            norms = w.abs().pow(self.norm_type).sum(-1).pow(
                1.0 / self.norm_type)
            scale = torch.clamp(self.max_norm / norms.clamp(min=1e-7),
                                max=1.0)
            w = w * scale[:, None]
        return w[torch.as_tensor(ids, device=w.device).long() - 1]

    def regularization_loss(self):
        if self.w_regularizer is not None:
            return self.w_regularizer.loss(self.weight)
        return 0.0
