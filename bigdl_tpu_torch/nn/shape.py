"""Shape layers (counterpart of ``bigdl_tpu.nn.shape``: View so far)."""
from __future__ import annotations

from torch import nn

__all__ = ["View"]


class View(nn.Module):
    """nn/View.scala: reshape to ``sizes``, keeping the batch dimension
    when the input has more than ``num_input_dims`` dims (or when the
    element count does not match ``sizes`` alone)."""

    def __init__(self, *sizes):
        super().__init__()
        if len(sizes) == 1 and isinstance(sizes[0], (list, tuple)):
            sizes = tuple(sizes[0])
        self.sizes = tuple(int(s) for s in sizes)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self

    def forward(self, x):
        n = 1
        for s in self.sizes:
            n *= s
        if self.num_input_dims > 0 and x.ndim > self.num_input_dims:
            return x.reshape((x.shape[0],) + self.sizes)
        if x.numel() == n:
            return x.reshape(self.sizes)
        return x.reshape((x.shape[0],) + self.sizes)
