"""Elementwise table ops (counterpart of ``bigdl_tpu.nn.table_ops``:
CAddTable so far). A table is a list or tuple of tensors."""
from __future__ import annotations

from bigdl_tpu_torch.nn.module import Module

__all__ = ["CAddTable"]


class CAddTable(Module):
    """nn/CAddTable.scala: the entries summed left to right (``inplace``
    is accepted and ignored, as in the JAX package)."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, entries):
        entries = list(entries)
        out = entries[0]
        for e in entries[1:]:
            out = out + e
        return out
