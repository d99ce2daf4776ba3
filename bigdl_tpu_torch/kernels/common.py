"""Helpers shared by the kernels' plain versions (counterpart of
``bigdl_tpu.kernels.common``)."""
from __future__ import annotations

__all__ = ["fit_block"]


def fit_block(dim: int, preferred: int) -> int:
    """The largest block size <= ``preferred`` that divides ``dim``
    (ragged shapes shrink the tile instead of falling off the tiled
    path)."""
    b = min(int(preferred), int(dim))
    while dim % b:
        b -= 1
    return b
