"""Elementwise table ops (counterpart of ``bigdl_tpu.nn.table_ops``;
BigDL nn/{CAddTable,CSubTable,CMulTable,CDivTable,CMaxTable,
CMinTable}.scala). A table is a list, a tuple or a
:class:`~bigdl_tpu_torch.utils.table.Table`; its entries are folded
left to right."""
from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module

__all__ = ["CAddTable", "CDivTable", "CMaxTable", "CMinTable",
           "CMulTable", "CSubTable"]


class _TableReduce(Module):
    """``combine`` folded over the table's entries, left to right."""

    @staticmethod
    def combine(a, b):
        raise NotImplementedError

    def forward(self, table):
        items = list(table)
        out = items[0]
        for e in items[1:]:
            out = self.combine(out, e)
        return out


class CAddTable(_TableReduce):
    """nn/CAddTable.scala: the entries summed (``inplace`` is accepted
    and ignored, as in the JAX package)."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    combine = staticmethod(torch.add)


class CSubTable(_TableReduce):
    """nn/CSubTable.scala"""

    combine = staticmethod(torch.sub)


class CMulTable(_TableReduce):
    """nn/CMulTable.scala"""

    combine = staticmethod(torch.mul)


class CDivTable(_TableReduce):
    """nn/CDivTable.scala"""

    combine = staticmethod(torch.div)


class CMaxTable(_TableReduce):
    """nn/CMaxTable.scala (a tie splits the gradient in two, as
    ``jnp.maximum``'s does)."""

    combine = staticmethod(torch.maximum)


class CMinTable(_TableReduce):
    """nn/CMinTable.scala"""

    combine = staticmethod(torch.minimum)
