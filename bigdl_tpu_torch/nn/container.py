"""Containers (counterpart of ``bigdl_tpu.nn.container``; BigDL
nn/Container.scala, Sequential.scala, ConcatTable.scala, Concat.scala).

Children are named ``"0"``, ``"1"``, ... in the order they are added —
the JAX package's param and state trees key containers the same way —
so a JAX tree maps onto the port's parameters and buffers by name
(:func:`bigdl_tpu_torch.convert.load_jax_params`), with no transpose.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["Concat", "ConcatTable", "Container", "Sequential"]


class Container(nn.Module):
    """Base container: ``add`` appends a child under the next index."""

    def __init__(self, *modules: nn.Module):
        super().__init__()
        for m in modules:
            self.add(m)

    def add(self, module: nn.Module) -> "Container":
        self.add_module(str(len(self._modules)), module)
        return self

    def __getitem__(self, i: int) -> nn.Module:
        return list(self._modules.values())[i]

    def __len__(self) -> int:
        return len(self._modules)


class Sequential(Container):
    """Feed-forward chain (nn/Sequential.scala:32)."""

    def forward(self, x):
        for m in self._modules.values():
            x = m(x)
        return x


class ConcatTable(Container):
    """Each child applied to the same input; the outputs as a list (a
    table) (nn/ConcatTable.scala)."""

    def forward(self, x):
        return [m(x) for m in self._modules.values()]


class Concat(Container):
    """Each child applied to the input, the outputs concatenated along
    ``dimension`` (1-based, as in Torch) (nn/Concat.scala)."""

    def __init__(self, dimension: int, *modules: nn.Module):
        super().__init__(*modules)
        self.dimension = dimension

    def forward(self, x):
        return torch.cat([m(x) for m in self._modules.values()],
                         dim=self.dimension - 1)
