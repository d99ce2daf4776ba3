"""Containers (counterpart of ``bigdl_tpu.nn.container``; BigDL
nn/Container.scala, Sequential.scala, ConcatTable.scala, Concat.scala,
ParallelTable.scala, MapTable.scala, Bottle.scala, NarrowTable.scala,
MixtureTable.scala).

Children are named ``"0"``, ``"1"``, ... in the order they are added —
the JAX package's param and state trees key containers the same way —
so a JAX tree maps onto the port's parameters and buffers by name
(:func:`bigdl_tpu_torch.convert.load_jax_params`), with no transpose.

``ParallelTable``, ``MapTable`` and ``Bottle`` are Containers, so
``quantize`` walks into them; ``NarrowTable`` and ``MixtureTable`` hold
no child and are plain Modules, as in the JAX package.

``Sequential``, ``Concat``, ``ConcatTable``, ``ParallelTable``,
``MapTable`` and ``Bottle`` take ``forward(x, generator=None)`` and hand the one generator to each child whose
``forward`` takes ``generator=`` (a ``Dropout``, a nested container),
in the children's order, so the children draw from one stream one after
the other. The JAX containers split their key instead
(``bigdl_tpu.nn.container._split_rng``: one key a child). The masks of
the two packages differ in any case (``jax.random`` against a
``torch.Generator``); what the port keeps is that a run's masks follow
from the step's one seeded generator, which a CUDA-graph window
replays.
"""
from __future__ import annotations

import functools
import inspect
from typing import Dict, Optional

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table

__all__ = ["Bottle", "Concat", "ConcatTable", "Container", "MapTable",
           "MixtureTable", "NarrowTable", "ParallelTable", "Sequential"]


@functools.lru_cache(maxsize=None)
def forward_takes_generator(cls: type) -> bool:
    """Whether ``cls.forward`` takes a ``generator=`` keyword (the
    containers' hand-off and ``build_train_step`` both ask this)."""
    return "generator" in inspect.signature(cls.forward).parameters


def _run(child, x, generator):
    """``child(x)``, with ``generator=`` where its forward takes one."""
    if generator is not None and forward_takes_generator(type(child)):
        return child(x, generator=generator)
    return child(x)


class Container(Module):
    """Base container (nn/Container.scala:40): ``add`` appends a child
    under the next index. Penalties, gradient scales and freezing are
    the children's."""

    def __init__(self, *modules: Module):
        super().__init__()
        for m in modules:
            self.add(m)

    def add(self, module: Module) -> "Container":
        self.add_module(str(len(self._modules)), module)
        return self

    def __getitem__(self, i: int) -> Module:
        return list(self._modules.values())[i]

    def __len__(self) -> int:
        return len(self._modules)

    def regularization_loss(self):
        return sum(m.regularization_loss() for m in self._modules.values())

    def param_scales(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for key, m in self._modules.items():
            out.update((f"{key}.{name}", s)
                       for name, s in m.param_scales().items())
        return out

    def freeze(self) -> "Container":
        for m in self._modules.values():
            m.freeze()
        return self

    def unfreeze(self) -> "Container":
        for m in self._modules.values():
            m.unfreeze()
        return self

    def find(self, name: str) -> Optional[Module]:
        """The first descendant named ``name``, depth first (Container.apply
        in the reference), or None."""
        for m in self._modules.values():
            if m.get_name() == name:
                return m
            if isinstance(m, Container):
                found = m.find(name)
                if found is not None:
                    return found
        return None


class Sequential(Container):
    """Feed-forward chain (nn/Sequential.scala:32)."""

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for m in self._modules.values():
            x = _run(m, x, generator)
        return x


class ConcatTable(Container):
    """Each child applied to the same input; the outputs as a list (a
    table) (nn/ConcatTable.scala)."""

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return [_run(m, x, generator) for m in self._modules.values()]


class Concat(Container):
    """Each child applied to the input, the outputs concatenated along
    ``dimension`` (1-based, as in Torch) (nn/Concat.scala)."""

    def __init__(self, dimension: int, *modules: Module):
        super().__init__(*modules)
        self.dimension = dimension

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return torch.cat([_run(m, x, generator)
                          for m in self._modules.values()],
                         dim=self.dimension - 1)


class ParallelTable(Container):
    """The i-th child applied to the input table's i-th entry; the
    outputs as a list (nn/ParallelTable.scala)."""

    def forward(self, table, generator: Optional[torch.Generator] = None):
        return [_run(m, x, generator)
                for m, x in zip(self._modules.values(), list(table))]


class MapTable(Container):
    """One child, its weights shared, applied to every entry of the
    input table; the outputs as a list (nn/MapTable.scala)."""

    def __init__(self, module: Module):
        super().__init__(module)

    def forward(self, table, generator: Optional[torch.Generator] = None):
        m = self[0]
        return [_run(m, x, generator) for x in list(table)]


class Bottle(Container):
    """The child applied to the input with its leading dims folded into
    one: an input of more than ``n_input_dim`` dims keeps its last
    ``n_input_dim - 1`` and the output gets the folded dims back
    (nn/Bottle.scala)."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: int = 2):
        super().__init__(module)
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim

    def forward(self, x, generator: Optional[torch.Generator] = None):
        keep = x.ndim - self.n_input_dim + 1
        lead = tuple(x.shape[:keep])
        out = _run(self[0], x.reshape((-1,) + tuple(x.shape[keep:])),
                   generator)
        return out.reshape(lead + tuple(out.shape[1:]))


class NarrowTable(Module):
    """The input table's entries ``[offset, offset + length)`` (1-based;
    a non-positive ``length`` leaves ``-length`` entries off the end)
    as a list (nn/NarrowTable.scala)."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset = offset
        self.length = length

    def forward(self, table):
        items = list(table)
        length = self.length if self.length > 0 \
            else len(items) + self.length + 1 - (self.offset - 1)
        return items[self.offset - 1: self.offset - 1 + length]


class MixtureTable(Module):
    """Input ``(gater [B, E], experts)``, the experts a table of E
    tensors ``[B, ...]`` or one ``[B, E, ...]`` tensor: the sum over
    experts of ``gater[:, e]`` times expert ``e``
    (nn/MixtureTable.scala)."""

    def __init__(self, dim: int = None):
        super().__init__()
        self.dim = dim

    def forward(self, table):
        gater, experts = list(table)[:2]
        if isinstance(experts, (Table, list, tuple)):
            stacked = torch.stack([torch.as_tensor(e) for e in experts], 1)
        else:
            stacked = torch.as_tensor(experts)
        g = torch.as_tensor(gater)
        g = g.reshape(tuple(g.shape) + (1,) * (stacked.ndim - g.ndim))
        return (stacked * g).sum(1)
