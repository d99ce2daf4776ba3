"""Containers (counterpart of ``bigdl_tpu.nn.container``; BigDL
nn/Container.scala, Sequential.scala, ConcatTable.scala, Concat.scala).

Children are named ``"0"``, ``"1"``, ... in the order they are added —
the JAX package's param and state trees key containers the same way —
so a JAX tree maps onto the port's parameters and buffers by name
(:func:`bigdl_tpu_torch.convert.load_jax_params`), with no transpose.

``Sequential``, ``Concat`` and ``ConcatTable`` take ``forward(x,
generator=None)`` and hand the one generator to each child whose
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

__all__ = ["Concat", "ConcatTable", "Container", "Sequential"]


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
