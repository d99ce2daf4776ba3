"""Graph control flow (counterpart of ``bigdl_tpu.nn.control_ops``;
BigDL nn/ops/ControlOps.scala — SwitchOps :69, MergeOps :91 — and the
Scheduler's control-flow handling, nn/Scheduler.scala:118-130).

- :class:`SwitchOps` passes its ``T(data, pred)`` input's data to both
  branch outputs (1 false, 2 true); the choice moves to the matching
  Merge.
- :class:`MergeOps` selects between its branch inputs by the predicate
  of the Switch that controls them (resolved by the Graph at
  construction): a ``torch.where``, so both branches run, nothing is
  read back to the host and a CUDA graph captures it.
- :class:`IfThenElse` runs one branch, as the JAX package's
  ``lax.cond`` does; eagerly that is one host read of the predicate a
  forward, which a CUDA graph cannot capture: a K-step window over a
  model that holds one falls back to per-step sync (the Optimizer logs
  :attr:`IfThenElse.window_fallback`).
"""
from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.container import _run
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import T

__all__ = ["IfThenElse", "MergeOps", "SwitchOps"]


class SwitchOps(Module):
    """Input ``T(data, pred)``; output ``T(data, data)``, entry 1 the
    false branch and entry 2 the true one."""

    def forward(self, input):
        data = list(input)[0]
        return T(data, data)


class MergeOps(Module):
    """Whichever branch the controlling Switch's predicate selects.
    Inside a Graph the Graph selects (:meth:`select`); alone it takes
    ``T(false_value, true_value, pred)``."""

    def forward(self, input):
        xs = list(input)
        if len(xs) == 3:
            false_v, true_v, pred = xs
            return self.select(pred, true_v, false_v)
        raise ValueError(
            "MergeOps outside a Graph needs T(false_val, true_val, pred)")

    @staticmethod
    def select(pred, true_v, false_v):
        pred = torch.as_tensor(pred, device=true_v.device)
        return torch.where(pred.bool(), true_v, false_v)


class IfThenElse(Module):
    """Conditional: input ``T(pred, x)`` (or ``[pred, x]``), output
    ``then_branch(x)`` when ``pred`` is true, else ``else_branch(x)``;
    one branch runs. The branches are submodules ``then`` and ``else``,
    the JAX tree's keys; ``generator`` goes to the branch that runs."""

    #: the reason a K-step window runs this model one step a sync
    window_fallback = ("IfThenElse reads its predicate on the host to "
                       "run one branch")
    jax_tree_children = ("then", "else")

    def __init__(self, then_branch: Module, else_branch: Module):
        super().__init__()
        self.add_module("then", then_branch)
        self.add_module("else", else_branch)

    @property
    def then_branch(self) -> Module:
        return self._modules["then"]

    @property
    def else_branch(self) -> Module:
        return self._modules["else"]

    def regularization_loss(self):
        return (self.then_branch.regularization_loss()
                + self.else_branch.regularization_loss())

    def forward(self, input, generator: Optional[torch.Generator] = None):
        pred, x = list(input)[:2]
        branch = self.then_branch if bool(torch.as_tensor(pred)) \
            else self.else_branch
        return _run(branch, x, generator)
