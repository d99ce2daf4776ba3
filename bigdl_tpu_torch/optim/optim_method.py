"""OptimMethods (counterpart of ``bigdl_tpu.optim.optim_method``).

The split follows the JAX package: the learning-rate schedule runs on
the host each iteration and mutates the method's own counters; the
update rule applies the step. The JAX rule is a pure function that
returns new parameters and state; the port's updates the parameters and
the state buffers IN PLACE under ``torch.no_grad()``, so a step
allocates no second copy of the weights.

Ported: the ``Default`` schedule and :class:`SGD`. Not ported yet: the
other schedules (Step, MultiStep, EpochStep, Poly, Plateau, Warmup,
...) and the other methods (Adam, Adagrad, LBFGS, ...).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

__all__ = ["Default", "LearningRateSchedule", "OptimMethod", "SGD"]


class LearningRateSchedule:
    """Computes the current learning rate from the method's host state
    (``evalCounter``, ``epoch``, ``neval``)."""

    def update(self, optim: "OptimMethod") -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """``lr / (1 + evalCounter * learningRateDecay)``, advancing
    ``evalCounter`` by one per call."""

    def update(self, optim):
        n = optim.state["evalCounter"]
        lr = optim.learning_rate / (1 + n * optim.learning_rate_decay)
        optim.state["evalCounter"] = n + 1
        return lr


class OptimMethod:
    """Base optimizer. ``state`` is the host dict of counters (epoch,
    neval, evalCounter) the driver and the schedule share; the device
    buffers come from :meth:`init_state`."""

    def __init__(self):
        self.state: Dict[str, Any] = {"epoch": 1, "evalCounter": 0,
                                      "neval": 1}
        self.current_lr: float = 0.0

    def update_hyper_parameter(self) -> float:
        """Advance the schedule one iteration and return its rate."""
        self.current_lr = self._compute_lr()
        return self.current_lr

    def _compute_lr(self) -> float:
        return 0.0

    def init_state(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        """Device buffers for ``params`` (a list of tensors)."""
        return {}

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor], lr: float) -> None:
        """Apply one step to ``params`` and ``state`` in place."""
        raise NotImplementedError


class SGD(OptimMethod):
    """SGD with weight decay, momentum, dampening and nesterov, with the
    JAX package's (and Torch's) semantics::

        grad += weightDecay * param
        v = momentum * v + (1 - dampening) * grad
        step = grad + momentum * v   (nesterov)  |  v  (classic)
        param -= lr * step

    The momentum buffer ``v`` (one tensor per parameter) is the state."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[LearningRateSchedule]
                 = None):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        if nesterov and (momentum <= 0 or self.dampening != 0):
            # the reference requires dampening == 0 for nesterov
            self.dampening = 0.0
        self.learning_rate_schedule = learning_rate_schedule or Default()

    def _compute_lr(self):
        return self.learning_rate_schedule.update(self)

    def init_state(self, params):
        if self.momentum > 0:
            return {"v": [torch.zeros_like(p) for p in params]}
        return {}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        wd, mom, damp = self.weight_decay, self.momentum, self.dampening
        vs: List[Optional[torch.Tensor]] = state.get("v", [None] * len(params))
        for p, g, v in zip(params, grads, vs):
            if wd > 0:
                g = g + wd * p
            if mom > 0:
                v.mul_(mom).add_((1 - damp) * g)
                step = g + mom * v if self.nesterov else v
            else:
                step = g
            p.sub_(lr * step)
