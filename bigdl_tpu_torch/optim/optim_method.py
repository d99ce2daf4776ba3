"""OptimMethods (counterpart of ``bigdl_tpu.optim.optim_method``).

The split follows the JAX package: the learning-rate schedule runs on
the host each iteration and mutates the method's own counters; the
update rule applies the step. The JAX rule is a pure function that
returns new parameters and state; the port's updates the parameters and
the state buffers IN PLACE under ``torch.no_grad()``, so a step
allocates no second copy of the weights.

A checkpoint holds the method's host state (:meth:`OptimMethod.get_state`)
and its buffers as the JAX package's opt_state tree: SGD's momentum is
``{"v": param tree}`` there and one list in ``named_parameters`` order
here (:meth:`OptimMethod.state_tree`, :meth:`OptimMethod.load_state_tree`).
The same tree carries a precision policy's float32 master copy
(``precision.MASTER_KEY``, a parameter-shaped tree) and the loss
scaler's state (``precision.SCALER_KEY``, three 0-d arrays).

The learning rate reaches ``update`` as a Python float or as a 0-d
tensor on the parameters' device (the driver stages it in
``default_dtype()``, as the JAX package stages its window's rates,
widened to a float64 model's dtype): a step captured into a CUDA graph
reads its rate from such a buffer instead of baking a constant in. A
float32 rate multiplies bitwise alike either way (torch rounds a Python
scalar to the tensor's dtype first).

Ported: the ``Default`` and ``EpochDecay`` schedules and :class:`SGD`.
Not ported yet: the other schedules (Step, MultiStep, EpochStep, Poly,
Plateau, Warmup, ...) and the other methods (Adam, Adagrad, LBFGS, ...).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Default", "EpochDecay", "LearningRateSchedule", "OptimMethod",
           "SGD"]


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


class EpochDecay(LearningRateSchedule):
    """``lr * 0.1 ** decay_fn(epoch)`` (SGD.scala EpochDecay), the epoch
    read from the method's state."""

    def __init__(self, decay_fn: Callable[[int], float]):
        self.decay_fn = decay_fn

    def update(self, optim):
        epoch = optim.state.get("epoch", 1)
        return optim.learning_rate * (0.1 ** self.decay_fn(epoch))


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

    def get_state(self) -> Dict[str, Any]:
        """A copy of the host state (what a checkpoint keeps)."""
        return dict(self.state)

    def load_state(self, state: Dict[str, Any]) -> "OptimMethod":
        self.state.update(state)
        return self

    @staticmethod
    def state_tree(opt_state: Dict[str, Any],
                   tree_of: Callable[[Sequence[torch.Tensor]], Any]
                   ) -> Dict[str, Any]:
        """The buffers as the JAX package's opt_state tree: each list
        of per-parameter tensors (the master copy's too) through
        ``tree_of`` (tensors in ``named_parameters`` order -> the param
        tree's shape), a dict of tensors (the scaler's state) as numpy
        arrays."""
        def host(v):
            if isinstance(v, list):
                return tree_of(v)
            if isinstance(v, dict):
                return {k: t.detach().cpu().numpy() for k, t in v.items()}
            return v
        return {k: host(v) for k, v in opt_state.items()}

    @staticmethod
    def load_state_tree(opt_state: Dict[str, Any], tree,
                        leaves_of: Callable[[Any], List[np.ndarray]],
                        device=None) -> None:
        """Copy a JAX opt_state tree into the buffers in place:
        ``leaves_of`` turns a param-shaped tree into arrays in
        ``named_parameters`` order. The method's own keys must be the
        buffers'. The precision keys (``MASTER_KEY``, ``SCALER_KEY``)
        the tree carries are copied into ``opt_state``'s entries, or
        made there on ``device`` (in the checkpoint's dtypes) where
        ``opt_state`` has none."""
        from bigdl_tpu_torch.precision.policy import MASTER_KEY, SCALER_KEY

        reserved = (MASTER_KEY, SCALER_KEY)
        own = {k for k in opt_state if k not in reserved}
        if {k for k in tree if k not in reserved} != own:
            raise KeyError(f"optimizer state keys {sorted(tree)} != this "
                           f"method's {sorted(own)}")

        def tensor(a):
            return torch.from_numpy(np.array(a)).to(device)

        with torch.no_grad():
            if MASTER_KEY in tree:
                arrays = leaves_of(tree[MASTER_KEY])
                if MASTER_KEY in opt_state:
                    for t, a in zip(opt_state[MASTER_KEY], arrays,
                                    strict=True):
                        t.copy_(tensor(a))
                else:
                    opt_state[MASTER_KEY] = [tensor(a) for a in arrays]
            if SCALER_KEY in tree:
                if SCALER_KEY in opt_state:
                    for k, t in opt_state[SCALER_KEY].items():
                        t.copy_(tensor(tree[SCALER_KEY][k]))
                else:
                    opt_state[SCALER_KEY] = {
                        k: tensor(a) for k, a in tree[SCALER_KEY].items()}
            for key in own:
                bufs = opt_state[key]
                if isinstance(bufs, list):
                    for t, a in zip(bufs, leaves_of(tree[key]), strict=True):
                        t.copy_(torch.from_numpy(np.array(a)))

    def init_state(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        """Device buffers for ``params`` (a list of tensors)."""
        return {}

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor], lr) -> None:
        """Apply one step to ``params`` and ``state`` in place; ``lr`` is
        a Python float or a 0-d tensor on the parameters' device (module
        docstring)."""
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
