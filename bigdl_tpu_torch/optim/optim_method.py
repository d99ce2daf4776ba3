"""OptimMethods (counterpart of ``bigdl_tpu.optim.optim_method``).

The split follows the JAX package: the learning-rate schedule runs on
the host each iteration and mutates the method's own counters; the
update rule applies the step. The JAX rule is a pure function that
returns new parameters and state; the port's updates the parameters and
the state buffers IN PLACE under ``torch.no_grad()``, so a step
allocates no second copy of the weights. The methods the JAX package
writes as chains of ``jax.tree.map`` (and lets XLA fuse) run here as
``torch._foreach_*`` ops over all the parameters at once, in the JAX
formula's order of operations; the gradients are never written.

A checkpoint holds the method's host state (:meth:`OptimMethod.get_state`)
and its buffers as the JAX package's opt_state tree: SGD's momentum is
``{"v": param tree}`` there and one list in ``named_parameters`` order
here (:meth:`OptimMethod.state_tree`, :meth:`OptimMethod.load_state_tree`);
Adam's and Adamax's step count ``t`` is a 0-d int32 tensor on the
parameters' device here and a 0-d int32 array there. The same tree
carries a precision policy's float32 master copy
(``precision.MASTER_KEY``, a parameter-shaped tree) and the loss
scaler's state (``precision.SCALER_KEY``, three 0-d arrays).

The learning rate reaches ``update`` as a Python float or as a 0-d
tensor on the parameters' device (the driver stages it in
``default_dtype()``, as the JAX package stages its window's rates,
widened to a float64 model's dtype): a step captured into a CUDA graph
reads its rate from such a buffer instead of baking a constant in. A
float32 rate multiplies bitwise alike either way (torch rounds a Python
scalar to the tensor's dtype first). For the same reason ``t`` is
advanced on the device and the bias corrections are computed from it
there: a Python number taken from ``t`` would be frozen into a captured
window, and every replay would apply the first step's correction.

Ported: every schedule (``Default``, ``Step``, ``MultiStep``,
``EpochStep``, ``EpochDecay``, ``Regime`` / ``EpochSchedule``, ``Poly``,
``NaturalExp``, ``Exponential``, ``Plateau``, ``Warmup``,
``SequentialSchedule``) and every method (:class:`SGD`, :class:`Adam`,
:class:`Adagrad`, :class:`Adadelta`, :class:`Adamax`, :class:`RMSprop`,
:class:`Ftrl`; ``LBFGS`` in :mod:`bigdl_tpu_torch.optim.lbfgs`).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["Adadelta", "Adagrad", "Adam", "Adamax", "Default", "EpochDecay",
           "EpochSchedule", "EpochStep", "Exponential", "Ftrl",
           "LearningRateSchedule", "MultiStep", "NaturalExp", "OptimMethod",
           "Plateau", "Poly", "RMSprop", "Regime", "SGD",
           "SequentialSchedule", "Step", "Warmup"]


# --------------------------------------------------------------------------
# Learning-rate schedules: host-side Python on floats and ints, the JAX
# package's arithmetic and counters, so the rates are bitwise its own.
# --------------------------------------------------------------------------

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


class Step(LearningRateSchedule):
    """``lr * gamma ** (evalCounter // step_size)`` (SGD.scala Step)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def update(self, optim):
        n = optim.state["evalCounter"]
        lr = optim.learning_rate * self.gamma ** (n // self.step_size)
        optim.state["evalCounter"] = n + 1
        return lr


class MultiStep(LearningRateSchedule):
    """``lr * gamma ** k``, ``k`` the milestones in ``step_sizes`` that
    ``evalCounter`` has reached (SGD.scala MultiStep)."""

    def __init__(self, step_sizes, gamma: float):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def update(self, optim):
        n = optim.state["evalCounter"]
        k = sum(1 for s in self.step_sizes if n >= s)
        optim.state["evalCounter"] = n + 1
        return optim.learning_rate * self.gamma ** k


class EpochStep(LearningRateSchedule):
    """``lr * gamma ** ((epoch - 1) // step_size)`` (SGD.scala
    EpochStep)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size = step_size
        self.gamma = gamma

    def update(self, optim):
        epoch = optim.state.get("epoch", 1)
        return optim.learning_rate * self.gamma ** (
            (epoch - 1) // self.step_size)


class EpochDecay(LearningRateSchedule):
    """``lr * 0.1 ** decay_fn(epoch)`` (SGD.scala EpochDecay), the epoch
    read from the method's state."""

    def __init__(self, decay_fn: Callable[[int], float]):
        self.decay_fn = decay_fn

    def update(self, optim):
        epoch = optim.state.get("epoch", 1)
        return optim.learning_rate * (0.1 ** self.decay_fn(epoch))


class Regime:
    """One row of an :class:`EpochSchedule`: ``config`` (keys
    ``learningRate``, ``weightDecay``, ``momentum``) for the epochs
    ``start_epoch..end_epoch`` (SGD.scala Regime)."""

    def __init__(self, start_epoch: int, end_epoch: int,
                 config: Dict[str, Any]):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.config = config


class EpochSchedule(LearningRateSchedule):
    """The rate of the regime the epoch falls in (SGD.scala
    EpochSchedule); a regime's ``weightDecay`` and ``momentum`` are set
    on the method. A training step reads those when it first runs (see
    ``optimizer.build_train_step``), as the JAX package's step reads
    them when it is traced: a regime that changes them in a later epoch
    changes neither package's step."""

    def __init__(self, regimes):
        self.regimes = list(regimes)

    def update(self, optim):
        epoch = optim.state.get("epoch", 1)
        lr = optim.learning_rate
        for r in self.regimes:
            if r.start_epoch <= epoch <= r.end_epoch:
                lr = r.config.get("learningRate", lr)
                if "weightDecay" in r.config:
                    optim.weight_decay = r.config["weightDecay"]
                if "momentum" in r.config:
                    optim.momentum = r.config["momentum"]
        return lr


class Poly(LearningRateSchedule):
    """``lr * (1 - evalCounter / max_iteration) ** power``, 0 from
    ``max_iteration`` on (SGD.scala Poly; the Inception recipe's
    ``Poly(0.5, ...)``)."""

    def __init__(self, power: float, max_iteration: int):
        self.power = power
        self.max_iteration = max_iteration

    def update(self, optim):
        n = optim.state["evalCounter"]
        optim.state["evalCounter"] = n + 1
        if n >= self.max_iteration:
            return 0.0
        return optim.learning_rate * (1.0 - n / self.max_iteration) \
            ** self.power


class NaturalExp(LearningRateSchedule):
    """``lr * exp(-gamma * (evalCounter // decay_step))`` (SGD.scala
    NaturalExp)."""

    def __init__(self, decay_step: int, gamma: float):
        self.decay_step = decay_step
        self.gamma = gamma

    def update(self, optim):
        n = optim.state["evalCounter"]
        optim.state["evalCounter"] = n + 1
        return optim.learning_rate * math.exp(
            -self.gamma * (n // self.decay_step))


class Exponential(LearningRateSchedule):
    """``lr * decay_rate ** (evalCounter / decay_step)``, the exponent
    floored with ``staircase`` (SGD.scala Exponential)."""

    def __init__(self, decay_step: int, decay_rate: float,
                 staircase: bool = False):
        self.decay_step = decay_step
        self.decay_rate = decay_rate
        self.staircase = staircase

    def update(self, optim):
        n = optim.state["evalCounter"]
        optim.state["evalCounter"] = n + 1
        p = n / self.decay_step
        if self.staircase:
            p = math.floor(p)
        return optim.learning_rate * self.decay_rate ** p


class Plateau(LearningRateSchedule):
    """Cuts the rate by ``factor`` (not below ``min_lr``) when the metric
    the driver records has not improved by ``epsilon`` for ``patience``
    records, then waits ``cooldown`` records (SGD.scala Plateau). The
    driver feeds it the first validation method's value through
    :meth:`record_metric`; a windowed driver runs per step with it."""

    def __init__(self, monitor: str = "score", factor: float = 0.1,
                 patience: int = 10, mode: str = "min",
                 epsilon: float = 1e-4, cooldown: int = 0,
                 min_lr: float = 0.0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.mode = mode
        self.epsilon = epsilon
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._lr = None
        self._best = None
        self._wait = 0
        self._cooldown_counter = 0

    def record_metric(self, value: float):
        if self._best is None:
            self._best = value
            return
        improved = (value < self._best - self.epsilon if self.mode == "min"
                    else value > self._best + self.epsilon)
        if self._cooldown_counter > 0:
            self._cooldown_counter -= 1
            self._wait = 0
        if improved:
            self._best = value
            self._wait = 0
        elif self._cooldown_counter <= 0:
            self._wait += 1
            if self._wait >= self.patience:
                self._lr = max(self._lr * self.factor, self.min_lr)
                self._cooldown_counter = self.cooldown
                self._wait = 0

    def update(self, optim):
        if self._lr is None:
            self._lr = optim.learning_rate
        return self._lr


class Warmup(LearningRateSchedule):
    """``lr + delta * evalCounter``: a linear warm-up (SGD.scala
    Warmup)."""

    def __init__(self, delta: float):
        self.delta = delta

    def update(self, optim):
        n = optim.state["evalCounter"]
        optim.state["evalCounter"] = n + 1
        return optim.learning_rate + self.delta * n


class SequentialSchedule(LearningRateSchedule):
    """Schedules one after another, each for its ``max_iteration`` calls,
    the last one on after that; the position is ``seqCounter`` in the
    method's state (SGD.scala SequentialSchedule)."""

    def __init__(self, iteration_per_epoch: int = 1):
        self.schedules = []
        self.iteration_per_epoch = iteration_per_epoch

    def add(self, schedule: LearningRateSchedule, max_iteration: int):
        self.schedules.append((schedule, max_iteration))
        return self

    def update(self, optim):
        n = optim.state.get("seqCounter", 0)
        optim.state["seqCounter"] = n + 1
        acc = 0
        for sched, max_it in self.schedules:
            if n < acc + max_it:
                return sched.update(optim)
            acc += max_it
        return self.schedules[-1][0].update(optim) if self.schedules else \
            optim.learning_rate


# --------------------------------------------------------------------------
# OptimMethods
# --------------------------------------------------------------------------

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
        tree's shape), a dict of tensors (the scaler's state) and a
        lone tensor (Adam's ``t``) as numpy arrays."""
        def host(v):
            if isinstance(v, list):
                return tree_of(v)
            if isinstance(v, dict):
                return {k: t.detach().cpu().numpy() for k, t in v.items()}
            if isinstance(v, torch.Tensor):
                return v.detach().cpu().numpy()
            return v
        return {k: host(v) for k, v in opt_state.items()}

    @staticmethod
    def load_state_tree(opt_state: Dict[str, Any], tree,
                        leaves_of: Callable[[Any], List[np.ndarray]],
                        device=None) -> None:
        """Copy a JAX opt_state tree into the buffers in place:
        ``leaves_of`` turns a param-shaped tree into arrays in
        ``named_parameters`` order, a lone tensor (Adam's ``t``) takes
        its 0-d array. The method's own keys must be the buffers'. The
        precision keys (``MASTER_KEY``, ``SCALER_KEY``) the tree carries
        are copied into ``opt_state``'s entries, or made there on
        ``device`` (in the checkpoint's dtypes) where ``opt_state`` has
        none."""
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
                elif isinstance(bufs, torch.Tensor):
                    bufs.copy_(torch.from_numpy(np.array(tree[key])))

    def init_state(self, params: Sequence[torch.Tensor]) -> Dict[str, Any]:
        """Device buffers for ``params`` (a list of tensors)."""
        return {}

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor], lr) -> None:
        """Apply one step to ``params`` and ``state`` in place; ``lr`` is
        a Python float or a 0-d tensor on the parameters' device (module
        docstring). ``grads`` are read, never written."""
        raise NotImplementedError


def _zeros(params) -> List[torch.Tensor]:
    return [torch.zeros_like(p) for p in params]


def _step_count(params) -> torch.Tensor:
    """A 0-d int32 step counter on the parameters' device."""
    device = params[0].device if len(params) else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _correction(beta: float, t: torch.Tensor) -> torch.Tensor:
    """``1 / (1 - beta ** t)`` in float32 on ``t``'s device, as
    ``jnp.power(beta, t.astype(float32))`` gives it."""
    return 1.0 / (1.0 - torch.pow(beta, t.to(torch.float32)))


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
            return {"v": _zeros(params)}
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


class Adam(OptimMethod):
    """Adam with bias correction (optim/Adam.scala)::

        t += 1
        m = beta1 * m + (1 - beta1) * grad
        v = beta2 * v + (1 - beta2) * grad * grad
        param -= lr * (m * mc) / (sqrt(v * vc) + epsilon)

    with ``mc = 1 / (1 - beta1 ** t)`` and ``vc = 1 / (1 - beta2 ** t)``
    in float32 on the device. The state is ``m`` and ``v`` (one tensor a
    parameter) and ``t`` (a 0-d int32 tensor)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def _compute_lr(self):
        return Default().update(self)

    def init_state(self, params):
        return {"m": _zeros(params), "v": _zeros(params),
                "t": _step_count(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        b1, b2 = self.beta1, self.beta2
        m, v, t = state["m"], state["v"], state["t"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - b2)
        t.add_(1)
        step = torch._foreach_mul(m, _correction(b1, t))
        torch._foreach_mul_(step, lr)
        den = torch._foreach_mul(v, _correction(b2, t))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(params, step)


class Adagrad(OptimMethod):
    """Adagrad (optim/Adagrad.scala)::

        grad += weightDecay * param
        accum += grad * grad
        param -= lr * grad / (sqrt(accum) + 1e-10)"""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.weight_decay = weight_decay

    def _compute_lr(self):
        return Default().update(self)

    def init_state(self, params):
        return {"accum": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        if self.weight_decay > 0:
            grads = torch._foreach_add(grads, params,
                                       alpha=self.weight_decay)
        accum = state["accum"]
        torch._foreach_addcmul_(accum, grads, grads)
        step = torch._foreach_mul(grads, lr)
        den = torch._foreach_sqrt(accum)
        torch._foreach_add_(den, 1e-10)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(params, step)


class Adadelta(OptimMethod):
    """Adadelta (optim/Adadelta.scala), at a rate of 1::

        accum_g = rho * accum_g + (1 - rho) * grad * grad
        dx = -sqrt(accum_dx + eps) / sqrt(accum_g + eps) * grad
        accum_dx = rho * accum_dx + (1 - rho) * dx * dx
        param += lr * dx"""

    def __init__(self, decay_rate: float = 0.9, epsilon: float = 1e-10):
        super().__init__()
        self.decay_rate = decay_rate
        self.epsilon = epsilon
        self.learning_rate = 1.0

    def _compute_lr(self):
        return 1.0

    def init_state(self, params):
        return {"accum_g": _zeros(params), "accum_dx": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        rho, eps = self.decay_rate, self.epsilon
        ag, adx = state["accum_g"], state["accum_dx"]
        torch._foreach_mul_(ag, rho)
        torch._foreach_addcmul_(ag, grads, grads, value=1 - rho)
        dx = torch._foreach_add(adx, eps)
        torch._foreach_sqrt_(dx)
        torch._foreach_neg_(dx)
        den = torch._foreach_add(ag, eps)
        torch._foreach_sqrt_(den)
        torch._foreach_div_(dx, den)
        torch._foreach_mul_(dx, grads)
        torch._foreach_mul_(adx, rho)
        torch._foreach_addcmul_(adx, dx, dx, value=1 - rho)
        torch._foreach_mul_(dx, lr)
        torch._foreach_add_(params, dx)


class Adamax(OptimMethod):
    """Adamax (optim/Adamax.scala)::

        t += 1
        m = beta1 * m + (1 - beta1) * grad
        u = max(beta2 * u, |grad| + epsilon)
        param -= lr * (1 / (1 - beta1 ** t)) * m / u

    ``epsilon`` defaults to the reference's 1e-38, below float32's
    smallest normal: torch keeps it as a subnormal, so a parameter whose
    gradient is exactly 0 stays where it is (``m / u = 0``). The JAX
    package's CPU backend flushes it to zero and makes that parameter
    NaN (0 / 0); the port does not copy that."""

    def __init__(self, learning_rate: float = 2e-3, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38):
        super().__init__()
        self.learning_rate = learning_rate
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def _compute_lr(self):
        return self.learning_rate

    def init_state(self, params):
        return {"m": _zeros(params), "u": _zeros(params),
                "t": _step_count(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        b1 = self.beta1
        m, u, t = state["m"], state["u"], state["t"]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1 - b1)
        torch._foreach_mul_(u, self.beta2)
        bound = torch._foreach_abs(grads)
        torch._foreach_add_(bound, self.epsilon)
        torch._foreach_maximum_(u, bound)
        t.add_(1)
        step = torch._foreach_mul(m, lr * _correction(b1, t))
        torch._foreach_div_(step, u)
        torch._foreach_sub_(params, step)


class RMSprop(OptimMethod):
    """RMSprop (optim/RMSprop.scala)::

        accum = rho * accum + (1 - rho) * grad * grad
        param -= lr * grad / (sqrt(accum) + epsilon)"""

    def __init__(self, learning_rate: float = 1e-2,
                 learning_rate_decay: float = 0.0,
                 decay_rate: float = 0.99, epsilon: float = 1e-8):
        super().__init__()
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.decay_rate = decay_rate
        self.epsilon = epsilon

    def _compute_lr(self):
        return Default().update(self)

    def init_state(self, params):
        return {"accum": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        rho = self.decay_rate
        accum = state["accum"]
        torch._foreach_mul_(accum, rho)
        torch._foreach_addcmul_(accum, grads, grads, value=1 - rho)
        step = torch._foreach_mul(grads, lr)
        den = torch._foreach_sqrt(accum)
        torch._foreach_add_(den, self.epsilon)
        torch._foreach_div_(step, den)
        torch._foreach_sub_(params, step)


class Ftrl(OptimMethod):
    """FTRL-proximal (later BigDL versions; the wide-and-deep use the
    SparseLinear path serves), per parameter::

        accum' = accum + grad * grad
        sigma = (accum' ** -power - accum ** -power) / lr
        linear += grad - sigma * param
        param = (clip(linear, -l1, l1) - linear)
                / (accum' ** -power / lr + 2 * l2)

    ``accum`` starts at ``initial_accumulator_value``; ``lr`` may be a
    0-d tensor (it divides)."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0):
        super().__init__()
        self.learning_rate = learning_rate
        self.lr_power = learning_rate_power
        self.init_accum = initial_accumulator_value
        self.l1 = l1_regularization_strength
        self.l2 = l2_regularization_strength

    def _compute_lr(self):
        return self.learning_rate

    def init_state(self, params):
        return {"accum": [torch.full_like(p, self.init_accum)
                          for p in params],
                "linear": _zeros(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr):
        power = -self.lr_power
        for p, g, a, lin in zip(params, grads, state["accum"],
                                state["linear"]):
            old = torch.pow(a, power)
            a.add_(g * g)
            new = torch.pow(a, power)
            sigma = (new - old) / lr
            lin.add_(g).sub_(sigma * p)
            quad = new / lr + 2 * self.l2
            p.copy_((lin.clamp(-self.l1, self.l1) - lin) / quad)
