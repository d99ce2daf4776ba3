"""The training driver (counterpart of ``bigdl_tpu.optim.optimizer``):
:func:`build_train_step` and :class:`Optimizer` / :class:`LocalOptimizer`.

The JAX package compiles loss, gradient and update into one jitted,
donated program; the port runs the same order eagerly — forward in
training mode, loss, ``backward()``, optional clipping, then the
OptimMethod's in-place update — and keeps the driver's host loop:
per-iteration learning rate from the OptimMethod, ``driver_state``
counters synced into ``optim_method.state``, a reshuffle at each epoch
rollover.

Not ported yet: validation, checkpoints and resume, train summaries,
the Optimizer's gradient-clipping setters,
``set_steps_per_sync`` windows, ZeRO, precision policies and loss
scaling, sequence parallelism, failure retry and preemption, device-fed
datasets, and the multi-card ``DistriOptimizer``.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

import torch

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger, max_epoch

__all__ = ["LocalOptimizer", "Optimizer", "build_train_step"]

logger = logging.getLogger(__name__)


def build_train_step(module: torch.nn.Module, criterion: Criterion,
                     optim_method: OptimMethod, gradient_clip=None):
    """One training step, ``step(inputs, targets, lr) -> loss``, in the
    JAX package's order: forward in training mode, loss, backward, then
    ``gradient_clip`` — ``("constant", min, max)`` clamps every gradient
    element, ``("l2norm", max_norm)`` scales the gradients so their
    global L2 norm is at most ``max_norm`` — then ``optim_method.update``
    on the parameters in place. Returns the data loss (a detached 0-d
    tensor on the module's device; reading it is the caller's sync).

    The OptimMethod's buffers (``init_state`` over the module's
    parameters, in ``named_parameters`` order) live in
    ``step.opt_state``."""
    if gradient_clip is not None and gradient_clip[0] not in (
            "constant", "l2norm"):
        raise ValueError(
            f"gradient_clip kind must be 'constant' or 'l2norm', got "
            f"{gradient_clip[0]!r}")
    params = [p for _, p in module.named_parameters()]
    opt_state = optim_method.init_state([p.detach() for p in params])

    def step(inputs, targets, lr: float):
        module.train()
        for p in params:
            p.grad = None
        loss = criterion(module(inputs), targets)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if gradient_clip is not None:
            with torch.no_grad():
                if gradient_clip[0] == "constant":
                    lo, hi = gradient_clip[1], gradient_clip[2]
                    grads = [g.clamp(lo, hi) for g in grads]
                else:
                    nrm = torch.sqrt(sum(g.float().square().sum()
                                         for g in grads))
                    scale = torch.clamp(
                        gradient_clip[1] / torch.clamp(nrm, min=1e-12),
                        max=1.0)
                    grads = [g * scale.to(g.dtype) for g in grads]
        optim_method.update(grads, opt_state, params, lr)
        return loss.detach()

    step.opt_state = opt_state
    return step


def _to_device(x, device):
    if isinstance(x, (list, tuple)):
        return [_to_device(e, device) for e in x]
    if x is None:
        return None
    return torch.as_tensor(x).to(device, non_blocking=True)


class Optimizer:
    """Driver loop and fluent config surface (``optim/Optimizer.scala``
    in the reference). Trains ``model`` on ``dataset`` (yielding
    :class:`~bigdl_tpu_torch.dataset.sample.MiniBatch`) under
    ``criterion`` until the end trigger fires; batches are moved to the
    model's device.

    ``driver_state`` holds ``epoch``, ``neval`` (1-based, the next
    iteration), ``recordsProcessedThisEpoch`` and, after a step,
    ``Loss``, ``LearningRate`` and ``Throughput``; ``history`` keeps one
    record per step (``neval``, ``epoch``, ``loss``, ``lr``,
    ``seconds`` — the step's wall time, batch transfer included)."""

    def __init__(self, model: torch.nn.Module, dataset: AbstractDataSet,
                 criterion: Criterion, batch_size: int = 32):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.batch_size = batch_size
        self.optim_method: OptimMethod = SGD()
        self.end_when: Optional[Trigger] = None
        self.driver_state: Dict[str, Any] = {"epoch": 1, "neval": 1,
                                             "recordsProcessedThisEpoch": 0}
        self.history: List[Dict[str, float]] = []

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def optimize(self) -> torch.nn.Module:
        """Run the loop until the end trigger (default ``max_epoch(10)``)
        fires; returns the trained model (updated in place)."""
        model = self.model
        model.train()
        device = self._device()
        state = self.driver_state
        # epoch/iteration-driven schedules read the OptimMethod's state
        for k in ("epoch", "neval"):
            self.optim_method.state[k] = state[k]
        step = build_train_step(model, self.criterion, self.optim_method)
        end_when = self.end_when or max_epoch(10)
        ds_size = self.dataset.size()
        data_iter = self.dataset.data(train=True)
        wall_start = time.perf_counter()
        while not end_when(state):
            t0 = time.perf_counter()
            batch = next(data_iter)
            if not isinstance(batch, MiniBatch):
                raise ValueError(
                    "dataset must yield MiniBatch; add SampleToMiniBatch")
            inp = _to_device(batch.get_input(), device)
            tgt = _to_device(batch.get_target(), device)
            lr = self.optim_method.update_hyper_parameter()
            loss_f = float(step(inp, tgt, lr))   # the per-step sync
            seconds = time.perf_counter() - t0
            bsz = batch.size()

            state["neval"] += 1
            self.optim_method.state["neval"] = state["neval"]
            state["recordsProcessedThisEpoch"] += bsz
            state["Loss"] = loss_f
            state["LearningRate"] = lr
            state["Throughput"] = bsz / max(1e-9, seconds)
            self.history.append({"neval": state["neval"] - 1,
                                 "epoch": state["epoch"], "loss": loss_f,
                                 "lr": lr, "seconds": seconds})
            logger.info(
                "Epoch %d iter %d: loss %.4f lr %.5f throughput %.1f rec/s",
                state["epoch"], state["neval"] - 1, loss_f, lr,
                state["Throughput"])
            # epoch rollover: a fresh permutation and iterator; the
            # overshoot of a batch that straddles the boundary is
            # dropped, as the JAX driver does for restartable iterators
            while state["recordsProcessedThisEpoch"] >= ds_size:
                state["epoch"] += 1
                self.optim_method.state["epoch"] = state["epoch"]
                state["recordsProcessedThisEpoch"] = 0
                self.dataset.shuffle()
                data_iter = self.dataset.data(train=True)
        logger.info("training done in %.1fs",
                    time.perf_counter() - wall_start)
        return model


class LocalOptimizer(Optimizer):
    """Single-process training on the model's device (one card, or the
    CPU)."""
