"""The training driver (counterpart of ``bigdl_tpu.optim.optimizer``):
:func:`build_train_step`, :func:`build_eval_step` and :class:`Optimizer`
/ :class:`LocalOptimizer`.

The JAX package compiles loss, gradient and update into one jitted,
donated program; the port runs the same order eagerly — forward in
training mode, loss plus the module's regularization penalty,
``backward()``, the gradients scaled by the module's ``param_scales``,
optional clipping, then the OptimMethod's in-place update — and keeps
the driver's host loop: per-iteration learning rate from the
OptimMethod, ``driver_state`` counters synced into
``optim_method.state``, a reshuffle at each epoch rollover, then the
validation trigger, then the checkpoint trigger.

Checkpoints are the JAX package's format 2
(:mod:`bigdl_tpu_torch.utils.serialization`), written synchronously, and
``optimize()`` resumes from the newest intact one under the checkpoint
path (a corrupt one is quarantined and the walk goes back), so a run
checkpointed by either package resumes in the other.

Not ported yet: the elastic checkpoint options (``keep_last``,
``async_write``) and fault points, train and validation summaries,
``set_steps_per_sync`` windows, ZeRO, precision policies and loss
scaling, sequence parallelism, failure retry and preemption, device-fed
and device-cached datasets, and the multi-card ``DistriOptimizer``.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch.convert import (export_params, export_state,
                                     flatten_params, jax_tree,
                                     load_jax_params)
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch
from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger, max_epoch
from bigdl_tpu_torch.optim.validation import ValidationMethod

__all__ = ["LocalOptimizer", "Optimizer", "build_eval_step",
           "build_train_step"]

logger = logging.getLogger(__name__)


def build_train_step(module: Module, criterion: Criterion,
                     optim_method: OptimMethod, gradient_clip=None):
    """One training step, ``step(inputs, targets, lr) -> loss``, in the
    JAX package's order: forward, loss plus
    ``module.regularization_loss()``, backward, each gradient times its
    ``module.param_scales()`` factor (0 for a frozen layer), then
    ``gradient_clip`` — ``("constant", min, max)`` clamps every gradient
    element, ``("l2norm", max_norm)`` scales the gradients so their
    global L2 norm is at most ``max_norm`` — then ``optim_method.update``
    on the parameters in place. Returns the data loss, without the
    penalty (a detached 0-d tensor on the module's device; reading it is
    the caller's sync).

    The module is put in training mode when the step is built (a layer
    set to evaluation mode after that stays so, as in a torch loop);
    the scales are read then too, as the JAX package reads them when it
    traces its step. The OptimMethod's buffers (``init_state`` over the
    module's parameters, in ``named_parameters`` order) live in
    ``step.opt_state``."""
    if gradient_clip is not None and gradient_clip[0] not in (
            "constant", "l2norm"):
        raise ValueError(
            f"gradient_clip kind must be 'constant' or 'l2norm', got "
            f"{gradient_clip[0]!r}")
    named = list(module.named_parameters())
    params = [p for _, p in named]
    opt_state = optim_method.init_state([p.detach() for p in params])
    scales = module.param_scales()
    factors = [scales[name] for name, _ in named]
    scaled = any(f != 1.0 for f in factors)
    module.train()

    def step(inputs, targets, lr: float):
        for p in params:
            p.grad = None
        loss = criterion(module(inputs), targets)
        reg = module.regularization_loss()
        (loss + reg if torch.is_tensor(reg) else loss).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if scaled:
            grads = [g if f == 1.0 else g * f
                     for g, f in zip(grads, factors)]
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


def build_eval_step(module: Module):
    """The evaluation forward, ``eval_step(inputs) -> output``: the
    module in evaluation mode under ``torch.inference_mode`` (the
    caller puts it back in training mode)."""
    def eval_step(inputs):
        module.eval()
        with torch.inference_mode():
            return module(inputs)

    return eval_step


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
    ``Loss``, ``LearningRate`` and ``Throughput`` (and ``score`` after a
    validation); ``history`` keeps one record per step (``neval``,
    ``epoch``, ``loss``, ``lr``, ``rows``, ``seconds`` — the step's wall
    time, batch transfer included), ``validation_history`` each
    validation's ``{method name: value}``, ``resumed_from`` the
    checkpoint the last ``optimize()`` resumed from (``{"path",
    "neval"}``, or None)."""

    def __init__(self, model: Module, dataset: AbstractDataSet,
                 criterion: Criterion, batch_size: int = 32):
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.batch_size = batch_size
        self.optim_method: OptimMethod = SGD()
        self.end_when: Optional[Trigger] = None
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset = None
        self.validation_methods: List[ValidationMethod] = []
        self._val_batch_size = batch_size
        self._gradient_clip = None
        self.driver_state: Dict[str, Any] = {"epoch": 1, "neval": 1,
                                             "recordsProcessedThisEpoch": 0}
        self.history: List[Dict[str, float]] = []
        self.validation_history: List[Dict[str, float]] = []
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.is_overwrite = False
        self.resumed_from: Optional[Dict[str, Any]] = None

    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_validation(self, trigger: Trigger, dataset,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None) -> "Optimizer":
        """Score ``dataset`` (MiniBatches or Samples) with ``methods``
        whenever ``trigger`` fires after a step (Optimizer.scala
        setValidation); the first method's value becomes
        ``driver_state["score"]``."""
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = list(methods)
        self._val_batch_size = batch_size or self.batch_size
        return self

    def set_checkpoint(self, path: str, trigger: Trigger, *,
                       keep_last: Optional[int] = None,
                       async_write: bool = False) -> "Optimizer":
        """Checkpoint into the directory ``path`` whenever ``trigger``
        fires after a step (Optimizer.scala:207 setCheckpoint), as
        ``checkpoint.<neval>`` (``checkpoint`` after
        :meth:`overwrite_checkpoint`); ``optimize()`` resumes from the
        newest intact checkpoint there. The elastic options
        (``keep_last``, ``async_write``) are not ported and raise."""
        if keep_last is not None or async_write:
            raise NotImplementedError(
                "set_checkpoint(keep_last=, async_write=): the elastic "
                "checkpoint writer is not ported yet (ROADMAP queue 1, "
                "item 12)")
        from bigdl_tpu_torch.utils import file_io
        file_io.makedirs(path)
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        return self

    def overwrite_checkpoint(self) -> "Optimizer":
        """Write every checkpoint to the one name ``checkpoint``."""
        self.is_overwrite = True
        return self

    def set_state(self, state: Dict[str, Any]) -> "Optimizer":
        """Seed the driver's counters (Optimizer.scala:240 setState);
        ``epoch`` and ``neval`` also reach the OptimMethod's state, so a
        schedule starts from the seeded position."""
        self.driver_state.update(dict(state))
        for k in ("epoch", "neval"):
            if k in state:
                self.optim_method.state[k] = state[k]
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float) -> "Optimizer":
        """Clip every gradient element into ``[min, max]``
        (setConstantGradientClipping)."""
        if float(min_value) > float(max_value):
            raise ValueError(
                f"constant gradient clipping needs min <= max, got "
                f"[{min_value}, {max_value}]")
        self._gradient_clip = ("constant", float(min_value),
                               float(max_value))
        return self

    def set_gradient_clipping_by_l2_norm(self,
                                         clip_norm: float) -> "Optimizer":
        """Scale the gradients so their global L2 norm never exceeds
        ``clip_norm`` (setGradientClippingByl2Norm)."""
        self._gradient_clip = ("l2norm", float(clip_norm))
        return self

    def disable_gradient_clipping(self) -> "Optimizer":
        self._gradient_clip = None
        return self

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _param_names(self) -> List[str]:
        return [name for name, _ in self.model.named_parameters()]

    def _checkpoint(self, step) -> None:
        """Write the run's state as a format-2 checkpoint: the params,
        the OptimMethod's buffers and the model state as the JAX
        package's trees, its host state and the driver's counters."""
        from bigdl_tpu_torch.utils.serialization import save_checkpoint
        suffix = "" if self.is_overwrite else f".{self.driver_state['neval']}"
        path = os.path.join(self.checkpoint_path, f"checkpoint{suffix}")
        names = self._param_names()
        opt_state = self.optim_method.state_tree(
            step.opt_state, lambda ts: jax_tree(self.model, zip(names, ts)))
        save_checkpoint(path, params=export_params(self.model),
                        opt_state=opt_state,
                        model_state=export_state(self.model),
                        optim_host_state=self.optim_method.get_state(),
                        driver_state=dict(self.driver_state))
        logger.info("checkpointed to %s", path)

    def _try_resume(self) -> Optional[Dict[str, Any]]:
        """The newest intact checkpoint under the checkpoint path, or
        None. One that fails to load (a digest that does not match, a
        missing file) is quarantined to ``*.corrupt-<pid>`` and the walk
        goes back to the one before; where the quarantine rename fails
        the error propagates."""
        from bigdl_tpu_torch.utils.serialization import (
            LOAD_ERRORS, find_latest_checkpoint, load_checkpoint,
            quarantine_checkpoint)
        if not self.checkpoint_path:
            return None
        while True:
            latest = find_latest_checkpoint(self.checkpoint_path)
            if latest is None:
                return None
            try:
                ck = load_checkpoint(latest)
            except LOAD_ERRORS as e:
                logger.warning("checkpoint %s unreadable (%s: %s); "
                               "quarantining and walking back", latest,
                               type(e).__name__, e)
                if quarantine_checkpoint(latest) is None:
                    raise
                continue
            logger.warning("resuming from %s", latest)
            ck["path"] = latest
            return ck

    def optimize(self) -> Module:
        """Run the loop until the end trigger (default ``max_epoch(10)``)
        fires; returns the trained model (updated in place)."""
        model = self.model
        model.train()
        device = self._device()
        state = self.driver_state
        resumed = self._try_resume()
        self.resumed_from = None
        if resumed is not None:
            load_jax_params(model, resumed["params"],
                            resumed["model_state"])
            self.optim_method.load_state(resumed["optim_host_state"])
            state.update(resumed["driver_state"])
            # a streaming pipeline's cursor: the port has no pipeline
            state.pop("datapipe", None)
            self.resumed_from = {"path": resumed["path"],
                                 "neval": state["neval"]}
        # epoch/iteration-driven schedules read the OptimMethod's state
        for k in ("epoch", "neval"):
            self.optim_method.state[k] = state[k]
        step = build_train_step(model, self.criterion, self.optim_method,
                                self._gradient_clip)
        if resumed is not None:
            names = self._param_names()

            def leaves_of(tree):
                flat = flatten_params(tree)
                if set(flat) != set(names):
                    raise KeyError(
                        f"optimizer state tree does not match the "
                        f"parameters: missing {sorted(set(names) - set(flat))}"
                        f", unexpected {sorted(set(flat) - set(names))}")
                return [flat[n] for n in names]

            self.optim_method.load_state_tree(
                step.opt_state, resumed["opt_state"], leaves_of)
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
                                 "lr": lr, "rows": bsz,
                                 "seconds": seconds})
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
            if (self.validation_trigger is not None
                    and self.validation_trigger(state)):
                scores = self._validate()
                if scores:
                    self.validation_history.append(scores)
                    # the first method's value drives max_score and a
                    # metric-reading schedule (DistriOptimizer.scala:382)
                    state["score"] = next(iter(scores.values()))
                    sched = getattr(self.optim_method,
                                    "learning_rate_schedule", None)
                    if hasattr(sched, "record_metric"):
                        sched.record_metric(state["score"])
            if (self.checkpoint_trigger is not None
                    and self.checkpoint_trigger(state)):
                self._checkpoint(step)
        logger.info("training done in %.1fs",
                    time.perf_counter() - wall_start)
        return model

    def _validate(self) -> Dict[str, float]:
        """One pass over the validation set through the Evaluator's
        sweep (each batch's output copied to the host once and scored
        there); the model is back in training mode after."""
        from bigdl_tpu_torch.optim.evaluator import Evaluator
        try:
            results = Evaluator(self.model).results(
                self.validation_dataset, self.validation_methods,
                self._val_batch_size)
        finally:
            self.model.train()
        return {} if results is None else self._score_summary(results)

    def _score_summary(self, results) -> Dict[str, float]:
        """``{name: value}`` in the methods' order; a repeated name gets
        ``-2``, ``-3``... so the first key stays the first method's."""
        summary: Dict[str, float] = {}
        for m, r in zip(self.validation_methods, results):
            value, _ = r.result()
            key, k = m.name, 2
            while key in summary:
                key = f"{m.name}-{k}"
                k += 1
            summary[key] = value
            logger.info("validation %s: %s", key, r)
        return summary


class LocalOptimizer(Optimizer):
    """Single-process training on the model's device (one card, or the
    CPU)."""
