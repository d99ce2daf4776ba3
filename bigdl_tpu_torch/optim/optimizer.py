"""The training driver (counterpart of ``bigdl_tpu.optim.optimizer``):
:func:`build_train_step`, :func:`build_eval_step`,
:func:`make_host_window` and :class:`Optimizer` /
:class:`LocalOptimizer`.

The JAX package compiles loss, gradient and update into one jitted,
donated program; the port runs the same order eagerly — forward in
training mode, loss plus the module's regularization penalty,
``backward()``, the gradients scaled by the module's ``param_scales``,
optional clipping, then the OptimMethod's in-place update — and keeps
the driver's host loop: per-iteration learning rate from the
OptimMethod, ``driver_state`` counters synced into
``optim_method.state``, a reshuffle at each epoch rollover, then the
validation trigger, then the checkpoint trigger.

A precision policy (:class:`~bigdl_tpu_torch.precision.PrecisionPolicy`,
``set_precision``) casts at the step's boundary: the parameters and the
inputs to the compute dtype for the forward and backward, the output to
the output dtype for the loss, the gradients to float32 for the update,
which runs on float32 weights (the parameters, or the master copy when
they are stored below float32); a float16 policy scales the loss and
skips a step whose gradients are not finite (the
:class:`~bigdl_tpu_torch.precision.DynamicLossScaler` state on the
device).

``set_steps_per_sync(K)`` runs up to K steps per host sync: on the card
one window of K steps is one CUDA graph (:func:`make_host_window`),
captured once per window shape and replayed; on the CPU the same
planned window runs its steps one by one. The host replays the K
per-step counter increments, triggers and ``history`` records after the
window's one loss fetch, so windows are observably the per-step loop.

Checkpoints are the JAX package's format 2
(:mod:`bigdl_tpu_torch.utils.serialization`), written synchronously, and
``optimize()`` resumes from the newest intact one under the checkpoint
path (a corrupt one is quarantined and the walk goes back), so a run
checkpointed by either package resumes in the other.

``optimize()`` retries a failure that
:func:`bigdl_tpu_torch.faults.retry.classify` calls transient from the
newest checkpoint, after an exponential, jittered backoff
(``retry_times``, ``retry_interval_s``, ``retry_max_interval_s``, from
``BIGDL_FAILURE_RETRY_TIMES``, ``..._INTERVAL`` and
``..._MAX_INTERVAL``), counting each in ``train/optimizer/recoveries``;
a fatal failure, one past ``retry_times`` or one with no checkpoint path
raises at once. Each pass of the loop goes through the ``train/step``
fault point (:mod:`bigdl_tpu_torch.faults`), keyed on ``neval`` and
``epoch``.

A dataset with ``continuous_stream`` (the threaded image feed, a
streaming pipeline) keeps its iterator across the epoch rollover, and
the driver carries a straddling batch's overshoot into the next epoch.
A pipeline's read cursor (``pipeline_state()``, found through
``TransformedDataSet`` wrappers) is checkpointed in
``driver_state["datapipe"]`` and restored on resume. A
:class:`~bigdl_tpu_torch.dataset.prefetch.StackedWindow` already on the
card (``Pipeline.as_dataset(staged_k=K)``) is run as its K steps: the
windowed driver copies its steps device to device into the window's
graph inputs, the per-step loop takes them one at a time.

A device-cached dataset (``dataset.device_dataset``:
:class:`~bigdl_tpu_torch.dataset.device_dataset.DeviceCachedArrayDataSet`,
or a :class:`~bigdl_tpu_torch.dataset.device_dataset.RotatingDeviceDataSet`
over two shard slots) feeds the steps on the card: each step gathers,
crops, flips and normalizes its batch from the cache at the cursor
``(epoch, pos)`` of its ``neval`` (for rotating shards, ``(visit, pos
in shard)``), its draws from the step's generator, then trains on it.
A window of such steps is one CUDA graph a ``(K, slot)``, reading the K
cursors and rates from static buffers, with one memory pool for all
its graphs; windows end at epoch rollovers and shard boundaries, an
epoch's visit order is built on the host at its first use, and a
rotating dataset pumps a piece of the next shard and rotates after
each step's loss fetch. ``set_validation`` with a device cache scores
its centre crops on the card at the cache's batch size.

On a mesh of ranks (``Optimizer(mesh=...)``, :class:`DistriOptimizer`
on the Engine's), one process a rank, each rank feeds its own rows and
the step's distribution points are
:class:`~bigdl_tpu_torch.optim.mesh_step.MeshSpread`'s
(data parallelism, ZeRO stages 1-3 by ``set_zero``, sequence
parallelism by ``set_sequence_parallel``; the gradient is the global
objective's). The driver checks at the start that every rank holds
the same parameters, counts the global rows, logs on rank 0 only, runs
a window's steps eagerly whatever the backend (the collectives are not
captured into a CUDA graph, NCCL's neither), writes checkpoints from rank 0 (gathered and unsharded, the
JAX package's format 2, so a checkpoint of a sharded run resumes in a
``LocalOptimizer`` of either package, or onto another stage) while
the other ranks wait at a barrier, and all-reduces the validation
counts of the rows each rank scored.

Not ported yet: the elastic checkpoint options (``keep_last``,
``async_write``) and the flight recorder's post-mortem on a fatal
failure (item 12), train and validation summaries, preemption, tensor
parallel ``sharding_rules`` and the device cache over a mesh (item 11).
"""
from __future__ import annotations

import contextlib
import copy
import functools
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from bigdl_tpu_torch import faults, telemetry
from bigdl_tpu_torch.convert import (export_params, export_state,
                                     flatten_params, jax_tree,
                                     load_jax_params)
from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.prefetch import (StackedWindow, WindowRow,
                                              batch_signature,
                                              stack_minibatches)
from bigdl_tpu_torch.dataset.sample import (HostBatchedCOO, MiniBatch,
                                            SparseFeature,
                                            minibatch_input_to_device)
from bigdl_tpu_torch.faults.retry import backoff_delay, classify
from bigdl_tpu_torch.nn.container import forward_takes_generator
from bigdl_tpu_torch.nn.module import Criterion, Module
from bigdl_tpu_torch.nn.moe import pop_aux_losses
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.trigger import Trigger, max_epoch
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.precision.policy import (MASTER_KEY, SCALER_KEY,
                                              PrecisionPolicy, cast_floating,
                                              dtype_name)
from bigdl_tpu_torch.precision.scaler import DynamicLossScaler
from bigdl_tpu_torch.utils.engine import default_dtype
from bigdl_tpu_torch.utils.random import RandomGenerator

__all__ = ["DistriOptimizer", "LocalOptimizer", "Optimizer",
           "build_eval_step",
           "build_train_step", "make_host_window", "seed_precision"]

logger = logging.getLogger(__name__)

# mixed-precision gauges (Optimizer.set_precision): the loss scale and
# the skipped steps are read off the scaler state after each host sync
# (the loss fetch has already synchronized the device); the policy gauge
# is set once when a run lays out its state
_LOSS_SCALE = telemetry.gauge(
    "train/precision/loss_scale",
    "current dynamic loss scale (1.0 when the policy does not scale)")
_SKIPPED_STEPS = telemetry.gauge(
    "train/precision/skipped_steps",
    "cumulative optimizer steps skipped on non-finite gradients")
_POLICY_INFO = telemetry.gauge(
    "train/precision/policy_info",
    "active precision policy (labels carry the dtypes); value is 1")
_RECOVERIES = telemetry.counter(
    "train/optimizer/recoveries",
    "retry-from-checkpoint recoveries performed by optimize()")


class _Body(torch.nn.Module):
    """``module``'s forward and its regularization penalty in one call,
    so one ``torch.func.functional_call`` swaps the compute-dtype
    parameters in for both (the penalty on the compute-dtype
    parameters, as the JAX package's ``regularization_loss(p_c)``).
    ``kw`` goes to the module's forward (the step's generator)."""

    def __init__(self, module):
        super().__init__()
        self.module = module

    def forward(self, x, **kw):
        return self.module(x, **kw), self.module.regularization_loss()


def build_train_step(module: Module, criterion: Criterion,
                     optim_method: OptimMethod, gradient_clip=None, *,
                     precision: Optional[PrecisionPolicy] = None,
                     loss_scaler: Optional[DynamicLossScaler] = None,
                     aux_loss_weight: float = 0.01, mesh=None, zero=None,
                     seq_parallel=None, data_axis: str = "data",
                     seq_axis: Optional[str] = None):
    """One training step, ``step(inputs, targets, lr) -> loss``, in the
    JAX package's order: forward, loss plus
    ``module.regularization_loss()`` plus ``aux_loss_weight`` times the
    MoE load-balance terms of this forward
    (:func:`~bigdl_tpu_torch.nn.moe.pop_aux_losses`, which also clears
    them; none without an MoE), backward, each gradient times its
    ``module.param_scales()`` factor (0 for a frozen layer), then
    ``gradient_clip`` — ``("constant", min, max)`` clamps every gradient
    element, ``("l2norm", max_norm)`` scales the gradients so their
    global L2 norm is at most ``max_norm`` — then ``optim_method.update``
    on the parameters in place. ``lr`` is a Python float or a 0-d tensor
    on the module's device. Returns the data loss, without the penalty
    and the load-balance term (a detached 0-d tensor on the module's
    device; reading it is the caller's sync).

    Where the module's forward takes ``generator=`` (a dropout model,
    and every container, which hands it to its children in order), the
    step passes it ``step.generator``, a ``torch.Generator`` on the
    module's device seeded at build time from
    :meth:`~bigdl_tpu_torch.utils.random.RandomGenerator.get_seed`
    (never torch's global generator), so a run's masks follow from its
    seed.

    ``precision`` (None: ``PrecisionPolicy.from_engine()``, the Engine
    dtype knobs) casts as the JAX package's step does: the inputs and
    the floating parameters to ``compute_dtype`` on entry (through
    ``torch.func.functional_call``; the penalty reads the cast
    parameters too), the output to ``output_dtype``, the gradients to
    float32; with a ``loss_scaler`` (made for a policy that scales) the
    loss is scaled before the backward and the gradients unscaled after
    it, and a step with a non-finite gradient leaves the parameters,
    the master copy and every OptimMethod buffer as they were (a
    ``torch.where`` select over each, no host read) while the scaler
    state advances. The update runs on the float32 base: the parameters,
    or the master copy ``step.opt_state[MASTER_KEY]`` (float32 tensors
    in ``named_parameters`` order), cast down into the parameters after.
    The scaler state lives in ``step.opt_state[SCALER_KEY]``. The step
    raises when the policy needs either and it is missing
    (``Optimizer.set_precision`` seeds both). A policy that changes
    nothing (float32 throughout) runs the pre-policy step exactly.

    The module is put in training mode when the step is built (a layer
    set to evaluation mode after that stays so, as in a torch loop);
    the scales are read then too, as the JAX package reads them when it
    traces its step. The OptimMethod's hyper-parameters (SGD's weight
    decay, momentum, dampening, nesterov; Adam's betas...) are read from
    a copy of the method taken at the step's first call, after the
    driver's first schedule update, as the JAX package's step reads them
    when it is traced at its first call: an ``EpochSchedule`` regime
    that changes them in a later epoch changes neither package's step,
    per step or windowed. Under a policy with a master copy the
    OptimMethod's buffers are made in the master's dtype. The OptimMethod's buffers (``init_state`` over the
    module's parameters, in ``named_parameters`` order) live in
    ``step.opt_state``; ``step.module`` is the module, ``step.lr_dtype``
    the dtype a driver stages the rate in. Nothing in a step
    reads a value back to the host, so a step can be captured into a
    CUDA graph (:func:`make_host_window`).

    On a ``mesh`` of more than one rank the step is the same code with
    :class:`~bigdl_tpu_torch.optim.mesh_step.MeshSpread`'s distribution
    points: this rank's rows, the global objective (batch statistics and
    random draws of the global batch), the gradients summed over the
    ``data_axis`` and ``seq_axis`` groups, ``zero`` (a
    :class:`~bigdl_tpu_torch.parallel.zero.ZeroConfig`) sharding the
    update, ``seq_parallel`` (a
    :class:`~bigdl_tpu_torch.parallel.sequence.SeqParallelConfig`)
    installed around the forward; it returns the global loss."""
    if gradient_clip is not None and gradient_clip[0] not in (
            "constant", "l2norm"):
        raise ValueError(
            f"gradient_clip kind must be 'constant' or 'l2norm', got "
            f"{gradient_clip[0]!r}")
    policy = precision if precision is not None \
        else PrecisionPolicy.from_engine()
    scaler = None
    if policy.needs_loss_scaling:
        scaler = loss_scaler if loss_scaler is not None \
            else DynamicLossScaler()
    named = list(module.named_parameters())
    params = [p for _, p in named]
    if mesh is not None and mesh.size > 1:
        from bigdl_tpu_torch.optim.mesh_step import MeshSpread
        spread = MeshSpread(module, criterion, mesh=mesh, policy=policy,
                            scaler=scaler, zero=zero, data_axis=data_axis,
                            seq_axis=seq_axis, seq_parallel=seq_parallel)
    else:
        spread = _OneRank(params, policy)
    plain = (isinstance(spread, _OneRank) and policy.is_noop
             and policy.param_dtype == torch.float32)
    opt_state = optim_method.init_state(spread.state_leaves())
    spread.seed(opt_state)
    scales = module.param_scales()
    factors = [scales[name] for name, _ in named]
    scaled = any(f != 1.0 for f in factors)
    body = _Body(module)
    module.train()
    generator = None
    forward_kw = {}
    if forward_takes_generator(type(module)):
        generator = torch.Generator(
            device=params[0].device if params else "cpu")
        generator.manual_seed(RandomGenerator.get_seed())
        forward_kw = {"generator": generator}

    def objective(loss, reg):
        """loss + penalty + weighted load-balance terms: what the
        backward differentiates (the JAX package's ``total``)."""
        total = loss + reg if torch.is_tensor(reg) else loss
        aux = pop_aux_losses(module)
        if torch.is_tensor(aux):
            total = total + aux_loss_weight * aux
        return total

    def clip(grads):
        if gradient_clip is None:
            return grads
        with torch.no_grad():
            if gradient_clip[0] == "constant":
                lo, hi = gradient_clip[1], gradient_clip[2]
                return [g.clamp(lo, hi) for g in grads]
            nrm = torch.sqrt(spread.square_norm(grads))
            scale = torch.clamp(
                gradient_clip[1] / torch.clamp(nrm, min=1e-12), max=1.0)
            return [g * scale.to(g.dtype) for g in grads]

    def gradients(sources):
        return [t.grad if t.grad is not None else torch.zeros_like(t)
                for t in sources]

    def scale(grads):
        if not scaled:
            return grads
        return [g if f == 1.0 else g * f for g, f in zip(grads, factors)]

    rule = []

    def update(grads, state, base, lr):
        # the method as the step's first call finds it: the JAX package
        # reads the hyper-parameters (an EpochSchedule's weight decay
        # and momentum) when it traces its step at the first call, and
        # a captured window keeps what its capture read
        if not rule:
            rule.append(copy.copy(optim_method))
        rule[0].update(grads, state, base, lr)

    def plain_step(inputs, targets, lr):
        for p in params:
            p.grad = None
        loss = criterion(module(inputs, **forward_kw), targets)
        objective(loss, module.regularization_loss()).backward()
        update(clip(scale(gradients(params))), opt_state, params, lr)
        return loss.detach()

    def policy_step(inputs, targets, lr):
        scaler_state = opt_state.get(SCALER_KEY)
        master = opt_state.get(MASTER_KEY)
        inner = {k: v for k, v in opt_state.items()
                 if k not in (SCALER_KEY, MASTER_KEY)}
        if scaler is not None and scaler_state is None:
            raise ValueError(
                "loss-scaling policy needs the scaler state in "
                "opt_state[precision.SCALER_KEY]; seed it with "
                "scaler.init_state() (Optimizer.set_precision does "
                "this automatically)")
        if policy.needs_master and master is None:
            raise ValueError(
                "low-precision param_dtype needs the f32 master copy "
                "in opt_state[precision.MASTER_KEY] "
                "(Optimizer.set_precision seeds it automatically)")
        inputs, targets = spread.batch(inputs, targets)
        # the tensors the gradients are taken for: the parameters, or
        # on a mesh compute-dtype copies of the whole parameters
        sources = spread.sources()
        x_c = policy.cast_to_compute(inputs)
        with spread.scope():
            if spread.functional or any(
                    t.is_floating_point() and t.dtype != policy.compute_dtype
                    for t in sources):
                out, reg = torch.func.functional_call(
                    body, {f"module.{name}": policy.cast_to_compute(t)
                           for (name, _), t in zip(named, sources)},
                    (x_c,), forward_kw)
            else:
                out, reg = body(x_c, **forward_kw)
        loss = criterion(policy.cast_output(out), targets)
        share = spread.share(loss, targets)
        total = objective(share, spread.penalty(reg))
        if scaler is not None:
            total = scaler.scale_loss(total, scaler_state)
        total.backward()
        with torch.no_grad():
            grads = policy.cast_to_accum(spread.reduce(gradients(sources)))
            del sources
            finite = None
            if scaler is not None:
                # checked after unscaling, so an overflowed scale's inf
                # is caught even where the float16 gradients were finite
                grads = scaler.unscale(grads, scaler_state)
                finite = spread.agree(scaler.all_finite(grads))
            grads = clip(scale(grads))
            # what the update writes: the parameters, or on a mesh this
            # rank's shard of each
            stored = spread.stored()
            base = master if master is not None else stored
            if master is None and policy.param_dtype != policy.accum_dtype:
                # no master (the legacy Engine path): the update runs in
                # the parameters' dtype, the pre-policy program
                grads = cast_floating(grads, policy.param_dtype)
            kept = []
            if finite is not None:
                # the skip-step select's old values: the parameters, the
                # master and every OptimMethod buffer
                kept = [(t, t.clone()) for t in
                        [*stored, *(master or []), *_buffers(inner)]]
            update(grads, inner, base, lr)
            if master is not None:
                for t, m in zip(stored, master):
                    t.copy_(m)           # the master cast down
            for t, old in kept:
                t.copy_(torch.where(finite, t, old))
            if scaler is not None:
                scaler.advance(scaler_state, finite)
            spread.finish()
        return spread.result(loss, share)

    step = plain_step if plain else policy_step
    # the dtype a driver stages the rate in: default_dtype(), as the JAX
    # package stages it, widened to a float64 model's dtype
    step.lr_dtype = functools.reduce(
        torch.promote_types,
        (p.dtype for p in params if p.is_floating_point()), default_dtype())
    step.opt_state = opt_state
    step.module = module
    step.policy = policy
    step.scaler = scaler
    step.generator = generator
    spread.attach(step)
    return step


class _OneRank:
    """The distribution points of a step on one rank, each the plain
    computation (a mesh's are
    :class:`~bigdl_tpu_torch.optim.mesh_step.MeshSpread`'s)."""

    #: whether the forward always swaps its sources in through
    #: ``functional_call`` (else only where a cast is due)
    functional = False

    def __init__(self, params, policy):
        self.params = params
        self.policy = policy

    def state_leaves(self):
        """The tensors the OptimMethod's buffers are made like: the
        float32 master's under a policy with one."""
        policy = self.policy
        return [p.detach().to(policy.accum_dtype)
                if policy.needs_master and p.is_floating_point()
                else p.detach() for p in self.params]

    def seed(self, opt_state) -> None:
        """Nothing: :func:`seed_precision` seeds the precision state."""

    def batch(self, inputs, targets):
        return inputs, targets

    def sources(self):
        for p in self.params:
            p.grad = None
        return self.params

    def scope(self):
        return contextlib.nullcontext()

    def share(self, loss, targets):
        return loss

    def penalty(self, reg):
        return reg

    def reduce(self, grads):
        return grads

    def agree(self, finite):
        return finite

    def square_norm(self, grads):
        return sum(g.float().square().sum() for g in grads)

    def stored(self):
        return self.params

    def finish(self) -> None:
        pass

    def result(self, loss, share):
        return loss.detach()

    def attach(self, step) -> None:
        pass


def seed_precision(step, cast_params: bool = True) -> None:
    """Give a :func:`build_train_step` step the precision state its
    policy needs and ``step.opt_state`` lacks (a fresh run, or a
    checkpoint written without a policy): the float32 master copy (the
    parameters cast up) and the scaler state on the parameters' device;
    then, with ``cast_params``, the at-rest parameters in the policy's
    ``param_dtype`` (``Optimizer.optimize`` does this for a policy set
    with ``set_precision``; the legacy Engine path keeps the parameters
    as built)."""
    policy, scaler, module = step.policy, step.scaler, step.module
    params = list(module.parameters())
    with torch.no_grad():
        if policy.needs_master and MASTER_KEY not in step.opt_state:
            step.opt_state[MASTER_KEY] = [
                p.detach().to(policy.accum_dtype).clone() for p in params]
        if scaler is not None and SCALER_KEY not in step.opt_state:
            step.opt_state[SCALER_KEY] = scaler.init_state(
                params[0].device if params else None)
        if cast_params:
            for p in params:
                if p.is_floating_point():
                    p.data = p.data.to(policy.param_dtype)


def _buffers(tree) -> List[torch.Tensor]:
    """The tensors of an OptimMethod's state (lists and dicts walked)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _buffers(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _buffers(v)]
    return []


def build_eval_step(module: Module,
                    precision: Optional[PrecisionPolicy] = None):
    """The evaluation forward, ``eval_step(inputs) -> output``: the
    module in evaluation mode under ``torch.inference_mode`` (the
    caller puts it back in training mode). ``precision`` (a policy that
    changes something) runs the forward in its compute dtype with the
    output cast to its output dtype
    (:meth:`~bigdl_tpu_torch.precision.PrecisionPolicy.apply_module`), so
    validation scores the precision that trains."""
    if precision is not None and not precision.is_noop:
        def eval_step(inputs):
            module.eval()
            with torch.inference_mode():
                return precision.apply_module(module, inputs)
    else:
        def eval_step(inputs):
            module.eval()
            with torch.inference_mode():
                return module(inputs)

    return eval_step


def _leaf_at(x, i: int):
    """Row ``i`` of a stacked ``[K, ...]`` leaf (lists walked)."""
    if isinstance(x, (list, tuple)):
        return [_leaf_at(e, i) for e in x]
    return None if x is None else x[i]


def _empty_on(x, device):
    """An uninitialized tensor of ``x``'s shape and dtype on ``device``
    (lists walked)."""
    if isinstance(x, (list, tuple)):
        return [_empty_on(e, device) for e in x]
    return None if x is None else torch.empty(x.shape, dtype=x.dtype,
                                              device=device)


def _copy_into(dst, src) -> None:
    if isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src, strict=True):
            _copy_into(d, s)
    elif dst is not None:
        dst.copy_(src, non_blocking=True)


def _as_tensors(x):
    if isinstance(x, (list, tuple)):
        return [_as_tensors(e) for e in x]
    return None if x is None else torch.as_tensor(x)


class _Captured:
    """One captured window: the graph and its static buffers."""

    __slots__ = ("graph", "xs", "ys", "lrs", "losses")


class _HostWindow:
    """K steps of ``step`` per call, ``window(xs, ys, lrs) -> losses``:
    ``xs`` / ``ys`` are a stacked window (``[K, B, ...]`` arrays or
    tensors, lists of them for a multi-plane input), ``lrs`` the K
    learning rates; returns the K data losses as one float32 tensor on
    the module's device (one fetch a window).

    On a CUDA module one window is one ``torch.cuda.CUDAGraph`` of the K
    steps, captured at the first window of each ``(K, signature)`` and
    replayed after: the graph reads static input buffers ``xs[K, B,
    ...]`` / ``ys[K, B, ...]`` and the rates ``lrs[K]`` (a
    ``step.lr_dtype`` buffer, never a constant baked in), reads and
    writes the parameters, the OptimMethod's buffers, the master copy,
    the scaler state and the module's buffers in place, and writes
    ``losses[K]``. A call copies the window into the static buffers,
    fills ``lrs``, replays and returns the losses. Before a capture one
    step runs on a side stream (the recipe's warm-up: every kernel
    library, cuBLAS and cuDNN handle and autograd's lazy state made)
    from a saved copy of every tensor a step changes, which is put back
    after, so the warm-up does not advance the run; the step's
    generator's state is put back too, and where the warm-up drew from
    it the graph registers it
    (``CUDAGraph.register_generator_state``), so each replay draws fresh
    masks at the offsets the per-step loop would, and advances the
    generator as the K steps would. A kernel wrapper
    counts its calls (``.launches``) in the warm-up and in the capture;
    a replay calls no wrapper and counts nothing. A capture that fails
    raises: there is no quiet per-step fallback.

    On the CPU, and for a step that is not ``capturable`` (a mesh step:
    its collectives are not captured), the K steps run one by one (no
    graph), from the same buffers' values: the planning and the host
    replay are what they see."""

    #: whether this window's graphs share one memory pool (each graph
    #: of a host window has its own)
    shares_pool = False

    def __init__(self, step):
        self.step = step
        self.module = step.module
        #: ``(K, signature) -> _Captured`` (CUDA only; :meth:`close`
        #: empties it)
        self.graphs: Dict[Any, _Captured] = {}
        #: graphs captured so far (one per window shape on the card)
        self.captures = 0
        #: every ``(K, signature)`` a call met, on any device
        self.shapes = set()
        self._pool = None

    def close(self) -> None:
        """Drop the captured graphs and their memory pools (the next call
        captures again)."""
        self.graphs.clear()

    def _device(self) -> torch.device:
        for t in self.module.parameters():
            return t.device
        return torch.device("cpu")

    def _state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a step writes: the parameters, the module's
        buffers, the OptimMethod buffers, the master copy and the scaler
        state."""
        return [*self.module.parameters(), *self.module.buffers(),
                *_buffers(self.step.opt_state)]

    def __call__(self, xs, ys, lrs: Sequence[float]) -> torch.Tensor:
        device = self._device()
        k = len(lrs)
        key = (k, batch_signature(MiniBatch(xs, ys)))
        self.shapes.add(key)
        if device.type != "cuda" or not getattr(self.step, "capturable",
                                                True):
            xs = minibatch_input_to_device(xs, device)
            ys = minibatch_input_to_device(ys, device)
            lr_t = torch.tensor(list(lrs), dtype=self.step.lr_dtype,
                                device=device)
            return torch.stack([self.step(_leaf_at(xs, i), _leaf_at(ys, i),
                                          lr_t[i]) for i in range(k)])
        xs, ys = _as_tensors(xs), _as_tensors(ys)
        cap = self.graphs.get(key)
        if cap is None:
            cap = self.graphs[key] = self._capture(xs, ys, k, device)
            self.captures += 1
        _copy_into(cap.xs, xs)
        _copy_into(cap.ys, ys)
        cap.lrs.copy_(torch.tensor(list(lrs), dtype=self.step.lr_dtype))
        cap.graph.replay()
        return cap.losses.clone()

    def _capture(self, xs, ys, k: int, device) -> _Captured:
        cap = _Captured()
        cap.xs, cap.ys = _empty_on(xs, device), _empty_on(ys, device)
        _copy_into(cap.xs, xs)
        _copy_into(cap.ys, ys)
        cap.lrs = torch.zeros((k,), dtype=self.step.lr_dtype,
                              device=device)
        cap.losses = torch.zeros((k,), dtype=torch.float32, device=device)
        self._record(cap, k, device, lambda i: self.step(
            _leaf_at(cap.xs, i), _leaf_at(cap.ys, i), cap.lrs[i]))
        return cap

    def _record(self, cap, k: int, device, run_step) -> None:
        """Warm up, then capture ``cap.graph``: the K calls
        ``run_step(i)`` (step i of the window, returning its loss), each
        loss written to ``cap.losses[i]``."""
        # warm-up: one step on a side stream from saved state, put back
        state = self._state_tensors()
        saved = [t.detach().clone() for t in state]
        gen = self.step.generator
        gen_saved = None if gen is None else gen.get_state()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            run_step(0)
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(state, saved):
                t.copy_(s)
        del saved
        drew = gen is not None and not torch.equal(gen.get_state(),
                                                   gen_saved)
        if gen is not None:
            gen.set_state(gen_saved)

        pool = None
        if self.shares_pool:
            # the warm-up's blocks go back to the card before the pool
            # grows (the allocator frees no cached block during a
            # capture)
            torch.cuda.empty_cache()
            pool = self._pool
        cap.graph = torch.cuda.CUDAGraph()
        if drew:
            cap.graph.register_generator_state(gen)
        # thread_local: a device_prefetch stager may be copying the next
        # window on its own stream and thread while this one captures
        with torch.cuda.graph(cap.graph, pool=pool,
                              capture_error_mode="thread_local"):
            for i in range(k):
                cap.losses[i].copy_(run_step(i))
        if self.shares_pool and self._pool is None:
            self._pool = cap.graph.pool()


class _FedCaptured:
    """One captured device-fed window: the graph, the K cursors and
    rates it reads, the losses it writes."""

    __slots__ = ("graph", "cursors", "lrs", "losses")


class _DeviceWindow(_HostWindow):
    """K device-fed steps per call, ``window(cursors, lrs) -> losses``:
    step i draws its batch from the device cache with ``feed(cursor)``
    at ``cursors[i]`` (``(epoch, pos)``, exact host integers) and trains
    on it at rate ``lrs[i]``.

    On a CUDA module one window is one CUDA graph a ``(K, slot())``
    (``slot`` names the cache tensor the feed reads now: a rotating
    dataset's two slots get a graph each, so a graph never reads a slot
    that is not resident), with the warm-up, generator and counting
    rules of :class:`_HostWindow`; its graphs share one memory pool.
    The caller builds the cursors' visit orders first
    (``ready_epochs``). On the CPU the K steps run one by one."""

    shares_pool = True

    def __init__(self, step, feed, slot):
        super().__init__(step)
        self.feed = feed
        self.slot = slot

    def __call__(self, cursors, lrs: Sequence[float]) -> torch.Tensor:
        device = self._device()
        k = len(lrs)
        key = (k, self.slot())
        self.shapes.add(key)
        cur = torch.tensor(cursors, dtype=torch.int64).reshape(k, 2)
        lr_t = torch.tensor(list(lrs), dtype=self.step.lr_dtype)
        if device.type != "cuda":
            return torch.stack([self.step(*self.feed(cur[i]), lr_t[i])
                                for i in range(k)])
        cap = self.graphs.get(key)
        if cap is None:
            cap = self.graphs[key] = _FedCaptured()
            cap.cursors = cur.to(device)
            cap.lrs = lr_t.to(device)
            cap.losses = torch.zeros((k,), dtype=torch.float32,
                                     device=device)
            self._record(cap, k, device, lambda i: self.step(
                *self.feed(cap.cursors[i]), cap.lrs[i]))
            self.captures += 1
        cap.cursors.copy_(cur)
        cap.lrs.copy_(lr_t)
        cap.graph.replay()
        return cap.losses.clone()


def make_host_window(step) -> _HostWindow:
    """The K-step window over ``step`` (a :func:`build_train_step`
    step): the counterpart of the JAX package's ``lax.scan`` window, as
    a CUDA graph on the card (see :class:`_HostWindow`)."""
    return _HostWindow(step)


def _window_stackable(batch: MiniBatch) -> bool:
    """True when every leaf of the MiniBatch is a dense host array (numpy
    or a CPU tensor): the only thing window stacking takes. A sparse
    plane (a HostBatchedCOO) keeps the per-step path, and so does a leaf
    already on the card: stacking it on the host would copy it back and
    forth with a sync a batch, the inverse of what a window buys."""
    def ok(x):
        if x is None:
            return True
        if isinstance(x, (list, tuple)):
            return all(ok(e) for e in x)
        if isinstance(x, (HostBatchedCOO, SparseFeature)):
            return False
        return not (isinstance(x, torch.Tensor) and x.device.type != "cpu")
    return ok(batch.input) and ok(batch.target)


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
    time, batch transfer included; a window's wall time over its steps
    in windowed mode), ``validation_history`` each validation's
    ``{method name: value}``, ``resumed_from`` the checkpoint the last
    ``optimize()`` resumed from (``{"path", "neval"}``, or None),
    ``train_step`` the last run's step (its ``opt_state`` holds the
    OptimMethod's buffers, the master copy and the scaler state) and
    ``window`` its :func:`make_host_window` window (None in per-step mode; closed
    when the run ends, its ``captures`` and ``shapes`` kept).

    ``mesh`` (a :class:`~bigdl_tpu_torch.parallel.mesh.Mesh`) trains
    across its ranks, ``data_axis`` naming the batch axis; ``zero1`` is
    ``set_zero(ZeroConfig(1))``. ``sharding_rules`` raises (item 11).
    On a mesh ``batch_size`` is the global batch (each data rank feeds
    its share), ``history``'s ``rows``, the throughput and the epoch's
    records count the global rows, the loss is the global one, and
    ``memory`` holds the bytes of parameters and optimizer state a rank
    keeps at rest (``record_memory_gauges``)."""

    def __init__(self, model: Module, dataset: AbstractDataSet,
                 criterion: Criterion, batch_size: int = 32, mesh=None,
                 data_axis: str = "data", sharding_rules=None,
                 zero1: bool = False):
        if sharding_rules is not None:
            raise NotImplementedError(
                "Optimizer(sharding_rules=...): tensor- and expert-parallel "
                "layouts are not ported yet (ROADMAP queue 1, item 11)")
        self.mesh = mesh
        self.data_axis = data_axis
        self.sharding_rules = None
        self.zero1 = zero1
        self.zero_config = None
        if zero1:
            from bigdl_tpu_torch.parallel.zero import ZeroConfig
            self.zero_config = ZeroConfig(stage=1, data_axis=data_axis)
        self._seq_parallel = None
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
        self.steps_per_sync = 1
        self._precision: Optional[PrecisionPolicy] = None
        self._loss_scaler: Optional[DynamicLossScaler] = None
        self.train_step = None
        self.window: Optional[_HostWindow] = None
        # retry from the newest checkpoint (optimize): at most
        # retry_times retries, the first after a jittered wait in
        # [base / 2, base), doubling per retry up to the cap
        self.retry_times = int(os.environ.get("BIGDL_FAILURE_RETRY_TIMES",
                                              5))
        self.retry_interval_s = float(
            os.environ.get("BIGDL_FAILURE_RETRY_INTERVAL", 1.0))
        self.retry_max_interval_s = float(
            os.environ.get("BIGDL_FAILURE_RETRY_MAX_INTERVAL", 30.0))

    def set_model(self, new_model: Module) -> "Optimizer":
        """Swap the model before ``optimize()`` (Optimizer.scala:230).
        The last run's step and window belong to the old model's
        parameters (a captured graph reads and writes them) and are
        dropped."""
        self.model = new_model
        if self.window is not None:
            self.window.close()
        self.window = None
        self.train_step = None
        return self

    def set_drop_module_property(self, drop_percentage: float,
                                 max_drop_percentage: float,
                                 batchsize: int = 100,
                                 warmup_iteration: int = 200
                                 ) -> "Optimizer":
        """Straggler dropping (Optimizer.scala:276): one card has no
        stragglers, so this is accepted for the recipes and does
        nothing."""
        return self

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
        ``driver_state["score"]``. A device-cached dataset is scored at
        its own batch size, and a different ``batch_size`` raises."""
        # a device cache's centre-crop batches are cut at its batch size:
        # a conflicting request would be dropped, so it raises before any
        # state changes
        ds_bs = getattr(dataset, "batch_size", None)
        if batch_size is not None and ds_bs is not None \
                and hasattr(dataset, "eval_batch_fn_on") \
                and batch_size != ds_bs:
            raise ValueError(
                f"device-cached validation runs at the dataset's own "
                f"batch_size={ds_bs}; got conflicting batch_size="
                f"{batch_size} (omit it or rebuild the dataset)")
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

    def set_steps_per_sync(self, k: int) -> "Optimizer":
        """Run up to ``k`` train steps per host sync.

        The per-step loop reads the loss back every step, so the card
        idles while the host does its bookkeeping and launches the next
        step. With ``k > 1`` a window of steps runs as one CUDA graph
        (:func:`make_host_window`) and the losses come back once, as a
        length-``k`` tensor; the driver's counters (``neval``,
        ``recordsProcessedThisEpoch``), triggers and ``history`` then
        replay the ``k`` per-step increments, so what a caller observes
        matches the per-step loop. Windows end early at validation,
        checkpoint and end-trigger boundaries and at epoch rollovers, and
        the driver falls back to ``k = 1``, logging why, when a trigger
        depends on values the device produces (``Loss``, ``score``), a
        trigger's dependencies are unknown, the learning-rate schedule
        reads a metric (Plateau), the model holds a module whose forward
        reads the device on the host (``IfThenElse``: its
        ``window_fallback``), or the batches cannot be stacked."""
        k = int(k)
        if k < 1:
            raise ValueError(f"steps_per_sync must be >= 1, got {k}")
        self.steps_per_sync = k
        return self

    def set_zero(self, config) -> "Optimizer":
        """Weight-update sharding (a
        :class:`~bigdl_tpu_torch.parallel.zero.ZeroConfig`, or None / stage
        0 for plain data parallelism): stage 1 shards the optimizer
        state over the data axis, stage 2 also reduce-scatters the
        gradients, stage 3 also keeps the parameters sharded between
        steps. A no-op off a mesh or where the data axis does not
        split. The config's ``data_axis`` is made this Optimizer's.
        Checkpoints hold the gathered, unsharded state, so a run may
        resume onto another stage or into a ``LocalOptimizer``."""
        import dataclasses

        from bigdl_tpu_torch.parallel.zero import ZeroConfig
        if config is not None and not isinstance(config, ZeroConfig):
            raise TypeError(
                f"set_zero expects a parallel.ZeroConfig or None, got "
                f"{type(config).__name__}")
        if config is not None and config.data_axis != self.data_axis:
            config = dataclasses.replace(config, data_axis=self.data_axis)
        self.zero_config = config if config is not None \
            and config.stage > 0 else None
        self.zero1 = self.zero_config is not None \
            and self.zero_config.stage == 1
        return self

    def set_sequence_parallel(self, config) -> "Optimizer":
        """Sequence-parallel attention for this run (a
        :class:`~bigdl_tpu_torch.parallel.sequence.SeqParallelConfig`, or
        None for dense): every ``MultiHeadAttention`` without its own
        ``ring_axis`` runs the ring or Ulysses kernel over the config's
        mesh axis, each rank on its slice of every row (the driver
        slices the rows, which every rank of the axis feeds whole).
        A quiet no-op where the axis does not split; the
        ``train/seq_parallel/degree`` gauge reads the degree reached."""
        from bigdl_tpu_torch.parallel.sequence import SeqParallelConfig
        if config is not None and not isinstance(config,
                                                 SeqParallelConfig):
            raise TypeError(
                f"set_sequence_parallel expects a "
                f"parallel.SeqParallelConfig or None, got "
                f"{type(config).__name__}")
        self._seq_parallel = config
        return self

    def _mesh_on(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _seq_axis(self):
        """``(axis, policy)``: the mesh axis the sequence is split over
        in this run (the ``set_sequence_parallel`` policy's, else a
        ``ring_axis`` of the model's attention) and the policy to
        install (None for the model's own)."""
        from bigdl_tpu_torch.parallel.mesh import resolve_axis_mesh
        from bigdl_tpu_torch.parallel.sequence import record_degree
        sp = self._seq_parallel
        if sp is not None and sp.active_on(self.mesh):
            if sp.mesh is None:
                import dataclasses
                sp = dataclasses.replace(sp, mesh=self.mesh)
            record_degree(sp.degree())
            return sp.axis, sp
        for m in self.model.modules():
            axis = getattr(m, "ring_axis", None)
            if axis is not None and resolve_axis_mesh(
                    getattr(m, "mesh", None) or self.mesh, axis) is not None:
                record_degree(self.mesh.shape.get(axis, 1))
                return axis, None
        record_degree(1)
        return None, None

    def _check_mesh(self) -> None:
        """What a mesh run cannot do yet raises before any step."""
        # an axis that neither splits the batch nor the sequence holds
        # replicas (every rank of it feeds the same rows), unless it is
        # one of the JAX package's model axes
        other = [a for a, n in self.mesh.shape.items()
                 if n > 1 and a in ("model", "pipe", "expert")]
        if other:
            raise NotImplementedError(
                f"mesh axes {other} split the model: tensor, expert and "
                f"pipeline parallelism are not ported yet (ROADMAP queue "
                f"1, item 11)")
        if getattr(self.dataset, "rotating", False) \
                or hasattr(self.dataset, "batch_fn"):
            raise NotImplementedError(
                "a device-cached dataset over a mesh is not ported yet "
                "(ROADMAP queue 1, item 11)")

    def set_precision(self, policy, scaler=None) -> "Optimizer":
        """Mixed-precision policy for this run
        (:class:`~bigdl_tpu_torch.precision.PrecisionPolicy`, a preset
        name such as ``"bf16_mixed"``, or None to go back to float32 /
        the Engine dtypes).

        The forward and backward run in ``compute_dtype``, the update on
        float32 weights (a float32 master copy in the optimizer state
        when ``param_dtype`` is below float32, which ``optimize()``
        seeds and casts the at-rest parameters to ``param_dtype`` for),
        and a float16 policy gets a
        :class:`~bigdl_tpu_torch.precision.DynamicLossScaler` (pass
        ``scaler`` to tune it) whose state is device tensors in the
        optimizer state, so ``set_steps_per_sync(K)`` windows carry it and
        checkpoints keep it. Validation runs under the policy too. When
        the run ends the model holds the float32 master copy."""
        if isinstance(policy, str):
            policy = PrecisionPolicy.named(policy)
        if policy is not None and not isinstance(policy, PrecisionPolicy):
            raise TypeError(
                f"set_precision expects a PrecisionPolicy, a preset "
                f"name or None, got {type(policy).__name__}")
        if scaler is not None and not isinstance(scaler,
                                                 DynamicLossScaler):
            raise TypeError(
                f"scaler must be a DynamicLossScaler, got "
                f"{type(scaler).__name__}")
        self._precision = policy
        self._loss_scaler = scaler
        return self

    # -- windowed driver planning (set_steps_per_sync) ---------------------
    def _window_limit(self, k: int, end_when):
        """Run-wide cap on the window size, with the reason for a
        fallback: windowed execution must be observably the per-step
        loop, so what the host cannot predict before a window runs
        (loss-dependent or unknown triggers, metric-driven learning-rate
        schedules) forces per-step sync."""
        if k <= 1:
            return 1, ""
        for what, t in (("end trigger", end_when),
                        ("validation trigger", self.validation_trigger),
                        ("checkpoint trigger", self.checkpoint_trigger)):
            if t is None or t.plannable():
                continue
            dep = sorted(t.depends_on) if t.depends_on is not None else None
            why = (f"{what} reads runtime state {dep}" if dep
                   else f"{what} has undeclared dependencies")
            return 1, why + "; per-step sync keeps its semantics exact"
        sched = getattr(self.optim_method, "learning_rate_schedule", None)
        if sched is not None and hasattr(sched, "record_metric"):
            return 1, ("metric-driven LR schedule (Plateau) adjusts per "
                       "step; per-step sync keeps it exact")
        for m in self.model.modules():
            why = getattr(m, "window_fallback", None)
            if why:
                # a host read in the forward (IfThenElse's predicate)
                # cannot be captured into a window's graph
                return 1, why + "; per-step sync runs it"
        return k, ""

    def _plan_window(self, k_max: int, state, bsz: int, ds_size: int,
                     end_when, shard_size: Optional[int] = None) -> int:
        """Largest ``k <= k_max`` such that the per-step loop would do no
        host work (a trigger firing, an epoch rollover, a shard rotation
        when ``shard_size`` is given) after steps 1..k-1. The k-th step
        may land on a boundary: the window ends there and the host
        replay handles it with the window's final parameters."""
        if k_max <= 1:
            return 1
        n0 = state["neval"]
        ep0 = state["epoch"]
        rec = state["recordsProcessedThisEpoch"]
        spos = ((n0 - 1) * bsz) % shard_size if shard_size else None
        for i in range(1, k_max):
            rec += bsz
            if rec >= ds_size:
                return i  # epoch rollover: the reshuffle
            if spos is not None:
                spos += bsz
                if spos >= shard_size:
                    return i  # the next shard rotates in before step i+1
            sim = {"epoch": ep0, "neval": n0 + i,
                   "recordsProcessedThisEpoch": rec}
            for t in (end_when, self.validation_trigger,
                      self.checkpoint_trigger):
                if t is not None and t.peek(sim):
                    return i
        return k_max

    def _window_lrs(self, k: int, state) -> List[float]:
        """The k learning rates the per-step loop would compute, by k
        real ``update_hyper_parameter()`` calls (the schedule's counters
        advance as they would per step; the epoch cannot change inside a
        window, which ends at a rollover)."""
        n0 = state["neval"]
        lrs = []
        for i in range(k):
            self.optim_method.state["neval"] = n0 + i
            lrs.append(self.optim_method.update_hyper_parameter())
        return lrs

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _param_names(self) -> List[str]:
        return [name for name, _ in self.model.named_parameters()]

    def _cursor_dataset(self):
        """The dataset, behind any ``TransformedDataSet`` wrappers (the
        ``.base`` chain), that carries a streaming pipeline's cursor, or
        None."""
        ds = self.dataset
        for _ in range(32):  # a cycle guard
            if ds is None:
                return None
            if callable(getattr(ds, "pipeline_state", None)) \
                    and callable(getattr(ds, "restore_pipeline_state",
                                         None)):
                return ds
            ds = getattr(ds, "base", None)
        return None

    def _checkpoint(self, step) -> None:
        """Write the run's state as a format-2 checkpoint: the params,
        the OptimMethod's buffers and the model state as the JAX
        package's trees, its host state and the driver's counters, with
        a streaming pipeline's read cursor as ``driver_state["datapipe"]``
        (the driver is one process, so the cursor is the run's)."""
        from bigdl_tpu_torch.utils.serialization import save_checkpoint
        suffix = "" if self.is_overwrite else f".{self.driver_state['neval']}"
        path = os.path.join(self.checkpoint_path, f"checkpoint{suffix}")
        names = self._param_names()
        buffers = step.opt_state
        mesh_step = getattr(step, "mesh", None) is not None
        if mesh_step:
            # every rank gathers; rank 0 writes; the others wait
            step.materialize()
            buffers = step.full_opt_state()
            if self.mesh.rank != 0:
                step.release()
                self._barrier()
                return
        opt_state = self.optim_method.state_tree(
            buffers, lambda ts: jax_tree(self.model, zip(names, ts)))
        driver_state = dict(self.driver_state)
        cursor_ds = self._cursor_dataset()
        if cursor_ds is not None:
            driver_state["datapipe"] = cursor_ds.pipeline_state()
        save_checkpoint(path, params=export_params(self.model),
                        opt_state=opt_state,
                        model_state=export_state(self.model),
                        optim_host_state=self.optim_method.get_state(),
                        driver_state=driver_state)
        logger.info("checkpointed to %s", path)
        if mesh_step:
            step.release()
            self._barrier()

    def _barrier(self) -> None:
        """Every rank of the mesh waits here (a gloo / NCCL barrier on
        the default group)."""
        import torch.distributed as dist
        dist.barrier()

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
        fires; returns the trained model (updated in place).

        A failure :func:`~bigdl_tpu_torch.faults.retry.classify` calls
        transient (an ``OSError``, a ``RuntimeError`` such as a CUDA
        error, an unknown type) starts the run again from the newest
        checkpoint after :func:`~bigdl_tpu_torch.faults.retry.backoff_delay`
        seconds, counted in ``train/optimizer/recoveries``, up to
        ``retry_times`` times; where no checkpoint has been written yet
        the run goes on from the parameters and counters the failure
        left. A fatal failure (a ``TypeError``, a shape mismatch...), the
        failure after the last retry, and any failure of a run with no
        checkpoint path raise unchanged, and so does any failure on a mesh
        of more than one rank (``tools.launch --max-restarts`` restarts
        the gang, which resumes from the newest checkpoint)."""
        retries = 0
        while True:
            try:
                return self._optimize_impl()
            except Exception as e:
                retries += 1
                # on a mesh a rank cannot retry alone (its peers wait in
                # a collective): the launcher's gang restart does it
                if classify(e) == "fatal" or retries > self.retry_times \
                        or self.checkpoint_path is None or self._mesh_on():
                    # the JAX package's flight recorder writes its
                    # post-mortem here; the port's waits for item 12
                    raise
                _RECOVERIES.inc()
                delay = backoff_delay(retries - 1, self.retry_interval_s,
                                      self.retry_max_interval_s)
                logger.exception("training failed (%s); retry %d/%d in "
                                 "%.2fs", e, retries, self.retry_times,
                                 delay)
                time.sleep(delay)

    def _optimize_impl(self) -> Module:
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
            # a streaming pipeline's cursor resumes the data position;
            # popped so the counters stay plain numbers
            cursor = state.pop("datapipe", None)
            cursor_ds = self._cursor_dataset()
            if cursor is not None and cursor_ds is not None:
                cursor_ds.restore_pipeline_state(cursor)
            self.resumed_from = {"path": resumed["path"],
                                 "neval": state["neval"]}
            # the steps a retry redoes are recorded once
            self.history = [h for h in self.history
                            if h["neval"] < state["neval"]]
        # epoch/iteration-driven schedules read the OptimMethod's state
        for k in ("epoch", "neval"):
            self.optim_method.state[k] = state[k]
        mesh_on = self._mesh_on()
        seq_axis, sp = self._seq_axis() if mesh_on else (None, None)
        if mesh_on:
            self._check_mesh()
        ndata = self.mesh.shape.get(self.data_axis, 1) if mesh_on else 1
        rank0 = not mesh_on or self.mesh.rank == 0
        log = logger.info if rank0 else (lambda *a, **k: None)
        step = build_train_step(model, self.criterion, self.optim_method,
                                self._gradient_clip,
                                precision=self._precision,
                                loss_scaler=self._loss_scaler,
                                mesh=self.mesh if mesh_on else None,
                                zero=self.zero_config,
                                seq_parallel=sp, data_axis=self.data_axis,
                                seq_axis=seq_axis)
        policy, scaler = step.policy, step.scaler
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

            if getattr(step, "mesh", None) is not None:
                # the checkpoint is unsharded: load it whole, then keep
                # this rank's shard of each buffer
                master = MASTER_KEY in step.opt_state
                full = self.optim_method.init_state([
                    torch.zeros(shape, dtype=torch.float32 if master
                                else p.dtype, device=device)
                    for shape, p in zip(step.full_shapes,
                                        model.parameters())])
                if master:
                    full[MASTER_KEY] = [torch.zeros(sh, device=device)
                                        for sh in step.full_shapes]
                if SCALER_KEY in step.opt_state:
                    full[SCALER_KEY] = {
                        k: v.clone()
                        for k, v in step.opt_state[SCALER_KEY].items()}
                self.optim_method.load_state_tree(
                    full, resumed["opt_state"], leaves_of, device=device)
                step.load_full_opt_state(full)
            else:
                self.optim_method.load_state_tree(
                    step.opt_state, resumed["opt_state"], leaves_of,
                    device=device)
        seed_precision(step, cast_params=self._precision is not None)
        self.train_step = step
        if mesh_on:
            from bigdl_tpu_torch.parallel.zero import record_memory_gauges
            self.memory = record_memory_gauges(*step.memory())
            log("mesh %s: ZeRO stage %d, sequence axis %s, %s",
                self.mesh.shape, step.stage, seq_axis, self.memory)
        if not policy.is_noop:
            log("precision policy: %s", policy.describe())
            # value 1 marks the active policy; series of earlier runs in
            # this process drop to 0
            for key in _POLICY_INFO.series():
                _POLICY_INFO.set(0.0, **dict(key))
            _POLICY_INFO.set(
                1.0, policy=policy.name,
                param=dtype_name(policy.param_dtype),
                compute=dtype_name(policy.compute_dtype),
                accum=dtype_name(policy.accum_dtype))
            _LOSS_SCALE.set(float(scaler.init_scale) if scaler else 1.0)
            _SKIPPED_STEPS.set(0.0)
        end_when = self.end_when or max_epoch(10)
        k_cap, why = self._window_limit(self.steps_per_sync, end_when)
        if k_cap < self.steps_per_sync:
            log("steps_per_sync=%d: falling back to per-step sync — %s",
                self.steps_per_sync, why)
        if mesh_on and k_cap > 1:
            import torch.distributed as dist
            log("steps_per_sync=%d: a mesh of %d ranks runs each "
                "window's steps eagerly under any backend (%s here): its "
                "collectives are not captured into a CUDA graph", k_cap,
                self.mesh.size, dist.get_backend())
        # the per-step rate is staged as the window's are, a 0-d tensor
        # in step.lr_dtype on the device, so both run one arithmetic
        lr_t = torch.zeros((), dtype=step.lr_dtype, device=device)
        ds_size = self.dataset.size()
        # a device-cached feed: each step samples and augments its batch
        # on the card from the cache (a rotating one's resident slot)
        rotating = getattr(self.dataset, "rotating", False)
        device_feed = rotating or hasattr(self.dataset, "batch_fn")
        shard_size = self.dataset.rot.shard_size if rotating else None
        if device_feed:
            feed_ds = self.dataset.template if rotating else self.dataset
            if torch.device(feed_ds.device) != device:
                raise ValueError(
                    f"the device cache lives on {feed_ds.device}, the "
                    f"model on {device}: build it with device="
                    f"'{device}'")
            if step.generator is None:
                # the crops and flips draw from a generator the step
                # owns, so a window's graph registers it
                step.generator = torch.Generator(device=device)
                step.generator.manual_seed(RandomGenerator.get_seed())
            gen = step.generator
            ds = self.dataset

            def feed(cursor):
                return feed_ds.batch_fn_on(ds.images, ds.labels, gen,
                                           cursor=cursor)

            def device_cursor(neval):
                """``(epoch, pos)`` of iteration ``neval`` (1-based; for
                rotating shards ``(visit, pos in shard)``), exact host
                integers, so no device integer ever overflows."""
                if rotating:
                    return ds.shard_cursor(neval)
                return divmod((neval - 1) * plan_bsz, ds_size)

            plan_bsz = ds.batch_size
            data_iter = None
            self.window = _DeviceWindow(
                step, feed, lambda: ds.images.data_ptr()) \
                if k_cap > 1 else None
        else:
            plan_bsz = self.batch_size
            data_iter = self.dataset.data(train=True)
            self.window = make_host_window(step) if k_cap > 1 else None
        pending: List[MiniBatch] = []   # batches pulled ahead of a window
        warned_unstackable = False

        def pull_batch() -> MiniBatch:
            if pending:
                return pending.pop(0)
            b = next(data_iter)
            if not isinstance(b, MiniBatch):
                raise ValueError(
                    "dataset must yield MiniBatch; add SampleToMiniBatch")
            if isinstance(b, StackedWindow):
                # a staged [K, B, ...] window: its K steps in order
                b, *rest = b.split()
                pending.extend(rest)
            return b

        def post_step(loss_f, lr, bsz, throughput, seconds):
            """One step's host bookkeeping: run after every step by the
            per-step loop, replayed K times after a window's one loss
            fetch, so counters, triggers and records see the per-step
            sequence either way."""
            nonlocal data_iter
            if rotating:
                # after this step's loss fetch: a piece of the next shard,
                # and the rotation at a shard boundary
                self.dataset.after_step(state["neval"])
            bsz *= ndata             # the global rows on a mesh
            throughput *= ndata
            state["neval"] += 1
            self.optim_method.state["neval"] = state["neval"]
            state["recordsProcessedThisEpoch"] += bsz
            state["Loss"] = loss_f
            state["LearningRate"] = lr
            state["Throughput"] = throughput
            self.history.append({"neval": state["neval"] - 1,
                                 "epoch": state["epoch"], "loss": loss_f,
                                 "lr": lr, "rows": bsz,
                                 "seconds": seconds})
            log("Epoch %d iter %d: loss %.4f lr %.5f throughput %.1f rec/s",
                state["epoch"], state["neval"] - 1, loss_f, lr, throughput)
            # epoch rollover (DistriOptimizer.scala:368-380): while, as
            # one batch can span several epochs. A continuous stream
            # keeps its iterator and the overshoot of a batch that
            # straddles the boundary, which tracks the stream's own
            # epochs; a restartable iterator begins a fresh permutation,
            # so the overshoot is dropped
            while state["recordsProcessedThisEpoch"] >= ds_size:
                state["epoch"] += 1
                self.optim_method.state["epoch"] = state["epoch"]
                state["recordsProcessedThisEpoch"] -= ds_size
                if not device_feed and not getattr(
                        self.dataset, "continuous_stream", False):
                    state["recordsProcessedThisEpoch"] = 0
                    self.dataset.shuffle()
                    data_iter = self.dataset.data(train=True)
            # windows end at every plannable trigger boundary, so with
            # k > 1 these fire only on a window's last replayed step
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

        wall_start = time.perf_counter()
        while not end_when(state):
            # the scripted worker-death site: a schedule raises here (the
            # classified retry runs) or SIGKILLs, keyed on the counters
            faults.point("train/step", neval=state["neval"],
                         epoch=state["epoch"])
            k_now = 1 if k_cap <= 1 else self._plan_window(
                k_cap, state, plan_bsz, ds_size, end_when,
                shard_size=shard_size)
            t0 = time.perf_counter()
            if device_feed:
                # one graph replay a window, or one eager step, each
                # batch drawn on the card at its cursor
                cursors = [device_cursor(state["neval"] + i)
                           for i in range(k_now)]
                feed_ds.ready_epochs(cursors[0][0])
                if k_now > 1:
                    lr_list = self._window_lrs(k_now, state)
                    loss_vals = self.window(cursors, lr_list).tolist()
                else:
                    lr_list = [self.optim_method.update_hyper_parameter()]
                    lr_t.fill_(lr_list[0])
                    cursor = torch.tensor(cursors[0], dtype=torch.int64)
                    loss_vals = [float(step(*feed(cursor.to(device)),
                                            lr_t))]
                seconds = time.perf_counter() - t0
                if scaler is not None:
                    self._record_scaler(step)
                rate = k_now * plan_bsz / max(1e-9, seconds)
                for i in range(k_now):
                    post_step(loss_vals[i], lr_list[i], plan_bsz, rate,
                              seconds / k_now)
                continue
            window = None
            if k_now > 1:
                # gather a window of stackable equal-shaped batches; a
                # shape change, the epoch boundary, a trigger boundary
                # by the actual sizes or exhaustion ends it early
                first = pull_batch()
                window = [first]
                staged = isinstance(first, WindowRow)
                if not staged and not _window_stackable(first) \
                        and not warned_unstackable:
                    warned_unstackable = True
                    log(
                        "steps_per_sync=%d: batches are not window-"
                        "stackable (sparse or device-resident leaves) — "
                        "running per-step", self.steps_per_sync)
                if staged or _window_stackable(first):
                    sig = batch_signature(first)
                    rec_sim = (state["recordsProcessedThisEpoch"]
                               + first.size() * ndata)

                    def boundary_after(steps_done, rec):
                        # _plan_window simulated the configured batch
                        # size; re-peek the plannable triggers with the
                        # actual record counts
                        sim = {"epoch": state["epoch"],
                               "neval": state["neval"] + steps_done,
                               "recordsProcessedThisEpoch": rec}
                        return any(t is not None and t.peek(sim)
                                   for t in (end_when,
                                             self.validation_trigger,
                                             self.checkpoint_trigger))

                    while len(window) < k_now and rec_sim < ds_size \
                            and not boundary_after(len(window), rec_sim):
                        try:
                            b = pull_batch()
                        except StopIteration:
                            break
                        if staged:
                            # the next step of the same staged window
                            fits = isinstance(b, WindowRow) \
                                and b.window is first.window \
                                and b.index == window[-1].index + 1
                        else:
                            fits = _window_stackable(b) \
                                and batch_signature(b) == sig
                        if not fits:
                            pending.insert(0, b)
                            break
                        window.append(b)
                        rec_sim += b.size() * ndata
                k_now = len(window)

            if k_now > 1:
                # one window: one graph replay, one host sync
                sizes = [b.size() for b in window]
                if staged:
                    # views of the window already on the card: the graph
                    # call copies them device to device
                    stacked = first.window.rows(first.index,
                                                first.index + k_now)
                else:
                    stacked = stack_minibatches(window)
                lr_list = self._window_lrs(k_now, state)
                losses = self.window(stacked.get_input(),
                                     stacked.get_target(), lr_list)
                loss_vals = losses.tolist()     # the one sync a window
                seconds = time.perf_counter() - t0
                if scaler is not None:
                    self._record_scaler(step)
                rate = sum(sizes) / max(1e-9, seconds)
                for i in range(k_now):
                    post_step(loss_vals[i], lr_list[i], sizes[i], rate,
                              seconds / k_now)
                continue

            batch = window[0] if window else pull_batch()
            inp = minibatch_input_to_device(batch.get_input(), device)
            tgt = minibatch_input_to_device(batch.get_target(), device)
            lr = self.optim_method.update_hyper_parameter()
            lr_t.fill_(lr)
            loss_f = float(step(inp, tgt, lr_t))   # the per-step sync
            seconds = time.perf_counter() - t0
            if scaler is not None:
                self._record_scaler(step)
            bsz = batch.size()
            post_step(loss_f, lr, bsz, bsz / max(1e-9, seconds), seconds)
        log("training done in %.1fs", time.perf_counter() - wall_start)
        if self.window is not None:
            self.window.close()       # the graphs' memory, not the counts
        if mesh_on:
            step.materialize()        # stage 3: the whole parameters
        master = step.opt_state.get(MASTER_KEY)
        if master is not None and mesh_on:
            # the master's shards gathered whole (every rank)
            master = step.full_opt_state()[MASTER_KEY]
        if master is not None:
            # the float32 master is the run's result; the at-rest
            # low-precision parameters are its rounding
            with torch.no_grad():
                for p, m in zip(model.parameters(), master):
                    p.data = m.detach().clone()
        return model

    @staticmethod
    def _record_scaler(step) -> None:
        """The loss-scale and skipped-steps gauges from the scaler state
        (read after the host sync, so no extra wait)."""
        ss = step.opt_state.get(SCALER_KEY)
        if ss is not None:
            _LOSS_SCALE.set(float(ss["scale"]))
            _SKIPPED_STEPS.set(float(ss["skipped"]))

    def _validate(self) -> Dict[str, float]:
        """One pass over the validation set through the Evaluator's
        sweep (each batch's output copied to the host once and scored
        there), or a device cache's centre crops on the card, under the
        precision policy when ``set_precision`` set one; the model is
        back in training mode after."""
        from bigdl_tpu_torch.optim.evaluator import Evaluator
        if hasattr(self.validation_dataset, "eval_batch_fn_on"):
            return self._validate_device_cached(self.validation_dataset)
        step = self.train_step
        mesh_step = getattr(step, "mesh", None) is not None
        if mesh_step:
            if step.seq_group is not None:
                raise NotImplementedError(
                    "validation under sequence parallelism is not ported "
                    "yet (ROADMAP queue 1, item 11)")
            step.materialize()
        try:
            results = Evaluator(self.model, self._precision).results(
                self.validation_dataset, self.validation_methods,
                self._val_batch_size)
        finally:
            self.model.train()
            if mesh_step:
                step.release()
        if mesh_step and step.data_group is not None:
            # each rank scored its own rows: the counts are summed
            import torch.distributed as dist
            seen = [None] * dist.get_world_size(step.data_group)
            dist.all_gather_object(seen, results, group=step.data_group)
            results = None
            for r in seen:
                if r is not None:
                    results = r if results is None else \
                        [a + b for a, b in zip(results, r)]
        return {} if results is None else self._score_summary(results)

    def _validate_device_cached(self, ds) -> Dict[str, float]:
        """Validation off the device cache: batch by batch from row 0,
        ``eval_batch_fn_on`` (centre crops, rows modulo n) and the
        evaluation forward on the card, the wrapped tail of the last
        batch trimmed, each batch's output scored on the host."""
        if torch.device(ds.device) != self._device():
            raise ValueError(
                f"the validation cache lives on {ds.device}, the model on "
                f"{self._device()}")
        eval_step = build_eval_step(self.model, self._precision)
        n, b = ds.size(), ds.batch_size
        results = None
        try:
            for start in range(0, n, b):
                x, y = ds.eval_batch_fn_on(ds.images, ds.labels, start)
                valid = min(b, n - start)
                out = eval_step(x)[:valid].cpu().numpy()
                tgt = y[:valid].cpu().numpy()
                batch_res = [m(out, tgt) for m in self.validation_methods]
                results = batch_res if results is None \
                    else [r + br for r, br in zip(results, batch_res)]
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
            if self.mesh is None or self.mesh.rank == 0:
                logger.info("validation %s: %s", key, r)
        return summary


class LocalOptimizer(Optimizer):
    """Single-process training on the model's device (one card, or the
    CPU)."""


class DistriOptimizer(Optimizer):
    """Synchronous data-parallel training over a mesh of ranks
    (``optim/DistriOptimizer.scala`` in the reference; the JAX package's
    ``DistriOptimizer``): ``mesh`` defaults to the Engine's
    (``utils.engine.mesh()``, one ``data`` axis over every rank once
    ``init_distributed`` has run). Each rank passes its own dataset
    (``DataSet.sharded(samples, rank, world)``)."""

    def __init__(self, model, dataset, criterion, batch_size: int = 32,
                 mesh=None):
        from bigdl_tpu_torch.utils import engine
        super().__init__(model, dataset, criterion, batch_size,
                         mesh=mesh or engine.mesh())
