"""The training step on a mesh of ranks: data parallelism, ZeRO stages
1-3 and sequence parallelism, one process a rank (the distributed half
of ``bigdl_tpu.optim.optimizer.build_train_step``; the driver is
:class:`bigdl_tpu_torch.optim.optimizer.Optimizer`). The step's code is
:func:`~bigdl_tpu_torch.optim.optimizer.build_train_step`'s, the one
for every step; :class:`MeshSpread` supplies its distribution points.

The JAX package traces one SPMD program over global arrays; here each
rank runs its own rows and every collective is explicit
(:mod:`bigdl_tpu_torch.parallel.comm`). The contract is the JAX
package's multi-process one: each rank of the ``data`` axis feeds its
own rows, the global batch being their concatenation in rank order,
the same row count every step (a batch that changes size raises
ValueError); ranks along the sequence axis feed identical rows and each
keeps its ``S / n`` consecutive tokens.

The objective is the global one. A rank's loss is a part of the global
mean: with a criterion that has an ``ignore_index`` its weight is its
count of kept targets over the count summed across the ranks (so uneven
padding gives the global token mean, not a mean of means), otherwise
one over the number of ranks. The backward runs on that part, so the
gradients are SUMMED over the sequence and data axes: the mean over the
data axis and the sum over the sequence axis the global mean needs. The
regularization penalty is shared out the same way. The step returns the
global data loss, equal on every rank. Batch normalization takes the
global batch's statistics, and every random draw (dropout) is this
rank's rows of one draw of the global shape
(:mod:`bigdl_tpu_torch.parallel.global_batch`), as in the JAX package's
SPMD program.

The gradients are taken with respect to compute-dtype copies of the
parameters (bfloat16 under ``bf16_mixed``), so the reduction moves
compute-dtype bytes, as the JAX package's does; the update then runs on
float32: the parameters, or the float32 master shard. Under ZeRO
(:class:`~bigdl_tpu_torch.parallel.zero.ZeroConfig`) each leaf's shard
dim is the JAX package's (:func:`~bigdl_tpu_torch.parallel.zero.shard_dim`);
stage 1 all-reduces and updates its shard, stage 2 reduce-scatters,
both then all-gather the parameters; stage 3 keeps only its shard
between steps (``step.release()``: the module's parameters are empty
tensors at rest, :meth:`materialize` gathers them back) and all-gathers
them whole at the start of a step.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from bigdl_tpu_torch.parallel import comm
from bigdl_tpu_torch.parallel.global_batch import BatchSlice, use_batch_slice
from bigdl_tpu_torch.parallel.zero import shard_dim, shard_view, tree_bytes
from bigdl_tpu_torch.precision.policy import MASTER_KEY, SCALER_KEY

__all__ = ["MeshSpread", "check_identical_start"]


def _rows(x) -> int:
    if isinstance(x, (list, tuple)):
        return _rows(x[0])
    return int(x.shape[0])


def _seq_slice(x, index: int, n: int):
    """This rank's ``S / n`` consecutive positions of ``[B, S, ...]``
    (lists of planes walked)."""
    if isinstance(x, (list, tuple)):
        return [_seq_slice(e, index, n) for e in x]
    if x.shape[1] % n:
        raise ValueError(f"sequence length {x.shape[1]} does not split "
                         f"over the {n}-rank sequence axis")
    s = x.shape[1] // n
    return x.narrow(1, index * s, s)


def _all_reduce_flat(tensors, group, reduce) -> None:
    """Sum ``tensors`` over ``group`` in place through one flat buffer
    (``reduce(flat, group)``): one collective for all of them."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    reduce(flat, group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def _sum_gradients(flat: torch.Tensor, group) -> None:
    """The data axis's all-reduce of the whole-leaf gradients (one flat
    buffer a step), in place."""
    comm.all_reduce(flat, group)


def check_identical_start(module, mesh, axes) -> None:
    """Raise ValueError unless every rank of ``mesh`` holds the same
    parameters and buffers: a checksum of each (float64 sums) compared
    along each axis in ``axes``, so a rank built from another seed fails
    at the start instead of training a different model."""
    tensors = [*module.parameters(), *module.buffers()]
    if not tensors:
        return
    dev = tensors[0].device
    sums = torch.stack([t.detach().double().sum() for t in tensors]
                       + [t.detach().double().abs().sum() for t in tensors]
                       ).to(dev)
    for axis in axes:
        group = mesh.group(axis)
        if group is None:
            continue
        seen = comm.all_gather(sums[None], group, 0)
        if not bool((seen == seen[0:1]).all()):
            raise ValueError(
                f"ranks along mesh axis {axis!r} start from different "
                f"parameters: build the model from the same seeded "
                f"generator on every rank")


class MeshSpread:
    """The distribution points of
    :func:`~bigdl_tpu_torch.optim.optimizer.build_train_step`'s step on a
    mesh of more than one rank (its one step code calls them where a
    step on one rank does nothing): this rank's slice of the batch, the
    compute-dtype copies the gradients are taken for, the global batch
    and the sequence policy around the forward, the loss's weight, the
    gradients' reduction, the all-reduced finite flag, the sharded L2
    norm, the shards the update writes, and the parameters' all-gather
    after it. ``seq_axis`` is the mesh axis the sequence is split over
    (None: every rank of the data group sees whole rows);
    ``seq_parallel`` a policy installed around the forward (None where
    the model's own ``ring_axis`` does it).

    A model with MoE blocks raises (their load-balance term is a product
    of global token means; ROADMAP queue 1, item 11). :meth:`attach`
    gives the step its extra surface: ``materialize()`` / ``release()``
    (stage 3's whole parameters in the module, or empty),
    ``full_opt_state()`` and ``load_full_opt_state(state)`` (the
    unsharded buffers, collective), ``memory()`` (the per-rank bytes at
    rest), ``mesh``, ``stage``, ``dims`` (each leaf's shard dim),
    ``full_shapes`` and ``capturable`` (False: a window of steps runs
    them eagerly, whatever the backend)."""

    functional = True

    def __init__(self, module, criterion, *, mesh, policy, scaler=None,
                 zero=None, data_axis: str = "data",
                 seq_axis: Optional[str] = None, seq_parallel=None):
        if any(getattr(m, "moe_experts", 0) for m in module.modules()):
            raise NotImplementedError(
                "MoE on a mesh of more than one rank: the Switch aux term "
                "is a product of global token means, and expert "
                "parallelism is not ported yet (ROADMAP queue 1, item 11)")
        self.named = list(module.named_parameters())
        self.params = params = [p for _, p in self.named]
        self.mesh, self.policy, self.scaler = mesh, policy, scaler
        self.ndata = mesh.shape.get(data_axis, 1)
        self.nseq = mesh.shape.get(seq_axis, 1) if seq_axis else 1
        self.data_g = mesh.group(data_axis)
        self.seq_g = mesh.group(seq_axis) if seq_axis else None
        self.dr = mesh.axis_index(data_axis)
        self.sr = mesh.axis_index(seq_axis) if seq_axis else 0
        self.stage = stage = (zero.stage if zero is not None
                              and zero.active_on(mesh) else 0)
        self.dims = [shard_dim(tuple(p.shape), self.ndata)
                     if stage and p.is_floating_point() else None
                     for p in params]
        self.split = [i for i, d in enumerate(self.dims) if d is not None]
        self.n_parts = self.ndata * self.nseq
        self.full_shapes = [tuple(p.shape) for p in params]
        self.slice = BatchSlice(
            self.dr, self.ndata, self.nseq,
            tuple(g for g in (self.seq_g, self.data_g) if g is not None))
        self.seq_parallel = seq_parallel
        self.ignore_index = getattr(criterion, "ignore_index", None)
        self.rows = None
        check_identical_start(module, mesh,
                              [a for a in (data_axis, seq_axis) if a])
        with torch.no_grad():
            self.shards = None
            if stage == 3:
                self.shards = [self.part(p.detach(), i).to(
                    policy.param_dtype if p.is_floating_point() else p.dtype)
                    .clone() for i, p in enumerate(params)]
            self.master = None
            if policy.needs_master:
                # from the parameters as built, before any cast down
                self.master = [
                    self.part(p.detach(), i).to(policy.accum_dtype).clone()
                    if p.is_floating_point()
                    else self.part(p.detach(), i).clone()
                    for i, p in enumerate(params)]
        self.materialized = stage != 3

    def part(self, t, i):
        """This rank's shard of leaf ``i`` (``t`` for a whole leaf)."""
        return shard_view(t, self.dims[i], self.dr, self.ndata)

    def stored(self):
        """The tensors the update writes: stage 3's shards, or this
        rank's shard of each parameter (a view)."""
        if self.shards is not None:
            return self.shards
        return [self.part(p.data, i) for i, p in enumerate(self.params)]

    def state_leaves(self):
        return [t.detach() for t in (self.master if self.master is not None
                                     else self.stored())]

    def seed(self, opt_state) -> None:
        """The sharded master and the scaler state, in ``opt_state``."""
        if self.master is not None:
            opt_state[MASTER_KEY] = self.master
        if self.scaler is not None:
            opt_state[SCALER_KEY] = self.scaler.init_state(
                self.params[0].device if self.params else None)

    def batch(self, inputs, targets):
        rows = _rows(inputs)
        if self.rows is None:
            self.rows = rows
        if self.rows != rows:
            raise ValueError(
                f"multi-host train batch changed size {self.rows} -> "
                f"{rows}: local datasets must yield equal fixed-size "
                "batches per stream (drop the remainder or pad the final "
                "batch)")
        if self.nseq > 1:
            inputs = _seq_slice(inputs, self.sr, self.nseq)
            targets = _seq_slice(targets, self.sr, self.nseq)
        return inputs, targets

    def sources(self):
        """Compute-dtype copies of the whole parameters (gathered at
        stage 3), so the reduction moves compute-dtype bytes."""
        with torch.no_grad():
            full = (self.gather_all(self.shards) if self.shards is not None
                    else [p.detach() for p in self.params])
            leaves = [t.detach().to(self.policy.compute_dtype)
                      if t.is_floating_point() else t.detach() for t in full]
        for t in leaves:
            if t.is_floating_point():
                t.requires_grad_(True)
        return leaves

    @contextlib.contextmanager
    def scope(self):
        """The global batch (batch statistics, random draws) and the
        sequence policy around the forward."""
        with use_batch_slice(self.slice):
            if self.seq_parallel is None:
                yield
            else:
                from bigdl_tpu_torch.parallel.sequence import \
                    use_sequence_parallel
                with use_sequence_parallel(self.seq_parallel):
                    yield

    def sum_over_ranks(self, t):
        comm.all_reduce(t, self.seq_g)
        comm.all_reduce(t, self.data_g)
        return t

    def share(self, loss, targets):
        """This rank's part of the global mean: its kept targets over
        every rank's under an ``ignore_index``, else one over the
        ranks."""
        if self.ignore_index is None:
            return loss * (1.0 / self.n_parts)
        kept = (torch.as_tensor(targets, device=loss.device)
                != self.ignore_index).sum().to(torch.float32)
        total_kept = self.sum_over_ranks(kept.clone()).clamp(min=1.0)
        return loss * (kept / total_kept)

    def penalty(self, reg):
        return reg / self.n_parts if torch.is_tensor(reg) else reg

    def reduce(self, grads):
        """The summed gradient a rank updates with: whole for a whole
        leaf, this rank's shard for a sharded one."""
        if self.seq_g is not None:
            _all_reduce_flat(grads, self.seq_g, comm.all_reduce)
        whole = [g for g, d in zip(grads, self.dims)
                 if d is None or self.stage < 2]
        if whole and self.data_g is not None:
            _all_reduce_flat(whole, self.data_g, _sum_gradients)
        out = list(grads)
        if self.stage >= 2 and self.split:
            # one reduce-scatter a step over every sharded leaf
            got = comm.reduce_scatter_many(
                [grads[i] for i in self.split],
                [self.dims[i] for i in self.split], self.data_g)
            for i, g in zip(self.split, got):
                out[i] = g
        else:
            for i in self.split:
                out[i] = self.part(grads[i], i)
        return out

    def agree(self, finite):
        """Every rank skips the step if any rank's gradients are not
        finite."""
        ok = finite.to(torch.float32).reshape(1)
        return comm.all_reduce(ok, self.data_g, "min")[0] > 0

    def square_norm(self, grads):
        zero_t = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        sharded = sum((g.float().square().sum() for g, d in
                       zip(grads, self.dims) if d is not None), zero_t)
        whole = sum((g.float().square().sum() for g, d in
                     zip(grads, self.dims) if d is None), zero_t.clone())
        return comm.all_reduce(sharded, self.data_g) + whole

    def gather_all(self, shard_list):
        """The whole tensors of a list of per-leaf shards (one
        all-gather for every sharded leaf)."""
        out = list(shard_list)
        if self.split:
            got = comm.all_gather_many([shard_list[i] for i in self.split],
                                       [self.dims[i] for i in self.split],
                                       self.data_g)
            for i, t in zip(self.split, got):
                out[i] = t
        return out

    def finish(self) -> None:
        if self.shards is None and self.stage:
            # the one parameter all-gather of stages 1 and 2
            whole = self.gather_all(self.stored())
            for i, p in enumerate(self.params):
                if self.dims[i] is not None:
                    p.data.copy_(whole[i])

    def result(self, loss, share):
        """The global data loss, equal on every rank."""
        return self.sum_over_ranks(share.detach().float().clone())

    def materialize(self) -> None:
        """Stage 3: the whole parameters back in the module (a
        collective; every rank calls it)."""
        if self.materialized:
            return
        with torch.no_grad():
            for p, t in zip(self.params, self.gather_all(self.shards)):
                p.data = t        # a whole leaf shares its shard
        self.materialized = True

    def release(self) -> None:
        """Stage 3: drop the whole parameters (the shards stay)."""
        if self.stage != 3:
            return
        for p in self.params:
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.materialized = False

    def attach(self, step) -> None:
        opt_state = step.opt_state

        def full_opt_state():
            """The unsharded buffers (every rank calls it; a
            collective)."""
            return {k: self.gather_all(v) if isinstance(v, list) else v
                    for k, v in opt_state.items()}

        def load_full_opt_state(full):
            """Copy unsharded buffers in, this rank's shard of each (the
            resume onto any stage)."""
            with torch.no_grad():
                for k, v in full.items():
                    mine = opt_state.get(k)
                    if isinstance(v, list):
                        for i, (dst, src) in enumerate(zip(mine, v,
                                                           strict=True)):
                            dst.copy_(self.part(src.to(dst.device), i))
                    elif isinstance(v, dict):
                        for kk, t in v.items():
                            mine[kk].copy_(t)
                    elif isinstance(v, torch.Tensor):
                        mine.copy_(v)
                if self.master is not None:
                    for d, m in zip(self.stored(), self.master):
                        d.copy_(m)

        def memory():
            """``(params, opt_state)`` bytes this rank holds at rest."""
            held = self.shards if self.shards is not None else self.params
            return tree_bytes(held), tree_bytes([opt_state])

        step.mesh = self.mesh
        step.stage = self.stage
        step.dims = self.dims
        step.full_shapes = self.full_shapes
        step.data_group, step.seq_group = self.data_g, self.seq_g
        step.capturable = False
        step.materialize = self.materialize
        step.release = self.release
        step.full_opt_state = full_opt_state
        step.load_full_opt_state = load_full_opt_state
        step.memory = memory
        self.release()
