"""The collectives (the port's own; the JAX package has none to port:
XLA inserts its collectives from shardings).

Every collective of the port goes through this module: all-reduce (sum
or mean), reduce-scatter and all-gather along a dim (one tensor, or many
in one flat buffer: ``reduce_scatter_many``, ``all_gather_many``), the
all-to-all between the sequence and head dims, and the ring's send and
receive (``dist.batch_isend_irecv``). Each call is counted by op in
``telemetry.REGISTRY``: ``parallel/collectives/calls`` and
``parallel/collectives/bytes`` (the payload: the tensor a rank hands
in), and ``parallel/collectives/host_staged_bytes`` (bytes copied
between the card and pinned host memory). These counts stand in for the
JAX package's HLO-parsed ``zero.collective_counts``.

Under gloo a CUDA tensor always goes through a pinned host buffer: one
code path, no probing and no second try (gloo carries collectives
through host memory; several ranks sharing one card cannot use NCCL).
Under NCCL the tensors go as they are.

Where autograd crosses a collective it is a ``torch.autograd.Function``
whose backward is the adjoint collective: :class:`AllToAll` (its
adjoint is the all-to-all back), :class:`ScatterSeq` /
:class:`GatherSeq` (taking a rank's slice of a replicated tensor, and
all-gathering the slices; each the other's adjoint).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from bigdl_tpu_torch import telemetry

__all__ = ["AllToAll", "GatherSeq", "ScatterSeq", "all_gather",
           "all_gather_many", "all_reduce", "all_to_all", "counts",
           "group_rank", "group_size", "reduce_scatter",
           "reduce_scatter_many", "ring_shift"]

_CALLS = telemetry.counter("parallel/collectives/calls",
                           "collective calls, by op")
_BYTES = telemetry.counter("parallel/collectives/bytes",
                           "payload bytes handed to collectives, by op")
_STAGED = telemetry.counter(
    "parallel/collectives/host_staged_bytes",
    "bytes copied between the card and pinned host memory for gloo "
    "collectives, by op")


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t``."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def _count(op: str, nbytes: int, staged: int = 0) -> None:
    _CALLS.inc(op=op)
    _BYTES.inc(nbytes, op=op)
    if staged:
        _STAGED.inc(staged, op=op)


def counts() -> dict:
    """``{op: {"calls", "bytes", "host_staged_bytes"}}`` so far in this
    process."""
    out = {}
    for inst, key in ((_CALLS, "calls"), (_BYTES, "bytes"),
                      (_STAGED, "host_staged_bytes")):
        for labels, v in inst.series().items():
            op = dict(labels).get("op", "")
            out.setdefault(op, {"calls": 0, "bytes": 0,
                                "host_staged_bytes": 0})[key] = v
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (``"sum"``, ``"mean"``, or
    ``"min"``: a flag every rank must agree on); returns ``t``. A None
    group (one rank) leaves it as it is."""
    if op not in ("sum", "mean", "min"):
        raise ValueError(f"all_reduce op must be sum|mean|min, got {op}")
    if group is None:
        return t
    rop = dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.SUM
    if _staged(t, group):
        buf = _host(t)
        dist.all_reduce(buf, rop, group=group)
        t.copy_(buf)
        _count("all_reduce", _nbytes(t), 2 * _nbytes(t))
    else:
        dist.all_reduce(t, rop, group=group)
        _count("all_reduce", _nbytes(t))
    if op == "mean":
        t.div_(group_size(group))
    return t


def reduce_scatter(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's slice (its group rank's chunk along ``dim``) of the
    sum of ``t`` over ``group``; a new tensor."""
    n = group_size(group)
    if n == 1:
        return t.clone()
    chunks = [c.contiguous() for c in t.chunk(n, dim)]
    if _staged(t, group):
        chunks = [_host(c) for c in chunks]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks, group=group)
        _count("reduce_scatter", _nbytes(t),
               _nbytes(t) + _nbytes(out))
        return out.to(t.device)
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    _count("reduce_scatter", _nbytes(t))
    return out


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group rank
    order; a new tensor."""
    n = group_size(group)
    if n == 1:
        return t.clone()
    src = t.contiguous()
    if _staged(t, group):
        src_h = _host(src)
        outs = [torch.empty_like(src_h) for _ in range(n)]
        dist.all_gather(outs, src_h, group=group)
        full = torch.cat(outs, dim)
        _count("all_gather", _nbytes(t), _nbytes(t) + _nbytes(full))
        return full.to(t.device)
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    _count("all_gather", _nbytes(t))
    return torch.cat(outs, dim)


def reduce_scatter_many(tensors: Sequence[torch.Tensor],
                        dims: Sequence[int], group) -> List[torch.Tensor]:
    """:func:`reduce_scatter` of each tensor along its dim, in ONE
    collective: each tensor's ``n`` chunks are laid out rank by rank in
    one flat buffer (rank j's region holds every tensor's chunk j), the
    buffer is reduce-scattered, and this rank's region is cut back into
    its chunks (new tensors). The sums are elementwise, so the result is
    the per-tensor one bit for bit."""
    n = group_size(group)
    if n == 1:
        return [t.clone() for t in tensors]
    regions = [torch.cat([t.chunk(n, d)[j].reshape(-1)
                          for t, d in zip(tensors, dims)]) for j in range(n)]
    mine = reduce_scatter(torch.cat(regions), group, 0)
    out, off = [], 0
    for t, d in zip(tensors, dims):
        shape = list(t.shape)
        shape[d] //= n
        size = int(torch.Size(shape).numel())
        out.append(mine[off:off + size].view(shape))
        off += size
    return out


def all_gather_many(shards: Sequence[torch.Tensor], dims: Sequence[int],
                    group) -> List[torch.Tensor]:
    """:func:`all_gather` of each shard along its dim, in ONE
    collective: this rank's shards go out as one flat buffer, and each
    rank's region is cut back into chunks and concatenated per tensor
    (new tensors, in group rank order)."""
    n = group_size(group)
    if n == 1:
        return [s.clone() for s in shards]
    flat = torch.cat([s.reshape(-1) for s in shards])
    regions = all_gather(flat, group, 0).chunk(n)
    out = [[] for _ in shards]
    for region in regions:
        off = 0
        for i, s in enumerate(shards):
            out[i].append(region[off:off + s.numel()].view(s.shape))
            off += s.numel()
    return [torch.cat(parts, d) for parts, d in zip(out, dims)]


def all_to_all(t: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``t`` into ``n`` chunks along ``split_dim``, send chunk j to
    group rank j, and concatenate what arrives along ``concat_dim`` in
    group rank order (the JAX ``all_to_all(..., tiled=True)``)."""
    n = group_size(group)
    if n == 1:
        return t
    inp = torch.stack(t.chunk(n, split_dim))       # [n, ...] contiguous
    staged = _staged(t, group)
    if staged:
        inp = _host(inp)
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    _count("all_to_all", _nbytes(t), 2 * _nbytes(t) if staged else 0)
    res = torch.cat(out.unbind(0), concat_dim)
    return res.to(t.device) if staged else res


def ring_shift(tensors: Sequence[torch.Tensor], group,
               shift: int = 1) -> List[torch.Tensor]:
    """One hop of a ring: send each tensor to group rank ``(r + shift) %
    n`` and receive the same shapes from ``(r - shift) % n``, through
    ``dist.batch_isend_irecv``; returns the received tensors (new)."""
    n = group_size(group)
    if n == 1:
        return [t.clone() for t in tensors]
    r = group_rank(group)
    to = dist.get_global_rank(group, (r + shift) % n)
    frm = dist.get_global_rank(group, (r - shift) % n)
    staged = any(_staged(t, group) for t in tensors)
    sends = [(_host(t) if staged else t.contiguous()) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = [dist.P2POp(dist.isend, s, to, group) for s in sends] \
        + [dist.P2POp(dist.irecv, b, frm, group) for b in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    nb = sum(_nbytes(t) for t in tensors)
    _count("ring_shift", nb, 2 * nb if staged else 0)
    if staged:
        return [b.to(t.device) for b, t in zip(recvs, tensors)]
    return recvs


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all` with the all-to-all back as its backward."""

    @staticmethod
    def forward(ctx, x, group, split_dim: int, concat_dim: int):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return (all_to_all(grad.contiguous(), ctx.group, concat_dim,
                           split_dim), None, None, None)


class ScatterSeq(torch.autograd.Function):
    """This rank's chunk along ``dim`` of a tensor every rank of
    ``group`` holds whole; the backward all-gathers the chunks' grads
    (the gradient of the replicated tensor)."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        n, r = group_size(group), group_rank(group)
        return x.chunk(n, dim)[r].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(grad, ctx.group, ctx.dim), None, None


class GatherSeq(torch.autograd.Function):
    """Every rank's chunk concatenated along ``dim`` (a replicated
    result); the backward keeps this rank's chunk of the grad."""

    @staticmethod
    def forward(ctx, x, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        n, r = group_size(ctx.group), group_rank(ctx.group)
        return grad.chunk(n, ctx.dim)[r].contiguous(), None, None


