"""Ulysses all-to-all sequence parallelism (counterpart of
``bigdl_tpu.parallel.ulysses``).

Where the ring rotates K/V blocks, Ulysses re-shards: an all-to-all
(:class:`~bigdl_tpu_torch.parallel.comm.AllToAll`, whose backward is
the all-to-all back) swaps the split dim from SEQUENCE to HEADS, each
rank runs full-sequence attention for its ``H / n`` heads through
:func:`bigdl_tpu_torch.nn.attention.dot_product_attention` (so the
kernel route applies: K1, or K2 where the sequence is long), and a
second all-to-all swaps back. Packed segment ids are all-gathered so
the dense same-segment mask applies unchanged. Heads must divide by the
axis size.
"""
from __future__ import annotations

import torch

from bigdl_tpu_torch.parallel import comm

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(q, k, v, *, axis_name: str = "seq", mesh=None,
                      causal: bool = False, segments=None):
    """Exact attention with the sequence split over ``axis_name`` of
    ``mesh`` (None: the Engine's). Per-rank q, k, v ``[B, H, S_local,
    D]`` with H divisible by the axis size; returns ``[B, H, S_local,
    D]``. ``segments`` ``[B, S_local]`` are this rank's packed ids."""
    from bigdl_tpu_torch.nn.attention import dot_product_attention
    from bigdl_tpu_torch.parallel.mesh import resolve_axis_mesh

    m = resolve_axis_mesh(mesh, axis_name)
    group = None if m is None else m.group(axis_name)
    n = comm.group_size(group)
    if q.shape[1] % n:
        raise ValueError(
            f"ulysses needs heads ({q.shape[1]}) divisible by the "
            f"'{axis_name}' mesh size ({n})")
    if n == 1:
        return dot_product_attention(q, k, v, causal=causal,
                                     segments=segments)
    # [B, H, S/n, D] -> [B, H/n, S, D]
    qh, kh, vh = (comm.AllToAll.apply(t, group, 1, 2) for t in (q, k, v))
    seg_full = None
    if segments is not None:
        seg_full = comm.all_gather(segments.to(torch.int32),
                                   group, 1)
    oh = dot_product_attention(qh, kh, vh, causal=causal,
                               segments=seg_full)
    return comm.AllToAll.apply(oh, group, 2, 1)


def ulysses_attention_sharded(q, k, v, mesh, seq_axis: str = "seq", *,
                              causal: bool = False, segments=None):
    """Whole-array form (see
    :func:`~bigdl_tpu_torch.parallel.ring_attention.ring_attention_sharded`)."""
    group = mesh.group(seq_axis) if mesh is not None else None
    ql, kl, vl = (comm.ScatterSeq.apply(t, group, 2) for t in (q, k, v))
    seg = None
    if segments is not None:
        seg = segments.chunk(comm.group_size(group), 1)[
            comm.group_rank(group)].contiguous()
    out = ulysses_attention(ql, kl, vl, axis_name=seq_axis, mesh=mesh,
                            causal=causal, segments=seg)
    return comm.GatherSeq.apply(out, group, 2)
