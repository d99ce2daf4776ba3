"""Ring attention over a mesh axis (counterpart of
``bigdl_tpu.parallel.ring_attention``).

Each rank of the axis holds ``S_local`` consecutive positions of q, k
and v (rank ``r`` the global positions ``r * S_local + i``). The K/V
blocks travel around the ring (:func:`bigdl_tpu_torch.parallel.comm.ring_shift`)
while each rank keeps a running online-softmax accumulator for its
queries, so memory stays linear in the local length. The arithmetic is
the JAX package's, in float32: scores times ``1/sqrt(D)``, masked
entries filled with the float32 minimum (causal by global position,
and packed segments, whose key-side ids travel with their block),
``m``, ``l`` and ``o`` carried across blocks, a row with no key giving
zeros. The JAX package's ring is einsum arithmetic outside any Pallas
kernel, and so is this one: it launches no kernel of the port's own.

Autograd cannot differentiate a send or a receive, so the ring is one
``torch.autograd.Function``. Its backward runs the ring again from the
saved row log-sum-exp: each block's dK / dV accumulators travel with
the block, and after the last block one more hop (:func:`_return_hop`)
hands every accumulator back to the rank that owns the block.
"""
from __future__ import annotations

import math
from typing import List

import torch

from bigdl_tpu_torch.parallel import comm

__all__ = ["ring_attention", "ring_attention_sharded"]


def _return_hop(tensors, group) -> List[torch.Tensor]:
    """The backward's last hop: the finished dK / dV accumulators to the
    rank that owns their block."""
    return comm.ring_shift(tensors, group)


def _scores(q, k, scale, qpos, kpos, causal, seg_q, seg_k, neg):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s, neg)
    if seg_q is not None:
        same = seg_q[:, None, :, None] == seg_k[:, None, None, :]
        s = torch.where(same, s, neg)
    return s


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, segments, group, causal):
        n, my = comm.group_size(group), comm.group_rank(group)
        b, h, s_loc, d = q.shape
        scale = 1.0 / math.sqrt(d)
        dt = torch.promote_types(q.dtype, torch.float32)
        q32, kb, vb = q.to(dt), k.to(dt), v.to(dt)
        seg = None if segments is None else segments.to(torch.int32)
        segb = seg
        dev = q.device
        qpos = my * s_loc + torch.arange(s_loc, device=dev)
        neg = torch.tensor(torch.finfo(dt).min, dtype=dt, device=dev)
        m = torch.full((b, h, s_loc), torch.finfo(dt).min, dtype=dt,
                       device=dev)
        l = torch.zeros((b, h, s_loc), dtype=dt, device=dev)
        o = torch.zeros((b, h, s_loc, d), dtype=dt, device=dev)
        for t in range(n):
            src = (my - t) % n
            kpos = src * s_loc + torch.arange(s_loc, device=dev)
            sc = _scores(q32, kb, scale, qpos, kpos, causal, seg, segb, neg)
            m_new = torch.maximum(m, sc.amax(-1))
            # a row with everything masked keeps m_new at the minimum;
            # its garbage is wiped (corr = 0) once a real key arrives
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
            m = m_new
            if t < n - 1:       # rotate after use; no wasted last hop
                blk = [kb, vb] + ([] if segb is None else [segb])
                got = comm.ring_shift(blk, group)
                kb, vb = got[0], got[1]
                segb = None if segb is None else got[2]
        empty = l == 0.0
        out = o / torch.where(empty, torch.ones_like(l), l)[..., None]
        lse = torch.where(empty, torch.full_like(l, math.inf),
                          m + torch.log(torch.where(empty,
                                                    torch.ones_like(l), l)))
        ctx.save_for_backward(q32, k.to(dt), v.to(dt), out, lse,
                              *([] if seg is None else [seg]))
        ctx.group, ctx.causal, ctx.dtypes = group, causal, \
            (q.dtype, k.dtype, v.dtype)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q32, kb, vb, out, lse, *rest = ctx.saved_tensors
        seg = rest[0] if rest else None
        group, causal = ctx.group, ctx.causal
        n, my = comm.group_size(group), comm.group_rank(group)
        b, h, s_loc, d = q32.shape
        scale = 1.0 / math.sqrt(d)
        dt = q32.dtype
        dev = q32.device
        do = dout.to(dt)
        delta = (do * out).sum(-1)                       # [B,H,Sq]
        qpos = my * s_loc + torch.arange(s_loc, device=dev)
        neg = torch.tensor(torch.finfo(dt).min, dtype=dt, device=dev)
        segb = seg
        dq = torch.zeros_like(q32)
        dk = torch.zeros_like(kb)
        dv = torch.zeros_like(vb)
        for t in range(n):
            src = (my - t) % n
            kpos = src * s_loc + torch.arange(s_loc, device=dev)
            sc = _scores(q32, kb, scale, qpos, kpos, causal, seg, segb, neg)
            p = torch.exp(sc - lse[..., None])
            dv = dv + torch.einsum("bhqk,bhqd->bhkd", p, do)
            dp = torch.einsum("bhqd,bhkd->bhqk", do, vb)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kb) * scale
            dk = dk + torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
            if t < n - 1:
                # the accumulators travel with their block
                blk = [kb, vb, dk, dv] + ([] if segb is None else [segb])
                got = comm.ring_shift(blk, group)
                kb, vb, dk, dv = got[:4]
                segb = None if segb is None else got[4]
        if n > 1:
            dk, dv = _return_hop([dk, dv], group)
        qd, kd, vd = ctx.dtypes
        return dq.to(qd), dk.to(kd), dv.to(vd), None, None, None


def _axis_group(axis_name: str, mesh):
    from bigdl_tpu_torch.parallel.mesh import resolve_axis_mesh
    m = resolve_axis_mesh(mesh, axis_name)
    return None if m is None else m.group(axis_name)


def ring_attention(q, k, v, *, axis_name: str = "seq", mesh=None,
                   causal: bool = False, segments=None):
    """Exact attention with the sequence split over ``axis_name`` of
    ``mesh`` (None: the Engine's). Per-rank q, k, v ``[B, H, S_local,
    D]``, ``segments`` ``[B, S_local]`` packed ids (None: no packing);
    returns ``[B, H, S_local, D]`` in q's dtype. Where the axis does not
    split, the same arithmetic runs on the one block."""
    group = _axis_group(axis_name, mesh)
    return _Ring.apply(q, k, v, segments, group, causal)


def ring_attention_sharded(q, k, v, mesh, seq_axis: str = "seq", *,
                           causal: bool = False, segments=None):
    """Whole-array form: every rank of the axis holds the global q, k, v
    ``[B, H, S, D]`` (and ``segments [B, S]``); each takes its slice of
    S, runs the ring, and the slices are all-gathered back, so every
    rank returns the global result (gradients flow back through both
    steps)."""
    group = mesh.group(seq_axis) if mesh is not None else None
    ql, kl, vl = (comm.ScatterSeq.apply(t, group, 2) for t in (q, k, v))
    seg = None
    if segments is not None:
        seg = segments.chunk(comm.group_size(group), 1)[
            comm.group_rank(group)].contiguous()
    out = ring_attention(ql, kl, vl, axis_name=seq_axis, mesh=mesh,
                         causal=causal, segments=seg)
    return comm.GatherSeq.apply(out, group, 2)
