"""Attention layers (counterpart of ``bigdl_tpu.nn.attention``).

Layout convention: ``[batch, seq, model]`` (B, S, E); heads split E.
Weights keep the JAX package's ``[in, out]`` layout and are applied as
``x @ w``, so converted parameters map 1:1 with no transpose.

Ported: ``dot_product_attention`` with the kernel route first (K1 or K2
through :func:`bigdl_tpu_torch.kernels.attention`), packed ``segments``,
the route of score matrices over 2 GiB to the blockwise kernel K2 (the
JAX package sends them to its bundled TPU flash kernel,
``_flash_attention_tpu``) and the einsum path, and
:class:`MultiHeadAttention` with its full-sequence and KV-cached
forwards. Not ported yet: attention dropout and the sequence-parallel
(ring / Ulysses) paths.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from bigdl_tpu_torch import kernels
from bigdl_tpu_torch.utils.engine import default_dtype

__all__ = ["MultiHeadAttention", "dot_product_attention"]

# Route to the blockwise flash kernel when the materialized [S, S] score
# matrix would not comfortably fit device memory: the JAX package's
# memory escape hatch, keyed on bytes (its threshold, kept so both
# packages take the route at the same shapes).
_FLASH_SCORE_BYTES = 2 << 30


def _flash_eligible(q, mask, dropout_rate, training) -> bool:
    if q.ndim < 4:  # the kernel needs [B,H,S,D]; lower ranks use einsum
        return False
    b, h, seq, d = q.shape[-4], q.shape[-3], q.shape[-2], q.shape[-1]
    scores_bytes = b * h * seq * seq * q.dtype.itemsize
    return (mask is None
            and not (training and dropout_rate > 0.0)
            and seq % 128 == 0 and d % 128 == 0
            and scores_bytes > _FLASH_SCORE_BYTES)


def dot_product_attention(q, k, v, *, causal: bool = False, mask=None,
                          dropout_rate: float = 0.0, rng=None,
                          training: bool = False, use_flash: bool = True,
                          segments=None):
    """Scaled dot-product attention over ``[B, H, S, D]`` q/k/v.

    The JAX package's rules: masking is EITHER ``mask`` (a boolean
    tensor broadcastable to ``[B, H, Sq, Sk]``, True = attend, ANDed
    with the causal structure; never kernel-eligible) OR ``segments``
    (the packed slab's ``[B, S]`` segment-id plane); both together
    raise. With ``use_flash`` and no ``mask`` the kernel dispatch
    (:func:`bigdl_tpu_torch.kernels.attention`) is tried first; a
    declined dispatch falls through, and the same-segment mask is
    derived here. Then, on a CUDA tensor with ``use_flash`` and no mask,
    a score matrix over 2 GiB (``[B, H, S, S]`` at q's itemsize, S and D
    multiples of 128) goes to the blockwise kernel K2
    (:func:`bigdl_tpu_torch.kernels.blockwise_flash_attention`, causal
    as asked), which launches or raises — the JAX package's route to its
    bundled TPU flash kernel, taken where the einsum path would not fit;
    on the CPU it is never taken, as the JAX package takes it on a TPU
    only. In practice it runs with flash switched off in the
    ``KernelConfig`` or declined as ``reason=vmem``. Everything else
    runs the einsum path. Attention dropout is not ported:
    ``training`` with ``dropout_rate > 0`` raises NotImplementedError
    (``rng`` is accepted for the signature's sake).

    The einsum path: scores in float32, divided by ``sqrt(D)`` *after*
    the product, masked entries filled with the float32 minimum (not
    ``-inf``), softmax in float32, weights cast to ``v.dtype`` for the
    second product."""
    if mask is not None and segments is not None:
        raise ValueError(
            "pass mask= OR segments=, not both: the kernel path can "
            "only honor segment equality, so a mask carrying anything "
            "more would be silently dropped")
    if training and dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout is not ported yet (dropout_rate must be "
            "0.0 in training)")
    d = q.shape[-1]
    if use_flash and mask is None:
        out = kernels.attention(q, k, v, causal=causal,
                                segment_ids=segments,
                                sm_scale=1.0 / math.sqrt(d))
        if out is not None:
            return out
    if segments is not None:
        # the einsum path's same-segment mask: its one derivation site
        seg = segments.to(device=q.device, dtype=torch.int32)
        mask = seg[:, None, :, None] == seg[:, None, None, :]
    if (use_flash and q.device.type == "cuda"
            and _flash_eligible(q, mask, dropout_rate, training)):
        return kernels.blockwise_flash_attention(q, k, v, causal=causal,
                                                 sm_scale=1.0 / math.sqrt(d))
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                          k.float()) / math.sqrt(d)
    fill = torch.finfo(scores.dtype).min
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        cmask = torch.ones((sq, sk), dtype=torch.bool,
                           device=scores.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~cmask, fill)
    if mask is not None:
        scores = scores.masked_fill(~mask, fill)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


class MultiHeadAttention(nn.Module):
    """Multi-head attention over ``[B, S, E]`` input.

    Parameters ``wq, wk, wv, wo`` (``[E, E]``, applied as ``x @ w``)
    and ``bq, bk, bv, bo``: the JAX param tree's names. ``generator``
    seeds the uniform(-1/sqrt(E), 1/sqrt(E)) init (None: torch's
    global generator)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 causal: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a "
                             f"multiple of num_heads {num_heads}")
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.causal = causal
        s = 1.0 / math.sqrt(hidden_size)
        for name in ("q", "k", "v", "o"):
            w = torch.empty((hidden_size, hidden_size),
                            dtype=default_dtype())
            w.uniform_(-s, s, generator=generator)
            self.register_parameter(f"w{name}", nn.Parameter(w))
            self.register_parameter(f"b{name}", nn.Parameter(
                torch.zeros(hidden_size, dtype=default_dtype())))

    def _proj(self, x, name: str):
        return x @ getattr(self, f"w{name}") + getattr(self, f"b{name}")

    def _split(self, t, b: int, s: int):  # [B,S,E] -> [B,H,S,D]
        return t.reshape(b, s, self.num_heads, self.head_dim) \
            .transpose(1, 2)

    def forward(self, x, *, cache: Optional[Dict[str, torch.Tensor]] = None,
                positions=None, attend_len: Optional[int] = None,
                segments=None):
        """Full-sequence attention, or — with ``cache=`` — one
        incremental (KV-cached) step.

        ``segments`` is the packed slab's ``[B, S]`` segment-id plane:
        queries attend only same-segment keys (the raw plane rides into
        the flash kernel; the einsum path derives the mask). It is a
        full-sequence (training) input and raises with ``cache=``.

        ``cache`` is ``{"k": [B,H,T,D], "v": [B,H,T,D]}``, updated IN
        PLACE (the JAX package returns a new cache; the port writes the
        buffers it was given, so the decode step never copies the
        cache). ``positions`` is an int32 ``[B]`` of per-row write
        offsets: the S new tokens of row ``b`` land at
        ``positions[b] .. positions[b]+S-1`` (the start clamped into
        ``[0, T-S]``, as ``dynamic_update_slice`` clamps), and each
        query at absolute position ``p`` attends the cached keys
        ``j <= p`` among the first ``attend_len`` slots. A one-token
        step goes through the ragged decode kernel with lengths
        ``positions + 1``."""
        b, s, e = x.shape
        q = self._split(self._proj(x, "q"), b, s)
        k = self._split(self._proj(x, "k"), b, s)
        v = self._split(self._proj(x, "v"), b, s)
        if cache is None:
            out = dot_product_attention(q, k, v, causal=self.causal,
                                        segments=segments)
        else:
            if segments is not None:
                raise ValueError(
                    "segment masks are not supported on the KV-cached "
                    "decode path (pack training slabs, not decode steps)")
            out = self._attend_cached(q, k, v, cache, positions, attend_len)
        out = out.transpose(1, 2).reshape(b, s, e)
        return self._proj(out, "o")

    def _attend_cached(self, q, k, v, cache, positions, attend_len):
        if positions is None:
            raise ValueError("cache= needs positions= (per-row int32 "
                             "write offsets into the KV cache)")
        ck, cv = cache["k"], cache["v"]
        b, _, s, _ = q.shape
        t = ck.shape[2]
        if s > t:
            raise ValueError(f"{s} new tokens do not fit a cache of {t}")
        positions = positions.to(device=q.device, dtype=torch.int32)
        # write the S new K/V rows at each row's offset, clamped into
        # the buffer like XLA's dynamic_update_slice
        start = positions.clamp(0, t - s)
        steps = torch.arange(s, device=q.device, dtype=torch.int32)
        rows = (start[:, None] + steps[None, :]).long()         # [B, S]
        bidx = torch.arange(b, device=q.device)[:, None].expand(b, s)
        ck[bidx, :, rows] = k.transpose(1, 2).to(ck.dtype)      # [B,S,H,D]
        cv[bidx, :, rows] = v.transpose(1, 2).to(cv.dtype)

        al = t if attend_len is None else int(attend_len)
        ks, vs = ck[:, :, :al, :], cv[:, :, :al, :]   # views, no copy
        if s == 1:
            # the decode step: the ragged kernel reads only
            # positions[b] + 1 valid rows of each slot's cache view
            # (None: decode switched off in the KernelConfig)
            out = kernels.decode_attention(q[:, :, 0, :], ks, vs,
                                           positions + 1)
            if out is not None:
                return out[:, :, None, :]
        # length-masked causal mask: query i of row b sits at absolute
        # position positions[b] + i and sees cache slots j <= that
        jpos = torch.arange(al, device=q.device)[None, None, None, :]
        qpos = positions[:, None, None, None] + steps[None, None, :, None]
        return dot_product_attention(q, ks, vs, mask=jpos <= qpos)
