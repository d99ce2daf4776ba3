"""Transformer LM (counterpart of ``bigdl_tpu.models.transformer``).

Decoder-only LM with pre-norm blocks, learned positional embeddings,
attention dropout, MoE blocks (every ``moe_every``-th block, with the
load-balance term the train step adds to the objective) and a tied or
untied (``lm_head``) output head. Parameter names mirror the JAX param
tree — ``embed``, ``pos_embed``, ``ln_f/*``, ``lm_head``,
``block_{i}/{ln1,attn,ln2,mlp}/*`` — with ``/`` spelled ``.``, so
:func:`bigdl_tpu_torch.convert.load_jax_params` is a name map; an MoE
block's state (``block_{i}/mlp/{__bigdl_aux_loss__,expert_frac}``) is
its buffers.

The recipes are :mod:`bigdl_tpu_torch.models.transformer.train` and
``.test``. Sequence parallelism (``ring_axis``, ``sp_impl``, ``mesh``)
runs each rank on its slice of the sequence. Not ported yet: the
sharding rules, MoE on a mesh of more than one rank and the pipelined
LM (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.moe import MoE, pop_aux_losses
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.norm import LayerNorm
from bigdl_tpu_torch.utils.engine import default_dtype, resolve_device

_ITEM_11 = "(ROADMAP queue 1, item 11)"


def _mesh_ranks(mesh) -> int:
    """Ranks of a port mesh (1 for None or anything without a shape)."""
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, dict):
        return 1
    n = 1
    for v in shape.values():
        n *= int(v)
    return n

__all__ = ["FeedForward", "TransformerBlock", "TransformerLM"]


class FeedForward(Module):
    """``gelu(x @ w_up + b_up) @ w_down + b_down`` with the tanh
    approximation of GELU (``jax.nn.gelu``'s default)."""

    def __init__(self, hidden_size: int, ffn_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.ffn_size = ffn_size
        dt = default_dtype()
        s1 = 1.0 / math.sqrt(hidden_size)
        s2 = 1.0 / math.sqrt(ffn_size)
        self.w_up = nn.Parameter(torch.empty((hidden_size, ffn_size),
                                             dtype=dt)
                                 .uniform_(-s1, s1, generator=generator))
        self.b_up = nn.Parameter(torch.zeros(ffn_size, dtype=dt))
        self.w_down = nn.Parameter(torch.empty((ffn_size, hidden_size),
                                               dtype=dt)
                                   .uniform_(-s2, s2, generator=generator))
        self.b_down = nn.Parameter(torch.zeros(hidden_size, dtype=dt))

    def forward(self, x):
        h = F.gelu(x @ self.w_up + self.b_up, approximate="tanh")
        return h @ self.w_down + self.b_down


class TransformerBlock(Module):
    """Pre-norm causal block: ``x + MHA(LN(x))``; ``x + FFN(LN(x))``, the
    FFN an :class:`~bigdl_tpu_torch.nn.moe.MoE` of ``moe_experts``
    experts (top ``moe_top_k``) when ``moe_experts > 0``; ``dropout`` is
    the attention's."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, moe_experts: int = 0,
                 moe_top_k: int = 2, ring_axis: Optional[str] = None,
                 sp_impl: str = "ring", mesh=None):
        super().__init__()
        self.ln1 = LayerNorm(hidden_size)
        self.attn = MultiHeadAttention(hidden_size, num_heads,
                                       causal=True, generator=generator,
                                       dropout=dropout, ring_axis=ring_axis,
                                       sp_impl=sp_impl, mesh=mesh)
        self.ln2 = LayerNorm(hidden_size)
        if moe_experts > 0:
            self.mlp = MoE(hidden_size, ffn_size, moe_experts, moe_top_k,
                           generator=generator)
        else:
            self.mlp = FeedForward(hidden_size, ffn_size,
                                   generator=generator)
        self.moe_experts = moe_experts

    #: the JAX state tree holds ``mlp`` in every block, ``{}`` for a
    #: dense one (:func:`bigdl_tpu_torch.convert.jax_tree`)
    jax_tree_children = ("mlp",)

    def forward(self, x, *, cache=None, positions=None, attend_len=None,
                attn_segments=None,
                generator: Optional[torch.Generator] = None):
        x = x + self.attn(self.ln1(x), cache=cache, positions=positions,
                          attend_len=attend_len, segments=attn_segments,
                          generator=generator)
        return x + self.mlp(self.ln2(x))


class TransformerLM(Module):
    """Decoder-only LM over token ids ``[B, S]`` → logits ``[B, S, V]``.

    The head is tied to the token embedding (``x @ embed.T``), or with
    ``tie_embeddings=False`` its own ``lm_head [H, V]``. Block ``i`` is
    an MoE block of ``moe_experts`` experts when ``moe_experts`` and ``i
    % moe_every == moe_every - 1``. ``dropout`` is the attention's
    weight dropout in a training forward given a ``generator``.

    Also takes the PACKED 3-plane input the datapipe produces
    (:mod:`bigdl_tpu_torch.datapipe.packing`): a list or tuple
    ``[tokens, segment_ids, positions]``, each ``[B, S]`` int. Attention
    is restricted to same-segment (and causal) pairs, and positional
    embeddings are gathered at the per-document ``positions`` (clipped
    into ``[0, max_len-1]``). Segment id 0 marks padding; mask its
    targets with the criterion's ``ignore_index``.

    ``ring_axis``, ``sp_impl`` and ``mesh`` are the JAX package's
    sequence-parallel arguments (:class:`MultiHeadAttention`): where
    the axis splits, each rank runs the model on its slice of every row,
    ``S / n`` consecutive tokens whose positional embeddings start at
    ``seq_rank * S_local`` (so do a module without ``ring_axis`` under a
    training step's
    :class:`~bigdl_tpu_torch.parallel.sequence.SeqParallelConfig`); where
    it does not (world 1, or a ``mesh`` with no such axis) the dense
    path runs, as ``resolve_axis_mesh`` has the JAX package do. MoE
    blocks on a mesh of more than one rank and :meth:`sharding_rules`
    raise NotImplementedError (ROADMAP queue 1, item 11).

    ``device`` defaults to the card (``None`` → ``"cuda"``, raising when
    CUDA is missing); pass ``device="cpu"`` to run on the CPU.
    Parameters are initialised on the CPU from ``generator`` (a CPU
    ``torch.Generator``; None: torch's global generator) and then moved,
    so one seed gives the same weights on every device."""

    def __init__(self, vocab_size: int, hidden_size: int = 512,
                 num_layers: int = 6, num_heads: int = 8,
                 ffn_size: Optional[int] = None, max_len: int = 2048,
                 dropout: float = 0.0, ring_axis: Optional[str] = None,
                 sp_impl: str = "ring", mesh=None, moe_experts: int = 0,
                 moe_every: int = 2, tie_embeddings: bool = True,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if moe_experts and _mesh_ranks(mesh) > 1:
            raise NotImplementedError(
                f"TransformerLM(moe_experts={moe_experts}) on a mesh of "
                f"{_mesh_ranks(mesh)} ranks: expert parallelism and the "
                f"Switch aux term over global token means are not ported "
                f"yet {_ITEM_11}")
        if sp_impl not in ("ring", "ulysses"):
            raise ValueError(f"sp_impl must be ring|ulysses, got {sp_impl}")
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.ffn_size = ffn_size or 4 * hidden_size
        self.max_len = max_len
        self.dropout = dropout
        self.moe_experts = moe_experts
        self.tie_embeddings = tie_embeddings
        self.ring_axis = ring_axis
        self.sp_impl = sp_impl
        self.mesh = mesh
        dt = default_dtype()
        s = 1.0 / math.sqrt(hidden_size)
        self.embed = nn.Parameter(torch.randn(
            (vocab_size, hidden_size), generator=generator, dtype=dt) * s)
        self.pos_embed = nn.Parameter(torch.randn(
            (max_len, hidden_size), generator=generator, dtype=dt) * s)
        self.ln_f = LayerNorm(hidden_size)
        self.blocks = []
        for i in range(num_layers):
            moe = moe_experts if moe_experts \
                and i % moe_every == moe_every - 1 else 0
            blk = TransformerBlock(hidden_size, num_heads, self.ffn_size,
                                   generator=generator, dropout=dropout,
                                   moe_experts=moe, ring_axis=ring_axis,
                                   sp_impl=sp_impl, mesh=mesh)
            # block_{i}, not a ModuleList: the JAX tree's names
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        if not tie_embeddings:
            self.lm_head = nn.Parameter(torch.randn(
                (hidden_size, vocab_size), generator=generator,
                dtype=dt) * s)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @property
    def jax_tree_children(self):
        """Every ``block_{i}``: the JAX state tree holds each block."""
        return [f"block_{i}" for i in range(self.num_layers)]

    def sharding_rules(self, model_axis: str = "model",
                       expert_axis: Optional[str] = None):
        """The JAX package's megatron-style tensor- and expert-parallel
        rules: not ported yet."""
        raise NotImplementedError(
            f"TransformerLM.sharding_rules: tensor- and expert-parallel "
            f"layouts are not ported yet {_ITEM_11}")

    def seq_shard(self):
        """``(rank, n)`` along the sequence axis this forward runs on
        (the blocks' attention decides), or None for the dense path."""
        if not self.blocks:
            return None
        sp = self.blocks[0].attn.sequence_parallel()
        if sp is None:
            return None
        axis, _, mesh = sp
        return mesh.axis_index(axis), mesh.shape[axis]

    def aux_loss(self):
        """The sum of the MoE blocks' load-balance terms from the last
        forward (differentiable; 0.0 without MoE blocks), taken off the
        blocks (:func:`~bigdl_tpu_torch.nn.moe.pop_aux_losses`)."""
        return pop_aux_losses(self)

    def forward(self, tokens, *, cache: Optional[Dict[str, torch.Tensor]]
                = None, positions=None, attend_len: Optional[int] = None,
                generator: Optional[torch.Generator] = None):
        """Full-sequence logits, or — with ``cache={"k", "v"}`` of
        ``[layers, B, H, T, D]`` buffers, updated in place — one
        incremental step whose row ``b`` holds the S tokens at absolute
        positions ``positions[b] ..`` (positional indices clipped into
        ``[0, max_len-1]``; see :class:`MultiHeadAttention`).
        ``tokens`` may be the packed ``[tokens, segment_ids,
        positions]`` planes (class docstring), never with ``cache=``.
        ``generator`` (on the model's device) draws every block's
        attention-dropout masks in a training forward, one stream
        through the blocks in order (the JAX package splits one key per
        block)."""
        seg = None
        if isinstance(tokens, (list, tuple)):
            if len(tokens) != 3:
                raise ValueError(
                    "packed TransformerLM input must be [tokens, "
                    f"segment_ids, positions]; got {len(tokens)} planes")
            if cache is not None:
                raise ValueError(
                    "packed 3-plane input is a training/scoring layout; "
                    "the KV-cached decode path takes plain token ids")
            tokens, seg, packed_pos = (
                torch.as_tensor(t, device=self.device) for t in tokens)
            seg = seg.to(torch.int32)
        tokens = torch.as_tensor(tokens, device=self.device).long()
        _, s = tokens.shape
        if cache is None:
            if s > self.max_len:
                raise ValueError(f"sequence of {s} exceeds max_len "
                                 f"{self.max_len}")
            if seg is None:
                # a sequence-parallel rank holds positions r * s ..
                shard = self.seq_shard()
                off = 0 if shard is None else shard[0] * s
                if off + s > self.max_len:
                    raise ValueError(
                        f"sequence of {s * shard[1]} exceeds max_len "
                        f"{self.max_len}")
                x = self.embed[tokens] + self.pos_embed[off:off + s][None]
            else:
                # per-document positions (restarting at 0 per segment)
                idx = packed_pos.long().clamp(0, self.max_len - 1)
                x = self.embed[tokens] + self.pos_embed[idx]
        else:
            positions = positions.to(device=self.device, dtype=torch.int32)
            idx = (positions[:, None] + torch.arange(
                s, device=self.device, dtype=torch.int32)[None]) \
                .clamp(0, self.max_len - 1).long()
            x = self.embed[tokens] + self.pos_embed[idx]
        for i, blk in enumerate(self.blocks):
            layer = None if cache is None else \
                {"k": cache["k"][i], "v": cache["v"][i]}
            x = blk(x, cache=layer, positions=positions,
                    attend_len=attend_len, attn_segments=seg,
                    generator=generator)
        x = self.ln_f(x)
        return x @ self.embed.T if self.tie_embeddings else x @ self.lm_head
