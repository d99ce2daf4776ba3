"""Transformer LM (counterpart of ``bigdl_tpu.models.transformer``).

Dense decoder-only LM with pre-norm blocks, learned positional
embeddings and a tied output head. Parameter names mirror
the JAX param tree — ``embed``, ``pos_embed``, ``ln_f/*``,
``block_{i}/{ln1,attn,ln2,mlp}/*`` — with ``/`` spelled ``.``, so
:func:`bigdl_tpu_torch.convert.load_jax_params` is a name map.

Not ported yet: MoE blocks, an untied output head, the packed 3-plane
input, sequence parallelism and the sharding rules.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.nn.norm import LayerNorm
from bigdl_tpu_torch.utils.engine import default_dtype, resolve_device

__all__ = ["FeedForward", "TransformerBlock", "TransformerLM"]


class FeedForward(nn.Module):
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


class TransformerBlock(nn.Module):
    """Pre-norm causal block: ``x + MHA(LN(x))``; ``x + FFN(LN(x))``."""

    def __init__(self, hidden_size: int, num_heads: int, ffn_size: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ln1 = LayerNorm(hidden_size)
        self.attn = MultiHeadAttention(hidden_size, num_heads,
                                       causal=True, generator=generator)
        self.ln2 = LayerNorm(hidden_size)
        self.mlp = FeedForward(hidden_size, ffn_size, generator=generator)

    def forward(self, x, *, cache=None, positions=None, attend_len=None):
        x = x + self.attn(self.ln1(x), cache=cache, positions=positions,
                          attend_len=attend_len)
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """Decoder-only LM over token ids ``[B, S]`` → logits ``[B, S, V]``,
    with the output head tied to the token embedding.

    ``device`` defaults to the card (``None`` → ``"cuda"``, raising when
    CUDA is missing); pass ``device="cpu"`` to run on the CPU.
    Parameters are initialised on the CPU from ``generator`` (a CPU
    ``torch.Generator``; None: torch's global generator) and then moved,
    so one seed gives the same weights on every device."""

    def __init__(self, vocab_size: int, hidden_size: int = 512,
                 num_layers: int = 6, num_heads: int = 8,
                 ffn_size: Optional[int] = None, max_len: int = 2048,
                 device: Optional[Union[str, torch.device]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.ffn_size = ffn_size or 4 * hidden_size
        self.max_len = max_len
        dt = default_dtype()
        s = 1.0 / math.sqrt(hidden_size)
        self.embed = nn.Parameter(torch.randn(
            (vocab_size, hidden_size), generator=generator, dtype=dt) * s)
        self.pos_embed = nn.Parameter(torch.randn(
            (max_len, hidden_size), generator=generator, dtype=dt) * s)
        self.ln_f = LayerNorm(hidden_size)
        self.blocks = []
        for i in range(num_layers):
            blk = TransformerBlock(hidden_size, num_heads, self.ffn_size,
                                   generator=generator)
            # block_{i}, not a ModuleList: the JAX tree's names
            self.add_module(f"block_{i}", blk)
            self.blocks.append(blk)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, *, cache: Optional[Dict[str, torch.Tensor]]
                = None, positions=None, attend_len: Optional[int] = None):
        """Full-sequence logits, or — with ``cache={"k", "v"}`` of
        ``[layers, B, H, T, D]`` buffers, updated in place — one
        incremental step whose row ``b`` holds the S tokens at absolute
        positions ``positions[b] ..`` (positional indices clipped into
        ``[0, max_len-1]``; see :class:`MultiHeadAttention`)."""
        tokens = tokens.to(device=self.device, dtype=torch.long)
        _, s = tokens.shape
        if cache is None:
            if s > self.max_len:
                raise ValueError(f"sequence of {s} exceeds max_len "
                                 f"{self.max_len}")
            x = self.embed[tokens] + self.pos_embed[:s][None]
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
                    attend_len=attend_len)
        return self.ln_f(x) @ self.embed.T
