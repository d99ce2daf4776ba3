"""Criterions (counterpart of ``bigdl_tpu.nn.criterion``): the slice the
TransformerLM training path reads.

Not ported yet: the ~30 classification, regression and ranking losses
of the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["Criterion", "SequenceCrossEntropyCriterion"]


class Criterion(nn.Module):
    """Loss contract (``bigdl_tpu.nn.module.Criterion``):
    ``forward(input, target)`` returns a scalar loss tensor; gradients
    come from autograd."""

    def forward(self, input, target):
        raise NotImplementedError


class SequenceCrossEntropyCriterion(Criterion):
    """Token-level cross-entropy from raw logits for LM training: input
    ``[B, S, V]`` (or ``[B, V]``), target int token ids ``[B, S]`` (or
    ``[B]``).

    Targets are 0-based vocabulary ids. Out-of-range ids pick a row as
    the JAX package's ``mode="clip"`` gather does — a negative id counts
    from the end (``-1`` is the last id), then the index is clamped into
    the vocabulary — rather than producing NaN. ``ignore_index`` (e.g.
    -1, the packing convention) marks positions left out of the loss;
    the mean is over the kept tokens, divided by ``max(count, 1)``.
    ``label_smoothing`` mixes in the mean negative log-probability."""

    def __init__(self, label_smoothing: float = 0.0,
                 ignore_index: Optional[int] = None):
        super().__init__()
        self.label_smoothing = label_smoothing
        self.ignore_index = ignore_index

    def forward(self, input, target):
        v = input.shape[-1]
        logits = input.reshape(-1, v)
        t = torch.as_tensor(target, device=input.device).reshape(-1).long()
        logp = torch.log_softmax(logits, dim=-1)
        idx = torch.where(t < 0, t + v, t).clamp(0, v - 1)
        nll = -logp.gather(1, idx[:, None])[:, 0]
        if self.label_smoothing > 0.0:
            smooth = -logp.mean(dim=-1)
            nll = ((1.0 - self.label_smoothing) * nll
                   + self.label_smoothing * smooth)
        if self.ignore_index is None:
            return nll.mean()
        keep = t != self.ignore_index
        count = keep.sum().clamp(min=1)
        return torch.where(keep, nll, 0.0).sum() / count
