"""Criterions (counterpart of ``bigdl_tpu.nn.criterion``): the
classification pair LeNet trains with, the sequence loss of the
TransformerLM path, and the autoencoder's MSE with its binary
cross-entropy twin. Class labels are 1-based, as in the reference.

Not ported yet: the other classification, regression and ranking
losses of the JAX package.

:class:`TimeDistributedCriterion` applies any of them at every time
step of a recurrent model's ``(B, T, ...)`` output.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Criterion
from bigdl_tpu_torch.utils.engine import default_dtype

__all__ = ["BCECriterion", "ClassNLLCriterion", "Criterion",
           "CrossEntropyCriterion", "MSECriterion",
           "SequenceCrossEntropyCriterion", "TimeDistributedCriterion"]


def _reduce(x, size_average: bool):
    return x.mean() if size_average else x.sum()


def _target(target, like):
    return torch.as_tensor(target, device=like.device)


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities
    (nn/ClassNLLCriterion.scala): input ``[B, C]`` (or ``[C]``), target
    ``[B]`` 1-based labels (floats are truncated). ``weights`` weights
    each class; with ``size_average`` the weighted sum is divided by the
    total weight, else the plain sum is returned. ``logProbAsInput=
    False`` takes probabilities (``log(max(p, 1e-8))``).

    Labels out of range read as the JAX package's ``take_along_axis``
    reads them: label 0 (index -1) counts from the end, the last class;
    a label still outside ``[1, C]`` after that picks NaN, and with
    ``weights`` a NaN weight too."""

    def __init__(self, weights=None, size_average: bool = True,
                 logProbAsInput: bool = True):
        super().__init__()
        self.weights = None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=default_dtype())
        self.size_average = size_average
        self.log_prob_as_input = logProbAsInput

    def forward(self, input, target):
        x = input if self.log_prob_as_input \
            else torch.log(input.clamp(min=1e-8))
        if x.ndim == 1:
            x = x[None]
        c = x.shape[1]
        t = torch.as_tensor(target, device=x.device).reshape(-1).long() - 1
        idx = torch.where(t < 0, t + c, t)
        valid = (idx >= 0) & (idx < c)
        safe = idx.clamp(0, c - 1)
        picked = torch.where(valid, x.gather(1, safe[:, None])[:, 0],
                             float("nan"))
        if self.weights is not None:
            w = torch.where(valid, self.weights.to(x.device)[safe],
                            float("nan"))
            loss = -(picked * w).sum()
            return loss / w.sum() if self.size_average else loss
        return -(picked.mean() if self.size_average else picked.sum())


class CrossEntropyCriterion(Criterion):
    """LogSoftMax and ClassNLL in one (nn/CrossEntropyCriterion.scala)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.inner = ClassNLLCriterion(weights, size_average)

    def forward(self, input, target):
        return self.inner(torch.log_softmax(input, dim=-1), target)


class MSECriterion(Criterion):
    """nn/MSECriterion.scala: the mean (``size_average``) or the sum of
    ``(input - target) ** 2`` over every element."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        d = input - _target(target, input)
        return _reduce(d * d, self.size_average)


class BCECriterion(Criterion):
    """Binary cross-entropy on probabilities (nn/BCECriterion.scala):
    ``-(t log x + (1 - t) log(1 - x))`` with ``x`` clamped to ``[1e-12,
    1 - 1e-12]`` in the input's dtype (in float32 the upper bound rounds
    to 1, as in the JAX package), times ``weights`` (broadcast against
    the input) where given, then the mean or the sum."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=default_dtype())
        self.size_average = size_average

    def forward(self, input, target):
        eps = 1e-12
        t = _target(target, input)
        x = torch.clamp(input, eps, 1.0 - eps)
        loss = -(t * torch.log(x) + (1.0 - t) * torch.log(1.0 - x))
        if self.weights is not None:
            loss = loss * self.weights.to(input.device)
        return _reduce(loss, self.size_average)


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


class TimeDistributedCriterion(Criterion):
    """``critrn`` at every time step of ``(B, T, ...)`` input
    (nn/TimeDistributedCriterion.scala), the steps' losses summed (the
    sum divided by T with ``size_average``). ``dimension`` is the
    1-based time axis.

    With the time axis second, a per-step target and an unweighted
    mean- or sum-reducing inner criterion (``ClassNLLCriterion``,
    ``CrossEntropyCriterion``, ``MSECriterion``...), the time axis folds
    into the batch and ``critrn`` runs once: ``sum_t mean_B`` is ``T *
    mean_{B,T}``. Class weights break that identity (each step divides
    by its own batch's total weight), so a weighted criterion runs the
    per-step loop, as in the JAX package. With ``CrossEntropyCriterion``
    and ``size_average=False`` the loss is the sum over time of the
    per-step means, which the rnn recipes report ``exp`` of as the
    perplexity (the JAX package's behaviour, mirrored)."""

    def __init__(self, critrn: Criterion, size_average: bool = False,
                 dimension: int = 2):
        super().__init__()
        self.critrn = critrn
        self.size_average = size_average
        self.dimension = dimension

    def forward(self, input, target):
        axis = self.dimension - 1
        steps = input.shape[axis]
        target = _target(target, input)
        inner = getattr(self.critrn, "inner", None)
        sa = getattr(self.critrn, "size_average", None)
        if sa is None:          # CrossEntropyCriterion wraps ClassNLL
            sa = getattr(inner, "size_average", None)
        weighted = getattr(self.critrn, "weights", None) is not None \
            or getattr(inner, "weights", None) is not None
        if axis == 1 and sa is not None and not weighted \
                and target.ndim > 1 and target.shape[1] == steps:
            flat = self.critrn(input.reshape((-1,) + input.shape[2:]),
                               target.reshape((-1,) + target.shape[2:]))
            total = steps * flat if sa else flat
        else:
            per_step = target.ndim > axis and target.shape[axis] == steps
            total = 0.0
            for i in range(steps):
                ti = target.select(axis, i) if per_step else target
                total = total + self.critrn(input.select(axis, i), ti)
        return total / steps if self.size_average else total
