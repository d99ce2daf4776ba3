"""Criterions (counterpart of ``bigdl_tpu.nn.criterion``; BigDL
nn/*Criterion.scala): every classification, regression, ranking,
embedding and VAE loss of the JAX package, the sequence loss of the
TransformerLM path, and the criterions that combine others. Class
labels are 1-based, as in the reference; ``size_average`` takes the
mean where the sum is the other choice.

Table inputs and targets (a :class:`~bigdl_tpu_torch.utils.table.Table`
or a plain list) are read as the JAX ``apply`` reads them. A label
outside ``[1, C]`` reads as the JAX package's gathers read it: label 0
(index -1) counts from the end, and an index still out of range picks
NaN, which a mask may then zero (:func:`_take_along`).

:class:`TimeDistributedCriterion` applies any of them at every time
step of a recurrent model's ``(B, T, ...)`` output.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch.nn.module import Criterion
from bigdl_tpu_torch.utils.engine import default_dtype
from bigdl_tpu_torch.utils.table import Table

__all__ = ["AbsCriterion", "BCECriterion", "ClassNLLCriterion",
           "ClassSimplexCriterion", "CosineDistanceCriterion",
           "CosineEmbeddingCriterion", "Criterion", "CrossEntropyCriterion",
           "DiceCoefficientCriterion", "DistKLDivCriterion",
           "GaussianCriterion", "HingeEmbeddingCriterion", "KLDCriterion",
           "L1Cost", "L1HingeEmbeddingCriterion", "MSECriterion",
           "MarginCriterion", "MarginRankingCriterion", "MultiCriterion",
           "MultiLabelMarginCriterion", "MultiLabelSoftMarginCriterion",
           "MultiMarginCriterion", "ParallelCriterion",
           "SequenceCrossEntropyCriterion", "SmoothL1Criterion",
           "SmoothL1CriterionWithWeights", "SoftMarginCriterion",
           "SoftmaxWithCriterion", "TimeDistributedCriterion"]


def _reduce(x, size_average: bool):
    return x.mean() if size_average else x.sum()


def _target(target, like):
    return torch.as_tensor(target, device=like.device)


def _weights(weights):
    return None if weights is None else torch.as_tensor(
        np.asarray(weights), dtype=default_dtype())


def _labels(target, like):
    """1-based labels as 0-based int64 indices on ``like``'s device
    (floats truncated)."""
    return _target(target, like).long() - 1


def _in_range(idx, n: int):
    """``(clamped index, valid)`` of an index into ``n`` entries as the
    JAX package's default gathers read it: a negative index counts from
    the end once; one still out of range is not valid (it picks NaN and
    passes no gradient). The clamp keeps the gather in range, so no
    device assert fires on the card."""
    idx = torch.where(idx < 0, idx + n, idx)
    return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)


def _take_along(x, idx, dim: int = 1):
    """``x`` gathered at ``idx`` along ``dim`` (``idx`` with that axis
    of size 1), out-of-range indices reading NaN (:func:`_in_range`)."""
    safe, valid = _in_range(idx, x.shape[dim])
    return torch.where(valid, x.gather(dim, safe), float("nan"))


def _take(table, idx):
    """The rows of ``table`` at ``idx``, out-of-range indices reading
    NaN (:func:`_in_range`)."""
    safe, valid = _in_range(idx, table.shape[0])
    valid = valid.reshape(valid.shape + (1,) * (table.ndim - 1))
    return torch.where(valid, table[safe], float("nan"))


def _relu(x):
    """``max(x, 0)`` with the JAX ``maximum``'s gradient (half at a
    tie)."""
    return torch.maximum(x, x.new_zeros(()))


def _softplus(x):
    """``log(1 + exp(x))`` as ``logaddexp(0, x)``."""
    return torch.logaddexp(x.new_zeros(()), x)


def _cosine(a, b):
    """Row-wise cosine over the last axis, the norms' product clipped
    at 1e-12."""
    return (a * b).sum(dim=-1) / (
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1)).clamp(min=1e-12)


def _table_first(target):
    """A Table target's first entry; any other target as it is."""
    return target[1] if isinstance(target, Table) else target


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
        self.weights = _weights(weights)
        self.size_average = size_average
        self.log_prob_as_input = logProbAsInput

    def forward(self, input, target):
        x = input if self.log_prob_as_input \
            else torch.log(input.clamp(min=1e-8))
        if x.ndim == 1:
            x = x[None]
        t = _labels(target, x).reshape(-1)
        picked = _take_along(x, t[:, None])[:, 0]
        if self.weights is not None:
            w = _take(self.weights.to(x.device), t)
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
        self.weights = _weights(weights)
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


class AbsCriterion(Criterion):
    """nn/AbsCriterion.scala: the mean or sum of ``|input - target|``."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce((input - _target(target, input)).abs(),
                       self.size_average)


class SmoothL1Criterion(Criterion):
    """Huber with delta 1 (nn/SmoothL1Criterion.scala): ``0.5 d^2``
    where ``d = |input - target| < 1``, else ``d - 0.5``."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        d = (input - _target(target, input)).abs()
        return _reduce(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                       self.size_average)


class SmoothL1CriterionWithWeights(Criterion):
    """The sigma-scaled smooth L1 of Fast R-CNN's box loss
    (nn/SmoothL1CriterionWithWeights.scala). The target is a tensor or
    a Table ``(target, inside weights, outside weights)``: ``d =
    (input - target) * inside``, ``0.5 sigma^2 d^2`` where ``|d| < 1 /
    sigma^2``, else ``|d| - 0.5 / sigma^2``, times ``outside``; the sum,
    divided by ``num`` when it is positive."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__()
        self.sigma2 = sigma * sigma
        self.num = num

    def forward(self, input, target):
        if isinstance(target, Table):
            t, win, wout = (_target(target[i], input) for i in (1, 2, 3))
        else:
            t, win, wout = _target(target, input), None, None
        d = input - t
        if win is not None:
            d = d * win
        ad = d.abs()
        loss = torch.where(ad < 1.0 / self.sigma2,
                           0.5 * self.sigma2 * d * d, ad - 0.5 / self.sigma2)
        if wout is not None:
            loss = loss * wout
        total = loss.sum()
        return total / self.num if self.num > 0 else total


class MarginCriterion(Criterion):
    """The hinge loss ``max(0, margin - input * target)`` with targets
    +-1, squared with ``squared`` (nn/MarginCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        super().__init__()
        self.margin = margin
        self.size_average = size_average
        self.squared = squared

    def forward(self, input, target):
        h = _relu(self.margin - input * _target(target, input))
        if self.squared:
            h = h * h
        return _reduce(h, self.size_average)


class MarginRankingCriterion(Criterion):
    """``max(0, -y (x1 - x2) + margin)`` over a table input ``(x1,
    x2)``, ``y`` +-1 (a tensor or a Table's first entry)
    (nn/MarginRankingCriterion.scala)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        x1, x2 = list(input)[:2]
        y = _target(_table_first(target), x1)
        return _reduce(_relu(-y * (x1 - x2) + self.margin),
                       self.size_average)


class MultiMarginCriterion(Criterion):
    """The multi-class hinge (nn/MultiMarginCriterion.scala): for each
    row ``sum_{k != t} max(0, margin - x_t + x_k) ** p / C`` (``p`` 1 or
    2), each term times ``weights[t]`` where given; 1-based targets."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__()
        self.p = p
        self.weights = _weights(weights)
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        x = input if input.ndim == 2 else input[None]
        t = _labels(target, x).reshape(-1)
        m = _relu(self.margin - _take_along(x, t[:, None]) + x)
        if self.p == 2:
            m = m * m
        if self.weights is not None:
            m = m * _take(self.weights.to(x.device), t)[:, None]
        # the correct class itself (one-hot: no column for an index out
        # of range)
        own = torch.arange(x.shape[1], device=x.device) == t[:, None]
        m = torch.where(own, 0.0, m)
        return _reduce(m.sum(dim=1) / x.shape[1], self.size_average)


class MultiLabelMarginCriterion(Criterion):
    """The multi-label hinge (nn/MultiLabelMarginCriterion.scala): each
    target row lists 1-based label ids, and each row's loss is ``sum_j
    sum_k max(0, 1 - (x_{t_j} - x_k)) / C`` over its listed labels
    ``t_j`` and the classes ``k`` it does not list.

    As in the JAX package, every positive id of a row counts, also one
    after a 0 (Torch stops at the first 0), and a repeated id counts
    each time it is listed. The terms are computed whole, ``[B, T,
    C]`` for ``T`` target slots, as there."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        x = input if input.ndim == 2 else input[None]
        t = _target(target, x).long()
        if t.ndim == 1:
            t = t[None]
        c = x.shape[1]
        valid = t > 0
        tidx = (t - 1).clamp(0, c - 1)
        listed = torch.zeros_like(x, dtype=torch.int64).scatter_add_(
            1, tidx, valid.long()) > 0
        xt = x.gather(1, tidx)
        hinge = _relu(1.0 - (xt[:, :, None] - x[:, None, :]))
        mask = valid[:, :, None] & ~listed[:, None, :]
        return _reduce(torch.where(mask, hinge, 0.0).sum(dim=(1, 2)) / c,
                       self.size_average)


class MultiLabelSoftMarginCriterion(Criterion):
    """Sigmoid cross-entropy on logits
    (nn/MultiLabelSoftMarginCriterion.scala): ``softplus(-x) t +
    softplus(x) (1 - t)``, times ``weights`` where given, the mean over
    the last axis, then the mean or the sum over rows."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def forward(self, input, target):
        t = _target(target, input)
        loss = _softplus(-input) * t + _softplus(input) * (1.0 - t)
        if self.weights is not None:
            loss = loss * self.weights.to(input.device)
        return _reduce(loss.mean(dim=-1), self.size_average)


class SoftMarginCriterion(Criterion):
    """nn/SoftMarginCriterion.scala: ``log(1 + exp(-y x))``, the mean
    or the sum."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce(_softplus(-input * _target(target, input)),
                       self.size_average)


class HingeEmbeddingCriterion(Criterion):
    """nn/HingeEmbeddingCriterion.scala: ``x`` where ``y > 0``, else
    ``max(0, margin - x)``."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        loss = torch.where(_target(target, input) > 0, input,
                           _relu(self.margin - input))
        return _reduce(loss, self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """The L1 distance ``d`` of a pair ``(a, b)`` (summed over every
    element), hinged for a dissimilar pair
    (nn/L1HingeEmbeddingCriterion.scala): ``d`` where ``y > 0``, else
    ``max(0, margin - d)``; ``y`` one value."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = margin

    def forward(self, input, target):
        a, b = list(input)[:2]
        d = (a - b).abs().sum()
        y = _target(target, d).reshape(())
        return torch.where(y > 0, d, _relu(self.margin - d))


class CosineEmbeddingCriterion(Criterion):
    """nn/CosineEmbeddingCriterion.scala over a table input ``(x1,
    x2)``: ``1 - cos`` where ``y > 0``, else ``max(0, cos - margin)``;
    ``y`` a tensor or a Table's first entry."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        x1, x2 = list(input)[:2]
        if x1.ndim == 1:
            x1, x2 = x1[None], x2[None]
        y = _target(_table_first(target), x1).reshape(-1)
        cos = _cosine(x1, x2)
        loss = torch.where(y > 0, 1.0 - cos, _relu(cos - self.margin))
        return _reduce(loss, self.size_average)


class CosineDistanceCriterion(Criterion):
    """nn/CosineDistanceCriterion.scala: ``1 - cos(input, target)`` row
    by row, the mean or the sum."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        x, t = input, _target(target, input)
        if x.ndim == 1:
            x, t = x[None], t[None]
        return _reduce(1.0 - _cosine(x, t), self.size_average)


class DistKLDivCriterion(Criterion):
    """``KL(target || input)`` with log-probability input
    (nn/DistKLDivCriterion.scala): ``t (log t - x)`` where ``t > 0``,
    else 0, summed; with ``size_average`` divided by the batch size,
    or by the element count of a 1-D input."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def forward(self, input, target):
        t = _target(target, input)
        loss = torch.where(t > 0, t * (torch.log(t.clamp(min=1e-12))
                                       - input), 0.0).sum()
        if self.size_average:
            return loss / (input.shape[0] if input.ndim > 1
                           else input.numel())
        return loss


class KLDCriterion(Criterion):
    """The VAE posterior's KL to ``N(0, I)`` from a table input ``(mean,
    log_var)`` (nn/KLDCriterion.scala): ``0.5 sum(mean^2 + exp(lv) - 1
    - lv)`` over the last axis, averaged over the rest. The target may
    be left out."""

    def forward(self, input, target=None):
        mean, log_var = list(input)[:2]
        kl = 0.5 * (mean ** 2 + torch.exp(log_var) - 1.0
                    - log_var).sum(dim=-1)
        return kl.mean()


class GaussianCriterion(Criterion):
    """The VAE reconstruction loss ``-log N(target; mean, exp(log_var))``
    from a table input ``(mean, log_var)``, summed
    (nn/GaussianCriterion.scala)."""

    def forward(self, input, target):
        mean, log_var = list(input)[:2]
        t = _target(target, mean)
        return (0.5 * (math.log(2 * math.pi) + log_var
                       + (t - mean) ** 2 / torch.exp(log_var))).sum()


def _build_simplex(n_classes: int) -> np.ndarray:
    """The regular simplex of ``n_classes`` unit vertices in
    ``R^(n_classes - 1)`` (pairwise dot ``-1 / (n_classes - 1)``),
    zero-padded to ``n_classes`` columns, built in numpy float32 exactly
    as the JAX package builds it (ClassSimplexCriterion.scala's
    regsplex)."""
    n = max(1, n_classes - 1)
    a = np.zeros((n + 1, n), dtype=np.float32)
    for k in range(n):
        a[k, k] = np.sqrt(max(0.0, 1.0 - np.dot(a[k, :k], a[k, :k])))
        for i in range(k + 1, n + 1):
            a[i, k] = (-1.0 / n - np.dot(a[i, :k], a[k, :k])) / a[k, k]
    out = np.zeros((n_classes, n_classes), dtype=np.float32)
    out[:, :n] = a[:n_classes]
    return out


class ClassSimplexCriterion(Criterion):
    """The squared error to each class's simplex vertex
    (nn/ClassSimplexCriterion.scala): ``simplex[t - 1]`` (float32, the
    JAX package's bits) against the input's first ``min(n_classes,
    width)`` columns, the mean or the sum."""

    def __init__(self, n_classes: int, size_average: bool = True):
        super().__init__()
        self.n_classes = n_classes
        self.size_average = size_average
        self.simplex = torch.from_numpy(_build_simplex(n_classes))

    def forward(self, input, target):
        t = _labels(target, input).reshape(-1)
        goal = _take(self.simplex.to(input.device), t)
        k = min(self.n_classes, input.shape[-1])
        d = input[..., :k] - goal[..., :k]
        return _reduce(d * d, self.size_average)


class DiceCoefficientCriterion(Criterion):
    """``1 - Dice`` row by row (nn/DiceCoefficientCriterion.scala):
    ``1 - (2 sum(x t) + eps) / (sum x + sum t + eps)``, the mean or the
    sum over rows."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__()
        self.size_average = size_average
        self.epsilon = epsilon

    def forward(self, input, target):
        x = input.reshape(input.shape[0], -1) if input.ndim > 1 \
            else input[None]
        t = _target(target, input).reshape(x.shape)
        dice = 1.0 - (2.0 * (x * t).sum(dim=-1) + self.epsilon) / (
            x.sum(dim=-1) + t.sum(dim=-1) + self.epsilon)
        return _reduce(dice, self.size_average)


class SoftmaxWithCriterion(Criterion):
    """Caffe's SoftmaxWithLoss over class axis 1
    (nn/SoftmaxWithCriterion.scala): input ``[B, C, ...]``, target
    ``[B, ...]`` (or ``[B, 1, ...]``) of 1-based labels.

    Positions labelled ``ignore_label`` are left out. As in the JAX
    package the label is gathered before it is masked, so Caffe's usual
    ``ignore_label=255`` over 21 classes gathers out of range: the index
    is clamped first here (no device assert), and the masked position
    adds nothing to the loss or the gradient. ``normalize_mode``:
    ``"VALID"`` divides by the kept positions (at least 1),
    ``"BATCH_SIZE"`` by B, ``"FULL"`` by every position; any other
    value leaves the sum."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def forward(self, input, target):
        logp = torch.log_softmax(input, dim=1)
        t = _target(target, input).long()
        if t.ndim == input.ndim:
            t = t[:, 0]
        picked = _take_along(logp, (t - 1)[:, None])[:, 0]
        if self.ignore_label is not None:
            keep = t != self.ignore_label
            picked = torch.where(keep, picked, 0.0)
            count = keep.sum().clamp(min=1)
        else:
            count = max(picked.numel(), 1)
        loss = -picked.sum()
        if self.normalize_mode == "VALID":
            return loss / count
        if self.normalize_mode == "BATCH_SIZE":
            return loss / input.shape[0]
        if self.normalize_mode == "FULL":
            return loss / picked.numel()
        return loss


class L1Cost(Criterion):
    """nn/L1Cost.scala: ``sum |input|``; the target is ignored and may
    be left out."""

    def forward(self, input, target=None):
        return input.abs().sum()


class ParallelCriterion(Criterion):
    """The weighted sum of criterions over the entries of a table input
    (nn/ParallelCriterion.scala): criterion ``i`` scores input entry
    ``i`` against target entry ``i`` (a Table, list or tuple target; a
    single target pairs with the first entry), or against the whole
    target with ``repeat_target``."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.criterions = nn.ModuleList()
        self.weights = []
        self.repeat_target = repeat_target

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        inputs = list(input)
        if self.repeat_target:
            targets = [target] * len(inputs)
        else:
            targets = list(target) if isinstance(
                target, (Table, list, tuple)) else [target]
        total = 0.0
        for c, w, i, t in zip(self.criterions, self.weights, inputs,
                              targets):
            total = total + w * c(i, t)
        return total


class MultiCriterion(Criterion):
    """The weighted sum of criterions on the same input and target
    (nn/MultiCriterion.scala)."""

    def __init__(self):
        super().__init__()
        self.criterions = nn.ModuleList()
        self.weights = []

    def add(self, criterion: Criterion, weight: float = 1.0):
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        total = 0.0
        for c, w in zip(self.criterions, self.weights):
            total = total + w * c(input, target)
        return total
