"""ValidationMethods (counterpart of ``bigdl_tpu.optim.validation``;
BigDL optim/ValidationMethod.scala).

Each method maps a batch's ``(output, target)`` to a
:class:`ValidationResult`; results sum with ``+`` across batches. Scoring
runs on the host in numpy, after one copy of the batch's output: the
same arithmetic as the JAX package's, so the scores are equal.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["AccuracyResult", "Loss", "LossResult", "MAE", "Top1Accuracy",
           "Top5Accuracy", "TreeNNAccuracy", "ValidationMethod",
           "ValidationResult"]


class ValidationResult:
    """Accumulable metric result: ``+`` merges batch results,
    ``result()`` is ``(value, count)``."""

    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError


class AccuracyResult(ValidationResult):
    """correct / count (ValidationMethod.scala:83)."""

    def __init__(self, correct: int, count: int):
        self.correct = int(correct)
        self.count = int(count)

    def result(self):
        return (self.correct / max(1, self.count), self.count)

    def __add__(self, other):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        v, c = self.result()
        return f"Accuracy({self.correct}/{c} = {v:.4f})"


class LossResult(ValidationResult):
    """Summed loss / count (ValidationMethod.scala:162)."""

    def __init__(self, loss: float, count: int):
        self.loss = float(loss)
        self.count = int(count)

    def result(self):
        return (self.loss / max(1, self.count), self.count)

    def __add__(self, other):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        v, _ = self.result()
        return f"Loss({v:.4f})"


class ValidationMethod:
    """Scoring contract: ``method(output, target) -> ValidationResult``
    on host arrays."""

    name = "ValidationMethod"

    def __call__(self, output, target) -> ValidationResult:
        raise NotImplementedError

    def __repr__(self):
        return self.name


class Top1Accuracy(ValidationMethod):
    """ValidationMethod.scala:170: argmax against 1-based labels."""

    name = "Top1Accuracy"

    def __call__(self, output, target):
        out = np.asarray(output)
        t = np.asarray(target).reshape(-1)
        if out.ndim == 1:
            out = out[None]
        pred = out.argmax(axis=-1) + 1
        correct = int((pred == t.astype(np.int64)).sum())
        return AccuracyResult(correct, t.shape[0])


class TreeNNAccuracy(ValidationMethod):
    """ValidationMethod.scala:118: the accuracy of a tree (recursive)
    network, scored on the first node's output, the root, only.

    ``output``: ``[batch, nodes, classes]``, or ``[nodes, classes]`` for
    one tree; ``target``: ``[batch, nodes]`` (or ``[nodes]``), of which
    the first column is read. A 1-wide output thresholds at 0.5 (class
    1 at or above it, 0 below, as the JAX package compares it); a wider
    one takes the 1-based argmax."""

    name = "TreeNNAccuracy"

    def __call__(self, output, target):
        out = np.asarray(output)
        t = np.asarray(target)
        if out.ndim == 3:
            root, tgt, count = out[:, 0, :], t[:, 0], out.shape[0]
        elif out.ndim == 2:
            root, tgt, count = out[0, :][None], t.reshape(-1)[:1], 1
        else:
            raise ValueError("TreeNNAccuracy needs 2-d or 3-d output")
        if root.shape[-1] == 1:
            pred = (root[..., 0] >= 0.5).astype(np.int64)
        else:
            pred = root.argmax(axis=-1) + 1
        correct = int((pred == tgt.astype(np.int64)).sum())
        return AccuracyResult(correct, count)


class Top5Accuracy(ValidationMethod):
    """ValidationMethod.scala:218"""

    name = "Top5Accuracy"

    def __call__(self, output, target):
        out = np.asarray(output)
        t = np.asarray(target).reshape(-1).astype(np.int64)
        if out.ndim == 1:
            out = out[None]
        top5 = np.argsort(-out, axis=-1)[:, :5] + 1
        correct = int(sum(t[i] in top5[i] for i in range(t.shape[0])))
        return AccuracyResult(correct, t.shape[0])


class Loss(ValidationMethod):
    """ValidationMethod.scala:312: the criterion's mean loss (default
    :class:`~bigdl_tpu_torch.nn.criterion.ClassNLLCriterion`), run on
    the host copy."""

    name = "Loss"

    def __init__(self, criterion=None):
        from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
        self.criterion = criterion or ClassNLLCriterion()

    def __call__(self, output, target):
        out = np.asarray(output)
        with torch.no_grad():
            loss = float(self.criterion(torch.from_numpy(out),
                                        torch.as_tensor(np.asarray(target))))
        n = out.shape[0] if out.ndim > 1 else 1
        return LossResult(loss * n, n)


class MAE(ValidationMethod):
    """ValidationMethod.scala:332: mean absolute error."""

    name = "MAE"

    def __call__(self, output, target):
        out = np.asarray(output)
        t = np.asarray(target)
        loss = float(np.abs(out - t).mean())
        n = out.shape[0] if out.ndim > 1 else 1
        return LossResult(loss * n, n)
