"""Accuracy-delta gate for quantized serving loads (counterpart of
``bigdl_tpu.precision.gate``).

``ModelRegistry.load(quantize=True, calibration=..., accuracy_gate=
AccuracyGate(...))`` evaluates the candidate (quantized) model against
the float reference on held-out rows BEFORE anything is staged: if the
accuracy delta exceeds the bound the load raises
:class:`AccuracyGateError` and the registry is untouched — no version
registered, no program built, no traffic can resolve it. The measured
delta lands in the ``serving/precision/accuracy_delta`` gauge of
:data:`bigdl_tpu_torch.telemetry.REGISTRY` either way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.precision.calibrate import evaluating
from bigdl_tpu_torch.utils.engine import model_device

__all__ = ["AccuracyGate", "AccuracyGateError"]

_ACC_DELTA = telemetry.gauge(
    "serving/precision/accuracy_delta",
    "accuracy delta (reference minus candidate) measured by the last "
    "quantized-load gate evaluation, by model label")


class AccuracyGateError(ValueError):
    """A quantized load's accuracy delta exceeded the gate bound; the
    candidate was refused before staging."""


@dataclasses.dataclass
class AccuracyGate:
    """Eval-row gate for quantized loads.

    ``inputs`` — held-out eval rows ``[N, features...]``.
    ``targets`` — optional 1-based class labels ``[N]``; with targets
    the metric is each model's top-1 accuracy and the delta is
    ``acc_reference - acc_candidate``; without them the metric is top-1
    AGREEMENT with the reference (delta = disagreement rate).
    ``max_delta`` — the refusal bound. ``batch_size`` — evaluation
    chunking. Both models run in evaluation mode without gradients;
    top-1 is numpy's argmax of the host copy (ties to the first index,
    as in the JAX package)."""

    inputs: np.ndarray
    targets: Optional[np.ndarray] = None
    max_delta: float = 0.02
    batch_size: int = 64

    @staticmethod
    def _top1(model: nn.Module, x: np.ndarray) -> np.ndarray:
        with evaluating(model):
            out = model(torch.as_tensor(x, device=model_device(model)))
        out = out.float().cpu().numpy()
        return np.argmax(out.reshape(out.shape[0], -1), axis=1)

    def evaluate(self, reference: nn.Module, candidate: nn.Module) -> float:
        """The accuracy delta of ``candidate`` vs ``reference`` on the
        gate's rows (positive = the candidate is worse)."""
        x = np.asarray(self.inputs)
        ref_hits = cand_hits = agree = 0
        for start in range(0, x.shape[0], self.batch_size):
            chunk = x[start:start + self.batch_size]
            ref = self._top1(reference, chunk)
            cand = self._top1(candidate, chunk)
            if self.targets is not None:
                t = np.asarray(self.targets).reshape(-1)[
                    start:start + chunk.shape[0]].astype(np.int64) - 1
                ref_hits += int((ref == t).sum())
                cand_hits += int((cand == t).sum())
            else:
                agree += int((ref == cand).sum())
        n = x.shape[0]
        if self.targets is not None:
            return (ref_hits - cand_hits) / n
        return 1.0 - agree / n

    def check(self, reference: nn.Module, candidate: nn.Module, *,
              label: str = "") -> float:
        """Evaluate, record the gauge, and raise
        :class:`AccuracyGateError` when the delta exceeds
        ``max_delta``. Returns the delta on success."""
        delta = self.evaluate(reference, candidate)
        _ACC_DELTA.set(delta, **({"model": label} if label else {}))
        if delta > self.max_delta:
            raise AccuracyGateError(
                f"quantized model refused: accuracy delta {delta:.4f} "
                f"exceeds the gate bound {self.max_delta:.4f}"
                + (f" for {label!r}" if label else "")
                + " (recalibrate with representative batches, or raise "
                  "the bound if the regression is acceptable)")
        return delta
