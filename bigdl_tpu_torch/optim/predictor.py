"""Predictor (counterpart of ``bigdl_tpu.optim.predictor``; BigDL
optim/Predictor.scala:35, LocalPredictor.scala:37): the local path.

A batched forward over a dataset in evaluation mode on the model's
device; a sparse plane (a HostBatchedCOO) goes to the model as a COO
tensor. The last partial batch is padded to the batch size with
:func:`pad_rows`, so every forward sees one batch shape, and the pad
rows are dropped from the predictions.

Not ported yet: the mesh path (``Predictor(model, mesh=...)``) and its
device-cached sweep, ROADMAP queue 1, item 11.
"""
from __future__ import annotations

import itertools
from typing import Iterator, List

import numpy as np

from bigdl_tpu_torch.dataset.dataset import AbstractDataSet
from bigdl_tpu_torch.dataset.sample import (HostBatchedCOO, MiniBatch,
                                            minibatch_input_to_device)
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
from bigdl_tpu_torch.optim.optimizer import build_eval_step
from bigdl_tpu_torch.utils.engine import model_device

__all__ = ["LocalPredictor", "Predictor", "minibatches", "pad_rows"]


def minibatches(dataset, batch_size: int) -> Iterator[MiniBatch]:
    """One pass of MiniBatches over an AbstractDataSet (its
    ``data(train=False)``) or an iterable, of MiniBatches as they come
    or of Samples grouped by ``batch_size``."""
    it = dataset.data(train=False) if isinstance(dataset, AbstractDataSet) \
        else iter(dataset)
    first = next(it, None)
    if first is None:
        return
    full = itertools.chain([first], it)
    if isinstance(first, MiniBatch):
        yield from full
    else:
        yield from SampleToMiniBatch(batch_size).apply(full)


def pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Right-pad dim 0 to ``n`` rows by repeating the last row (inert
    for row-wise models)."""
    if a.shape[0] == n:
        return a
    if a.shape[0] > n:
        raise ValueError(
            f"batch of {a.shape[0]} rows exceeds batch_size={n}: a "
            "pre-batched dataset must use a batch size <= the "
            "predictor's (pass batch_size= matching the dataset's)")
    reps = np.repeat(a[-1:], n - a.shape[0], axis=0)
    return np.concatenate([a, reps], axis=0)


def padded_input(inp, batch_size: int):
    """A batch's input padded to ``batch_size`` rows when it has fewer
    (each plane of a multi-plane input alike; a sparse plane repeats
    its last row's entries)."""
    if isinstance(inp, (list, tuple)):
        return [padded_input(p, batch_size) for p in inp]
    if isinstance(inp, HostBatchedCOO):
        if inp.shape[0] >= batch_size:
            return inp
        return HostBatchedCOO(pad_rows(inp.indices, batch_size),
                              pad_rows(inp.values, batch_size),
                              (batch_size,) + inp.shape[1:], inp.fixed_nnz)
    a = np.asarray(inp)
    return pad_rows(a, batch_size) if a.shape[0] < batch_size else a


class Predictor:
    """Batched evaluation-mode forward of ``model`` over a dataset of
    MiniBatches or Samples, on the model's device; ``precision`` (a
    :class:`~bigdl_tpu_torch.precision.PrecisionPolicy`) runs it in the
    policy's compute dtype (:func:`build_eval_step`)."""

    def __init__(self, model, precision=None):
        self.model = model
        self.precision = precision

    def outputs(self, dataset, batch_size: int = 32):
        """``(host output, batch)`` per batch, pad rows dropped: the one
        sweep :meth:`predict` and the Evaluator share. The model is left
        in evaluation mode."""
        step = build_eval_step(self.model, self.precision)
        device = model_device(self.model)
        for b in minibatches(dataset, batch_size):
            out = step(minibatch_input_to_device(
                padded_input(b.get_input(), batch_size), device))
            yield out[:b.size()].cpu().numpy(), b

    def predict(self, dataset, batch_size: int = 32) -> List[np.ndarray]:
        """Per-sample predictions, in the dataset's order."""
        outs: List[np.ndarray] = []
        for out, _ in self.outputs(dataset, batch_size):
            outs.extend(out)
        return outs

    def predict_class(self, dataset, batch_size: int = 32) -> List[int]:
        """1-based argmax class, like the reference's predictClass."""
        return [int(np.argmax(o)) + 1
                for o in self.predict(dataset, batch_size)]


class LocalPredictor(Predictor):
    """Single-device predictor (LocalPredictor.scala:37)."""
