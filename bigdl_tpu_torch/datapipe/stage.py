"""Device staging, the pipeline's last hop (counterpart of
``bigdl_tpu.datapipe.stage``):

- :func:`stage_batches` stages each ``[B, ...]`` MiniBatch to the card
  ``size`` steps ahead (``dataset.prefetch.device_prefetch``, with its
  stop-event and drain on abandonment and the ``prefetch/stage`` fault
  point);
- :func:`stage_windows` groups ``k`` consecutive equal-shaped batches
  into one ``[K, B, ...]`` :class:`~bigdl_tpu_torch.dataset.prefetch.StackedWindow`
  (``stack_windows``) and stages that: the buffer one window of ``k``
  train steps reads. The windowed Optimizer copies it device to device
  into its CUDA graph's static inputs (``Pipeline.as_dataset(
  staged_k=k)``).
"""
from __future__ import annotations

from typing import Iterator

from bigdl_tpu_torch.dataset.prefetch import (StackedWindow, device_prefetch,
                                              stack_windows)
from bigdl_tpu_torch.dataset.sample import MiniBatch

__all__ = ["stage_batches", "stage_windows"]


def stage_batches(it: Iterator[MiniBatch], *, size: int = 2,
                  device="cuda") -> Iterator[MiniBatch]:
    """Stage MiniBatches to ``device`` ``size`` steps ahead."""
    return device_prefetch(it, size=size, device=device)


def stage_windows(it: Iterator[MiniBatch], k: int, *, size: int = 2,
                  device="cuda") -> Iterator[StackedWindow]:
    """Stack ``k``-batch windows into ``[K, B, ...]`` buffers and stage
    them to ``device``. A shape change (a short final batch) closes a
    window early, as in ``stack_windows``."""
    windows = (StackedWindow(w.input, w.target)
               for w in stack_windows(it, k))
    return device_prefetch(windows, size=size, device=device)
