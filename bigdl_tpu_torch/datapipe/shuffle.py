"""Windowed global shuffle — bounded memory, seeded, per-epoch exact
(counterpart of ``bigdl_tpu.datapipe.shuffle``).

The reference shuffled per epoch by re-permuting cached RDD partitions
(DataSet.scala CachedDistriDataSet.shuffle); a streaming pipeline cannot
hold an epoch to permute it, so the classic substitute is a **bounded
shuffle buffer** (tf.data's ``shuffle(buffer_size)``): keep ``buffer_size``
records in flight, emit a uniformly chosen one as each new record
arrives, and drain with a final permutation at epoch end.

Two properties the generic version lacks are load-bearing here:

- **Seeded determinism.** The buffer's RNG derives from
  ``(seed, epoch)`` — ``np.random.default_rng((seed, epoch))`` — so
  the same seed
  yields a bit-identical record order across runs, across
  checkpoint/resume at epoch boundaries, and across the windowed
  driver's K (the shuffle is host-side and upstream of window
  stacking, so K never reorders it).
- **Per-epoch reseeding.** Each epoch is an independent deterministic
  permutation — epoch 2 of run A equals epoch 2 of run B without
  replaying epoch 1.

The buffer depth lands in the ``data/shuffle/buffer_depth`` gauge: a
depth pinned near zero is a starved shuffle (upstream too slow).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from bigdl_tpu_torch import telemetry

__all__ = ["WindowShuffle"]

_BUFFER_DEPTH = telemetry.gauge(
    "data/shuffle/buffer_depth",
    "records currently held by the windowed shuffle buffer")


class WindowShuffle:
    """Pipeline stage: bounded seeded shuffle (see module doc).

    ``buffer_size`` bounds host memory (records held at once) and the
    mixing radius: a record can move at most ~``buffer_size`` positions
    forward, so size it to several batches at minimum. ``buffer_size=1``
    degenerates to pass-through.
    """

    def __init__(self, buffer_size: int, seed: int = 0):
        if buffer_size < 1:
            raise ValueError(
                f"shuffle buffer_size must be >= 1, got {buffer_size}")
        self.buffer_size = int(buffer_size)
        self.seed = int(seed)

    def __call__(self, it: Iterator, epoch: int) -> Iterator:
        rng = np.random.default_rng((self.seed, int(epoch)))
        buf = []
        # the depth gauge updates on TRANSITIONS (filled, drain start,
        # drained), not per record: the steady-state loop takes no
        # instrument lock
        for rec in it:
            if len(buf) < self.buffer_size:
                buf.append(rec)
                if len(buf) == self.buffer_size:
                    _BUFFER_DEPTH.set(len(buf))
                continue
            j = int(rng.integers(self.buffer_size))
            out, buf[j] = buf[j], rec
            yield out
        # epoch end: drain with one final seeded permutation so the tail
        # is as shuffled as the steady state
        _BUFFER_DEPTH.set(len(buf))
        order = rng.permutation(len(buf))
        for j in order:
            yield buf[int(j)]
        _BUFFER_DEPTH.set(0)
