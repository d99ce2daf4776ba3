"""Composable streaming pipeline: reader -> stages -> (optional) device
(counterpart of ``bigdl_tpu.datapipe.pipeline``).

The tf.data-shaped assembly surface over the datapipe pieces::

    from bigdl_tpu_torch import datapipe as dp

    pipe = (dp.Pipeline(dp.TextLineReader(shards, seed=7))
              .map(tokenize_to_ids)
              .shuffle(buffer_size=4096, seed=7)
              .pack(seq_len=512, batch_rows=8))
    ds = pipe.as_dataset(batch_size=8)      # drop-in Optimizer DataSet
    ds = pipe.as_dataset(batch_size=8, staged_k=8)  # windows on the card
    for window in pipe.staged(k=8):          # [K, B, ...] device buffers
        ...

Stages are ``(iterator, epoch) -> iterator`` callables constructed
fresh each epoch, so per-epoch seeding (shuffle permutations, packer
flushes) is structural: the stream is a pure function of
``(seed, epoch, cursor)`` and therefore bit-identical across runs,
across checkpoint/resume, and across the windowed driver's K.

Checkpoint/resume rides the source reader's cursor: ``state()`` /
``restore()`` round-trip through the optimizer's ``driver_state`` JSON
(see ``Optimizer._checkpoint``). The cursor names the next unread
SHARD record — records already pulled into a shuffle buffer or a
partially packed row at snapshot time sit before it and are SKIPPED on
resume (a bounded loss of at most ``buffer_size`` plus one batch's
worth per recovery, not silent reordering). Resume at epoch boundaries
is bit-exact — the determinism contract in docs/data.md.
"""
from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence

from bigdl_tpu_torch.datapipe.packing import (LengthBucketBatcher,
                                              SequencePacker)
from bigdl_tpu_torch.datapipe.readers import ShardedReader
from bigdl_tpu_torch.datapipe.shuffle import WindowShuffle
from bigdl_tpu_torch.dataset.dataset import PipelineDataSet
from bigdl_tpu_torch.dataset.sample import MiniBatch

__all__ = ["Pipeline"]


class _MapStage:
    def __init__(self, fn: Callable):
        self.fn = fn

    def __call__(self, it: Iterator, epoch: int) -> Iterator:
        return map(self.fn, it)


class _FilterStage:
    def __init__(self, pred: Callable):
        self.pred = pred

    def __call__(self, it: Iterator, epoch: int) -> Iterator:
        return filter(self.pred, it)


class _BatchStage:
    """Samples -> MiniBatches (``SampleToMiniBatch`` with the epoch-
    aware stage signature)."""

    def __init__(self, batch_size: int, drop_remainder: bool = False,
                 feature_padding=None, label_padding=None):
        from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch
        self.drop_remainder = drop_remainder
        self._b = SampleToMiniBatch(batch_size,
                                    feature_padding=feature_padding,
                                    label_padding=label_padding,
                                    drop_remainder=drop_remainder)

    def __call__(self, it: Iterator, epoch: int) -> Iterator[MiniBatch]:
        return self._b.apply(it)


class Pipeline:
    """Immutable-ish builder: each combinator returns ``self`` with the
    stage appended (chain in one expression; a pipeline instance is ONE
    stream — build a fresh one per concurrent consumer)."""

    def __init__(self, source: ShardedReader,
                 stages: Optional[Sequence] = None):
        self.source = source
        self.stages: List = list(stages or [])

    # ---- combinators -----------------------------------------------------
    def map(self, fn: Callable) -> "Pipeline":
        """Apply ``fn`` per record (tokenize, decode, augment...)."""
        self.stages.append(_MapStage(fn))
        return self

    def filter(self, pred: Callable) -> "Pipeline":
        """Keep records where ``pred(record)`` is true."""
        self.stages.append(_FilterStage(pred))
        return self

    def shuffle(self, buffer_size: int, seed: int = 0) -> "Pipeline":
        """Windowed seeded shuffle (``datapipe.shuffle.WindowShuffle``)."""
        self.stages.append(WindowShuffle(buffer_size, seed))
        return self

    def batch(self, batch_size: int, *, drop_remainder: bool = False,
              feature_padding=None, label_padding=None) -> "Pipeline":
        """Group :class:`Sample` records into MiniBatches."""
        self.stages.append(_BatchStage(batch_size, drop_remainder,
                                       feature_padding, label_padding))
        return self

    def pack(self, seq_len: int, batch_rows: int, **kw) -> "Pipeline":
        """Pack token documents into ``[batch_rows, seq_len]`` slabs
        with segment masks (``datapipe.packing.SequencePacker``)."""
        self.stages.append(SequencePacker(seq_len, batch_rows, **kw))
        return self

    def bucket(self, boundaries: Sequence[int], batch_size: int,
               **kw) -> "Pipeline":
        """Length-bucketed padded batching
        (``datapipe.packing.LengthBucketBatcher``)."""
        self.stages.append(LengthBucketBatcher(boundaries, batch_size,
                                               **kw))
        return self

    # ---- cursor ----------------------------------------------------------
    def state(self) -> dict:
        """Serializable resume point (the source reader's cursor)."""
        return self.source.state()

    def restore(self, state: dict) -> "Pipeline":
        """Continue from a :meth:`state` snapshot (same seeds/shards ⇒
        bit-identical continuation at shard-record granularity)."""
        self.source.restore(state)
        return self

    # ---- iteration -------------------------------------------------------
    def iterate(self, loop: bool = False) -> Iterator:
        """The host-side record/batch stream; ``loop=True`` crosses
        epochs forever (stages rebuilt + reseeded per epoch)."""
        while True:
            epoch = self.source.epoch
            it = self.source.read_epoch()
            for stage in self.stages:
                it = stage(it, epoch)
            yield from it
            if not loop:
                return

    def __iter__(self) -> Iterator:
        return self.iterate(loop=False)

    def iterate_detached(self) -> Iterator:
        """One repeatable epoch-0 pass that does NOT touch this
        pipeline's cursor: the source is shallow-copied (shard lists /
        arrays shared read-only) with its own fresh cursor, so every
        call yields the identical stream — the side-effect-free
        iteration ``PipelineDataSet.data(train=False)`` hands to
        validation/scoring consumers. Stateful stages (packers,
        bucketers) are copied too, with fresh stats and gauge reporting
        off, so an eval pass never folds its slabs into the TRAINING
        feed's cumulative padding_efficiency."""
        import copy
        src = copy.copy(self.source)
        src._cursor = {"epoch": 0, "spos": 0, "offset": 0}
        stages = []
        for stage in self.stages:
            if hasattr(stage, "_stats"):
                stage = copy.copy(stage)
                stage._stats = [0, 0]
                stage.report_gauge = False
            stages.append(stage)
        return Pipeline(src, stages).iterate(loop=False)

    def staged(self, k: Optional[int] = None, *, loop: bool = True,
               size: int = 2, device="cuda") -> Iterator[MiniBatch]:
        """Device-resident stream: plain staged batches, or — with
        ``k`` — ``[K, B, ...]`` stacked windows (``datapipe.stage``)."""
        from bigdl_tpu_torch.datapipe.stage import (stage_batches,
                                                    stage_windows)
        it = self.iterate(loop=loop)
        if k is None:
            return stage_batches(it, size=size, device=device)
        return stage_windows(it, k, size=size, device=device)

    # ---- dataset adapter -------------------------------------------------
    def count_epoch_records(self) -> int:
        """Records (MiniBatch = one record ⇒ its row count) one epoch-0
        pass emits — a detached cold scan that leaves the cursor alone
        (prefer passing ``size=`` to :meth:`as_dataset` when you know
        it)."""
        n = 0
        for item in self.iterate_detached():
            n += item.size() if isinstance(item, MiniBatch) else 1
        return n

    def as_dataset(self, size: Optional[int] = None,
                   batch_size: Optional[int] = None, *,
                   staged_k: Optional[int] = None,
                   device="cuda") -> PipelineDataSet:
        """Drop-in ``AbstractDataSet`` over this pipeline (feed it to an
        Optimizer). ``size`` is records per epoch in the units the
        stream yields (MiniBatch rows when batched/packed). Omitted, it
        is derived from the reader's cheap ``num_records()`` when every
        stage is count-preserving — map, shuffle, and non-dropping
        ``batch`` (total MiniBatch ROWS == source records); otherwise
        one cold scan counts an epoch — for a large corpus behind a
        filtering or packing stage, pass ``size=`` explicitly. With
        ``staged_k`` the training stream is ``staged(k=staged_k)`` on
        ``device``."""
        def preserves_count(stage) -> bool:
            if isinstance(stage, (_MapStage, WindowShuffle)):
                return True
            return isinstance(stage, _BatchStage) \
                and not stage.drop_remainder

        if size is None:
            if all(preserves_count(s) for s in self.stages):
                size = self.source.num_records()
            if size is None:
                size = self.count_epoch_records()
        return PipelineDataSet(self, size, batch_size=batch_size,
                               staged_k=staged_k, device=device)
