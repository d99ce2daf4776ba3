"""Sharded streaming readers — records without materializing an epoch
(counterpart of ``bigdl_tpu.datapipe.readers``).

The reference's data plane was Spark RDD partitions streamed off
HDFS/S3 per epoch (BigDL paper §data-parallel ingestion; DataSet.scala's
SeqFileFolder reads record shards at cluster rates). The equivalent
here is a reader over an ordered list of **shards** (text files,
SequenceFile shards, array row-ranges) that yields records one at a
time with a tiny serializable **cursor** — so a terabyte corpus streams
through a bounded amount of host RAM, multi-host runs split shards by
process, and checkpoint/resume carries the exact read position in the
same JSON host-state the optimizer already persists (the
``driver_state`` block of the checkpoint MANIFEST format).

Cursor contract: ``state()`` returns ``{"epoch", "spos", "offset"}`` —
the epoch number, the position in this epoch's (seeded, per-epoch
permuted) shard order, and the record offset inside that shard.
``restore(state)`` on a fresh reader continues the stream bit-exactly:
same seed ⇒ same shard order ⇒ same records in the same order.

Epoch boundaries are explicit (``read_epoch``) so downstream stages —
the windowed shuffle's per-epoch permutation, sequence packers — flush
and reseed per epoch, which is what keeps the stream a pure function of
``(seed, epoch, position)`` no matter how it was paused or windowed.
"""
from __future__ import annotations

import itertools
from typing import Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch import faults, telemetry
from bigdl_tpu_torch.dataset.sample import Sample

__all__ = ["ArrayRecordReader", "SeqFileImageReader", "ShardedReader",
           "TextLineReader"]

_RECORDS = telemetry.counter("data/datapipe/records",
                             "records yielded by streaming readers")


class ShardedReader:
    """Base streaming reader over an ordered shard list.

    Subclasses implement :meth:`_open` (shard -> record iterator) and
    optionally :meth:`_shard_len` (for :meth:`num_records` without a
    scan). Multi-host: process ``process_index`` of ``process_count``
    reads shards ``[process_index::process_count]`` — the reader-side
    form of the optimizer's per-process batch-row contribution.

    ``shuffle_shards`` permutes the local shard order with a seeded,
    per-epoch permutation (the epoch joins the seed), so
    every epoch visits shards in a fresh but reproducible order.
    """

    def __init__(self, shards: Sequence, *, process_index: int = 0,
                 process_count: int = 1, shuffle_shards: bool = True,
                 seed: int = 0):
        self.all_shards = list(shards)
        if not self.all_shards:
            raise ValueError("reader needs at least one shard")
        if not (0 <= process_index < process_count):
            raise ValueError(
                f"process_index {process_index} out of range for "
                f"process_count {process_count}")
        self.process_index = process_index
        self.process_count = process_count
        self.local_shards = self.all_shards[process_index::process_count]
        if not self.local_shards:
            raise ValueError(
                f"process {process_index}/{process_count} has no shards "
                f"({len(self.all_shards)} total); use fewer processes or "
                "more shards")
        self.shuffle_shards = shuffle_shards
        self.seed = int(seed)
        self._cursor = {"epoch": 0, "spos": 0, "offset": 0}

    # ---- subclass surface ------------------------------------------------
    def _open(self, shard) -> Iterator:
        """Iterate one shard's records from the beginning."""
        raise NotImplementedError

    def _shard_len(self, shard) -> Optional[int]:
        """Record count of one shard, or None when only a scan can tell."""
        return None

    # ---- cursor ----------------------------------------------------------
    def state(self) -> dict:
        """Serializable read position (plain ints — rides the checkpoint
        ``driver_state`` JSON unchanged). Safe to call from a thread
        other than the reading one (the staged() consumer): shard and
        epoch transitions rebind the cursor dict atomically, so a
        snapshot is always internally consistent."""
        return dict(self._cursor)

    def restore(self, state: dict) -> "ShardedReader":
        """Continue from a :meth:`state` snapshot (same seed/shard list
        required for bit-identical continuation)."""
        self._cursor = {k: int(state[k])
                        for k in ("epoch", "spos", "offset")}
        return self

    @property
    def epoch(self) -> int:
        return self._cursor["epoch"]

    def _epoch_order(self, epoch: int) -> List[int]:
        if not self.shuffle_shards or len(self.local_shards) == 1:
            return list(range(len(self.local_shards)))
        rng = np.random.default_rng((self.seed, epoch))
        return [int(i) for i in rng.permutation(len(self.local_shards))]

    # ---- streaming -------------------------------------------------------
    def read_epoch(self) -> Iterator:
        """Yield the rest of the CURRENT epoch from the cursor position,
        then advance the cursor to the next epoch's start. The cursor
        observed between two yields always names the NEXT unread record,
        so a checkpoint taken mid-stream resumes without replay or
        skip."""
        epoch = self._cursor["epoch"]
        order = self._epoch_order(epoch)
        while self._cursor["spos"] < len(order):
            shard = self.local_shards[order[self._cursor["spos"]]]
            it = self._open(shard)
            skip = self._cursor["offset"]
            if skip:
                it = itertools.islice(it, skip, None)
            # the record counter flushes once per shard, so the hot loop
            # takes no lock a record
            n = 0
            try:
                for rec in it:
                    # a read that dies mid-shard surfaces as an error,
                    # never as a silently short epoch
                    faults.point("datapipe/read")
                    self._cursor["offset"] += 1
                    n += 1
                    yield rec
            finally:
                _RECORDS.inc(n)
            # ONE atomic rebind, never spos/offset mutated separately: a
            # state() snapshot from another thread (the staged()
            # prefetch stager runs this generator off-thread) must never
            # pair the next shard's spos with the old shard's offset
            self._cursor = {"epoch": epoch,
                            "spos": self._cursor["spos"] + 1,
                            "offset": 0}
        self._cursor = {"epoch": epoch + 1, "spos": 0, "offset": 0}

    def read(self, *, loop: bool = False) -> Iterator:
        """Stream records; ``loop=True`` crosses epoch boundaries forever
        (each epoch re-permutes the shard order)."""
        while True:
            yield from self.read_epoch()
            if not loop:
                return

    def num_records(self) -> Optional[int]:
        """Records per LOCAL epoch when shard lengths are known cheaply;
        None otherwise (``count_records`` scans)."""
        total = 0
        for s in self.local_shards:
            n = self._shard_len(s)
            if n is None:
                return None
            total += n
        return total

    def count_records(self) -> int:
        """Records per LOCAL epoch, scanning the shards if needed; the
        cursor is left untouched."""
        known = self.num_records()
        if known is not None:
            return known
        return sum(sum(1 for _ in self._open(s)) for s in self.local_shards)


class TextLineReader(ShardedReader):
    """Stream non-empty lines from text files (one shard per file) —
    the streaming replacement for ``read_words``-style whole-file
    materialization; feed it to a tokenizing ``map`` stage."""

    def __init__(self, paths: Sequence[str], *, strip: bool = True,
                 keep_empty: bool = False, encoding: str = "utf-8", **kw):
        super().__init__(paths, **kw)
        self.strip = strip
        self.keep_empty = keep_empty
        self.encoding = encoding

    def _open(self, shard) -> Iterator[str]:
        with open(shard, encoding=self.encoding) as f:
            for line in f:
                if self.strip:
                    line = line.rstrip("\n")
                if line or self.keep_empty:
                    yield line


class ArrayRecordReader(ShardedReader):
    """Stream :class:`Sample` rows from in-memory arrays, sharded into
    row ranges — the streaming face of ``DataSet.array`` (same records,
    but composable with cursors/shuffle/packing and never copied into a
    per-epoch list)."""

    def __init__(self, features: np.ndarray,
                 labels: Optional[np.ndarray] = None, *,
                 shard_size: int = 1024, **kw):
        features = np.asarray(features)
        n = len(features)
        if labels is not None and len(labels) < n:
            raise ValueError("labels shorter than features")
        shard_size = max(1, int(shard_size))
        shards = [(i, min(i + shard_size, n))
                  for i in range(0, n, shard_size)]
        super().__init__(shards, **kw)
        self.features = features
        self.labels = None if labels is None else np.asarray(labels)

    def _shard_len(self, shard) -> int:
        return shard[1] - shard[0]

    def _open(self, shard) -> Iterator[Sample]:
        lo, hi = shard
        for i in range(lo, hi):
            yield Sample(self.features[i],
                         None if self.labels is None else self.labels[i])


class SeqFileImageReader(ShardedReader):
    """Stream ``(jpeg_bytes, label, name)`` records from Hadoop
    SequenceFile shards (the reference's packed-ImageNet wire format,
    ``dataset.seqfile``) — one shard per ``.seq`` file."""

    def _open(self, shard) -> Iterator:
        from bigdl_tpu_torch.dataset.seqfile import read_seq_image_records
        return read_seq_image_records(shard)
