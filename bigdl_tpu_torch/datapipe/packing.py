"""Sequence packing and length bucketing for variable-length token data
(counterpart of ``bigdl_tpu.datapipe.packing``; numpy only).

- **Packing** (:func:`pack_documents`): several documents head-to-tail
  in each row of a fixed ``[rows, S]`` slab, with a ``segment_ids``
  plane so attention never looks across a document boundary and a
  ``positions`` plane that restarts at 0 per document.
- **Streaming stages** (:class:`SequencePacker`,
  :class:`LengthBucketBatcher`): ``stage(documents, epoch)`` yields
  ``MiniBatch([tokens, segment_ids, positions], targets)`` slabs, packed
  next-fit, or one document per row padded to its length bucket's
  bound (segment id 1 on real tokens). ``LengthBucketBatcher([S],
  len(docs))`` is the train CLI's ``--inputMode padded``.

Targets are next-token ids inside each document with ``ignore_index``
at pad positions (pair with ``SequenceCrossEntropyCriterion(
ignore_index=...)``). Every emitted slab sets the
``data/packing/padding_efficiency`` gauge (real tokens over slab
capacity, cumulative per stage). The stages plug into
:class:`~bigdl_tpu_torch.datapipe.Pipeline` (``.pack`` / ``.bucket``).
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch import telemetry
from bigdl_tpu_torch.dataset.sample import MiniBatch

__all__ = ["LengthBucketBatcher", "SequencePacker", "pack_documents",
           "padding_efficiency"]

_PAD_EFF = telemetry.gauge(
    "data/packing/padding_efficiency",
    "real tokens / slab capacity of emitted [B, S] token batches")


def padding_efficiency(lengths: Sequence[int], seq_len: int) -> float:
    """Real-token fraction of the pad-to-``seq_len`` layout for
    documents of these lengths."""
    lengths = [min(int(l), seq_len) for l in lengths]
    if not lengths:
        return 1.0
    return sum(lengths) / (len(lengths) * seq_len)


def _chunk_doc(doc: np.ndarray, max_tokens: int) -> List[np.ndarray]:
    """Split an over-long document into <= max_tokens pieces."""
    return [doc[i:i + max_tokens] for i in range(0, len(doc), max_tokens)]


class _RowBuilder:
    """One [S] row being filled with consecutive documents."""

    def __init__(self, seq_len: int, pad_id: int, ignore_index: int):
        self.seq_len = seq_len
        self.tokens = np.full(seq_len, pad_id, np.int32)
        self.segments = np.zeros(seq_len, np.int32)
        self.positions = np.zeros(seq_len, np.int32)
        self.targets = np.full(seq_len, ignore_index, np.int32)
        self.used = 0
        self.n_docs = 0

    def fits(self, n: int) -> bool:
        return self.used + n <= self.seq_len

    def add(self, doc: np.ndarray) -> None:
        # a document of length L contributes x = doc[:-1], y = doc[1:]
        n = len(doc) - 1
        lo = self.used
        self.n_docs += 1
        self.tokens[lo:lo + n] = doc[:-1]
        self.targets[lo:lo + n] = doc[1:]
        self.segments[lo:lo + n] = self.n_docs
        self.positions[lo:lo + n] = np.arange(n, dtype=np.int32)
        self.used += n


def _iter_packed_rows(docs, seq_len: int, pad_id: int, ignore_index: int):
    """The next-fit packing loop (deterministic, order-preserving):
    chunk at ``seq_len + 1``, drop pieces shorter than 2 tokens, close a
    row when the next piece no longer fits."""
    cur = _RowBuilder(seq_len, pad_id, ignore_index)
    for doc in docs:
        doc = np.asarray(doc)
        for piece in _chunk_doc(doc, seq_len + 1):
            if len(piece) < 2:
                continue
            if not cur.fits(len(piece) - 1):
                yield cur
                cur = _RowBuilder(seq_len, pad_id, ignore_index)
            cur.add(piece)
    if cur.used:
        yield cur


def pack_documents(docs: Sequence[np.ndarray], seq_len: int, *,
                   pad_id: int = 0, ignore_index: int = -1
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    """Pack integer token documents into fixed-shape slabs (greedy
    next-fit). Returns ``(tokens, segment_ids, positions, targets)``,
    each ``[rows, seq_len]`` int32."""
    if seq_len < 1:
        raise ValueError(f"seq_len must be >= 1, got {seq_len}")
    rows = list(_iter_packed_rows(docs, seq_len, pad_id, ignore_index))
    if not rows:
        z = np.zeros((0, seq_len), np.int32)
        return z, z.copy(), z.copy(), z.copy()
    _PAD_EFF.set(sum(r.used for r in rows) / (len(rows) * seq_len))
    return (np.stack([r.tokens for r in rows]),
            np.stack([r.segments for r in rows]),
            np.stack([r.positions for r in rows]),
            np.stack([r.targets for r in rows]))


def _emit(rows: List[_RowBuilder], stats, report: bool) -> MiniBatch:
    tokens = np.stack([r.tokens for r in rows])
    segs = np.stack([r.segments for r in rows])
    pos = np.stack([r.positions for r in rows])
    tgt = np.stack([r.targets for r in rows])
    stats[0] += sum(r.used for r in rows)
    stats[1] += len(rows) * rows[0].seq_len
    if report:
        _PAD_EFF.set(stats[0] / stats[1])
    return MiniBatch([tokens, segs, pos], tgt)


class SequencePacker:
    """Stage: token documents -> packed ``[batch_rows, seq_len]``
    MiniBatches (next-fit, as :func:`pack_documents`). Flushes at the
    end of the stream, so the packing is a function of the epoch's
    record stream; a final partial batch gets fully padded spare rows
    (static shapes) unless ``drop_remainder``. ``report_gauge=False``
    keeps a copy's slabs out of the gauge."""

    def __init__(self, seq_len: int, batch_rows: int, *, pad_id: int = 0,
                 ignore_index: int = -1, drop_remainder: bool = False):
        if seq_len < 1 or batch_rows < 1:
            raise ValueError("seq_len and batch_rows must be >= 1")
        self.seq_len = int(seq_len)
        self.batch_rows = int(batch_rows)
        self.pad_id = int(pad_id)
        self.ignore_index = int(ignore_index)
        self.drop_remainder = drop_remainder
        # cumulative [real tokens, capacity] over the stage's lifetime
        self._stats = [0, 0]
        self.report_gauge = True

    @property
    def efficiency(self) -> float:
        """Cumulative real-token fraction of everything emitted (the
        gauge's value)."""
        return self._stats[0] / self._stats[1] if self._stats[1] else 1.0

    def __call__(self, it: Iterator, epoch: int) -> Iterator[MiniBatch]:
        done: List[_RowBuilder] = []
        for row in _iter_packed_rows(it, self.seq_len, self.pad_id,
                                     self.ignore_index):
            done.append(row)
            if len(done) == self.batch_rows:
                yield _emit(done, self._stats, self.report_gauge)
                done = []
        if done and not self.drop_remainder:
            while len(done) < self.batch_rows:  # static shapes: pad rows
                done.append(_RowBuilder(self.seq_len, self.pad_id,
                                        self.ignore_index))
            yield _emit(done, self._stats, self.report_gauge)


class LengthBucketBatcher:
    """Stage: token documents -> length-bucketed padded MiniBatches, one
    document per row padded to its bucket's bound.

    ``boundaries`` are ascending inclusive upper bounds (each >= 2); a
    document longer than the last bound is truncated to it, one shorter
    than 2 tokens dropped. Each bucket fills on its own and emits
    ``[batch_size, bound]`` batches in the 3-plane layout (segment id 1
    on real tokens, 0 on pad); at the end of the stream the partial
    buckets flush in boundary order unless ``drop_remainder``."""

    def __init__(self, boundaries: Sequence[int], batch_size: int, *,
                 pad_id: int = 0, ignore_index: int = -1,
                 drop_remainder: bool = False):
        bounds = [int(b) for b in boundaries]
        if not bounds or sorted(bounds) != bounds or bounds[0] < 2:
            raise ValueError(
                f"boundaries must be ascending and >= 2, got {bounds}")
        self.boundaries = bounds
        self.batch_size = int(batch_size)
        self.pad_id = int(pad_id)
        self.ignore_index = int(ignore_index)
        self.drop_remainder = drop_remainder
        self._stats = [0, 0]
        self.report_gauge = True

    @property
    def efficiency(self) -> float:
        """Cumulative real-token fraction of emitted batches."""
        return self._stats[0] / self._stats[1] if self._stats[1] else 1.0

    def _bucket_of(self, n: int) -> int:
        for i, b in enumerate(self.boundaries):
            if n <= b:
                return i
        return len(self.boundaries) - 1

    def _emit_bucket(self, bound: int, docs: List[np.ndarray]) -> MiniBatch:
        b = len(docs)
        tokens = np.full((b, bound), self.pad_id, np.int32)
        segs = np.zeros((b, bound), np.int32)
        pos = np.zeros((b, bound), np.int32)
        tgt = np.full((b, bound), self.ignore_index, np.int32)
        for i, doc in enumerate(docs):
            n = len(doc) - 1
            tokens[i, :n] = doc[:-1]
            tgt[i, :n] = doc[1:]
            segs[i, :n] = 1
            pos[i, :n] = np.arange(n, dtype=np.int32)
            self._stats[0] += n
        self._stats[1] += b * bound
        if self.report_gauge:
            _PAD_EFF.set(self._stats[0] / self._stats[1])
        return MiniBatch([tokens, segs, pos], tgt)

    def __call__(self, it: Iterator, epoch: int) -> Iterator[MiniBatch]:
        buckets: List[List[np.ndarray]] = [[] for _ in self.boundaries]
        top = self.boundaries[-1]
        for doc in it:
            doc = np.asarray(doc)
            if len(doc) < 2:
                continue
            if len(doc) > top + 1:
                doc = doc[:top + 1]
            i = self._bucket_of(len(doc) - 1)
            buckets[i].append(doc)
            if len(buckets[i]) == self.batch_size:
                yield self._emit_bucket(self.boundaries[i], buckets[i])
                buckets[i] = []
        if not self.drop_remainder:
            for i, docs in enumerate(buckets):
                if docs:
                    yield self._emit_bucket(self.boundaries[i], docs)
