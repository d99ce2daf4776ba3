"""Sequence packing and length bucketing for variable-length token data
(counterpart of ``bigdl_tpu.datapipe.packing``; numpy only).

- **Packing** (:func:`pack_documents`): several documents head-to-tail
  in each row of a fixed ``[rows, S]`` slab, with a ``segment_ids``
  plane so attention never looks across a document boundary and a
  ``positions`` plane that restarts at 0 per document.
- **Padding** (:func:`pad_documents`): one document per row, padded to
  the slab width (the "before" layout packing is measured against).

Targets are next-token ids inside each document with ``ignore_index``
at pad positions (pair with ``SequenceCrossEntropyCriterion(
ignore_index=...)``).

Not ported yet: the streaming ``SequencePacker`` and
``LengthBucketBatcher`` stages, the pipeline they plug into and the
``data/packing/padding_efficiency`` gauge.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["pack_documents", "pad_documents", "padding_efficiency"]


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
    return (np.stack([r.tokens for r in rows]),
            np.stack([r.segments for r in rows]),
            np.stack([r.positions for r in rows]),
            np.stack([r.targets for r in rows]))


def pad_documents(docs: Sequence[np.ndarray], seq_len: int, *,
                  pad_id: int = 0, ignore_index: int = -1
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray]:
    """One document per row, padded to ``seq_len`` — the JAX package's
    ``LengthBucketBatcher([seq_len], len(docs))`` batch: documents
    shorter than 2 tokens are dropped, longer than ``seq_len + 1``
    truncated; segment id 1 on real tokens, 0 on pad. Returns
    ``(tokens, segment_ids, positions, targets)``, each
    ``[rows, seq_len]`` int32."""
    docs = [np.asarray(d)[:seq_len + 1] for d in docs if len(d) >= 2]
    rows = len(docs)
    tokens = np.full((rows, seq_len), pad_id, np.int32)
    segs = np.zeros((rows, seq_len), np.int32)
    pos = np.zeros((rows, seq_len), np.int32)
    tgt = np.full((rows, seq_len), ignore_index, np.int32)
    for i, doc in enumerate(docs):
        n = len(doc) - 1
        tokens[i, :n] = doc[:-1]
        tgt[i, :n] = doc[1:]
        segs[i, :n] = 1
        pos[i, :n] = np.arange(n, dtype=np.int32)
    return tokens, segs, pos, tgt
