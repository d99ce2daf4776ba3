"""Transformer pipeline stages (counterpart of
``bigdl_tpu.dataset.transformer``): a ``Transformer`` maps an iterator
of A to an iterator of B; ``a >> b`` (or ``a.chain(b)``) composes, the
reference's ``->`` (ChainedTransformer, Transformer.scala:86)."""
from __future__ import annotations

from typing import Iterator, Optional

from bigdl_tpu_torch.dataset.sample import PaddingParam, samples_to_minibatch

__all__ = ["ChainedTransformer", "Lambda", "SampleToMiniBatch", "Transformer"]


class Transformer:
    """Iterator-to-iterator preprocessing stage."""

    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it):
        return self.apply(iter(it))

    def chain(self, other: "Transformer") -> "ChainedTransformer":
        return ChainedTransformer(self, other)

    # the reference's `->`
    def __rshift__(self, other: "Transformer") -> "ChainedTransformer":
        return self.chain(other)


class ChainedTransformer(Transformer):
    """Composition of two transformers (Transformer.scala ``->``)."""

    def __init__(self, first: Transformer, second: Transformer):
        self.first = first
        self.second = second

    def apply(self, it):
        return self.second.apply(self.first.apply(it))


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches of ``batch_size`` records
    (Transformer.scala:309); a final partial batch is emitted unless
    ``drop_remainder``. ``feature_padding`` / ``label_padding`` pad
    records of differing sizes (a sparse feature's nnz among them), as
    :func:`~bigdl_tpu_torch.dataset.sample.samples_to_minibatch` says.
    ``partition_num`` is accepted as in the JAX package, where it does
    nothing either: the batch is split at the sharding layer."""

    def __init__(self, batch_size: int,
                 feature_padding: Optional[PaddingParam] = None,
                 label_padding: Optional[PaddingParam] = None,
                 partition_num: int = 1, drop_remainder: bool = False):
        self.batch_size = batch_size
        self.feature_padding = feature_padding
        self.label_padding = label_padding
        self.drop_remainder = drop_remainder

    def _batch(self, buf):
        return samples_to_minibatch(buf, self.feature_padding,
                                    self.label_padding)

    def apply(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield self._batch(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self._batch(buf)


class Lambda(Transformer):
    """Wrap a per-element function as a transformer."""

    def __init__(self, fn):
        self.fn = fn

    def apply(self, it):
        for x in it:
            yield self.fn(x)
