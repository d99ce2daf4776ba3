"""Transformer pipeline stages (counterpart of
``bigdl_tpu.dataset.transformer``): a ``Transformer`` maps an iterator
of A to an iterator of B. Not ported yet: chaining (``>>``) and
``Lambda``."""
from __future__ import annotations

from typing import Iterator

from bigdl_tpu_torch.dataset.sample import samples_to_minibatch

__all__ = ["SampleToMiniBatch", "Transformer"]


class Transformer:
    """Iterator-to-iterator preprocessing stage."""

    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it):
        return self.apply(iter(it))


class SampleToMiniBatch(Transformer):
    """Group Samples into MiniBatches of ``batch_size`` records; a final
    partial batch is emitted unless ``drop_remainder``."""

    def __init__(self, batch_size: int, drop_remainder: bool = False):
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder

    def apply(self, it):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield samples_to_minibatch(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield samples_to_minibatch(buf)
