"""DataSet abstractions (counterpart of ``bigdl_tpu.dataset.dataset``).

:class:`LocalDataSet` keeps the reference's iterator contract:
``data(train=True)`` loops over the elements forever in the current
permutation, ``data(train=False)`` is one pass in order, ``shuffle()``
permutes with :class:`~bigdl_tpu_torch.utils.random.RandomGenerator`'s
numpy stream (so one seed gives the JAX package's order record for
record), ``size()`` counts elements.

Not ported yet: sharded, pipeline, device-cached and image datasets.
"""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.transformer import Transformer
from bigdl_tpu_torch.utils.random import RandomGenerator

__all__ = ["AbstractDataSet", "DataSet", "LocalDataSet",
           "TransformedDataSet"]


class AbstractDataSet:
    """DataSet contract: ``data(train)`` yields elements;
    ``size``/``shuffle``/``transform`` as in the reference."""

    def data(self, train: bool) -> Iterator:
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def shuffle(self):
        return self

    def transform(self, transformer: Transformer) -> "TransformedDataSet":
        return TransformedDataSet(self, transformer)


class LocalDataSet(AbstractDataSet):
    """In-memory dataset over a list of elements."""

    def __init__(self, elements: Sequence):
        self.elements = list(elements)
        self._perm = np.arange(len(self.elements))

    def size(self) -> int:
        return len(self.elements)

    def shuffle(self):
        RandomGenerator.numpy().shuffle(self._perm)
        return self

    def data(self, train: bool) -> Iterator:
        if train:
            while True:
                for i in self._perm:
                    yield self.elements[i]
        else:
            for i in range(len(self.elements)):
                yield self.elements[i]


class TransformedDataSet(AbstractDataSet):
    """A dataset viewed through a Transformer chain; ``size`` and
    ``shuffle`` act on the base (records, not batches)."""

    def __init__(self, base: AbstractDataSet, transformer: Transformer):
        self.base = base
        self.transformer = transformer

    def size(self) -> int:
        return self.base.size()

    def shuffle(self):
        self.base.shuffle()
        return self

    def data(self, train: bool) -> Iterator:
        return self.transformer.apply(self.base.data(train))


class DataSet:
    """Factory namespace (``object DataSet`` in the reference)."""

    @staticmethod
    def array(elements) -> LocalDataSet:
        return LocalDataSet(list(elements))
